"""The benchmark's work counter against the program's `cost_analysis` on
the meta device, at every cell's shapes and at the published input sizes
of the families no cell runs yet."""

import contextlib

import pytest
import torch

from h100bench import manifest, reference, work

# (cell, contraction operations, contraction bytes) of one train step,
# as `tools/flops_torch.py` gives the b256 steps
KNOWN = {"mnv2_recipe.b256": (134_682_771_456, 2_504_004_064),
         "resnet18.b256": (852_224_901_120, 1_000_159_616),
         "mnv2_recipe.b32": (16_835_346_432, 318_788_192),
         "resnet18.b32": (106_528_112_640, 154_327_552)}

# family: (the program's builder, its keyword arguments and the
# reference's, the published input (B, H, W, C), logit width)
PUBLISHED = {"lenet": ("lenet_niti", {}, (64, 28, 28, 1), 12),
             "squeezenet": ("squeezenet_niti", {"num_classes": 1000}, (128, 224, 224, 3), 1000),
             "inception_v3": ("inceptionv3_niti", {"num_classes": 1000}, (32, 299, 299, 3), 1000),
             "resnet50v2": ("resnet50v2_niti", {"num_classes": 1000}, (64, 224, 224, 3), 1000)}


def _port_work(builder, kwargs, shape, logit_width, margins=None):
    from mandheling_tpu_torch import models
    from mandheling_tpu_torch.ops.depthwise import recipe_margins
    from mandheling_tpu_torch.train import make_train_step
    from mandheling_tpu_torch.utils.profiler import cost_analysis

    model = getattr(models, builder)(**kwargs).to("meta")
    with recipe_margins(margins["dense"], margins["dw"]) if margins else contextlib.nullcontext():
        return cost_analysis(make_train_step(model), torch.zeros(shape, device="meta"),
                             torch.zeros((shape[0], logit_width), dtype=torch.int32,
                                         device="meta"))


@pytest.mark.parametrize("name", [w["name"] for w in manifest.benchmark()["workloads"]])
def test_work_equals_cost_analysis(name):
    c = manifest.cell(manifest.benchmark(), name)
    cfg, batch = c["config"], c["traffic"]["batch"]
    shape = (batch, *cfg["input_shape"])
    ref = reference.build(cfg["reference"]["family"], **cfg["reference"]["kwargs"])
    got = _port_work(cfg["program"]["builder"], cfg["program"]["kwargs"], shape,
                     cfg["logit_width"], cfg.get("margins"))
    assert work.step_ops(ref, shape) == got["flops"] == got["integer flops"]
    assert work.step_bytes(ref, shape) == got["contraction bytes"]
    if name in KNOWN:
        assert (work.step_ops(ref, shape), work.step_bytes(ref, shape)) == KNOWN[name]


@pytest.mark.parametrize("family", sorted(PUBLISHED))
def test_work_equals_cost_analysis_at_published_sizes(family):
    builder, kwargs, shape, logit_width = PUBLISHED[family]
    ref = reference.build(family, **kwargs)
    got = _port_work(builder, kwargs, shape, logit_width)
    assert reference.shape_of(ref, shape) == (shape[0], 1, 1, logit_width)
    assert work.step_ops(ref, shape) == got["flops"] == got["integer flops"]
    assert work.step_bytes(ref, shape) == got["contraction bytes"]


def test_pools_and_the_flatten_change_the_shape_and_count_nothing():
    R = reference
    shape = (2, 9, 11, 4)
    assert work.contractions([R.MaxPool((3, 3), (2, 2)), R.AvgPool((3, 3), (1, 1), 1),
                              R.Flatten(), R.Relu()], shape) == []
    assert R.MaxPool((3, 3), (2, 2)).out_shape(shape) == (2, 4, 5, 4)
    assert R.MaxPool().out_shape(shape) == (2, 4, 5, 4)
    assert R.AvgPool((3, 3), (1, 1), 1).out_shape(shape) == shape
    assert R.Flatten().out_shape(shape) == (2, 1, 1, 396)
    # a pool before a conv shrinks every later contraction
    conv = R.Conv(4, 8, (3, 3), (1, 1), "SAME")
    pooled = work.contractions([R.MaxPool((2, 2), (2, 2)), conv], (2, 8, 8, 4))
    assert [c.macs for c in pooled] == [2 * 4 * 4 * 9 * 4 * 8] * 3


def test_a_concat_walks_every_branch_from_its_input():
    R = reference
    shape = (1, 5, 5, 3)
    cat = R.Concat([[R.Conv(3, 4, (3, 3), (2, 2))],
                    [R.Conv(3, 2), R.Conv(2, 6, (3, 3), (2, 2))],
                    [R.MaxPool((3, 3), (2, 2))]])
    assert cat.out_shape(shape) == (1, 2, 2, 4 + 6 + 3)
    macs = [c.macs for c in work.contractions([R.Conv(3, 3), cat], shape)]
    # the first conv skips its input grad; every branch's first conv reads (1, 5, 5, 3)
    assert macs == [25 * 9] * 2 + [4 * 9 * 3 * 4] * 3 + [25 * 3 * 2] * 3 + [4 * 9 * 2 * 6] * 3
    assert [l.weight_shape for l in R.weighted([R.Conv(3, 3), cat])] == [
        (1, 1, 3, 3), (3, 3, 3, 4), (1, 1, 3, 2), (3, 3, 2, 6)]


def test_bound_takes_the_larger_of_compute_and_bytes():
    ref = reference.build("resnet18")
    shape = (256, 32, 32, 3)
    cs = work.contractions(ref, shape)
    fast_bytes = work.bound_seconds(ref, shape, 1e15, 1e30)
    fast_ops = work.bound_seconds(ref, shape, 1e30, 1e12)
    both = work.bound_seconds(ref, shape, 1e15, 1e12)
    assert fast_bytes == pytest.approx(sum(c.ops for c in cs) / 1e15)
    assert fast_ops == pytest.approx(sum(c.bytes for c in cs) / 1e12)
    assert max(fast_bytes, fast_ops) <= both <= fast_bytes + fast_ops
