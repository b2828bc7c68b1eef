"""The benchmark's work counter against the program's `cost_analysis` on
the meta device, at every cell's shapes."""

import contextlib

import pytest
import torch

from h100bench import manifest, reference, work

# (cell, contraction operations, contraction bytes) of one train step,
# as `tools/flops_torch.py` gives the b256 steps
KNOWN = {"mnv2_recipe.b256": (134_682_771_456, 2_504_004_064),
         "resnet18.b256": (852_224_901_120, 1_000_159_616)}


@pytest.mark.parametrize("name", [w["name"] for w in manifest.benchmark()["workloads"]])
def test_work_equals_cost_analysis(name):
    from mandheling_tpu_torch import models
    from mandheling_tpu_torch.ops.depthwise import recipe_margins
    from mandheling_tpu_torch.train import make_train_step
    from mandheling_tpu_torch.utils.profiler import cost_analysis

    c = manifest.cell(manifest.benchmark(), name)
    cfg, batch = c["config"], c["traffic"]["batch"]
    shape = (batch, *cfg["input_shape"])
    ref = reference.build(cfg["reference"]["family"], **cfg["reference"]["kwargs"])
    model = getattr(models, cfg["program"]["builder"])(**cfg["program"]["kwargs"]).to("meta")
    m = cfg.get("margins")
    with recipe_margins(m["dense"], m["dw"]) if m else contextlib.nullcontext():
        got = cost_analysis(make_train_step(model), torch.zeros(shape, device="meta"),
                            torch.zeros((batch, cfg["logit_width"]), dtype=torch.int32,
                                        device="meta"))
    assert work.step_ops(ref, shape) == got["flops"] == got["integer flops"]
    assert work.step_bytes(ref, shape) == got["contraction bytes"]
    if name in KNOWN:
        assert (work.step_ops(ref, shape), work.step_bytes(ref, shape)) == KNOWN[name]


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
