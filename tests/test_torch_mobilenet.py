"""The MobileNet slice end to end: a reduced NITI MobileNetV2 trained in the
port against the JAX package, from the same params (carried across by
utils/jax_params.py) and the same synthetic CIFAR batches. Params and
exponents must be byte-identical after 3 steps; losses agree within 1e-6
relative (the logged loss is a float32 softmax-CE).

The reduced network keeps every kind of layer of the full one at width 0.25:
the stem, a non-residual bottleneck (expansion 1), a residual bottleneck, a
stride-2 bottleneck, the head, the global average pool and the logits. Each
package builds it from its own `_bottleneck`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mandheling_tpu.nn.blocks as jblocks
import mandheling_tpu.nn.layers as jlayers
import mandheling_tpu.nn.module as jmodule
from mandheling_tpu.models import mobilenet as jmobilenet
from mandheling_tpu.models import mobilenet_v1_niti as j_mobilenet_v1_niti
from mandheling_tpu.models import mobilenet_v2_niti as j_mobilenet_v2_niti
from mandheling_tpu.ops import conv as jconv
from mandheling_tpu.ops import depthwise as jdw
from mandheling_tpu.train import make_eval_step as j_make_eval_step
from mandheling_tpu.train import make_train_step as j_make_train_step
import mandheling_tpu_torch.nn.blocks as tblocks
import mandheling_tpu_torch.nn.layers as tlayers
import mandheling_tpu_torch.nn.module as tmodule
from mandheling_tpu_torch.data import onehot_padded, synthetic_cifar
from mandheling_tpu_torch.models import (MOBILENET_V2_NITI_LOGITS, mobilenet_v1_niti,
                                         mobilenet_v2_niti)
from mandheling_tpu_torch.models import mobilenet as tmobilenet
from mandheling_tpu_torch.ops import conv as tconv
from mandheling_tpu_torch.ops import depthwise as tdw
from mandheling_tpu_torch.ops.kernels import use_backend
from mandheling_tpu_torch.train import make_eval_step, make_train_step
from mandheling_tpu_torch.train.trainer import train_niti
from mandheling_tpu_torch.utils.jax_params import export_jax_params, flat_weights, load_jax_params

STEPS, BATCH = 3, 8
RECIPES = {"per_tensor": (False, 2), "per_channel_margins_0": (True, 0)}


def reduced_mnv2(blocks, layers, module, bottleneck, dw_per_channel):
    """Width 0.25: stem 3->8, bottlenecks (8->4, e1, s1), (4->4, e6, s1,
    residual), (4->8, e6, s2), head 8->320, GAP, 320->12."""
    out = [layers.NITIConv2D(3, 8, (3, 3), (1, 1), "SAME", act="relu6")]
    for in_c, out_c, e, s in [(8, 4, 1, 1), (4, 4, 6, 1), (4, 8, 6, 2)]:
        b = bottleneck(in_c, out_c, e, s, dw_per_channel=dw_per_channel)
        out += [b] if isinstance(b, blocks.ResidualBlock) else list(b.layers)
    out += [layers.NITIConv2D(8, 320, (1, 1), act="relu6"), blocks.GlobalAvgPool(),
            layers.NITIConv2D(320, MOBILENET_V2_NITI_LOGITS, (1, 1)), layers.SqueezeLogits()]
    return module.Sequential(out)


def to_numpy(params):
    """JAX params -> the carrier's layout with numpy arrays, nested lists kept."""
    if isinstance(params, list):
        return [to_numpy(p) for p in params]
    if not params:
        return ()
    return {"w": (np.asarray(params["w"].data), np.asarray(params["w"].exp))}


def set_margins(conv_ops, dw_ops, margin):
    conv_ops.set_fgrad_margin(margin)
    dw_ops.set_dw_fgrad_margin(margin)


@pytest.fixture(scope="module")
def batches():
    x, y = synthetic_cifar(STEPS * BATCH, seed=0)
    xs = [x[i * BATCH:(i + 1) * BATCH].astype(np.float32) for i in range(STEPS)]
    ohs = [onehot_padded(y[i * BATCH:(i + 1) * BATCH], 10, MOBILENET_V2_NITI_LOGITS)
           for i in range(STEPS)]
    return xs, ohs, y[:BATCH].astype(np.int64)


@pytest.fixture(scope="module")
def jax_runs(batches):
    """Per recipe: the start params, the JAX losses, the final params and the
    eval step's correct count (XLA backend; the JAX package's own tests hold
    it byte-identical to its Pallas kernels)."""
    xs, ohs, labels = batches
    runs = {}
    for name, (per_channel, margin) in RECIPES.items():
        model = reduced_mnv2(jblocks, jlayers, jmodule, jmobilenet._bottleneck, per_channel)
        params = model.init(jax.random.PRNGKey(1))
        start = to_numpy(params)
        set_margins(jconv, jdw, margin)
        try:
            step = jax.jit(j_make_train_step(model))
            losses = []
            for x, oh in zip(xs, ohs):
                params, loss = step(params, jnp.asarray(x), jnp.asarray(oh))
                losses.append(float(loss))
        finally:
            set_margins(jconv, jdw, 2)
        correct = int(j_make_eval_step(model)(params, jnp.asarray(xs[0]), jnp.asarray(labels)))
        runs[name] = (start, losses, to_numpy(params), correct)
    return runs


def assert_weights_equal(got, want):
    got, want = flat_weights(got), flat_weights(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("recipe", list(RECIPES))
@pytest.mark.parametrize("mode", ["matmul_only", "all"])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_reduced_mnv2_steps_byte_identical_to_jax(jax_runs, batches, recipe, mode, backend):
    xs, ohs, labels = batches
    start, losses_j, final_j, correct_j = jax_runs[recipe]
    per_channel, margin = RECIPES[recipe]
    model = reduced_mnv2(tblocks, tlayers, tmodule, tmobilenet._bottleneck, per_channel)
    load_jax_params(model, start)
    assert_weights_equal(export_jax_params(model), start)
    step = make_train_step(model)
    losses = []
    with tdw.recipe_margins(margin, margin), use_backend(backend), \
            tconv.use_fused_conv_mode(mode):
        for x, oh in zip(xs, ohs):
            losses.append(float(step(torch.from_numpy(x), torch.from_numpy(oh))))
        correct = int(make_eval_step(model)(torch.from_numpy(xs[0]), torch.from_numpy(labels)))
    final = export_jax_params(model)
    assert_weights_equal(final, final_j)
    assert any(not np.array_equal(a, b)
               for a, b in zip(flat_weights(final), flat_weights(start)))
    np.testing.assert_allclose(losses, losses_j, rtol=1e-6, atol=0)
    assert correct == correct_j


def _layout(model, blocks):
    out = []
    for layer in model.layers:
        if isinstance(layer, blocks.ResidualBlock):
            out.append(("residual", _layout(layer.branch, blocks)))
        else:
            out.append((type(layer).__name__,) + tuple(
                getattr(layer, a, None) for a in ("in_channels", "out_channels", "channels",
                                                   "kernel", "stride", "padding", "act",
                                                   "out_bits", "per_channel")))
    return out


@pytest.mark.parametrize("kwargs", [{}, {"dw_per_channel": True}, {"variant": "imagenet"},
                                    {"width_mult": 0.5, "proj_bits": 15}])
def test_full_mnv2_layout_matches_jax(kwargs):
    """The full network has the JAX package's layers, nesting, widths,
    strides and options, in both plans and both exponent forms."""
    assert _layout(mobilenet_v2_niti(**kwargs), tblocks) == \
        _layout(j_mobilenet_v2_niti(**kwargs), jblocks)


@pytest.mark.parametrize("kwargs", [{}, {"dw_per_channel": True}, {"variant": "imagenet"}])
def test_mnv1_layout_matches_jax(kwargs):
    assert _layout(mobilenet_v1_niti(**kwargs), tblocks) == \
        _layout(j_mobilenet_v1_niti(**kwargs), jblocks)


def test_trainer_runs_mobilenet_on_the_cpu():
    """train_niti(model=...) trains the MobileNet through the same loop;
    backends "cuda" (plain versions on a CPU tensor) and "torch" agree."""
    tr, te = synthetic_cifar(2 * BATCH, seed=3), synthetic_cifar(BATCH, seed=4)
    runs = []
    for backend in ("cuda", "torch"):
        lines = []
        model, acc = train_niti(tr, te, epochs=1, batch=BATCH, seed=0, log=lines.append,
                                device="cpu", backend=backend,
                                model=mobilenet_v2_niti(width_mult=0.25))
        runs.append((flat_weights(export_jax_params(model)), acc, lines[0].split(" lr ")[0]))
    for a, b in zip(runs[0][0], runs[1][0]):
        np.testing.assert_array_equal(a, b)
    assert runs[0][1:] == runs[1][1:]
    assert runs[0][2].startswith("epoch 0: loss ")


def _load_chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_launch_table_is_the_routes(monkeypatch):
    """chip_smoke.py asserts the launches of every main path against
    EXPECTED_PER_STEP. Rehearsed here on the meta device (shapes only, no
    data): each dispatch call a train step and an eval step make, per
    kernel family (K1 on an int16 A is its int16-A route, "K1i16"), at the
    table's models ("mnv2pc": the r5 recipe's per-channel depthwise
    MobileNetV2; "mnv2p15": MobileNetV2 with int16 projection outputs; the
    ResNets; the zoo, "squeezenet10" at 10 classes), batches and fused
    modes. K7 (the requant of each accumulator no fused kernel takes)
    counts its sites: each runs phase 1 once and one phase 2. K8 counts
    each pool, pool backward and concat."""
    from mandheling_tpu_torch.models import lenet_niti
    from mandheling_tpu_torch.ops.kernels import fused_conv_int8, fused_dwconv_int8
    from mandheling_tpu_torch.ops.kernels import (fused_matmul_int8, matmul_int8, pool_concat_int8,
                                                  requant_int32)

    cs = _load_chip_smoke()
    calls = {}
    for fam, mod, name in [("K1", matmul_int8, "matmul_acc"), ("K2", fused_matmul_int8, "matmul_max"),
                           ("K2r", fused_matmul_int8, "matmul_requant"),
                           ("K3", fused_conv_int8, "conv_max"), ("K3r", fused_conv_int8, "conv_requant"),
                           ("K4", fused_dwconv_int8, "dwconv_max"),
                           ("K4r", fused_dwconv_int8, "dwconv_requant"),
                           ("K5", fused_dwconv_int8, "dwconv_fgrad_acc"),
                           ("K7", requant_int32, "absmax"), ("K7r", requant_int32, "requant_forward"),
                           ("K7g", requant_int32, "requant_grad"),
                           ("K8mp", pool_concat_int8, "maxpool"),
                           ("K8mpb", pool_concat_int8, "maxpool_grad"),
                           ("K8ap", pool_concat_int8, "avgpool"),
                           ("K8apb", pool_concat_int8, "avgpool_grad"),
                           ("K8cat", pool_concat_int8, "concat")]:
        real = getattr(mod, name)

        def counted(*a, _fam=fam, _real=real, **k):
            f = "K1i16" if _fam == "K1" and a[0].dtype == torch.int16 else _fam
            calls[f] = calls.get(f, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    from mandheling_tpu_torch.models import (inceptionv3_niti, resnet18_niti, resnet50v2_niti,
                                             squeezenet_niti)

    model_fns = {"lenet": (lenet_niti, (28, 28, 1), 12), "mnv2": (mobilenet_v2_niti, (32, 32, 3), 12),
                 "mnv2pc": (lambda: mobilenet_v2_niti(dw_per_channel=True), (32, 32, 3), 12),
                 "mnv2p15": (lambda: mobilenet_v2_niti(proj_bits=15), (32, 32, 3), 12),
                 "resnet18": (resnet18_niti, (32, 32, 3), 12),
                 "resnet50v2": (lambda: resnet50v2_niti(num_classes=1000), (224, 224, 3), 1000),
                 "squeezenet": (lambda: squeezenet_niti(num_classes=1000), (224, 224, 3), 1000),
                 "squeezenet10": (lambda: squeezenet_niti(num_classes=10), (32, 32, 3), 12),
                 "inceptionv3": (lambda: inceptionv3_niti(num_classes=1000), (299, 299, 3), 1000)}
    # the transfer rows take the transfer steps: tests/test_torch_transfer.py
    rows = {k: v for k, v in cs.EXPECTED_PER_STEP.items() if k[0] != "mnv2_transfer"}
    for (model_name, batch, mode), want in rows.items():
        build, hwc, n_logits = model_fns[model_name]
        model = build().to("meta")
        x = torch.zeros((batch,) + hwc, device="meta")
        oh = torch.zeros((batch, n_logits), dtype=torch.int32, device="meta")
        got = []
        with tconv.use_fused_conv_mode(mode):
            for run in (lambda: make_train_step(model)(x, oh),
                        lambda: make_eval_step(model)(x, torch.zeros(batch, dtype=torch.int64,
                                                                     device="meta"))):
                calls.clear()
                run()
                for fam in ("K2", "K3", "K4"):
                    assert calls.get(fam, 0) == calls.get(fam + "r", 0)
                assert calls.get("K7", 0) == calls.get("K7r", 0) + calls.get("K7g", 0)
                got.append({f: n for f, n in calls.items() if not f.endswith(("r", "g"))})
        assert tuple(got) == want, (model_name, batch, mode)


def test_chip_smoke_k4_path_cases_are_the_step_shapes():
    """chip_smoke.py times K4 at K4_PATH_CASES and weights them by the
    launches it records in a batch-256 MobileNetV2 step, per-tensor and
    under the recipe (whose per-channel forms take K4 with their shifts).
    Rehearsed here on the meta device with its recorder: the (x shape,
    kernel, pads, dilation) a train step and an eval step give K4 are the
    listed ones in both models, the counts sum to EXPECTED_PER_STEP's, every
    recipe call carries a (C,) shift vector and no per-tensor one does, and
    the recorder restores the wrapped function."""
    from mandheling_tpu_torch.ops.kernels import fused_dwconv_int8

    cs = _load_chip_smoke()
    real = fused_dwconv_int8.dwconv_max
    path = {(xs, k, pads, dil) for _, xs, k, pads, dil in cs.K4_PATH_CASES}
    x = torch.zeros((256, 32, 32, 3), device="meta")
    oh = torch.zeros((256, MOBILENET_V2_NITI_LOGITS), dtype=torch.int32, device="meta")
    for per_channel in (False, True):
        model = mobilenet_v2_niti(dw_per_channel=per_channel).to("meta")
        spec = {"K4": (fused_dwconv_int8, "dwconv_max", cs.k4_key),
                "pc": (fused_dwconv_int8, "dwconv_requant",
                       lambda x, w, s, g=False, pc_shift=None, **_: (
                           None if pc_shift is None else tuple(pc_shift.shape) == x.shape[3:]))}
        with cs.recording(spec) as train:
            make_train_step(model)(x, oh)
        with cs.recording(spec) as evals:
            make_eval_step(model)(x, torch.zeros(256, dtype=torch.int64, device="meta"))
        assert fused_dwconv_int8.dwconv_max is real
        assert set(train["K4"]) == path and set(evals["K4"]) <= path
        per_train, per_eval = cs.EXPECTED_PER_STEP[
            ("mnv2pc" if per_channel else "mnv2", 256, "matmul_only")]
        assert sum(train["K4"].values()) == per_train["K4"] == 31
        assert sum(evals["K4"].values()) == per_eval["K4"] == 14
        assert set(train["pc"]) | set(evals["pc"]) == ({True} if per_channel else {None})


@pytest.mark.parametrize("per_channel", [False, True])
def test_chip_smoke_k5_path_cases_are_the_step_shapes(per_channel):
    """chip_smoke.py times K5 at K5_PATH_CASES and weights them by the
    launches it records in a batch-256 MobileNetV2 step, per-tensor and
    under the recipe. Rehearsed here on the meta device with its recorder:
    a train step's K5 calls (x shape, kernel, pads, stride) are the listed
    ones (17 launches: 14 at stride 1, 3 at stride 2 with pads (0, 1)), an
    eval step makes none."""
    from mandheling_tpu_torch.ops.kernels import fused_dwconv_int8

    cs = _load_chip_smoke()
    model = mobilenet_v2_niti(dw_per_channel=per_channel).to("meta")
    x = torch.zeros((256, 32, 32, 3), device="meta")
    oh = torch.zeros((256, MOBILENET_V2_NITI_LOGITS), dtype=torch.int32, device="meta")
    spec = {"K5": (fused_dwconv_int8, "dwconv_fgrad_acc", cs.k5_key)}
    with cs.recording(spec) as train:
        make_train_step(model)(x, oh)
    with cs.recording(spec) as evals:
        make_eval_step(model)(x, torch.zeros(256, dtype=torch.int64, device="meta"))
    assert set(train["K5"]) == cs.K5_PATH_KEYS
    assert not evals["K5"]
    key = ("mnv2pc" if per_channel else "mnv2", 256, "matmul_only")
    assert sum(train["K5"].values()) == cs.EXPECTED_PER_STEP[key][0]["K5"] == 17
    assert sum(n for (_, _, _, stride), n in train["K5"].items() if stride == (2, 2)) == 3
