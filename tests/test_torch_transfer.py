"""The port's transfer learning (train/transfer.py) against the JAX
package's: a frozen NITI feature extractor (LeNet's up to fc1's relu, and
MobileNetV2 at width 0.25 up to its global pool) and a trained NITI head,
from the same params (drawn by the port, carried across) and the same
integer-pixel batches (b2-b8, where the JAX package's float32 batch sums are
exact; LeNet at b2 and b8, MobileNetV2 at b4). Head params byte-identical,
the features' params unchanged, losses within 1e-5, equal correct counts. Also `split_params` / `merge_params`, the
MobilenetV2Transfer demo on the CPU, and chip_smoke.py's launch table for
the transfer steps, rehearsed on the meta device."""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mandheling_tpu.data import onehot_padded as j_onehot
from mandheling_tpu.models import lenet_niti as j_lenet
from mandheling_tpu.models.mobilenet import mobilenet_v2_niti as j_mnv2
from mandheling_tpu.nn.layers import NITIConv2D as JConv
from mandheling_tpu.nn.layers import SqueezeLogits as JSqueeze
from mandheling_tpu.nn.module import Sequential as JSequential
from mandheling_tpu.ops.qtensor import QTensor as JQTensor
from mandheling_tpu.train import transfer as jtransfer
from mandheling_tpu_torch.models import lenet_niti, mobilenet_v2_niti
from mandheling_tpu_torch.ops import conv as tconv
from mandheling_tpu_torch.ops.kernels import use_backend
from mandheling_tpu_torch.train import transfer as ttransfer
from mandheling_tpu_torch.utils.jax_params import export_jax_params, flat_weights, load_jax_params

ROOT = Path(__file__).resolve().parents[1]
STEPS = 3
# name -> (JAX builder, port builder, image shape, batches)
MODELS = {"lenet": (j_lenet, lenet_niti, (28, 28, 1), (2, 8)),
          "mnv2_w025": (lambda: j_mnv2(num_classes=10, width_mult=0.25),
                        lambda: mobilenet_v2_niti(num_classes=10, width_mult=0.25), (32, 32, 3),
                        (4,))}
CASES = [(name, batch) for name, spec in MODELS.items() for batch in spec[3]]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test runners share the machine's cores among
    several processes, where torch's spinning thread pool slows tiny ops by
    orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_module(relpath, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / relpath)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def weights_equal(got, want):
    a, b = flat_weights(got), flat_weights(want)
    return len(a) == len(b) and all(x.dtype == y.dtype and np.array_equal(x, y)
                                    for x, y in zip(a, b))


def to_jax(params):
    """Port-exported (JAX-layout) params as the JAX package's QTensors."""
    return [to_jax(p) if isinstance(p, list) else
            {"w": JQTensor(jnp.asarray(p["w"][0]), jnp.asarray(p["w"][1]))} if p else ()
            for p in params]


def jax_transfer(name):
    """The JAX demo's split of the model, from weights the port draws (seed
    0 for the full model, 1 for the head): features before the classifier
    conv, a fresh NITIConv2D + SqueezeLogits head -> (model, full params,
    head params), the params in the JAX layout."""
    jbuild, tbuild = MODELS[name][:2]
    full = jbuild()
    split = len(full.layers) - 2
    tfull = tbuild().reset_parameters(torch.Generator().manual_seed(0))
    thead = ttransfer.transfer_from(tfull, 10).reset_parameters(torch.Generator().manual_seed(1))
    full_params = to_jax(export_jax_params(tfull))
    head = JSequential([JConv(full.layers[split].in_channels, 12, (1, 1)), JSqueeze()])
    model = jtransfer.TransferModel(JSequential(full.layers[:split]), full_params[:split], head)
    return model, full_params, to_jax(export_jax_params(thead.head))


@pytest.fixture(scope="module")
def jax_runs():
    """For each model and batch: STEPS jitted JAX transfer train steps and one
    eval step on integer pixels."""
    out = {}
    for name, (_, _, hwc, batches) in MODELS.items():
        model, full_params, head_params = jax_transfer(name)
        start = head_params
        step = jax.jit(jtransfer.make_transfer_train_step(model))
        evals = jax.jit(jtransfer.make_transfer_eval_step(model, 10))
        for batch in batches:
            rng = np.random.default_rng(batch)
            xs = [rng.integers(0, 256, (batch,) + hwc).astype(np.float32) for _ in range(STEPS)]
            ys = [rng.integers(0, 10, batch) for _ in range(STEPS)]
            params, losses = start, []
            for x, y in zip(xs, ys):
                params, loss = step(params, jnp.asarray(x), jnp.asarray(j_onehot(y, 10, 12)))
                losses.append(float(loss))
            correct = int(evals(params, jnp.asarray(xs[0]), jnp.asarray(ys[0])))
            out[name, batch] = dict(full=full_params, start=start, xs=xs, ys=ys, final=params,
                                    losses=losses, correct=correct)
    return out


@pytest.mark.parametrize("name,batch", CASES)
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_transfer_steps_byte_identical_to_jax(jax_runs, name, batch, backend):
    run = jax_runs[name, batch]
    full = load_jax_params(MODELS[name][1](), run["full"])
    model = ttransfer.transfer_from(full, 10)
    load_jax_params(model.head, run["start"])
    features_before = export_jax_params(model.features)
    step = ttransfer.make_transfer_train_step(model)
    with use_backend(backend):
        losses = [float(step(torch.from_numpy(x), torch.from_numpy(j_onehot(y, 10, 12))))
                  for x, y in zip(run["xs"], run["ys"])]
        correct = int(ttransfer.make_transfer_eval_step(model, 10)(
            torch.from_numpy(run["xs"][0]), torch.from_numpy(run["ys"][0])))
    assert weights_equal(export_jax_params(model.head), run["final"])
    assert not weights_equal(export_jax_params(model.head), run["start"])
    assert weights_equal(export_jax_params(model.features), features_before)
    np.testing.assert_allclose(losses, run["losses"], rtol=0, atol=1e-5)
    assert correct == run["correct"]


def test_transfer_under_fused_mode_all():
    """MobileNetV2's stem takes K3's route under "all" on the card; on the
    CPU the same bytes as "matmul_only"."""
    full = mobilenet_v2_niti(num_classes=10, width_mult=0.25)
    full.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 256, (4, 32, 32, 3)).astype(np.float32))
    oh = torch.from_numpy(j_onehot(rng.integers(0, 10, 4), 10, 12))
    heads = []
    for mode in ("matmul_only", "all"):
        model = ttransfer.transfer_from(full, 10).reset_parameters(torch.Generator().manual_seed(1))
        with tconv.use_fused_conv_mode(mode):
            ttransfer.make_transfer_train_step(model)(x, oh)
        heads.append(export_jax_params(model.head))
    assert weights_equal(heads[0], heads[1])


def test_split_and_merge_params_match_jax():
    params = j_lenet().init(jax.random.PRNGKey(0))
    trainable = [i >= 7 for i in range(len(params))]
    jf, jt = jtransfer.split_params(params, trainable)
    tf, tt = ttransfer.split_params(params, trainable)
    for got, want in ((tf, jf), (tt, jt)):
        assert [p is None for p in got] == [p is None for p in want]
        assert weights_equal([p for p in got if p is not None], [p for p in want if p is not None])
    merged = ttransfer.merge_params(tf, tt)
    assert weights_equal(merged, jtransfer.merge_params(jf, jt)) and weights_equal(merged, params)


def test_transfer_model_draws_only_the_head():
    full = lenet_niti().reset_parameters(torch.Generator().manual_seed(0))
    before = export_jax_params(full)
    model = ttransfer.transfer_from(full, 10)
    assert model.features.layers[0] is full.layers[0]
    assert not model.head.layers[0].w.any()
    model.reset_parameters(torch.Generator().manual_seed(1))
    assert model.head.layers[0].w.any()
    assert tuple(model.head.layers[0].w.shape) == (1, 1, 500, 12)
    assert weights_equal(export_jax_params(full), before)


def test_mobilenet_v2_transfer_demo_on_the_cpu(tmp_path, capsys):
    """The demo, one epoch on the CPU: the lines the JAX CLI prints; with a
    snapshot of the full model it loads the features; its image-folder
    branch trains on the images of the label file (64 PNGs here;
    tests/test_torch_import_cli.py holds its lines to the JAX CLI's)."""
    from PIL import Image

    from mandheling_tpu_torch.utils.checkpoint import save_checkpoint

    cli = load_module("tools/run_train_demo_torch.py", "run_train_demo_torch")
    cli.main(["MobilenetV2Transfer", "--epochs", "1", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == ["(no pretrained snapshot — feature extractor is random init)",
                       "(no image folder/txt — synthetic data)"]
    assert re.fullmatch(r"epoch 0: loss \d+\.\d{4} train_acc \d\.\d{4}", out[-1]), out
    snap = tmp_path / "mnv2.npz"
    full = mobilenet_v2_niti(num_classes=10, width_mult=0.25)
    save_checkpoint(str(snap), export_jax_params(full.reset_parameters(
        torch.Generator().manual_seed(3))))
    rng = np.random.default_rng(0)
    for i in range(64):
        Image.fromarray(rng.integers(0, 255, (36, 40, 3)).astype(np.uint8)).save(
            tmp_path / f"im{i}.png")
    (tmp_path / "l.txt").write_text("".join(f"im{i}.png {i % 10}\n" for i in range(64)))
    cli.main(["MobilenetV2Transfer", str(tmp_path), "--images-txt", str(tmp_path / "l.txt"),
              "--snapshot", str(snap), "--epochs", "1", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == [f"loaded pretrained features from {snap}",
                       f"ImageDataset: 64 images from {tmp_path / 'l.txt'}"]
    assert re.fullmatch(r"epoch 0: loss \d+\.\d{4} train_acc \d\.\d{4}", out[-1]), out


def test_chip_smoke_transfer_launch_table_is_the_routes(monkeypatch):
    """chip_smoke.py asserts the launches of its transfer runs against the
    "mnv2_transfer" rows of EXPECTED_PER_STEP: full-width MobileNetV2, the
    features forward only (a MobileNetV2 eval step but its classifier) and
    the head's forward and filter grad. Rehearsed here on the meta device
    with each dispatch call counted, per kernel family."""
    from mandheling_tpu_torch.ops.kernels import (fused_conv_int8, fused_dwconv_int8,
                                                  fused_matmul_int8, matmul_int8)

    cs = load_module("chip_smoke.py", "chip_smoke")
    calls = {}
    for fam, mod, name in [("K1", matmul_int8, "matmul_acc"), ("K2", fused_matmul_int8, "matmul_max"),
                           ("K2r", fused_matmul_int8, "matmul_requant"),
                           ("K3", fused_conv_int8, "conv_max"), ("K3r", fused_conv_int8, "conv_requant"),
                           ("K4", fused_dwconv_int8, "dwconv_max"),
                           ("K4r", fused_dwconv_int8, "dwconv_requant"),
                           ("K5", fused_dwconv_int8, "dwconv_fgrad_acc")]:
        def counted(*a, _fam=fam, _real=getattr(mod, name), **k):
            calls[_fam] = calls.get(_fam, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    rows = {k: v for k, v in cs.EXPECTED_PER_STEP.items() if k[0] == "mnv2_transfer"}
    assert set(rows) == {("mnv2_transfer", 256, "matmul_only"), ("mnv2_transfer", 256, "all"),
                         ("mnv2_transfer", 32, "matmul_only")}
    model = cs.mnv2_transfer_model().to("meta")
    for (_, batch, mode), want in rows.items():
        x = torch.zeros((batch, 32, 32, 3), device="meta")
        oh = torch.zeros((batch, 12), dtype=torch.int32, device="meta")
        got = []
        with tconv.use_fused_conv_mode(mode):
            for run in (lambda: ttransfer.make_transfer_train_step(model)(x, oh),
                        lambda: ttransfer.make_transfer_eval_step(model)(
                            x, torch.zeros(batch, dtype=torch.int64, device="meta"))):
                calls.clear()
                run()
                for fam in ("K2", "K3", "K4"):
                    assert calls.get(fam, 0) == calls.get(fam + "r", 0)
                got.append({f: n for f, n in calls.items() if not f.endswith("r")})
        assert tuple(got) == want, (batch, mode, got)
        assert "K5" not in got[0]  # the features are frozen: no depthwise filter grad
