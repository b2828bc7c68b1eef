"""The port's converter (utils/convert.py) and its CLI
(tools/convert_torch.py) against the JAX package's: a torch `state_dict`
(and an .onnx or .tflite file of the same model) gives the JAX converter's
fp32 arrays exactly, the port's float models compute the torch model's
function from them, and the CLI writes the JAX CLI's checkpoints (keys and
arrays, `--quantize`'s int8 tree too) and prints its lines."""

import contextlib
import importlib.util
import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mandheling_tpu.utils import convert as jconvert
from mandheling_tpu_torch.models import LeNetFP32
from mandheling_tpu_torch.models.mobilenet_fp32 import MobileNetV1FP32, MobileNetV2FP32
from mandheling_tpu_torch.utils import convert as tconvert
from mandheling_tpu_torch.utils import onnx_io as tonnx
from mandheling_tpu_torch.utils.checkpoint import flatten_tree
from test_torch_graph_import import _one_torch_thread, assert_weights_equal  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def load(relpath, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / relpath)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# the JAX package's torch mirrors (XLA-SAME padding, spec-ordered modules)
mirrors = load("tests/test_convert.py", "_torch_convert_mirrors")


def _lenet_sd():
    torch.manual_seed(0)
    return mirrors.TorchLeNet().eval()


def tree_equal(got, want):
    a, b = flatten_tree(got), {k: np.asarray(v) for k, v in flatten_tree(want).items()}
    assert list(a) == list(b)
    assert_weights_equal(list(a.values()), list(b.values()))


def test_lenet_arrays_equal_jax_and_compute_the_torch_model():
    tm = _lenet_sd()
    params = tconvert.lenet_fp32_from_torch(tm.state_dict())
    tree_equal(params, jconvert.lenet_fp32_from_torch(tm.state_dict()))
    x = np.random.default_rng(0).normal(0, 1, (4, 28, 28, 1)).astype(np.float32)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
        out = LeNetFP32().load_params(params)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cls", [MobileNetV1FP32, MobileNetV2FP32])
def test_mobilenet_arrays_equal_jax_and_compute_the_torch_model(cls):
    from mandheling_tpu.models import mobilenet_fp32 as jm

    model = cls(num_classes=10)
    tm = mirrors._torch_from_spec(model)
    tm.train()
    with torch.no_grad():
        tm(torch.randn(8, 3, 32, 32, generator=torch.Generator().manual_seed(0)))
    tm.eval()
    params = tconvert.mobilenet_fp32_from_torch(tm.state_dict(), model)
    tree_equal(params, jconvert.mobilenet_fp32_from_torch(
        tm.state_dict(), getattr(jm, cls.__name__)(num_classes=10)))
    x = np.random.default_rng(1).normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
        out = model.load_params(params)(torch.from_numpy(x), training=False).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)


def test_modules_and_mismatch_as_jax():
    sd = _lenet_sd().state_dict()
    t, j = tconvert.modules_from_state_dict(sd), jconvert.modules_from_state_dict(sd)
    assert [k for k, _ in t] == [k for k, _ in j]
    for (_, a), (_, b) in zip(t, j):
        assert_weights_equal([a[k] for k in sorted(a)], [b[k] for k in sorted(b)])
    with pytest.raises(ValueError, match="architecture mismatch"):
        tconvert.mobilenet_fp32_from_torch(sd, MobileNetV2FP32())
    assert np.array_equal(tconvert.chw_to_hwc_perm(3, 2, 4), jconvert.chw_to_hwc_perm(3, 2, 4))


def test_load_torch_file_unwraps(tmp_path):
    tm = torch.nn.Sequential(torch.nn.Conv2d(1, 4, 3), torch.nn.BatchNorm2d(4))
    for i, obj in enumerate((tm.state_dict(), tm, {"state_dict": tm.state_dict()})):
        path = tmp_path / f"m{i}.pt"
        torch.save(obj, path)
        got = tconvert.load_torch_file(str(path))
        assert list(got) == list(tm.state_dict())
        assert all(torch.equal(got[k], v) for k, v in tm.state_dict().items())


def _run(cli, argv, jax_cli=False, monkeypatch=None):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if jax_cli:
            monkeypatch.setattr(sys, "argv", ["convert"] + argv)
            cli.main()
        else:
            cli.main(argv)
    return out.getvalue()


def _npz(path):
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def _model_file(tmp_path, fmt):
    tm = _lenet_sd()
    if fmt == "pt":
        path = tmp_path / "lenet.pt"
        torch.save(tm.state_dict(), path)
    elif fmt == "onnx":
        sd = {k: v.numpy() for k, v in tm.state_dict().items()}
        path = tmp_path / "lenet.onnx"
        tonnx.build_onnx_sequential([
            ("Conv", {"w": sd["conv1.weight"], "b": sd["conv1.bias"]}),
            ("MaxPool", {}), ("Conv", {"w": sd["conv2.weight"], "b": sd["conv2.bias"]}),
            ("MaxPool", {}), ("Flatten", {}),
            ("Gemm", {"w": sd["fc1.weight"], "b": sd["fc1.bias"]}),
            ("Gemm", {"w": sd["fc2.weight"], "b": sd["fc2.bias"]})], (1, 1, 28, 28), str(path))
    else:  # a NITI LeNet exported as TFLite (bias-less)
        from mandheling_tpu_torch.models import lenet_niti
        from mandheling_tpu_torch.utils.tflite_model import tflite_from_sequential

        path = tmp_path / "lenet.tflite"
        model = lenet_niti().reset_parameters(torch.Generator().manual_seed(0))
        path.write_bytes(tflite_from_sequential(model, None, (1, 28, 28, 1)))
    return str(path)


@pytest.mark.parametrize("fmt", ["pt", "onnx", "tflite"])
def test_cli_writes_the_jax_clis_checkpoints(tmp_path, monkeypatch, fmt):
    src = _model_file(tmp_path, fmt)
    tcli = load("tools/convert_torch.py", "convert_torch_under_test")
    jcli = load("tools/convert.py", "convert_jax_under_test")
    arch = "lenet_fp32"
    got = _run(tcli, [src, "--arch", arch, "--out", str(tmp_path / "t.npz"), "--quantize"])
    want = _run(jcli, [src, "--arch", arch, "--out", str(tmp_path / "j.npz"), "--quantize"],
                jax_cli=True, monkeypatch=monkeypatch)
    assert got.replace("t.npz", "X").replace("t.niti.npz", "X") == \
        want.replace("j.npz", "X").replace("j.niti.npz", "X")
    for a, b in (("t.npz", "j.npz"), ("t.niti.npz", "j.niti.npz")):
        ta, ja = _npz(tmp_path / a), _npz(tmp_path / b)
        assert list(ta) == list(ja)
        assert_weights_equal(list(ta.values()), list(ja.values()))


def test_cli_mobilenet_v2_from_a_state_dict(tmp_path, monkeypatch):
    model = MobileNetV2FP32(num_classes=10)
    tm = mirrors._torch_from_spec(model).eval()
    src = str(tmp_path / "mbv2.pth")
    torch.save(tm.state_dict(), src)
    tcli = load("tools/convert_torch.py", "convert_torch_under_test")
    jcli = load("tools/convert.py", "convert_jax_under_test")
    argv = [src, "--arch", "mobilenet_v2_fp32", "--num-classes", "10"]
    got = _run(tcli, argv + ["--out", str(tmp_path / "t.npz")])
    want = _run(jcli, argv + ["--out", str(tmp_path / "j.npz")], jax_cli=True,
                monkeypatch=monkeypatch)
    assert got.replace("t.npz", "j.npz") == want
    ta, ja = _npz(tmp_path / "t.npz"), _npz(tmp_path / "j.npz")
    assert list(ta) == list(ja)
    assert_weights_equal(list(ta.values()), list(ja.values()))
