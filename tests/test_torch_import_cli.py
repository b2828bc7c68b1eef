"""The port's import CLI (tools/import_model_torch.py) and its import demos
and image-folder branches (tools/run_train_demo_torch.py) against the JAX
package's tools on the CPU: the same model file gives the same printed
lines and a checkpoint with the same keys and arrays (`--check` and
`--dw-per-channel` too); `OnnxImportTrain`, `TfImportTrain`,
`CaffeImportTrain` and `TFLiteImportTrain` (LeNet's weights carried from
the JAX draw) print the JAX demos' lines; so do `MobilenetV2Transfer
--images-txt` (features and head carried across) and `QuanByMSE` on a
folder of images (the float LeNet carried across)."""

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mandheling_tpu.models import lenet_niti as j_lenet
from mandheling_tpu.utils import caffe_model as jcm
from mandheling_tpu.utils import onnx_io as jonnx
from mandheling_tpu.utils import tf_graphdef as JG
from mandheling_tpu.utils import tflite_model as jtm
from mandheling_tpu_torch.utils.jax_params import load_jax_params
from test_torch_graph_import import _one_torch_thread, assert_weights_equal  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PIL = pytest.importorskip("PIL")


def load(relpath, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / relpath)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tools():
    return dict(timport=load("tools/import_model_torch.py", "import_model_torch_under_test"),
                jimport=load("tools/import_model.py", "import_model_under_test"),
                tdemo=load("tools/run_train_demo_torch.py", "run_train_demo_torch_under_test"),
                jdemo=load("tools/run_train_demo.py", "run_train_demo_under_test"))


def run(main, argv, monkeypatch=None, prog="tool"):
    """main(argv) of the port's tool, or the JAX tool's main() on sys.argv;
    -> its standard output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if monkeypatch is None:
            main(argv)
        else:
            monkeypatch.setattr(sys, "argv", [prog] + argv)
            main()
    return out.getvalue()


def npz(path):
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


# ------------------------------------------------------------ model files


def _onnx_residual(path):
    rng = np.random.default_rng(0)
    jonnx.build_onnx_graph([
        ("Conv", ["input"], ["c"], {"w": rng.normal(0, 0.2, (8, 3, 3, 3)).astype(np.float32),
                                    "pads": (1, 1, 1, 1)}),
        ("Relu", ["c"], ["r"], {}),
        ("Conv", ["r"], ["b"], {"w": rng.normal(0, 0.2, (8, 8, 3, 3)).astype(np.float32),
                                "pads": (1, 1, 1, 1)}),
        ("Add", ["b", "r"], ["gap_in"], {}),
        ("GlobalAveragePool", ["gap_in"], ["g"], {}),
        ("Conv", ["g"], ["out"], {"w": rng.normal(0, 0.2, (12, 8, 1, 1)).astype(np.float32)}),
    ], (1, 3, 16, 16), output="out", path=path)
    return ["--input-shape", "1,3,16,16"]


def _tflite_dw(path):
    """A small depthwise net exported from the JAX package's draw."""
    from mandheling_tpu.nn import blocks as jb
    from mandheling_tpu.nn import layers as jl
    from mandheling_tpu.nn.module import Sequential as JSeq

    model = JSeq([jl.NITIConv2D(3, 8, (3, 3), (1, 1), "SAME", act="relu6"),
                  jb.NITIDepthwiseConv2D(8, (3, 3), (2, 2), "SAME", act="relu6"),
                  jb.ResidualBlock(JSeq([jb.NITIDepthwiseConv2D(8, (3, 3), (1, 1), "SAME")])),
                  jb.GlobalAvgPool(), jl.NITIConv2D(8, 12, (1, 1)), jl.SqueezeLogits()])
    Path(path).write_bytes(jtm.tflite_from_sequential(
        model, model.init(jax.random.PRNGKey(1)), (1, 16, 16, 3)))
    return ["--input-shape", "1,16,16,3"]


def _tf_graph(path):
    rng = np.random.default_rng(1)
    DT = ("dtype", JG.DT_FLOAT)
    c = lambda n, a, t=np.float32: (n, "Const", [], {"dtype": DT, "value": np.asarray(a, t)})  # noqa
    Path(path).write_bytes(JG.build_graphdef([
        ("input", "Placeholder", [], {"dtype": DT}),
        c("w0", rng.normal(0, 0.2, (5, 5, 1, 8))),
        ("conv0", "Conv2D", ["input", "w0"], {"strides": [1, 1, 1, 1], "padding": "SAME"}),
        ("relu0", "Relu", ["conv0"], {}),
        c("axes", [1, 2], np.int32),
        ("gap", "Mean", ["relu0", "axes"], {"keep_dims": True}),
        c("shape", [-1, 8], np.int32),
        ("flat", "Reshape", ["gap", "shape"], {}),
        c("wf", rng.normal(0, 0.1, (8, 12))),
        ("logits", "MatMul", ["flat", "wf"], {"transpose_b": False}),
    ]))
    return ["--format", "tf", "--input-shape", "1,12,12,1", "--output", "logits"]


def _caffe_net(path):
    rng = np.random.default_rng(2)
    F = np.float32
    Path(path).write_bytes(jcm.build_caffemodel([
        ("conv0", "Convolution", ["data"], ["c0"], {"num_output": 8, "kernel_size": 3, "pad": 1},
         [rng.normal(0, 0.2, (8, 1, 3, 3)).astype(F)]),
        ("bn0", "BatchNorm", ["c0"], ["c0"], {"use_global_stats": 1},
         [np.zeros(8, F), np.ones(8, F), np.ones(1, F)]),
        ("sc0", "Scale", ["c0"], ["c0"], {"axis": 1}, [rng.uniform(0.5, 1.5, 8).astype(F)]),
        ("relu0", "ReLU", ["c0"], ["c0"], {}, []),
        ("pool", "Pooling", ["c0"], ["p"], {"pool": 0, "kernel_size": 2, "stride": 2}, []),
        ("fc", "InnerProduct", ["p"], ["logits"], {"num_output": 12},
         [rng.normal(0, 0.1, (12, 8 * 6 * 6)).astype(F)]),
    ], ["data"], [[1, 1, 12, 12]]))
    return ["--input-shape", "1,1,12,12"]


FILES = {"onnx": ("m.onnx", _onnx_residual), "tflite": ("m.tflite", _tflite_dw),
         "tf": ("frozen.pb", _tf_graph), "caffe": ("net.caffemodel", _caffe_net)}


@pytest.mark.parametrize("fmt", sorted(FILES))
@pytest.mark.parametrize("flags", [[], ["--check"], ["--check", "--dw-per-channel"]],
                         ids=["plain", "check", "check-dw"])
def test_import_cli_equals_jax(tools, tmp_path, monkeypatch, fmt, flags):
    name, write = FILES[fmt]
    src = str(tmp_path / name)
    extra = write(src)
    got = run(tools["timport"].main, [src, *extra, *flags, "--out", str(tmp_path / "t.npz"),
                                      "--device", "cpu"])
    want = run(tools["jimport"].main, [src, *extra, *flags, "--out", str(tmp_path / "j.npz")],
               monkeypatch)
    assert got.replace("t.npz", "j.npz") == want
    if "--check" in flags:
        assert "check: one integer train step OK, loss " in got
    if "--dw-per-channel" in flags and fmt == "tflite":
        assert got.startswith("dw-per-channel: upgraded 1 depthwise layers")
    t, j = npz(tmp_path / "t.npz"), npz(tmp_path / "j.npz")
    assert list(t) == list(j)
    assert json.loads(str(t.pop("__meta__"))) == json.loads(str(j.pop("__meta__")))
    assert_weights_equal(list(t.values()), list(j.values()))


def test_import_cli_needs_the_card_unless_asked(tools, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = str(tmp_path / "m.onnx")
    _onnx_residual(src)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tools["timport"].main([src, "--out", str(tmp_path / "t.npz")])


# ------------------------------------------------------------- the demos


@pytest.mark.parametrize("demo", ["OnnxImportTrain", "TfImportTrain", "CaffeImportTrain",
                                  "TFLiteImportTrain"])
def test_import_demos_print_the_jax_lines(tools, monkeypatch, demo):
    """One epoch (16 steps at batch 64) of each demo on synthetic MNIST;
    TFLiteImportTrain's LeNet takes the JAX draw (PRNGKey(0))."""
    if demo == "TFLiteImportTrain":
        jparams = j_lenet().init(jax.random.PRNGKey(0))
        monkeypatch.setattr(tools["tdemo"], "_seeded",
                            lambda model, seed: load_jax_params(model, jparams))
    got = run(tools["tdemo"].main, [demo, "--epochs", "1", "--device", "cpu"])
    want = run(tools["jdemo"].main, [demo, "--epochs", "1"], monkeypatch)
    assert got == want
    assert got.splitlines()[-1].startswith("final loss: ")


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    """64 PNG and JPEG images with labels (one transfer batch)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("folder")
    rng = np.random.default_rng(0)
    lines = []
    for i in range(64):
        name = f"im{i}.{'png' if i % 2 else 'jpg'}"
        Image.fromarray(rng.integers(0, 255, (36, 40, 3)).astype("uint8")).save(root / name,
                                                                                quality=95)
        lines.append(f"{name} {i % 10}")
    (root / "labels.txt").write_text("\n".join(lines) + "\n")
    return root


def test_transfer_on_an_image_folder_prints_the_jax_lines(tools, image_folder, monkeypatch,
                                                          tmp_path):
    """MobilenetV2Transfer root --images-txt: the features from a snapshot
    of the JAX draw, the head the JAX draw (PRNGKey(1)) through the port's
    reset_parameters."""
    from mandheling_tpu.models.mobilenet import mobilenet_v2_niti as j_mnv2
    from mandheling_tpu.nn.layers import NITIConv2D, SqueezeLogits
    from mandheling_tpu.nn.module import Sequential
    from mandheling_tpu.train.transfer import TransferModel
    from mandheling_tpu.utils.checkpoint import save_checkpoint
    from mandheling_tpu_torch.train import transfer as ttransfer

    full = j_mnv2(num_classes=10, width_mult=0.25)
    full_params = full.init(jax.random.PRNGKey(0))
    snap = str(tmp_path / "features.npz")
    save_checkpoint(snap, full_params)
    split = len(full.layers) - 2
    head = Sequential([NITIConv2D(full.layers[split].in_channels, 12, (1, 1)), SqueezeLogits()])
    head_params = TransferModel(Sequential(full.layers[:split]), full_params[:split],
                                head).init(jax.random.PRNGKey(1))
    transfer_from = ttransfer.transfer_from

    def carried(model, num_classes):
        tm = transfer_from(model, num_classes)
        object.__setattr__(tm, "reset_parameters",
                           lambda generator=None: (load_jax_params(tm.head, head_params), tm)[1])
        return tm

    monkeypatch.setattr(ttransfer, "transfer_from", carried)
    argv = ["MobilenetV2Transfer", str(image_folder), "--images-txt",
            str(image_folder / "labels.txt"), "--snapshot", snap, "--epochs", "2"]
    got = run(tools["tdemo"].main, argv + ["--device", "cpu"])
    want = run(tools["jdemo"].main, argv, monkeypatch)
    assert got == want
    assert got.splitlines()[1] == f"ImageDataset: 64 images from {image_folder / 'labels.txt'}"


def test_quan_by_mse_on_an_image_folder_prints_the_jax_lines(tools, image_folder, monkeypatch):
    """QuanByMSE on a folder: ImageNoLabelDataset's 64 images at 28x28, the
    float LeNet the JAX draw (PRNGKey(0))."""
    import mandheling_tpu_torch.models as tmodels
    from mandheling_tpu.models import LeNetFP32 as JLeNet

    jparams = jax.tree.map(np.asarray, JLeNet().init(jax.random.PRNGKey(0)))

    class Carried(tmodels.LeNetFP32):
        def reset_parameters(self, generator=None):
            return self.load_params(jparams)

    monkeypatch.setattr(tmodels, "LeNetFP32", Carried)
    got = run(tools["tdemo"].main, ["QuanByMSE", str(image_folder), "--device", "cpu"])
    want = run(tools["jdemo"].main, ["QuanByMSE", str(image_folder)], monkeypatch)
    assert got.splitlines()[0] == f"calibrating on 64 images from {image_folder}"
    assert got == want
