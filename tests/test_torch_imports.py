"""The port stands alone: no module of mandheling_tpu_torch, and none of
chip_smoke.py, tools/profile_torch_step.py, the demo CLI
tools/run_train_demo_torch.py, the training gate tools/test_train_torch.py,
the importer and converter CLIs tools/import_model_torch.py and
tools/convert_torch.py and the probe tools/probes/dot_probe_torch.py,
imports jax or anything of the JAX package (not even a module there that
uses no jax)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "mandheling_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch_step.py",
    ROOT / "tools" / "run_train_demo_torch.py", ROOT / "tools" / "test_train_torch.py",
    ROOT / "tools" / "import_model_torch.py", ROOT / "tools" / "convert_torch.py",
    ROOT / "tools" / "probes" / "dot_probe_torch.py"]
FORBIDDEN = ("jax", "jaxlib", "mandheling_tpu")


def imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted({m for m in imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_sees_the_package():
    assert len(FILES) > 20
    assert (ROOT / "chip_smoke.py").exists()
    names = {str(p.relative_to(ROOT / "mandheling_tpu_torch")) for p in FILES
             if ROOT / "mandheling_tpu_torch" in p.parents}
    for module in ("ops/depthwise.py", "ops/eltwise.py", "ops/kernels/fused_conv_int8.py",
                   "ops/kernels/fused_dwconv_int8.py", "nn/blocks.py", "models/mobilenet.py",
                   "data/cifar.py", "nn/transform.py", "utils/checkpoint.py",
                   "models/resnet.py", "models/resnet_fp32.py", "models/mobilenet_fp32.py",
                   "models/squeezenet.py", "models/inception.py", "ops/softmax.py",
                   "ops/matmul.py", "train/losses.py", "nn/qat.py", "models/lenet_qat.py",
                   "train/qat_train.py", "train/transfer.py", "utils/calibration.py",
                   "data/image.py", "data/native.py", "utils/flatbuf.py", "utils/tflite_io.py",
                   "utils/onnx_io.py", "utils/onnx_proto/onnx_subset_pb2.py",
                   "utils/tf_graphdef.py", "utils/graph_import.py", "utils/tflite_model.py",
                   "utils/onnx_model.py", "utils/tf_model.py", "utils/caffe_model.py",
                   "utils/convert.py"):
        assert module in names


@pytest.mark.parametrize("module", [
    "mandheling_tpu_torch.ops.depthwise", "mandheling_tpu_torch.ops.eltwise",
    "mandheling_tpu_torch.ops.kernels.fused_conv_int8",
    "mandheling_tpu_torch.ops.kernels.fused_dwconv_int8", "mandheling_tpu_torch.nn.blocks",
    "mandheling_tpu_torch.models.mobilenet", "mandheling_tpu_torch.data.cifar",
    "mandheling_tpu_torch.nn.transform", "mandheling_tpu_torch.utils.checkpoint",
    "mandheling_tpu_torch.train.trainer", "mandheling_tpu_torch.models.resnet",
    "mandheling_tpu_torch.models.resnet_fp32", "mandheling_tpu_torch.models.mobilenet_fp32",
    "mandheling_tpu_torch.models.squeezenet", "mandheling_tpu_torch.models.inception",
    "mandheling_tpu_torch.ops.softmax", "mandheling_tpu_torch.ops.matmul",
    "mandheling_tpu_torch.train.losses", "mandheling_tpu_torch.nn.qat",
    "mandheling_tpu_torch.models.lenet_qat", "mandheling_tpu_torch.train.qat_train",
    "mandheling_tpu_torch.train.transfer", "mandheling_tpu_torch.utils.calibration",
    "mandheling_tpu_torch.data.image", "mandheling_tpu_torch.data.native",
    "mandheling_tpu_torch.utils.flatbuf", "mandheling_tpu_torch.utils.tflite_io",
    "mandheling_tpu_torch.utils.onnx_io", "mandheling_tpu_torch.utils.tf_graphdef",
    "mandheling_tpu_torch.utils.graph_import", "mandheling_tpu_torch.utils.tflite_model",
    "mandheling_tpu_torch.utils.onnx_model", "mandheling_tpu_torch.utils.tf_model",
    "mandheling_tpu_torch.utils.caffe_model", "mandheling_tpu_torch.utils.convert"])
def test_new_modules_import_without_building(module):
    """Importing a kernel module builds nothing: the build happens at the
    first launch, on the card."""
    import importlib

    from mandheling_tpu_torch.ops.kernels import build

    importlib.import_module(module)
    assert not build._loaded
