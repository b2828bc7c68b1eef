"""mandheling_tpu_torch — the PyTorch / CUDA port of ``mandheling_tpu`` for an
NVIDIA H100.

NITI integer-only training (int8 forward and backward, int32 accumulation,
power-of-two per-tensor scales) with every int8 contraction in hand-written
Hopper kernels (``csrc/``). The JAX package ``mandheling_tpu`` is the
reference: the port keeps its layouts (NHWC / HWIO), its module names and its
explicit fwd/bwd layer protocol, and is byte-identical to it. Entry points
run on the card unless the caller passes ``device="cpu"``.

It covers NITI LeNet training (``NITIDSPInt8Train``), NITI MobileNetV2
training per-tensor and as the r5 recipe (``MobilenetV2Train``), the float
LeNet baseline, checkpoints and the demo CLI ``tools/run_train_demo_torch.py``,
and what the package list below names since (ResNets, the zoo, QAT and
transfer, the TFLite / ONNX / TF / Caffe importers in ``utils``, the image
datasets in ``data``).
"""

__version__ = "0.1.0"

from . import data, models, nn, ops, train, utils  # noqa: F401
