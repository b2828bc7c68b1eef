"""mandheling_tpu_torch — the PyTorch / CUDA port of ``mandheling_tpu`` for an
NVIDIA H100.

NITI integer-only training (int8 forward and backward, int32 accumulation,
power-of-two per-tensor scales) with every int8 contraction in hand-written
Hopper kernels (``csrc/``). The JAX package ``mandheling_tpu`` is the
reference: the port keeps its layouts (NHWC / HWIO), its module names and its
explicit fwd/bwd layer protocol, and is byte-identical to it. Entry points
run on the card unless the caller passes ``device="cpu"``.

This slice covers the NITI LeNet training path (``NITIDSPInt8Train``).
"""

__version__ = "0.1.0"

from . import data, models, nn, ops, train, utils  # noqa: F401
