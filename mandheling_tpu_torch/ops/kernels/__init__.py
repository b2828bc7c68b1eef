"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), their plain
PyTorch versions, and the backend selector.

| kernel                 | module                 | replaces (TPU kernel)                      |
|------------------------|------------------------|--------------------------------------------|
| `matmul_int8`          | matmul_int8.py         | matmul_int8.py `_matmul_kernel`            |
| `fused_matmul_max`     | fused_matmul_int8.py   | fused_matmul_int8.py `_small_max_kernel`, `_max_kernel` |
| `fused_matmul_requant` | fused_matmul_int8.py   | fused_matmul_int8.py `_small_requant_kernel`, `_requant_kernel` |
"""

from typing import Dict

from . import conv_int8, dispatch, fused_matmul_int8, matmul_int8
from .dispatch import get_backend, set_backend, use_backend


def launch_counts() -> Dict[str, int]:
    """CUDA launches of each kernel since the last reset."""
    return {
        "matmul_int8": matmul_int8.LAUNCHES,
        "fused_matmul_max": fused_matmul_int8.MAX_LAUNCHES,
        "fused_matmul_requant": fused_matmul_int8.REQUANT_LAUNCHES,
    }


def reset_launch_counts() -> None:
    matmul_int8.LAUNCHES = 0
    fused_matmul_int8.MAX_LAUNCHES = 0
    fused_matmul_int8.REQUANT_LAUNCHES = 0


__all__ = [
    "conv_int8",
    "dispatch",
    "fused_matmul_int8",
    "matmul_int8",
    "get_backend",
    "set_backend",
    "use_backend",
    "launch_counts",
    "reset_launch_counts",
]
