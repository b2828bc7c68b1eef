"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), their plain
PyTorch versions, and the backend selector.

| kernel                 | module                 | replaces (TPU kernel)                      |
|------------------------|------------------------|--------------------------------------------|
| `matmul_int8`          | matmul_int8.py         | matmul_int8.py `_matmul_kernel`            |
| `matmul_int16a`        | matmul_int8.py         | K1's int16-A route (MobileNetV2's int16 projection outputs); the JAX package computes it in XLA |
| `fused_matmul_max`     | fused_matmul_int8.py   | fused_matmul_int8.py `_small_max_kernel`, `_max_kernel` |
| `fused_matmul_requant` | fused_matmul_int8.py   | fused_matmul_int8.py `_small_requant_kernel`, `_requant_kernel` |
| `fused_conv_max`       | fused_conv_int8.py     | fused_conv_int8.py `_max_kernel` (`conv_max_pallas`) |
| `fused_conv_requant`   | fused_conv_int8.py     | fused_conv_int8.py `_requant_kernel` (`conv_requant_pallas`) |
| `fused_dwconv_max`     | fused_dwconv_int8.py   | fused_dwconv_int8.py `_max_kernel` (`dwconv_max_pallas`) |
| `fused_dwconv_requant` | fused_dwconv_int8.py   | fused_dwconv_int8.py `_requant_kernel` (`dwconv_requant_pallas`) |
| `fused_dwconv_fgrad`   | fused_dwconv_int8.py   | fused_dwconv_int8.py `_fgrad_kernel` (`dwconv_fgrad_acc_pallas`) |
| `fused_matmul_max_bf16` | fused_matmul_int8.py  | tools/probes/dot_probe.py `make_dot.kernel`, bf16 operands (its int8 variant is `fused_matmul_max`) |
| `requant_int32_absmax`  | requant_int32.py      | no Pallas kernel: the XLA-side range estimate of an int32 accumulator no fused kernel takes (K7 phase 1) |
| `requant_int32_requant` | requant_int32.py      | no Pallas kernel: the XLA-side forward / gradient requant of that accumulator (K7 phase 2) |
| `pool_concat_maxpool`, `pool_concat_maxpool_grad` | pool_concat_int8.py | no Pallas kernel: the XLA-side int8 max pool and its gradient (K8) |
| `pool_concat_avgpool`, `pool_concat_avgpool_grad` | pool_concat_int8.py | no Pallas kernel: the XLA-side zero-padded int8 average pool and its gradient (K8) |
| `pool_concat_concat`    | pool_concat_int8.py   | no Pallas kernel: the XLA-side exponent-aligned channel concat (K8) |
"""

from typing import Dict

from . import (conv_int8, dispatch, fused_conv_int8, fused_dwconv_int8, fused_matmul_int8,
               matmul_int8, pool_concat_int8, requant_int32, stream_state)
from .dispatch import get_backend, set_backend, use_backend

# kernel name -> (module, name of its launch counter)
_COUNTERS = {
    "matmul_int8": (matmul_int8, "LAUNCHES"),
    "matmul_int16a": (matmul_int8, "INT16_LAUNCHES"),
    "fused_matmul_max": (fused_matmul_int8, "MAX_LAUNCHES"),
    "fused_matmul_requant": (fused_matmul_int8, "REQUANT_LAUNCHES"),
    "fused_conv_max": (fused_conv_int8, "MAX_LAUNCHES"),
    "fused_conv_requant": (fused_conv_int8, "REQUANT_LAUNCHES"),
    "fused_dwconv_max": (fused_dwconv_int8, "MAX_LAUNCHES"),
    "fused_dwconv_requant": (fused_dwconv_int8, "REQUANT_LAUNCHES"),
    "fused_dwconv_fgrad": (fused_dwconv_int8, "FGRAD_LAUNCHES"),
    "fused_matmul_max_bf16": (fused_matmul_int8, "MAX_BF16_LAUNCHES"),
    "requant_int32_absmax": (requant_int32, "ABSMAX_LAUNCHES"),
    "requant_int32_requant": (requant_int32, "REQUANT_LAUNCHES"),
    "pool_concat_maxpool": (pool_concat_int8, "MAXPOOL_LAUNCHES"),
    "pool_concat_maxpool_grad": (pool_concat_int8, "MAXPOOL_GRAD_LAUNCHES"),
    "pool_concat_avgpool": (pool_concat_int8, "AVGPOOL_LAUNCHES"),
    "pool_concat_avgpool_grad": (pool_concat_int8, "AVGPOOL_GRAD_LAUNCHES"),
    "pool_concat_concat": (pool_concat_int8, "CONCAT_LAUNCHES"),
}

# the counters of kernels that compute no contraction (K7's requant of an
# accumulator another kernel made, K8's pools and concats): their launch
# notes carry no work
NO_CONTRACTION = frozenset(("requant_int32_absmax", "requant_int32_requant", "pool_concat_maxpool",
                            "pool_concat_maxpool_grad", "pool_concat_avgpool",
                            "pool_concat_avgpool_grad", "pool_concat_concat"))


def launch_counts() -> Dict[str, int]:
    """CUDA launches of each kernel since the last reset."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)


def add_launch_counts(delta: Dict[str, int]) -> None:
    """Add `delta` ({kernel name: launches}) to the counts: a replayed CUDA
    graph adds the launches its capture recorded (train/step_graph.py), so
    that the counts stay launches executed."""
    for name, n in delta.items():
        mod, attr = _COUNTERS[name]
        setattr(mod, attr, getattr(mod, attr) + n)


__all__ = [
    "conv_int8",
    "dispatch",
    "fused_conv_int8",
    "fused_dwconv_int8",
    "fused_matmul_int8",
    "matmul_int8",
    "pool_concat_int8",
    "requant_int32",
    "stream_state",
    "get_backend",
    "set_backend",
    "use_backend",
    "launch_counts",
    "reset_launch_counts",
    "add_launch_counts",
]
