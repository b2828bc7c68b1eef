"""NITI int8 max pooling forward/backward and LeftPoolGrad (port of
``mandheling_tpu/ops/pool.py``; reference `NITI_Maxpool_Int8.cpp:40-206`,
`NITI_CPUPoolGrad_Int8.cpp:21-77`, `NITI_CPULeftPoolGrad_Int8.cpp:18-52`)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import flops
from .kernels import pool_concat_int8 as _pc


@flops.counted(lambda args: (0, 0))
def maxpool2d(
    x: torch.Tensor, x_exp: torch.Tensor,
    window: Sequence[int] = (2, 2), stride: Sequence[int] = (2, 2),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 NHWC VALID max pool; exponent passthrough. Under the "cuda"
    backend K8 (kernels/pool_concat_int8.py) computes it in one launch.
    Counted as no work (ops/flops.py), so that its launches are noted."""
    return _pc.maxpool(x, window, stride), x_exp


@flops.counted(lambda args: (0, 0))
def maxpool2d_grad(
    x: torch.Tensor, y: torch.Tensor, gy: torch.Tensor,
    window: Sequence[int] = (2, 2), stride: Sequence[int] = (2, 2),
) -> torch.Tensor:
    """Route gy to the first (row-major scan order) window position whose
    forward value >= the pooled max (NITI_CPUPoolGrad_Int8.cpp:60-66).
    Overlapping windows accumulate in int32 and clip to +/-127; disjoint
    windows (stride == window) pass gy through. K8 under "cuda"."""
    return _pc.maxpool_grad(x, y, gy, window, stride)


def left_pool_grad(gy: torch.Tensor, out_spatial: Sequence[int],
                   stride: Sequence[int] = (2, 2)) -> torch.Tensor:
    """Zero-insertion upsample: out[y, x] = gy[y/s, x/s] where both divide."""
    sh, sw = stride
    oh, ow = out_spatial
    b, ih, iw, c = gy.shape
    out = gy.new_zeros((b, oh, ow, c))
    ny = min(ih, (oh + sh - 1) // sh)
    nx = min(iw, (ow + sw - 1) // sw)
    out[:, : ny * sh : sh, : nx * sw : sw, :] = gy[:, :ny, :nx, :]
    return out
