"""NITI int8 max pooling forward/backward and LeftPoolGrad (port of
``mandheling_tpu/ops/pool.py``; reference `NITI_Maxpool_Int8.cpp:40-206`,
`NITI_CPUPoolGrad_Int8.cpp:21-77`, `NITI_CPULeftPoolGrad_Int8.cpp:18-52`)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import numerics


def _windows(x: torch.Tensor, window, stride, out_spatial) -> torch.Tensor:
    """(B, OH, OW, KH, KW, C) strided view of the VALID pooling windows."""
    kh, kw = window
    sh, sw = stride
    oh, ow = out_spatial
    s_b, s_h, s_w, s_c = x.stride()
    return x.as_strided((x.shape[0], oh, ow, kh, kw, x.shape[3]),
                        (s_b, s_h * sh, s_w * sw, s_h, s_w, s_c))


def maxpool2d(
    x: torch.Tensor, x_exp: torch.Tensor,
    window: Sequence[int] = (2, 2), stride: Sequence[int] = (2, 2),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 NHWC VALID max pool; exponent passthrough."""
    kh, kw = window
    sh, sw = stride
    b, ih, iw, c = x.shape
    if (kh, kw) == (sh, sw):
        oh, ow = ih // kh, iw // kw
        xc = x[:, : oh * kh, : ow * kw, :].reshape(b, oh, kh, ow, kw, c)
        return xc.amax(dim=(2, 4)), x_exp
    oh, ow = (ih - kh) // sh + 1, (iw - kw) // sw + 1
    return _windows(x, window, stride, (oh, ow)).amax(dim=(3, 4)), x_exp


def maxpool2d_grad(
    x: torch.Tensor, y: torch.Tensor, gy: torch.Tensor,
    window: Sequence[int] = (2, 2), stride: Sequence[int] = (2, 2),
) -> torch.Tensor:
    """Route gy to the first (row-major scan order) window position whose
    forward value >= the pooled max (NITI_CPUPoolGrad_Int8.cpp:60-66).
    Overlapping windows accumulate in int32 and clip to +/-127."""
    kh, kw = window
    sh, sw = stride
    if (kh, kw) == (sh, sw):
        return _maxpool2d_grad_disjoint(x, y, gy, kh, kw)
    b, ih, iw, c = x.shape
    oh, ow = y.shape[1], y.shape[2]
    win = _windows(x, window, stride, (oh, ow))
    stacked = win.permute(3, 4, 0, 1, 2, 5).reshape(kh * kw, b, oh, ow, c)
    is_max = (stacked >= y[None]).to(torch.int32)
    earlier = torch.cumsum(is_max, dim=0) - is_max
    first = (is_max == 1) & (earlier == 0)  # exactly one per window
    gx = torch.zeros((b, ih, iw, c), dtype=torch.int32, device=x.device)
    zero = torch.zeros_like(gy)
    idx = 0
    for dy in range(kh):
        for dx in range(kw):
            contrib = torch.where(first[idx], gy, zero).to(torch.int32)
            gx[:, dy : dy + (oh - 1) * sh + 1 : sh,
               dx : dx + (ow - 1) * sw + 1 : sw, :] += contrib
            idx += 1
    return numerics.int8_clip(gx).to(torch.int8)


def _maxpool2d_grad_disjoint(x, y, gy, kh: int, kw: int) -> torch.Tensor:
    """stride == window: each input element belongs to exactly one window,
    which routes gy to its first (scan-order) max; int8 end to end."""
    b, ih, iw, c = x.shape
    oh, ow = y.shape[1], y.shape[2]
    xc = x[:, : oh * kh, : ow * kw, :].reshape(b, oh, kh, ow, kw, c)
    taken = torch.zeros((b, oh, ow, c), dtype=torch.bool, device=x.device)
    zero = torch.zeros_like(gy)
    rows = []
    for dy in range(kh):
        cols = []
        for dx in range(kw):
            m = (xc[:, :, dy, :, dx, :] >= y) & ~taken
            taken = taken | m
            cols.append(torch.where(m, gy, zero))
        rows.append(torch.stack(cols, dim=3))  # (b, oh, ow, kw, c)
    gx = torch.stack(rows, dim=2).reshape(b, oh * kh, ow * kw, c)
    if oh * kh < ih or ow * kw < iw:
        gx = F.pad(gx, (0, 0, 0, iw - ow * kw, 0, ih - oh * kh))
    return gx


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
