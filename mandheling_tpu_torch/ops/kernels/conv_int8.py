"""int8 (and int16 x int8) convolution as im2col + the K1 GEMM (port of
``mandheling_tpu/ops/kernels/conv_int8.py``).

Patch extraction is plain torch data movement on the tensor's device, as
the JAX package leaves it to XLA: zero insertion for lhs dilation, one pad,
and one strided view copied into (B*OH*OW, KH*KW*C) patches. Patch order is
(kh, kw, c), so HWIO weights reshape directly into the GEMM's B operand.
Every int8 conv goes to the GEMM: on CUDA there is no profitability guard.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from . import matmul_int8

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def _dilate_hw(x: torch.Tensor, dh: int, dw: int) -> torch.Tensor:
    """Zero-insertion (lhs dilation) along H and W of an NHWC tensor."""
    if dh == 1 and dw == 1:
        return x
    b, h, w, c = x.shape
    out = x.new_zeros((b, (h - 1) * dh + 1, (w - 1) * dw + 1, c))
    out[:, ::dh, ::dw, :] = x
    return out


def pad_hw(x: torch.Tensor, padding: Pads) -> torch.Tensor:
    """Zero-pad H and W of an NHWC tensor; negative pads crop, as XLA's do."""
    (pt, pb), (pl, pr) = padding
    if (pt, pb, pl, pr) == (0, 0, 0, 0):
        return x
    return F.pad(x, (0, 0, pl, pr, pt, pb))


def im2col(
    x: torch.Tensor,
    kernel: Tuple[int, int],
    strides: Tuple[int, int],
    padding: Pads,
    lhs_dilation: Tuple[int, int] = (1, 1),
    rhs_dilation: Tuple[int, int] = (1, 1),
):
    """NHWC -> ((B*OH*OW, KH*KW*C) patches, (OH, OW)), ordering (kh, kw, c).
    Negative pads crop, as XLA's do."""
    kh, kw = kernel
    sh, sw = strides
    rdh, rdw = rhs_dilation
    x = pad_hw(_dilate_hw(x, *lhs_dilation), padding)
    b, ih, iw, c = x.shape
    oh = (ih - ((kh - 1) * rdh + 1)) // sh + 1
    ow = (iw - ((kw - 1) * rdw + 1)) // sw + 1
    s_b, s_h, s_w, s_c = x.stride()
    windows = x.as_strided(
        (b, oh, ow, kh, kw, c),
        (s_b, s_h * sh, s_w * sw, s_h * rdh, s_w * rdw, s_c),
    )
    return windows.reshape(b * oh * ow, kh * kw * c), (oh, ow)


def conv_acc(
    x: torch.Tensor,
    w: torch.Tensor,
    strides: Tuple[int, int],
    padding: Pads,
    lhs_dilation: Tuple[int, int] = (1, 1),
    rhs_dilation: Tuple[int, int] = (1, 1),
    matmul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = matmul_int8.matmul_acc,
) -> torch.Tensor:
    """int8 or int16 NHWC x int8 HWIO -> int32 NHWC via im2col + `matmul`
    (K1, or its int16-A route, by default; the dispatch layer passes the
    plain version for backend "torch")."""
    kh, kw, ic, oc = w.shape
    patches, (oh, ow) = im2col(x, (kh, kw), strides, padding, lhs_dilation,
                               rhs_dilation)
    acc = matmul(patches, w.reshape(kh * kw * ic, oc))
    return acc.reshape(x.shape[0], oh, ow, oc)
