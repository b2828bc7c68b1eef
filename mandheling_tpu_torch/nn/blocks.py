"""Composite NITI layers: depthwise conv, average pools, the parallel
joins and the residual blocks (port of ``mandheling_tpu/nn/blocks.py``, and
of the projected block of ``mandheling_tpu/models/resnet.py``).

The residual add is the int8 eltwise of the reference with a NOP gradient
(`NITI_Eltwise_Int8.cpp`, `grad/NITI_DSPBinaryGrad.cpp:27-32`): the output
diff passes unchanged to both paths, and where two gradient paths meet the
contributions are summed and clipped to int8 (`grad/OpGrad.cpp:64-128`).
The channel concat's gradient is a channel split: each branch gets its own
slice of the output diff.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import depthwise as dw_ops
from ..ops import eltwise as elt_ops
from ..ops import relu as relu_ops
from ..ops.numerics import int8_clip
from ..ops.qtensor import QTensor
from .init import niti_xavier_int8, niti_xavier_int8_dw_per_channel
from .layers import load_weight
from .module import NITILayer, Sequential


def _accum_grads(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return int8_clip(a.to(torch.int32) + b.to(torch.int32)).to(torch.int8)


class NITIDepthwiseConv2D(NITILayer):
    """int8 depthwise conv with the (KH, KW, 1, C) weight `w`. Its exponent
    `w_exp` is 0-d, or a (C,) vector with `per_channel=True` (drawn by
    ``niti_xavier_int8_dw_per_channel``, aligned by ops/depthwise.py)."""

    def __init__(self, channels: int, kernel=(3, 3), stride=(1, 1), padding="SAME",
                 per_channel: bool = False, act: Optional[str] = None):
        super().__init__()
        self.channels = channels
        self.kernel = tuple(kernel)
        self.stride = tuple(stride)
        self.padding = padding
        self.per_channel = per_channel
        self.act = act
        kh, kw = self.kernel
        self.register_buffer("w", torch.zeros((kh, kw, 1, channels), dtype=torch.int8))
        self.register_buffer(
            "w_exp", torch.zeros((channels,) if per_channel else (), dtype=torch.int32))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init = niti_xavier_int8_dw_per_channel if self.per_channel else niti_xavier_int8
        q = init(tuple(self.w.shape), generator)
        self.w.copy_(q.data)
        self.w_exp.copy_(q.exp)

    def load_weight(self, data: np.ndarray, exp: np.ndarray) -> None:
        """Set the weight from host arrays; a per-channel exponent vector
        must pass the alignment cap's spread check."""
        load_weight(self, data, exp)
        dw_ops.check_pc_spread(self.w_exp, self.kernel[0] * self.kernel[1])

    def weight_numpy(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.w.cpu().numpy(), self.w_exp.cpu().numpy()

    def fwd(self, q: QTensor, group=None):
        y, e = dw_ops.dwconv2d_forward(q.data, q.exp, self.w, self.w_exp, self.stride,
                                       self.padding, act=self.act, group=group)
        res = q.data if self.act is None else (q.data, y, e)
        return QTensor(y, e), res

    def bwd(self, res, gy, group=None):
        if self.act is None:
            x = res
        elif self.act == "relu6":
            x, y, y_exp = res
            gy = relu_ops.relu6_grad_from_output(y, y_exp, gy)
        else:
            raise ValueError(f"unknown act {self.act!r}")
        w_exp = self.w_exp if self.per_channel else None
        gx = dw_ops.dwconv2d_input_grad(gy, self.w, (x.shape[1], x.shape[2]), self.stride,
                                        self.padding, w_exp=w_exp, group=group)
        gw = dw_ops.dwconv2d_filter_grad(x, gy, self.kernel, self.stride, self.padding,
                                         w_exp=w_exp, group=group)
        return gx, {"w": QTensor(gw, torch.zeros((), dtype=torch.int32, device=gw.device))}


class NITIAvgPool(NITILayer):
    """int8 average pool. `pad` > 0 zero-pads each spatial side before a
    VALID pool (the divisor stays |window|); the pad is read as zeros, and
    the gradient is the unpadded input's (ops/depthwise.avgpool2d_int8)."""

    def __init__(self, window=(2, 2), stride=None, pad: int = 0):
        super().__init__()
        self.window = tuple(window)
        self.stride = tuple(stride) if stride else tuple(window)
        self.pad = int(pad)

    def fwd(self, q: QTensor, group=None):
        y, e = dw_ops.avgpool2d_int8(q.data, q.exp, self.window, self.stride, pad=self.pad)
        return QTensor(y, e), q.data.shape

    def bwd(self, res, gy, group=None):
        return dw_ops.avgpool2d_grad(gy, (res[1], res[2]), self.window, self.stride,
                                     pad=self.pad), ()


class GlobalAvgPool(NITILayer):
    """(B, H, W, C) -> (B, 1, 1, C): the int32 sum over H and W divided by
    H*W, truncated toward zero; the grad spreads gy / (H*W) back."""

    def fwd(self, q: QTensor, group=None):
        _, h, w, _ = q.data.shape
        acc = q.data.to(torch.int32).sum(dim=(1, 2), keepdim=True, dtype=torch.int32)
        out = torch.div(acc, h * w, rounding_mode="trunc")
        return QTensor(int8_clip(out).to(torch.int8), q.exp), q.data.shape

    def bwd(self, res, gy, group=None):
        b, h, w, c = res
        g = torch.div(gy.to(torch.int32), h * w, rounding_mode="trunc")
        return int8_clip(g.expand(b, h, w, c)).to(torch.int8), ()


class _Parallel(NITILayer):
    """Branches that all read the same input. Their grads are a list with
    one list per branch, as the JAX package nests them; the backward sums
    the branches' input grads in branch order."""

    def __init__(self, branches: Sequence[Sequential]):
        super().__init__()
        self.branches = nn.ModuleList(branches)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for branch in self.branches:
            branch.reset_parameters(generator)

    def _fwd_branches(self, q: QTensor, group):
        outs, ress = [], []
        for branch in self.branches:
            out, r = branch.fwd(q, group)
            outs.append(out)
            ress.append(r)
        return outs, ress

    def _bwd_branches(self, ress, gys, group):
        gx, grads = None, []
        for branch, r, g in zip(self.branches, ress, gys):
            g_in, g_p = branch.bwd(r, g, group)
            grads.append(g_p)
            gx = g_in if gx is None else _accum_grads(gx, g_in)
        return gx, grads


class ParallelConcat(_Parallel):
    """Runs the branches on the same input and joins their outputs on the
    channel axis, exponent-aligned (ops/eltwise.concat_int8): SqueezeNet's
    Fire modules and the Inception modules. Each branch's backward gets its
    own channel slice of gy, a strided view."""

    def fwd(self, q: QTensor, group=None):
        outs, ress = self._fwd_branches(q, group)
        y, e = elt_ops.concat_int8([o.data for o in outs], [o.exp for o in outs])
        return QTensor(y, e), (ress, tuple(o.data.shape[-1] for o in outs))

    def bwd(self, res, gy, group=None):
        ress, sizes = res
        gys, off = [], 0
        for c in sizes:
            gys.append(gy[..., off:off + c])
            off += c
        return self._bwd_branches(ress, gys, group)


class ParallelAdd(_Parallel):
    """Runs the branches on the same input and joins them with the
    exponent-aligned int8 add (ops/eltwise.add_int8), left to right. An
    empty branch (``Sequential([])``) is the identity skip, so
    ``ParallelAdd([main, Sequential([])])`` is ``ResidualBlock(main)``.
    Every branch's backward gets all of gy."""

    def __init__(self, branches: Sequence[Sequential]):
        if len(branches) < 2:
            raise ValueError("ParallelAdd needs >= 2 branches")
        super().__init__(branches)

    def fwd(self, q: QTensor, group=None):
        outs, ress = self._fwd_branches(q, group)
        y, e = outs[0].data, outs[0].exp
        for o in outs[1:]:
            y, e = elt_ops.add_int8(y, e, o.data, o.exp, group=group)
        return QTensor(y, e), ress

    def bwd(self, res, gy, group=None):
        return self._bwd_branches(res, [gy] * len(self.branches), group)


class ResidualBlock(NITILayer):
    """y = requant(branch(x) + x), exponent-aligned (ops/eltwise.add_int8).
    Its grads are the branch's list, as the JAX package nests them."""

    def __init__(self, branch: Sequential):
        super().__init__()
        self.branch = branch

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.branch.reset_parameters(generator)

    def fwd(self, q: QTensor, group=None):
        out, res = self.branch.fwd(q, group)
        y, e = elt_ops.add_int8(out.data, out.exp, q.data, q.exp, group=group)
        return QTensor(y, e), res

    def bwd(self, res, gy, group=None):
        g_branch_in, grads = self.branch.bwd(res, gy, group)
        return _accum_grads(g_branch_in, gy), grads


class ProjectedResidualBlock(NITILayer):
    """y = requant(branch(x) + proj(x)) with a 1x1 strided projection on the
    skip path (the standard ResNet downsample; the JAX package defines it in
    models/resnet.py, which re-exports this one). The backward runs the
    branch, then the projection, both on the same gy, and sums their input
    grads. Its grads are ``{"branch": [...], "proj": {"w": ...}}``, the JAX
    nesting."""

    def __init__(self, branch: Sequential, proj: NITILayer):
        super().__init__()
        self.branch = branch
        self.proj = proj

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.branch.reset_parameters(generator)
        self.proj.reset_parameters(generator)

    def fwd(self, q: QTensor, group=None):
        out, res_b = self.branch.fwd(q, group)
        skip, res_p = self.proj.fwd(q, group)
        y, e = elt_ops.add_int8(out.data, out.exp, skip.data, skip.exp, group=group)
        return QTensor(y, e), (res_b, res_p)

    def bwd(self, res, gy, group=None):
        res_b, res_p = res
        g_in_b, g_branch = self.branch.bwd(res_b, gy, group)
        g_in_p, g_proj = self.proj.bwd(res_p, gy, group)
        return _accum_grads(g_in_b, g_in_p), {"branch": g_branch, "proj": g_proj}
