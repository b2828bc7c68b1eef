"""NITI int8 layers: conv (and FC as a 1x1 conv), relu, relu6, maxpool,
flatten (port of ``mandheling_tpu/nn/layers.py``).

The weight exponent is drawn once by the NITI Xavier scheme and stays
constant during training: NITI-SGD updates only the int8 data.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import conv as conv_ops
from ..ops import pool as pool_ops
from ..ops import relu as relu_ops
from ..ops.qtensor import QTensor
from .init import niti_xavier_int8
from .module import NITILayer


def load_weight(layer: NITILayer, data: np.ndarray, exp: np.ndarray) -> None:
    """Copy host arrays into `layer`'s int8 `w` and int32 `w_exp` buffers,
    whose shapes they must have."""
    data = torch.from_numpy(np.array(data, dtype=np.int8))
    exp = torch.from_numpy(np.array(exp, dtype=np.int32))
    for name, src, dst in (("weight", data, layer.w), ("exponent", exp, layer.w_exp)):
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name} shape {tuple(src.shape)} != {tuple(dst.shape)}")
    layer.w.copy_(data)
    layer.w_exp.copy_(exp)


class NITIConv2D(NITILayer):
    """int8 conv with NITI power-of-two requantization; FC layers are 1x1
    convs over 1x1 spatial. Holds the HWIO int8 weight `w` and its 0-d int32
    exponent `w_exp` as buffers. `act="relu6"` fuses the exponent-aware
    ReLU6 onto the requant and masks its backward by the output."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel: Tuple[int, int] = (1, 1),
        stride: Tuple[int, int] = (1, 1),
        padding="VALID",
        act: Optional[str] = None,
        out_bits: int = 7,
    ):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel = tuple(kernel)
        self.stride = tuple(stride)
        self.padding = padding
        self.act = act
        self.out_bits = int(out_bits)
        kh, kw = self.kernel
        self.register_buffer(
            "w", torch.zeros((kh, kw, in_channels, out_channels), dtype=torch.int8))
        self.register_buffer("w_exp", torch.zeros((), dtype=torch.int32))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        q = niti_xavier_int8(tuple(self.w.shape), generator)
        self.w.copy_(q.data)
        self.w_exp.copy_(q.exp)

    def load_weight(self, data: np.ndarray, exp: np.ndarray) -> None:
        """Set the weight from host arrays (HWIO int8 data, int32 exponent)."""
        load_weight(self, data, exp)

    def weight_numpy(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.w.cpu().numpy(), self.w_exp.cpu().numpy()

    def fwd(self, q: QTensor, group=None):
        y, y_exp = conv_ops.conv2d_forward(
            q.data, q.exp, self.w, self.w_exp, self.stride, self.padding,
            act=self.act, out_bits=self.out_bits, group=group,
        )
        # residual: the forward input (for the filter grad); with a fused
        # act, also the output and its exponent (for the output mask)
        res = q.data if self.act is None else (q.data, y, y_exp)
        return QTensor(y, y_exp), res

    def _unpack(self, res, gy):
        """(x, act-masked gy)."""
        if self.act is None:
            return res, gy
        x, y, y_exp = res
        if self.act == "relu6":
            return x, relu_ops.relu6_grad_from_output(y, y_exp, gy)
        raise ValueError(f"unknown act {self.act!r}")

    def _filter_grad(self, x, gy, group):
        gw = conv_ops.conv2d_filter_grad(x, gy, self.kernel, self.stride, self.padding,
                                         group=group)
        return {"w": QTensor(gw, torch.zeros((), dtype=torch.int32, device=gw.device))}

    def _input_grad(self, x, gy, group):
        return conv_ops.conv2d_input_grad(
            gy, self.w, (x.shape[1], x.shape[2]), self.stride, self.padding, group=group)

    def bwd(self, res, gy, group=None):
        x, gy = self._unpack(res, gy)
        return self._input_grad(x, gy, group), self._filter_grad(x, gy, group)

    def bwd_params_only(self, res, gy, group=None):
        x, gy = self._unpack(res, gy)
        return self._filter_grad(x, gy, group)

    # The int32 accumulator before its requant, for exact gradient sums over
    # pipeline microbatches (JAX `nn/layers.py:100-125`; the reference's
    # split-batch gradient contract: one shift over the whole batch).
    @property
    def grad_margin(self) -> int:
        """The filter-grad requant margin of the deferred (pipeline) requant:
        the global knob, so GPipe matches the single step under a recipe."""
        return conv_ops.get_fgrad_margin()

    def bwd_acc(self, res, gy, group=None, need_input_grad=True):
        """(input grad or None, {"w": int32 filter-grad accumulator})."""
        x, gy = self._unpack(res, gy)
        gx = self._input_grad(x, gy, group) if need_input_grad else None
        return gx, {"w": conv_ops.conv2d_filter_grad_acc(x, gy, self.kernel, self.stride,
                                                          self.padding)}


class NITIRelu(NITILayer):
    def fwd(self, q: QTensor, group=None):
        return QTensor(relu_ops.relu(q.data), q.exp), q.data

    def bwd(self, res, gy, group=None):
        return relu_ops.relu_grad(res, gy), ()


class NITIRelu6(NITILayer):
    """Exponent-aware int8 ReLU6; its residual is the output."""

    def fwd(self, q: QTensor, group=None):
        y = relu_ops.relu6(q.data, q.exp)
        return QTensor(y, q.exp), (y, q.exp)

    def bwd(self, res, gy, group=None):
        y, exp = res
        return relu_ops.relu6_grad_from_output(y, exp, gy), ()


class NITIMaxPool(NITILayer):
    def __init__(self, window=(2, 2), stride=(2, 2)):
        super().__init__()
        self.window = tuple(window)
        self.stride = tuple(stride)

    def fwd(self, q: QTensor, group=None):
        y, e = pool_ops.maxpool2d(q.data, q.exp, self.window, self.stride)
        return QTensor(y, e), (q.data, y)

    def bwd(self, res, gy, group=None):
        x, y = res
        return pool_ops.maxpool2d_grad(x, y, gy, self.window, self.stride), ()


class Flatten(NITILayer):
    """(B, H, W, C) -> (B, 1, 1, H*W*C), NHWC feature order (the JAX
    package's; an NCHW flatten would permute the fc1 inputs)."""

    def fwd(self, q: QTensor, group=None):
        b = q.data.shape[0]
        return QTensor(q.data.reshape(b, 1, 1, -1), q.exp), q.data.shape

    def bwd(self, res, gy, group=None):
        return gy.reshape(res), ()


class SqueezeLogits(NITILayer):
    """(B, 1, 1, C) -> (B, C) for the loss; the grad restores the shape."""

    def fwd(self, q: QTensor, group=None):
        b = q.data.shape[0]
        return QTensor(q.data.reshape(b, -1), q.exp), q.data.shape

    def bwd(self, res, gy, group=None):
        return gy.reshape(res), ()
