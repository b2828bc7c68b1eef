"""The work of one NITI train step, counted from the shapes of its
contractions: 2 operations a multiply-add; bytes as each contraction's
int8 operands read once and its int8 result written once, elementwise
traffic around it not counted. Every conv and depthwise conv counts its
forward, its filter gradient and, but for the first layer, its input
gradient, each with the forward's multiply-adds (a strided input gradient
counts the forward's products, not those of its zero-dilated form). The
same rule whatever kernel, route or fused mode computes them."""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

from .reference import Conv, DepthwiseConv, GlobalAvgPool, Residual, same_or_valid


class Contraction(NamedTuple):
    what: str
    macs: int
    bytes: int

    @property
    def ops(self) -> int:
        return 2 * self.macs


def _out_spatial(layer, spatial) -> Tuple[int, int]:
    pads = same_or_valid(layer.padding, layer.kernel, layer.stride, spatial)
    return tuple((n + p[0] + p[1] - k) // s + 1
                 for n, p, k, s in zip(spatial, pads, layer.kernel, layer.stride))


def _layer(layer, shape, first: bool, out: List[Contraction]):
    b, h, w, c = shape
    if isinstance(layer, Residual):
        y = _walk(layer.branch, shape, False, out)
        if layer.proj is not None:
            _layer(layer.proj, shape, False, out)
        return y
    if isinstance(layer, GlobalAvgPool):
        return (b, 1, 1, c)
    if not isinstance(layer, (Conv, DepthwiseConv)):
        return shape
    oh, ow = _out_spatial(layer, (h, w))
    kh, kw = layer.kernel
    depthwise = isinstance(layer, DepthwiseConv)
    oc = c if depthwise else layer.oc
    ic = 1 if depthwise else c
    taps = b * oh * ow * kh * kw * ic * oc  # multiply-adds of the forward
    x, y, wt = b * h * w * c, b * oh * ow * oc, kh * kw * ic * oc
    name = f"{'dw' if depthwise else 'conv'}{kh}x{kw}/{layer.stride[0]} {h}x{w}x{c}->{oc}"
    out.append(Contraction(f"{name} fwd", taps, x + wt + y))
    out.append(Contraction(f"{name} filter grad", taps, y + x + wt))
    if not first:
        out.append(Contraction(f"{name} input grad", taps, y + wt + x))
    return (b, oh, ow, oc)


def _walk(layers, shape, top: bool, out: List[Contraction]):
    for i, layer in enumerate(layers):
        shape = _layer(layer, shape, top and i == 0, out)
    return shape


def contractions(model: List, input_shape) -> List[Contraction]:
    """The contractions of one train step of `model` on a batch of
    `input_shape` (B, H, W, C)."""
    out: List[Contraction] = []
    _walk(model, tuple(input_shape), True, out)
    return out


def step_ops(model: List, input_shape) -> int:
    return sum(c.ops for c in contractions(model, input_shape))


def step_bytes(model: List, input_shape) -> int:
    return sum(c.bytes for c in contractions(model, input_shape))


def bound_seconds(model: List, input_shape, ops_per_s: float, bytes_per_s: float) -> float:
    """Sum over the step's contractions of the larger of its operations over
    the peak operation rate and its bytes over the peak bandwidth."""
    return sum(max(c.ops / ops_per_s, c.bytes / bytes_per_s)
               for c in contractions(model, input_shape))
