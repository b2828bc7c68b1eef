"""The work of one NITI train step, counted from the shapes of its
contractions: 2 operations a multiply-add; bytes as each contraction's
int8 operands read once and its int8 result written once, elementwise
traffic around it not counted. Every conv and depthwise conv counts its
forward, its filter gradient and, but for the first layer, its input
gradient, each with the forward's multiply-adds (a strided input gradient
counts the forward's products, not those of its zero-dilated form). The
same rule whatever kernel, route or fused mode computes them.

A layer with a weight is a contraction: its multiply-adds are those of its
weight (KH, KW, IC, OC; a depthwise weight's IC is 1) at every output
pixel. Every other layer adds none and changes the shape as its
out_shape() says; a composite layer's branches each start from its input
(reference.py)."""

from __future__ import annotations

import math
from typing import List, NamedTuple


class Contraction(NamedTuple):
    what: str
    macs: int
    bytes: int

    @property
    def ops(self) -> int:
        return 2 * self.macs


def _layer(layer, shape, first: bool, out: List[Contraction]):
    for branch in getattr(layer, "branches", ()):
        _walk(branch, shape, False, out)
    y = layer.out_shape(shape)
    if not hasattr(layer, "weight_shape"):
        return y
    wt = math.prod(layer.weight_shape)
    taps = math.prod(y[:3]) * wt  # multiply-adds of the forward
    x, yb = math.prod(shape), math.prod(y)
    kh, kw = layer.weight_shape[:2]
    name = f"{type(layer).__name__}{kh}x{kw}/{layer.stride[0]} {shape[1:]}->{y[3]}"
    out.append(Contraction(f"{name} fwd", taps, x + wt + yb))
    out.append(Contraction(f"{name} filter grad", taps, yb + x + wt))
    if not first:
        out.append(Contraction(f"{name} input grad", taps, yb + wt + x))
    return y


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
