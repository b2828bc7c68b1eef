"""The pools and channel concats of a NITI train step: the symbols of the
program's kernels that compute them (K8, `csrc/pool_concat_int8.cu` of the
program), and the least bytes they move, counted from the shapes.

Every tensor a pool or a concat reads or writes is int8 and counts once:

- a max pool reads x and writes y forward; backward it reads x, y and gy
  and writes gx;
- an average pool reads x and writes y forward; backward it reads gy and
  writes gx (its zero pad is not a tensor);
- a concat reads its branches' outputs and writes its output forward; its
  backward hands each branch a channel slice of gy and moves nothing.

The walk is work.py's: a composite layer's branches each start from its
input, and every layer changes the shape as its out_shape() says. Nothing
here imports the program."""

from __future__ import annotations

import math
from typing import List

from h100bench.reference import AvgPool, Concat, MaxPool

# the kernels of the program's K8 source, as the device trace names them
SYMBOLS = ("k8_maxpool_kernel", "k8_maxpool_grad_kernel", "k8_avgpool_kernel",
           "k8_avgpool_grad_kernel", "k8_concat_kernel")


def is_k8(name: str) -> bool:
    """Whether a device activity is one of K8's kernels."""
    return any(s in name for s in SYMBOLS)


def device_us(stretch) -> float:
    """Device microseconds of K8's kernels in a traced stretch."""
    return sum(a.end_us - a.start_us for a in stretch.activities if is_k8(a.name))


def _layer(layer, shape, out: List[int]):
    for branch in getattr(layer, "branches", ()):
        _walk(branch, shape, out)
    y = layer.out_shape(shape)
    x_n, y_n = math.prod(shape), math.prod(y)
    if isinstance(layer, MaxPool):
        out.append((x_n + y_n) + (2 * x_n + 2 * y_n))
    elif isinstance(layer, AvgPool):
        out.append((x_n + y_n) + (y_n + x_n))
    elif isinstance(layer, Concat):
        out.append(2 * y_n)
    return y


def _walk(layers, shape, out: List[int]):
    for layer in layers:
        shape = _layer(layer, shape, out)
    return shape


def site_bytes(layers, input_shape) -> List[int]:
    """The bytes of each pool and concat of one train step of `layers` on a
    batch of `input_shape` (B, H, W, C), in the order of the walk."""
    out: List[int] = []
    _walk(layers, tuple(input_shape), out)
    return out


def step_bytes(layers, input_shape) -> int:
    """The least bytes the pools and concats of one train step move."""
    return sum(site_bytes(layers, input_shape))
