"""QTensor: the (int8 data, power-of-two exponent) pair that NITI threads
through every layer (PyTorch port of ``mandheling_tpu/ops/qtensor.py``).

The exponent is a 0-d int32 tensor on the data's device, as JAX keeps it a
traced scalar: reading it on the host would synchronise the step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QTensor(NamedTuple):
    """int8 data with a per-tensor power-of-two scale exponent."""

    data: torch.Tensor  # int8
    exp: torch.Tensor   # 0-d int32; value = data * 2^exp

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def dequantize(self) -> torch.Tensor:
        """Real-valued view: data * 2^exp (float32)."""
        return self.data.to(torch.float32) * torch.exp2(self.exp.to(torch.float32))


def _max_abs_quantize(y: torch.Tensor) -> QTensor:
    rng = torch.abs(y).amax()
    exp = torch.ceil(torch.log2(rng)).to(torch.int32) - 7
    data = torch.round(y / rng * 127.0).to(torch.int8)
    return QTensor(data, exp)


def quantize_input(x: torch.Tensor) -> QTensor:
    """Standardize a float batch, then max-abs quantize it
    (`demo/MnistUtils.cpp:84-96`): ascale = ceil(log2(max|Y|)) - 7,
    data = round(Y / max|Y| * 127)."""
    x = x.to(torch.float32)
    mean = torch.mean(x)
    std = torch.sqrt(torch.sum((x - mean) ** 2) / x.numel())
    return _max_abs_quantize((x - mean) / std)


def quantize_weights(w: torch.Tensor) -> QTensor:
    """Max-abs power-of-two quantization of the NITI initializer
    (`nn/Distributions.cpp:26-51`)."""
    return _max_abs_quantize(w.to(torch.float32))
