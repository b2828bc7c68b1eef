"""The NITI training and eval steps (port of
``mandheling_tpu/train/train_step.py``): input quantization, forward,
explicit backward, integer update. PyTorch runs them eagerly; nothing in a
step reads a device value on the host.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..nn.module import Sequential
from ..ops.loss import loss_cross_entropy_float, loss_grad_int8
from ..ops.qtensor import QTensor
from .optim import niti_sgd_update


def quantize_batch(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standardize + quantize a float batch like the reference training loop
    (MnistUtils.cpp:84-96) -> (int8 data, 0-d int32 ascale).

    The two moments are summed in float64 and rounded once to float32. For
    integer-valued pixels (what the loader feeds) that makes both sums exact,
    so the result is the same on every device and in every reduction order.
    The JAX package sums in float32: s agrees with it wherever its float32
    sum is exact (below 2^24: batches up to 83 MNIST images); s2 may differ
    in its last bit, which moves only ascale, and only where r/std sits on a
    power of two."""
    x = x.to(torch.float32)
    n = float(x.numel())
    x64 = x.to(torch.float64)
    s = x64.sum().to(torch.float32)
    s2 = (x64 * x64).sum().to(torch.float32)
    mean = s / n
    std = torch.sqrt(torch.clamp_min(s2 / n - mean * mean, 0.0))
    r = torch.abs(x - mean).amax()
    ascale = torch.ceil(torch.log2(r / std)).to(torch.int32) - 7
    data = torch.round((x - mean) * (127.0 / r)).to(torch.int8)
    return data, ascale


def make_train_step(model: Sequential):
    """Returns train_step(x_float, onehot) -> loss (0-d float32 on the
    device), updating the model's weights in place. `onehot` is padded to
    the model's logit width (10 classes in 12 channels for the LeNet)."""

    def train_step(x: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
        data, ascale = quantize_batch(x)
        logits, residuals = model.fwd(QTensor(data, ascale))
        loss = loss_cross_entropy_float(logits.data, logits.exp, onehot)
        g = loss_grad_int8(logits.data, logits.exp, onehot)
        _, grads = model.bwd(residuals, g, need_input_grad=False)
        niti_sgd_update(model, grads)
        return loss

    return train_step


def make_eval_step(model: Sequential, num_classes: int = 10):
    """Returns eval_step(x_float, labels) -> correct count (0-d int32):
    the int8 forward, argmax over the first `num_classes` logit channels
    (the first index on ties, as jnp.argmax)."""

    def eval_step(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        data, ascale = quantize_batch(x)
        logits, _ = model.fwd(QTensor(data, ascale))
        pred = torch.argmax(logits.data[:, :num_classes], dim=-1)
        return (pred == labels).sum(dtype=torch.int32)

    return eval_step
