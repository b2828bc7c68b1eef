"""The NITI training and eval steps (port of
``mandheling_tpu/train/train_step.py``): input quantization, forward,
explicit backward, integer update. `make_train_step` / `make_eval_step`
run eagerly; nothing in a step reads a device value on the host, so
`jit_train_step` / `jit_eval_step` capture the whole step as a CUDA graph
and replay it (step_graph.py), as the JAX package jits it.

With a replica `group` (a ``torch.distributed`` process group; JAX's
`axis_name`), the batch statistics, every range estimate, the loss and the
eval count are global over the group, so a data-parallel step gives the
single process's bytes (JAX `train/train_step.py:31-115`).
"""

from __future__ import annotations

import itertools
from typing import Tuple

import torch
import torch.distributed as dist

from ..nn.module import Sequential
from ..ops import allreduce
from ..ops.loss import loss_cross_entropy_float, loss_grad_int8
from ..ops.qtensor import QTensor
from .optim import niti_sgd_update
from .step_graph import compile_step


def det_psum(v: torch.Tensor, group) -> torch.Tensor:
    """Order-deterministic float sum over `group`: gather the per-rank
    values and add them in rank order, in v's dtype (JAX `det_psum_f32`,
    `train/train_step.py:31-42`): every rank, in any process layout, sums
    the same partials in the same order."""
    parts = allreduce.all_gather(v, group)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def quantize_batch(x: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standardize + quantize a float batch like the reference training loop
    (MnistUtils.cpp:84-96) -> (int8 data, 0-d int32 ascale).

    The two moments are summed in float64 and rounded once to float32. For
    integer-valued pixels (what the loader feeds) that makes both sums exact,
    so the result is the same on every device and in every reduction order.
    The JAX package sums in float32: s agrees with it wherever its float32
    sum is exact (below 2^24: batches up to 83 MNIST images); s2 may differ
    in its last bit, which moves only ascale, and only where r/std sits on a
    power of two.

    With `group`, the statistics are the global batch's: the per-rank
    float64 partial sums are added in rank order, still in float64, and
    rounded once (exact, so equal to the single process, for integer
    pixels), and r is the maximum over the group."""
    x = x.to(torch.float32)
    x64 = x.to(torch.float64)
    n, s, s2 = float(x.numel()), x64.sum(), (x64 * x64).sum()
    if group is not None:  # the ranks hold equal shards (shard_batch)
        n *= dist.get_world_size(group)
        s, s2 = det_psum(torch.stack([s, s2]), group).unbind()
    s, s2 = s.to(torch.float32), s2.to(torch.float32)
    mean = s / n
    std = torch.sqrt(torch.clamp_min(s2 / n - mean * mean, 0.0))
    r = allreduce.maybe_pmax(torch.abs(x - mean).amax(), group)
    ascale = torch.ceil(torch.log2(r / std)).to(torch.int32) - 7
    data = torch.round((x - mean) * (127.0 / r)).to(torch.int8)
    return data, ascale


def make_train_step(model: Sequential, group=None):
    """Returns train_step(x_float, onehot) -> loss (0-d float64 on the
    device), updating the model's weights in place. `onehot` is padded to
    the model's logit width (10 classes in 12 channels for the LeNet). With
    `group`, x and onehot are this rank's rows of the global batch and the
    loss is the mean of the ranks' losses, summed in rank order."""

    def train_step(x: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
        data, ascale = quantize_batch(x, group)
        logits, residuals = model.fwd(QTensor(data, ascale), group)
        loss = loss_cross_entropy_float(logits.data, logits.exp, onehot)
        if group is not None:
            loss = det_psum(loss, group) / float(dist.get_world_size(group))
        g = loss_grad_int8(logits.data, logits.exp, onehot)
        _, grads = model.bwd(residuals, g, group, need_input_grad=False)
        niti_sgd_update(model, grads)
        return loss

    return train_step


def make_eval_step(model: Sequential, num_classes: int = 10, group=None):
    """Returns eval_step(x_float, labels) -> correct count (0-d int32):
    the int8 forward, argmax over the first `num_classes` logit channels
    (the first index on ties, as jnp.argmax); with `group`, summed over it."""

    def eval_step(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        data, ascale = quantize_batch(x, group)
        logits, _ = model.fwd(QTensor(data, ascale), group)
        pred = torch.argmax(logits.data[:, :num_classes], dim=-1)
        correct = (pred == labels).sum(dtype=torch.int32)
        return correct if group is None else allreduce.psum(correct, group)

    return eval_step


def model_device(model: torch.nn.Module) -> torch.device:
    """The device of the model's weights (the CPU for a model without any)."""
    for t in itertools.chain(model.buffers(), model.parameters()):
        return t.device
    return torch.device("cpu")


def _single_chip(name: str, group) -> None:
    if group is not None:
        raise ValueError(f"{name} is the single-chip step, as the JAX package's; a step over "
                         "a replica group runs eagerly (make_train_step / make_eval_step)")


def jit_train_step(model: Sequential, group=None):
    """The compiled train step (JAX `jit_train_step`,
    `train/train_step.py:118-121`): make_train_step(model) captured as a
    CUDA graph per input signature on the model's device and replayed, the
    weights written in place (the JAX step's donated params); on the CPU the
    eager step itself. Called as the eager step: step(x_float, onehot) ->
    loss. Single-chip: a `group` raises."""
    _single_chip("jit_train_step", group)
    return compile_step(make_train_step(model), model_device(model))


def jit_eval_step(model: Sequential, num_classes: int = 10, group=None):
    """The compiled eval step (JAX `jit_eval_step`): make_eval_step(model,
    num_classes) as `jit_train_step` compiles the train step."""
    _single_chip("jit_eval_step", group)
    return compile_step(make_eval_step(model, num_classes), model_device(model))
