"""Transfer learning: a frozen feature extractor and a trained head (port of
``mandheling_tpu/train/transfer.py``; reference MobilenetV2Transfer,
`demo/mobilenetV2Train.cpp:29-53`: freeze everything up to the average pool,
train a fresh conv head with the NITI integer update).

`split_params` / `merge_params` partition JAX-layout per-layer params (the
analog of `Transformer::turnModelToTrainable`). In the port the weights live
in the layers, so `TransferModel` holds the two Sequentials themselves: the
features run forward only, keeping no residuals, and only the head's
weights are updated.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..nn.layers import NITIConv2D, SqueezeLogits
from ..nn.module import Sequential
from ..ops import allreduce
from ..ops.loss import loss_cross_entropy_float, loss_grad_int8
from ..ops.qtensor import QTensor
from .optim import niti_sgd_update
from .train_step import quantize_batch


def split_params(params: List[Any], trainable: Sequence[bool]) -> Tuple[List[Any], List[Any]]:
    """Partition per-layer params into (frozen, trainable) lists; the frozen
    list holds None at trainable positions and vice versa."""
    frozen = [None if t else p for p, t in zip(params, trainable)]
    train = [p if t else None for p, t in zip(params, trainable)]
    return frozen, train


def merge_params(frozen: List[Any], train: List[Any]) -> List[Any]:
    return [f if t is None else t for f, t in zip(frozen, train)]


class TransferModel(nn.Module):
    """`features` (a frozen Sequential) -> `head` (a trained Sequential)."""

    def __init__(self, features: Sequential, head: Sequential):
        super().__init__()
        self.features = features
        self.head = head

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> "TransferModel":
        """Draw the head's weights (the JAX `init`); the features keep theirs."""
        self.head.reset_parameters(generator)
        return self

    def extract(self, q: QTensor, group=None) -> QTensor:
        """The frozen forward: each layer's residuals are dropped at once."""
        for layer in self.features.layers:
            q, _ = layer.fwd(q, group)
        return q

    def fwd(self, q: QTensor, group=None):
        return self.head.fwd(self.extract(q, group), group)


def transfer_from(full: Sequential, num_classes: int = 10) -> TransferModel:
    """The MobilenetV2Transfer split of a classifier `full` whose last two
    layers are its classifier conv and SqueezeLogits: every layer before the
    conv frozen (for MobileNetV2, up to and including the global average
    pool), and a fresh head, NITIConv2D(the conv's input width, num_classes
    padded to a multiple of 4) + SqueezeLogits, whose weights are zero until
    drawn or loaded. The features are `full`'s own layers."""
    split = len(full.layers) - 2
    head = Sequential([NITIConv2D(full.layers[split].in_channels, (num_classes + 3) // 4 * 4,
                                  (1, 1)), SqueezeLogits()])
    return TransferModel(Sequential(list(full.layers[:split])), head)


def make_transfer_train_step(model: TransferModel, group=None):
    """train_step(x_float, onehot) -> loss (0-d float32), updating the head's
    weights in place (MobilenetV2Utils::train, `demo/MobilenetV2Utils.cpp:78-100`,
    with the NITI integer update). The backward stops at the head, and skips
    the head's input grad, which nothing reads (under jit the JAX package's
    is dead code that XLA drops): the weights get the same bytes. With
    `group`, as make_train_step's, but the loss is the group's mean (JAX's
    `pmean`, `train/transfer.py:77-78`)."""

    def step(x: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
        data, ascale = quantize_batch(x, group)
        logits, residuals = model.fwd(QTensor(data, ascale), group)
        loss = loss_cross_entropy_float(logits.data, logits.exp, onehot)
        if group is not None:
            loss = allreduce.psum(loss, group) / float(dist.get_world_size(group))
        g = loss_grad_int8(logits.data, logits.exp, onehot)
        _, grads = model.head.bwd(residuals, g, group, need_input_grad=False)
        niti_sgd_update(model.head, grads)
        return loss

    return step


def make_transfer_eval_step(model: TransferModel, num_classes: int = 10):
    """eval_step(x_float, labels) -> correct count (0-d int32), argmax over
    the first `num_classes` logit channels."""

    def eval_step(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        data, ascale = quantize_batch(x)
        logits, _ = model.fwd(QTensor(data, ascale))
        pred = torch.argmax(logits.data[:, :num_classes], dim=-1)
        return (pred == labels).sum(dtype=torch.int32)

    return eval_step
