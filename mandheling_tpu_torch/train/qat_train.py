"""The fake-quant training steps of the demos MnistInt8Train and
DistillTrainQuant, which the JAX package writes inline in its CLI
(`tools/run_train_demo.py:106-160, 658-732`): autograd through the
straight-through estimators of nn/qat.py, float momentum SGD. Each step runs
with TF32 off and updates its model's parameters (and, for a LeNetQAT, its
observers) in place.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.lenet import LeNetFP32
from ..models.lenet_qat import LeNetQAT
from .losses import cross_entropy_with_logits, distill_loss
from .optim import sgd_init, sgd_update
from .trainer import full_float32

DISTILL_TEMPERATURE, DISTILL_ALPHA = 20.0, 0.9
TEACHER_LR, STUDENT_LR = 0.05, 0.01


def _sgd(model: torch.nn.Module) -> Callable[[Callable[[], torch.Tensor], float], torch.Tensor]:
    """update(loss_fn, lr) -> loss: one momentum-SGD update of the model's
    parameters on the gradient of loss_fn(), the velocities kept between
    calls."""
    params = list(model.parameters())
    velocity = sgd_init(params)

    def update(loss_fn: Callable[[], torch.Tensor], lr: float) -> torch.Tensor:
        with full_float32():
            loss = loss_fn()
            sgd_update(params, torch.autograd.grad(loss, params), velocity, lr)
        return loss.detach()

    return update


def make_qat_train_step(model: LeNetQAT):
    """MnistInt8Train's step: step(x, onehot, lr, generator=None) -> loss.
    x is the normalised batch, (pixels / 255 - 0.5) * 2; the loss is the
    cross entropy of the logits; `generator` draws the dropout mask."""
    update = _sgd(model)

    def step(x, onehot, lr: float, generator: Optional[torch.Generator] = None):
        return update(lambda: cross_entropy_with_logits(model(x, generator=generator), onehot),
                      lr)

    return step


def make_teacher_step(teacher: LeNetFP32):
    """DistillTrainQuant's teacher pre-training step: step(x, onehot) ->
    loss, cross entropy, SGD at TEACHER_LR."""
    update = _sgd(teacher)

    def step(x, onehot):
        return update(lambda: cross_entropy_with_logits(teacher(x), onehot), TEACHER_LR)

    return step


def make_distill_step(student: LeNetQAT, teacher: LeNetFP32):
    """DistillTrainQuant's student step: step(x, onehot, generator=None) ->
    loss, the distillation loss (T = 20, alpha = 0.9) of the student's
    logits against the frozen teacher's, SGD at STUDENT_LR."""
    update = _sgd(student)

    def loss_fn(x, onehot, generator):
        slogits = student(x, generator=generator)
        with torch.no_grad():
            tlogits = teacher(x)
        return distill_loss(slogits, tlogits, onehot, DISTILL_TEMPERATURE, DISTILL_ALPHA)

    def step(x, onehot, generator: Optional[torch.Generator] = None):
        return update(lambda: loss_fn(x, onehot, generator), STUDENT_LR)

    return step


def predict(model: LeNetQAT, x: torch.Tensor) -> torch.Tensor:
    """Class predictions of an inference forward (observers untouched)."""
    with torch.no_grad(), full_float32():
        return torch.argmax(model(x, training=False), dim=-1)
