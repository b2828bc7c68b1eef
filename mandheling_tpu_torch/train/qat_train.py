"""The fake-quant training steps of the demos MnistInt8Train and
DistillTrainQuant, which the JAX package writes inline in its CLI
(`tools/run_train_demo.py:106-160, 658-732`): autograd through the
straight-through estimators of nn/qat.py, float momentum SGD. Each step runs
with TF32 off and updates its model's parameters (and, for a LeNetQAT, its
observers) in place.

The steps take tensors only, as the JAX CLI's jitted steps take arrays, so
that `step_graph.compile_step` can capture them: a learning rate that
changes every step is a 0-d tensor, and the dropout generator is bound when
the step is built. A step that draws dropout names its generator in
`step.generators` (step_graph.py registers it with every graph it
captures).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..models.lenet import LeNetFP32
from ..models.lenet_qat import LeNetQAT
from .losses import cross_entropy_with_logits, distill_loss
from .optim import sgd_init, sgd_update
from .trainer import full_float32

DISTILL_TEMPERATURE, DISTILL_ALPHA = 20.0, 0.9
TEACHER_LR, STUDENT_LR = 0.05, 0.01

Lr = Union[float, torch.Tensor]


def _sgd(model: torch.nn.Module) -> Callable[[Callable[[], torch.Tensor], Lr], torch.Tensor]:
    """update(loss_fn, lr) -> loss: one momentum-SGD update of the model's
    parameters on the gradient of loss_fn(), the velocities kept between
    calls."""
    params = list(model.parameters())
    velocity = sgd_init(params)

    def update(loss_fn: Callable[[], torch.Tensor], lr: Lr) -> torch.Tensor:
        with full_float32():
            loss = loss_fn()
            sgd_update(params, torch.autograd.grad(loss, params), velocity, lr)
        return loss.detach()

    return update


def _drawing(step, generator: Optional[torch.Generator]):
    step.generators = () if generator is None else (generator,)
    return step


def make_qat_train_step(model: LeNetQAT, generator: Optional[torch.Generator] = None):
    """MnistInt8Train's step: step(x, onehot, lr) -> loss. x is the
    normalised batch, (pixels / 255 - 0.5) * 2; the loss is the cross
    entropy of the logits; lr is a 0-d tensor of the parameters' dtype (the
    JAX step's traced float; a Python float gives the same bytes eagerly);
    `generator` draws the dropout mask, without one there is no dropout."""
    update = _sgd(model)

    def step(x: torch.Tensor, onehot: torch.Tensor, lr: Lr) -> torch.Tensor:
        return update(lambda: cross_entropy_with_logits(model(x, generator=generator), onehot),
                      lr)

    return _drawing(step, generator)


def make_teacher_step(teacher: LeNetFP32):
    """DistillTrainQuant's teacher pre-training step: step(x, onehot) ->
    loss, cross entropy, SGD at TEACHER_LR."""
    update = _sgd(teacher)

    def step(x: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
        return update(lambda: cross_entropy_with_logits(teacher(x), onehot), TEACHER_LR)

    return step


def make_distill_step(student: LeNetQAT, teacher: LeNetFP32,
                      generator: Optional[torch.Generator] = None):
    """DistillTrainQuant's student step: step(x, onehot) -> loss, the
    distillation loss (T = 20, alpha = 0.9) of the student's logits against
    the frozen teacher's, SGD at STUDENT_LR; `generator` draws the student's
    dropout mask."""
    update = _sgd(student)

    def loss_fn(x, onehot):
        slogits = student(x, generator=generator)
        with torch.no_grad():
            tlogits = teacher(x)
        return distill_loss(slogits, tlogits, onehot, DISTILL_TEMPERATURE, DISTILL_ALPHA)

    def step(x: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
        return update(lambda: loss_fn(x, onehot), STUDENT_LR)

    return _drawing(step, generator)


def predict(model: LeNetQAT, x: torch.Tensor) -> torch.Tensor:
    """Class predictions of an inference forward (observers untouched)."""
    with torch.no_grad(), full_float32():
        return torch.argmax(model(x, training=False), dim=-1)


def make_predict_step(model: LeNetQAT):
    """`predict` as a step, step(x) -> class predictions, for
    `compile_step` (the JAX CLI's jitted predict)."""
    return lambda x: predict(model, x)
