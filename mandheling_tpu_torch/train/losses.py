"""Float loss functions, the reference's Loss.{hpp,cpp} set (port of
``mandheling_tpu/train/losses.py``; `tools/train/source/optimizer/Loss.cpp`):
cross entropy, KL divergence, MSE, MAE, hinge, and the distillation loss of
Loss.cpp:68-84,

    alpha * T^2 * KL(softmax(student/T) || softmax(teacher/T))
    + (1 - alpha) * CE(softmax(student), onehot).

Each reduces over the last axis and averages over the batch. Probabilities
are floored at 1e-20 before a log. The integer NITI loss is ops/loss.py;
these serve the float and fake-quant paths (MnistInt8Train,
DistillTrainQuant, the gate's lenet_fp32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_FLOOR = 1e-20


def cross_entropy(probs: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """-mean(sum(onehot * log(p))) over the batch (Loss.cpp _CrossEntropy)."""
    return -torch.mean(torch.sum(onehot * torch.log(torch.clamp_min(probs, _FLOOR)), -1))


def cross_entropy_with_logits(logits: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    return -torch.mean(torch.sum(onehot * F.log_softmax(logits, dim=-1), -1))


def kl_divergence(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """mean KL(target || pred) over the batch for probability inputs."""
    t = torch.clamp_min(target, _FLOOR)
    return torch.mean(torch.sum(
        target * (torch.log(t) - torch.log(torch.clamp_min(pred, _FLOOR))), -1))


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.sum((pred - target) ** 2, -1))


def mae(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.sum(torch.abs(pred - target), -1))


def hinge(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.sum(torch.clamp_min(1.0 - pred * target, 0.0), -1))


def distill_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                 onehot: torch.Tensor, temperature: float = 20.0,
                 alpha: float = 0.9) -> torch.Tensor:
    """Knowledge-distillation loss, exactly Loss.cpp:68-84."""
    soft_targets = F.softmax(teacher_logits / temperature, dim=-1)
    student_soft = F.softmax(student_logits / temperature, dim=-1)
    loss1 = temperature * temperature * kl_divergence(student_soft, soft_targets)
    loss2 = cross_entropy(F.softmax(student_logits, dim=-1), onehot)
    return alpha * loss1 + (1.0 - alpha) * loss2
