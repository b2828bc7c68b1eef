"""Gradient requant after the (future) cross-replica sum — the local path of
``mandheling_tpu/ops/allreduce.py`` only."""

from __future__ import annotations

import torch

from . import numerics


def grad_allreduce_requant(acc: torch.Tensor, axis_name, margin: int,
                           pc_shift=None) -> torch.Tensor:
    """Requantize an int32 gradient accumulator to the int8 NITI gradient
    (shift = bw - margin). Only the single-replica path (`axis_name` None)
    without per-channel alignment (`pc_shift` None) is ported."""
    if axis_name is not None or pc_shift is not None:
        raise NotImplementedError(
            "cross-replica sums and per-channel alignment are not ported yet"
        )
    return numerics.requant_grad_from_bw(acc, numerics.range_estimate(acc), margin)
