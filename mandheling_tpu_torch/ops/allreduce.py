"""Gradient requant after the (future) cross-replica sum — the local path of
``mandheling_tpu/ops/allreduce.py`` only."""

from __future__ import annotations

from typing import Optional

import torch

from . import numerics


def grad_allreduce_requant(acc: torch.Tensor, axis_name, margin: int,
                           pc_shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Requantize an int32 gradient accumulator to the int8 NITI gradient
    (shift = bw - margin). `pc_shift`, the per-channel depthwise alignment
    (a broadcastable int32 tensor of right shifts), is applied first, with
    truncating division. Only the single-replica path (`axis_name` None) is
    ported."""
    if axis_name is not None:
        raise NotImplementedError("cross-replica sums are not ported yet")
    if pc_shift is not None:
        acc = numerics.trunc_shift_div(acc, pc_shift)
    return numerics.requant_grad_from_bw(acc, numerics.range_estimate(acc), margin)
