"""NITI int8 elementwise ops: the exponent-aligned residual add, padding and
the channel concat (port of ``mandheling_tpu/ops/eltwise.py``; reference
`NITI_Eltwise_Int8.cpp:26`, `NITI_PAD_Int8`).

Operands with different exponents are aligned to the larger one by a
truncating right shift before the int32 add; the sum is then requantized
forward-style, so everything stays power-of-two.

With a replica `group`, the add's range estimate is the maximum over the
group, as every forward requant's is, so a data-parallel residual net gives
the single process's bytes. This departs from the JAX package on purpose:
its `add_int8` takes no `axis_name` and estimates on the replica's shard
alone, so where the shards' bitwidths differ, the port's data-parallel
residual net is NOT byte-equal to the JAX package's data-parallel step
(which then also parts from its own single chip; ROADMAP Queue 3). The
group max costs one collective an add a step, counted under the site
"add" (`allreduce.collective_sites`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import allreduce, flops
from .kernels import pool_concat_int8 as _pc
from .kernels import requant_int32 as _rq


@flops.counted(lambda args: (0, 0))
def add_int8(
    a: torch.Tensor, a_exp: torch.Tensor, b: torch.Tensor, b_exp: torch.Tensor,
    out_bits: Optional[int] = None, group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exponent-aligned integer residual add -> (intN, exp_out): align to
    max(a_exp, b_exp) by x >> (max_exp - x_exp), add in int32, forward
    requant. `out_bits` defaults to the wider operand's (15 for int16).
    Under the "cuda" backend K7 (kernels/requant_int32.py) forms the sum in
    registers in both of its phases, so the int32 sum never reaches device
    memory. Counted as no work (ops/flops.py), so that its launches are
    noted."""
    if out_bits is None:
        out_bits = 15 if torch.int16 in (a.dtype, b.dtype) else 7
    acc = _rq.aligned_sum(a, a_exp, b, b_exp)
    m = allreduce.maybe_pmax(_rq.absmax(acc), group, "add")
    return _rq.requant_forward(acc, m, out_bits=out_bits)


def pad_int8(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Symmetric spatial zero-pad of an NHWC tensor (NITI_PAD_Int8)."""
    return F.pad(x, (0, 0, pad, pad, pad, pad))


@flops.counted(lambda args: (0, 0))
def concat_int8(datas: Sequence[torch.Tensor],
                exps: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exponent-aligned channel concat -> (int8, exp_out): every branch is
    right-shifted (truncating) to e = max(exps), which keeps it int8. K8
    (kernels/pool_concat_int8.py) under "cuda": one launch that reads the
    exponents and writes e on the device."""
    return _pc.concat(datas, exps)
