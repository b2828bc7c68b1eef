"""Core NITI integer numerics: range estimation and pseudo-stochastic shift.

PyTorch port of ``mandheling_tpu/ops/numerics.py``; every function is bit-exact
with its JAX counterpart. The reference C helpers are
``NITI_int8_clip`` -> :func:`int8_clip`, ``NITI_sign`` -> :func:`int_sign`,
``NITI_RangeEstimate`` -> :func:`range_estimate` and
``NITI_MNNPstoShiftInt32[ToInt8]`` -> :func:`psto_round` / :func:`psto_shift_int8`
(`CommonOptFunction.cpp:1548-1680`).

Shifts and exponents are 0-d int32 tensors on the data's device, so nothing
here synchronises with the host. torch's ``>>`` on int32 is arithmetic and
``.to(torch.int8)`` wraps, both as in JAX.
"""

from __future__ import annotations

import functools

import torch

INT8_MIN = -127  # the reference clips symmetrically to +/-127
INT8_MAX = 127


def int8_clip(x: torch.Tensor) -> torch.Tensor:
    """Clip int32 values to the symmetric int8 range [-127, 127]."""
    return torch.clamp(x, INT8_MIN, INT8_MAX)


def int_sign(x: torch.Tensor) -> torch.Tensor:
    """Integer sign: 1 for positive, -1 for negative, 0 for zero."""
    return torch.sign(x).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _thresholds(device: torch.device) -> torch.Tensor:
    """2^k for k in [0, 31), int32, cached per device."""
    return torch.bitwise_left_shift(
        torch.ones(31, dtype=torch.int32, device=device),
        torch.arange(31, dtype=torch.int32, device=device),
    )


def range_estimate_from_max(m: torch.Tensor) -> torch.Tensor:
    """ceil(log2(m)) for a non-negative int32 max magnitude, as a 0-d int32.

    Counts the k in [0, 31) with 2^k < m, which is exact for every int32
    (a float log2 misrounds near powers of two above 2^24). A negative m
    (abs of INT32_MIN) gives 0, as in JAX."""
    m = m.to(torch.int32)
    return (m > _thresholds(m.device)).sum(dtype=torch.int32)


def range_estimate(acc: torch.Tensor) -> torch.Tensor:
    """bw = ceil(log2(max|acc|)) as an exact 0-d int32; 0 if max == 0."""
    return range_estimate_from_max(torch.abs(acc.to(torch.int32)).amax())


def _as_i32(v, device: torch.device) -> torch.Tensor:
    """0-d int32 tensor on `device`; a Python int becomes a fill, never a
    host-to-device copy (which would synchronise)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32)
    return torch.full((), int(v), dtype=torch.int32, device=device)


def _pow2_mask(s: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_left_shift(torch.ones_like(s), s) - 1


def trunc_shift_div(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """C-style trunc-toward-zero division of int32 by 2^s (s >= 0)."""
    x = x.to(torch.int32)
    s = _as_i32(s, x.device)
    bias = torch.bitwise_and(x >> 31, _pow2_mask(s))
    return (x + bias) >> s


def psto_round(acc: torch.Tensor, shift, rail: int = 127) -> torch.Tensor:
    """Pseudo-stochastic right shift of int32 by `shift` bits -> int32 in
    [-rail, rail]; bit-exact port of ``NITI_MNNPstoShiftInt32``:

        round_temp = trunc(acc / 2^shift)
        prob       = |acc - round_temp * 2^shift|
        qprob      = trunc(prob / 2^(shift/2))
        prand      = (prob - qprob * 2^(shift/2)) * (2 if shift odd else 1)
        out        = clip(round_temp + (qprob > prand) * sign(acc))

    `shift` (an int or a 0-d int32 tensor) is clamped to [0, 30]."""
    acc = acc.to(torch.int32)
    shift = torch.clamp(_as_i32(shift, acc.device), 0, 30)
    bias = torch.bitwise_and(acc >> 31, _pow2_mask(shift))
    round_temp = (acc + bias) >> shift
    prob = torch.abs(acc - torch.bitwise_left_shift(round_temp, shift))
    h = shift >> 1
    odd = torch.bitwise_and(shift, 1)
    qprob = prob >> h
    prand = torch.bitwise_left_shift(torch.bitwise_and(prob, _pow2_mask(h)), odd)
    round_1 = (qprob > prand).to(torch.int32)
    return torch.clamp(round_temp + round_1 * int_sign(acc), -rail, rail)


def psto_shift_int8(acc: torch.Tensor, shift) -> torch.Tensor:
    """:func:`psto_round` cast to int8 (NITI_MNNPstoShiftInt32ToInt8)."""
    return psto_round(acc, shift).to(torch.int8)


def psto_epilogue(acc: torch.Tensor, shift: torch.Tensor, grad: bool) -> torch.Tensor:
    """Phase 2 of the two-phase fused kernels (K2, K3, K4): psto by `shift`
    to int8; the forward variant (`grad` False) wrap-casts when shift <= 0."""
    shift = shift.to(torch.int32)
    shifted = psto_round(acc, shift)
    if grad:
        return shifted.to(torch.int8)
    plain = acc.to(torch.int8).to(torch.int32)
    return torch.where(shift > 0, shifted, plain).to(torch.int8)


def abs_max(acc: torch.Tensor) -> torch.Tensor:
    """max|acc| as a 0-d int32, INT32_MIN for an empty tensor (the identity
    of jnp.max); |INT32_MIN| stays negative, as jnp.abs gives it."""
    if acc.numel() == 0:
        return torch.full((), -(2**31), dtype=torch.int32, device=acc.device)
    return torch.abs(acc.to(torch.int32)).amax()


def forward_shift(bw: torch.Tensor, out_bits: int = 7) -> torch.Tensor:
    """Effective forward shift: bw-out_bits, promoted to 2 when exactly 1,
    0 when <= 0 (NITI_Conv_Int8.cpp:262-305)."""
    shift = bw.to(torch.int32) - out_bits
    return torch.where(
        shift > 1, shift, torch.where(shift == 1, 2, 0).to(torch.int32)
    )


def requant_forward_from_bw(acc: torch.Tensor, exp_in: torch.Tensor,
                            bw: torch.Tensor, out_bits: int = 7):
    """Forward requantization given a precomputed bitwidth: psto shift by
    forward_shift(bw), or a plain wrapping cast when that shift is 0
    (NITI_Conv_Int8.cpp:301-305). Returns (int8/int16 tensor, exp_out)."""
    if out_bits not in (7, 15):
        raise ValueError(f"out_bits must be 7 or 15, got {out_bits}")
    dtype = torch.int8 if out_bits == 7 else torch.int16
    rail = (1 << out_bits) - 1
    eff_shift = forward_shift(bw, out_bits)
    exp_out = exp_in.to(torch.int32) + eff_shift
    shifted = psto_round(acc, eff_shift, rail)
    plain = acc.to(torch.int32).to(dtype).to(torch.int32)
    out = torch.where(eff_shift > 0, shifted, plain)
    return out.to(dtype), exp_out


def requant_forward(acc: torch.Tensor, exp_in: torch.Tensor, out_bits: int = 7):
    """Forward-conv requantization: int32 accumulator -> (intN, exp_out)."""
    return requant_forward_from_bw(acc, exp_in, range_estimate(acc), out_bits)


def requant_grad_from_bw(acc: torch.Tensor, bw: torch.Tensor, margin: int):
    """Gradient requantization with a precomputed bitwidth: shift = bw -
    margin; an all-zero accumulator (bw == 0) gives zero."""
    out = psto_shift_int8(acc, bw - margin)
    return torch.where(bw == 0, torch.zeros_like(out), out)


def requant_grad(acc: torch.Tensor, margin: int):
    """Gradient requantization: shift = bw - margin (margin 2 for conv filter
    grads, 3 for FC grads); all-zero stays zero."""
    return requant_grad_from_bw(acc, range_estimate(acc), margin)
