"""K7: the two-phase NITI requant of an int32 accumulator that no fused
kernel takes, a hand-written Hopper kernel (``csrc/requant_int32.cu``) and
its plain PyTorch version, the ``numerics`` chain as the ops run it.

It replaces no Pallas kernel: the JAX package requantizes these
accumulators in XLA (``range_estimate``, ``requant_forward_from_bw``,
``requant_grad_from_bw``); the kernel gives the same bytes in two launches
where the plain chain takes 20-40.

- phase 1 (:func:`absmax`): max|v| as a 0-d int32 (INT32_MIN for no values,
  |INT32_MIN| kept negative), ended in its own launch with one state a
  stream (stream_state.py).
- between the phases the caller may take the maximum over a replica group
  (``allreduce.maybe_pmax``).
- phase 2 (:func:`requant_forward`, :func:`requant_grad`): the range
  estimate, the shift of the mode, the pseudo-stochastic shift, the cast and
  the optional relu6 cap, all on the device from the 0-d max; the forward
  also gives exp_out as a 0-d int32 written by the kernel.

The values v (:class:`Values`) are an int32 accumulator, optionally shifted
per channel (the last dim) by an int32 vector, left (the depthwise forward)
or by a truncating right shift (the depthwise filter grad), or the
exponent-aligned sum of two int8 / int16 operands (``eltwise.add_int8``),
which the kernel forms in registers. Both phases take the same values.

Bound: bytes (each phase reads the values; phase 2 writes the output), and
phase 2 also the psto epilogue's integer operations on the CUDA cores (see
the CUDA source). A launch is sized here from n and the SM count; nothing
is compiled, tuned or synchronised at a call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .. import numerics
from .. import relu as relu_ops
from . import build, dispatch
from .stream_state import per_stream

# Launches of the CUDA kernels (plain integers; counted where they launch).
ABSMAX_LAUNCHES = 0
REQUANT_LAUNCHES = 0

_INT32_MIN = -(2**31)
_THREADS = 256
_BLOCKS_PER_SM = 4
_ELEMENT_BYTES = {torch.int32: 4, torch.int8: 1, torch.int16: 2}


class Values(NamedTuple):
    """The int32 values a requant site takes: the accumulator `a`, with
    `pc_shift` (int32, its last dim the channels) applied left, or as a
    truncating right shift if `pc_right`; or, with `b`, the sum of int8 /
    int16 `a` and `b` aligned to max(a_exp, b_exp)."""
    a: torch.Tensor
    b: Optional[torch.Tensor] = None
    a_exp: Optional[torch.Tensor] = None
    b_exp: Optional[torch.Tensor] = None
    pc_shift: Optional[torch.Tensor] = None
    pc_right: bool = False


def aligned_sum(a: torch.Tensor, a_exp: torch.Tensor, b: torch.Tensor,
                b_exp: torch.Tensor) -> Values:
    """The values of ``eltwise.add_int8``: a and b truncated to their larger
    exponent and added in int32."""
    return Values(a, b, a_exp, b_exp)


def _values(v) -> Values:
    return v if isinstance(v, Values) else Values(v)


def _plain(v: Values) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(the int32 values, the sum's exponent or None), by the chain's ops."""
    if v.b is not None:
        a_exp, b_exp = v.a_exp.to(torch.int32), v.b_exp.to(torch.int32)
        e = torch.maximum(a_exp, b_exp)
        acc = numerics.trunc_shift_div(v.a, e - a_exp) + numerics.trunc_shift_div(v.b, e - b_exp)
        return acc, e
    if v.pc_shift is None:
        return v.a, None
    if v.pc_right:
        return numerics.trunc_shift_div(v.a, v.pc_shift), None
    return v.a << v.pc_shift, None


def _exp_in(exps: Sequence, device: torch.device) -> torch.Tensor:
    if not exps:
        return torch.zeros((), dtype=torch.int32, device=device)
    e = exps[0].to(torch.int32)
    for x in exps[1:]:
        e = e + x.to(torch.int32)
    return e


def apply_act(y: torch.Tensor, exp_out: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """An activation on a requantized int8 output (relu6: clamp to [0,
    relu6_cap(exp_out)])."""
    if act is None:
        return y
    if y.dtype != torch.int8:
        raise ValueError("fused activations are int8-only")
    if act == "relu6":
        cap = relu_ops.relu6_cap(exp_out).to(torch.int8)
        return torch.clamp_min(torch.minimum(y, cap), 0)
    raise ValueError(f"unknown act {act!r}")


def _check_act(act: Optional[str], out_bits: int) -> None:
    if out_bits not in (7, 15):
        raise ValueError(f"out_bits must be 7 or 15, got {out_bits}")
    if act is not None and out_bits != 7:
        raise ValueError("fused activations are int8-only")
    if act not in (None, "relu6"):
        raise ValueError(f"unknown act {act!r}")


def absmax_plain(v) -> torch.Tensor:
    return numerics.abs_max(_plain(_values(v))[0])


def requant_forward_plain(v, m: torch.Tensor, exps: Sequence = (), out_bits: int = 7,
                          act: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    v = _values(v)
    _check_act(act, out_bits)
    acc, e = _plain(v)
    exp_in = e if e is not None else _exp_in(exps, acc.device)
    y, exp_out = numerics.requant_forward_from_bw(acc, exp_in, numerics.range_estimate_from_max(m),
                                                  out_bits)
    return apply_act(y, exp_out, act), exp_out


def requant_grad_plain(v, m: torch.Tensor, margin: int) -> torch.Tensor:
    acc, _ = _plain(_values(v))
    return numerics.requant_grad_from_bw(acc, numerics.range_estimate_from_max(m), margin)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("requant_int32")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    common = [i, i, p, p, p, p, p, i, i, ll, i]
    lib.mh_k7_absmax.argtypes = common + [p, p, i, p]
    lib.mh_k7_absmax.restype = ctypes.c_int
    lib.mh_k7_requant.argtypes = common + [p, p, p, i, i, i, i, i, p]
    lib.mh_k7_requant.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _blocks(n: int, device: torch.device) -> int:
    """Grid of a phase: a thread per 4 elements, at most _BLOCKS_PER_SM
    blocks an SM (the rest by the grid-stride loop), at least one."""
    want = -(-n // (4 * _THREADS))
    return max(1, min(want, _BLOCKS_PER_SM * _sm_count(device.index)))


def _make_state(device: torch.device) -> torch.Tensor:
    state = torch.zeros(2, dtype=torch.int32, device=device)
    state[0].fill_(_INT32_MIN)
    return state


def _state(device: torch.device, stream: int) -> torch.Tensor:
    """Phase 1's {running max, block ticket} for the CUDA stream `stream` of
    `device` (stream_state.py): {INT32_MIN, 0}, filled on the device once
    while that stream is current; every launch leaves it so."""
    return per_stream(("requant_int32_state", device, stream), lambda: _make_state(device))


def _i32_on(t, device: torch.device) -> torch.Tensor:
    t = numerics._as_i32(t, device)
    if t.numel() != 1:
        raise ValueError(f"an exponent is one int32, got shape {tuple(t.shape)}")
    return t.contiguous()


def _operands(v: Values):
    """K7's operand arguments (type codes, tensors, pc and its direction, C,
    n, vec) and the tensors they point into, checked; the output shape."""
    a, b = v.a, v.b
    if not a.is_cuda:
        raise ValueError(f"K7 needs CUDA tensors, got {a.device}")
    keep = []
    if b is None:
        if a.dtype != torch.int32:
            raise TypeError(f"K7 takes an int32 accumulator, got {a.dtype}")
        a = a.contiguous()
        ta, tb, ea, eb = 4, 0, None, None
    else:
        if a.dtype not in (torch.int8, torch.int16) or b.dtype not in (torch.int8, torch.int16):
            raise TypeError(f"K7's sum takes int8 / int16 operands, got {a.dtype}, {b.dtype}")
        if b.device != a.device:
            raise ValueError(f"K7's sum needs both operands on {a.device}, got {b.device}")
        if a.shape != b.shape:
            a, b = torch.broadcast_tensors(a, b)
        a, b = a.contiguous(), b.contiguous()
        ea, eb = _i32_on(v.a_exp, a.device), _i32_on(v.b_exp, a.device)
        keep += [ea, eb]
        ta, tb = _ELEMENT_BYTES[a.dtype], _ELEMENT_BYTES[b.dtype]
    pc, c = v.pc_shift, 1
    if pc is not None:
        c = a.shape[-1] if a.dim() else 1
        if (b is not None or pc.dtype != torch.int32 or pc.device != a.device or pc.numel() != c
                or pc.dim() > a.dim() or (pc.dim() and pc.shape[-1] != c)):
            raise ValueError(f"pc_shift must be int32 over the last dim ({c}) of an accumulator "
                             f"on {a.device}, got {pc.dtype} {tuple(pc.shape)} on {pc.device}")
        pc = pc.reshape(-1).contiguous()
        keep.append(pc)
    vec = all(t.data_ptr() % 16 == 0 for t in (a, b) if t is not None)
    ptrs = [a.data_ptr(), None if b is None else b.data_ptr(),
            None if ea is None else ea.data_ptr(), None if eb is None else eb.data_ptr(),
            None if pc is None else pc.data_ptr()]
    return [ta, tb, *ptrs, int(v.pc_right), c, a.numel(), int(vec)], (a, b, *keep), a.shape


def absmax_cuda(v) -> torch.Tensor:
    """Phase 1 on the card -> 0-d int32 max|v|, in one launch."""
    global ABSMAX_LAUNCHES
    v = _values(v)
    args, _keep, _ = _operands(v)
    device = v.a.device
    stream = torch.cuda.current_stream(device).cuda_stream
    out = torch.empty((), dtype=torch.int32, device=device)
    err = _lib().mh_k7_absmax(*args, _state(device, stream).data_ptr(), out.data_ptr(),
                              _blocks(args[9], device), stream)
    if err:
        raise RuntimeError(f"requant_int32 absmax kernel launch failed: CUDA error {err}")
    ABSMAX_LAUNCHES += 1
    return out


def _requant_cuda(v: Values, m: torch.Tensor, exps: Sequence, grad: bool, out_bits: int,
                  margin: int, act: Optional[str]):
    global REQUANT_LAUNCHES
    args, _keep, shape = _operands(v)
    device = v.a.device
    if m.device != device or m.numel() != 1:
        raise ValueError("m must be a one-element tensor on the values' device")
    m = m.to(torch.int32).contiguous()
    if not grad and v.b is None:
        if len(exps) > 2:
            raise ValueError(f"K7 adds at most two exponents, got {len(exps)}")
        given = [_i32_on(e, device) for e in exps]
        _keep += tuple(given)
        args[4:6] = [e.data_ptr() for e in given] + [None] * (2 - len(given))
    y = torch.empty(shape, dtype=torch.int16 if not grad and out_bits == 15 else torch.int8,
                    device=device)
    exp_out = None if grad else torch.empty((), dtype=torch.int32, device=device)
    err = _lib().mh_k7_requant(
        *args, m.data_ptr(), y.data_ptr(), None if exp_out is None else exp_out.data_ptr(),
        int(grad), out_bits, margin, int(act == "relu6"), _blocks(args[9], device),
        torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"requant_int32 requant kernel launch failed: CUDA error {err}")
    REQUANT_LAUNCHES += 1
    return y, exp_out


def requant_forward_cuda(v, m: torch.Tensor, exps: Sequence = (), out_bits: int = 7,
                         act: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 2, forward, on the card -> (int8 or int16 y, 0-d int32 exp_out);
    `m` (0-d int32, on the values' device) is read there by the kernel."""
    _check_act(act, out_bits)
    return _requant_cuda(_values(v), m, exps, False, out_bits, 0, act)


def requant_grad_cuda(v, m: torch.Tensor, margin: int) -> torch.Tensor:
    """Phase 2, gradient, on the card -> int8 y."""
    return _requant_cuda(_values(v), m, (), True, 7, int(margin), None)[0]


def _kernel_takes(v) -> bool:
    """The kernel under the "cuda" backend on a CUDA tensor; the plain
    version on any other tensor, and on every one under "torch"."""
    return _values(v).a.is_cuda and dispatch.get_backend() == "cuda"


def absmax(v) -> torch.Tensor:
    """Phase 1: max|v| as a 0-d int32 (`v` a Values or an int32 tensor); the
    kernel or its plain version (:func:`_kernel_takes`)."""
    if _kernel_takes(v):
        return absmax_cuda(v)
    return absmax_plain(v)


def requant_forward(v, m: torch.Tensor, exps: Sequence = (), out_bits: int = 7,
                    act: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 2, the forward requant: (y, exp_out) with exp_out = exp_in +
    forward_shift(bw, out_bits), exp_in the sum of `exps` (0-d int32
    tensors, at most two; none: 0), or the aligned sum's exponent; y int8
    (out_bits 7, optionally relu6-capped) or int16 (out_bits 15)."""
    if _kernel_takes(v):
        return requant_forward_cuda(v, m, exps, out_bits, act)
    return requant_forward_plain(v, m, exps, out_bits, act)


def requant_grad(v, m: torch.Tensor, margin: int) -> torch.Tensor:
    """Phase 2, the gradient requant: psto by bw - margin to int8; zero
    where bw == 0."""
    if _kernel_takes(v):
        return requant_grad_cuda(v, m, margin)
    return requant_grad_plain(v, m, margin)
