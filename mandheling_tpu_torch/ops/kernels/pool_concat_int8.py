"""K8: the NITI int8 max pool, the zero-padded average pool (forward and
backward each) and the exponent-aligned channel concat, a hand-written
Hopper kernel a function (``csrc/pool_concat_int8.cu``) beside its plain
PyTorch version, the chain the ops ran before (the JAX package's ops,
op for op).

It replaces no Pallas kernel: the JAX package leaves these ops to XLA
(``ops/pool.py``, ``ops/depthwise.py``'s average pool, ``ops/eltwise.py``'s
pad and concat). Each kernel gives the chain's bytes in one launch, where
the chain takes 5-40 and, in the max pool's backward, int64 and int32
temporaries of many times the tensor:

- :func:`maxpool` / :func:`maxpool_grad`: VALID, any window and stride; the
  gradient goes to each window's first position (row-major) at its max,
  overlapping windows summed in int32 and clipped; where windows do not
  overlap, gy passes unclipped, as the chain's disjoint form gives it.
- :func:`avgpool` / :func:`avgpool_grad`: `pad` zero pixels a side, read
  as zeros inside the kernel (no padded copy); the gradient is written for
  the unpadded input (no crop).
- :func:`concat`: every branch shifted to the largest exponent into its
  channel slice of the output, in one launch; the exponents are read and
  the output exponent written on the device.

Under the "cuda" backend a CUDA tensor of a form the kernel takes
(`supports_*`) launches it; every other tensor, and every one under
"torch", takes the plain version. Nothing is compiled, tuned or
synchronised at a call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import numerics
from . import build, dispatch
from .conv_int8 import _dilate_hw

# Launches of the CUDA kernels (plain integers; counted where they launch).
MAXPOOL_LAUNCHES = 0
MAXPOOL_GRAD_LAUNCHES = 0
AVGPOOL_LAUNCHES = 0
AVGPOOL_GRAD_LAUNCHES = 0
CONCAT_LAUNCHES = 0

MAX_BRANCHES = 8
_KINDS = {"maxpool": 0, "maxpool_grad": 1, "avgpool": 2, "avgpool_grad": 3}

Pair = Tuple[int, int]


def _pair(v: Sequence[int]) -> Pair:
    return int(v[0]), int(v[1])


def pooled(spatial: Pair, window: Pair, stride: Pair, pad: int = 0) -> Pair:
    """The output (OH, OW) of a VALID pool over `spatial` padded by `pad`."""
    return tuple((n + 2 * pad - k) // s + 1 for n, k, s in zip(spatial, window, stride))


# ------------------------------------------------------------------ plain

def _windows(x: torch.Tensor, window, stride, out_spatial) -> torch.Tensor:
    """(B, OH, OW, KH, KW, C) strided view of the VALID pooling windows."""
    kh, kw = window
    sh, sw = stride
    oh, ow = out_spatial
    s_b, s_h, s_w, s_c = x.stride()
    return x.as_strided((x.shape[0], oh, ow, kh, kw, x.shape[3]),
                        (s_b, s_h * sh, s_w * sw, s_h, s_w, s_c))


def maxpool_plain(x: torch.Tensor, window=(2, 2), stride=(2, 2)) -> torch.Tensor:
    kh, kw = window
    sh, sw = stride
    b, ih, iw, c = x.shape
    if (kh, kw) == (sh, sw):
        oh, ow = ih // kh, iw // kw
        xc = x[:, : oh * kh, : ow * kw, :].reshape(b, oh, kh, ow, kw, c)
        return xc.amax(dim=(2, 4))
    oh, ow = (ih - kh) // sh + 1, (iw - kw) // sw + 1
    return _windows(x, window, stride, (oh, ow)).amax(dim=(3, 4))


def _maxpool_grad_disjoint(x, y, gy, kh: int, kw: int) -> torch.Tensor:
    """stride == window: each input element belongs to exactly one window,
    which routes gy to its first (scan-order) max; int8 end to end."""
    b, ih, iw, c = x.shape
    oh, ow = y.shape[1], y.shape[2]
    xc = x[:, : oh * kh, : ow * kw, :].reshape(b, oh, kh, ow, kw, c)
    taken = torch.zeros((b, oh, ow, c), dtype=torch.bool, device=x.device)
    zero = torch.zeros_like(gy)
    rows = []
    for dy in range(kh):
        cols = []
        for dx in range(kw):
            m = (xc[:, :, dy, :, dx, :] >= y) & ~taken
            taken = taken | m
            cols.append(torch.where(m, gy, zero))
        rows.append(torch.stack(cols, dim=3))  # (b, oh, ow, kw, c)
    gx = torch.stack(rows, dim=2).reshape(b, oh * kh, ow * kw, c)
    if oh * kh < ih or ow * kw < iw:
        gx = F.pad(gx, (0, 0, 0, iw - ow * kw, 0, ih - oh * kh))
    return gx


def maxpool_grad_plain(x: torch.Tensor, y: torch.Tensor, gy: torch.Tensor, window=(2, 2),
                       stride=(2, 2)) -> torch.Tensor:
    kh, kw = window
    sh, sw = stride
    if (kh, kw) == (sh, sw):
        return _maxpool_grad_disjoint(x, y, gy, kh, kw)
    b, ih, iw, c = x.shape
    oh, ow = y.shape[1], y.shape[2]
    win = _windows(x, window, stride, (oh, ow))
    stacked = win.permute(3, 4, 0, 1, 2, 5).reshape(kh * kw, b, oh, ow, c)
    is_max = (stacked >= y[None]).to(torch.int32)
    earlier = torch.cumsum(is_max, dim=0) - is_max
    first = (is_max == 1) & (earlier == 0)  # exactly one per window
    gx = torch.zeros((b, ih, iw, c), dtype=torch.int32, device=x.device)
    zero = torch.zeros_like(gy)
    idx = 0
    for dy in range(kh):
        for dx in range(kw):
            contrib = torch.where(first[idx], gy, zero).to(torch.int32)
            gx[:, dy : dy + (oh - 1) * sh + 1 : sh,
               dx : dx + (ow - 1) * sw + 1 : sw, :] += contrib
            idx += 1
    return numerics.int8_clip(gx).to(torch.int8)


def avgpool_plain(x: torch.Tensor, window, stride, pad: int = 0) -> torch.Tensor:
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    kh, kw = window
    sh, sw = stride
    b, ih, iw, c = x.shape
    oh, ow = (ih - kh) // sh + 1, (iw - kw) // sw + 1
    acc = torch.zeros((b, oh, ow, c), dtype=torch.int32, device=x.device)
    for dy in range(kh):
        for dx in range(kw):
            acc += x[:, dy:dy + (oh - 1) * sh + 1:sh, dx:dx + (ow - 1) * sw + 1:sw, :].to(torch.int32)
    out = torch.div(acc, kh * kw, rounding_mode="trunc")
    return numerics.int8_clip(out).to(torch.int8)


def avgpool_grad_plain(gy: torch.Tensor, x_spatial: Pair, window, stride,
                       pad: int = 0) -> torch.Tensor:
    kh, kw = window
    sh, sw = stride
    ih, iw = x_spatial[0] + 2 * pad, x_spatial[1] + 2 * pad
    g = torch.div(gy.to(torch.int32), kh * kw, rounding_mode="trunc")
    b, oh, ow, c = gy.shape
    dil = _dilate_hw(g, sh, sw)
    dh, dw = dil.shape[1], dil.shape[2]
    gx = torch.zeros((b, ih, iw, c), dtype=torch.int32, device=gy.device)
    for dy in range(kh):
        for dx in range(kw):
            # lax.dynamic_update_slice clamps the start so that the update fits
            y0, x0 = min(dy, ih - dh), min(dx, iw - dw)
            gx[:, y0:y0 + dh, x0:x0 + dw, :] += dil
    gx = numerics.int8_clip(gx).to(torch.int8)
    return gx[:, pad:ih - pad, pad:iw - pad, :] if pad else gx


def concat_plain(datas: Sequence[torch.Tensor],
                 exps: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    exps = [e.to(torch.int32) for e in exps]
    e = exps[0]
    for ei in exps[1:]:
        e = torch.maximum(e, ei)
    aligned = [numerics.trunc_shift_div(d, e - ei).to(torch.int8)
               for d, ei in zip(datas, exps)]
    return torch.cat(aligned, dim=-1), e


# ------------------------------------------------------------------ forms

def supports_pool(x: torch.Tensor, window, stride, pad: int = 0) -> bool:
    """A 4-D int8 NHWC input whose padded frame holds at least one window."""
    return (x.dim() == 4 and x.dtype == torch.int8 and pad >= 0
            and min(*window, *stride) >= 1
            and all(n >= 1 for n in pooled(tuple(x.shape[1:3]), window, stride, pad)))


def supports_maxpool_grad(x, y, gy, window, stride) -> bool:
    if not supports_pool(x, window, stride) or y.dtype != torch.int8 or gy.dtype != torch.int8:
        return False
    want = (x.shape[0], *pooled(tuple(x.shape[1:3]), window, stride), x.shape[3])
    return tuple(y.shape) == want and tuple(gy.shape) == want


def supports_avgpool_grad(gy: torch.Tensor, x_spatial, window, stride, pad: int = 0) -> bool:
    """An int8 gy whose every window lies inside the padded input, so that
    the chain's dynamic_update_slice clamps no start."""
    if gy.dim() != 4 or gy.dtype != torch.int8 or pad < 0 or min(*window, *stride) < 1:
        return False
    oh, ow = gy.shape[1], gy.shape[2]
    return all(o >= 1 and (o - 1) * s + k <= n + 2 * pad
               for o, s, k, n in zip((oh, ow), stride, window, x_spatial))


def supports_concat(datas: Sequence[torch.Tensor]) -> bool:
    """1 to MAX_BRANCHES int8 branches of one device and the same leading
    dims."""
    return (1 <= len(datas) <= MAX_BRANCHES and all(d.dtype == torch.int8 for d in datas)
            and all(d.dim() >= 1 and d.shape[:-1] == datas[0].shape[:-1]
                    and d.device == datas[0].device for d in datas))


# ------------------------------------------------------------------- cuda

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("pool_concat_int8")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mh_k8_pool.argtypes = [i, i, p, p, p, p] + [i] * 11 + [ll, i, p]
    lib.mh_k8_pool.restype = ctypes.c_int
    lib.mh_k8_concat.argtypes = [i, i, p, p, p, p, ll, p, p, p]
    lib.mh_k8_concat.restype = ctypes.c_int
    return lib


def _rows(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(t or a contiguous copy, its row stride in elements): rows of
    t.shape[-1] unit-stride channels at one stride, as a channel slice of a
    larger tensor is."""
    if t.dim() >= 2 and t.stride(-1) == 1 and t.stride(-2) >= t.shape[-1]:
        ld = expect = t.stride(-2)
        for n, s in zip(reversed(t.shape[:-1]), reversed(t.stride()[:-1])):
            if n > 1 and s != expect:
                break
            expect *= n
        else:
            return t, ld
    t = t.contiguous()
    return t, t.shape[-1]


def _vec(channels: Sequence[int], lds: Sequence[int], tensors: Sequence[torch.Tensor]) -> int:
    """The channel run a thread takes: 16 or 4 where every channel count,
    row stride and pointer allows it, else 1."""
    for v in (16, 4):
        if (all(c % v == 0 for c in channels) and all(ld % v == 0 for ld in lds)
                and all(t.data_ptr() % v == 0 for t in tensors)):
            return v
    return 1


def _cuda_of(t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"K8 needs CUDA tensors, got {t.device}")


def _pool_cuda(kind: str, x: Optional[torch.Tensor], y: Optional[torch.Tensor],
               gy: Optional[torch.Tensor], shape_in, shape_out, window, stride, pad: int,
               clip: bool, device: torch.device) -> torch.Tensor:
    b, h, w, c = shape_in
    oh, ow = shape_out
    out_shape = (b, oh, ow, c) if kind in ("maxpool", "avgpool") else (b, h, w, c)
    out = torch.empty(out_shape, dtype=torch.int8, device=device)
    if out.numel() == 0:
        return out
    ld_gy = c
    keep = [t for t in (x, y) if t is not None]
    if gy is not None:
        gy, ld_gy = _rows(gy)
        keep.append(gy)
    vec = _vec((c,), (ld_gy,), keep + [out])
    err = _lib().mh_k8_pool(
        _KINDS[kind], vec, None if x is None else x.data_ptr(), None if y is None else y.data_ptr(),
        None if gy is None else gy.data_ptr(), out.data_ptr(), b, h, w, c, oh, ow, *window,
        *stride, pad, ld_gy, int(clip), torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"pool_concat_int8 {kind} kernel launch failed: CUDA error {err}")
    return out


def maxpool_cuda(x: torch.Tensor, window=(2, 2), stride=(2, 2)) -> torch.Tensor:
    global MAXPOOL_LAUNCHES
    _cuda_of(x)
    x = x.contiguous()
    window, stride = _pair(window), _pair(stride)
    out = _pool_cuda("maxpool", x, None, None, tuple(x.shape),
                     pooled(tuple(x.shape[1:3]), window, stride), window, stride, 0, False,
                     x.device)
    if out.numel():
        MAXPOOL_LAUNCHES += 1
    return out


def maxpool_grad_cuda(x: torch.Tensor, y: torch.Tensor, gy: torch.Tensor, window=(2, 2),
                      stride=(2, 2)) -> torch.Tensor:
    global MAXPOOL_GRAD_LAUNCHES
    for t in (x, y, gy):
        _cuda_of(t)
    x, y = x.contiguous(), y.contiguous()
    window, stride = _pair(window), _pair(stride)
    out = _pool_cuda("maxpool_grad", x, y, gy, tuple(x.shape), tuple(y.shape[1:3]), window,
                     stride, 0, window != stride, x.device)
    if out.numel():
        MAXPOOL_GRAD_LAUNCHES += 1
    return out


def avgpool_cuda(x: torch.Tensor, window, stride, pad: int = 0) -> torch.Tensor:
    global AVGPOOL_LAUNCHES
    _cuda_of(x)
    x = x.contiguous()
    window, stride = _pair(window), _pair(stride)
    out = _pool_cuda("avgpool", x, None, None, tuple(x.shape),
                     pooled(tuple(x.shape[1:3]), window, stride, pad), window, stride, pad,
                     True, x.device)
    if out.numel():
        AVGPOOL_LAUNCHES += 1
    return out


def avgpool_grad_cuda(gy: torch.Tensor, x_spatial: Pair, window, stride,
                      pad: int = 0) -> torch.Tensor:
    global AVGPOOL_GRAD_LAUNCHES
    _cuda_of(gy)
    window, stride = _pair(window), _pair(stride)
    b, oh, ow, c = gy.shape
    out = _pool_cuda("avgpool_grad", None, None, gy, (b, *_pair(x_spatial), c), (oh, ow),
                     window, stride, pad, True, gy.device)
    if out.numel():
        AVGPOOL_GRAD_LAUNCHES += 1
    return out


def concat_cuda(datas: Sequence[torch.Tensor],
                exps: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch: (int8 concat on the last dim, 0-d int32 exponent), both
    written by the kernel."""
    global CONCAT_LAUNCHES
    if len(datas) != len(exps) or not supports_concat(datas):
        raise ValueError("K8's concat takes 1 to 8 int8 branches of one device and leading dims")
    device = datas[0].device
    _cuda_of(datas[0])  # supports_concat: every branch on its device
    srcs, lds = zip(*(_rows(d) for d in datas))
    es = [numerics._as_i32(e, device).reshape(()).contiguous() for e in exps]
    channels = [d.shape[-1] for d in datas]
    out = torch.empty((*datas[0].shape[:-1], sum(channels)), dtype=torch.int8, device=device)
    exp_out = torch.empty((), dtype=torch.int32, device=device)
    rows = out.numel() // max(1, out.shape[-1])
    vec = _vec(channels, lds, list(srcs) + [out])
    n = len(datas)
    arr = ctypes.c_void_p * n
    err = _lib().mh_k8_concat(
        vec, n, arr(*[s.data_ptr() for s in srcs]), arr(*[e.data_ptr() for e in es]),
        (ctypes.c_longlong * n)(*lds), (ctypes.c_int * n)(*channels), rows, out.data_ptr(),
        exp_out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"pool_concat_int8 concat kernel launch failed: CUDA error {err}")
    CONCAT_LAUNCHES += 1
    return out, exp_out


# --------------------------------------------------------------- dispatch

def _kernel_takes(t: torch.Tensor) -> bool:
    return t.is_cuda and dispatch.get_backend() == "cuda"


def maxpool(x: torch.Tensor, window=(2, 2), stride=(2, 2)) -> torch.Tensor:
    """int8 NHWC VALID max pool."""
    if _kernel_takes(x) and supports_pool(x, window, stride):
        return maxpool_cuda(x, window, stride)
    return maxpool_plain(x, window, stride)


def maxpool_grad(x: torch.Tensor, y: torch.Tensor, gy: torch.Tensor, window=(2, 2),
                 stride=(2, 2)) -> torch.Tensor:
    """gy to each window's first position (row-major) at its max; overlaps
    summed in int32 and clipped to +-127."""
    if _kernel_takes(x) and supports_maxpool_grad(x, y, gy, window, stride):
        return maxpool_grad_cuda(x, y, gy, window, stride)
    return maxpool_grad_plain(x, y, gy, window, stride)


def avgpool(x: torch.Tensor, window, stride, pad: int = 0) -> torch.Tensor:
    """int8 average pool over the input zero-padded by `pad` a side: the
    int32 window sum over |window|, truncated, clipped."""
    if _kernel_takes(x) and supports_pool(x, window, stride, pad):
        return avgpool_cuda(x, window, stride, pad)
    return avgpool_plain(x, window, stride, pad)


def avgpool_grad(gy: torch.Tensor, x_spatial: Pair, window, stride,
                 pad: int = 0) -> torch.Tensor:
    """gy / |window| (truncated) spread over each window, summed in int32,
    clipped, for the unpadded input of `x_spatial`."""
    if _kernel_takes(gy) and supports_avgpool_grad(gy, x_spatial, window, stride, pad):
        return avgpool_grad_cuda(gy, x_spatial, window, stride, pad)
    return avgpool_grad_plain(gy, x_spatial, window, stride, pad)


def concat(datas: Sequence[torch.Tensor],
           exps: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exponent-aligned channel concat -> (int8, exp_out): every branch
    shifted right, truncating, to max(exps)."""
    if _kernel_takes(datas[0]) and supports_concat(datas):
        return concat_cuda(datas, exps)
    return concat_plain(datas, exps)
