"""K7 (ops/kernels/requant_int32.py), the requant of an int32 accumulator no
fused kernel takes: its plain version against the numerics chain the ops
ran before it and against the JAX package's numerics, byte for byte; and
every routed op site, with the kernel's launches stubbed by their plain
versions, calling it and giving the bytes and exponent it gave before."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mandheling_tpu.ops import eltwise as jelt
from mandheling_tpu.ops import numerics as jnum
from mandheling_tpu.ops import relu as jrelu
from mandheling_tpu_torch.ops import allreduce as tar
from mandheling_tpu_torch.ops import conv as tconv
from mandheling_tpu_torch.ops import depthwise as tdw
from mandheling_tpu_torch.ops import eltwise as telt
from mandheling_tpu_torch.ops import matmul as tmm
from mandheling_tpu_torch.ops import numerics as tnum
from mandheling_tpu_torch.ops import relu as trelu
from mandheling_tpu_torch.ops.kernels import dispatch
from mandheling_tpu_torch.ops.kernels import requant_int32 as rq

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def i32(values):
    return torch.tensor(values, dtype=torch.int32)


def rand_acc(n, bits, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-(2**bits), 2**bits + 1, n).astype(np.int32))


# accumulators by what they exercise: (name, values)
ACCS = [
    ("all zero", torch.zeros(37, dtype=torch.int32)),
    ("INT32_MIN only", i32([I32_MIN] * 5)),
    ("INT32_MIN among others", i32([I32_MIN, 3, -70000, 12])),
    ("bw 0: max 1", i32([1, -1, 0, 1])),
    ("max 2^24", i32([2**24, -5, 77, -(2**20)])),
    ("max 2^24 + 1", i32([2**24 + 1, -5, 77, 3])),
    ("max 2^30", i32([2**30, -1, 5])),
    ("max above 2^30", i32([2**30 + 1, -(2**29), 5, I32_MAX])),
    ("forward shift 0 (bw 7)", rand_acc(300, 6, 1)),
    ("forward shift 1 -> 2 (bw 8)", i32([255, -200, 17, 128])),
    ("forward shift 2 (bw 9)", i32([300, -511, 2])),
    ("forward shift 13", rand_acc(500, 20, 2)),
    ("bw 15 and 16 (out_bits 15)", i32([40000, -32767, 5, 1])),
    ("random wide", rand_acc(1000, 30, 3)),
]


def chain_forward(acc, exp_in, out_bits=7, act=None):
    """The numerics chain of the ops before K7: range estimate of |acc|'s
    max, requant_forward_from_bw, the fused activation."""
    bw = tnum.range_estimate_from_max(tnum.abs_max(acc))
    y, e = tnum.requant_forward_from_bw(acc, exp_in, bw, out_bits)
    if act == "relu6":
        y = torch.clamp_min(torch.minimum(y, trelu.relu6_cap(e).to(torch.int8)), 0)
    return y, e


def jax_forward(acc, exp_in, out_bits=7, act=None):
    a = jnp.asarray(acc.numpy())
    y, e = jnum.requant_forward_from_bw(a, jnp.int32(int(exp_in)), jnum.range_estimate(a),
                                        out_bits)
    if act == "relu6":
        y = jrelu.relu6(y, e)
    return np.asarray(y), int(e)


def assert_same(got, want_torch, want_jax=None):
    (y, e), (y0, e0) = got, want_torch
    assert y.dtype == y0.dtype and torch.equal(y, y0) and int(e) == int(e0)
    if want_jax is not None:
        np.testing.assert_array_equal(y.numpy(), want_jax[0])
        assert int(e) == want_jax[1]


@pytest.mark.parametrize("name,acc", ACCS, ids=[a for a, _ in ACCS])
@pytest.mark.parametrize("out_bits,act,exp", [(7, None, 0), (7, None, -9), (15, None, -3),
                                              (7, "relu6", -9), (7, "relu6", 1),
                                              (7, "relu6", -20)])
def test_plain_forward_is_the_chain_and_jax(name, acc, out_bits, act, exp):
    """relu6 at exponent -20 and -9 (the cap after the shift saturates at
    127 or not) and 1 (cap 3 or less); out_bits 15 (int16, rail 32767)."""
    exps = (torch.tensor(exp, dtype=torch.int32), torch.tensor(2, dtype=torch.int32))
    m = rq.absmax_plain(acc)
    got = rq.requant_forward_plain(acc, m, exps, out_bits, act)
    assert_same(got, chain_forward(acc, torch.tensor(exp + 2, dtype=torch.int32), out_bits, act),
                jax_forward(acc, exp + 2, out_bits, act))


def test_relu6_cap_of_127_passes_the_rail():
    """An exponent at which 6.0 is not representable: the cap is 127 and the
    rail stays."""
    acc = i32([127 * 4, -5, 60])  # bw 9: shift 2, exp_out -9 + 2 = -7 -> cap 127
    y, e = rq.requant_forward_plain(acc, rq.absmax_plain(acc), (torch.tensor(-9),), act="relu6")
    assert int(trelu.relu6_cap(e)) == 127 and int(y.max()) == 127
    assert_same((y, e), chain_forward(acc, torch.tensor(-9), act="relu6"),
                jax_forward(acc, -9, act="relu6"))


@pytest.mark.parametrize("name,acc", ACCS, ids=[a for a, _ in ACCS])
@pytest.mark.parametrize("margin", [0, 2, 3])
def test_plain_grad_is_the_chain_and_jax(name, acc, margin):
    got = rq.requant_grad_plain(acc, rq.absmax_plain(acc), margin)
    want = tnum.requant_grad_from_bw(acc, tnum.range_estimate(acc), margin)
    assert got.dtype == torch.int8 and torch.equal(got, want)
    a = jnp.asarray(acc.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnum.requant_grad(a, margin)))


def test_plain_empty_accumulator():
    """No values: the max is INT32_MIN (jnp.max's identity), bw 0, an empty
    output and exp_out = exp_in."""
    acc = torch.zeros((0, 4), dtype=torch.int32)
    m = rq.absmax_plain(acc)
    assert int(m) == I32_MIN
    y, e = rq.requant_forward_plain(acc, m, (torch.tensor(-3),))
    assert y.shape == (0, 4) and y.dtype == torch.int8 and int(e) == -3
    assert rq.requant_grad_plain(acc, m, 2).shape == (0, 4)


@pytest.mark.parametrize("right", [False, True])
def test_plain_per_channel_shifts(right):
    """pc_shift left (the depthwise forward's alignment, wrapping) and as a
    truncating right shift (the depthwise filter grad's), per last-dim
    channel, against the chain and JAX."""
    acc = rand_acc(2 * 3 * 3 * 40, 22, 5).reshape(2, 3, 3, 40)
    acc[0, 0, 0, :4] = torch.tensor([I32_MIN, -(2**21), 2**21 + 1, -1], dtype=torch.int32)
    pc = torch.arange(40, dtype=torch.int32) % 13
    pcv = pc.reshape(1, 1, 1, 40) if right else pc
    v = rq.Values(acc, pc_shift=pcv, pc_right=right)
    shifted = tnum.trunc_shift_div(acc, pcv) if right else acc << pcv
    ja = jnp.asarray(acc.numpy())
    jshifted = np.asarray(jnum.trunc_shift_div(ja, jnp.asarray(pcv.numpy())) if right
                          else ja << jnp.asarray(pc.numpy()))
    np.testing.assert_array_equal(shifted.numpy(), jshifted)
    m = rq.absmax_plain(v)
    assert torch.equal(m, tnum.abs_max(shifted))
    assert_same(rq.requant_forward_plain(v, m, (torch.tensor(-4),)),
                chain_forward(shifted, torch.tensor(-4)), jax_forward(shifted, -4))
    for margin in (0, 2):
        np.testing.assert_array_equal(
            rq.requant_grad_plain(v, m, margin).numpy(),
            np.asarray(jnum.requant_grad(jnp.asarray(shifted.numpy()), margin)))


@pytest.mark.parametrize("ta,tb,ea,eb", [
    (torch.int8, torch.int8, -5, -2), (torch.int8, torch.int8, 3, 3),
    (torch.int8, torch.int16, -7, -1), (torch.int16, torch.int8, 0, -6),
    (torch.int16, torch.int16, -12, -3), (torch.int8, torch.int8, -40, 0),
])
def test_plain_aligned_sum_is_add_int8_and_jax(ta, tb, ea, eb):
    """add_int8's exponent-aligned sum of int8 / int16 operands with unequal
    exponents (one shift past 32), against the chain and the JAX add."""
    gen = torch.Generator().manual_seed(ea * 7 + eb)
    a = torch.randint(torch.iinfo(ta).min, torch.iinfo(ta).max + 1, (6, 5, 7), generator=gen,
                      dtype=ta)
    b = torch.randint(torch.iinfo(tb).min, torch.iinfo(tb).max + 1, (6, 5, 7), generator=gen,
                      dtype=tb)
    a_exp, b_exp = torch.tensor(ea, dtype=torch.int32), torch.tensor(eb, dtype=torch.int32)
    out_bits = 15 if torch.int16 in (ta, tb) else 7
    v = rq.aligned_sum(a, a_exp, b, b_exp)
    got = rq.requant_forward_plain(v, rq.absmax_plain(v), out_bits=out_bits)
    e = torch.maximum(a_exp, b_exp)
    acc = tnum.trunc_shift_div(a, e - a_exp) + tnum.trunc_shift_div(b, e - b_exp)
    jy, je = jelt.add_int8(jnp.asarray(a.numpy()), jnp.int32(ea), jnp.asarray(b.numpy()),
                           jnp.int32(eb))
    assert_same(got, chain_forward(acc, e, out_bits), (np.asarray(jy), int(je)))


def test_the_kernel_is_taken_only_on_the_card_under_cuda():
    acc = torch.zeros(3, dtype=torch.int32)
    assert not rq._kernel_takes(acc) and not rq._kernel_takes(acc.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        rq.absmax_cuda(acc)
    with pytest.raises(ValueError, match="int8-only"):
        rq.requant_forward(acc, rq.absmax(acc), out_bits=15, act="relu6")


# --- the routed op sites ----------------------------------------------------


@pytest.fixture
def stubbed(monkeypatch):
    """K7 taken on CPU tensors under the "cuda" backend, its launches run by
    the plain versions and recorded: [(phase, form)]."""
    calls = []
    monkeypatch.setattr(rq, "_kernel_takes",
                        lambda v: dispatch.get_backend() == "cuda")

    def form(v):
        v = rq._values(v)
        return "sum" if v.b is not None else ("pc" if v.pc_shift is not None else "acc")

    def absmax_cuda(v):
        calls.append(("absmax", form(v)))
        return rq.absmax_plain(v)

    def forward_cuda(v, m, exps=(), out_bits=7, act=None):
        calls.append(("forward", form(v)))
        return rq.requant_forward_plain(v, m, exps, out_bits, act)

    def grad_cuda(v, m, margin):
        calls.append(("grad", form(v)))
        return rq.requant_grad_plain(v, m, margin)

    monkeypatch.setattr(rq, "absmax_cuda", absmax_cuda)
    monkeypatch.setattr(rq, "requant_forward_cuda", forward_cuda)
    monkeypatch.setattr(rq, "requant_grad_cuda", grad_cuda)
    return calls


def rand8(shape, seed, dtype=torch.int8):
    gen = torch.Generator().manual_seed(seed)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max + 1, shape, generator=gen, dtype=dtype)


E = torch.tensor(-6, dtype=torch.int32)
WE = torch.tensor(-7, dtype=torch.int32)


def site_conv_forward(act, out_bits):
    x, w = rand8((2, 9, 9, 8), 1), rand8((3, 3, 8, 16), 2)

    def run():
        return tconv.conv2d_forward(x, E, w, WE, (2, 2), "SAME", act=act, out_bits=out_bits)

    acc = tconv.conv2d_int8_acc(x, w, (2, 2), "SAME")
    return run, chain_forward(acc, E + WE, out_bits, act), [("absmax", "acc"), ("forward", "acc")]


def site_conv_input_grad():
    gy, w = rand8((2, 5, 5, 16), 3), rand8((3, 3, 8, 16), 4)

    def run():
        return tconv.conv2d_input_grad(gy, w, (9, 9), (2, 2), "SAME"), torch.tensor(0)

    acc = tconv.conv2d_input_grad_acc(gy, w, (9, 9), (2, 2), "SAME")
    return run, (chain_forward(acc, torch.tensor(0, dtype=torch.int32))[0], torch.tensor(0)), [
        ("absmax", "acc"), ("forward", "acc")]


def site_matmul_forward():
    a, b = rand8((24, 40), 5), rand8((40, 12), 6)

    def run():
        return tmm.matmul_int8_forward(a, E, b, WE)

    return run, chain_forward(tmm.matmul_int8_acc(a, b), E + WE), [
        ("absmax", "acc"), ("forward", "acc")]


def site_dw_forward(per_channel, stride):
    x, w = rand8((2, 8, 8, 12), 7), rand8((3, 3, 1, 12), 8)
    w_exp = (torch.arange(12, dtype=torch.int32) % 4 - 9) if per_channel else WE

    def run():
        return tdw.dwconv2d_forward(x, E, w, w_exp, stride, "SAME", act="relu6")

    acc = tdw.dwconv2d_int8_acc(x, w, stride, "SAME")
    e_base, pc = tdw._per_channel_shifts(w_exp)
    if pc is not None:
        acc = acc << pc
    return run, chain_forward(acc, E + e_base, act="relu6"), [
        ("absmax", "pc" if per_channel else "acc"), ("forward", "pc" if per_channel else "acc")]


def site_dw_input_grad(per_channel):
    gy, w = rand8((2, 4, 4, 12), 9), rand8((3, 3, 1, 12), 10)
    w_exp = (torch.arange(12, dtype=torch.int32) % 4 - 9) if per_channel else None

    def run():
        return tdw.dwconv2d_input_grad(gy, w, (8, 8), (2, 2), "SAME", w_exp), torch.tensor(0)

    pad = tconv._input_grad_pads(w.shape, (8, 8), (4, 4), (2, 2), "SAME")
    pc = tdw._per_channel_shifts(w_exp)[1] if per_channel else None
    from mandheling_tpu_torch.ops.kernels import fused_dwconv_int8 as fdw
    acc = fdw.dwconv_shifted_acc_plain(gy, w, pad, (2, 2), pc, rot180=True)
    form = "pc" if per_channel else "acc"
    return run, (chain_forward(acc, torch.tensor(0, dtype=torch.int32))[0], torch.tensor(0)), [
        ("absmax", form), ("forward", form)]


def site_filter_grad(op):
    x, gy = rand8((2, 9, 9, 8), 11), rand8((2, 5, 5, 8), 12)
    if op == "conv":
        w_gy = rand8((2, 5, 5, 16), 12)

        def run():
            return tconv.conv2d_filter_grad(x, w_gy, (3, 3), (2, 2), "SAME"), torch.tensor(0)

        acc = tconv.conv2d_filter_grad_acc(x, w_gy, (3, 3), (2, 2), "SAME")
        want = tnum.requant_grad_from_bw(acc, tnum.range_estimate(acc), tconv.get_fgrad_margin())
        return run, (want, torch.tensor(0)), [("absmax", "acc"), ("grad", "acc")]
    if op == "matmul":
        a, b = rand8((40, 24), 13), rand8((24, 12), 14)

        def run():
            return tmm.matmul_int8_grad(a, b), torch.tensor(0)

        acc = tmm.matmul_int8_acc(a, b)
        return run, (tnum.requant_grad_from_bw(acc, tnum.range_estimate(acc), 3),
                     torch.tensor(0)), [("absmax", "acc"), ("grad", "acc")]
    w_exp = torch.arange(8, dtype=torch.int32) % 5 - 10

    def run():
        return tdw.dwconv2d_filter_grad(x, gy, (3, 3), (2, 2), "SAME", w_exp), torch.tensor(0)

    acc = tdw.dwconv2d_filter_grad_acc(x, gy, (3, 3), (2, 2), "SAME")
    acc = tnum.trunc_shift_div(acc, tdw._per_channel_shifts(w_exp)[1].reshape(1, 1, 1, -1))
    want = tnum.requant_grad_from_bw(acc, tnum.range_estimate(acc), tdw.get_dw_fgrad_margin())
    return run, (want, torch.tensor(0)), [("absmax", "pc"), ("grad", "pc")]


def site_add(ta, tb):
    a, b = rand8((2, 4, 4, 8), 15, ta), rand8((2, 4, 4, 8), 16, tb)
    ea, eb = torch.tensor(-9, dtype=torch.int32), torch.tensor(-6, dtype=torch.int32)

    def run():
        return telt.add_int8(a, ea, b, eb)

    e = torch.maximum(ea, eb)
    acc = tnum.trunc_shift_div(a, e - ea) + tnum.trunc_shift_div(b, e - eb)
    out_bits = 15 if torch.int16 in (ta, tb) else 7
    return run, chain_forward(acc, e, out_bits), [("absmax", "sum"), ("forward", "sum")]


SITES = {
    "conv2d_forward": lambda: site_conv_forward(None, 7),
    "conv2d_forward relu6": lambda: site_conv_forward("relu6", 7),
    "conv2d_forward int16": lambda: site_conv_forward(None, 15),
    "conv2d_input_grad": site_conv_input_grad,
    "matmul_int8_forward": site_matmul_forward,
    "dwconv2d_forward strided": lambda: site_dw_forward(False, (2, 2)),
    "dwconv2d_forward strided per-channel": lambda: site_dw_forward(True, (2, 2)),
    "dwconv2d_forward K4 off": lambda: site_dw_forward(False, (1, 1)),
    "dwconv2d_input_grad K4 off": lambda: site_dw_input_grad(False),
    "dwconv2d_input_grad K4 off per-channel": lambda: site_dw_input_grad(True),
    "conv2d_filter_grad": lambda: site_filter_grad("conv"),
    "matmul_int8_grad": lambda: site_filter_grad("matmul"),
    "dwconv2d_filter_grad per-channel": lambda: site_filter_grad("dw"),
    "add_int8": lambda: site_add(torch.int8, torch.int8),
    "add_int8 int8 + int16": lambda: site_add(torch.int8, torch.int16),
}


@pytest.mark.parametrize("site", list(SITES))
def test_routed_site_calls_k7_and_keeps_its_bytes(stubbed, site):
    """Each routed site, its CPU tensors taken as the card's under the
    "cuda" backend (fused mode "off", so that K4 refuses every depthwise
    shape): it launches both phases of K7 once, in the site's form, and
    gives the bytes and exponent of the numerics chain it ran before; under
    the "torch" backend it launches nothing and gives the same."""
    with tconv.use_fused_conv_mode("off"):
        run, (want_y, want_e), want_calls = SITES[site]()
        with dispatch.use_backend("cuda"):
            y, e = run()
        assert stubbed == want_calls
        assert y.dtype == want_y.dtype and torch.equal(y, want_y) and int(e) == int(want_e)
        stubbed.clear()
        with dispatch.use_backend("torch"):
            y2, e2 = run()
        assert not stubbed and torch.equal(y2, want_y) and int(e2) == int(want_e)


def test_grad_allreduce_requant_local_takes_k7(stubbed):
    """grad_allreduce_requant with no group: one K7 site, the shift inside
    it (the depthwise filter grad's truncating per-channel shift)."""
    acc = rand_acc(3 * 3 * 1 * 16, 24, 9).reshape(3, 3, 1, 16)
    pc = (torch.arange(16, dtype=torch.int32) % 7).reshape(1, 1, 1, 16)
    got = tar.grad_allreduce_requant(acc, None, 2, pc_shift=pc)
    shifted = tnum.trunc_shift_div(acc, pc)
    assert stubbed == [("absmax", "pc"), ("grad", "pc")]
    assert torch.equal(got, tnum.requant_grad_from_bw(shifted, tnum.range_estimate(shifted), 2))
