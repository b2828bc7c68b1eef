"""The port's depthwise ops, average pools, eltwise ops and K4's plain
version against the JAX package, bit for bit: K4's plain version
(``kernels/fused_dwconv_int8.py``) against the Pallas kernels in interpret
mode, also with its own operands (x unpadded with its pads, a dilation, w
rotated) on the input the JAX caller pads and dilates; the depthwise
forward, input grad and filter grad, per-tensor and per-channel (where K4
takes the alignment shifts), under both port backends against the JAX
package under XLA and under its Pallas interpreter. The CUDA kernel itself is held against the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mandheling_tpu.nn import blocks as jblocks
from mandheling_tpu.ops import allreduce as jallreduce
from mandheling_tpu.ops import depthwise as jdw
from mandheling_tpu.ops import eltwise as jelt
from mandheling_tpu.ops import numerics as jnum
from mandheling_tpu.ops.kernels import fused_dwconv_int8 as jfdw
from mandheling_tpu.ops.kernels import use_backend as j_use_backend
from mandheling_tpu.ops.qtensor import QTensor as JQTensor
from mandheling_tpu_torch.nn import blocks as tblocks
from mandheling_tpu_torch.nn.init import niti_xavier_int8_dw_per_channel
from mandheling_tpu_torch.ops import allreduce as tallreduce
from mandheling_tpu_torch.ops import depthwise as tdw
from mandheling_tpu_torch.ops import eltwise as telt
from mandheling_tpu_torch.ops.kernels import fused_dwconv_int8 as tfdw
from mandheling_tpu_torch.ops.kernels import use_backend as t_use_backend
from mandheling_tpu_torch.ops.qtensor import QTensor


def t(a):
    return torch.from_numpy(np.asarray(a))


def i32(v):
    return torch.tensor(v, dtype=torch.int32)


def rand_int8(rng, shape, lo=-128, hi=128):
    return rng.integers(lo, hi, shape).astype(np.int8)


@pytest.mark.parametrize("xp_shape", [(4, 18, 18, 24), (2, 10, 10, 20), (3, 6, 9, 33)])
def test_fused_dwconv_plain_matches_pallas(xp_shape):
    rng = np.random.default_rng(sum(xp_shape))
    xp = rand_int8(rng, xp_shape)
    w = rand_int8(rng, (3, 3, 1, xp_shape[3]))
    mx_j = jfdw.dwconv_max_pallas(jnp.asarray(xp), jnp.asarray(w), (3, 3), interpret=True)
    mx_t = tfdw.dwconv_max(t(xp), t(w))
    assert mx_t.dtype == torch.int32 and int(mx_t) == int(mx_j)
    bw = int(jnum.range_estimate_from_max(mx_j))
    for shift, grad in [(int(jnum.forward_shift(jnp.int32(bw))), False), (0, False),
                        (bw - 2, True), (bw - 40, True)]:
        y_j = jfdw.dwconv_requant_pallas(jnp.asarray(xp), jnp.asarray(w), jnp.int32(shift),
                                         (3, 3), grad=grad, interpret=True)
        y_t = tfdw.dwconv_requant(t(xp), t(w), i32(shift), grad)
        np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))


@pytest.mark.parametrize("xp_shape,kernel", [((2, 8, 12, 40), (3, 1)), ((1, 6, 9, 33), (1, 3)),
                                             ((2, 9, 9, 7), (5, 5))])
def test_fused_dwconv_plain_matches_pallas_any_kernel(xp_shape, kernel):
    """K4 takes every kernel size the JAX kernel takes, not only 3x3."""
    rng = np.random.default_rng(sum(xp_shape) + sum(kernel))
    xp = rand_int8(rng, xp_shape)
    w = rand_int8(rng, kernel + (1, xp_shape[3]))
    mx_j = jfdw.dwconv_max_pallas(jnp.asarray(xp), jnp.asarray(w), kernel, interpret=True)
    mx_t = tfdw.dwconv_max(t(xp), t(w))
    assert int(mx_t) == int(mx_j)
    bw = int(jnum.range_estimate_from_max(mx_j))
    for shift, grad in [(int(jnum.forward_shift(jnp.int32(bw))), False), (bw - 2, True)]:
        y_j = jfdw.dwconv_requant_pallas(jnp.asarray(xp), jnp.asarray(w), jnp.int32(shift),
                                         kernel, grad=grad, interpret=True)
        y_t = tfdw.dwconv_requant(t(xp), t(w), i32(shift), grad)
        np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))


def _dilate_pad_np(x, dilation, pads):
    """What the JAX caller hands its Pallas kernels: x zero-dilated, then padded."""
    dh, dw = dilation
    b, h, w, c = x.shape
    d = np.zeros((b, (h - 1) * dh + 1, (w - 1) * dw + 1, c), x.dtype)
    d[:, ::dh, ::dw, :] = x
    return np.pad(d, ((0, 0), pads[0], pads[1], (0, 0)))


@pytest.mark.parametrize("x_shape,kernel,pads,dilation,rot180", [
    ((3, 9, 11, 20), (3, 3), ((1, 1), (1, 1)), (1, 1), False),   # stride-1 SAME forward
    ((2, 7, 10, 8), (3, 3), ((0, 1), (0, 1)), (1, 1), False),    # the asymmetric SAME pads
    ((2, 8, 8, 12), (3, 3), ((2, 1), (2, 1)), (2, 2), True),     # stride-2 input grad, 16x16
    ((2, 5, 5, 9), (3, 3), ((1, 1), (1, 1)), (2, 2), True),      # stride-2 input grad, odd 9x9
    ((1, 5, 6, 7), (5, 5), ((2, 2), (3, 1)), (2, 2), True),      # 5x5, pads apart
    ((2, 6, 7, 5), (3, 1), ((1, 1), (0, 0)), (1, 2), False),     # 3x1, dilation along W only
])
def test_fused_dwconv_plain_widened_matches_pallas(x_shape, kernel, pads, dilation, rot180):
    """K4's plain version with x unpadded, its pads, a dilation and w rotated
    by 180 degrees equals the Pallas kernels (interpret mode) on the input
    the JAX caller pads and dilates and the weight it flips."""
    rng = np.random.default_rng(sum(x_shape) + sum(kernel) + dilation[1])
    x = rand_int8(rng, x_shape)
    w = rand_int8(rng, kernel + (1, x_shape[3]))
    xp_j = jnp.asarray(_dilate_pad_np(x, dilation, pads))
    w_j = jnp.flip(jnp.asarray(w), axis=(0, 1)) if rot180 else jnp.asarray(w)
    k4 = dict(pads=pads, dilation=dilation, rot180=rot180)
    mx_j = jfdw.dwconv_max_pallas(xp_j, w_j, kernel, interpret=True)
    assert int(tfdw.dwconv_max(t(x), t(w), **k4)) == int(mx_j)
    bw = int(jnum.range_estimate_from_max(mx_j))
    for shift, grad in [(int(jnum.forward_shift(jnp.int32(bw))), False), (0, False),
                        (bw - 2, True)]:
        y_j = jfdw.dwconv_requant_pallas(xp_j, w_j, jnp.int32(shift), kernel, grad=grad,
                                         interpret=True)
        y_t = tfdw.dwconv_requant(t(x), t(w), i32(shift), grad, **k4)
        np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))


# (x spatial, C, stride, exponents): the spread of the exponents is exactly
# pc_shift_cap(9) = 12 in every case.
PC_CASES = [((16, 16), 24, (1, 1)), ((16, 16), 24, (2, 2)), ((9, 11), 12, (1, 1)),
            ((9, 9), 8, (2, 2)), ((7, 10), 20, (2, 2))]


@pytest.mark.parametrize("spatial,c,stride", PC_CASES)
@pytest.mark.parametrize("saturated", [False, True])
def test_per_channel_forms_take_k4_and_match_jax(spatial, c, stride, saturated):
    """The per-channel depthwise forward and input grad under "cuda" (K4's
    route, with the (C,) alignment shifts as its operand; its plain version
    on these CPU tensors) equal the JAX package's per-channel forms, bytes
    and exponent, at a spread of exactly 12; `saturated`: every operand
    -128, so an interior accumulator is 147456 << 12."""
    rng = np.random.default_rng(spatial[0] * 31 + c + stride[0] + 7 * saturated)
    h, w_sp = spatial
    oh, ow = -(-h // stride[0]), -(-w_sp // stride[1])
    w_exp = rng.integers(-15, -2, c).astype(np.int32)
    w_exp[0], w_exp[-1] = -15, -3
    if saturated:
        x = np.full((2, h, w_sp, c), -128, np.int8)
        w = np.full((3, 3, 1, c), -128, np.int8)
        gy = np.full((2, oh, ow, c), -128, np.int8)
    else:
        x, w = rand_int8(rng, (2, h, w_sp, c)), rand_int8(rng, (3, 3, 1, c))
        gy = rand_int8(rng, (2, oh, ow, c))
    y_j, e_j = jdw.dwconv2d_forward(jnp.asarray(x), jnp.int32(-4), jnp.asarray(w),
                                    jnp.asarray(w_exp), stride, "SAME")
    gx_j = jdw.dwconv2d_input_grad(jnp.asarray(gy), jnp.asarray(w), spatial, stride, "SAME",
                                   w_exp=jnp.asarray(w_exp))
    with t_use_backend("cuda"):
        y_t, e_t = tdw.dwconv2d_forward(t(x), i32(-4), t(w), t(w_exp), stride, "SAME")
        gx_t = tdw.dwconv2d_input_grad(t(gy), t(w), spatial, stride, "SAME", w_exp=t(w_exp))
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    assert int(e_t) == int(e_j)
    np.testing.assert_array_equal(gx_t.numpy(), np.asarray(gx_j))
    if saturated:
        pc = t(w_exp - w_exp.min())
        acc = tfdw.dwconv_shifted_acc_plain(t(x), t(w), ((1, 1), (1, 1)), pc_shift=pc)
        assert int(acc.abs().max()) == 147456 << 12


@pytest.mark.parametrize("backend,mode,want", [("cuda", "matmul_only", 2), ("cuda", "all", 2),
                                               ("torch", "matmul_only", 0), ("cuda", "off", 0)])
def test_per_channel_forms_call_k4(monkeypatch, backend, mode, want):
    """Under the "cuda" backend the per-channel forward (stride 1) and input
    grads (stride 1 and 2) call K4's two entry points once each, with the
    (C,) shift vector; under "torch" or fused mode "off" they call neither."""
    from mandheling_tpu_torch.ops import conv as tconv

    calls = []
    for name in ("dwconv_max", "dwconv_requant"):
        real = getattr(tfdw, name)

        def counted(*a, _real=real, _name=name, **k):
            calls.append((_name, tuple(k["pc_shift"].shape), k["dilation"], k["rot180"]))
            return _real(*a, **k)
        monkeypatch.setattr(tfdw, name, counted)
    rng = np.random.default_rng(3)
    x, w = rand_int8(rng, (2, 8, 8, 12)), rand_int8(rng, (3, 3, 1, 12))
    w_exp = t(rng.integers(-12, -4, 12).astype(np.int32))
    with t_use_backend(backend), tconv.use_fused_conv_mode(mode):
        tdw.dwconv2d_forward(t(x), i32(-3), t(w), w_exp, (1, 1), "SAME")
        for stride in ((1, 1), (2, 2)):
            gy = rand_int8(rng, (2, 8 // stride[0], 8 // stride[1], 12))
            tdw.dwconv2d_input_grad(t(gy), t(w), (8, 8), stride, "SAME", w_exp=w_exp)
        tdw.dwconv2d_forward(t(x), i32(-3), t(w), w_exp, (2, 2), "SAME")  # strided: plain taps
    assert len(calls) == 3 * want
    if want:
        assert calls == [(n, (12,), d, r) for d, r in (((1, 1), False), ((1, 1), True),
                                                       ((2, 2), True))
                         for n in ("dwconv_max", "dwconv_requant")]


def test_fused_dwconv_supports_is_the_jax_rule():
    for b, hp, wp, c in [(256, 34, 34, 144), (256, 18, 18, 192), (256, 10, 10, 576),
                         (256, 6, 6, 960), (4, 66, 66, 144), (1, 130, 130, 32), (2, 3, 400, 8)]:
        oh, ow = hp - 2, wp - 2
        assert tfdw.supports(b, hp, wp, oh, ow, c) == jfdw.supports(b, hp, wp, oh, ow, c)


def _run_dw(pkg, x, gy, w, w_exp, stride, per_channel):
    """(forward y, exp, input grad, filter grad) of one package."""
    dw = jdw if pkg == "jax" else tdw
    cv = (lambda a: jnp.asarray(a)) if pkg == "jax" else t
    e = (lambda v: jnp.int32(v)) if pkg == "jax" else i32
    w_exp_arr = cv(w_exp)
    y, ye = dw.dwconv2d_forward(cv(x), e(-5), cv(w), w_exp_arr, stride, "SAME")
    gx = dw.dwconv2d_input_grad(cv(gy), cv(w), x.shape[1:3], stride, "SAME",
                                w_exp=w_exp_arr if per_channel else None)
    gw = dw.dwconv2d_filter_grad(cv(x), cv(gy), (3, 3), stride, "SAME",
                                 w_exp=w_exp_arr if per_channel else None)
    return [np.asarray(y), int(ye), np.asarray(gx), np.asarray(gw)]


@pytest.mark.parametrize("stride", [(1, 1), (2, 2)])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_depthwise_ops_match_jax(stride, per_channel, backend):
    """(4, 16, 16, 24): the stride-1 forward and every input grad take K4's
    route under "cuda", per-tensor and per-channel (with the alignment
    shifts as K4's operand), the filter grad K5's at both strides, x
    unpadded with its pads (their plain versions on these CPU tensors); the
    strided forward runs the plain taps, as in the JAX package."""
    rng = np.random.default_rng(5 + stride[0] + 2 * per_channel)
    x = rand_int8(rng, (4, 16, 16, 24))
    w = rand_int8(rng, (3, 3, 1, 24))
    w_exp = (rng.integers(-12, -4, 24) if per_channel else np.array(-6)).astype(np.int32)
    oh = 16 // stride[0]
    gy = rand_int8(rng, (4, oh, oh, 24))
    want = _run_dw("jax", x, gy, w, w_exp, stride, per_channel)
    with j_use_backend("pallas_interpret"):
        want_pallas = _run_dw("jax", x, gy, w, w_exp, stride, per_channel)
    with t_use_backend(backend):
        got = _run_dw("torch", x, gy, w, w_exp, stride, per_channel)
    for g, a, b in zip(got, want, want_pallas):
        np.testing.assert_array_equal(g, a)
        np.testing.assert_array_equal(g, b)
    acc_j = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(gy), (1, 1), ((0, 1), (0, 1)) if stride == (2, 2) else
        ((1, 1), (1, 1)), rhs_dilation=stride, dimension_numbers=("CHWN", "IHWO", "NHWC"),
        batch_group_count=24, preferred_element_type=jnp.int32)[:, :3, :3, :].transpose(1, 2, 0, 3)
    acc_t = tdw.dwconv2d_filter_grad_acc(t(x), t(gy), (3, 3), stride, "SAME")
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))


def test_depthwise_filter_grad_wraps_like_int32():
    """258048 products of 128 * 128 pass 2^31: the int32 sum wraps, as XLA's
    int32 accumulation does (b256 at 32x32 can get there)."""
    x = np.full((63, 64, 64, 2), -128, np.int8)
    gy = np.full((63, 64, 64, 2), -128, np.int8)
    acc_t = tdw.dwconv2d_filter_grad_acc(t(x), t(gy), (1, 1), (1, 1), "VALID")
    true_sum = 63 * 64 * 64 * 128 * 128
    assert true_sum > 2**31
    assert int(acc_t[0, 0, 0, 0]) == (true_sum + 2**31) % 2**32 - 2**31
    g_j = jdw.dwconv2d_filter_grad(jnp.asarray(x), jnp.asarray(gy), (1, 1), (1, 1), "VALID")
    g_t = tdw.dwconv2d_filter_grad(t(x), t(gy), (1, 1), (1, 1), "VALID")
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))


def test_pc_shift_cap_and_spread_check():
    for taps in (1, 9, 25, 49, 121):
        assert tdw.pc_shift_cap(taps) == jdw.pc_shift_cap(taps)
    assert [tdw.pc_shift_cap(k * k) for k in (3, 5, 7)] == [12, 11, 10]
    ok = np.array([-3, -15, -9], np.int32)  # spread 12 == the 3x3 cap
    e_j, s_j = jdw._per_channel_shifts(jnp.asarray(ok), 9)
    e_t, s_t = tdw._per_channel_shifts(t(ok), 9)
    assert int(e_t) == int(e_j) and np.array_equal(s_t.numpy(), np.asarray(s_j))
    e_t, s_t = tdw._per_channel_shifts(i32(-4), 9)
    assert int(e_t) == -4 and s_t is None
    bad = np.array([-3, -16, -9], np.int32)
    with pytest.raises(ValueError, match="spread 13"):
        jdw._per_channel_shifts(jnp.asarray(bad), 9)
    with pytest.raises(ValueError, match="spread 13"):
        tdw._per_channel_shifts(t(bad), 9)
    layer = tblocks.NITIDepthwiseConv2D(3, per_channel=True)
    with pytest.raises(ValueError, match="spread 13"):
        layer.load_weight(np.zeros((3, 3, 1, 3), np.int8), bad)


def test_per_channel_init_respects_the_cap():
    gen = torch.Generator().manual_seed(0)
    for shape in [(3, 3, 1, 960), (5, 5, 1, 64)]:
        q = niti_xavier_int8_dw_per_channel(shape, gen)
        assert q.data.dtype == torch.int8 and q.exp.shape == (shape[3],)
        assert int(q.exp.max() - q.exp.min()) <= tdw.pc_shift_cap(shape[0] * shape[1])
        assert int(q.data.abs().amax(dim=(0, 1, 2)).max()) == 127
    with pytest.raises(ValueError):
        niti_xavier_int8_dw_per_channel((3, 3, 2, 4), gen)


@pytest.mark.parametrize("window,stride", [((2, 2), None), ((3, 3), (1, 1)), ((3, 3), (2, 2))])
def test_avgpool_matches_jax(window, stride):
    rng = np.random.default_rng(7)
    x = rand_int8(rng, (2, 9, 9, 5))
    y_j, e_j = jdw.avgpool2d_int8(jnp.asarray(x), jnp.int32(-3), window, stride)
    y_t, e_t = tdw.avgpool2d_int8(t(x), i32(-3), window, stride)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    assert int(e_t) == int(e_j)
    gy = rand_int8(rng, np.asarray(y_j).shape)
    g_j = jdw.avgpool2d_grad(jnp.asarray(gy), (9, 9), window, stride)
    g_t = tdw.avgpool2d_grad(t(gy), (9, 9), window, stride)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    layer_j, layer_t = jblocks.NITIAvgPool(window, stride, pad=1), tblocks.NITIAvgPool(
        window, stride, pad=1)
    (q_j, r_j), (q_t, r_t) = (layer_j.fwd((), JQTensor(jnp.asarray(x), jnp.int32(-3))),
                              layer_t.fwd(QTensor(t(x), i32(-3))))
    np.testing.assert_array_equal(q_t.data.numpy(), np.asarray(q_j.data))
    gy = rand_int8(rng, np.asarray(q_j.data).shape)
    np.testing.assert_array_equal(layer_t.bwd(r_t, t(gy))[0].numpy(),
                                  np.asarray(layer_j.bwd((), r_j, jnp.asarray(gy))[0]))


def test_global_avg_pool_matches_jax():
    rng = np.random.default_rng(8)
    x = rand_int8(rng, (3, 4, 4, 6))
    (q_j, r_j) = jblocks.GlobalAvgPool().fwd((), JQTensor(jnp.asarray(x), jnp.int32(2)))
    (q_t, r_t) = tblocks.GlobalAvgPool().fwd(QTensor(t(x), i32(2)))
    np.testing.assert_array_equal(q_t.data.numpy(), np.asarray(q_j.data))
    assert int(q_t.exp) == int(q_j.exp)
    gy = rand_int8(rng, (3, 1, 1, 6))
    g_j, _ = jblocks.GlobalAvgPool().bwd((), r_j, jnp.asarray(gy))
    g_t, _ = tblocks.GlobalAvgPool().bwd(r_t, t(gy))
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))


@pytest.mark.parametrize("a_exp,b_exp", [(-5, -5), (-3, -7), (-9, -2), (0, -20)])
def test_eltwise_matches_jax(a_exp, b_exp):
    rng = np.random.default_rng(a_exp - b_exp + 40)
    a, b = rand_int8(rng, (2, 5, 5, 7)), rand_int8(rng, (2, 5, 5, 7))
    y_j, e_j = jelt.add_int8(jnp.asarray(a), jnp.int32(a_exp), jnp.asarray(b), jnp.int32(b_exp))
    y_t, e_t = telt.add_int8(t(a), i32(a_exp), t(b), i32(b_exp))
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    assert int(e_t) == int(e_j) and y_t.dtype == torch.int8
    a16 = rng.integers(-30000, 30000, (2, 5, 5, 7)).astype(np.int16)
    y_j, e_j = jelt.add_int8(jnp.asarray(a16), jnp.int32(a_exp), jnp.asarray(b), jnp.int32(b_exp))
    y_t, e_t = telt.add_int8(t(a16), i32(a_exp), t(b), i32(b_exp))
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    assert int(e_t) == int(e_j) and y_t.dtype == torch.int16
    c = rand_int8(rng, (2, 5, 5, 3))
    d_j, ec_j = jelt.concat_int8([jnp.asarray(a), jnp.asarray(c)], [jnp.int32(a_exp), jnp.int32(b_exp)])
    d_t, ec_t = telt.concat_int8([t(a), t(c)], [i32(a_exp), i32(b_exp)])
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert int(ec_t) == int(ec_j)
    np.testing.assert_array_equal(telt.pad_int8(t(a), 2).numpy(),
                                  np.asarray(jelt.pad_int8(jnp.asarray(a), 2)))


def test_grad_requant_with_pc_shift_matches_jax():
    rng = np.random.default_rng(9)
    acc = rng.integers(-(2**28), 2**28, (3, 3, 1, 6)).astype(np.int32)
    pc = rng.integers(0, 12, 6).astype(np.int32).reshape(1, 1, 1, 6)
    for margin in (0, 2):
        want = jallreduce.grad_allreduce_requant(jnp.asarray(acc), None, margin, jnp.asarray(pc))
        got = tallreduce.grad_allreduce_requant(t(acc), None, margin, t(pc))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
