"""The port's NITI conv forward / input grad / filter grad against the JAX
package's, bit for bit, at the LeNet shapes and at the strided and SAME
cases of tests/test_grad_strategy.py; and the fused (K2) route."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mandheling_tpu.ops import conv as jconv
from mandheling_tpu.ops.kernels import use_backend as j_use_backend
from mandheling_tpu_torch.ops import conv as tconv
from mandheling_tpu_torch.ops.kernels import fused_matmul_int8 as tfmm
from mandheling_tpu_torch.ops.kernels import use_backend as t_use_backend


def t(a):
    return torch.from_numpy(np.asarray(a))


def i32(v):
    return torch.tensor(v, dtype=torch.int32)


CASES = [
    # (batch, h, w, ic, oc, kernel, stride, padding)
    (4, 28, 28, 1, 20, (5, 5), (1, 1), "VALID"),    # LeNet conv1
    (4, 12, 12, 20, 52, (5, 5), (1, 1), "VALID"),   # LeNet conv2
    (4, 1, 1, 832, 500, (1, 1), (1, 1), "VALID"),   # LeNet fc1
    (4, 1, 1, 500, 12, (1, 1), (1, 1), "VALID"),    # LeNet fc2
    (4, 12, 12, 8, 16, (5, 5), (1, 1), "VALID"),
    (4, 12, 12, 8, 16, (3, 3), (2, 2), "SAME"),
    (8, 8, 8, 4, 4, (3, 3), (1, 1), "SAME"),
    (2, 7, 7, 16, 8, (1, 1), (1, 1), "VALID"),
    (2, 9, 9, 4, 12, (3, 3), (2, 2), "VALID"),
]


def _port_conv_ops(x, wt, gy, h, w, k, s, pad):
    y, e = tconv.conv2d_forward(t(x), i32(-5), t(wt), i32(-6), s, pad)
    gx = tconv.conv2d_input_grad(t(gy), t(wt), (h, w), s, pad)
    acc = tconv.conv2d_filter_grad_acc(t(x), t(gy), k, s, pad)
    gw = tconv.conv2d_filter_grad(t(x), t(gy), k, s, pad)
    return [y.numpy(), np.int32(e), gx.numpy(), acc.numpy(), gw.numpy()]


@pytest.mark.parametrize("b,h,w,ic,oc,k,s,pad", CASES)
def test_conv_ops_match_jax(b, h, w, ic, oc, k, s, pad):
    """Both port backends ("cuda" takes the kernels' plain versions on a CPU
    tensor; "torch" forces them) against the JAX package, whose filter grad
    gives the same int32 under its "conv" and "matmul" strategies."""
    rng = np.random.default_rng(b * h + ic + oc)
    x = rng.integers(-127, 128, (b, h, w, ic)).astype(np.int8)
    wt = rng.integers(-127, 128, (*k, ic, oc)).astype(np.int8)
    y_j, e_j = jconv.conv2d_forward(jnp.asarray(x), jnp.int32(-5), jnp.asarray(wt),
                                    jnp.int32(-6), s, pad)
    gy = rng.integers(-127, 128, y_j.shape).astype(np.int8)
    gx_j = jconv.conv2d_input_grad(jnp.asarray(gy), jnp.asarray(wt), (h, w), s, pad)
    want = [np.asarray(y_j), np.int32(e_j), np.asarray(gx_j)]
    for strategy in ("conv", "matmul"):
        with jconv.use_filter_grad_strategy(strategy):
            acc_j = jconv.conv2d_filter_grad_acc(jnp.asarray(x), jnp.asarray(gy), k, s, pad)
            gw_j = jconv.conv2d_filter_grad(jnp.asarray(x), jnp.asarray(gy), k, s, pad)
        for backend in ("cuda", "torch"):
            with t_use_backend(backend):
                got = _port_conv_ops(x, wt, gy, h, w, k, s, pad)
            for g, wnt in zip(got, want + [np.asarray(acc_j), np.asarray(gw_j)]):
                np.testing.assert_array_equal(g, wnt)


@pytest.mark.parametrize("act_exp", [-9, -6, -3, 0, 2])
def test_conv_forward_relu6_act(act_exp):
    rng = np.random.default_rng(5)
    x = rng.integers(-127, 128, (2, 6, 6, 8)).astype(np.int8)
    wt = rng.integers(-127, 128, (3, 3, 8, 16)).astype(np.int8)
    y_t, e_t = tconv.conv2d_forward(t(x), i32(act_exp), t(wt), i32(-12), (1, 1), "SAME",
                                    act="relu6")
    y_j, e_j = jconv.conv2d_forward(jnp.asarray(x), jnp.int32(act_exp), jnp.asarray(wt),
                                    jnp.int32(-12), (1, 1), "SAME", act="relu6")
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    assert int(e_t) == int(e_j)


@pytest.mark.parametrize("stride", [(1, 1), (2, 2)])
def test_fused_route_matches_jax(stride, monkeypatch):
    """1x1 convs the fused kernel takes (the fc2 input grad at batch >= 1056;
    here 1024 x 512 outputs): the port's fused route, on the CPU through K2's
    plain version, against the JAX package's unfused XLA path and its Pallas
    fused path."""
    calls = []
    real_max = tfmm.matmul_max
    monkeypatch.setattr(tfmm, "matmul_max", lambda a, b: calls.append(a.shape) or real_max(a, b))
    rng = np.random.default_rng(6)
    gy = rng.integers(-127, 128, (1024, 1, 1, 12)).astype(np.int8)
    wt = rng.integers(-127, 128, (1, 1, 512, 12)).astype(np.int8)
    gx_t = tconv.conv2d_input_grad(t(gy), t(wt), (1, 1))
    assert calls == [(1024, 12)]
    gx_x = jconv.conv2d_input_grad(jnp.asarray(gy), jnp.asarray(wt), (1, 1))
    with j_use_backend("pallas_interpret"):
        gx_p = jconv.conv2d_input_grad(jnp.asarray(gy), jnp.asarray(wt), (1, 1))
    np.testing.assert_array_equal(gx_t.numpy(), np.asarray(gx_x))
    np.testing.assert_array_equal(gx_t.numpy(), np.asarray(gx_p))

    x = rng.integers(-127, 128, (128, 4, 4, 12)).astype(np.int8)
    w2 = rng.integers(-127, 128, (1, 1, 12, 512)).astype(np.int8)
    calls.clear()
    y_t, e_t = tconv.conv2d_forward(t(x), i32(-3), t(w2), i32(-7), stride)
    assert len(calls) == (1 if stride == (1, 1) else 0)  # 128*2*2 rows: too few
    with tconv.use_fused_conv_mode("off"):
        y_off, e_off = tconv.conv2d_forward(t(x), i32(-3), t(w2), i32(-7), stride)
    y_j, e_j = jconv.conv2d_forward(jnp.asarray(x), jnp.int32(-3), jnp.asarray(w2),
                                    jnp.int32(-7), stride)
    for y, e in ((y_t, e_t), (y_off, e_off)):
        np.testing.assert_array_equal(y.numpy(), np.asarray(y_j))
        assert int(e) == int(e_j)


def test_modes_and_margin():
    assert tconv.get_fused_conv_mode() == "matmul_only"
    tconv.set_fused_conv_mode("all")  # K3's route, ported
    assert tconv.get_fused_conv_mode() == "all"
    tconv.set_fused_conv_mode("matmul_only")
    with pytest.raises(ValueError):
        tconv.set_fused_conv_mode("bogus")
    assert tconv.get_fused_conv_mode() == "matmul_only"
    rng = np.random.default_rng(8)
    x = rng.integers(-127, 128, (4, 12, 12, 20)).astype(np.int8)
    gy = rng.integers(-127, 128, (4, 8, 8, 52)).astype(np.int8)
    for margin in (0, 1, 3):
        tconv.set_fgrad_margin(margin)
        jconv.set_fgrad_margin(margin)
        try:
            np.testing.assert_array_equal(
                tconv.conv2d_filter_grad(t(x), t(gy), (5, 5)).numpy(),
                np.asarray(jconv.conv2d_filter_grad(jnp.asarray(x), jnp.asarray(gy), (5, 5))))
        finally:
            tconv.set_fgrad_margin(2)
            jconv.set_fgrad_margin(2)
    assert tconv.resolve_padding("SAME", (3, 3), (2, 2), (12, 12)) == \
        jconv.resolve_padding("SAME", (3, 3), (2, 2), (12, 12))
