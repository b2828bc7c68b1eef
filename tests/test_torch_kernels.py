"""The plain PyTorch versions of the port's kernels against the JAX
package's Pallas kernels in interpret mode, bit for bit, and the dispatch
layer around them. The CUDA kernels themselves are held against these
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mandheling_tpu.ops import numerics as jnum
from mandheling_tpu.ops.kernels import conv_int8 as jconv
from mandheling_tpu.ops.kernels import fused_matmul_int8 as jfmm
from mandheling_tpu.ops.kernels.matmul_int8 import matmul_acc_pallas_padded
from mandheling_tpu_torch.ops import numerics as tnum
from mandheling_tpu_torch.ops.kernels import conv_int8 as tconv
from mandheling_tpu_torch.ops.kernels import dispatch
from mandheling_tpu_torch.ops.kernels import fused_matmul_int8 as tfmm
from mandheling_tpu_torch.ops.kernels import matmul_int8 as tmm


def t(a):
    return torch.from_numpy(np.asarray(a))


def rand_int8(rng, shape, lo=-128, hi=128):
    return rng.integers(lo, hi, shape).astype(np.int8)


@pytest.mark.parametrize("m,k,n", [
    (8, 16, 8), (100, 50, 30), (256, 256, 256),
    (37, 25, 20),     # conv1 im2col widths, ragged M
    (16, 832, 500),   # fc1 forward
    (16, 500, 832),   # fc1 input grad
    (5, 1300, 20),    # conv2 input grad widths
    (3, 12, 500),     # fc2 input grad widths
])
def test_matmul_plain_matches_pallas(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a, b = rand_int8(rng, (m, k)), rand_int8(rng, (k, n))
    want = np.asarray(matmul_acc_pallas_padded(jnp.asarray(a), jnp.asarray(b), interpret=True))
    np.testing.assert_array_equal(tmm.matmul_acc_plain(t(a), t(b)).numpy(), want)
    # the filter grads hand the GEMM a transposed view
    at = t(np.ascontiguousarray(a.T)).t()
    np.testing.assert_array_equal(tmm.matmul_acc(at, t(b)).numpy(), want)


def test_matmul_plain_wraps_like_int32():
    """Sums past 2^31 wrap, as XLA's int32 accumulation does."""
    k = 140000  # 140000 * 128 * 128 > 2^31
    a = np.full((2, k), -128, np.int8)
    b = np.full((k, 3), -128, np.int8)
    want = np.asarray(jnp.dot(jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32)))
    np.testing.assert_array_equal(tmm.matmul_acc_plain(t(a), t(b)).numpy(), want)


@pytest.mark.parametrize("m,n,k", [(36864, 20, 25), (25, 20, 36864), (500, 52, 4096),
                                   (64, 12, 500), (9216, 20, 1300), (1, 1, 1), (5, 7, 0)])
def test_split_k_covers_k(m, n, k):
    per, splits = tmm.split_k(m, n, k)
    ksteps = -(-k // 32)
    assert splits >= 1 and per * splits >= ksteps and per * (splits - 1) < max(ksteps, 1)


@pytest.mark.parametrize("stride,lhs_dil,rhs_dil", [
    ((1, 1), (1, 1), (1, 1)), ((2, 2), (1, 1), (1, 1)),
    ((1, 1), (2, 2), (1, 1)), ((1, 1), (1, 1), (2, 2)),
])
def test_conv_plain_matches_pallas(stride, lhs_dil, rhs_dil):
    rng = np.random.default_rng(1)
    x = rand_int8(rng, (2, 9, 9, 16), -30, 30)
    w = rand_int8(rng, (3, 3, 16, 64), -30, 30)
    pad = ((2, 2), (2, 2))
    want = np.asarray(jconv.conv_acc_pallas(jnp.asarray(x), jnp.asarray(w), stride, pad,
                                            lhs_dil, rhs_dil, interpret=True))
    got = tconv.conv_acc(t(x), t(w), stride, pad, lhs_dil, rhs_dil)
    np.testing.assert_array_equal(got.numpy(), want)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), stride, pad, lhs_dilation=lhs_dil,
        rhs_dilation=rhs_dil, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kernel,stride,pad,lhs,rhs", [
    ((5, 5), (1, 1), ((0, 0), (0, 0)), (1, 1), (1, 1)),
    ((3, 3), (2, 2), ((1, 0), (0, 1)), (1, 1), (1, 1)),
    ((5, 5), (1, 1), ((4, 4), (4, 4)), (2, 2), (1, 1)),
    ((2, 3), (1, 2), ((1, 2), (0, 0)), (1, 1), (2, 1)),
    ((1, 1), (1, 1), ((0, 0), (0, 0)), (1, 1), (1, 1)),
])
def test_im2col_matches_jax(kernel, stride, pad, lhs, rhs):
    rng = np.random.default_rng(2)
    x = rand_int8(rng, (3, 10, 9, 4))
    pj, oj = jconv.im2col(jnp.asarray(x), kernel, stride, pad, lhs, rhs)
    pt, ot = tconv.im2col(t(x), kernel, stride, pad, lhs, rhs)
    assert ot == oj
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


@pytest.mark.parametrize("m,k,n", [
    (300, 100, 70),    # the tiled TPU branch
    (1024, 24, 144),   # the small-K/N TPU branch
    (1024, 12, 512),   # fc2 input-grad widths
    (512, 144, 24),
])
def test_fused_matmul_plain_matches_pallas(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a, b = rand_int8(rng, (m, k), -30, 30), rand_int8(rng, (k, n), -30, 30)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    mx_j = jfmm.matmul_max_pallas(ja, jb, interpret=True)
    mx_t = tfmm.matmul_max(t(a), t(b))
    assert mx_t.dtype == torch.int32 and int(mx_t) == int(mx_j)
    shift_j = jnum.forward_shift(jnum.range_estimate_from_max(mx_j))
    shift_t = tnum.forward_shift(tnum.range_estimate_from_max(mx_t))
    assert int(shift_t) == int(shift_j)
    for shift in (shift_j, jnp.int32(0), jnp.int32(-3), jnp.int32(3)):
        st = torch.tensor(int(shift), dtype=torch.int32)
        for grad in (False, True):
            want = jfmm.matmul_requant_pallas(ja, jb, shift, grad=grad, interpret=True)
            got = tfmm.matmul_requant(t(a), t(b), st, grad=grad)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_supports_is_the_jax_rule():
    for m in (64, 1024, 1056, 2048, 1032):
        for k, n in ((12, 500), (832, 500), (500, 12), (500, 832), (24, 144)):
            assert tfmm.supports(m, k, n) == jfmm.supports(m, k, n)
    assert not tfmm.supports(64, 12, 500) and tfmm.supports(2048, 12, 500)


def test_dispatch_backends_and_guards():
    rng = np.random.default_rng(4)
    x, w = t(rand_int8(rng, (2, 7, 7, 3))), t(rand_int8(rng, (3, 3, 3, 5)))
    a, b = t(rand_int8(rng, (9, 11))), t(rand_int8(rng, (11, 6)))
    pad = ((1, 1), (1, 1))
    assert dispatch.get_backend() == "cuda"
    c_cuda, m_cuda = dispatch.conv_acc(x, w, (1, 1), pad), dispatch.matmul_acc(a, b)
    with dispatch.use_backend("torch"):
        assert dispatch.get_backend() == "torch"
        np.testing.assert_array_equal(dispatch.conv_acc(x, w, (1, 1), pad).numpy(), c_cuda.numpy())
        np.testing.assert_array_equal(dispatch.matmul_acc(a, b).numpy(), m_cuda.numpy())
    assert dispatch.get_backend() == "cuda"
    with pytest.raises(ValueError):
        dispatch.set_backend("pallas")
    a16 = a.to(torch.int16) * 255  # int16 A takes K1's int16-A route (plain here)
    np.testing.assert_array_equal(dispatch.matmul_acc(a16, b).numpy(),
                                  a16.numpy().astype(np.int64) @ b.numpy().astype(np.int64))
    with pytest.raises(TypeError):
        dispatch.matmul_acc(a16, b.to(torch.int16))  # B stays int8
    with pytest.raises(ValueError):
        tmm.matmul_acc_cuda(a, b)  # a CPU tensor never reaches the kernel
    with pytest.raises(ValueError):
        tfmm.matmul_max_cuda(a, b)
