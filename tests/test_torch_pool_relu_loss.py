"""The port's relu, max pool and NITI loss against the JAX package's:
integer results bit for bit, the float loss value within 1e-6 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mandheling_tpu.ops import loss as jloss
from mandheling_tpu.ops import pool as jpool
from mandheling_tpu.ops import relu as jrelu
from mandheling_tpu_torch.ops import loss as tloss
from mandheling_tpu_torch.ops import pool as tpool
from mandheling_tpu_torch.ops import relu as trelu


def t(a):
    return torch.from_numpy(np.asarray(a))


def eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def rand_int8(rng, shape, lo=-128, hi=128):
    return rng.integers(lo, hi, shape).astype(np.int8)


def test_relu_family():
    rng = np.random.default_rng(0)
    x = rand_int8(rng, (4, 6, 6, 8))
    gy = rand_int8(rng, x.shape)
    eq(trelu.relu(t(x)), jrelu.relu(jnp.asarray(x)))
    eq(trelu.relu_grad(t(x), t(gy)), jrelu.relu_grad(jnp.asarray(x), jnp.asarray(gy)))
    for e in range(-9, 6):
        ej, et = jnp.int32(e), torch.tensor(e, dtype=torch.int32)
        assert int(trelu.relu6_cap(et)) == int(jrelu.relu6_cap(ej))
        eq(trelu.relu6(t(x), et), jrelu.relu6(jnp.asarray(x), ej))
        eq(trelu.relu6_grad(t(x), et, t(gy)),
           jrelu.relu6_grad(jnp.asarray(x), ej, jnp.asarray(gy)))
        y = trelu.relu6(t(x), et)
        eq(trelu.relu6_grad_from_output(y, et, t(gy)),
           jrelu.relu6_grad_from_output(jnp.asarray(y.numpy()), ej, jnp.asarray(gy)))


@pytest.mark.parametrize("shape,window,stride", [
    ((4, 24, 24, 20), (2, 2), (2, 2)),   # LeNet pool 1
    ((4, 8, 8, 52), (2, 2), (2, 2)),     # LeNet pool 2
    ((2, 9, 9, 5), (2, 2), (2, 2)),      # ragged disjoint
    ((2, 9, 9, 5), (3, 3), (2, 2)),      # overlapping (ResNet50v2 style)
    ((2, 7, 8, 3), (3, 2), (1, 2)),
])
@pytest.mark.parametrize("ties", [False, True])
def test_maxpool_and_grad(shape, window, stride, ties):
    rng = np.random.default_rng(sum(shape))
    # narrow values make ties (several window positions at the max) common
    x = rand_int8(rng, shape, -3, 3) if ties else rand_int8(rng, shape)
    yj, ej = jpool.maxpool2d(jnp.asarray(x), jnp.int32(-4), window, stride)
    yt, et = tpool.maxpool2d(t(x), torch.tensor(-4, dtype=torch.int32), window, stride)
    eq(yt, yj)
    assert int(et) == int(ej)
    gy = rand_int8(rng, yt.shape, -127, 128)
    eq(tpool.maxpool2d_grad(t(x), yt, t(gy), window, stride),
       jpool.maxpool2d_grad(jnp.asarray(x), yj, jnp.asarray(gy), window, stride))


def test_left_pool_grad():
    rng = np.random.default_rng(1)
    gy = rand_int8(rng, (2, 4, 5, 3))
    for out, s in [((8, 10), (2, 2)), ((7, 9), (2, 2)), ((12, 5), (3, 1))]:
        eq(tpool.left_pool_grad(t(gy), out, s), jpool.left_pool_grad(jnp.asarray(gy), out, s))


@pytest.mark.parametrize("ascale", list(range(-30, 16)))
def test_loss_grad_int8_bit_exact(ascale):
    rng = np.random.default_rng(ascale + 100)
    logits = rand_int8(rng, (16, 12))
    logits[0] = 127
    logits[1] = -128
    logits[2, :] = 0
    logits[3, 5] = 127
    onehot = np.zeros((16, 12), np.int32)
    onehot[np.arange(16), rng.integers(0, 10, 16)] = 1
    a = np.int32(ascale)
    eq(tloss.loss_grad_int8(t(logits), torch.tensor(a), t(onehot)),
       jloss.loss_grad_int8(jnp.asarray(logits), jnp.int32(a), jnp.asarray(onehot)))
    lj = float(jloss.loss_cross_entropy_float(jnp.asarray(logits), jnp.int32(a), jnp.asarray(onehot)))
    lt = tloss.loss_cross_entropy_float(t(logits), torch.tensor(a), t(onehot))
    assert abs(float(lt) - lj) <= 1e-6 * max(abs(lj), 1e-30)
