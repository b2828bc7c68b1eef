"""`ops/loss.loss_and_grad`, the NITI loss's (float loss, int8 gradient)
pair, against the JAX package's `loss_and_grad` at every ascale of both
gradient branches: the gradient byte for byte, the float loss within 1e-6
relative (torch's log_softmax and XLA's part by an ulp, as
tests/test_torch_pool_relu_loss.py states for the loss alone). The float
loss is 0-d float64: the JAX package's float32 value where that is finite,
and the same formula in float64 where logits * 2^ascale overflows float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mandheling_tpu.ops.loss import loss_and_grad as j_loss_and_grad
from mandheling_tpu.ops.loss import loss_cross_entropy_float as j_loss_float
from mandheling_tpu_torch.ops.loss import loss_and_grad, loss_cross_entropy_float


@pytest.mark.parametrize("ascale", [-30, -12, -7, -6, 0, 5, 15])
def test_loss_and_grad_matches_jax(ascale):
    rng = np.random.default_rng(ascale + 200)
    logits = rng.integers(-128, 128, (32, 12)).astype(np.int8)
    logits[0] = 127
    onehot = np.zeros((32, 12), np.int32)
    onehot[np.arange(32), rng.integers(0, 10, 32)] = 1
    loss, grad = loss_and_grad(torch.from_numpy(logits), torch.tensor(ascale, dtype=torch.int32),
                               torch.from_numpy(onehot))
    j_loss, j_grad = j_loss_and_grad(jnp.asarray(logits), jnp.int32(ascale), jnp.asarray(onehot))
    assert grad.dtype == torch.int8 and grad.numpy().tobytes() == np.asarray(j_grad).tobytes()
    assert loss.dtype == torch.float64 and loss.shape == ()
    assert abs(float(loss) - float(j_loss)) <= 1e-6 * max(abs(float(j_loss)), 1e-30)


def _overflow_case(seed, classes):
    rng = np.random.default_rng(seed)
    logits = rng.integers(-128, 128, (32, classes)).astype(np.int8)
    onehot = np.zeros((32, classes), np.int32)
    onehot[np.arange(32), rng.integers(0, classes, 32)] = 1
    return logits, onehot


@pytest.mark.parametrize("ascale", [60, 100, 110, 114])
def test_float_loss_is_the_float32_value_where_that_is_finite(ascale):
    """Below the overflow the logged loss is the float32 mean NLL, bit for
    bit, with a runaway exponent as with a small one; the JAX package's
    within 1e-5 relative (at these magnitudes torch's and XLA's float32
    reductions of the 32 rows part by about 2e-6)."""
    logits, onehot = _overflow_case(ascale, 12)
    lg, oh = torch.from_numpy(logits), torch.from_numpy(onehot)
    loss = loss_cross_entropy_float(lg, torch.tensor(ascale, dtype=torch.int32), oh)
    x = lg.to(torch.float32) * 2.0 ** ascale
    f32 = -torch.mean(torch.sum(torch.log_softmax(x, dim=-1) * oh.to(torch.float32), dim=-1))
    j_loss = float(j_loss_float(jnp.asarray(logits), jnp.int32(ascale), jnp.asarray(onehot)))
    assert np.isfinite(j_loss) and float(loss) == float(f32)
    assert abs(float(loss) - j_loss) <= 1e-5 * abs(j_loss)


@pytest.mark.parametrize("ascale", [121, 128, 200, 600, 1000])
def test_float_loss_stays_finite_where_float32_overflows(ascale):
    """Where logits * 2^ascale overflows float32 (the JAX package's loss is
    then inf or nan), the logged loss is the float64 mean NLL: finite, and
    2^ascale times the mean gap between each row's largest logit and its
    target's (the softmax is one-hot there)."""
    logits, onehot = _overflow_case(ascale, 1000)
    j_loss = j_loss_float(jnp.asarray(logits), jnp.int32(ascale), jnp.asarray(onehot))
    assert not np.isfinite(float(j_loss))
    loss = loss_cross_entropy_float(torch.from_numpy(logits), torch.tensor(ascale, dtype=torch.int32),
                                    torch.from_numpy(onehot))
    gap = (logits.astype(np.float64).max(-1) - (logits * onehot).sum(-1)).mean()
    assert np.isfinite(float(loss)) and float(loss) == pytest.approx(gap * 2.0 ** ascale, rel=1e-12)
