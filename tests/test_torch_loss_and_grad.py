"""`ops/loss.loss_and_grad`, the NITI loss's (float loss, int8 gradient)
pair, against the JAX package's `loss_and_grad` at every ascale of both
gradient branches: the gradient byte for byte, the float loss within 1e-6
relative (torch's log_softmax and XLA's part by an ulp, as
tests/test_torch_pool_relu_loss.py states for the loss alone)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mandheling_tpu.ops.loss import loss_and_grad as j_loss_and_grad
from mandheling_tpu_torch.ops.loss import loss_and_grad


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
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss) - float(j_loss)) <= 1e-6 * max(abs(float(j_loss)), 1e-30)
