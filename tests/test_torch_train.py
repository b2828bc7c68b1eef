"""The slice end to end: LeNet NITI training steps in the port against the
JAX package, from the same params (carried across by utils/jax_params.py)
and the same integer-pixel batches. Params and exponents must be
byte-identical; losses agree within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mandheling_tpu.data import onehot_padded as j_onehot
from mandheling_tpu.models import lenet_niti as j_lenet
from mandheling_tpu.train import make_eval_step as j_make_eval_step
from mandheling_tpu.train import make_train_step as j_make_train_step
from mandheling_tpu.train import quantize_batch as j_quantize_batch
from mandheling_tpu_torch.data import synthetic_mnist
from mandheling_tpu_torch.models import NITI_LOGIT_CHANNELS, lenet_niti
from mandheling_tpu_torch.ops.kernels import use_backend
from mandheling_tpu_torch.train import make_eval_step, make_train_step, quantize_batch
from mandheling_tpu_torch.train.trainer import train_niti
from mandheling_tpu_torch.utils.jax_params import export_jax_params, load_jax_params

STEPS, BATCH = 5, 8


def jax_params_numpy(params):
    return [{"w": (np.asarray(p["w"].data), np.asarray(p["w"].exp))} if p else ()
            for p in params]


def assert_params_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert bool(g) == bool(w)
        if g:
            for a, b in zip(g["w"], w["w"]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def jax_run():
    """STEPS JAX train steps (XLA backend, byte-identical to Pallas by the
    JAX package's own cross-backend test) on integer-pixel batches."""
    model = j_lenet()
    params = model.init(jax.random.PRNGKey(0))
    start = jax_params_numpy(params)
    rng = np.random.default_rng(3)
    xs = [rng.integers(0, 256, (BATCH, 28, 28, 1)).astype(np.float32) for _ in range(STEPS)]
    ohs = [j_onehot(rng.integers(0, 10, BATCH), 10, NITI_LOGIT_CHANNELS) for _ in range(STEPS)]
    step = jax.jit(j_make_train_step(model))
    losses = []
    for x, oh in zip(xs, ohs):
        params, loss = step(params, jnp.asarray(x), jnp.asarray(oh))
        losses.append(float(loss))
    labels = np.random.default_rng(4).integers(0, 10, BATCH)
    correct = int(j_make_eval_step(model)(params, jnp.asarray(xs[0]), jnp.asarray(labels)))
    return start, xs, ohs, losses, jax_params_numpy(params), labels, correct


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_lenet_steps_byte_identical_to_jax(jax_run, backend):
    start, xs, ohs, losses_j, final_j, labels, correct_j = jax_run
    model = load_jax_params(lenet_niti(), start)
    assert_params_equal(export_jax_params(model), start)
    step = make_train_step(model)
    losses = []
    with use_backend(backend):
        for x, oh in zip(xs, ohs):
            losses.append(float(step(torch.from_numpy(x), torch.from_numpy(oh))))
        correct = int(make_eval_step(model)(torch.from_numpy(xs[0]), torch.from_numpy(labels)))
    final = export_jax_params(model)
    assert_params_equal(final, final_j)
    assert any(not np.array_equal(f["w"][0], s["w"][0]) for f, s in zip(final, start) if f)
    np.testing.assert_allclose(losses, losses_j, rtol=0, atol=1e-5)
    assert correct == correct_j


@pytest.mark.parametrize("batch", [8, 64])
def test_quantize_batch(batch):
    """Integer pixels (what the loader feeds): data and ascale exact. The
    port sums the moments exactly; the JAX package sums in float32, exact
    for the pixel sum at these batches, and the rounded E[x^2] sum moves only
    ascale at a power of two. Gaussian inputs: float sums in another order,
    so ascale equal and data within 1 count on under 0.1% of the elements."""
    rng = np.random.default_rng(batch)
    x = rng.integers(0, 256, (batch, 28, 28, 1)).astype(np.float32)
    d_j, a_j = j_quantize_batch(jnp.asarray(x))
    d_t, a_t = quantize_batch(torch.from_numpy(x))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert int(a_t) == int(a_j)
    g = rng.normal(3.0, 2.0, (batch, 28, 28, 1)).astype(np.float32)
    d_j, a_j = j_quantize_batch(jnp.asarray(g))
    d_t, a_t = quantize_batch(torch.from_numpy(g))
    assert int(a_t) == int(a_j)
    diff = np.abs(d_t.numpy().astype(np.int32) - np.asarray(d_j, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_train_niti_on_cpu_and_device_guard(monkeypatch):
    """The trainer runs the plain versions on the CPU only when asked, and
    the same params give the same result under both backends."""
    x, y = synthetic_mnist(2 * BATCH, seed=0)
    xt, yt = synthetic_mnist(BATCH, seed=1)
    runs = []
    for backend in ("cuda", "torch"):
        lines = []
        model, acc = train_niti((x, y), (xt, yt), epochs=2, batch=BATCH, seed=5,
                                log=lines.append, device="cpu", backend=backend)
        runs.append((export_jax_params(model), acc, [ln.split(" lr ")[0] for ln in lines]))
    assert len(runs[0][2]) == 2 and runs[0][2][0].startswith("epoch 0: loss ")
    assert_params_equal(runs[0][0], runs[1][0])
    assert runs[0][1:] == runs[1][1:]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_niti((x, y), (xt, yt), epochs=1, batch=BATCH)
