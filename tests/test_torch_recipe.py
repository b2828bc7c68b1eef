"""The r5 MobileNetV2 recipe (per-channel depthwise exponents, filter-grad
margins 0/0; `MobilenetV2Train`) in the port against the JAX package: the
whole MobileNetV2 at width 0.25 (every layer and block of the full one),
from the same params and the same synthetic CIFAR batches. Params and
exponents must be byte-identical after 3 train steps, under both port
backends; losses agree within 1e-6 relative (the logged loss is a float32
softmax-CE). Under the "cuda" backend every stride-1 depthwise filter grad
goes through K5's dispatcher (its plain version on these CPU tensors)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mandheling_tpu.models import mobilenet_v2_niti as j_mobilenet_v2_niti
from mandheling_tpu.ops import conv as jconv
from mandheling_tpu.ops import depthwise as jdw
from mandheling_tpu.train import make_train_step as j_make_train_step
from mandheling_tpu_torch.data import onehot_padded, synthetic_cifar
from mandheling_tpu_torch.models import MOBILENET_V2_NITI_LOGITS, mobilenet_v2_niti
from mandheling_tpu_torch.ops import conv as tconv
from mandheling_tpu_torch.ops import depthwise as tdw
from mandheling_tpu_torch.ops.kernels import fused_dwconv_int8, use_backend
from mandheling_tpu_torch.train import make_train_step
from mandheling_tpu_torch.utils.jax_params import export_jax_params, flat_weights, load_jax_params

STEPS, BATCH = 3, 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test runners share the machine's cores among
    several processes, where torch's spinning thread pool slows tiny ops by
    orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_numpy(params):
    if isinstance(params, list):
        return [to_numpy(p) for p in params]
    if not params:
        return ()
    return {"w": (np.asarray(params["w"].data), np.asarray(params["w"].exp))}


def set_margins(conv_ops, dw_ops, margin):
    conv_ops.set_fgrad_margin(margin)
    dw_ops.set_dw_fgrad_margin(margin)


@pytest.mark.parametrize("fail", [False, True])
def test_recipe_margins_restore_the_callers(fail):
    """0/0 inside (the recipe's), or the margins given; the caller's own
    margins, not the contract's 2/2, come back after, also on an error."""
    try:
        set_margins(tconv, tdw, 1)
        with pytest.raises(RuntimeError) if fail else contextlib.nullcontext():
            with tdw.recipe_margins():
                assert (tconv.get_fgrad_margin(), tdw.get_dw_fgrad_margin()) == (0, 0)
                with tdw.recipe_margins(3, 4):
                    assert (tconv.get_fgrad_margin(), tdw.get_dw_fgrad_margin()) == (3, 4)
                    if fail:
                        raise RuntimeError("training failed")
                assert (tconv.get_fgrad_margin(), tdw.get_dw_fgrad_margin()) == (0, 0)
        assert (tconv.get_fgrad_margin(), tdw.get_dw_fgrad_margin()) == (1, 1)
    finally:
        set_margins(tconv, tdw, 2)


@pytest.fixture(scope="module")
def run_jax():
    x, y = synthetic_cifar(STEPS * BATCH, seed=7)
    xs = [x[i * BATCH:(i + 1) * BATCH].astype(np.float32) for i in range(STEPS)]
    ohs = [onehot_padded(y[i * BATCH:(i + 1) * BATCH], 10, MOBILENET_V2_NITI_LOGITS)
           for i in range(STEPS)]
    model = j_mobilenet_v2_niti(width_mult=0.25, dw_per_channel=True)
    params = model.init(jax.random.PRNGKey(2))
    start = to_numpy(params)
    step = jax.jit(j_make_train_step(model))
    losses = []
    set_margins(jconv, jdw, 0)
    try:
        for xb, oh in zip(xs, ohs):
            params, loss = step(params, jnp.asarray(xb), jnp.asarray(oh))
            losses.append(float(loss))
    finally:
        set_margins(jconv, jdw, 2)
    return xs, ohs, start, losses, to_numpy(params)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_recipe_steps_byte_identical_to_jax(run_jax, monkeypatch, backend):
    xs, ohs, start, losses_j, final_j = run_jax
    calls = []
    real = fused_dwconv_int8.dwconv_fgrad_acc

    def counted(*a, **k):
        calls.append(tuple(a[0].shape))
        return real(*a, **k)

    monkeypatch.setattr(fused_dwconv_int8, "dwconv_fgrad_acc", counted)
    model = load_jax_params(mobilenet_v2_niti(width_mult=0.25, dw_per_channel=True), start)
    step = make_train_step(model)
    losses = []
    with tdw.recipe_margins(), use_backend(backend):
        for xb, oh in zip(xs, ohs):
            losses.append(float(step(torch.from_numpy(xb), torch.from_numpy(oh))))
    got, want = flat_weights(export_jax_params(model)), flat_weights(final_j)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in zip(got, flat_weights(start)))
    np.testing.assert_allclose(losses, losses_j, rtol=1e-6, atol=0)
    # K5 takes all 17 depthwise filter grads of a step, the 3 strided ones too
    assert len(calls) == (STEPS * 17 if backend == "cuda" else 0)
