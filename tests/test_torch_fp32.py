"""The float32 LeNet baseline (`MnistTrain`) against the JAX package:
`LeNetFP32` forward and float SGD, from the same params (carried across as
the JAX float dict) and the same batches. Tolerances are relative to the
largest magnitude of the reference: 1e-5 for a forward (float32 sums in
another order), 1e-4 for the params after 3 `train_fp32` steps (autograd's
float32 gradients and the update, in another order), 1e-6 for one SGD
update (the same float32 expression).

The JAX trainer takes its native loader when the native library loads; the
JAX run here uses the JAX package's Python `DataLoader`, whose order the
port's copies."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mandheling_tpu.train.trainer as jtrainer
from mandheling_tpu.data.loader import DataLoader as JDataLoader
from mandheling_tpu.models.lenet import LeNetFP32 as JLeNetFP32
from mandheling_tpu.train import optim as joptim
from mandheling_tpu_torch.data import synthetic_mnist
from mandheling_tpu_torch.models import LeNetFP32
from mandheling_tpu_torch.train import optim as toptim
from mandheling_tpu_torch.train.trainer import train_fp32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test runners share the machine's cores among
    several processes, where torch's spinning thread pool slows tiny ops by
    orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_numpy(tree):
    return {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in tree.items()}


def assert_close(got, want, rtol):
    scale = np.abs(want).max()
    assert np.abs(np.asarray(got, np.float64) - want).max() <= rtol * scale


def test_lenet_fp32_forward_matches_jax():
    params = JLeNetFP32().init(jax.random.PRNGKey(0))
    x = np.random.default_rng(0).normal(0, 1, (8, 28, 28, 1)).astype(np.float32)
    want = np.asarray(JLeNetFP32().apply(params, jnp.asarray(x)))
    model = LeNetFP32().load_params(to_numpy(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (8, 10)
    assert_close(got, want, 1e-5)
    for name, leaves in model.params_numpy().items():
        for key, arr in leaves.items():
            np.testing.assert_array_equal(arr, np.asarray(params[name][key]))


def test_sgd_update_matches_jax():
    rng = np.random.default_rng(1)
    w, g, v = (rng.normal(0, 1, (50, 7)).astype(np.float32) for _ in range(3))
    wj, vj = joptim.sgd_update({"w": jnp.asarray(w)}, {"w": jnp.asarray(g)}, {"w": jnp.asarray(v)},
                               jnp.float32(0.01))
    wt, vt = torch.from_numpy(w.copy()), torch.from_numpy(v.copy())
    toptim.sgd_update([wt], [torch.from_numpy(g)], [vt], 0.01)
    assert_close(wt.numpy(), np.asarray(wj["w"]), 1e-6)
    assert_close(vt.numpy(), np.asarray(vj["w"]), 1e-6)
    assert all(float(z.abs().max()) == 0 for z in toptim.sgd_init([wt, vt]))


def test_train_fp32_three_steps_match_jax(monkeypatch):
    monkeypatch.setattr(jtrainer, "make_loader",
                        lambda x, y, batch, seed=0: JDataLoader(x, y, batch, seed=seed))
    train, test = synthetic_mnist(3 * 64, seed=31), synthetic_mnist(64, seed=32)
    jlines, tlines = [], []
    jparams, _ = jtrainer.train_fp32(train, test, epochs=1, batch=64, log=jlines.append)
    start = to_numpy(JLeNetFP32().init(jax.random.PRNGKey(0)))  # train_fp32's seed-0 init
    model, _ = train_fp32(train, test, epochs=1, batch=64, log=tlines.append, device="cpu",
                          start_params=start)
    got = model.params_numpy()
    for name in LeNetFP32.SHAPES:
        for key in ("w", "b"):
            assert_close(got[name][key], np.asarray(jparams[name][key]), 1e-4)
    loss_j = float(jlines[0].split("loss ")[1].split()[0])
    loss_t = float(tlines[0].split("loss ")[1].split()[0])
    assert abs(loss_t - loss_j) <= 1e-4 * abs(loss_j) + 5e-5  # both printed to 4 places
    assert tlines[0].startswith("epoch 0: loss ") and "[3 steps" in tlines[0]
