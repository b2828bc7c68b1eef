"""The float twins with batch norm (`MobileNetV2FP32`, `MobileNetV1FP32`,
`ResNet18FP32`) against the JAX package's, from JAX-initialised params at
batch 2, 32x32 inputs. Tolerances are relative to the largest magnitude of
the reference; for a batch norm's running stats, of that layer's (mean,
var) pair, since a mean that is zero by construction (a conv of a
normalised input) holds only rounding noise.

- In float64 (the JAX package under ``jax.enable_x64``, the port's model
  moved to float64) both forwards, train and eval mode, and the running
  stats after a training forward agree within 1e-10: the formulas are the
  same.
- In float32 the eval forward agrees within 1e-5, as does the training
  forward of ResNet-18 and every running stat. The MobileNets' training
  forward agrees within 5e-5: normalising 52 (V2) or 27 (V1) layers by
  two-sample batch statistics amplifies the summation order, and the JAX
  twin's own float32 logits sit 1.5-2.6e-5 from its float64 ones there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mandheling_tpu.models import mobilenet_fp32 as jmobilenet_fp32
from mandheling_tpu.models import resnet_fp32 as jresnet_fp32
from mandheling_tpu_torch.models import MobileNetV1FP32, MobileNetV2FP32, ResNet18FP32

MODELS = {
    "mnv2": (jmobilenet_fp32.MobileNetV2FP32, MobileNetV2FP32),
    "mnv1": (jmobilenet_fp32.MobileNetV1FP32, MobileNetV1FP32),
    "resnet18": (jresnet_fp32.ResNet18FP32, ResNet18FP32),
}
TRAIN_FWD_RTOL = {"mnv2": 5e-5, "mnv1": 5e-5, "resnet18": 1e-5}


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
    if isinstance(tree, list):
        return [to_numpy(t) for t in tree]
    return {k: to_numpy(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def bn_stats(tree, path=""):
    """{path: (mean, var)} of every batch norm of a params tree."""
    out = {}
    if isinstance(tree, list):
        for i, t in enumerate(tree):
            out.update(bn_stats(t, f"{path}[{i}]"))
    elif "mean" in tree:
        out[path] = (np.asarray(tree["mean"]), np.asarray(tree["var"]))
    else:
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(bn_stats(v, f"{path}.{k}"))
    return out


def assert_close(got, want, rtol):
    want = np.asarray(want)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def assert_stats_close(got_tree, want_tree, rtol):
    got, want = bn_stats(got_tree), bn_stats(want_tree)
    assert list(got) == list(want) and got
    for path, (mean, var) in want.items():
        scale = max(np.abs(mean).max(), np.abs(var).max())
        err = max(np.abs(got[path][0] - mean).max(), np.abs(got[path][1] - var).max())
        assert err <= rtol * scale, (path, err, scale)


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(0).normal(0, 1, (2, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_and_stats_match_jax(x, name):
    jcls, tcls = MODELS[name]
    jmodel = jcls()
    apply = jax.jit(jmodel.apply, static_argnames="training")
    params = jmodel.init(jax.random.PRNGKey(0))
    model = tcls().load_params(to_numpy(params))
    want, _ = apply(params, jnp.asarray(x), training=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 10)
    assert_close(got, want, 1e-5)
    want, new_params = apply(params, jnp.asarray(x), training=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x), training=True).numpy()
    assert_close(got, want, TRAIN_FWD_RTOL[name])
    assert_stats_close(model.params_numpy(), to_numpy(new_params), 1e-5)
    moved = bn_stats(model.params_numpy())
    assert any(not np.array_equal(m, 0) for m, _ in moved.values())


@pytest.mark.parametrize("name", list(MODELS))
def test_float64_forward_and_stats_match_jax(x, name):
    jcls, tcls = MODELS[name]
    jmodel = jcls()
    apply = jax.jit(jmodel.apply, static_argnames="training")
    start = to_numpy(jmodel.init(jax.random.PRNGKey(1)))
    x64 = x.astype(np.float64)
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), start)
        want_eval, _ = apply(params, jnp.asarray(x64), training=False)
        want_train, new_params = apply(params, jnp.asarray(x64), training=True)
        want_eval, want_train, new_params = (np.asarray(want_eval), np.asarray(want_train),
                                             to_numpy(new_params))
    model = tcls().load_params(start).double()
    with torch.no_grad():
        assert_close(model(torch.from_numpy(x64)).numpy(), want_eval, 1e-10)
        assert_close(model(torch.from_numpy(x64), training=True).numpy(), want_train, 1e-10)
    assert_stats_close(model.params_numpy(), new_params, 1e-10)


def test_params_tree_round_trips():
    """load_params / params_numpy carry the JAX tree unchanged; a tree of
    the wrong shape is refused; the running stats are buffers, not
    parameters."""
    params = to_numpy(jresnet_fp32.ResNet18FP32().init(jax.random.PRNGKey(2)))
    model = ResNet18FP32().load_params(params)
    back = model.params_numpy()
    flat = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in flat(back)] == [p for p, _ in flat(params)]
    for (_, a), (_, b) in zip(flat(back), flat(params)):
        np.testing.assert_array_equal(a, b)
    n_bn = len(bn_stats(params))
    assert n_bn == 1 + 8 * 2 + 3
    assert len(list(model.buffers())) == 2 * n_bn
    assert len(list(model.parameters())) == len(flat(params)) - 2 * n_bn
    with pytest.raises(ValueError, match="shape"):
        MobileNetV2FP32(width_mult=0.5).load_params(
            to_numpy(jmobilenet_fp32.MobileNetV2FP32().init(jax.random.PRNGKey(0))))
