"""`train_fp32_bn` against the JAX package's, for the float twins with batch
norm at batch 2, from the same JAX-initialised params and the same batches:
momentum SGD with the inv learning rate, the running stats taken from the
forward, the loss printed the same. Params after the steps agree within 1e-4
of the largest magnitude of each layer's entry (its weights, batch-norm
scale, bias and running stats together).

Both trainers run in float64 here (the JAX package under
``jax.enable_x64``, its model's init and loader cast; the port's model moved
to float64 and its input normalised in float64). In float32 a step at batch
2 is too ill-conditioned to compare: a relative change of 1e-9 in the input
moves a stem weight's update by 5e-4 of its scale after one step, and after
three steps the two packages' float32 params differ by up to 0.6% (ResNet-18)
and 20% (the MobileNets) of a layer's scale. MobileNetV2 is compared after
one step: its relu6 units meet batch-norm outputs at their kinks, so its
float64 runs part after two (3e-2 of a layer's scale after three steps at
width 0.25), while one step agrees within 1e-7; that case is
tests/test_torch_fp32_cifar_train_mnv2.py, which runs `check_train_fp32_bn`
of this file (each file stays under a minute alone). The JAX trainer
prefers its native loader; it is given its Python `DataLoader` here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mandheling_tpu.train.trainer as jtrainer
import mandheling_tpu_torch.train.trainer as ttrainer
from mandheling_tpu.data.loader import DataLoader as JDataLoader
from mandheling_tpu.models import mobilenet_fp32 as jmobilenet_fp32
from mandheling_tpu.models import resnet_fp32 as jresnet_fp32
from mandheling_tpu_torch.data import synthetic_cifar
from mandheling_tpu_torch.models import MobileNetV1FP32, MobileNetV2FP32, ResNet18FP32

# name -> (JAX class, port class, constructor kwargs, steps)
CASES = {
    "resnet18": (jresnet_fp32.ResNet18FP32, ResNet18FP32, {}, 3),
    "mnv1_w025": (jmobilenet_fp32.MobileNetV1FP32, MobileNetV1FP32, {"width_mult": 0.25}, 3),
}
MNV2_CASE = (jmobilenet_fp32.MobileNetV2FP32, MobileNetV2FP32, {"width_mult": 0.25}, 1)


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


def entries(tree):
    """The dicts of a params tree, bottleneck lists flattened."""
    if isinstance(tree, list):
        return [e for t in tree for e in entries(t)]
    return [tree]


def leaves(entry):
    return [a for k in sorted(entry) for a in
            (leaves(entry[k]) if isinstance(entry[k], dict) else [entry[k]])]


class Float64Loader:
    """The JAX package's Python loader, its batches cast to float64."""

    def __init__(self, x, y, batch, seed=0):
        self.loader = JDataLoader(x, y, batch, seed=seed)

    def __len__(self):
        return len(self.loader)

    def epoch(self):
        for bx, by in self.loader.epoch():
            yield bx.astype(np.float64), by


@pytest.mark.parametrize("name", list(CASES))
def test_train_fp32_bn_matches_jax(monkeypatch, name):
    check_train_fp32_bn(monkeypatch, *CASES[name])


def check_train_fp32_bn(monkeypatch, jcls, tcls, kwargs, steps):
    """Both trainers for `steps` steps of batch 2 in float64, from the JAX
    init of seed 0: the params of each layer entry within 1e-4 of its
    largest magnitude, the logged loss the same."""
    start = to_numpy(jcls(**kwargs).init(jax.random.PRNGKey(0)))  # train_fp32_bn's seed-0 init
    monkeypatch.setattr(jtrainer, "make_loader", Float64Loader)
    monkeypatch.setattr(ttrainer, "_normalize",
                        lambda x: (x.astype(np.float64) / 255.0 - 0.5) * 2.0)
    monkeypatch.setattr(jcls, "init", lambda self, key, _init=jcls.init: jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float64), _init(self, key)))
    x, y = synthetic_cifar(2 * steps, seed=31)
    # no test batch: the JAX loop's eval casts its input to float32
    train, test = (x, y), (x[:0], y[:0])
    jlines, tlines = [], []
    with jax.enable_x64(True):
        jparams, jacc = jtrainer.train_fp32_bn(jcls(**kwargs), train, test, epochs=1, batch=2,
                                               log=jlines.append)
        jparams = to_numpy(jparams)
    model, acc = ttrainer.train_fp32_bn(tcls(**kwargs).double(), train, test, epochs=1, batch=2,
                                        log=tlines.append, device="cpu", start_params=start)
    got = model.params_numpy()
    assert len(entries(got)) == len(entries(jparams))
    for i, (a, b, s) in enumerate(zip(entries(got), entries(jparams), entries(start))):
        scale = max(np.abs(v).max() for v in leaves(b))
        err = max(np.abs(u - v).max() for u, v in zip(leaves(a), leaves(b)))
        assert err <= 1e-4 * scale, (i, err, scale)
    assert any(not np.array_equal(a, s) for a, s in zip(leaves(got[0]), leaves(start[0])))
    assert acc == jacc == 0.0
    assert tlines[0].split(" [")[0] == jlines[0].split(" [")[0]  # the loss, to 4 places
    assert f"[{steps} steps" in tlines[0]
