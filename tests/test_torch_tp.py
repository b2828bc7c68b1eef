"""Tensor parallelism of the port (parallel/tp.py) on a 2x2 (data, model)
mesh of gloo processes, byte for byte against the JAX package's
`make_tp_train_step` on `make_mesh(2, 2)` and against the port's single
process (an unbound TPConv2D is the dense layer): `lenet_niti_tp` (two
steps) and the 16 -> 64 3x3 spatial TP conv of tests/test_tp.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mandheling_tpu.data import onehot_padded, synthetic_mnist
from mandheling_tpu.models import NITI_LOGIT_CHANNELS
from mandheling_tpu.nn import layers as jlayers
from mandheling_tpu.nn.module import Sequential as JSequential
from mandheling_tpu.parallel import tp as jtp
from mandheling_tpu.parallel.mesh import make_mesh as j_make_mesh
from mandheling_tpu_torch.nn import Flatten, NITIConv2D, NITIMaxPool, NITIRelu, Sequential
from mandheling_tpu_torch.nn import SqueezeLogits
from mandheling_tpu_torch.parallel import runs, tp
from mandheling_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
from mandheling_tpu_torch.parallel.tp import TPConv2D
from test_torch_parallel import assert_weights_equal, loss_close, run, to_numpy


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spatial(conv, tpconv, relu, pool, flatten, squeeze, seq):
    """tests/test_tp.py's spatial TP model, in either package's layers."""
    return seq([
        conv(1, 16, (3, 3), padding="SAME"), relu(), pool((2, 2), (2, 2)),
        tpconv(16, 64, (3, 3), padding="SAME"), relu(), pool((2, 2), (2, 2)), flatten(),
        tpconv(7 * 7 * 64, 128, (1, 1)), relu(), conv(128, 12, (1, 1)), squeeze(),
    ])


CASES = {
    "lenet_tp": (jtp.lenet_niti_tp, tp.lenet_niti_tp, 0, 64, 2),
    "spatial": (lambda: spatial(jlayers.NITIConv2D, jtp.TPConv2D, jlayers.NITIRelu,
                                jlayers.NITIMaxPool, jlayers.Flatten, jlayers.SqueezeLogits,
                                JSequential),
                lambda: spatial(NITIConv2D, TPConv2D, NITIRelu, NITIMaxPool, Flatten,
                                SqueezeLogits, Sequential), 1, 32, 1),
}


@pytest.fixture(scope="module")
def tp_runs():
    """Both cases: the JAX package's run, and the port's 4 ranks (one group)."""
    jax_out, items = {}, []
    for name, (jbuild, tbuild, key, batch, steps) in CASES.items():
        jm = jbuild()
        params = jm.init(jax.random.PRNGKey(key))
        x, y = synthetic_mnist(batch * steps, seed=key)
        batches = [(x[i * batch:(i + 1) * batch].astype(np.float32),
                    onehot_padded(y[i * batch:(i + 1) * batch], 10, NITI_LOGIT_CHANNELS))
                   for i in range(steps)]
        mesh = j_make_mesh(n_data=2, n_model=2)
        step = jtp.make_tp_train_step(jm, mesh, donate=False)
        p = jtp.shard_params(mesh, jm, params)
        shard = NamedSharding(mesh, P("data"))
        losses = []
        for bx, oh in batches:
            p, loss = step(p, jax.device_put(jnp.asarray(bx), shard),
                           jax.device_put(jnp.asarray(oh), shard))
            losses.append(float(loss))
        jax_out[name] = (to_numpy(p), losses, to_numpy(params), batches)
        items.append((runs.tp_steps, dict(model=tbuild(), params=to_numpy(params),
                                          batches=batches, n_data=2, n_model=2)))
    port = run(4, items)
    return {name: (jax_out[name], [r[i] for r in port]) for i, name in enumerate(CASES)}


@pytest.mark.parametrize("case", list(CASES))
def test_tp_2x2_byte_identical_to_jax_and_one_process(tp_runs, case):
    (j_params, j_losses, start, batches), port = tp_runs[case]
    tbuild = CASES[case][1]
    assert sorted((r["coords"][DATA_AXIS], r["coords"][MODEL_AXIS]) for r in port) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    # data replicas hold the same slice; model ranks the same replicated layers
    by = {(r["coords"][DATA_AXIS], r["coords"][MODEL_AXIS]): r for r in port}
    for m in (0, 1):
        assert_weights_equal(by[(1, m)]["params"], by[(0, m)]["params"], "data replicas")
    got = runs.tp_weights(port, tbuild())
    assert_weights_equal(got, j_params, "JAX TP")
    for r in port:
        assert all(map(loss_close, r["losses"], j_losses))
    single = runs.dp_steps(dict(model=tbuild(), params=start, batches=batches, world=0))
    assert_weights_equal(got, single["params"], "the port's one process")
    assert all(map(loss_close, single["losses"], j_losses))


def test_tp_param_specs_and_unbound_layer():
    model = tp.lenet_niti_tp()
    specs = tp.tp_param_specs(model)
    assert [i for i, s in enumerate(specs) if s] == [7]
    assert specs[7] == {"w": (None, None, None, MODEL_AXIS)}
    assert model.layers[7].mesh is None and tuple(model.layers[7].w.shape) == (1, 1, 832, 500)
