"""Data parallelism of the port (mandheling_tpu_torch/parallel) on gloo
processes, byte for byte against the JAX package on its 8-device CPU mesh.

The ranks are spawned by `parallel.distributed.run_local` (each group has its
own collective timeout and join deadline, so a hang fails one test) and run
the workers of `parallel/runs.py` and `torch_rank_workers.py`, which import
nothing of JAX; the JAX references run in this process. Params are carried
across from the JAX init, the batches are integer-valued pixels
(`synthetic_mnist`).

- LeNet DP at world 2 and 4: equal to the JAX package's `make_dp_train_step`
  on `data_mesh(N)`, to the port's single process and to `jit_train_step`;
  losses within 1e-6 (relative above 1), the eval count equal;
- the int8 wire mode at world 2 and 4, equal to the JAX package under
  `use_grad_allreduce("int8")` on `data_mesh(N)`;
- the MobileNetV2 recipe (width 0.25, per-channel depthwise, proj_bits=15,
  margins 1/1) at world 2, on the JAX test's own normal batch;
- the parallel joins and the transfer step at world 2;
- `distributed.initialize` from the environment, and `local_batch_slice`.
"""

import multiprocessing
import socket
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from mandheling_tpu import nn as jnn_layers
from mandheling_tpu.nn import blocks as jblocks
from mandheling_tpu.data import onehot_padded, synthetic_mnist
from mandheling_tpu.models import NITI_LOGIT_CHANNELS
from mandheling_tpu.models import lenet_niti as j_lenet
from mandheling_tpu.models.mobilenet import mobilenet_v2_niti as j_mnv2
from mandheling_tpu.ops import conv as jconv
from mandheling_tpu.ops import depthwise as jdw
from mandheling_tpu.ops.allreduce import use_grad_allreduce as j_use_grad_allreduce
from mandheling_tpu.parallel.mesh import data_mesh as j_data_mesh
from mandheling_tpu.parallel.sharded_step import make_dp_eval_step as j_dp_eval
from mandheling_tpu.parallel.sharded_step import make_dp_train_step as j_dp_train
from mandheling_tpu.parallel.sharded_step import replicate as j_replicate
from mandheling_tpu.parallel.sharded_step import shard_batch as j_shard_batch
from mandheling_tpu.train import jit_train_step
from mandheling_tpu.train import transfer as jtransfer
from mandheling_tpu_torch import nn as tnn
from mandheling_tpu_torch.models import lenet_niti, mobilenet_v2_niti
from mandheling_tpu_torch.ops import allreduce
from mandheling_tpu_torch.parallel import distributed, runs
from mandheling_tpu_torch.train.transfer import TransferModel
from mandheling_tpu_torch.utils.jax_params import flat_weights, load_jax_params

import torch_rank_workers

STEPS, BATCH = 2, 64
TIMEOUT_S = 120
jnn = types.SimpleNamespace(**vars(jnn_layers), ParallelAdd=jblocks.ParallelAdd,
                            ParallelConcat=jblocks.ParallelConcat,
                            ResidualBlock=jblocks.ResidualBlock)


def to_numpy(params):
    """JAX params -> the carrier's layout with numpy arrays (plain tuples,
    which the ranks unpickle without the JAX package)."""
    if isinstance(params, list):
        return [to_numpy(p) for p in params]
    if not params:
        return ()
    if "branch" in params:
        return {"branch": to_numpy(params["branch"]), "proj": to_numpy(params["proj"])}
    return {"w": (np.asarray(params["w"].data), np.asarray(params["w"].exp))}


def assert_weights_equal(got, want, what=""):
    a, b = flat_weights(got), flat_weights(want)
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, i)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: array {i}")


def loss_close(a, b) -> bool:
    """Losses within 1e-6, relative above 1: the logged loss is a float32
    softmax-CE, whose torch and XLA forms part by an ulp (as in
    tests/test_torch_mobilenet.py)."""
    return abs(a - b) <= 1e-6 * max(1.0, abs(b))


def run(world, items):
    """`items` [(worker, spec), ...] in one group of `world` ranks."""
    return distributed.run_local(world, runs.sequence, items, timeout_s=TIMEOUT_S, threads=1)


def ranks_agree(results):
    for r in results[1:]:
        assert_weights_equal(r["params"], results[0]["params"], "ranks")
        assert r["losses"] == results[0]["losses"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lenet_data():
    model = j_lenet()
    params = model.init(jax.random.PRNGKey(0))
    x, y = synthetic_mnist(256, seed=0)
    batches = [(x[i * BATCH:(i + 1) * BATCH].astype(np.float32),
                onehot_padded(y[i * BATCH:(i + 1) * BATCH], 10, NITI_LOGIT_CHANNELS))
               for i in range(STEPS)]
    evals = (x[128:192].astype(np.float32), y[128:192].astype(np.int64))
    return model, params, batches, evals


def jax_dp(model, params, batches, evals, n, mode="int32"):
    mesh = j_data_mesh(n)
    with j_use_grad_allreduce(mode):
        step = j_dp_train(model, mesh, donate=False)
        p = j_replicate(mesh, params)
        losses = []
        for x, oh in batches:
            p, loss = step(p, *j_shard_batch(mesh, jnp.asarray(x), jnp.asarray(oh)))
            losses.append(float(loss))
        correct = int(j_dp_eval(model, mesh)(p, *j_shard_batch(mesh, jnp.asarray(evals[0]),
                                                                jnp.asarray(evals[1]))))
    return to_numpy(p), losses, correct


@pytest.fixture(scope="module")
def lenet_runs(lenet_data):
    """Per world: the port's ranks in modes int32 and int8 (one group), the
    JAX package's DP in both modes."""
    model, params, batches, evals = lenet_data
    out = {}
    for n in (2, 4):
        spec = dict(model=lenet_niti(), params=to_numpy(params), batches=batches, eval=evals)
        port = run(n, [(runs.dp_steps, spec), (runs.dp_steps, dict(spec, allreduce="int8"))])
        out[n] = {mode: ([r[i] for r in port], jax_dp(model, params, batches, evals, n, mode))
                  for i, mode in enumerate(("int32", "int8"))}
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_dp_lenet_byte_identical_to_jax_and_one_process(lenet_data, lenet_runs, world):
    model, params, batches, evals = lenet_data
    port, (j_params, j_losses, j_correct) = lenet_runs[world]["int32"]
    ranks_agree(port)
    assert_weights_equal(port[0]["params"], j_params, "JAX DP")
    assert all(map(loss_close, port[0]["losses"], j_losses))
    assert port[0]["correct"] == j_correct
    single = runs.dp_steps(dict(model=lenet_niti(), params=to_numpy(params), batches=batches,
                                eval=evals, world=0))
    assert_weights_equal(port[0]["params"], single["params"], "the port's one process")
    assert port[0]["correct"] == single["correct"]
    step = jit_train_step(model)
    p = jax.tree.map(jnp.copy, params)
    for x, oh in batches:
        p, loss = step(p, jnp.asarray(x), jnp.asarray(oh))
    assert_weights_equal(single["params"], to_numpy(p), "jit_train_step")
    assert loss_close(single["losses"][-1], float(loss))
    # one pmax a range estimate, the batch statistics, a loss gather, and
    # one int32 sum a filter grad (4 convs), in every train step
    assert port[0]["collectives"][:STEPS] == [14] * STEPS


@pytest.mark.parametrize("world", [2, 4])
def test_dp_int8_wire_byte_identical_to_jax(lenet_runs, world):
    port, (j_params, j_losses, j_correct) = lenet_runs[world]["int8"]
    ranks_agree(port)
    assert_weights_equal(port[0]["params"], j_params, "JAX DP, int8 wire")
    assert all(map(loss_close, port[0]["losses"], j_losses))
    assert port[0]["correct"] == j_correct
    # the wire mode does change the update: it is not the int32 run
    exact = flat_weights(lenet_runs[world]["int32"][0][0]["params"])
    assert any(not np.array_equal(a, b) for a, b in zip(flat_weights(port[0]["params"]), exact))


def test_dp_mnv2_recipe_world2():
    """The JAX package's test_dp_bit_identical_mnv2_recipe at world 2: its
    seed, its normal (not integer) batch, margins 1/1."""
    model = j_mnv2(width_mult=0.25, dw_per_channel=True, proj_bits=15)
    params = model.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    bx = np.asarray(jnp.asarray(rng.normal(0, 1, (32, 32, 32, 3)), jnp.float32))
    oh = onehot_padded(rng.integers(0, 10, 32), 10, 12)
    jconv.set_fgrad_margin(1)
    jdw.set_dw_fgrad_margin(1)
    try:
        mesh = j_data_mesh(2)
        p, j_loss = j_dp_train(model, mesh, donate=False)(
            j_replicate(mesh, params), *j_shard_batch(mesh, jnp.asarray(bx), jnp.asarray(oh)))
    finally:
        jconv.set_fgrad_margin(2)
        jdw.set_dw_fgrad_margin(2)
    spec = dict(model=mobilenet_v2_niti(width_mult=0.25, dw_per_channel=True, proj_bits=15),
                params=to_numpy(params), batches=[(bx, oh)], margins=(1, 1))
    port = run(2, [(runs.dp_steps, spec)])[0]
    ranks_agree(port)
    assert loss_close(port[0]["losses"][0], float(j_loss))
    assert_weights_equal(port[0]["params"], to_numpy(p), "JAX DP, MNv2 recipe")
    single = runs.dp_steps(dict(spec, world=0))
    assert_weights_equal(port[0]["params"], single["params"], "the port's one process")


def joins_model(pkg):
    """A narrow net with both parallel joins, in either package's layers."""
    nn = pkg
    return nn.Sequential([
        nn.NITIConv2D(3, 8, (3, 3), padding="SAME"), nn.NITIRelu(),
        nn.ParallelConcat([nn.Sequential([nn.NITIConv2D(8, 4, (1, 1))]),
                           nn.Sequential([nn.NITIConv2D(8, 4, (3, 3), padding="SAME")])]),
        nn.NITIRelu(),
        nn.ParallelAdd([nn.Sequential([nn.NITIConv2D(8, 8, (3, 3), padding="SAME"),
                                       nn.NITIRelu()]), nn.Sequential([])]),
        nn.NITIMaxPool((2, 2), (2, 2)), nn.Flatten(), nn.NITIConv2D(128, 12, (1, 1)),
        nn.SqueezeLogits(),
    ])


def transfer_parts(pkg):
    nn = pkg
    features = nn.Sequential([nn.NITIConv2D(3, 8, (3, 3), padding="SAME"), nn.NITIRelu(),
                              nn.NITIMaxPool((2, 2), (2, 2)), nn.Flatten()])
    head = nn.Sequential([nn.NITIConv2D(128, 12, (1, 1)), nn.SqueezeLogits()])
    return features, head


def test_dp_parallel_joins_and_transfer_world2():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (8, 8, 8, 3)).astype(np.float32)
    oh = onehot_padded(rng.integers(0, 10, 8), 10, 12)
    mesh = j_data_mesh(2)
    jm = joins_model(jnn)
    jp = jm.init(jax.random.PRNGKey(2))
    j_joins, j_joins_loss = j_dp_train(jm, mesh, donate=False)(
        j_replicate(mesh, jp), *j_shard_batch(mesh, jnp.asarray(x), jnp.asarray(oh)))
    jf, jh = transfer_parts(jnn)
    fp, hp = jf.init(jax.random.PRNGKey(3)), jh.init(jax.random.PRNGKey(4))
    jt = jtransfer.TransferModel(jf, fp, jh)
    jstep = jax.jit(shard_map(jtransfer.make_transfer_train_step(jt, "data"), mesh=mesh,
                              in_specs=(P(), P("data"), P("data")), out_specs=(P(), P()),
                              check_vma=False))
    j_head, j_t_loss = jstep(j_replicate(mesh, hp), *j_shard_batch(mesh, jnp.asarray(x),
                                                                    jnp.asarray(oh)))
    tf, th = transfer_parts(tnn)
    load_jax_params(tf, to_numpy(fp))
    port = run(2, [
        (runs.dp_steps, dict(model=joins_model(tnn), params=to_numpy(jp), batches=[(x, oh)])),
        (runs.dp_steps, dict(model=TransferModel(tf, th), params=to_numpy(hp),
                             batches=[(x, oh)], transfer=True)),
    ])
    joins, transfer = [r[0] for r in port], [r[1] for r in port]
    for results, j_params, j_loss, what in ((joins, j_joins, j_joins_loss, "joins"),
                                            (transfer, j_head, j_t_loss, "transfer head")):
        ranks_agree(results)
        assert_weights_equal(results[0]["params"], to_numpy(j_params), what)
        assert loss_close(results[0]["losses"][0], float(j_loss))
    assert not all(np.array_equal(a, b) for a, b in zip(flat_weights(joins[0]["params"]),
                                                        flat_weights(to_numpy(jp))))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_from_the_environment(monkeypatch):
    """Unconfigured: a no-op, one process. Configured by the torchrun
    variables: two processes join and see each other; a configured rank
    that cannot reach its coordinator raises."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    distributed.initialize()
    assert not torch.distributed.is_initialized()
    assert (distributed.process_count(), distributed.process_index()) == (1, 0)
    assert distributed.local_batch_slice(64) == (0, 64)

    port = _free_port()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": "2"}
    procs = [ctx.Process(target=torch_rank_workers.join_from_env,
                         args=(dict(env, RANK=str(r)), results)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = sorted(results.get(timeout=90) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    assert got == [(0, 2, 1, (0, 64)), (1, 2, 1, (64, 128))]

    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(Exception):
        distributed.initialize(timeout_s=3)
    assert not torch.distributed.is_initialized()


def test_run_local_fails_on_a_rank_error():
    with pytest.raises(RuntimeError, match="a rank raised"):
        distributed.run_local(2, torch_rank_workers.op_rows,
                              dict(op=allreduce.psum, args=["not a tensor"]),
                              timeout_s=30, threads=1)


def residual_model(pkg):
    """A narrow residual net, in either package's layers."""
    nn = pkg
    return nn.Sequential([
        nn.NITIConv2D(3, 8, (3, 3), padding="SAME"), nn.NITIRelu(),
        nn.ResidualBlock(nn.Sequential([nn.NITIConv2D(8, 8, (3, 3), padding="SAME"),
                                        nn.NITIRelu()])),
        nn.NITIMaxPool((2, 2), (2, 2)), nn.Flatten(), nn.NITIConv2D(128, 12, (1, 1)),
        nn.SqueezeLogits(),
    ])


def test_dp_residual_add_takes_the_group_max():
    """A residual add requantizes its sum by a range estimate; the port takes
    it over the group, so DP equals one process (the contract of the JAX
    package's parallel/sharded_step.py). The JAX package's `add_int8`
    estimates on each shard alone: with one shard of flat images and one of
    full-contrast ones, the shards' bitwidths differ, and its DP step parts
    from its single-chip step, which the port's DP step equals (ROADMAP
    Queue 3)."""
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.integers(120, 124, (4, 8, 8, 3)),
                        rng.integers(0, 256, (4, 8, 8, 3))]).astype(np.float32)
    oh = onehot_padded(rng.integers(0, 10, 8), 10, 12)
    jm = residual_model(jnn)
    jp = jm.init(jax.random.PRNGKey(8))
    j_single, j_loss = jit_train_step(jm)(jax.tree.map(jnp.copy, jp), jnp.asarray(x),
                                          jnp.asarray(oh))
    mesh = j_data_mesh(2)
    j_dp, _ = j_dp_train(jm, mesh, donate=False)(
        j_replicate(mesh, jp), *j_shard_batch(mesh, jnp.asarray(x), jnp.asarray(oh)))
    assert not all(np.array_equal(a, b) for a, b in zip(flat_weights(to_numpy(j_dp)),
                                                        flat_weights(to_numpy(j_single))))
    spec = dict(model=residual_model(tnn), params=to_numpy(jp), batches=[(x, oh)])
    port = run(2, [(runs.dp_steps, spec)])
    results = [r[0] for r in port]
    ranks_agree(results)
    assert results[0]["sites"][0]["add"][0] == 1  # the add's one group max
    assert_weights_equal(results[0]["params"], to_numpy(j_single), "JAX single chip")
    assert loss_close(results[0]["losses"][0], float(j_loss))
    single = runs.dp_steps(dict(spec, world=0))
    assert_weights_equal(results[0]["params"], single["params"], "the port's one process")
