"""Multi-host data parallelism of the port on the CPU: 4 gloo ranks as 2
hosts x 2 ranks (`run_local(local_world=2)`, LOCAL_WORLD_SIZE as torchrun
sets it) train DP LeNet on `make_global_mesh()` for 3 steps on the batches
tests/test_multihost.py makes (normal pixels from numpy seed 0, global batch
16), each rank feeding its `local_batch_slice` through `shard_host_batch`;
the params equal the JAX package's single-process DP (`make_dp_train_step`
on a 4-device `data_mesh`) byte for byte and the losses within 1e-6.
`make_global_mesh(2)` keeps each model group on one host, and a model axis
wider than a host raises. `shard_for_host` is the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mandheling_tpu.data import onehot_padded
from mandheling_tpu.data import shard_for_host as j_shard_for_host
from mandheling_tpu.models import NITI_LOGIT_CHANNELS
from mandheling_tpu.models import lenet_niti as j_lenet
from mandheling_tpu.parallel import data_mesh, make_dp_train_step, replicate, shard_batch
from mandheling_tpu_torch.data import shard_for_host
from mandheling_tpu_torch.models import lenet_niti
from mandheling_tpu_torch.parallel import distributed, runs

import torch_rank_workers
from test_torch_parallel import assert_weights_equal, loss_close, to_numpy

STEPS, BATCH = 3, 16


def batches():
    """tests/test_multihost.py's data protocol."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        x = rng.normal(0, 1, (BATCH, 28, 28, 1)).astype(np.float32)
        y = rng.integers(0, 10, BATCH)
        out.append((x, onehot_padded(y, 10, NITI_LOGIT_CHANNELS)))
    return out


@pytest.fixture(scope="module")
def jax_single_process():
    model = j_lenet()
    params = model.init(jax.random.PRNGKey(0))
    mesh = data_mesh(4)
    step = make_dp_train_step(model, mesh, donate=False)
    p = replicate(mesh, params)
    losses = []
    for x, oh in batches():
        p, loss = step(p, *shard_batch(mesh, jnp.asarray(x), jnp.asarray(oh)))
        losses.append(float(loss))
    return to_numpy(params), to_numpy(p), losses


@pytest.fixture(scope="module")
def two_hosts(jax_single_process):
    init, _, _ = jax_single_process
    spec = dict(model=lenet_niti(), params=init, batches=batches(), global_mesh=True)
    return distributed.run_local(
        4, runs.sequence, [(runs.dp_steps, spec),
                           (torch_rank_workers.global_mesh_coords, dict(n_model=(1, 2, 4)))],
        timeout_s=120, threads=1, local_world=2)


def test_two_hosts_dp_byte_identical_to_jax_single_process(jax_single_process, two_hosts):
    _, want, losses = jax_single_process
    for rank, (run, _) in enumerate(two_hosts):
        assert (run["host"], run["local_world"]) == (rank // 2, 2)
        assert_weights_equal(run["params"], want, f"rank {rank}")
        assert len(run["losses"]) == STEPS and all(map(loss_close, run["losses"], losses))


def test_global_mesh_keeps_the_model_axis_within_a_host(two_hosts):
    coords = [c for _, c in two_hosts]
    assert [(c["host"], c["hosts"]) for c in coords] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert [c[1] for c in coords] == [{"data": r, "model": 0} for r in range(4)]
    assert [c[2] for c in coords] == [{"data": r // 2, "model": r % 2} for r in range(4)]
    for c in coords:  # each model group (one data row) is one host's ranks
        assert c[2]["data"] == c["host"]
        assert "must divide the 2 ranks of a host" in c[4]


def test_run_local_refuses_a_partial_host():
    with pytest.raises(ValueError, match="no whole number of hosts"):
        distributed.run_local(3, runs.sequence, [], local_world=2)


def test_one_process_is_one_host(monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert (distributed.host_index(), distributed.host_count()) == (0, 1)
    assert distributed.make_global_mesh().shape == {"data": 1, "model": 1}


@pytest.mark.parametrize("host_id,num_hosts", [(0, 2), (1, 2), (2, 3)])
def test_shard_for_host_is_the_jax_slice(host_id, num_hosts):
    x = np.arange(7 * 2).reshape(7, 2)
    y = np.arange(7)
    got, want = shard_for_host(x, y, host_id, num_hosts), j_shard_for_host(x, y, host_id,
                                                                            num_hosts)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
