"""GPipe of the port (parallel/pp.py, parallel/pp_general.py) on gloo
processes, byte for byte against the JAX package's `make_gpipe_train_step`
on its CPU mesh and against one process on the same quantized batch:

- `homogeneous_blocks(8, 32)`: 2 stages at M = 1 (equal to one process and
  to JAX), at M = 2 (equal to JAX), and data x pipe 2x2 at M = 1;
- the LeNet: `plan.bounds` equal to the JAX planner's, 2 stages at M = 1;
- `pack_params` / `unpack_params` against the JAX package's packed layout,
  and `quantize_microbatches`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mandheling_tpu.data import onehot_padded, synthetic_mnist
from mandheling_tpu.models import NITI_LOGIT_CHANNELS
from mandheling_tpu.models import lenet_niti as j_lenet
from mandheling_tpu.ops.loss import loss_cross_entropy_float as j_loss
from mandheling_tpu.ops.loss import loss_grad_int8 as j_loss_grad
from mandheling_tpu.ops.qtensor import QTensor as JQTensor
from mandheling_tpu.parallel import pp as jpp
from mandheling_tpu.parallel import pp_general as jpg
from mandheling_tpu.train.optim import niti_sgd_update as j_update
from mandheling_tpu_torch.models import lenet_niti
from mandheling_tpu_torch.ops.loss import loss_cross_entropy_float, loss_grad_int8
from mandheling_tpu_torch.ops.qtensor import QTensor
from mandheling_tpu_torch.parallel import pp, pp_general, runs
from mandheling_tpu_torch.train.optim import niti_sgd_update
from mandheling_tpu_torch.utils.jax_params import export_jax_params, load_jax_params
from test_torch_parallel import assert_weights_equal, loss_close, run, to_numpy

C, L, B = 32, 8, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_gpipe(model, params, mb_shape, n_stages, n_data, m, x_d, x_e, oh):
    mesh = jpp.pipe_mesh(n_stages, n_data=n_data)
    plan = jpg.GPipePlan(model, params, mb_shape, n_stages=n_stages)
    step = jpg.make_gpipe_train_step(plan, mesh, n_microbatches=m, data_parallel=n_data > 1,
                                     donate=False)
    packed = jpg.shard_packed_params(mesh, plan.pack_params(params))
    new, loss = step(packed, x_d, x_e, oh)
    return to_numpy(plan.unpack_params(tuple(np.asarray(b) for b in new))), float(loss), plan


def port_single(model, params, x_d, x_e, oh):
    """One process on the same quantized batch: forward, loss, backward,
    update."""
    load_jax_params(model, params)
    logits, res = model.fwd(QTensor(torch.as_tensor(x_d), torch.as_tensor(x_e)))
    oh = torch.as_tensor(oh)
    loss = loss_cross_entropy_float(logits.data, logits.exp, oh)
    _, grads = model.bwd(res, loss_grad_int8(logits.data, logits.exp, oh), need_input_grad=False)
    niti_sgd_update(model, grads)
    return export_jax_params(model), float(loss)


@pytest.fixture(scope="module")
def gpipe_runs():
    model = jpp.homogeneous_blocks(L, C)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(0, 1, (B, 1, 1, C)), jnp.float32)
    oh = jnp.asarray(onehot_padded(rng.integers(0, 10, B), 10, C))
    q1, q2 = jpp.quantize_microbatches(x, 1), jpp.quantize_microbatches(x, 2)
    homog = {  # name: (n_stages, n_data, M, quantized microbatches, onehot)
        "s2m1": (2, 1, 1, q1, oh[None]), "s2m2": (2, 1, 2, q2, oh.reshape(2, B // 2, C)),
        "dp2s2m1": (2, 2, 1, q1, oh[None])}
    jax_out, specs = {}, {}
    for name, (s, d, m, (x_d, x_e), ohm) in homog.items():
        mb = (B // m, 1, 1, C)
        jax_out[name] = jax_gpipe(model, params, mb, s, d, m, x_d, x_e, ohm)[:2]
        specs[name] = dict(model=pp.homogeneous_blocks(L, C), params=to_numpy(params),
                           mb_shape=mb, n_stages=s, n_data=d, n_microbatches=m,
                           microbatches=[tuple(np.asarray(a) for a in (x_d, x_e, ohm))])
    lm = j_lenet()
    lp = lm.init(jax.random.PRNGKey(0))
    xs, ys = synthetic_mnist(B, seed=0)
    from mandheling_tpu.train.train_step import quantize_batch as j_quantize

    ld, le = j_quantize(jnp.asarray(xs.astype(np.float32)))
    loh = jnp.asarray(onehot_padded(ys, 10, NITI_LOGIT_CHANNELS))
    logits, res = lm.fwd(lp, JQTensor(ld, le))
    j_l = j_loss(logits.data, logits.exp, loh)
    _, grads = lm.bwd(lp, res, j_loss_grad(logits.data, logits.exp, loh), need_input_grad=False)
    jax_out["lenet"] = (to_numpy(j_update(lp, grads)), float(j_l))
    specs["lenet"] = dict(model=lenet_niti(), params=to_numpy(lp), mb_shape=(B, 28, 28, 1),
                          n_stages=2, n_microbatches=1,
                          microbatches=[(np.asarray(ld)[None], np.asarray(le).reshape(1),
                                         np.asarray(loh)[None])])
    two = run(2, [(runs.gpipe_steps, specs[k]) for k in ("s2m1", "s2m2", "lenet")])
    four = run(4, [(runs.gpipe_steps, specs["dp2s2m1"])])
    port = {k: [r[i] for r in two] for i, k in enumerate(("s2m1", "s2m2", "lenet"))}
    port["dp2s2m1"] = [r[0] for r in four]
    return jax_out, port, specs, params


@pytest.mark.parametrize("case", ["s2m1", "s2m2", "dp2s2m1", "lenet"])
def test_gpipe_byte_identical_to_jax(gpipe_runs, case):
    jax_out, port, specs, _ = gpipe_runs
    j_params, j_loss_value = jax_out[case]
    results = port[case]
    assert_weights_equal(runs.pipeline_weights(results), j_params, f"JAX GPipe {case}")
    for r in results:
        assert loss_close(r["losses"][0], j_loss_value)
    if case == "dp2s2m1":  # the data replicas of a stage agree
        for s in (0, 1):
            a, b = (r["params"] for r in results if r["coords"]["pipe"] == s)
            assert_weights_equal(a, b, "data replicas")


@pytest.mark.parametrize("case", ["s2m1", "lenet"])
def test_gpipe_one_microbatch_is_one_process(gpipe_runs, case):
    _, port, specs, _ = gpipe_runs
    spec = specs[case]
    x_d, x_e, oh = spec["microbatches"][0]
    model = pp.homogeneous_blocks(L, C) if case == "s2m1" else lenet_niti()
    want, loss = port_single(model, spec["params"], x_d[0], x_e[0], oh[0])
    assert_weights_equal(runs.pipeline_weights(port[case]), want, "one process")
    assert loss_close(port[case][0]["losses"][0], loss)


def test_gpipe_microbatches_move_the_weights(gpipe_runs):
    _, port, specs, params = gpipe_runs
    assert not all(np.array_equal(a, b) for a, b in zip(
        [p["w"][0] for p in runs.pipeline_weights(port["s2m2"]) if p],
        [p["w"][0] for p in to_numpy(params) if p]))


@pytest.mark.parametrize("n_stages", [2, 4])
@pytest.mark.parametrize("net", ["lenet", "blocks"])
def test_plan_bounds_and_packing_are_the_jax_planners(net, n_stages):
    if net == "lenet":
        jm, tm, mb = j_lenet(), lenet_niti(), (32, 28, 28, 1)
    else:
        jm, tm, mb = jpp.homogeneous_blocks(L, C), pp.homogeneous_blocks(L, C), (8, 1, 1, C)
    params = jm.init(jax.random.PRNGKey(3))
    jplan = jpg.GPipePlan(jm, params, mb, n_stages=n_stages)
    plan = pp_general.GPipePlan(load_jax_params(tm, to_numpy(params)), mb, n_stages)
    assert plan.bounds == jplan.bounds
    assert plan.act_shapes == [tuple(s) for s in jplan.act_shapes]
    packed = plan.pack_params(to_numpy(params))
    for mine, theirs in zip(packed, jplan.pack_params(params)):
        np.testing.assert_array_equal(mine, np.asarray(theirs))
    assert_weights_equal(plan.unpack_params(packed), to_numpy(params), "round trip")


def test_quantize_microbatches_is_the_jax_one():
    x, _ = synthetic_mnist(32, seed=4)
    x = x.astype(np.float32)
    jd, je = jpp.quantize_microbatches(jnp.asarray(x), 4)
    td, te = pp.quantize_microbatches(torch.as_tensor(x), 4)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
