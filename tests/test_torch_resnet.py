"""The ResNet slice end to end: NITI ResNets trained in the port against the
JAX package from the same params (carried across by utils/jax_params.py)
and the same synthetic CIFAR batches. Params and exponents must be
byte-identical after the steps; losses agree within 1e-6 relative (the
logged loss is a float32 softmax-CE); the eval step's correct count is the
same. The JAX side runs its XLA route; the port runs the "cuda" backend
(the kernels' plain versions on CPU tensors) and the "torch" backend, in
fused modes "matmul_only" and "all" (which send the 3x3 convs `supports`
takes to the fused conv's plain version).

- A reduced ResNet-18: stem 3->8, basic blocks 8->8 (identity), 8->16
  stride 2 (projected) and 16->16, the pool and 1x1 logits of width 12, at
  batch 4 on 8x8 inputs; each package builds it from its own `_basic_block`.
- The full-width `resnet18_niti` at batch 2.
- A reduced ResNet-v2-50: the 7x7/2 stem (3->8) and the 3x3/2 maxpool, a
  projected bottleneck with its shared pre-activation (8 -> 4 -> 16), an
  identity one (16 -> 4 -> 16) and a strided projected one (16 -> 8 -> 32),
  the final relu, the pool and the logits, at batch 2 on 32x32 inputs.

Also: the full networks' layers and param-tree shapes equal the JAX
package's, and chip_smoke.py's launch table for the ResNets is the routes
(test_torch_mobilenet.py rehearses the whole table)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mandheling_tpu.nn.blocks as jblocks
import mandheling_tpu.nn.layers as jlayers
import mandheling_tpu.nn.module as jmodule
from mandheling_tpu.models import resnet as jresnet
from mandheling_tpu.train import make_eval_step as j_make_eval_step
from mandheling_tpu.train import make_train_step as j_make_train_step
import mandheling_tpu_torch.nn.blocks as tblocks
import mandheling_tpu_torch.nn.layers as tlayers
import mandheling_tpu_torch.nn.module as tmodule
from mandheling_tpu_torch.data import onehot_padded, synthetic_cifar
from mandheling_tpu_torch.models import RESNET18_NITI_LOGITS, resnet18_niti, resnet50v2_niti
from mandheling_tpu_torch.models import resnet as tresnet
from mandheling_tpu_torch.ops import conv as tconv
from mandheling_tpu_torch.ops.kernels import use_backend
from mandheling_tpu_torch.train import make_eval_step, make_train_step
from mandheling_tpu_torch.utils.jax_params import export_jax_params, flat_weights, load_jax_params


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test runners share the machine's cores among
    several processes, where torch's spinning thread pool slows tiny ops by
    orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reduced_resnet18(blocks, layers, module, resnet):
    out = [layers.NITIConv2D(3, 8, (3, 3), (1, 1), "SAME"), layers.NITIRelu()]
    for in_c, out_c, s in [(8, 8, 1), (8, 16, 2), (16, 16, 1)]:
        out += [resnet._basic_block(in_c, out_c, s), layers.NITIRelu()]
    out += [blocks.GlobalAvgPool(), layers.NITIConv2D(16, RESNET18_NITI_LOGITS, (1, 1)),
            layers.SqueezeLogits()]
    return module.Sequential(out)


def reduced_resnet50v2(blocks, layers, module, resnet):
    out = [layers.NITIConv2D(3, 8, (7, 7), (2, 2), "SAME"), layers.NITIMaxPool((3, 3), (2, 2))]
    for in_c, mid_c, s in [(8, 4, 1), (16, 4, 1), (16, 8, 2)]:
        out += resnet._bottleneck_v2(in_c, mid_c, s)
    out += [layers.NITIRelu(), blocks.GlobalAvgPool(),
            layers.NITIConv2D(32, RESNET18_NITI_LOGITS, (1, 1)), layers.SqueezeLogits()]
    return module.Sequential(out)


def full_resnet18(blocks, layers, module, resnet):
    return resnet.resnet18_niti()


# name -> (builder, batch, input side, steps)
NETS = {
    "reduced_resnet18": (reduced_resnet18, 4, 8, 3),
    "resnet18": (full_resnet18, 2, 32, 2),
    "reduced_resnet50v2": (reduced_resnet50v2, 2, 32, 3),
}


def to_numpy(params):
    """JAX params -> the carrier's layout with numpy arrays."""
    if isinstance(params, list):
        return [to_numpy(p) for p in params]
    if not params:
        return ()
    if "branch" in params:
        return {"branch": to_numpy(params["branch"]), "proj": to_numpy(params["proj"])}
    return {"w": (np.asarray(params["w"].data), np.asarray(params["w"].exp))}


def assert_weights_equal(got, want):
    got, want = flat_weights(got), flat_weights(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def batches(batch, side, steps):
    x, y = synthetic_cifar(steps * batch, seed=0)
    x = x[:, :side, :side, :].astype(np.float32)
    xs = [x[i * batch:(i + 1) * batch] for i in range(steps)]
    ohs = [onehot_padded(y[i * batch:(i + 1) * batch], 10, RESNET18_NITI_LOGITS)
           for i in range(steps)]
    return xs, ohs, y[:batch].astype(np.int64)


@pytest.fixture(scope="module")
def jax_runs():
    """Per net: the start params, the JAX losses, the final params and the
    eval step's correct count (XLA backend; the JAX package's own tests hold
    it byte-identical to its Pallas kernels)."""
    runs = {}
    for name, (build, batch, side, steps) in NETS.items():
        xs, ohs, labels = batches(batch, side, steps)
        model = build(jblocks, jlayers, jmodule, jresnet)
        params = model.init(jax.random.PRNGKey(1))
        start = to_numpy(params)
        step = jax.jit(j_make_train_step(model))
        losses = []
        for x, oh in zip(xs, ohs):
            params, loss = step(params, jnp.asarray(x), jnp.asarray(oh))
            losses.append(float(loss))
        correct = int(jax.jit(j_make_eval_step(model))(params, jnp.asarray(xs[0]),
                                                      jnp.asarray(labels)))
        runs[name] = (start, losses, to_numpy(params), correct)
    return runs


def run_port(name, start, backend, mode):
    build, batch, side, steps = NETS[name]
    xs, ohs, labels = batches(batch, side, steps)
    model = build(tblocks, tlayers, tmodule, tresnet)
    load_jax_params(model, start)
    assert_weights_equal(export_jax_params(model), start)
    step = make_train_step(model)
    losses = []
    with use_backend(backend), tconv.use_fused_conv_mode(mode):
        for x, oh in zip(xs, ohs):
            losses.append(float(step(torch.from_numpy(x), torch.from_numpy(oh))))
        correct = int(make_eval_step(model)(torch.from_numpy(xs[0]), torch.from_numpy(labels)))
    return export_jax_params(model), losses, correct


def check_against_jax(jax_runs, name, backend, mode):
    start, losses_j, final_j, correct_j = jax_runs[name]
    final, losses, correct = run_port(name, start, backend, mode)
    assert_weights_equal(final, final_j)
    assert any(not np.array_equal(a, b)
               for a, b in zip(flat_weights(final), flat_weights(start)))
    np.testing.assert_allclose(losses, losses_j, rtol=1e-6, atol=0)
    assert correct == correct_j


@pytest.mark.parametrize("mode", ["matmul_only", "all"])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_reduced_resnet18_steps_byte_identical_to_jax(jax_runs, mode, backend):
    check_against_jax(jax_runs, "reduced_resnet18", backend, mode)


@pytest.mark.parametrize("mode", ["matmul_only", "all"])
def test_full_resnet18_steps_byte_identical_to_jax(jax_runs, mode):
    check_against_jax(jax_runs, "resnet18", "cuda", mode)


@pytest.mark.parametrize("mode", ["matmul_only", "all"])
def test_reduced_resnet50v2_steps_byte_identical_to_jax(jax_runs, mode):
    check_against_jax(jax_runs, "reduced_resnet50v2", "cuda", mode)


def test_projected_block_grads_nest_as_jax():
    """A ProjectedResidualBlock's grads are {"branch": [...], "proj": {"w"}},
    as the JAX package nests them, and the block's input grad is the
    clipped sum of its two paths'."""
    block = tresnet._basic_block(8, 16, 2)
    assert isinstance(block, tblocks.ProjectedResidualBlock)
    block.reset_parameters(torch.Generator().manual_seed(3))
    x = torch.randint(-128, 128, (2, 8, 8, 8), generator=torch.Generator().manual_seed(4),
                      dtype=torch.int8)
    from mandheling_tpu_torch.ops.qtensor import QTensor
    y, res = block.fwd(QTensor(x, torch.tensor(-7, dtype=torch.int32)))
    assert y.data.shape == (2, 4, 4, 16)
    gy = torch.randint(-128, 128, (2, 4, 4, 16), generator=torch.Generator().manual_seed(5),
                       dtype=torch.int8)
    gx, grads = block.bwd(res, gy)
    assert set(grads) == {"branch", "proj"} and len(grads["branch"]) == 3
    assert set(grads["proj"]) == {"w"} and grads["proj"]["w"].data.shape == (1, 1, 8, 16)
    g_b, _ = block.branch.bwd(res[0], gy)
    g_p, _ = block.proj.bwd(res[1], gy)
    want = torch.clamp(g_b.to(torch.int32) + g_p.to(torch.int32), -127, 127).to(torch.int8)
    assert torch.equal(gx, want)


def _attrs(layer):
    return (type(layer).__name__,) + tuple(
        getattr(layer, a, None) for a in ("in_channels", "out_channels", "kernel", "stride",
                                          "padding", "window"))


def _layout(model, residual, projected):
    out = []
    for layer in model.layers:
        if isinstance(layer, projected):
            out.append(("projected", _layout(layer.branch, residual, projected),
                        _attrs(layer.proj)))
        elif isinstance(layer, residual):
            out.append(("residual", _layout(layer.branch, residual, projected)))
        else:
            out.append(_attrs(layer))
    return out


@pytest.mark.parametrize("name", ["resnet18", "resnet50v2"])
def test_full_layout_and_param_shapes_match_jax(name):
    """The full networks have the JAX package's layers, nesting, widths,
    strides and pads, and their params the JAX package's tree paths,
    shapes and dtypes (resnet50v2 with 1000 classes: 108 leaves, the
    logits 1000 wide)."""
    tmodel = resnet18_niti() if name == "resnet18" else resnet50v2_niti(num_classes=1000)
    jmodel = jresnet.resnet18_niti() if name == "resnet18" else jresnet.resnet50v2_niti(1000)
    assert _layout(tmodel, tblocks.ResidualBlock, tblocks.ProjectedResidualBlock) == \
        _layout(jmodel, jblocks.ResidualBlock, jresnet.ProjectedResidualBlock)
    from mandheling_tpu_torch.utils.checkpoint import flatten_params

    shapes, _ = jax.tree.flatten_with_path(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))
    # keyed as the JAX package's checkpoints key them (utils/checkpoint.py)
    want = {"/".join(str(p) for p in path): (v.shape, v.dtype) for path, v in shapes}
    got = {k: (v.shape, v.dtype) for k, v in flatten_params(export_jax_params(tmodel)).items()}
    assert list(got) == list(want)
    assert got == want
    assert len(got) == (42 if name == "resnet18" else 108)


def _load_chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_resnet_k3_shapes_are_k3_cases():
    """Under fused mode "all" every K3 call of a batch-256 ResNet-18 train
    and eval step is a K3_CASES shape of chip_smoke.py (which checks and
    times K3 there), and the three strided 1x1 projections and their input
    grads are its K2 path cases for ResNet-18. Rehearsed on the meta
    device with chip_smoke.py's own recorder."""
    from mandheling_tpu_torch.ops.kernels import fused_conv_int8, fused_matmul_int8

    cs = _load_chip_smoke()
    model = resnet18_niti().to("meta")
    x = torch.zeros((256, 32, 32, 3), device="meta")
    oh = torch.zeros((256, RESNET18_NITI_LOGITS), dtype=torch.int32, device="meta")
    spec = {"K3": (fused_conv_int8, "conv_max", cs.k3_key),
            "K2": (fused_matmul_int8, "matmul_max", cs.k1_key)}
    with tconv.use_fused_conv_mode("all"):
        with cs.recording(spec) as train:
            make_train_step(model)(x, oh)
        with cs.recording(spec) as evals:
            make_eval_step(model)(x, torch.zeros(256, dtype=torch.int64, device="meta"))
    assert set(train["K3"]) | set(evals["K3"]) <= cs.K3_KEYS
    assert sum(train["K3"].values()) == 24 and sum(evals["K3"].values()) == 14
    assert set(train["K2"]) == set(cs.K2_RESNET18_CASES)
    assert set(evals["K2"]) < set(cs.K2_RESNET18_CASES)
