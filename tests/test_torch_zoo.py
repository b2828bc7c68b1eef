"""The zoo slice: the parallel joins (``ParallelConcat``, ``ParallelAdd``),
the Inception modules, SqueezeNet v1.0 and Inception-v3, in the port
against the JAX package from the same params (carried across by
utils/jax_params.py) and the same inputs, made with numpy. Outputs, input
grads and weight grads, and params after train steps, must be
byte-identical; losses agree within 1e-6 relative (the logged loss is a
float32 softmax-CE); eval steps give the same correct count. The JAX side
runs its XLA route; the port runs the "cuda" backend (the kernels' plain
versions on CPU tensors) in fused modes "matmul_only" and "all" (which
sends the convs the fused conv's `supports` takes, the Inception 1x7 and 1x3
convs among them, to its plain version).

Also: both networks' layers, nesting and checkpoint keys are the JAX
package's, and chip_smoke.py's K3 cases cover the zoo's fused convs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mandheling_tpu.nn.blocks as jblocks
import mandheling_tpu.nn.layers as jlayers
import mandheling_tpu.nn.module as jmodule
from mandheling_tpu.models import inception as jinception
from mandheling_tpu.models import squeezenet as jsqueezenet
from mandheling_tpu.ops.qtensor import QTensor as JQ
from mandheling_tpu.train import make_eval_step as j_make_eval_step
from mandheling_tpu.train import make_train_step as j_make_train_step
from mandheling_tpu.utils import checkpoint as jcheckpoint
import mandheling_tpu_torch.nn.blocks as tblocks
import mandheling_tpu_torch.nn.layers as tlayers
import mandheling_tpu_torch.nn.module as tmodule
from mandheling_tpu_torch.models import inception as tinception
from mandheling_tpu_torch.models import inceptionv3_niti, squeezenet_niti
from mandheling_tpu_torch.ops import conv as tconv
from mandheling_tpu_torch.ops.qtensor import QTensor
from mandheling_tpu_torch.train import make_eval_step, make_train_step
from mandheling_tpu_torch.utils import checkpoint as tcheckpoint
from mandheling_tpu_torch.utils.jax_params import export_jax_params, flat_weights, load_jax_params

MODES = ["matmul_only", "all"]


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
    """JAX params -> the carrier's layout with numpy arrays, nested lists kept."""
    if isinstance(params, list):
        return [to_numpy(p) for p in params]
    if not params:
        return ()
    return {"w": (np.asarray(params["w"].data), np.asarray(params["w"].exp))}


def grads_numpy(grads):
    """A grads tree (JAX or port QTensors) -> the carrier's layout, numpy."""
    if isinstance(grads, list):
        return [grads_numpy(g) for g in grads]
    if not grads:
        return ()
    return {"w": (np.asarray(grads["w"].data), np.asarray(grads["w"].exp))}


def assert_weights_equal(got, want):
    got, want = flat_weights(got), flat_weights(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def fwd_bwd_both(jlayer, tlayer, x, gy_seed, mode="matmul_only", key=0, params=None):
    """One forward and backward of a JAX layer and its port, from `params`
    (default: the JAX init at PRNGKey(key)), on int8 x (exponent -7) and a
    random int8 gy of the output's shape -> ((y, e, gx, grads) of JAX, of
    the port)."""
    params = jlayer.init(jax.random.PRNGKey(key)) if params is None else params
    load_jax_params(tmodule.Sequential([tlayer]), [to_numpy(params)])
    exp = np.int32(-7)
    yj, resj = jlayer.fwd(params, JQ(jnp.asarray(x), jnp.asarray(exp)))
    gy = np.random.default_rng(gy_seed).integers(-128, 128, yj.data.shape, dtype=np.int8)
    gxj, gj = jlayer.bwd(params, resj, jnp.asarray(gy))
    with tconv.use_fused_conv_mode(mode):
        yt, rest = tlayer.fwd(QTensor(torch.from_numpy(x), torch.tensor(exp)))
        gxt, gt = tlayer.bwd(rest, torch.from_numpy(gy))
    return ((np.asarray(yj.data), int(yj.exp), np.asarray(gxj), grads_numpy(gj)),
            (yt.data.numpy(), int(yt.exp), gxt.numpy(), grads_numpy(gt)))


def assert_same(jax_out, port_out):
    (yj, ej, gxj, gj), (yt, et, gxt, gt) = jax_out, port_out
    np.testing.assert_array_equal(yt, yj)
    assert et == ej
    np.testing.assert_array_equal(gxt, gxj)
    assert_weights_equal(gt, gj)


def two_branches(blocks, layers, module, c3):
    """The JAX test's branches: conv 1x1 4 -> 8 + relu, conv 3x3 SAME 4 ->
    c3 + relu."""
    return [module.Sequential([layers.NITIConv2D(4, 8, (1, 1)), layers.NITIRelu()]),
            module.Sequential([layers.NITIConv2D(4, c3, (3, 3), (1, 1), "SAME"),
                               layers.NITIRelu()])]


def rand_x(shape, seed=1):
    return np.random.default_rng(seed).integers(-100, 100, shape, dtype=np.int8)


def test_parallel_concat_fwd_bwd_byte_identical_to_jax():
    """ParallelConcat at the JAX test's shape (tests/test_benchmark_models.py):
    the output is the channel concat of 8 + 4, each branch's grads are its
    own slice's, and the input grad is the clipped sum of the branches'."""
    jl = jblocks.ParallelConcat(two_branches(jblocks, jlayers, jmodule, 4))
    tl = tblocks.ParallelConcat(two_branches(tblocks, tlayers, tmodule, 4))
    jax_out, port_out = fwd_bwd_both(jl, tl, rand_x((2, 6, 6, 4)), 2)
    assert_same(jax_out, port_out)
    assert port_out[0].shape == (2, 6, 6, 12) and port_out[0].dtype == np.int8
    assert len(port_out[3]) == 2 and len(port_out[3][0]) == 2


def test_parallel_add_fwd_bwd_byte_identical_to_jax():
    """ParallelAdd of two branches (1x1 and 3x3, 4 -> 8): the exponent-
    aligned int8 add forward, all of gy to each branch backward."""
    jl = jblocks.ParallelAdd(two_branches(jblocks, jlayers, jmodule, 8))
    tl = tblocks.ParallelAdd(two_branches(tblocks, tlayers, tmodule, 8))
    jax_out, port_out = fwd_bwd_both(jl, tl, rand_x((2, 6, 6, 4)), 3)
    assert_same(jax_out, port_out)
    assert port_out[0].shape == (2, 6, 6, 8)
    with pytest.raises(ValueError, match=">= 2 branches"):
        tblocks.ParallelAdd([tmodule.Sequential([])])


def test_parallel_add_with_empty_branch_is_residual_block():
    """ParallelAdd([main, Sequential([])]) equals ResidualBlock(main) from
    the same weights: the same output, exponent, input grad and main's
    grads (the identity branch has none), in both packages."""
    def main(layers, module):
        return module.Sequential([layers.NITIConv2D(8, 8, (3, 3), (1, 1), "SAME"),
                                  layers.NITIRelu()])

    x = rand_x((2, 5, 5, 8), seed=4)
    jmain = main(jlayers, jmodule)
    p_main = jmain.init(jax.random.PRNGKey(3))
    rb = fwd_bwd_both(jblocks.ResidualBlock(jmain), tblocks.ResidualBlock(main(tlayers, tmodule)),
                      x, 5, params=p_main)
    pa = fwd_bwd_both(jblocks.ParallelAdd([jmain, jmodule.Sequential([])]),
                      tblocks.ParallelAdd([main(tlayers, tmodule), tmodule.Sequential([])]),
                      x, 5, params=[p_main, []])
    for jax_out, port_out in (rb, pa):
        assert_same(jax_out, port_out)
    for got in pa:
        for a, b in zip(got[:3], rb[1][:3]):
            np.testing.assert_array_equal(a, b)
    assert_weights_equal(pa[1][3][0], rb[1][3])
    assert pa[1][3][1] == []


# (constructor, args, input shape): each Inception module alone at a small
# spatial size and its widths in the full network
MODULES = {
    "a": ("_inception_a", (192, 32), (2, 7, 7, 192)),
    "b": ("_inception_b", (288,), (1, 9, 9, 288)),
    "c": ("_inception_c", (768, 128), (1, 5, 5, 768)),
    "d": ("_inception_d", (768,), (1, 7, 7, 768)),
    "e": ("_inception_e", (1280,), (1, 3, 3, 1280)),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(MODULES))
def test_inception_module_byte_identical_to_jax(name, mode):
    ctor, args, shape = MODULES[name]
    jl = getattr(jinception, ctor)(*args)
    tl = getattr(tinception, ctor)(*args)
    jax_out, port_out = fwd_bwd_both(jl, tl, rand_x(shape, seed=6), 7, mode=mode, key=2)
    assert_same(jax_out, port_out)


def batches(batch, side, steps, n_logits, seed):
    rng = np.random.default_rng(seed)
    xs = [rng.integers(0, 256, (batch, side, side, 3)).astype(np.float32) for _ in range(steps)]
    ys = [rng.integers(0, 10, batch) for _ in range(steps)]
    ohs = [np.eye(n_logits, dtype=np.float32)[y] for y in ys]
    return xs, ohs, ys[0].astype(np.int64)


# name -> (JAX constructor, port constructor, batch, input side, train steps)
NETS = {
    "squeezenet": (lambda: jsqueezenet.squeezenet_niti(num_classes=10),
                   lambda: squeezenet_niti(num_classes=10), 2, 32, 2),
    "inceptionv3": (lambda: jinception.inceptionv3_niti(num_classes=10),
                    lambda: inceptionv3_niti(num_classes=10), 1, 75, 1),
}


@pytest.fixture(scope="module")
def jax_runs():
    """Per net: the start params, the batches, the JAX losses, the final
    params and the eval step's correct count."""
    runs = {}
    for name, (jbuild, _, batch, side, steps) in NETS.items():
        xs, ohs, labels = batches(batch, side, steps, 12, seed=len(name))
        model = jbuild()
        params = model.init(jax.random.PRNGKey(1))
        start = to_numpy(params)
        step = jax.jit(j_make_train_step(model))
        losses = []
        for x, oh in zip(xs, ohs):
            params, loss = step(params, jnp.asarray(x), jnp.asarray(oh))
            losses.append(float(loss))
        correct = int(jax.jit(j_make_eval_step(model))(params, jnp.asarray(xs[0]),
                                                      jnp.asarray(labels)))
        runs[name] = (start, (xs, ohs, labels), losses, to_numpy(params), correct)
    return runs


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(NETS))
def test_full_zoo_steps_byte_identical_to_jax(jax_runs, name, mode):
    """The full networks (SqueezeNet at 32x32, b2, two train steps;
    Inception-v3 at 75x75, b1, one train step) and an eval step."""
    start, (xs, ohs, labels), losses_j, final_j, correct_j = jax_runs[name]
    model = load_jax_params(NETS[name][1](), start)
    assert_weights_equal(export_jax_params(model), start)
    step = make_train_step(model)
    with tconv.use_fused_conv_mode(mode):
        losses = [float(step(torch.from_numpy(x), torch.from_numpy(oh)))
                  for x, oh in zip(xs, ohs)]
        correct = int(make_eval_step(model)(torch.from_numpy(xs[0]), torch.from_numpy(labels)))
    final = export_jax_params(model)
    assert_weights_equal(final, final_j)
    assert any(not np.array_equal(a, b) for a, b in zip(flat_weights(final), flat_weights(start)))
    np.testing.assert_allclose(losses, losses_j, rtol=1e-6, atol=0)
    assert correct == correct_j


ZOO = {"squeezenet": (jsqueezenet.squeezenet_niti, squeezenet_niti, 52),
       "inceptionv3": (jinception.inceptionv3_niti, inceptionv3_niti, 190)}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_checkpoint_keys_match_jax(name, tmp_path):
    """The checkpoint keys of the full networks (1000 classes) are the JAX
    package's tree paths (``[k]/[b]/[i]/['w']/.data`` in a parallel join),
    with its shapes and dtypes, and a checkpoint crosses both ways."""
    jbuild, tbuild, leaves = ZOO[name]
    jmodel, tmodel = jbuild(1000), tbuild(1000)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    want = {"/".join(str(p) for p in path): (v.shape, v.dtype)
            for path, v in jax.tree.flatten_with_path(shapes)[0]}
    tmodel.reset_parameters(torch.Generator().manual_seed(2))
    params = export_jax_params(tmodel)
    got = {k: (v.shape, v.dtype) for k, v in tcheckpoint.flatten_params(params).items()}
    assert list(got) == list(want)
    assert got == want and len(got) == leaves
    assert any("]/[1]/[0]/['w']/.data" in k for k in got)
    path = str(tmp_path / "ckpt.npz")
    tcheckpoint.save_checkpoint(path, params, step=3)
    jparams, step = jcheckpoint.load_checkpoint(path, jmodel.init(jax.random.PRNGKey(0)))
    assert step == 3
    assert_weights_equal(to_numpy(jparams), params)
    jcheckpoint.save_checkpoint(path, jparams, step=4)
    back, step = tcheckpoint.load_checkpoint(path, export_jax_params(tbuild(1000)))
    assert step == 4
    assert_weights_equal(back, params)


def _layout(model, blocks, module):
    out = []
    for layer in model.layers:
        if isinstance(layer, module.Sequential):
            out.append(("sequential", _layout(layer, blocks, module)))
        elif isinstance(layer, (blocks.ParallelConcat, blocks.ParallelAdd)):
            out.append((type(layer).__name__,
                        [_layout(b, blocks, module) for b in layer.branches]))
        else:
            out.append((type(layer).__name__,) + tuple(
                getattr(layer, a, None) for a in ("in_channels", "out_channels", "kernel",
                                                  "stride", "padding", "act", "out_bits",
                                                  "window", "pad")))
    return out


@pytest.mark.parametrize("name", sorted(ZOO))
def test_full_zoo_layout_matches_jax(name):
    """The full networks have the JAX package's layers, nesting, widths,
    kernels, strides, pads and pools."""
    jbuild, tbuild, _ = ZOO[name]
    assert _layout(tbuild(1000), tblocks, tmodule) == _layout(jbuild(1000), jblocks, jmodule)


def test_export_refuses_a_layer_it_does_not_know():
    class Unknown(tmodule.NITILayer):
        pass

    with pytest.raises(TypeError, match="Unknown"):
        export_jax_params(tmodule.Sequential([tlayers.NITIRelu(), Unknown()]))


def _load_chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name,batch,side", [("squeezenet", 128, 224), ("inceptionv3", 32, 299)])
def test_chip_smoke_zoo_k3_shapes_are_k3_cases(name, batch, side):
    """Under fused mode "all" every K3 call of a train and an eval step of
    the full network at chip_smoke.py's batch is a K3_CASES shape (which it
    checks and times), and the train step's counts are the ones it weights
    them by. Rehearsed on the meta device with its own recorder."""
    from mandheling_tpu_torch.ops.kernels import fused_conv_int8

    cs = _load_chip_smoke()
    model = ZOO[name][1](1000).to("meta")
    x = torch.zeros((batch, side, side, 3), device="meta")
    oh = torch.zeros((batch, 1000), dtype=torch.int32, device="meta")
    spec = {"K3": (fused_conv_int8, "conv_max", cs.k3_key)}
    with tconv.use_fused_conv_mode("all"):
        with cs.recording(spec) as train:
            make_train_step(model)(x, oh)
        with cs.recording(spec) as evals:
            make_eval_step(model, 1000)(x, torch.zeros(batch, dtype=torch.int64, device="meta"))
    assert set(train["K3"]) | set(evals["K3"]) <= cs.K3_KEYS
    want = cs.EXPECTED_PER_STEP[(name, batch, "all")]
    assert sum(train["K3"].values()) == want[0]["K3"]
    assert sum(evals["K3"].values()) == want[1]["K3"]


def test_squeezenet_at_224_gets_no_weight_update():
    """A behaviour of the JAX package that the port mirrors: SqueezeNet at
    224x224 ends in a 13x13 map, and the global pool's backward divides
    every int8 gy by 169, truncating it to 0 (the JAX GlobalAvgPool.bwd and
    the port's give the same zeros), so no weight grad is nonzero and a
    train step leaves the params as they were."""
    gy = np.random.default_rng(8).integers(-128, 128, (2, 1, 1, 1000), dtype=np.int8)
    gx_j, _ = jblocks.GlobalAvgPool().bwd((), (2, 13, 13, 1000), jnp.asarray(gy))
    gx_t, _ = tblocks.GlobalAvgPool().bwd((2, 13, 13, 1000), torch.from_numpy(gy))
    np.testing.assert_array_equal(gx_t.numpy(), np.asarray(gx_j))
    assert not gx_t.any()
    model = squeezenet_niti(num_classes=1000).reset_parameters(torch.Generator().manual_seed(0))
    start = flat_weights(export_jax_params(model))
    xs, ohs, _ = batches(1, 224, 1, 1000, seed=9)
    loss = float(make_train_step(model)(torch.from_numpy(xs[0]), torch.from_numpy(ohs[0])))
    assert np.isfinite(loss)
    for a, b in zip(flat_weights(export_jax_params(model)), start):
        np.testing.assert_array_equal(a, b)
