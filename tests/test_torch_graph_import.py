"""The port's region walker (utils/graph_import.py) and what the importers
share: an imported model comes back on the device asked for, with its
params the weight buffers themselves in the JAX layout; the walker builds
the JAX package's tree (ResidualBlock, ParallelAdd, ParallelConcat, nested)
and refuses what it refuses.

Also the helpers of the importer tests (tests/test_torch_{tflite,onnx,
tf_import,caffe_import,import_cli}.py): the layer tree of either package's
model, byte-equality of the params, and N train steps of an imported model
in both packages from the same weights and batch."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mandheling_tpu.train import make_train_step as j_make_train_step
from mandheling_tpu.utils import onnx_io as jonnx
from mandheling_tpu.utils.onnx_model import niti_model_from_onnx as j_from_onnx
from mandheling_tpu_torch.nn.blocks import ParallelAdd, ResidualBlock
from mandheling_tpu_torch.ops.conv import use_fused_conv_mode
from mandheling_tpu_torch.ops.kernels import use_backend
from mandheling_tpu_torch.train import make_train_step
from mandheling_tpu_torch.utils import onnx_io as tonnx
from mandheling_tpu_torch.utils.graph_import import finish_model, live_params
from mandheling_tpu_torch.utils.jax_params import export_jax_params, flat_weights
from mandheling_tpu_torch.utils.onnx_model import niti_model_from_onnx as t_from_onnx

# the port's backends and fused modes a train comparison runs under
MODES = [("cuda", "matmul_only"), ("cuda", "all"), ("torch", "matmul_only"), ("torch", "all")]
_ATTRS = ("in_channels", "out_channels", "channels", "kernel", "stride", "padding", "act",
          "per_channel", "out_bits", "window", "pad")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test runners share the machine's cores among
    several processes, where torch's spinning thread pool slows tiny ops by
    orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def layer_tree(model):
    """(type name, hyper-parameters, children) of every layer of either
    package's model, recursing into blocks."""
    out = []
    for layer in model.layers:
        attrs = {k: getattr(layer, k) for k in _ATTRS if hasattr(layer, k)}
        if hasattr(layer, "branches"):
            kids = [layer_tree(b) for b in layer.branches]
        elif hasattr(layer, "proj"):
            kids = [layer_tree(layer.branch), layer_tree(type(layer.branch)([layer.proj]))]
        elif hasattr(layer, "branch"):
            kids = [layer_tree(layer.branch)]
        elif hasattr(layer, "layers"):
            kids = [layer_tree(layer)]
        else:
            kids = []
        out.append((type(layer).__name__, attrs, kids))
    return out


def assert_weights_equal(a, b):
    """Two lists of weight arrays (flat_weights) byte for byte, dtypes too."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def assert_import_equal(jmodel, jparams, tmodel, tparams, device="cpu"):
    """The port's import equals the JAX package's: the layer tree, and the
    int8 weights and exponents byte for byte; the port's params are the
    model's weight buffers, on `device`."""
    assert layer_tree(tmodel) == layer_tree(jmodel)
    assert_weights_equal(flat_weights(jparams), flat_weights(export_jax_params(tmodel)))
    live = [t for t in jax.tree.leaves(tparams) if isinstance(t, torch.Tensor)]
    assert len(live) == len(flat_weights(jparams))
    assert all(t.device.type == device for t in live)
    buffers = {t.data_ptr() for t in tmodel.buffers()}
    assert all(t.data_ptr() in buffers for t in live)


def pixels(shape, seed):
    """Integer pixel values as float32 (the loader's batches): both
    packages' quantize_batch sum them exactly."""
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.float32)


def jax_steps(jmodel, jparams, x, oh, steps=3):
    """`steps` jitted JAX train steps on one batch -> (params, losses)."""
    step = jax.jit(j_make_train_step(jmodel))
    losses = []
    for _ in range(steps):
        jparams, loss = step(jparams, jnp.asarray(x), jnp.asarray(oh))
        losses.append(float(loss))
    return jparams, losses


def torch_steps(tmodel, x, oh, backend, mode, steps=3):
    """The same steps in the port, on a copy of the imported model."""
    model = copy.deepcopy(tmodel)
    step = make_train_step(model)
    with use_backend(backend), use_fused_conv_mode(mode):
        losses = [float(step(torch.from_numpy(x), torch.from_numpy(oh))) for _ in range(steps)]
    return model, losses


def assert_steps_equal(jrun, trun, start):
    """Byte-identical params after the steps (which moved them from
    `start`), losses within 1e-6 relative."""
    (jp, jl), (tm, tl) = jrun, trun
    got = flat_weights(export_jax_params(tm))
    assert_weights_equal(flat_weights(jp), got)
    assert any(not np.array_equal(a, b) for a, b in zip(got, flat_weights(start)))
    np.testing.assert_allclose(tl, jl, rtol=1e-6)


# ---------------------------------------------------------------- the walker


def _resnet_graph(rng):
    w = lambda o, i, k=3: rng.normal(0, 0.2, (o, i, k, k)).astype(np.float32)  # noqa: E731
    return [
        ("Conv", ["input"], ["t0"], {"w": w(8, 3), "pads": (1, 1, 1, 1)}),
        ("Relu", ["t0"], ["r0"], {}),
        ("Conv", ["r0"], ["b0"], {"w": w(8, 8), "pads": (1, 1, 1, 1)}),
        ("Relu", ["b0"], ["b1"], {}),
        ("Conv", ["b1"], ["b2"], {"w": w(8, 8), "pads": (1, 1, 1, 1)}),
        ("Add", ["b2", "r0"], ["j0"], {}),
        ("Relu", ["j0"], ["r1"], {}),
        ("Conv", ["r1"], ["m0"], {"w": w(16, 8), "strides": (2, 2), "pads": (1, 1, 1, 1)}),
        ("Conv", ["r1"], ["p0"], {"w": w(16, 8, 1), "strides": (2, 2)}),
        ("Add", ["m0", "p0"], ["j1"], {}),
        ("Relu", ["j1"], ["r2"], {}),
        ("Conv", ["r2"], ["a"], {"w": w(4, 16, 1)}),
        ("Conv", ["r2"], ["b"], {"w": w(4, 16, 1)}),
        ("Concat", ["a", "b"], ["cat"], {"axis": 1}),
        ("GlobalAveragePool", ["cat"], ["gap"], {}),
        ("Conv", ["gap"], ["out"], {"w": w(12, 8, 1)}),
    ]


def test_walker_builds_the_jax_tree_and_params_alias_the_buffers():
    nodes = _resnet_graph(np.random.default_rng(0))
    jm, jp = j_from_onnx(jonnx.build_onnx_graph(nodes, (1, 3, 16, 16), output="out"))
    tm, tp = t_from_onnx(tonnx.build_onnx_graph(nodes, (1, 3, 16, 16), output="out"),
                         device="cpu")
    assert [type(l).__name__ for l in tm.layers] == [
        "NITIConv2D", "NITIRelu", "ResidualBlock", "NITIRelu", "ParallelAdd", "NITIRelu",
        "ParallelConcat", "GlobalAvgPool", "NITIConv2D", "SqueezeLogits"]
    assert_import_equal(jm, jp, tm, tp)
    # the params follow the model: a write to a buffer shows in them
    tm.layers[0].w.add_(1)
    assert np.array_equal(np.asarray(tp[0]["w"].data), tm.layers[0].w.numpy())


@pytest.mark.parametrize("backend,mode", MODES)
def test_walked_tree_trains_as_the_jax_one(backend, mode):
    nodes = _resnet_graph(np.random.default_rng(1))
    jm, jp = j_from_onnx(jonnx.build_onnx_graph(nodes, (1, 3, 16, 16), output="out"))
    tm, _ = t_from_onnx(tonnx.build_onnx_graph(nodes, (1, 3, 16, 16), output="out"),
                        device="cpu")
    x = pixels((4, 16, 16, 3), 2)
    oh = np.eye(12, dtype=np.int32)[np.random.default_rng(3).integers(0, 10, 4)]
    assert_steps_equal(jax_steps(jm, jp, x, oh), torch_steps(tm, x, oh, backend, mode), jp)


def test_live_params_layout_matches_export():
    nodes = _resnet_graph(np.random.default_rng(4))
    tm, _ = t_from_onnx(tonnx.build_onnx_graph(nodes, (1, 3, 16, 16), output="out"),
                        device="cpu")
    live = live_params(tm)
    assert isinstance(live[2], list) and isinstance(live[4], list) and len(live[4]) == 2
    assert_weights_equal(flat_weights(live), flat_weights(export_jax_params(tm)))


def test_finish_model_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        finish_model([], [])


def test_walker_refusals_match_jax():
    """A join whose input does not derive from the fan-out tensor, and a
    join that is neither Add nor Concat, raise in both packages alike."""
    w1 = np.random.default_rng(5).normal(0, 0.2, (8, 8, 1, 1)).astype(np.float32)
    dangling = [
        ("Conv", ["input"], ["a"], {"w": w1}),
        ("Conv", ["input"], ["b"], {"w": w1}),
        ("Add", ["a", "other"], ["j"], {}),
        ("Add", ["b", "j"], ["out"], {}),
    ]
    product = [
        ("Conv", ["input"], ["a"], {"w": w1}),
        ("Conv", ["input"], ["b"], {"w": w1}),
        ("Mul", ["a", "b"], ["out"], {}),
    ]
    for nodes, match in ((dangling, "no path"), (product, "unsupported join")):
        msgs = []
        for build, imp, kwargs in ((jonnx.build_onnx_graph, j_from_onnx, {}),
                                   (tonnx.build_onnx_graph, t_from_onnx, {"device": "cpu"})):
            with pytest.raises(ValueError, match=match) as err:
                imp(build(nodes, (1, 8, 8, 8), output="out"), input_shape=(1, 8, 8, 8),
                    **kwargs)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


def test_blocks_are_the_ports():
    nodes = _resnet_graph(np.random.default_rng(6))
    tm, _ = t_from_onnx(tonnx.build_onnx_graph(nodes, (1, 3, 16, 16), output="out"),
                        device="cpu")
    assert isinstance(tm.layers[2], ResidualBlock) and isinstance(tm.layers[4], ParallelAdd)
    assert isinstance(tm, torch.nn.Module)
