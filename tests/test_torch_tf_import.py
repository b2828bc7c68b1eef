"""TensorFlow frozen-graph import in the port (utils/tf_graphdef.py,
utils/tf_model.py) against the JAX package's: `build_graphdef` writes the
JAX writer's bytes and the reader parses them alike; `niti_model_from_graphdef`
builds the JAX importer's layer tree with byte-identical int8 weights and
exponents (FusedBatchNorm folded, a zero BiasAdd dropped, residual Add,
channel ConcatV2, depthwise); 3 train steps after the import of the
TfImportTrain demo's graph are byte-identical in both of the port's
backends and fused modes; the rejections raise as the JAX ones do."""

import numpy as np
import pytest

from mandheling_tpu.utils import tf_graphdef as JG
from mandheling_tpu.utils.tf_model import niti_model_from_graphdef as j_import
from mandheling_tpu_torch.nn import blocks as tblocks
from mandheling_tpu_torch.utils import tf_graphdef as G
from mandheling_tpu_torch.utils.tf_model import niti_model_from_graphdef as t_import
from test_torch_graph_import import (MODES, _one_torch_thread, assert_import_equal,  # noqa: F401
                                     assert_steps_equal, jax_steps, pixels, torch_steps)

F = np.float32
DT = ("dtype", G.DT_FLOAT)


def _const(name, arr, dtype=F):
    return (name, "Const", [], {"dtype": DT, "value": np.asarray(arr, dtype)})


def both(nodes, input_shape, output=None):
    buf = G.build_graphdef(nodes)
    assert buf == JG.build_graphdef(nodes)
    jm, jp = j_import(buf, input_shape=input_shape, output=output)
    tm, tp = t_import(buf, input_shape=input_shape, output=output, device="cpu")
    assert_import_equal(jm, jp, tm, tp)
    return jm, jp, tm


def _demo_graph():
    """The TfImportTrain demo's graph: conv, relu, a residual conv, global
    mean, reshape and the logits MatMul."""
    rng = np.random.default_rng(0)
    return [
        ("input", "Placeholder", [], {"dtype": DT}),
        _const("w0", rng.normal(0, 0.2, (5, 5, 1, 8))),
        ("conv0", "Conv2D", ["input", "w0"], {"strides": [1, 1, 1, 1], "padding": "SAME"}),
        ("relu0", "Relu", ["conv0"], {}),
        _const("w1", rng.normal(0, 0.2, (3, 3, 8, 8))),
        ("conv1", "Conv2D", ["relu0", "w1"], {"strides": [1, 1, 1, 1], "padding": "SAME"}),
        ("res", "AddV2", ["conv1", "relu0"], {}),
        ("relu1", "Relu", ["res"], {}),
        _const("axes", [1, 2], np.int32),
        ("gap", "Mean", ["relu1", "axes"], {"keep_dims": True}),
        _const("shape", [-1, 8], np.int32),
        ("flat", "Reshape", ["gap", "shape"], {}),
        _const("wf", rng.normal(0, 0.1, (8, 12))),
        ("logits", "MatMul", ["flat", "wf"], {"transpose_b": False}),
    ]


def test_reader_parses_the_writers_bytes_as_jax():
    buf = G.build_graphdef(_demo_graph())
    got, want = G.load_graphdef(buf), JG.load_graphdef(buf)
    assert [(n.name, n.op, n.input) for n in got.node] == \
        [(n.name, n.op, n.input) for n in want.node]
    w0 = next(n for n in got.node if n.name == "w0").attr["value"]
    assert np.array_equal(w0.data, next(n for n in want.node if n.name == "w0").attr["value"].data)


@pytest.fixture(scope="module")
def demo_steps():
    jm, jp, tm = both(_demo_graph(), (1, 28, 28, 1))
    assert [type(l).__name__ for l in tm.layers] == [
        "NITIConv2D", "NITIRelu", "ResidualBlock", "NITIRelu", "GlobalAvgPool", "Flatten",
        "NITIConv2D", "SqueezeLogits"]
    x = pixels((16, 28, 28, 1), 1)
    oh = np.eye(12, dtype=np.int32)[np.random.default_rng(2).integers(0, 10, 16)]
    return jp, tm, x, oh, jax_steps(jm, jp, x, oh)


@pytest.mark.parametrize("backend,mode", MODES)
def test_imported_demo_graph_trains_as_jax(demo_steps, backend, mode):
    jp, tm, x, oh, jrun = demo_steps
    assert_steps_equal(jrun, torch_steps(tm, x, oh, backend, mode), jp)


def test_lenet_graph_with_pools():
    rng = np.random.default_rng(11)
    _, _, tm = both([
        ("input", "Placeholder", [], {"dtype": DT}),
        _const("w1", rng.normal(0, 0.2, (5, 5, 1, 8))),
        ("conv1", "Conv2D", ["input", "w1"], {"strides": [1, 1, 1, 1], "padding": "VALID"}),
        ("relu1", "Relu6", ["conv1"], {}),
        ("pool1", "MaxPool", ["relu1"], {"ksize": [1, 2, 2, 1], "strides": [1, 2, 2, 1],
                                         "padding": "VALID"}),
        _const("w2", rng.normal(0, 0.2, (3, 3, 8, 12))),
        ("conv2", "Conv2D", ["pool1", "w2"], {"strides": [1, 2, 2, 1], "padding": "VALID"}),
        ("pool2", "AvgPool", ["conv2", ], {"ksize": [1, 2, 2, 1], "strides": [1, 2, 2, 1],
                                           "padding": "VALID"}),
        _const("shape", [-1, 48], np.int32),
        ("flat", "Reshape", ["pool2", "shape"], {}),
        _const("wf", rng.normal(0, 0.1, (12, 48))),
        ("logits", "MatMul", ["flat", "wf"], {"transpose_b": True}),
        ("prob", "Softmax", ["logits"], {}),
    ], (1, 28, 28, 1))
    assert [type(l).__name__ for l in tm.layers] == [
        "NITIConv2D", "NITIRelu6", "NITIMaxPool", "NITIConv2D", "NITIAvgPool", "Flatten",
        "NITIConv2D", "SqueezeLogits"]


def test_bn_fold_bias_drop_residual():
    rng = np.random.default_rng(12)
    nodes = [
        ("input", "Placeholder", [], {"dtype": DT}),
        _const("w1", rng.normal(0, 0.2, (3, 3, 8, 8))),
        ("conv1", "Conv2D", ["input", "w1"], {"strides": [1, 1, 1, 1], "padding": "SAME"}),
        _const("bias", np.zeros(8)),
        ("badd", "BiasAdd", ["conv1", "bias"], {}),
        _const("scale", rng.uniform(0.5, 2.0, 8)),
        _const("offset", np.zeros(8)),
        _const("mean", np.zeros(8)),
        _const("var", rng.uniform(0.5, 2.0, 8)),
        ("bn", "FusedBatchNormV3", ["badd", "scale", "offset", "mean", "var"],
         {"epsilon": 0.001}),
        ("join", "AddV2", ["bn", "input"], {}),
        ("out", "Relu", ["join"], {}),
    ]
    _, _, tm = both(nodes, (1, 8, 8, 8))
    assert isinstance(tm.layers[0], tblocks.ResidualBlock)


def test_concat_and_depthwise():
    rng = np.random.default_rng(13)
    _, _, tm = both([
        ("input", "Placeholder", [], {"dtype": DT}),
        _const("wdw", rng.normal(0, 0.3, (3, 3, 8, 1))),
        ("dw", "DepthwiseConv2dNative", ["input", "wdw"],
         {"strides": [1, 1, 1, 1], "padding": "SAME"}),
        _const("wa", rng.normal(0, 0.3, (1, 1, 8, 4))),
        ("a", "Conv2D", ["dw", "wa"], {"strides": [1, 1, 1, 1], "padding": "VALID"}),
        _const("wb", rng.normal(0, 0.3, (1, 1, 8, 4))),
        ("b", "Conv2D", ["dw", "wb"], {"strides": [1, 1, 1, 1], "padding": "VALID"}),
        _const("axis", [3], np.int32),
        ("cat", "ConcatV2", ["a", "b", "axis"], {}),
    ], (1, 8, 8, 8))
    assert [type(l).__name__ for l in tm.layers][:2] == ["NITIDepthwiseConv2D", "ParallelConcat"]


def _conv(extra_nodes, wshape=(3, 3, 4, 4), op="Conv2D", attrs=None):
    rng = np.random.default_rng(14)
    return [("input", "Placeholder", [], {"dtype": DT}),
            _const("w", rng.normal(0, 0.2, wshape)),
            ("c", op, ["input", "w"], {"strides": [1, 1, 1, 1], "padding": "SAME",
                                       **(attrs or {})})] + extra_nodes


@pytest.mark.parametrize("nodes,match", [
    (_conv([_const("b", np.ones(4)), ("o", "BiasAdd", ["c", "b"], {})]), "non-zero BiasAdd"),
    (_conv([], wshape=(3, 3, 4, 2), op="DepthwiseConv2dNative"), "depth multiplier"),
    (_conv([("o", "MaxPool", ["c"], {"ksize": [1, 2, 2, 1], "strides": [1, 2, 2, 1],
                                     "padding": "SAME"})]), "SAME padding"),
    (_conv([_const("ax", [3], np.int32), ("o", "Mean", ["c", "ax"], {})]), "spatial axes"),
    (_conv([("o", "Tanh", ["c"], {})]), "unsupported TF op"),
])
def test_rejections_as_jax(nodes, match):
    buf = G.build_graphdef(nodes)
    msgs = []
    for imp, kw in ((j_import, {}), (t_import, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match) as err:
            imp(buf, input_shape=(1, 8, 8, 4), **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_needs_an_input_shape_and_one_sink():
    buf = G.build_graphdef(_demo_graph())
    with pytest.raises(ValueError, match="input_shape"):
        t_import(buf, device="cpu")
    extra = G.build_graphdef(_demo_graph() + [("side", "Relu", ["relu0"], {})])
    with pytest.raises(ValueError, match="ambiguous"):
        t_import(extra, input_shape=(1, 28, 28, 1), device="cpu")
    tm, _ = t_import(extra, input_shape=(1, 28, 28, 1), output="logits", device="cpu")
    jm, _ = j_import(extra, input_shape=(1, 28, 28, 1), output="logits")
    assert [type(l).__name__ for l in tm.layers] == [type(l).__name__ for l in jm.layers]
