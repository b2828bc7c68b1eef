"""Caffe import in the port (utils/caffe_model.py) against the JAX
package's: `build_caffemodel` writes the JAX writer's bytes and the reader
parses them alike (in-place layers renamed); `niti_model_from_caffemodel`
builds the JAX importer's layer tree with byte-identical int8 weights and
exponents (BatchNorm + Scale folded, Eltwise-SUM residuals, channel Concat,
pools, InnerProduct with the feature permutation); 3 train steps after the
import of the CaffeImportTrain demo's net are byte-identical in both of the
port's backends and fused modes; the rejections raise as the JAX ones do."""

import numpy as np
import pytest

from mandheling_tpu.utils import caffe_model as jcm
from mandheling_tpu_torch.nn import blocks as tblocks
from mandheling_tpu_torch.utils import caffe_model as tcm
from test_torch_graph_import import (MODES, _one_torch_thread, assert_import_equal,  # noqa: F401
                                     assert_steps_equal, jax_steps, pixels, torch_steps)

F = np.float32


def _w(rng, o, i, k=3):
    return rng.normal(0, 0.2, (o, i, k, k)).astype(F)


def both(layers, shape):
    buf = tcm.build_caffemodel(layers, ["data"], [shape])
    assert buf == jcm.build_caffemodel(layers, ["data"], [shape])
    jm, jp = jcm.niti_model_from_caffemodel(buf)
    tm, tp = tcm.niti_model_from_caffemodel(buf, device="cpu")
    assert_import_equal(jm, jp, tm, tp)
    return jm, jp, tm


def _demo_net():
    """The CaffeImportTrain demo's net."""
    rng = np.random.default_rng(0)
    return [
        ("conv0", "Convolution", ["data"], ["c0"], {"num_output": 8, "kernel_size": 5, "pad": 2},
         [rng.normal(0, 0.2, (8, 1, 5, 5)).astype(F)]),
        ("relu0", "ReLU", ["c0"], ["c0"], {}, []),
        ("conv1", "Convolution", ["c0"], ["c1"], {"num_output": 8, "kernel_size": 3, "pad": 1},
         [rng.normal(0, 0.2, (8, 8, 3, 3)).astype(F)]),
        ("bn1", "BatchNorm", ["c1"], ["c1"], {"use_global_stats": 1},
         [np.zeros(8, F), np.ones(8, F), np.ones(1, F)]),
        ("sc1", "Scale", ["c1"], ["c1"], {"axis": 1}, [rng.uniform(0.5, 1.5, 8).astype(F)]),
        ("res", "Eltwise", ["c1", "c0"], ["r"], {"operation": 1}, []),
        ("relu1", "ReLU", ["r"], ["r"], {}, []),
        ("gap", "Pooling", ["r"], ["g"], {"pool": 1, "global_pooling": 1}, []),
        ("fc", "InnerProduct", ["g"], ["logits"], {"num_output": 12},
         [rng.normal(0, 0.1, (12, 8)).astype(F)]),
    ]


def test_reader_parses_the_writers_bytes_as_jax():
    buf = tcm.build_caffemodel(_demo_net(), ["data"], [[1, 1, 28, 28]])
    got, want = tcm.load_caffemodel(buf), jcm.load_caffemodel(buf)
    assert (got.inputs, got.input_shapes) == (want.inputs, want.input_shapes) == (
        ["data"], [[1, 1, 28, 28]])
    for a, b in zip(got.layers, want.layers):
        assert (a.name, a.type, a.bottom, a.top, a.params) == (b.name, b.type, b.bottom, b.top,
                                                                b.params)
        assert all(np.array_equal(x.data, y.data) for x, y in zip(a.blobs, b.blobs))
    relu = got.layers[1]
    assert relu.top[0] != relu.bottom[0] and got.layers[2].bottom == [relu.top[0]]


@pytest.fixture(scope="module")
def demo_steps():
    jm, jp, tm = both(_demo_net(), [1, 1, 28, 28])
    assert [type(l).__name__ for l in tm.layers] == [
        "NITIConv2D", "NITIRelu", "ResidualBlock", "NITIRelu", "GlobalAvgPool", "Flatten",
        "NITIConv2D", "SqueezeLogits"]
    x = pixels((16, 28, 28, 1), 1)
    oh = np.eye(12, dtype=np.int32)[np.random.default_rng(2).integers(0, 10, 16)]
    return jp, tm, x, oh, jax_steps(jm, jp, x, oh)


@pytest.mark.parametrize("backend,mode", MODES)
def test_imported_demo_net_trains_as_jax(demo_steps, backend, mode):
    jp, tm, x, oh, jrun = demo_steps
    assert_steps_equal(jrun, torch_steps(tm, x, oh, backend, mode), jp)


def test_lenet_net_pools_and_feature_permutation():
    rng = np.random.default_rng(13)
    _, _, tm = both([
        ("conv1", "Convolution", ["data"], ["c1"], {"num_output": 8, "kernel_size": 5},
         [_w(rng, 8, 1, 5)]),
        ("relu1", "ReLU", ["c1"], ["c1"], {}, []),
        ("pool1", "Pooling", ["c1"], ["p1"], {"pool": 0, "kernel_size": 2, "stride": 2}, []),
        ("conv2", "Convolution", ["p1"], ["c2"], {"num_output": 12, "kernel_size": 3,
                                                  "stride": 2}, [_w(rng, 12, 8)]),
        ("pool2", "Pooling", ["c2"], ["p2"], {"pool": 1, "kernel_size": 2, "stride": 2,
                                              "pad": 1}, []),
        ("fc", "InnerProduct", ["p2"], ["logits"], {"num_output": 12},
         [rng.normal(0, 0.1, (12, 12 * 4 * 4)).astype(F)]),
        ("prob", "Softmax", ["logits"], ["prob"], {}, []),
    ], [1, 1, 28, 28])
    assert [type(l).__name__ for l in tm.layers] == [
        "NITIConv2D", "NITIRelu", "NITIMaxPool", "NITIConv2D", "NITIAvgPool", "Flatten",
        "NITIConv2D", "SqueezeLogits"]


def test_bn_scale_fold_with_scale_factor_and_concat():
    rng = np.random.default_rng(14)
    var = rng.uniform(0.5, 2.0, 8).astype(F)
    _, _, tm = both([
        ("conv1", "Convolution", ["data"], ["c1"], {"num_output": 8, "kernel_size": 3, "pad": 1},
         [_w(rng, 8, 8)]),
        ("bn1", "BatchNorm", ["c1"], ["c1"], {"use_global_stats": 1},
         [rng.normal(0, 1, 8).astype(F) * 2, var * 2, np.asarray([2.0], F)]),
        ("sc1", "Scale", ["c1"], ["c1"], {"axis": 1, "bias_term": 1},
         [rng.uniform(0.5, 2.0, 8).astype(F), np.zeros(8, F)]),
        ("res", "Eltwise", ["c1", "data"], ["r"], {"operation": 1}, []),
        ("a", "Convolution", ["r"], ["a"], {"num_output": 4, "kernel_size": 1}, [_w(rng, 4, 8, 1)]),
        ("b", "Convolution", ["r"], ["b"], {"num_output": 4, "kernel_size": 1}, [_w(rng, 4, 8, 1)]),
        ("cat", "Concat", ["a", "b"], ["out"], {"axis": 1}, []),
    ], [1, 8, 8, 8])
    assert isinstance(tm.layers[0], tblocks.ResidualBlock)
    assert isinstance(tm.layers[1], tblocks.ParallelConcat)


def _conv_then(rng, extra, blobs=None):
    return [("conv1", "Convolution", ["data"], ["c1"], {"num_output": 4, "kernel_size": 3},
             blobs or [_w(rng, 4, 1)])] + extra


@pytest.mark.parametrize("case,match", [
    ("conv_bias", "non-zero conv bias"),
    ("scale_bias", "Scale bias"),
    ("global_max", "global max pooling"),
    ("padded_max", "padded max pool"),
    ("eltwise_prod", "Eltwise SUM"),
    ("lone_bn", "without a preceding Convolution"),
    ("unknown", "unsupported Caffe layer"),
])
def test_rejections_as_jax(case, match):
    rng = np.random.default_rng(15)
    layers = {
        "conv_bias": _conv_then(rng, [], [_w(rng, 4, 1), np.ones(4, F)]),
        "scale_bias": _conv_then(rng, [("s", "Scale", ["c1"], ["c1"], {"axis": 1, "bias_term": 1},
                                        [np.ones(4, F), np.ones(4, F)])]),
        "global_max": _conv_then(rng, [("g", "Pooling", ["c1"], ["g"],
                                        {"pool": 0, "global_pooling": 1}, [])]),
        "padded_max": _conv_then(rng, [("p", "Pooling", ["c1"], ["p"],
                                        {"pool": 0, "kernel_size": 2, "stride": 2, "pad": 1}, [])]),
        "eltwise_prod": [
            ("a", "Convolution", ["data"], ["a"], {"num_output": 1, "kernel_size": 1},
             [_w(rng, 1, 1, 1)]),
            ("e", "Eltwise", ["a", "data"], ["e"], {"operation": 0}, [])],
        "lone_bn": _conv_then(rng, [("r", "ReLU", ["c1"], ["r"], {}, []),
                                    ("bn", "BatchNorm", ["r"], ["o"], {},
                                     [np.zeros(4, F), np.ones(4, F), np.ones(1, F)])]),
        "unknown": _conv_then(rng, [("t", "TanH", ["c1"], ["t"], {}, [])]),
    }[case]
    buf = tcm.build_caffemodel(layers, ["data"], [[1, 1, 8, 8]])
    msgs = []
    for imp, kw in ((jcm.niti_model_from_caffemodel, {}),
                    (tcm.niti_model_from_caffemodel, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match) as err:
            imp(buf, **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
