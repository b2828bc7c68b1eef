"""ONNX in the port (utils/onnx_io.py with its vendored codec,
utils/onnx_model.py) against the JAX package's: the builders write the JAX
builders' bytes, the module stream and the fp32 adapters give the same
arrays, and `niti_model_from_onnx` builds the JAX importer's layer tree
with byte-identical int8 weights and exponents, linear chains and branching
graphs alike (residual Add, projection Add, Fire-style Concat, nesting,
staggered Adds, BatchNormalization folded into its conv); 3 train steps
after an import are byte-identical in both of the port's backends and
fused modes; the rejections raise as the JAX ones do."""

import numpy as np
import pytest
import torch

from mandheling_tpu.utils import onnx_io as jonnx
from mandheling_tpu.utils.convert import lenet_fp32_from_modules as j_lenet_from_modules
from mandheling_tpu.utils.onnx_model import niti_model_from_onnx as j_import
from mandheling_tpu_torch.models import LeNetFP32
from mandheling_tpu_torch.nn import blocks as tblocks
from mandheling_tpu_torch.nn.layers import NITIRelu, NITIRelu6
from mandheling_tpu_torch.utils import onnx_io as tonnx
from mandheling_tpu_torch.utils.convert import lenet_fp32_from_modules, lenet_fp32_from_torch
from mandheling_tpu_torch.utils.onnx_model import niti_model_from_onnx as t_import
from test_torch_graph_import import (MODES, _one_torch_thread, assert_import_equal,  # noqa: F401
                                     assert_steps_equal, assert_weights_equal, jax_steps, pixels,
                                     torch_steps)


def _w(rng, o, i, k=3):
    return rng.normal(0, 0.2, (o, i, k, k)).astype(np.float32)


def both(nodes, shape, output=None, input_shape=None):
    """Build the graph with each package's builder (the same bytes), import
    it with each importer (the same tree and weights)."""
    if output is None:
        jm_pb, tm_pb = (pkg.build_onnx_sequential(nodes, shape) for pkg in (jonnx, tonnx))
    else:
        jm_pb, tm_pb = (pkg.build_onnx_graph(nodes, shape, output=output)
                        for pkg in (jonnx, tonnx))
    assert tm_pb.SerializeToString() == jm_pb.SerializeToString()
    jm, jp = j_import(jm_pb, input_shape=input_shape)
    tm, tp = t_import(tm_pb, input_shape=input_shape, device="cpu")
    assert_import_equal(jm, jp, tm, tp)
    return jm, jp, tm


class TorchLeNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = torch.nn.Conv2d(1, 20, 5)
        self.conv2 = torch.nn.Conv2d(20, 50, 5)
        self.fc1 = torch.nn.Linear(800, 500)
        self.fc2 = torch.nn.Linear(500, 10)


def _lenet_ops(sd):
    sd = {k: v.detach().numpy() for k, v in sd.items()}
    return [
        ("Conv", {"w": sd["conv1.weight"], "b": sd["conv1.bias"]}),
        ("MaxPool", {"kernel": (2, 2), "strides": (2, 2)}),
        ("Conv", {"w": sd["conv2.weight"], "b": sd["conv2.bias"]}),
        ("MaxPool", {"kernel": (2, 2), "strides": (2, 2)}),
        ("Flatten", {}),
        ("Gemm", {"w": sd["fc1.weight"], "b": sd["fc1.bias"]}),
        ("Clip", {"min": 0.0, "max": 6.0}),
        ("Gemm", {"w": sd["fc2.weight"], "b": sd["fc2.bias"]}),
    ]


def test_lenet_file_modules_and_adapter_equal_jax(tmp_path):
    torch.manual_seed(0)
    sd = TorchLeNet().state_dict()
    tpath, jpath = str(tmp_path / "t.onnx"), str(tmp_path / "j.onnx")
    tonnx.build_onnx_sequential(_lenet_ops(sd), (1, 1, 28, 28), tpath)
    jonnx.build_onnx_sequential(_lenet_ops(sd), (1, 1, 28, 28), jpath)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    tmods, jmods = tonnx.modules_from_onnx(tpath), jonnx.modules_from_onnx(tpath)
    assert [k for k, _ in tmods] == [k for k, _ in jmods] == ["conv", "conv", "linear", "linear"]
    assert tmods[0][1]["meta"] == jmods[0][1]["meta"]
    got = lenet_fp32_from_modules(tmods)
    want = j_lenet_from_modules(jmods)
    for layer in ("conv1", "conv2", "ip1", "ip2"):
        assert_weights_equal([got[layer][k] for k in sorted(got[layer])],
                             [np.asarray(want[layer][k]) for k in sorted(want[layer])])
        # the same arrays as the torch-direct conversion
        direct = lenet_fp32_from_torch(sd)[layer]
        assert_weights_equal([got[layer][k] for k in sorted(got[layer])],
                             [direct[k] for k in sorted(direct)])
    # and the port's float LeNet computes the torch model's function
    x = np.random.default_rng(0).normal(0, 1, (4, 28, 28, 1)).astype(np.float32)
    tm = TorchLeNet()
    tm.load_state_dict(sd)
    with torch.no_grad():
        h = torch.nn.functional.max_pool2d(tm.conv1(torch.from_numpy(x).permute(0, 3, 1, 2)), 2)
        h = torch.nn.functional.max_pool2d(tm.conv2(h), 2).flatten(1)
        ref = tm.fc2(torch.clamp(tm.fc1(h), 0.0, 6.0))
        out = LeNetFP32().load_params(got)(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


def test_conv_attributes_round_trip(tmp_path):
    w = np.random.default_rng(1).normal(0, 1, (8, 1, 3, 3)).astype(np.float32)
    path = str(tmp_path / "dw.onnx")
    tonnx.build_onnx_sequential(
        [("Conv", {"w": w, "strides": (2, 2), "pads": (1, 1, 1, 1), "group": 8})],
        (1, 8, 16, 16), path)
    (kind, entry), = tonnx.modules_from_onnx(path)
    assert kind == "conv" and entry["meta"] == {"stride": (2, 2), "pads": (1, 1, 1, 1), "group": 8}
    assert np.array_equal(entry["w"], w.transpose(2, 3, 1, 0))
    # a file of the port's builder reads back in the JAX package and the reverse
    assert jonnx.load_onnx(path).SerializeToString() == tonnx.load_onnx(path).SerializeToString()


def _chain(rng):
    return [
        ("Conv", {"w": _w(rng, 8, 1, 5)}),
        ("Relu", {}),
        ("MaxPool", {"kernel": (2, 2), "strides": (2, 2)}),
        ("Conv", {"w": _w(rng, 12, 8)}),
        ("BatchNormalization", {"scale": rng.uniform(0.5, 2, 12).astype(np.float32),
                                "bias": np.zeros(12, np.float32),
                                "mean": np.zeros(12, np.float32),
                                "var": rng.uniform(0.5, 2, 12).astype(np.float32)}),
        ("Clip", {"min": 0.0, "max": 6.0}),
        ("MaxPool", {"kernel": (2, 2), "strides": (2, 2)}),
        ("Flatten", {}),
        ("Gemm", {"w": rng.normal(0, 0.1, (12, 300)).astype(np.float32)}),
    ]


@pytest.fixture(scope="module")
def chain_steps():
    jm, jp, tm = both(_chain(np.random.default_rng(0)), (1, 1, 28, 28))
    assert [type(l).__name__ for l in tm.layers] == [
        "NITIConv2D", "NITIRelu", "NITIMaxPool", "NITIConv2D", "NITIRelu6", "NITIMaxPool",
        "Flatten", "NITIConv2D", "SqueezeLogits"]
    x = pixels((16, 28, 28, 1), 1)
    oh = np.eye(12, dtype=np.int32)[np.random.default_rng(2).integers(0, 10, 16)]
    return jp, tm, x, oh, jax_steps(jm, jp, x, oh)


@pytest.mark.parametrize("backend,mode", MODES)
def test_imported_chain_trains_as_jax(chain_steps, backend, mode):
    jp, tm, x, oh, jrun = chain_steps
    assert_steps_equal(jrun, torch_steps(tm, x, oh, backend, mode), jp)


def test_gemm_after_flatten_takes_the_feature_permutation():
    rng = np.random.default_rng(3)
    both([("Conv", {"w": rng.normal(0, 0.3, (4, 1, 3, 3)).astype(np.float32)}),
          ("Flatten", {}), ("Gemm", {"w": rng.normal(0, 0.2, (5, 144)).astype(np.float32)})],
         (1, 1, 8, 8))


def test_clip_bounds_from_inputs_and_attributes():
    w = np.random.default_rng(0).normal(0, 0.2, (4, 1, 3, 3)).astype(np.float32)
    pb = tonnx.build_onnx_sequential([("Conv", {"w": w}), ("Clip", {"min": 0.0, "max": 6.0})],
                                     (1, 1, 8, 8))
    clip = [n for n in pb.graph.node if n.op_type == "Clip"][0]
    assert len(clip.input) == 3 and not clip.attribute
    assert any(isinstance(l, NITIRelu6) for l in t_import(pb, device="cpu")[0].layers)
    del clip.input[1:]
    a = clip.attribute.add(); a.name = "min"; a.f = 0.0; a.type = 1  # noqa: E702
    a = clip.attribute.add(); a.name = "max"; a.f = 6.0; a.type = 1  # noqa: E702
    assert any(isinstance(l, NITIRelu6) for l in t_import(pb, device="cpu")[0].layers)
    _, _, tm = both([("Conv", {"w": w}), ("Clip", {"min": 0.0, "max": 3.0})], (1, 1, 8, 8))
    assert any(isinstance(l, NITIRelu) for l in tm.layers)
    assert not any(isinstance(l, NITIRelu6) for l in tm.layers)


@pytest.mark.parametrize("ops,match", [
    ([("Conv", {"b": np.zeros(4, np.float32)})], "bias"),
    ([("Conv", {}), ("Flatten", {}), ("Gemm", {"b": np.zeros(4, np.float32)})], "bias"),
    ([("Conv", {}), ("BatchNormalization", {}), ("BatchNormalization", {})],
     "BatchNormalization without"),
    ([("Conv", {"group": 2})], "grouped conv"),
    ([("Conv", {}), ("Softsign", {})], "unsupported ONNX op"),
])
def test_rejections_as_jax(ops, match):
    rng = np.random.default_rng(0)
    c = 4
    spec = []
    for op, extra in ops:
        if op == "Conv":
            w = rng.normal(0, 0.2, (c, 2 if extra.get("group") else 1, 3, 3)).astype(np.float32)
            spec.append((op, {"w": w, **extra}))
        elif op == "Gemm":
            spec.append((op, {"w": rng.normal(0, 0.2, (4, 144)).astype(np.float32), **extra}))
        elif op == "BatchNormalization":
            spec.append((op, {k: np.ones(c, np.float32) for k in ("scale", "bias", "mean", "var")}))
        else:
            spec.append((op, extra))
    shape = (1, 4 if any(e.get("group") for _, e in ops) else 1, 8, 8)
    msgs = []
    for pkg, imp, kw in ((jonnx, j_import, {}), (tonnx, t_import, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match) as err:
            imp(pkg.build_onnx_sequential(spec, shape), **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------------------------ branching graphs


def test_residual_identity():
    rng = np.random.default_rng(7)
    _, _, tm = both([
        ("Conv", ["input"], ["t0"], {"w": _w(rng, 8, 3), "pads": (1, 1, 1, 1)}),
        ("Relu", ["t0"], ["t1"], {}),
        ("Conv", ["t1"], ["b0"], {"w": _w(rng, 8, 8), "pads": (1, 1, 1, 1)}),
        ("Relu", ["b0"], ["b1"], {}),
        ("Conv", ["b1"], ["b2"], {"w": _w(rng, 8, 8), "pads": (1, 1, 1, 1)}),
        ("Add", ["b2", "t1"], ["j"], {}),
        ("Relu", ["j"], ["out"], {}),
    ], (1, 3, 8, 8), output="out", input_shape=(1, 3, 8, 8))
    assert [type(l).__name__ for l in tm.layers] == [
        "NITIConv2D", "NITIRelu", "ResidualBlock", "NITIRelu", "SqueezeLogits"]


def test_projection_skip_and_fire_concat_and_nesting():
    rng = np.random.default_rng(8)
    _, _, tm = both([
        ("Conv", ["input"], ["m0"], {"w": _w(rng, 16, 8), "strides": (2, 2),
                                     "pads": (1, 1, 1, 1)}),
        ("Conv", ["input"], ["p0"], {"w": _w(rng, 16, 8, 1), "strides": (2, 2)}),
        ("Add", ["m0", "p0"], ["j"], {}),
        ("Relu", ["j"], ["s0"], {}),
        ("Conv", ["s0"], ["a0"], {"w": _w(rng, 6, 16, 1)}),
        ("Relu", ["a0"], ["a1"], {}),
        ("Conv", ["s0"], ["b0"], {"w": _w(rng, 6, 16), "pads": (1, 1, 1, 1)}),
        ("Relu", ["b0"], ["b1"], {}),
        ("Concat", ["a1", "b1"], ["cat"], {"axis": 1}),
        ("Conv", ["cat"], ["c"], {"w": _w(rng, 4, 12, 1)}),
        ("Conv", ["cat"], ["d"], {"w": _w(rng, 4, 12, 1)}),
        ("Concat", ["c", "d"], ["cat2"], {"axis": 1}),
        ("Conv", ["cat2"], ["m"], {"w": _w(rng, 8, 8, 1)}),
        ("Add", ["m", "cat2"], ["out"], {}),
    ], (1, 8, 8, 8), output="out", input_shape=(1, 8, 8, 8))
    kinds = [type(l).__name__ for l in tm.layers]
    assert kinds == ["ParallelAdd", "NITIRelu", "ParallelConcat", "ParallelConcat",
                     "ResidualBlock", "SqueezeLogits"]


def test_staggered_adds_nest_as_regions():
    w1 = _w(np.random.default_rng(9), 8, 8, 1)
    _, _, tm = both([
        ("Conv", ["input"], ["a"], {"w": w1}),
        ("Conv", ["input"], ["b"], {"w": w1}),
        ("Add", ["a", "input"], ["j1"], {}),
        ("Add", ["b", "j1"], ["out"], {}),
    ], (1, 8, 8, 8), output="out", input_shape=(1, 8, 8, 8))
    blk = tm.layers[0]
    assert isinstance(blk, tblocks.ParallelAdd)
    assert sorted(tuple(type(l).__name__ for l in br.layers) for br in blk.branches) == [
        ("NITIConv2D",), ("ResidualBlock",)]


def _resnet_style(rng):
    nodes = [("Conv", ["input"], ["t0"], {"w": _w(rng, 8, 3), "pads": (1, 1, 1, 1)}),
             ("Relu", ["t0"], ["r0"], {})]
    prev = "r0"
    for i, (cin, cout, s) in enumerate([(8, 8, 1), (8, 16, 2)]):
        nodes += [
            ("Conv", [prev], [f"b{i}_0"], {"w": _w(rng, cout, cin), "strides": (s, s),
                                           "pads": (1, 1, 1, 1)}),
            ("Relu", [f"b{i}_0"], [f"b{i}_1"], {}),
            ("Conv", [f"b{i}_1"], [f"b{i}_2"], {"w": _w(rng, cout, cout), "pads": (1, 1, 1, 1)}),
        ]
        if s == 1:
            nodes.append(("Add", [f"b{i}_2", prev], [f"j{i}"], {}))
        else:
            nodes.append(("Conv", [prev], [f"p{i}"], {"w": _w(rng, cout, cin, 1),
                                                     "strides": (s, s)}))
            nodes.append(("Add", [f"b{i}_2", f"p{i}"], [f"j{i}"], {}))
        nodes.append(("Relu", [f"j{i}"], [f"r{i + 1}"], {}))
        prev = f"r{i + 1}"
    nodes += [("GlobalAveragePool", [prev], ["gap"], {}),
              ("Conv", ["gap"], ["out"], {"w": _w(rng, 12, 16, 1)})]
    return nodes


@pytest.fixture(scope="module")
def resnet_steps():
    jm, jp, tm = both(_resnet_style(np.random.default_rng(10)), (1, 3, 16, 16), output="out",
                      input_shape=(1, 3, 16, 16))
    x = pixels((8, 16, 16, 3), 3)
    oh = np.eye(12, dtype=np.int32)[np.random.default_rng(4).integers(0, 10, 8)]
    return jp, tm, x, oh, jax_steps(jm, jp, x, oh)


@pytest.mark.parametrize("backend,mode", MODES)
def test_imported_resnet_style_trains_as_jax(resnet_steps, backend, mode):
    jp, tm, x, oh, jrun = resnet_steps
    assert_steps_equal(jrun, torch_steps(tm, x, oh, backend, mode), jp)


def test_average_pool_keeps_the_params_aligned():
    """The JAX importer appends no params entry for an AveragePool, so every
    later layer takes its neighbour's; the port appends one, and the conv
    after the pool keeps its weight."""
    rng = np.random.default_rng(11)
    w1, w2 = _w(rng, 8, 3), _w(rng, 12, 8, 1)
    nodes = [("Conv", ["input"], ["c"], {"w": w1, "pads": (1, 1, 1, 1)}),
             ("AveragePool", ["c"], ["p"], {"kernel": (2, 2)}),
             ("Conv", ["p"], ["out"], {"w": w2})]
    jm, jp = j_import(jonnx.build_onnx_graph(nodes, (1, 3, 8, 8), output="out"))
    tm, tp = t_import(tonnx.build_onnx_graph(nodes, (1, 3, 8, 8), output="out"), device="cpu")
    assert len(jp) == len(jm.layers) - 1  # the JAX fault
    assert len(tp) == len(tm.layers) and tp[1] == ()
    assert [type(l).__name__ for l in tm.layers] == [type(l).__name__ for l in jm.layers]
    assert tm.layers[1].window == (2, 2)
    # the weights are the JAX package's, in their layers
    assert_weights_equal([np.asarray(a) for a in jp[0]["w"]] + [np.asarray(a) for a in jp[1]["w"]],
                         [a.numpy() for a in tp[0]["w"]] + [a.numpy() for a in tp[2]["w"]])
