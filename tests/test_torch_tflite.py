"""TFLite import and export in the port (utils/flatbuf.py, tflite_io.py,
tflite_model.py) against the JAX package's: the exporter writes the JAX
exporter's bytes from the same weights, the importer builds the JAX
importer's layer tree with byte-identical int8 weights and exponents from
the same file, and 3 train steps after the import are byte-identical in
both of the port's backends and fused modes. Full-width ResNet-18 and
MobileNetV2 round-trip through both packages (params only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mandheling_tpu.models import lenet_niti as j_lenet
from mandheling_tpu.models import mobilenet_v2_niti as j_mnv2
from mandheling_tpu.models import resnet18_niti as j_resnet18
from mandheling_tpu.models.resnet import ProjectedResidualBlock as JProjected
from mandheling_tpu.nn import blocks as jblocks
from mandheling_tpu.nn import layers as jlayers
from mandheling_tpu.nn.module import Sequential as JSequential
from mandheling_tpu.ops.qtensor import QTensor as JQTensor
from mandheling_tpu.utils import tflite_io as JT
from mandheling_tpu.utils import tflite_model as jtm
from mandheling_tpu_torch.models import lenet_niti, mobilenet_v2_niti, resnet18_niti
from mandheling_tpu_torch.nn import blocks as tblocks
from mandheling_tpu_torch.nn import layers as tlayers
from mandheling_tpu_torch.nn.module import Sequential
from mandheling_tpu_torch.ops.qtensor import QTensor
from mandheling_tpu_torch.utils import tflite_io as T
from mandheling_tpu_torch.utils import tflite_model as ttm
from mandheling_tpu_torch.utils.jax_params import export_jax_params, flat_weights, load_jax_params
from test_torch_graph_import import (MODES, _one_torch_thread, assert_import_equal,  # noqa: F401
                                     assert_steps_equal, assert_weights_equal, jax_steps, pixels,
                                     torch_steps)


def to_jax(params):
    """The port's JAX-layout numpy params as the JAX package's QTensors."""
    if isinstance(params, list):
        return [to_jax(p) for p in params]
    if isinstance(params, dict):
        return {k: (JQTensor(*(jnp.asarray(a) for a in v)) if k == "w" else to_jax(v))
                for k, v in params.items()}
    return params


def both_imports(buf):
    jm, jp = jtm.niti_model_from_tflite(buf)
    tm, tp = ttm.niti_model_from_tflite(buf, device="cpu")
    assert_import_equal(jm, jp, tm, tp)
    return (jm, jp), (tm, tp)


@pytest.fixture(scope="module")
def lenet():
    """LeNet-NITI drawn by the JAX package, carried into the port; both
    exports at batch 2."""
    jm = j_lenet()
    jp = jm.init(jax.random.PRNGKey(3))
    tm = load_jax_params(lenet_niti(), jp)
    jbuf = jtm.tflite_from_sequential(jm, jp, (2, 28, 28, 1))
    tbuf = ttm.tflite_from_sequential(tm, None, (2, 28, 28, 1))
    return jm, jp, tm, jbuf, tbuf


def test_export_is_the_jax_exporters_bytes(lenet):
    jm, jp, tm, jbuf, tbuf = lenet
    assert tbuf == jbuf
    # the params argument, as QTensors of the model's buffers or numpy pairs
    assert ttm.tflite_from_sequential(tm, export_jax_params(tm), (2, 28, 28, 1)) == jbuf
    m = T.load_tflite(tbuf)
    names = [op.name for op in m.ops]
    assert names.count("CONV_2D") == 2 and names.count("FULLY_CONNECTED") == 2
    assert m.tensors[m.inputs[0]].shape == [2, 28, 28, 1]
    w = m.tensors[next(op for op in m.ops if op.name == "CONV_2D").inputs[1]]
    assert w.shape == [20, 5, 5, 1] and w.data.dtype == np.float32


def test_import_equals_jax_and_round_trips_the_forward(lenet):
    jm, jp, tm, jbuf, _ = lenet
    _, (tm2, _) = both_imports(jbuf)
    # the NITI initializer scales max|data| to 127: the re-quantization is
    # the identity, so the imported weights are the source's
    assert_weights_equal(flat_weights(jp), flat_weights(export_jax_params(tm2)))
    x = QTensor(torch.from_numpy(np.random.default_rng(0).integers(-64, 64, (2, 28, 28, 1))
                                 .astype(np.int8)), torch.tensor(-5, dtype=torch.int32))
    y1, _ = tm.fwd(x)
    y2, _ = tm2.fwd(x)
    assert torch.equal(y1.data, y2.data) and int(y1.exp) == int(y2.exp)


def test_modules_cursor_equals_jax(lenet):
    _, _, _, jbuf, _ = lenet
    jmods, tmods = jtm.modules_from_tflite(jbuf), ttm.modules_from_tflite(jbuf)
    assert [k for k, _ in tmods] == [k for k, _ in jmods] == ["conv", "conv", "linear", "linear"]
    for (_, a), (_, b) in zip(jmods, tmods):
        assert sorted(a) == sorted(b)
        assert_weights_equal([a[k] for k in sorted(a)], [b[k] for k in sorted(b)])


def test_quantized_weights_dequantize_as_jax():
    for kw in (dict(scale=[0.5], zero_point=[2]),
               dict(scale=[0.5, 0.25], zero_point=[0, 0], quantized_dimension=0)):
        data = np.array([[10, -20], [30, 40]], np.int8)
        got = T.TFLTensor(shape=[2, 2], dtype=9, data=data, **kw).dequantized()
        want = JT.TFLTensor(shape=[2, 2], dtype=9, data=data, **kw).dequantized()
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _bias_graph(io):
    w = io.TFLiteWriter()
    inp = w.tensor((1, 8, 8, 3), name="in")
    wt = w.const(np.ones((4, 3, 3, 3), np.float32))
    bias = w.const(np.ones((4,), np.float32))
    out = w.tensor((1, 6, 6, 4))
    w.op(io.CONV_2D, [inp, wt, bias], [out], io.OPT_CONV2D,
         {"padding": io.PAD_VALID, "stride": (1, 1)})
    return w.finish([inp], [out])


def test_rejections_and_branching_as_jax():
    assert _bias_graph(T) == _bias_graph(JT)
    msgs = []
    for imp, kw in ((jtm.niti_model_from_tflite, {}),
                    (ttm.niti_model_from_tflite, {"device": "cpu"})):
        with pytest.raises(ValueError, match="bias") as err:
            imp(_bias_graph(T), **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    # an ADD with a fused activation is refused alike
    w = T.TFLiteWriter()
    inp = w.tensor((1, 8, 8, 3), name="in")
    o1, o2, o3 = (w.tensor((1, 8, 8, 3)) for _ in range(3))
    w.op(T.RELU, [inp], [o1])
    w.op(T.RELU, [inp], [o2])
    w.op(T.ADD, [o1, o2], [o3], T.OPT_ADD, {"fused_activation": T.ACT_RELU})
    buf = w.finish([inp], [o3])
    with pytest.raises(ValueError, match="fused activation on ADD"):
        ttm.niti_model_from_tflite(buf, device="cpu")
    with pytest.raises(ValueError, match="fused activation on ADD"):
        jtm.niti_model_from_tflite(buf)
    # relu(x) + relu(x) imports as a ParallelAdd
    w = T.TFLiteWriter()
    inp = w.tensor((1, 8, 8, 3), name="in")
    o1, o2, o3 = (w.tensor((1, 8, 8, 3)) for _ in range(3))
    w.op(T.RELU, [inp], [o1])
    w.op(T.RELU, [inp], [o2])
    w.op(T.ADD, [o1, o2], [o3], T.OPT_ADD, {})
    (_, _), (tm, _) = both_imports(w.finish([inp], [o3]))
    assert isinstance(tm.layers[0], tblocks.ParallelAdd)


def _fire(io, rng):
    """SqueezeNet Fire: squeeze 1x1 -> [expand 1x1, expand 3x3] -> concat,
    then a 1x1 classifier on a global pool."""
    w = io.TFLiteWriter()
    inp = w.tensor((1, 8, 8, 8), name="in")
    wsq = w.const(rng.normal(0, 0.3, (4, 1, 1, 8)).astype(np.float32))
    sq = w.tensor((1, 8, 8, 4))
    w.op(io.CONV_2D, [inp, wsq, -1], [sq], io.OPT_CONV2D,
         {"padding": io.PAD_VALID, "stride": (1, 1), "fused_activation": io.ACT_RELU})
    we1 = w.const(rng.normal(0, 0.3, (6, 1, 1, 4)).astype(np.float32))
    e1 = w.tensor((1, 8, 8, 6))
    w.op(io.CONV_2D, [sq, we1, -1], [e1], io.OPT_CONV2D, {"padding": io.PAD_VALID, "stride": (1, 1)})
    we3 = w.const(rng.normal(0, 0.3, (6, 3, 3, 4)).astype(np.float32))
    e3 = w.tensor((1, 8, 8, 6))
    w.op(io.CONV_2D, [sq, we3, -1], [e3], io.OPT_CONV2D, {"padding": io.PAD_SAME, "stride": (1, 1)})
    cat = w.tensor((1, 8, 8, 12))
    w.op(io.CONCATENATION, [e1, e3], [cat], io.OPT_CONCAT, {"axis": 3})
    axes = w.const(np.asarray([1, 2], np.int32))
    gap = w.tensor((1, 1, 1, 12))
    w.op(io.MEAN, [cat, axes], [gap], io.OPT_REDUCER, {"keep_dims": True})
    wfc = w.const(rng.normal(0, 0.3, (12, 12)).astype(np.float32))
    out = w.tensor((1, 12))
    w.op(io.FULLY_CONNECTED, [gap, wfc, -1], [out], io.OPT_FULLY_CONNECTED, {})
    return w.finish([inp], [out])


@pytest.fixture(scope="module")
def fire():
    buf = _fire(T, np.random.default_rng(5))
    assert buf == _fire(JT, np.random.default_rng(5))
    (jm, jp), (tm, _) = both_imports(buf)
    x = pixels((8, 8, 8, 8), 0)
    oh = np.eye(12, dtype=np.int32)[np.random.default_rng(0).integers(0, 10, 8)]
    return jm, jp, tm, x, oh, jax_steps(jm, jp, x, oh)


@pytest.mark.parametrize("backend,mode", MODES)
def test_fire_concat_import_trains_as_jax(fire, backend, mode):
    jm, jp, tm, x, oh, jrun = fire
    assert any(isinstance(l, tblocks.ParallelConcat) for l in tm.layers)
    assert_steps_equal(jrun, torch_steps(tm, x, oh, backend, mode), jp)


@pytest.fixture(scope="module")
def lenet_steps(lenet):
    _, _, _, jbuf, _ = lenet
    (jm, jp), (tm, _) = both_imports(jbuf)
    x = pixels((16, 28, 28, 1), 1)
    oh = np.eye(12, dtype=np.int32)[np.random.default_rng(1).integers(0, 10, 16)]
    return jp, tm, x, oh, jax_steps(jm, jp, x, oh)


@pytest.mark.parametrize("backend,mode", MODES)
def test_imported_lenet_trains_as_jax(lenet_steps, backend, mode):
    jp, tm, x, oh, jrun = lenet_steps
    assert_steps_equal(jrun, torch_steps(tm, x, oh, backend, mode), jp)


def test_residual_identity_import():
    wt = np.random.default_rng(6).normal(0, 0.3, (8, 3, 3, 8)).astype(np.float32)  # OHWI
    w = T.TFLiteWriter()
    inp = w.tensor((1, 8, 8, 8), name="in")
    cw = w.const(wt)
    c0 = w.tensor((1, 8, 8, 8))
    w.op(T.CONV_2D, [inp, cw, -1], [c0], T.OPT_CONV2D, {"padding": T.PAD_SAME, "stride": (1, 1)})
    j = w.tensor((1, 8, 8, 8))
    w.op(T.ADD, [c0, inp], [j], T.OPT_ADD, {})
    (_, _), (tm, _) = both_imports(w.finish([inp], [j]))
    assert isinstance(tm.layers[0], tblocks.ResidualBlock)


def _net(nn_, blocks, layers, proj_cls, seq):
    """The same small net in either package: SAME padding, a strided conv,
    relu6 (fused and alone), depthwise, residual, projected residual and
    concat joins, global pool and a 1x1 classifier."""
    return seq([
        layers.NITIConv2D(3, 8, (3, 3), (2, 2), "SAME", act="relu6"),
        blocks.NITIDepthwiseConv2D(8, (3, 3), (1, 1), "SAME", act="relu6"),
        layers.NITIRelu(),
        blocks.ResidualBlock(seq([
            layers.NITIConv2D(8, 8, (3, 3), (1, 1), "SAME"), layers.NITIRelu(),
            layers.NITIConv2D(8, 8, (3, 3), (1, 1), "SAME")])),
        layers.NITIRelu6(),
        proj_cls(seq([layers.NITIConv2D(8, 16, (3, 3), (2, 2), "SAME")]),
                 layers.NITIConv2D(8, 16, (1, 1), (2, 2))),
        blocks.ParallelConcat([seq([layers.NITIConv2D(16, 4, (1, 1))]),
                               seq([layers.NITIConv2D(16, 4, (1, 1)), layers.NITIRelu()])]),
        blocks.NITIAvgPool((2, 2)),
        blocks.GlobalAvgPool(),
        layers.NITIConv2D(8, 12, (1, 1)),
        layers.SqueezeLogits(),
    ])


def test_branching_relu6_depthwise_export_round_trip():
    jm = _net(None, jblocks, jlayers, JProjected, JSequential)
    jp = jm.init(jax.random.PRNGKey(5))
    tm = load_jax_params(_net(None, tblocks, tlayers, tblocks.ProjectedResidualBlock,
                              Sequential), jp)
    buf = ttm.tflite_from_sequential(tm, None, (2, 16, 16, 3))
    assert buf == jtm.tflite_from_sequential(jm, jp, (2, 16, 16, 3))
    names = [op.name for op in T.load_tflite(buf).ops]
    assert names.count("ADD") == 2 and names.count("CONCATENATION") == 1
    assert names.count("RELU6") == 3 and names.count("DEPTHWISE_CONV_2D") == 1
    (_, _), (tm2, _) = both_imports(buf)
    x = QTensor(torch.from_numpy(np.random.default_rng(0).integers(-64, 64, (2, 16, 16, 3))
                                 .astype(np.int8)), torch.tensor(-5, dtype=torch.int32))
    y1, _ = Sequential(tm.layers[:-1]).fwd(x)
    y2, _ = Sequential(tm2.layers[:-1]).fwd(x)
    assert torch.equal(y1.data, y2.data) and int(y1.exp) == int(y2.exp)


def test_exporter_refusals_as_jax():
    for model, kind in ((Sequential([tblocks.NITIAvgPool((2, 2), pad=1)]), "pad > 0"),
                        (Sequential([tlayers.NITIConv2D(3, 4, (3, 3), (1, 1),
                                                        ((0, 1), (0, 1)))]), "asymmetric")):
        with pytest.raises(ValueError, match=kind):
            ttm.tflite_from_sequential(model, None, (1, 8, 8, 3))


@pytest.mark.parametrize("net", ["resnet18", "mobilenet_v2"])
def test_full_width_round_trip_params(net):
    """Full-width ResNet-18 (44.7 MB file) and MobileNetV2 from the port's
    weights: both exporters write the same bytes, both importers read the
    same weights back, which are the built model's."""
    tbuild, jbuild = {"resnet18": (resnet18_niti, j_resnet18),
                      "mobilenet_v2": (mobilenet_v2_niti, j_mnv2)}[net]
    tm = tbuild().reset_parameters(torch.Generator().manual_seed(0))
    start = export_jax_params(tm)
    buf = ttm.tflite_from_sequential(tm, None, (2, 32, 32, 3))
    assert buf == jtm.tflite_from_sequential(jbuild(), to_jax(start), (2, 32, 32, 3))
    (_, jp), (tm2, _) = both_imports(buf)
    assert_weights_equal(flat_weights(start), flat_weights(jp))
    assert len(tm2.layers) == {"resnet18": 22, "mobilenet_v2": 51}[net]


def test_chip_smoke_imported_launches_are_the_built_rows(monkeypatch):
    """chip_smoke.py phase 15 holds the launches of the TFLite-imported
    full-width ResNet-18 and MobileNetV2 to the built models'
    EXPECTED_PER_STEP rows. Rehearsed here on the meta device: the dispatch
    calls of a train step and an eval step, per kernel family, at each row
    the phase uses (batch 256 in both fused modes, and its batch against the
    CPU)."""
    import importlib.util
    from pathlib import Path

    from mandheling_tpu_torch.ops import conv as tconv
    from mandheling_tpu_torch.ops.kernels import fused_conv_int8, fused_dwconv_int8
    from mandheling_tpu_torch.ops.kernels import fused_matmul_int8, matmul_int8
    from mandheling_tpu_torch.train import make_eval_step, make_train_step

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    calls = {}
    for fam, mod, name in [("K1", matmul_int8, "matmul_acc"), ("K2", fused_matmul_int8, "matmul_max"),
                           ("K3", fused_conv_int8, "conv_max"), ("K4", fused_dwconv_int8, "dwconv_max"),
                           ("K5", fused_dwconv_int8, "dwconv_fgrad_acc")]:
        real = getattr(mod, name)

        def counted(*a, _fam=fam, _real=real, **k):
            calls[_fam] = calls.get(_fam, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    small = dict(cs.IMPORTED_NETS_SMALL)
    for net, build in (("resnet18", resnet18_niti), ("mnv2", mobilenet_v2_niti)):
        built = build().reset_parameters(torch.Generator().manual_seed(0))
        buf = ttm.tflite_from_sequential(built, None, (256, 32, 32, 3))
        model = ttm.niti_model_from_tflite(buf, device="cpu")[0].to("meta")
        for batch, mode in ((256, "matmul_only"), (256, "all"), (small[net], "matmul_only")):
            x = torch.zeros((batch, 32, 32, 3), device="meta")
            oh = torch.zeros((batch, 12), dtype=torch.int32, device="meta")
            got = []
            with tconv.use_fused_conv_mode(mode):
                for run in (lambda: make_train_step(model)(x, oh),
                            lambda: make_eval_step(model)(
                                x, torch.zeros(batch, dtype=torch.int64, device="meta"))):
                    calls.clear()
                    run()
                    got.append(dict(calls))
            assert tuple(got) == cs.EXPECTED_PER_STEP[(net, batch, mode)], (net, batch, mode)
