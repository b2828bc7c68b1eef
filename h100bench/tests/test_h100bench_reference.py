"""The benchmark's plain reference held byte for byte to the port's plain
path (backend "torch") on the CPU, over a few steps, and kept free of the
program and of JAX."""

import ast
import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch

from h100bench import reference as R
from h100bench import weights as W

HERE = Path(__file__).resolve().parents[1]


# the program's builder of each family, and the input (H, W, C) of its CPU-size test
BUILDERS = {"mobilenet_v2": "mobilenet_v2_niti", "resnet18": "resnet18_niti",
            "lenet": "lenet_niti", "squeezenet": "squeezenet_niti",
            "inception_v3": "inceptionv3_niti", "resnet50v2": "resnet50v2_niti"}
INPUT = {"lenet": (28, 28, 1), "squeezenet": (64, 64, 3), "inception_v3": (75, 75, 3),
         "resnet50v2": (64, 64, 3)}


def _port_layers(model):
    return [m for m in model.modules()
            if isinstance(getattr(m, "w", None), torch.Tensor) and hasattr(m, "w_exp")]


def _port_step(family, kwargs, margins):
    from mandheling_tpu_torch import models
    from mandheling_tpu_torch.train import make_train_step

    model = getattr(models, BUILDERS[family])(**kwargs)
    return make_train_step(model), _port_layers(model)


@pytest.mark.parametrize("family,kwargs,batch,margins", [
    ("mobilenet_v2", {"width_mult": 0.25, "dw_per_channel": True}, 4, (0, 0)),
    ("mobilenet_v2", {"width_mult": 0.25}, 4, None),
    ("resnet18", {}, 2, None),
    ("lenet", {}, 4, None),
    ("squeezenet", {"num_classes": 10}, 2, None),
    ("inception_v3", {"num_classes": 10}, 2, None),
    ("resnet50v2", {"num_classes": 10}, 2, None),
])
def test_reference_equals_the_ports_plain_path(family, kwargs, batch, margins):
    from mandheling_tpu_torch.ops.depthwise import recipe_margins
    from mandheling_tpu_torch.ops.kernels import use_backend

    ref = R.build(family, **kwargs)
    leaves = W.make(ref, torch.Generator().manual_seed(2**31 + 7))
    R.load(ref, leaves)
    step, layers = _port_step(family, kwargs, margins)
    assert [tuple(l.w.shape) for l in layers] == [tuple(w.shape) for w, _ in leaves]
    for layer, (w, e) in zip(layers, leaves):
        layer.w.copy_(w)
        layer.w_exp.copy_(e)
    ctx = R.Ctx(R.INT8, *(margins or (2, 2)))
    rng = np.random.default_rng(3)
    with use_backend("torch"), (recipe_margins(*margins) if margins else contextlib.nullcontext()):
        for _ in range(3):
            x = torch.from_numpy(rng.integers(0, 256, (batch, *INPUT.get(family, (32, 32, 3))))
                                 .astype(np.float32))
            oh = torch.zeros(batch, 12, dtype=torch.int32)
            oh[torch.arange(batch), torch.from_numpy(rng.integers(0, 10, batch))] = 1
            assert float(step(x, oh)) == float(R.train_step(ref, x, oh, ctx))
            for layer, (w, e) in zip(layers, R.weights(ref)):
                assert torch.equal(layer.w, w) and torch.equal(layer.w_exp, e)
    moved = sum(int((w != w0).sum()) for (w, _), (w0, _) in zip(R.weights(ref), leaves))
    assert moved > 0


def _port_grads(g):
    """The int8 weight grads of a program layer's nested grads, in order."""
    if isinstance(g, dict):
        return [g["w"].data] if "w" in g else [x for v in g.values() for x in _port_grads(v)]
    return [x for v in g for x in _port_grads(v)] if isinstance(g, (list, tuple)) else []


def _equal_alone(ref_layer, port_layer, x, e, seed):
    """The reference's layer and the program's, on the same weights, input
    and output gradient: forward data and exponent, input grad and weight
    grads byte for byte."""
    from mandheling_tpu_torch.ops.kernels import use_backend
    from mandheling_tpu_torch.ops.qtensor import QTensor

    leaves = W.make([ref_layer], torch.Generator().manual_seed(seed))
    if leaves:
        R.load([ref_layer], leaves)
        for layer, (w, we) in zip(_port_layers(port_layer), leaves):
            layer.w.copy_(w)
            layer.w_exp.copy_(we)
    ctx = R.Ctx()
    y, ey, res = ref_layer.fwd(x, e, ctx)
    with use_backend("torch"):
        q, pres = port_layer.fwd(QTensor(x, e))
        gy = torch.from_numpy(np.random.default_rng(seed).integers(-127, 128, tuple(y.shape))
                              .astype(np.int8))
        gx, pgrads = port_layer.bwd(pres, gy)
    rgx, rgrads = ref_layer.bwd(res, gy, ctx)
    assert torch.equal(q.data, y) and int(q.exp) == int(ey)
    assert gx.dtype == rgx.dtype == torch.int8 and torch.equal(gx, rgx)
    got = _port_grads(pgrads)
    assert len(got) == len(rgrads) == len(leaves)
    assert all(torch.equal(a, b) for a, (_, b) in zip(got, rgrads))
    return y, ey


def _int8(seed, shape, lo=-127, hi=128):
    return torch.from_numpy(np.random.default_rng(seed).integers(lo, hi, shape).astype(np.int8))


@pytest.mark.parametrize("window,stride,shape", [((2, 2), (2, 2), (2, 8, 8, 5)),
                                                 ((2, 2), (2, 2), (2, 9, 7, 5)),
                                                 ((3, 3), (2, 2), (2, 9, 11, 5)),
                                                 ((3, 3), (2, 2), (3, 15, 15, 4))])
def test_maxpool_alone_equals_the_port(window, stride, shape):
    from mandheling_tpu_torch.nn.layers import NITIMaxPool

    # values from a handful, so that most windows hold their max twice or more
    x = _int8(1, shape, -3, 4)
    y, _ = _equal_alone(R.MaxPool(window, stride), NITIMaxPool(window, stride), x,
                        torch.tensor(-5, dtype=torch.int32), 7)
    win = R.windows(x, window, stride)
    assert int(((win == y[:, :, :, None, None, :]).sum(dim=(3, 4)) > 1).sum()) > 0


def test_avgpool_alone_equals_the_port():
    from mandheling_tpu_torch.nn.blocks import NITIAvgPool

    for seed, shape in ((1, (2, 7, 7, 6)), (2, (2, 5, 9, 3))):
        _equal_alone(R.AvgPool((3, 3), (1, 1), pad=1), NITIAvgPool((3, 3), (1, 1), pad=1),
                     _int8(seed, shape), torch.tensor(3, dtype=torch.int32), seed)


def test_flatten_alone_equals_the_port():
    from mandheling_tpu_torch.nn.layers import Flatten

    _equal_alone(R.Flatten(), Flatten(), _int8(4, (2, 3, 5, 4)),
                 torch.tensor(0, dtype=torch.int32), 4)


def _port_concat(branches):
    """The program's ParallelConcat of reference branches (lists of Conv,
    Relu, AvgPool and Concat)."""
    from mandheling_tpu_torch.nn.blocks import NITIAvgPool, ParallelConcat
    from mandheling_tpu_torch.nn.layers import NITIConv2D, NITIRelu
    from mandheling_tpu_torch.nn.module import Sequential

    def port(layer):
        if isinstance(layer, R.Conv):
            return NITIConv2D(layer.ic, layer.oc, layer.kernel, layer.stride, layer.padding)
        if isinstance(layer, R.AvgPool):
            return NITIAvgPool(layer.window, layer.stride, layer.pad)
        if isinstance(layer, R.Concat):
            return _port_concat(layer.branches)
        return NITIRelu()

    return ParallelConcat([Sequential([port(l) for l in b]) for b in branches])


@pytest.mark.parametrize("nested", [False, True], ids=["flat", "nested"])
def test_concat_alone_equals_the_port(nested):
    split = R.Concat([[R.Conv(6, 4, (1, 3), (1, 1), "SAME"), R.Relu()],
                      [R.Conv(6, 4, (3, 1), (1, 1), "SAME")]])
    cat = R.Concat([[R.Conv(5, 3), R.Relu()],
                    [R.Conv(5, 6, (3, 3), (1, 1), "SAME")] + ([split] if nested else []),
                    [R.AvgPool((3, 3), (1, 1), pad=1), R.Conv(5, 2)],
                    [R.Relu()]])
    x, e = _int8(6, (2, 7, 7, 5)), torch.tensor(-2, dtype=torch.int32)
    y, ey = _equal_alone(cat, _port_concat(cat.branches), x, e, 11)
    assert y.shape == (2, 7, 7, 3 + (8 if nested else 6) + 2 + 5)
    # the branches came with unequal exponents: the identity's -2 and the convs' own
    exps = {int(R.run_forward(b, x, e, R.Ctx())[1]) for b in cat.branches}
    assert len(exps) > 1 and int(ey) == max(exps)


def test_int4_control_departs_from_int8():
    ref8, ref4 = R.build("resnet18"), R.build("resnet18")
    leaves = W.make(ref8, torch.Generator().manual_seed(5))
    R.load(ref8, leaves)
    R.load(ref4, leaves)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3))
                         .astype(np.float32))
    oh = torch.zeros(2, 12, dtype=torch.int32)
    oh[:, 3] = 1
    l8 = R.train_step(ref8, x, oh, R.Ctx(R.INT8))
    l4 = R.train_step(ref4, x, oh, R.Ctx(R.INT4))
    assert float(l8) != float(l4)
    assert any(not torch.equal(a, b) for (a, _), (b, _) in zip(R.weights(ref8), R.weights(ref4)))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


@pytest.mark.parametrize("path", [HERE / "reference.py", *sorted((HERE / "families").glob("*.py"))],
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program_or_jax(path):
    names = set(_imports(path))
    assert {n.split(".")[0] for n in names} <= {"__future__", "math", "dataclasses", "typing",
                                                "importlib", "pathlib", "torch", "h100bench"}
    assert {n for n in names if n.startswith("h100bench")} <= {"h100bench.reference"}


def test_reference_runs_on_the_meta_device():
    ref = R.build("mobilenet_v2", dw_per_channel=True)
    leaves = [(torch.zeros(l.weight_shape, dtype=torch.int8, device="meta"),
               torch.zeros((l.weight_shape[-1],) if l.per_channel else (), dtype=torch.int32,
                           device="meta")) for l in R.weighted(ref)]
    R.load(ref, leaves)
    loss = R.train_step(ref, torch.zeros((256, 32, 32, 3), device="meta"),
                        torch.zeros((256, 12), dtype=torch.int32, device="meta"), R.Ctx())
    assert loss.shape == ()


@pytest.mark.parametrize("family,shape", [("lenet", (64, 28, 28, 1)),
                                          ("squeezenet", (128, 224, 224, 3)),
                                          ("inception_v3", (32, 299, 299, 3)),
                                          ("resnet50v2", (64, 224, 224, 3))])
def test_the_zoo_runs_on_the_meta_device_at_published_sizes(family, shape):
    ref = R.build(family)
    R.load(ref, [(torch.zeros(l.weight_shape, dtype=torch.int8, device="meta"),
                  torch.zeros((), dtype=torch.int32, device="meta")) for l in R.weighted(ref)])
    width = R.shape_of(ref, shape)[-1]
    loss = R.train_step(ref, torch.zeros(shape, device="meta"),
                        torch.zeros((shape[0], width), dtype=torch.int32, device="meta"), R.Ctx())
    assert loss.shape == () and width == (12 if family == "lenet" else 1000)


@pytest.mark.cuda
def test_reference_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    outs = []
    for dev in ("cpu", "cuda"):
        ref = R.build("resnet18")
        R.load(ref, [(w.to(dev), e.to(dev)) for w, e in
                     W.make(R.build("resnet18"), torch.Generator().manual_seed(9))])
        x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (8, 32, 32, 3))
                             .astype(np.float32)).to(dev)
        oh = torch.zeros(8, 12, dtype=torch.int32, device=dev)
        oh[:, 1] = 1
        loss = R.train_step(ref, x, oh, R.Ctx())
        outs.append((float(loss), [w.cpu() for w, _ in R.weights(ref)]))
    assert outs[0][0] == pytest.approx(outs[1][0], rel=1e-6)  # float32 softmax on two devices
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
