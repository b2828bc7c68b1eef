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


def _port_step(family, kwargs, margins):
    from mandheling_tpu_torch.models import mobilenet_v2_niti, resnet18_niti
    from mandheling_tpu_torch.train import make_train_step

    model = (mobilenet_v2_niti if family == "mobilenet_v2" else resnet18_niti)(**kwargs)
    layers = [m for m in model.modules()
              if isinstance(getattr(m, "w", None), torch.Tensor) and hasattr(m, "w_exp")]
    return make_train_step(model), layers


@pytest.mark.parametrize("family,kwargs,batch,margins", [
    ("mobilenet_v2", {"width_mult": 0.25, "dw_per_channel": True}, 4, (0, 0)),
    ("mobilenet_v2", {"width_mult": 0.25}, 4, None),
    ("resnet18", {}, 2, None),
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
            x = torch.from_numpy(rng.integers(0, 256, (batch, 32, 32, 3)).astype(np.float32))
            oh = torch.zeros(batch, 12, dtype=torch.int32)
            oh[torch.arange(batch), torch.from_numpy(rng.integers(0, 10, batch))] = 1
            assert float(step(x, oh)) == float(R.train_step(ref, x, oh, ctx))
            for layer, (w, e) in zip(layers, R.weights(ref)):
                assert torch.equal(layer.w, w) and torch.equal(layer.w_exp, e)
    moved = sum(int((w != w0).sum()) for (w, _), (w0, _) in zip(R.weights(ref), leaves))
    assert moved > 0


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
