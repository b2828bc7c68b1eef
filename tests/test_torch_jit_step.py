"""The compiled steps (train/step_graph.py: `jit_train_step` / `jit_eval_step`
and the trainer's float steps) against the JAX package's jitted ones, on the
CPU, where the port's compiled step is the eager step itself (its CUDA graphs
need the card: tests/test_torch_cuda.py). The same params, carried across by
utils/jax_params.py, and the same seeded batches go through both packages.

- NITI steps: the port's `jit_train_step` / `jit_eval_step` against the JAX
  package's (XLA backend) for the NITI LeNet, MobileNetV2 at width 0.25
  (per-tensor and the r5 recipe) and a narrow ResNet-18: params and eval
  counts byte-identical after 3 steps, losses within 1e-6 relative.
- The float loops with the lr as a 0-d tensor against the JAX loops, at the
  tolerances of tests/test_torch_fp32.py and test_torch_fp32_cifar_train.py,
  and bitwise equal to the same loops with a Python-float lr.
- `train_niti` on the jit steps against the JAX `train_niti`, 2 epochs.
- The bookkeeping of a CompiledStep and its errors, the CUDA calls replaced
  by stubs: one graph per signature and dispatch setting, launch counts
  taken back at a capture and added at each replay, clones returned, and a
  failed capture raised, never run eagerly instead.

The JAX trainer prefers its native loader; it is given its Python
`DataLoader` here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mandheling_tpu.nn.blocks as jblocks
import mandheling_tpu.nn.layers as jlayers
import mandheling_tpu.nn.module as jmodule
import mandheling_tpu.train.trainer as jtrainer
import mandheling_tpu_torch.nn.blocks as tblocks
import mandheling_tpu_torch.nn.layers as tlayers
import mandheling_tpu_torch.nn.module as tmodule
import mandheling_tpu_torch.train.trainer as ttrainer
from mandheling_tpu import models as jmodels
from mandheling_tpu.data.loader import DataLoader as JDataLoader
from mandheling_tpu.models import mobilenet_fp32 as jmobilenet_fp32
from mandheling_tpu.models import resnet as jresnet
from mandheling_tpu.ops import conv as jconv
from mandheling_tpu.ops import depthwise as jdw
from mandheling_tpu.ops.kernels import use_backend as j_use_backend
from mandheling_tpu.train import jit_eval_step as j_jit_eval_step
from mandheling_tpu.train import jit_train_step as j_jit_train_step
from mandheling_tpu_torch import models as tmodels
from mandheling_tpu_torch.data import onehot_padded, synthetic_cifar, synthetic_mnist
from mandheling_tpu_torch.models import MobileNetV1FP32
from mandheling_tpu_torch.models import resnet as tresnet
from mandheling_tpu_torch.ops import conv as tconv
from mandheling_tpu_torch.ops import depthwise as tdw
from mandheling_tpu_torch.ops import kernels
from mandheling_tpu_torch.ops.kernels import matmul_int8
from mandheling_tpu_torch.train import jit_eval_step, jit_train_step, step_graph
from mandheling_tpu_torch.utils.jax_params import export_jax_params, flat_weights, load_jax_params

STEPS, BATCH = 3, 8


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


def narrow_resnet18(blocks, layers, module, resnet):
    """ResNet-18's blocks (plain and projected) at widths 8 and 16."""
    out = [layers.NITIConv2D(3, 8, (3, 3), (1, 1), "SAME"), layers.NITIRelu()]
    for in_c, out_c, s in [(8, 8, 1), (8, 16, 2), (16, 16, 1)]:
        out += [resnet._basic_block(in_c, out_c, s), layers.NITIRelu()]
    out += [blocks.GlobalAvgPool(), layers.NITIConv2D(16, 12, (1, 1)), layers.SqueezeLogits()]
    return module.Sequential(out)


# name -> (JAX model, port model, data, input side, the r5 recipe's margins 0/0)
NETS = {
    "lenet": (lambda: jmodels.lenet_niti(), lambda: tmodels.lenet_niti(), synthetic_mnist, 28,
              False),
    "mnv2_w025": (lambda: jmodels.mobilenet_v2_niti(width_mult=0.25),
                  lambda: tmodels.mobilenet_v2_niti(width_mult=0.25), synthetic_cifar, 32, False),
    "mnv2_w025_recipe": (lambda: jmodels.mobilenet_v2_niti(width_mult=0.25, dw_per_channel=True),
                         lambda: tmodels.mobilenet_v2_niti(width_mult=0.25, dw_per_channel=True),
                         synthetic_cifar, 32, True),
    "resnet18_narrow": (lambda: narrow_resnet18(jblocks, jlayers, jmodule, jresnet),
                        lambda: narrow_resnet18(tblocks, tlayers, tmodule, tresnet),
                        synthetic_cifar, 16, False),
}


def batches(name):
    _, _, data, side, _ = NETS[name]
    x, y = data(STEPS * BATCH, seed=11)
    x = x[:, :side, :side].astype(np.float32)
    xs = [x[i * BATCH:(i + 1) * BATCH] for i in range(STEPS)]
    ohs = [onehot_padded(y[i * BATCH:(i + 1) * BATCH], 10, 12) for i in range(STEPS)]
    return xs, ohs, y[:BATCH].astype(np.int64)


def set_margins(conv_ops, dw_ops, margin):
    conv_ops.set_fgrad_margin(margin)
    dw_ops.set_dw_fgrad_margin(margin)


@pytest.mark.parametrize("name", list(NETS))
def test_jit_steps_byte_identical_to_jax(name):
    """STEPS steps of `jit_train_step`, then one of `jit_eval_step`, in both
    packages from the JAX init: params and the correct count byte-identical,
    losses within 1e-6 relative (a float32 softmax-CE)."""
    jbuild, tbuild, _, _, recipe = NETS[name]
    xs, ohs, labels = batches(name)
    jmodel = jbuild()
    params = jmodel.init(jax.random.PRNGKey(4))
    start = to_numpy(params)
    jstep, jevals = j_jit_train_step(jmodel), j_jit_eval_step(jmodel)
    jlosses = []
    set_margins(jconv, jdw, 0 if recipe else 2)
    try:
        with j_use_backend("xla"):
            for x, oh in zip(xs, ohs):
                params, loss = jstep(params, jnp.asarray(x), jnp.asarray(oh))
                jlosses.append(float(loss))
            jcorrect = int(jevals(params, jnp.asarray(xs[0]), jnp.asarray(labels)))
    finally:
        set_margins(jconv, jdw, 2)

    model = load_jax_params(tbuild(), start)
    step, evals = jit_train_step(model), jit_eval_step(model)
    losses = []
    set_margins(tconv, tdw, 0 if recipe else 2)
    try:
        for x, oh in zip(xs, ohs):
            losses.append(float(step(torch.from_numpy(x), torch.from_numpy(oh))))
        correct = int(evals(torch.from_numpy(xs[0]), torch.from_numpy(labels)))
    finally:
        set_margins(tconv, tdw, 2)
    final = export_jax_params(model)
    assert_weights_equal(final, to_numpy(params))
    assert any(not np.array_equal(a, b) for a, b in zip(flat_weights(final), flat_weights(start)))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-6, atol=0)
    assert correct == jcorrect


def test_train_niti_on_jit_steps_matches_jax(monkeypatch):
    """2 epochs of `train_niti` (its jit steps) in both packages from the
    JAX init: the same test accuracies and losses in the log lines, and
    byte-identical params."""
    monkeypatch.setattr(jtrainer, "make_loader",
                        lambda x, y, batch, seed=0: JDataLoader(x, y, batch, seed=seed))
    train, test = synthetic_mnist(4 * BATCH, seed=21), synthetic_mnist(2 * BATCH, seed=22)
    start = to_numpy(jmodels.lenet_niti().init(jax.random.PRNGKey(0)))  # train_niti's seed 0
    jlines, tlines = [], []
    jparams, jacc = jtrainer.train_niti(train, test, epochs=2, batch=BATCH, log=jlines.append)
    model, acc = ttrainer.train_niti(train, test, epochs=2, batch=BATCH, log=tlines.append,
                                     start_params=start, device="cpu")
    assert_weights_equal(export_jax_params(model), to_numpy(jparams))
    assert acc == jacc
    assert len(tlines) == len(jlines) == 2
    for t, j in zip(tlines, jlines):
        field = lambda line, key: float(line.split(f"{key} ")[1].split()[0])  # noqa: E731
        assert field(t, "test_acc") == field(j, "test_acc")
        assert abs(field(t, "loss") - field(j, "loss")) <= 5e-5 + 1e-6 * abs(field(j, "loss"))


def record_lr(monkeypatch, as_float=False):
    """Record the lr each sgd_update of the trainer gets; with `as_float`
    hand sgd_update the Python float of the tensor instead (the same loop
    with a Python-float lr)."""
    seen = []
    real = ttrainer.sgd_update

    def update(params, grads, velocity, lr, **kw):
        seen.append(lr)
        return real(params, grads, velocity, float(lr) if as_float else lr, **kw)

    monkeypatch.setattr(ttrainer, "sgd_update", update)
    return seen


def jax_float_start(jcls, kwargs):
    if jcls is None:
        return {name: {k: np.asarray(v) for k, v in entry.items()}
                for name, entry in jmodels.LeNetFP32().init(jax.random.PRNGKey(0)).items()}
    return jax.tree.map(np.asarray, jcls(**kwargs).init(jax.random.PRNGKey(0)))


def assert_close(got, want, rtol):
    scale = max(float(np.abs(w).max()) for w in want)
    assert max(float(np.abs(g - w).max()) for g, w in zip(got, want)) <= rtol * scale


def leaves(tree):
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for t in tree for a in leaves(t)]
    return [np.asarray(tree)]


def test_train_fp32_tensor_lr_matches_jax(monkeypatch):
    """`train_fp32` (float32 LeNet, 3 steps at batch 64) hands sgd_update
    its lr as a 0-d float32 tensor; its params within 1e-4 of the JAX loop's
    largest magnitude per tensor, as tests/test_torch_fp32.py holds them."""
    monkeypatch.setattr(jtrainer, "make_loader",
                        lambda x, y, batch, seed=0: JDataLoader(x, y, batch, seed=seed))
    train, test = synthetic_mnist(3 * 64, seed=31), synthetic_mnist(64, seed=32)
    seen = record_lr(monkeypatch)
    jparams, _ = jtrainer.train_fp32(train, test, epochs=1, batch=64, log=lambda s: None)
    model, _ = ttrainer.train_fp32(train, test, epochs=1, batch=64, log=lambda s: None,
                                   device="cpu", start_params=jax_float_start(None, None))
    assert len(seen) == 3 and all(isinstance(lr, torch.Tensor) and lr.dim() == 0
                                  and lr.dtype == torch.float32 for lr in seen)
    got = model.params_numpy()
    for name in got:
        for key in ("w", "b"):
            assert_close([got[name][key]], [np.asarray(jparams[name][key])], 1e-4)


def test_train_fp32_bn_tensor_lr_matches_jax(monkeypatch):
    """`train_fp32_bn` (MobileNetV1FP32 at width 0.25, 3 steps at batch 2,
    in float64 as test_torch_fp32_cifar_train.py runs it) with the lr as a
    0-d tensor of the params' dtype: each layer entry within 1e-4 of its
    largest magnitude in the JAX loop."""
    kwargs = {"width_mult": 0.25}
    jcls = jmobilenet_fp32.MobileNetV1FP32

    class Float64Loader:
        def __init__(self, x, y, batch, seed=0):
            self.loader = JDataLoader(x, y, batch, seed=seed)

        def __len__(self):
            return len(self.loader)

        def epoch(self):
            for bx, by in self.loader.epoch():
                yield bx.astype(np.float64), by

    start = jax_float_start(jcls, kwargs)
    monkeypatch.setattr(jtrainer, "make_loader", Float64Loader)
    monkeypatch.setattr(ttrainer, "_normalize",
                        lambda x: (x.astype(np.float64) / 255.0 - 0.5) * 2.0)
    monkeypatch.setattr(jcls, "init", lambda self, key, _init=jcls.init: jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float64), _init(self, key)))
    seen = record_lr(monkeypatch)
    x, y = synthetic_cifar(6, seed=31)
    train, test = (x, y), (x[:0], y[:0])
    with jax.enable_x64(True):
        jparams, _ = jtrainer.train_fp32_bn(jcls(**kwargs), train, test, epochs=1, batch=2,
                                            log=lambda s: None)
        jparams = jax.tree.map(np.asarray, jparams)
    model, _ = ttrainer.train_fp32_bn(MobileNetV1FP32(**kwargs).double(), train, test, epochs=1,
                                      batch=2, log=lambda s: None, device="cpu",
                                      start_params=start)
    assert len(seen) == 3 and all(lr.dim() == 0 and lr.dtype == torch.float64 for lr in seen)
    got = model.params_numpy()
    entries = lambda t: [e for x in t for e in entries(x)] if isinstance(t, list) else [t]  # noqa: E731
    for a, b in zip(entries(got), entries(jparams)):
        assert_close(leaves(a), leaves(b), 1e-4)


@pytest.mark.parametrize("which", ["train_fp32", "train_fp32_bn"])
def test_tensor_lr_is_bitwise_the_float_lr(monkeypatch, which):
    """The float loops (float32) give the same bytes and log lines with the
    lr as a 0-d tensor as with the Python float it holds."""
    runs = []
    for as_float in (False, True):
        with monkeypatch.context() as m:
            record_lr(m, as_float)
            lines = []
            if which == "train_fp32":
                model, _ = ttrainer.train_fp32(synthetic_mnist(3 * 16, seed=3),
                                               synthetic_mnist(16, seed=4), epochs=1, batch=16,
                                               log=lines.append, device="cpu")
            else:
                model, _ = ttrainer.train_fp32_bn(MobileNetV1FP32(width_mult=0.25),
                                                  synthetic_cifar(3 * 4, seed=3),
                                                  synthetic_cifar(4, seed=4), epochs=1, batch=4,
                                                  log=lines.append, device="cpu")
            runs.append(([p.detach().clone() for p in model.parameters()]
                         + [b.clone() for b in model.buffers()],
                         [ln.split(" [")[0] for ln in lines]))
    (tensors_t, lines_t), (tensors_f, lines_f) = runs
    assert len(tensors_t) == len(tensors_f) > 0
    assert all(torch.equal(a, b) for a, b in zip(tensors_t, tensors_f))
    assert lines_t == lines_f


def test_jit_steps_refuse_a_group():
    """The compiled steps are single-chip, as the JAX package's: a step over
    a replica group runs eagerly (make_train_step / make_eval_step)."""
    model = tmodels.lenet_niti()
    for jit in (jit_train_step, jit_eval_step):
        with pytest.raises(ValueError, match="single-chip"):
            jit(model, group=object())
    assert callable(jit_train_step(model)) and callable(jit_eval_step(model))


class FakeStream:
    def wait_stream(self, other):
        pass


class FakeGraph:
    """A graph whose replay runs the captured function again on the same
    static inputs and writes its results into the captured outputs. While
    it replays, `replaying` is set: the test's functions then skip what
    they do on the host (a CUDA replay runs no Python)."""

    captures = 0
    replaying = False

    def replay(self):
        FakeGraph.replaying = True
        try:
            new = self.fn(*self.args)
        finally:
            FakeGraph.replaying = False
        outs = self.outputs if isinstance(self.outputs, tuple) else (self.outputs,)
        for out, n in zip(outs, new if isinstance(new, tuple) else (new,)):
            out.copy_(n)


def fake_capture(graph, stream, fn, args):
    FakeGraph.captures += 1
    graph.fn, graph.args = fn, args
    graph.outputs = fn(*args)
    return graph.outputs


@pytest.fixture
def stub_cuda(monkeypatch):
    """step_graph's CUDA calls replaced: streams that order nothing, the
    warm-up run in place, and FakeGraph for the graphs. A CompiledStep made
    directly for the CPU then runs its CUDA path's bookkeeping here."""
    FakeGraph.captures = 0
    monkeypatch.setattr(step_graph, "_streams", lambda device: (FakeStream(), FakeStream()))
    monkeypatch.setattr(step_graph, "_warm_up", lambda stream, fn, args: fn(*args))
    monkeypatch.setattr(step_graph, "_new_graph", FakeGraph)
    monkeypatch.setattr(step_graph, "_capture", fake_capture)
    kernels.reset_launch_counts()
    yield
    kernels.reset_launch_counts()


def doubled(x, y):
    """(2x, x + y), and one (pretended) launch of K1."""
    if not FakeGraph.replaying:
        matmul_int8.LAUNCHES += 1
    return 2 * x, x + y


def test_compiled_step_bookkeeping(stub_cuda):
    step = step_graph.CompiledStep(doubled, "cpu")
    x, y = torch.arange(4.0), torch.ones(4)
    outs = [step(x + i, y) for i in range(4)]
    for i, (a, b) in enumerate(outs):  # each call's own result, not the last replay's
        assert torch.equal(a, 2 * (x + i)) and torch.equal(b, x + i + 1)
    assert step.graphs == 1 and FakeGraph.captures == 1
    # one launch a call: the warm-up's, then one a replay; the capture's taken back
    assert kernels.launch_counts()["matmul_int8"] == 4
    step(torch.zeros(5), torch.zeros(5))  # another shape: another graph
    assert step.graphs == 2
    with tconv.use_fused_conv_mode("all"):  # another dispatch setting: another graph
        a, _ = step(x, y)
    assert step.graphs == 3 and torch.equal(a, 2 * x)
    with kernels.use_backend("torch"), tdw.recipe_margins():
        step(x, y)
    assert step.graphs == 4
    assert torch.equal(step(x + 1, y)[0], 2 * (x + 1)) and step.graphs == 4
    assert kernels.launch_counts()["matmul_int8"] == 8


def test_compiled_step_replays_hooks(stub_cuda):
    """A replay hook sees what a capture counted on the host and gets it
    again at every replay of that graph while the hook is in place."""
    class Calls:
        def __init__(self):
            self.n = 0

        def begin(self):
            return self.n

        def end(self, before):
            made, self.n = self.n - before, before
            return made

        def replay(self, made):
            self.n += made

    calls = Calls()

    def fn(x):
        if not FakeGraph.replaying:
            calls.n += 1
        return x + 1

    step = step_graph.CompiledStep(fn, "cpu")
    with step_graph.replay_hook(calls):
        for _ in range(3):
            step(torch.zeros(2))
    assert calls.n == 3
    step(torch.zeros(2))  # the hook is gone: not counted
    assert calls.n == 3


def test_failed_capture_raises_and_never_runs_eagerly(stub_cuda, monkeypatch):
    """A capture that fails raises on every call, and no call returns an
    eager result in its place; the launches of the failed capture are taken
    back."""
    def refuse(graph, stream, fn, args):
        fn(*args)
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(step_graph, "_capture", refuse)
    step = step_graph.CompiledStep(doubled, "cpu")
    for _ in range(2):
        with pytest.raises(RuntimeError, match="not permitted when stream is capturing"):
            step(torch.ones(3), torch.ones(3))
    assert step.graphs == 0
    # the two warm-ups launched; the failed captures' launches were taken back
    assert kernels.launch_counts()["matmul_int8"] == 2


def test_compile_step_is_the_eager_step_on_the_cpu():
    """On the CPU, which the caller asks for, the compiled step is the step."""
    assert step_graph.compile_step(doubled, "cpu") is doubled
    assert isinstance(step_graph.compile_step(doubled, "cuda"), step_graph.CompiledStep)


def test_compiled_step_spans_and_counters(stub_cuda, monkeypatch):
    """Recorded under profiler.spans: step.call around every call (the step
    id), step.capture inside the first, step.copy_in / step.replay /
    step.hooks / step.clone inside each replay, in that order; counters
    step.captures, step.replays and step.graph_kernels (the kernel nodes
    _capture counted, once a replay). A call outside the recording records
    nothing."""
    from mandheling_tpu_torch.utils import profiler

    def counted(graph, stream, fn, args):
        out = fake_capture(graph, stream, fn, args)
        graph.kernels = 7
        return out

    monkeypatch.setattr(step_graph, "_capture", counted)
    step = step_graph.CompiledStep(doubled, "cpu")
    x, y = torch.arange(4.0), torch.ones(4)
    with profiler.spans("cpu") as rec:
        outs = [step(x + i, y) for i in range(3)]
    step(x, y)
    assert all(torch.equal(a, 2 * (x + i)) for i, (a, _) in enumerate(outs))
    calls = [s for s in rec.spans if s.name == "step.call"]
    assert [s.step for s in calls] == [1, 2, 3] and rec.steps == 3
    inside = {c.id: [s.name for s in rec.spans if s.parent == c.id] for c in calls}
    assert inside[calls[0].id] == ["step.capture"]
    for c in calls[1:]:
        assert inside[c.id] == ["step.copy_in", "step.replay", "step.hooks", "step.clone"]
    assert all(s.step == c.step for c in calls for s in rec.spans if s.parent == c.id)
    assert rec.counters == {"step.captures": 1, "step.replays": 2, "step.graph_kernels": 14}
    assert rec.intervals == []  # no device, no marks
