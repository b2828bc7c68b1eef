"""The fine-tuning and sanity steps in the form `step_graph.compile_step`
captures (tensor arguments only; train/qat_train.py and the demo CLI), on
the CPU against the JAX CLI's jitted steps in float64:

- MnistInt8Train's step with its lr a 0-d tensor (bitwise the float's; the
  JAX comparison is tests/test_torch_qat.py's) and its predict step;
- LinearRegression's step from the JAX CLI's data: w, b and the losses
  within 1e-9 of the JAX fit after its 200 steps;
- the dropout generator bound at build time and named in `step.generators`,
  registered with every graph a CompiledStep captures, and refused on
  another device than the step's (the CUDA calls of step_graph stubbed as in
  tests/test_torch_jit_step.py).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mandheling_tpu_torch.models.lenet_qat import LeNetQAT
from mandheling_tpu_torch.models import LeNetFP32
from mandheling_tpu_torch.train import qat_train, step_graph
from mandheling_tpu_torch.train.optim import lr_inv

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cli():
    spec = importlib.util.spec_from_file_location("run_train_demo_torch_compiled",
                                                  ROOT / "tools" / "run_train_demo_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def batches(n, batch=8):
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(((rng.integers(0, 256, (batch, 28, 28, 1)) / 255.0 - 0.5) * 2.0)
                           .astype(np.float32)) for _ in range(n)]
    ohs = [torch.from_numpy(np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)])
           for _ in range(n)]
    return xs, ohs


def test_tensor_lr_is_bitwise_the_float_lr():
    """float32, with dropout: a 0-d lr tensor gives the bytes of its float."""
    xs, ohs = batches(3)
    runs = []
    for as_tensor in (False, True):
        model = LeNetQAT().reset_parameters(torch.Generator().manual_seed(0))
        step = qat_train.make_qat_train_step(model, torch.Generator().manual_seed(4))
        losses = [step(x, oh, torch.tensor(lr_inv(0.01, i)) if as_tensor else lr_inv(0.01, i))
                  for i, (x, oh) in enumerate(zip(xs, ohs))]
        runs.append((losses, [v.clone() for v in model.state_dict().values()]))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_predict_step_is_predict():
    xs, ohs = batches(2)
    model = LeNetQAT().reset_parameters(torch.Generator().manual_seed(0))
    qat_train.make_qat_train_step(model)(xs[0], ohs[0], torch.tensor(0.01))
    pred = step_graph.compile_step(qat_train.make_predict_step(model), "cpu")
    assert torch.equal(pred(xs[1]), qat_train.predict(model, xs[1]))


def test_linear_regression_fit_matches_jax(cli):
    """The JAX CLI's data (jax.random) and its jitted step, 200 steps, in
    float64 on both sides."""
    with jax.enable_x64(True):
        xs = jax.random.normal(jax.random.PRNGKey(0), (256, 1), jnp.float64)
        ys = 3.0 * xs + 1.5 + 0.01 * jax.random.normal(jax.random.PRNGKey(1), (256, 1),
                                                        jnp.float64)

        @jax.jit
        def step(w, b):
            loss, (gw, gb) = jax.value_and_grad(
                lambda w, b: jnp.mean((xs @ w + b - ys) ** 2), argnums=(0, 1))(w, b)
            return w - 0.1 * gw, b - 0.1 * gb, loss

        w, b = jnp.zeros((1, 1), jnp.float64), jnp.zeros((1,), jnp.float64)
        j_losses = []
        for _ in range(200):
            w, b, loss = step(w, b)
            j_losses.append(float(loss))
        j_w, j_b = np.asarray(w), np.asarray(b)
        xs, ys = np.array(xs), np.array(ys)
    tw, tb = torch.zeros((1, 1), dtype=torch.float64), torch.zeros((1,), dtype=torch.float64)
    tstep = step_graph.compile_step(cli.make_linear_regression_step(tw, tb), "cpu")
    losses = [float(tstep(torch.from_numpy(xs), torch.from_numpy(ys))) for _ in range(200)]
    np.testing.assert_allclose(tw.numpy(), j_w, rtol=1e-9)
    np.testing.assert_allclose(tb.numpy(), j_b, rtol=1e-9)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-9, atol=1e-12)
    assert abs(float(tw[0, 0]) - 3.0) < 0.01 and abs(float(tb[0]) - 1.5) < 0.01
    # the CLI's own data (torch's generator) fits the same line
    xs_t, ys_t, w0, b0 = cli.linear_regression_data(torch.device("cpu"))
    assert xs_t.shape == ys_t.shape == (256, 1) and not w0.any() and not b0.any()


class FakeStream:
    def wait_stream(self, other):
        pass


class RegisteringGraph:
    """A graph that records the generators registered with it; its capture
    runs the step (a CUDA capture would not)."""

    def __init__(self):
        self.generators = []

    def register_generator_state(self, generator):
        self.generators.append(generator)

    def replay(self):
        pass


@pytest.fixture
def stub_cuda(monkeypatch):
    graphs = []

    def new_graph():
        graphs.append(RegisteringGraph())
        return graphs[-1]

    monkeypatch.setattr(step_graph, "_streams", lambda device: (FakeStream(), FakeStream()))
    monkeypatch.setattr(step_graph, "_warm_up", lambda stream, fn, args: fn(*args))
    monkeypatch.setattr(step_graph, "_new_graph", new_graph)
    monkeypatch.setattr(step_graph, "_capture", lambda graph, stream, fn, args: fn(*args))
    return graphs


def test_the_dropout_generator_is_registered_with_every_graph(stub_cuda):
    gen = torch.Generator().manual_seed(1)
    model = LeNetQAT().reset_parameters(torch.Generator().manual_seed(0))
    step = qat_train.make_qat_train_step(model, gen)
    distill = qat_train.make_distill_step(model, LeNetFP32(), gen)
    assert step.generators == distill.generators == (gen,)
    assert qat_train.make_qat_train_step(model).generators == ()
    assert not hasattr(qat_train.make_teacher_step(LeNetFP32()), "generators")
    compiled = step_graph.CompiledStep(step, "cpu")
    xs, ohs = batches(2, batch=2)
    compiled(xs[0], ohs[0], torch.tensor(0.01))
    compiled(xs[0][:1], ohs[0][:1], torch.tensor(0.01))  # a second signature
    assert compiled.graphs == 2 and [g.generators for g in stub_cuda] == [[gen], [gen]]


def test_a_generator_on_another_device_is_refused(stub_cuda):
    model = LeNetQAT().reset_parameters(torch.Generator().manual_seed(0))
    step = qat_train.make_qat_train_step(model, torch.Generator(device="cpu"))
    with pytest.raises(ValueError, match="cannot draw from a generator on cpu"):
        step_graph._generators(step, torch.device("cuda"))
    assert step_graph._generators(step, torch.device("cpu")) == step.generators
    assert step_graph._generators(lambda x: x, torch.device("cuda")) == ()
