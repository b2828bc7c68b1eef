"""The port's fake-quant QAT (nn/qat.py, models/lenet_qat.py) and the steps
of MnistInt8Train and DistillTrainQuant (train/qat_train.py) against the JAX
package, from the same params (the JAX init, carried across by
utils/jax_params.py) and the same batches made from a numpy seed.

Tolerance: 1e-9 of each tensor's largest magnitude, in float64 on both sides
(`jax.enable_x64`, the port's model `.double()`). Fake quant turns an
ulp of difference into a whole quant step, so multi-step comparisons run in
float64, where none is met; float32 is held to a single forward
(test_lenet_qat_float32_forward states what it found).
Parity runs have no dropout (jax.random's stream cannot be reproduced); the
port's dropout is tested alone."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mandheling_tpu.models import LeNetFP32 as JLeNetFP32
from mandheling_tpu.models.lenet_qat import LeNetQAT as JLeNetQAT
from mandheling_tpu.nn import qat as jqat
from mandheling_tpu.train.losses import distill_loss as j_distill_loss
from mandheling_tpu.train.optim import lr_inv as j_lr_inv
from mandheling_tpu.train.optim import sgd_init as j_sgd_init
from mandheling_tpu.train.optim import sgd_update as j_sgd_update
from mandheling_tpu_torch.models import LeNetFP32
from mandheling_tpu_torch.models import lenet_qat as tlenet_qat
from mandheling_tpu_torch.models.lenet_qat import LeNetQAT
from mandheling_tpu_torch.nn import qat as tqat
from mandheling_tpu_torch.train import qat_train
from mandheling_tpu_torch.utils.jax_params import export_qat_params, load_qat_params

TOL = 1e-9
BATCH, STEPS = 8, 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test runners share the machine's cores among
    several processes, where torch's spinning thread pool slows tiny ops by
    orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def tree_close(got, want, tol=TOL):
    for name in want:
        for key in want[name]:
            close(got[name][key], want[name][key], tol)


def f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


J_APPLY = jax.jit(JLeNetQAT().apply, static_argnames=("training",))


def jax_init(seed=0):
    params, obs = JLeNetQAT().init(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, obs)


def mnist_batches(seed, n, normalise=True):
    rng = np.random.default_rng(seed)
    xs = [rng.integers(0, 256, (BATCH, 28, 28, 1)).astype(np.float64) for _ in range(n)]
    if normalise:
        xs = [(x / 255.0 - 0.5) * 2.0 for x in xs]
    ohs = [np.eye(10)[rng.integers(0, 10, BATCH)] for _ in range(n)]
    return xs, ohs


@pytest.mark.parametrize("zero_channel", [False, True])
def test_weight_fake_quant_and_ste_grads(zero_channel):
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.1, (5, 5, 3, 8))
    if zero_channel:
        w[..., 2] = 0.0  # the 1e-6 floor of the scale
    c = rng.normal(0, 1, w.shape)
    with jax.enable_x64(True):
        want = jqat.fake_quant_weight_perchannel(jnp.asarray(w), 7.0)
        gj = jax.grad(lambda v: jnp.sum(jqat.fake_quant_weight_perchannel(v, 7.0) * c))(
            jnp.asarray(w))
    tw = t(w).requires_grad_()
    got = tqat.fake_quant_weight_perchannel(tw, 7.0)
    (g,) = torch.autograd.grad(torch.sum(got * t(c)), tw)
    close(got.detach(), want)
    close(g, gj)
    np.testing.assert_array_equal(g.numpy(), c)  # straight through


@pytest.mark.parametrize("mn,mx", [(-1.0, 1.0), (0.5, 2.0), (-3.0, -1.0), (0.0, 0.0),
                                   (-0.3, 5.0)])
def test_feature_fake_quant_scale_zeropoint_and_ste(mn, mx):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (4, 6, 6, 3))
    c = rng.normal(0, 1, x.shape)
    with jax.enable_x64(True):
        s_j, z_j = jqat.compute_scale_zeropoint(jnp.float64(mn), jnp.float64(mx))
        want = jqat.fake_quant_feature(jnp.asarray(x), jnp.float64(mn), jnp.float64(mx))
        gj = jax.grad(lambda v: jnp.sum(jqat.fake_quant_feature(
            v, jnp.float64(mn), jnp.float64(mx)) * c))(jnp.asarray(x))
    s_t, z_t = tqat.compute_scale_zeropoint(torch.tensor(mn, dtype=torch.float64),
                                            torch.tensor(mx, dtype=torch.float64))
    close(s_t, s_j)
    close(z_t, z_j)
    tx = t(x).requires_grad_()
    got = tqat.fake_quant_feature(tx, torch.tensor(mn, dtype=torch.float64),
                                  torch.tensor(mx, dtype=torch.float64))
    (g,) = torch.autograd.grad(torch.sum(got * t(c)), tx)
    close(got.detach(), want)
    close(g, gj)


@pytest.mark.parametrize("method", ["moving_average", "maximum"])
@pytest.mark.parametrize("initialized", [0.0, 1.0])
def test_update_observer(method, initialized):
    with jax.enable_x64(True):
        for old, new in ((0.7, 1.3), (-2.0, -5.0), (0.0, 0.25)):
            want = jqat.update_observer(jnp.float64(old), jnp.float64(new),
                                        jnp.float64(initialized), method)
            newt = torch.tensor(new, dtype=torch.float64, requires_grad=True)
            got = tqat.update_observer(torch.tensor(old, dtype=torch.float64), newt,
                                       torch.tensor(initialized, dtype=torch.float64), method)
            close(got, want)
            assert not got.requires_grad  # an observation carries no gradient
    with pytest.raises(ValueError):
        tqat.update_observer(torch.zeros(()), torch.zeros(()), torch.zeros(()), "median")


@pytest.mark.parametrize("training", [True, False])
def test_qat_conv_apply(training):
    params, obs = jax_init()
    p, o = params["conv2"], {k: np.float64(v) for k, v in obs["conv2"].items()}
    o.update(in_min=-0.2, in_max=0.9, out_min=-1.0, out_max=1.0, initialized=1.0)
    rng = np.random.default_rng(2)
    x = rng.normal(0.2, 0.4, (2, 12, 12, 20))
    with jax.enable_x64(True):
        y_j, o_j = jqat.qat_conv_apply(f64(p), f64(o), jnp.asarray(x), bits=8,
                                       activation=lambda v: jnp.clip(v, 0.0, 6.0),
                                       training=training)
    tp = {k: t(v).double() for k, v in p.items()}
    to = {k: torch.tensor(v, dtype=torch.float64) for k, v in o.items()}
    y, o_t = tqat.qat_conv_apply(tp, to, t(x), bits=8, activation=tlenet_qat._relu6,
                                 training=training)
    close(y, y_j)
    for k in o_j:
        close(o_t[k], o_j[k])
    assert float(to["in_min"]) == -0.2  # the caller's observers are left as they were


def test_pool_sends_ties_to_the_first_maximum():
    """Fake-quantized activations are discrete, so 2x2 windows often hold
    equal maxima; the gradient must reach the element the JAX package's
    reduce_window picks."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 3, (3, 8, 10, 4)).astype(np.float64)
    x[0, :2, :2, 0] = 2.0  # a whole window tied
    gy = rng.normal(0, 1, (3, 4, 5, 4))

    def jpool(v):
        return jax.lax.reduce_window(v, -jnp.inf, jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1),
                                     "VALID")

    with jax.enable_x64(True):
        want = jpool(jnp.asarray(x))
        gj = jax.grad(lambda v: jnp.sum(jpool(v) * gy))(jnp.asarray(x))
    tx = t(x).requires_grad_()
    got = tlenet_qat._pool(tx)
    (g,) = torch.autograd.grad(torch.sum(got * t(gy)), tx)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(g.numpy(), np.asarray(gj))
    assert (np.asarray(gj) != 0).sum() == gy.size  # one element of each window


def test_relu6_splits_ties_as_jnp_clip():
    v = np.array([-1.0, 0.0, 3.0, 6.0, 7.0])
    with jax.enable_x64(True):
        gj = jax.grad(lambda a: jnp.sum(jnp.clip(a, 0.0, 6.0)))(jnp.asarray(v))
    tv = t(v).requires_grad_()
    (g,) = torch.autograd.grad(tlenet_qat._relu6(tv).sum(), tv)
    np.testing.assert_array_equal(g.numpy(), np.asarray(gj))


def test_observer_init_matches_jax():
    want = jqat.qat_observer_init()
    got = tqat.qat_observer_init()
    assert list(got) == list(want)
    assert all(float(got[k]) == float(want[k]) == 0.0 for k in want)
    assert list(LeNetQAT().observers["conv1"].as_dict()) == list(want)


def test_qat_params_carry_across_both_ways():
    params, obs = jax_init()
    obs["ip1"]["in_max"] = np.float32(0.5)
    model = load_qat_params(LeNetQAT(), params, obs)
    p, o = export_qat_params(model)
    for name in params:
        for key in params[name]:
            np.testing.assert_array_equal(p[name][key], params[name][key])
        for key in obs[name]:
            assert o[name][key] == obs[name][key]
    with pytest.raises(ValueError):
        load_qat_params(LeNetQAT(), {**params, "ip2": {"w": np.zeros((1, 1, 500, 12)),
                                                       "b": np.zeros(10)}})
    drawn = LeNetQAT().reset_parameters(torch.Generator().manual_seed(0))
    w = drawn.layers["ip1"]["w"].detach()
    assert abs(float(w.std()) - (2.0 / 1300) ** 0.5) < 1e-3
    assert not any(drawn.layers[n]["b"].detach().any() for n in drawn.SHAPES)


@pytest.mark.parametrize("training", [True, False])
def test_lenet_qat_forward_matches_jax(training):
    """One forward after a training forward (which sets the observers), in
    float64 within 1e-9, against the jitted JAX forward (as the JAX demos
    run it: XLA turns its division of a scale by a constant into a
    multiplication, and so does the port)."""
    params, obs = jax_init()
    xs, _ = mnist_batches(4, 2)
    with jax.enable_x64(True):
        _, o1 = J_APPLY(f64(params), obs, jnp.asarray(xs[0]), training=True)
        logits, o2 = J_APPLY(f64(params), o1, jnp.asarray(xs[1]), training=training)
        o1, o2, logits = jax.tree.map(np.asarray, (o1, o2, logits))
    model = load_qat_params(LeNetQAT(), params).double()
    with torch.no_grad():
        model(t(xs[0]))
        tree_close(export_qat_params(model)[1], o1)
        got = model(t(xs[1]), training=training)
    close(got, logits)
    tree_close(export_qat_params(model)[1], o2)


@pytest.mark.parametrize("seed", [4, 5, 6, 7])
def test_lenet_qat_float32_forward(seed):
    """A float32 forward (the demos' dtype): float32 convs sum in another
    order than XLA's, and where that moves a value across a rounding
    boundary one activation takes the next quant step; where that value is
    an observed extreme, every later scale moves with it. Found at these
    seeds: the logits within 1.35e-2 of the largest magnitude at worst
    (seed 4, all 80 moved), 6.9e-3 (seed 5, one logit), 5e-7 and 1.5e-7 where
    no step is crossed; held to 2e-2, the observers too."""
    params, obs = jax_init()
    xs, _ = mnist_batches(seed, 2)
    xs = [x.astype(np.float32) for x in xs]
    _, o1 = J_APPLY(params, obs, jnp.asarray(xs[0]), training=True)
    logits, o2 = J_APPLY(params, o1, jnp.asarray(xs[1]), training=True)
    logits = np.asarray(logits)
    model = load_qat_params(LeNetQAT(), params)
    with torch.no_grad():
        model(t(xs[0]))
        got = model(t(xs[1])).numpy()
    err = np.abs(got - logits) / np.abs(logits).max()
    assert err.max() <= 2e-2, err.max()
    tree_close(export_qat_params(model)[1], jax.tree.map(np.asarray, o2), 2e-2)


def test_mnist_int8_train_steps_match_jax():
    """MnistInt8Train's step (the JAX CLI's inline step, without dropout)
    for STEPS steps at its lr_inv(0.01, step), the lr a 0-d tensor: params,
    observers and losses within 1e-9."""
    params, obs = jax_init()
    xs, ohs = mnist_batches(5, STEPS)
    lrs = [float(j_lr_inv(0.01, i)) for i in range(STEPS)]
    jm = JLeNetQAT()

    def loss_fn(p, o, xb, oh):
        logits, new_o = jm.apply(p, o, xb, dropout_key=None, training=True)
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * oh, axis=-1)), new_o

    @jax.jit
    def step(p, o, v, xb, oh, lr):
        (loss, new_o), g = jax.value_and_grad(loss_fn, has_aux=True)(p, o, xb, oh)
        p, v = j_sgd_update(p, g, v, lr)
        return p, new_o, v, loss

    with jax.enable_x64(True):
        p, o = f64(params), obs
        v = j_sgd_init(p)
        losses_j = []
        for x, oh, lr in zip(xs, ohs, lrs):
            p, o, v, loss = step(p, o, v, jnp.asarray(x), jnp.asarray(oh), lr)
            losses_j.append(float(loss))
        p_j, o_j = jax.tree.map(np.asarray, (p, o))

    model = load_qat_params(LeNetQAT().double(), params)
    tstep = qat_train.make_qat_train_step(model)
    # the lr a 0-d tensor of the params' dtype, as the compiled step takes it
    losses = [float(tstep(t(x), t(oh), torch.tensor(lr, dtype=torch.float64)))
              for x, oh, lr in zip(xs, ohs, lrs)]
    got_p, got_o = export_qat_params(model)
    tree_close(got_p, p_j)
    tree_close(got_o, o_j)
    close(losses, losses_j)
    assert not np.array_equal(got_p["conv1"]["w"], params["conv1"]["w"])
    with jax.enable_x64(True):
        logits_j, _ = J_APPLY(f64(p_j), o_j, jnp.asarray(xs[0]), training=False)
    np.testing.assert_array_equal(qat_train.predict(model, t(xs[0])).numpy(),
                                  np.argmax(np.asarray(logits_j), -1))


def jax_distill(params, obs, tparams, xs, ohs, student_steps):
    """The JAX CLI's DistillTrainQuant steps in float64: one teacher step on
    batch 0, then `student_steps` student steps -> (teacher loss, teacher
    params, student losses, student params, observers)."""
    teacher_j, student_j = JLeNetFP32(), JLeNetQAT()

    def tloss(p, xb, oh):
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(teacher_j.apply(p, xb)) * oh, -1))

    with jax.enable_x64(True):
        tp = f64(tparams)
        tl, g = jax.jit(jax.value_and_grad(tloss))(tp, jnp.asarray(xs[0]), jnp.asarray(ohs[0]))
        tp, _ = j_sgd_update(tp, g, j_sgd_init(tp), 0.05)

        def sloss(p, o, xb, oh):
            slogits, new_o = student_j.apply(p, o, xb, dropout_key=None, training=True)
            return j_distill_loss(slogits, teacher_j.apply(tp, xb), oh, 20.0, 0.9), new_o

        p, o = f64(params), obs
        v = j_sgd_init(p)
        losses = []
        grad_fn = jax.jit(jax.value_and_grad(sloss, has_aux=True))
        for x, oh in list(zip(xs, ohs))[1:student_steps + 1]:
            (loss, o), g = grad_fn(p, o, jnp.asarray(x), jnp.asarray(oh))
            p, v = j_sgd_update(p, g, v, 0.01)
            losses.append(float(loss))
        return (float(tl), jax.tree.map(np.asarray, tp), losses,
                *jax.tree.map(np.asarray, (p, o)))


def port_distill(params, tparams, xs, ohs, student_steps):
    teacher = LeNetFP32()
    teacher.load_params(tparams)
    teacher.double()
    tl = float(qat_train.make_teacher_step(teacher)(t(xs[0]), t(ohs[0])))
    tp = teacher.params_numpy()
    student = load_qat_params(LeNetQAT().double(), params)
    sstep = qat_train.make_distill_step(student, teacher)
    losses = [float(sstep(t(x), t(oh))) for x, oh in list(zip(xs, ohs))[1:student_steps + 1]]
    assert all(np.array_equal(a[k], b[k]) for a, b in zip(tp.values(),
               teacher.params_numpy().values()) for k in a)  # the student leaves the teacher
    return (tl, tp, losses, *export_qat_params(student))


def distill_inputs():
    params, obs = jax_init(1)
    tparams = jax.tree.map(np.asarray, JLeNetFP32().init(jax.random.PRNGKey(0)))
    return params, obs, tparams


@pytest.mark.parametrize("pixels,student_steps", [("raw", 1), ("normalised", STEPS)])
def test_distill_steps_match_jax(pixels, student_steps):
    """DistillTrainQuant's steps as the JAX CLI's: one teacher step
    (LeNetFP32, SGD at 0.05) and student steps (LeNetQAT, distill_loss T =
    20, alpha = 0.9, SGD at 0.01): both nets' params, the observers and the
    losses within 1e-9. On the demo's raw pixels one student step: its
    first step triples the convs' weights, the next batch's activations pass
    twice their observed ranges, and there the JAX package's
    straight-through value carries its conv's last bit (nn/qat.py), so its
    later steps cannot be repeated by another conv. STEPS student steps on
    normalised pixels, which stay inside their ranges."""
    params, obs, tparams = distill_inputs()
    xs, ohs = mnist_batches(6, student_steps + 1, normalise=pixels == "normalised")
    want = jax_distill(params, obs, tparams, xs, ohs, student_steps)
    got = port_distill(params, tparams, xs, ohs, student_steps)
    close(got[0], want[0])
    tree_close(got[1], want[1])
    close(got[2], want[2])
    tree_close(got[3], want[3])
    tree_close(got[4], want[4])
    assert not np.array_equal(got[3]["ip1"]["w"], params["ip1"]["w"])


def _conv_other_order(x, w):
    """A VALID conv summed tap by tap in reverse order: the same values as
    F.conv2d in another summation order, as another device's conv gives."""
    kh, kw = w.shape[2:]
    ho, wo = x.shape[2] - kh + 1, x.shape[3] - kw + 1
    out = 0
    for i in reversed(range(kh)):
        for j in reversed(range(kw)):
            out = out + torch.einsum("bchw,oc->bohw", x[:, :, i:i + ho, j:j + wo], w[:, :, i, j])
    return out


def test_distill_steps_do_not_depend_on_the_conv_summation_order(monkeypatch):
    """The demo's raw-pixel distillation for STEPS student steps, with the
    fake-quant convs summed in another order: within 1e-9 of the normal
    run (the card against the CPU rests on this)."""
    params, _, tparams = distill_inputs()
    xs, ohs = mnist_batches(6, STEPS + 1, normalise=False)
    normal = port_distill(params, tparams, xs, ohs, STEPS)
    monkeypatch.setattr(tqat.F, "conv2d", _conv_other_order)
    other = port_distill(params, tparams, xs, ohs, STEPS)
    close(other[2], normal[2])
    tree_close(other[3], normal[3])
    tree_close(other[4], normal[4])
    assert not np.array_equal(other[3]["conv1"]["w"], normal[3]["conv1"]["w"])  # other bits


def test_dropout_keep_rate_scale_and_seed():
    x = torch.ones((64, 1, 1, 500), dtype=torch.float64)
    out = tlenet_qat.dropout(x, torch.Generator().manual_seed(7))
    assert set(torch.unique(out).tolist()) == {0.0, 2.0}
    keep = float((out != 0).double().mean())
    assert abs(keep - 0.5) < 0.01
    again = tlenet_qat.dropout(x, torch.Generator().manual_seed(7))
    assert torch.equal(out, again)
    assert not torch.equal(out, tlenet_qat.dropout(x, torch.Generator().manual_seed(8)))
    # in the model: a generator drops units of ip1's output, none means no dropout
    params, _ = jax_init()
    xs, _ = mnist_batches(9, 1)
    runs = []
    for gen in (None, None, torch.Generator().manual_seed(7)):
        model = load_qat_params(LeNetQAT().double(), params)
        with torch.no_grad():
            runs.append(model(t(xs[0]), generator=gen))
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def test_demos_on_the_cpu(monkeypatch, capsys):
    """MnistInt8Train and DistillTrainQuant through the port's CLI, one
    epoch on the CPU on a small synthetic set: the lines the JAX CLI
    prints."""
    import importlib.util
    from pathlib import Path

    from mandheling_tpu_torch.data import synthetic_mnist

    path = Path(__file__).resolve().parents[1] / "tools" / "run_train_demo_torch.py"
    spec = importlib.util.spec_from_file_location("run_train_demo_torch", path)
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    monkeypatch.setattr(cli, "_data", lambda root: (synthetic_mnist(256, seed=0),
                                                    synthetic_mnist(128, seed=1)))
    cli.main(["MnistInt8Train", "--epochs", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and all(re.fullmatch(
        rf"epoch {i}: loss \d+\.\d{{4}} test_acc \d\.\d{{4}}", ln) for i, ln in enumerate(out)), out
    cli.main(["DistillTrainQuant", "--epochs", "1", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "teacher pre-trained (1 epoch)"
    assert re.fullmatch(r"epoch 0: distill_loss \d+\.\d{4} student_test_acc \d\.\d{4}",
                        out[-1]), out
