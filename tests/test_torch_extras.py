"""The port's int8 softmax and matmul ops, float losses, ADAM and learning-
rate schedules, calibration and `quantize_params_tree` against the JAX
package's, on inputs made from a numpy seed.

Tolerances: the integer ops byte for byte; the losses and ADAM in float64
within 1e-9 relative to the largest magnitude (ADAM's bias corrections are
float32 on both sides); the schedules, which the JAX package computes in
float32, within float32's precision (test_lr_schedules_match_jax); calibration (numpy on both sides) and
`quantize_params_tree` exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mandheling_tpu.ops import matmul as jmatmul
from mandheling_tpu.ops import softmax as jsoftmax
from mandheling_tpu.ops.kernels import use_backend as j_use_backend
from mandheling_tpu.train import losses as jlosses
from mandheling_tpu.train import optim as joptim
from mandheling_tpu.utils import calibration as jcal
from mandheling_tpu.utils.checkpoint import quantize_params_tree as j_quantize_params_tree
from mandheling_tpu_torch import ops as tops
from mandheling_tpu_torch.ops import matmul as tmatmul
from mandheling_tpu_torch.ops import softmax as tsoftmax
from mandheling_tpu_torch.ops.kernels import use_backend
from mandheling_tpu_torch.train import losses as tlosses
from mandheling_tpu_torch.train import optim as toptim
from mandheling_tpu_torch.utils import calibration as tcal
from mandheling_tpu_torch.utils.checkpoint import quantize_params_tree


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


def eq(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def close(got, want, tol=1e-9):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(np.asarray(got) - want).max()) <= tol * scale


def test_ops_export_softmax_and_matmul():
    assert tops.softmax is tsoftmax and tops.matmul is tmatmul


@pytest.mark.parametrize("ascale", range(-12, 18))  # -9..15 after the clamp, and past it
def test_softmax_forward_byte_equal(ascale):
    rng = np.random.default_rng(ascale + 100)
    x = rng.integers(-128, 128, (64, 12)).astype(np.int8)
    x[0] = -128  # a row of equal minima
    x[1] = 127
    want = jsoftmax.softmax_int8_forward(jnp.asarray(x), jnp.int32(ascale))
    eq(tsoftmax.softmax_int8_forward(t(x), torch.tensor(ascale, dtype=torch.int32)), want)


def test_softmax_grad_truncates_to_the_low_byte():
    rng = np.random.default_rng(1)
    up = rng.integers(-2**31, 2**31, (64, 12), dtype=np.int64).astype(np.int32)
    up[0, :4] = [127, 128, -129, 255]
    eq(tsoftmax.softmax_grad_int8(t(up)), jsoftmax.softmax_grad_int8(jnp.asarray(up)))


# the fc shapes of the slice: LeNet's 832->500 and 500->12, MobileNetV2's
# 1280->12, a ragged one, and a K whose sums wrap past 2^31
MATMUL_SHAPES = [(64, 832, 500), (64, 500, 12), (32, 1280, 12), (7, 33, 5), (3, 140000, 2)]


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_matmul_ops_byte_equal(m, k, n, backend):
    rng = np.random.default_rng(m + k + n)
    if k > 100000:
        a = np.full((m, k), -128, np.int8)
        b = np.full((k, n), -128, np.int8)
    else:
        a = rng.integers(-128, 128, (m, k)).astype(np.int8)
        b = rng.integers(-128, 128, (k, n)).astype(np.int8)
    a_exp, b_exp = np.int32(-7), np.int32(-5)
    with j_use_backend("xla"):
        acc_j = jmatmul.matmul_int8_acc(jnp.asarray(a), jnp.asarray(b))
        grad_j = jmatmul.matmul_int8_grad(jnp.asarray(a), jnp.asarray(b))
        y_j, e_j = jmatmul.matmul_int8_forward(jnp.asarray(a), jnp.asarray(a_exp),
                                               jnp.asarray(b), jnp.asarray(b_exp))
    with use_backend(backend):
        eq(tmatmul.matmul_int8_acc(t(a), t(b)), acc_j)
        eq(tmatmul.matmul_int8_grad(t(a), t(b)), grad_j)
        y, e = tmatmul.matmul_int8_forward(t(a), t(a_exp), t(b), t(b_exp))
    eq(y, y_j)
    eq(e, e_j)


def test_matmul_grad_all_zero_and_cross_replica():
    a = torch.zeros((4, 8), dtype=torch.int8)
    b = torch.ones((8, 3), dtype=torch.int8)
    assert not tmatmul.matmul_int8_grad(a, b).any()
    with pytest.raises(NotImplementedError):
        tmatmul.matmul_int8_forward(a, torch.tensor(0), b, torch.tensor(0), axis_name="data")


def test_losses_match_jax_in_float64():
    rng = np.random.default_rng(2)
    s, tl = rng.normal(0, 3, (8, 10)), rng.normal(0, 3, (8, 10))
    oh = np.eye(10)[rng.integers(0, 10, 8)]
    probs, target = jax.nn.softmax(jnp.asarray(s)), jax.nn.softmax(jnp.asarray(tl))
    pm = np.asarray(probs).copy()
    pm[0, 0] = 0.0  # a zero probability meets the 1e-20 floor
    signs = np.sign(rng.normal(size=(8, 10)))
    with jax.enable_x64(True):
        cases = [
            (tlosses.cross_entropy, jlosses.cross_entropy, pm, oh),
            (tlosses.cross_entropy_with_logits, jlosses.cross_entropy_with_logits, s, oh),
            (tlosses.kl_divergence, jlosses.kl_divergence, pm, np.asarray(target)),
            (tlosses.mse, jlosses.mse, s, tl),
            (tlosses.mae, jlosses.mae, s, tl),
            (tlosses.hinge, jlosses.hinge, s, signs),
        ]
        for tfn, jfn, a, b in cases:
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            close(tfn(t(a), t(b)), jfn(jnp.asarray(a), jnp.asarray(b)))
            # and their gradients in the first argument
            ta = t(a).requires_grad_()
            (g,) = torch.autograd.grad(tfn(ta, t(b)), ta)
            close(g, jax.grad(jfn)(jnp.asarray(a), jnp.asarray(b)))
        for temp, alpha in ((20.0, 0.9), (1.0, 0.5)):
            want = jlosses.distill_loss(jnp.asarray(s), jnp.asarray(tl), jnp.asarray(oh), temp,
                                        alpha)
            ts = t(s).requires_grad_()
            got = tlosses.distill_loss(ts, t(tl), t(oh), temp, alpha)
            close(got.detach(), want)
            (g,) = torch.autograd.grad(got, ts)
            close(g, jax.grad(jlosses.distill_loss)(jnp.asarray(s), jnp.asarray(tl),
                                                      jnp.asarray(oh), temp, alpha))


@pytest.mark.parametrize("weight_decay", [0.0, 5e-4])
def test_adam_matches_jax_over_five_steps(weight_decay):
    rng = np.random.default_rng(3)
    w0 = [rng.normal(0, 1, (5, 7)), rng.normal(0, 1, (7,))]
    grads = [[rng.normal(0, 1, w.shape) for w in w0] for _ in range(5)]
    with jax.enable_x64(True):
        params = [jnp.asarray(w) for w in w0]
        state = joptim.adam_init(params)
        for g in grads:
            params, state = joptim.adam_update(params, [jnp.asarray(x) for x in g], state, 1e-2,
                                               weight_decay=weight_decay)
        want = [np.asarray(p) for p in params]
        want_m = [np.asarray(m) for m in state["m"]]
        want_t = int(state["t"])
    tparams = [t(w) for w in w0]
    tstate = toptim.adam_init(tparams)
    assert tstate["t"].dtype == torch.int32
    for g in grads:
        toptim.adam_update(tparams, [t(x) for x in g], tstate, 1e-2, weight_decay=weight_decay)
    for got, w in zip(tparams, want):
        close(got, w)
    for got, w in zip(tstate["m"], want_m):
        close(got, w)
    assert int(tstate["t"]) == want_t == 5


@pytest.mark.parametrize("step", [0, 1, 999, 1000, 12345])
def test_lr_schedules_match_jax(step):
    """The port computes the schedules in double precision, the JAX package
    in float32: lr_exp's gamma^step carries float32's rounding of gamma (at
    most 3e-8 relative) times the step, beside float32's own 1e-6; below
    float32's least denormal (1.4e-45) the JAX value is 0."""
    rtol_exp = 1e-6 + 3e-8 * step
    for gamma in (0.999, 0.9):
        np.testing.assert_allclose(toptim.lr_exp(0.1, step, gamma),
                                   float(joptim.lr_exp(0.1, step, gamma)), rtol=rtol_exp,
                                   atol=1.4e-45)
    for milestones in ([1000], [1, 1000, 5000]):
        np.testing.assert_allclose(toptim.lr_multistep(0.1, step, milestones),
                                   float(joptim.lr_multistep(0.1, step, milestones)), rtol=1e-6)
    np.testing.assert_allclose(toptim.lr_inv(0.01, step), float(joptim.lr_inv(0.01, step)),
                               rtol=1e-6)


def test_calibration_copy_is_exact():
    rng = np.random.default_rng(4)
    batches = [rng.normal(0, 1, (16, 8)).astype(np.float32) for _ in range(3)]
    batches[1][0, 0] = 9.0  # an outlier the KL search clips
    for num_bins in (256, 2048):
        hist_t, mx_t = tcal.collect_histogram(batches, num_bins)
        hist_j, mx_j = jcal.collect_histogram(batches, num_bins)
        np.testing.assert_array_equal(hist_t, hist_j)
        assert mx_t == mx_j
    assert tcal.kl_threshold(hist_t[:256], mx_t) == jcal.kl_threshold(hist_j[:256], mx_j)
    assert tcal.mse_scale(batches) == jcal.mse_scale(batches)
    acts = {"a": batches, "zero": [np.zeros((4,), np.float32)]}
    for method in ("KL", "MSE"):
        assert tcal.calibrate_activations(acts, method) == jcal.calibrate_activations(acts, method)
    with pytest.raises(ValueError):
        tcal.calibrate_activations(acts, "ADMM")
    w = rng.normal(0, 0.1, (3, 3, 4, 6)).astype(np.float32)
    for per_channel in (True, False):
        for got, want in zip(tcal.quantize_weight_maxabs(w, per_channel),
                             jcal.quantize_weight_maxabs(w, per_channel)):
            np.testing.assert_array_equal(got, want)
    for got, want in zip(tcal.quantize_weight_admm(w), jcal.quantize_weight_admm(w)):
        np.testing.assert_array_equal(got, want)


def test_quantize_params_tree_matches_jax():
    rng = np.random.default_rng(5)
    tree = {"conv1": {"w": rng.normal(0, 0.2, (5, 5, 1, 20)).astype(np.float32),
                      "b": rng.normal(0, 0.01, (20,)).astype(np.float32)},
            "ip": [rng.normal(0, 3, (8, 4)).astype(np.float32),
                   np.array([0.25, -1.0], np.float32)]}  # a power of two as the range
    got = quantize_params_tree(tree)
    want = j_quantize_params_tree(jax.tree.map(jnp.asarray, tree))
    got_leaves = [got["conv1"]["b"], got["conv1"]["w"], got["ip"][0], got["ip"][1]]
    want_leaves = [want["conv1"]["b"], want["conv1"]["w"], want["ip"][0], want["ip"][1]]
    for g, w in zip(got_leaves, want_leaves):
        eq(g.data, w.data)
        eq(g.exp, w.exp)
    # torch tensors are taken as well
    q = quantize_params_tree([torch.from_numpy(tree["ip"][0])])[0]
    eq(q.data, want["ip"][0].data)


def test_quan_by_mse_demo(tmp_path, capsys):
    """QuanByMSE through the port's CLI on the CPU: the JAX CLI's lines (its
    numbers differ: the float LeNet is drawn by torch); on a folder of
    images it calibrates on them (tests/test_torch_import_cli.py holds those
    lines to the JAX CLI's)."""
    import importlib.util
    import re
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "run_train_demo_torch.py"
    spec = importlib.util.spec_from_file_location("run_train_demo_torch", path)
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    cli.main(["QuanByMSE", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "calibrating on MNIST/synthetic batches"
    for method, ln in zip(("MSE", "KL"), out[2:4]):
        assert re.fullmatch(rf"{method} scales: input=\d+\.\d{{4}}, logits=\d+\.\d{{4}}", ln), ln
    for name, ln in zip(("maxabs", "admm"), out[4:6]):
        assert re.fullmatch(rf"weight PTQ \({name}\): mean \|recon err\| per conv layer: "
                            r"(\d\.\d{5}, ){3}\d\.\d{5}", ln), ln
    from PIL import Image

    Image.fromarray(np.full((30, 30, 3), 200, np.uint8)).save(tmp_path / "a.png")
    cli.main(["QuanByMSE", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"calibrating on 1 images from {tmp_path}"
    for method, ln in zip(("MSE", "KL"), out[1:3]):
        assert re.fullmatch(rf"{method} scales: input=\d+\.\d{{4}}, logits=\d+\.\d{{4}}", ln), ln
