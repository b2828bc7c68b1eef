"""The int16 operands: MobileNetV2 with int16 projection outputs
(``proj_bits=15``) and the products that read them, int16 x int8 -> int32.

On the card these go to K1's int16-A route; here, on CPU tensors, to its
plain version (float64, exact, then the int32 wrap). Both are held to the
JAX package, which computes these products in XLA with int32 accumulation
(``mandheling_tpu/ops/kernels/dispatch.py:72-86``): the same int32 at the
extremes of both types and where the sums wrap past 2^31 and 2^32, the same
conv forwards and filter grads on an int16 x, and a MobileNetV2 at width 0.5
with ``proj_bits=15`` trained to byte-identical params."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mandheling_tpu.models import mobilenet_v2_niti as j_mobilenet_v2_niti
from mandheling_tpu.ops import conv as jconv
from mandheling_tpu.ops.kernels import dispatch as jdispatch
from mandheling_tpu.train import make_eval_step as j_make_eval_step
from mandheling_tpu.train import make_train_step as j_make_train_step
from mandheling_tpu_torch.data import onehot_padded, synthetic_cifar
from mandheling_tpu_torch.models import MOBILENET_V2_NITI_LOGITS, mobilenet_v2_niti
from mandheling_tpu_torch.ops import conv as tconv
from mandheling_tpu_torch.ops.kernels import dispatch
from mandheling_tpu_torch.ops.kernels import matmul_int8 as tmm
from mandheling_tpu_torch.ops.kernels import use_backend
from mandheling_tpu_torch.train import make_eval_step, make_train_step
from mandheling_tpu_torch.train.trainer import train_niti
from mandheling_tpu_torch.utils.jax_params import export_jax_params, flat_weights, load_jax_params


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test runners share the machine's cores among
    several processes, where torch's spinning thread pool slows tiny ops by
    orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.asarray(jdispatch.matmul_acc(jnp.asarray(a), jnp.asarray(b)))


# (what, A's values, B's values, M, K, N): random over both full ranges, the
# extremes, and sums that wrap past 2^31 (600 x 2^22) and past 2^32 (1030 x
# 2^22), with both signs
EXTREMES = [
    ("random", None, None, 37, 300, 29),
    ("32767 x 127", 32767, 127, 5, 516, 7),
    ("32767 x 127, past 2^31", 32767, 127, 5, 517, 7),
    ("-32768 x -128, past 2^31", -32768, -128, 4, 600, 3),
    ("-32768 x 127, past 2^32", -32768, 127, 3, 1030, 5),
    ("+-32767 x -128", "alt", -128, 6, 2049, 4),
]


@pytest.mark.parametrize("what,a_val,b_val,m,k,n", EXTREMES, ids=[e[0] for e in EXTREMES])
@pytest.mark.parametrize("a_t", [False, True])
def test_int16_plain_matches_jax_dot(what, a_val, b_val, m, k, n, a_t):
    """The plain version of K1's int16-A route, in both of K1's layouts
    (A K-major; A an MN-major transposed view), equals the JAX package's
    int16 x int8 dot, the int32 wrap of the exact sum."""
    rng = np.random.default_rng(3)
    if a_val is None:
        a = rng.integers(-32768, 32768, (m, k), dtype=np.int16)
        b = rng.integers(-128, 128, (k, n), dtype=np.int8)
    else:
        a = np.full((m, k), a_val if a_val != "alt" else 0, np.int16)
        if a_val == "alt":
            a[:, 0::2], a[:, 1::2] = 32767, -32767
            a[:, -1] = -32768
        b = np.full((k, n), b_val, np.int8)
    ta = torch.from_numpy(np.ascontiguousarray(a.T)).t() if a_t else torch.from_numpy(a)
    assert ta.is_contiguous() != a_t
    got = tmm.matmul_acc_plain(ta, torch.from_numpy(b)).numpy()
    want = jax_matmul(a, b)
    np.testing.assert_array_equal(got, want)
    exact = a.astype(np.int64) @ b.astype(np.int64)
    np.testing.assert_array_equal(got, ((exact + 2**31) % 2**32 - 2**31).astype(np.int32))
    if what.endswith("2^31") or what.endswith("2^32"):
        assert np.abs(exact).max() >= 2**31


def test_split_bytes_recombines_every_int16():
    """The route's byte planes: a = 256 hi + lo for every int16 value, hi
    signed, lo unsigned, each plane in a's own layout."""
    a = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).reshape(256, 256)
    for view in (a, a.t()):
        hi, lo = tmm.split_bytes(view)
        assert hi.dtype == torch.int8 and lo.dtype == torch.uint8
        assert hi.stride() == lo.stride() == view.stride()
        assert torch.equal(hi.to(torch.int32) * 256 + lo.to(torch.int32), view.to(torch.int32))
    hi, lo = tmm.split_bytes(a[:, ::2])  # not dense: planes of a contiguous copy
    assert hi.is_contiguous() and lo.is_contiguous()


def test_int16_route_plans_one_warpgroup():
    """The int16-A route's K-major plan keeps one warpgroup a block (its
    CUDA instances), where the int8 route would take two; the MN-major plan
    is the int8 one."""
    m, k, n = 262144, 16, 96
    assert tmm.plan(m, k, n, (k, 1), (n, 1)).warps == 2
    assert tmm.plan(m, k, n, (k, 1), (n, 1), wide=True).warps == 1
    assert tmm.plan(16, 262144, 96, (1, 16), (96, 1), wide=True) == \
        tmm.plan(16, 262144, 96, (1, 16), (96, 1))


def test_dispatch_types():
    """int8 or int16 A against an int8 B on both backends, equal; an int16 B
    or an int32 A is refused, as is an int16 A for the int8 entry of the
    kernel, and a CPU tensor for the route's CUDA entry."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(-32768, 32768, (9, 40), dtype=np.int16))
    b = torch.from_numpy(rng.integers(-128, 128, (40, 6), dtype=np.int8))
    got = dispatch.matmul_acc(a, b)
    with use_backend("torch"):
        assert torch.equal(dispatch.matmul_acc(a, b), got)
    np.testing.assert_array_equal(got.numpy(), jax_matmul(a.numpy(), b.numpy()))
    for x, y in ((a, b.to(torch.int16)), (a.to(torch.int32), b)):
        with pytest.raises(TypeError):
            dispatch.matmul_acc(x, y)
    with pytest.raises(TypeError):
        tmm.matmul_acc_cuda(a, b)
    with pytest.raises(ValueError):
        tmm.matmul_acc_int16_cuda(a, b)


@pytest.mark.parametrize("kernel,stride,padding", [((1, 1), (1, 1), "VALID"),
                                                    ((3, 3), (2, 2), "SAME"),
                                                    ((1, 3), (1, 1), "SAME")])
@pytest.mark.parametrize("mode", ["matmul_only", "all"])
def test_int16_conv_forward_and_filter_grad_match_jax(kernel, stride, padding, mode):
    """A conv on an int16 x (full range): the forward (int8 and, with
    out_bits=15, int16 outputs) and the filter grad equal the JAX
    package's. No fused kernel takes an int16 x or an int16 output, in
    either fused mode."""
    rng = np.random.default_rng(7)
    x = rng.integers(-32768, 32768, (2, 9, 9, 24), dtype=np.int16)
    w = rng.integers(-128, 128, kernel + (24, 16), dtype=np.int8)
    x_exp, w_exp = np.int32(-12), np.int32(-7)
    calls = []
    with tconv.use_fused_conv_mode(mode):
        for out_bits in (7, 15):
            y, e = tconv.conv2d_forward(torch.from_numpy(x), torch.tensor(x_exp),
                                        torch.from_numpy(w), torch.tensor(w_exp), stride,
                                        padding, out_bits=out_bits)
            yj, ej = jconv.conv2d_forward(jnp.asarray(x), jnp.asarray(x_exp), jnp.asarray(w),
                                          jnp.asarray(w_exp), stride, padding,
                                          out_bits=out_bits)
            assert y.dtype == (torch.int8 if out_bits == 7 else torch.int16)
            np.testing.assert_array_equal(y.numpy(), np.asarray(yj))
            assert int(e) == int(ej)
            calls.append(y)
        gy = rng.integers(-128, 128, tuple(calls[0].shape), dtype=np.int8)
        gw = tconv.conv2d_filter_grad(torch.from_numpy(x), torch.from_numpy(gy), kernel, stride,
                                      padding)
    gwj = jconv.conv2d_filter_grad(jnp.asarray(x), jnp.asarray(gy), kernel, stride, padding)
    np.testing.assert_array_equal(gw.numpy(), np.asarray(gwj))
    with pytest.raises(ValueError, match="int8-only"):
        tconv.conv2d_forward(torch.from_numpy(x), torch.tensor(x_exp), torch.from_numpy(w),
                             torch.tensor(w_exp), stride, padding, act="relu6", out_bits=15)


STEPS, BATCH = 2, 4


def to_numpy(params):
    if isinstance(params, list):
        return [to_numpy(p) for p in params]
    if not params:
        return ()
    return {"w": (np.asarray(params["w"].data), np.asarray(params["w"].exp))}


@pytest.fixture(scope="module")
def mnv2_p15_jax():
    """MobileNetV2 width 0.5, proj_bits=15, in the JAX package (XLA): the
    start params, the batches, losses, final params and the eval step's
    correct count."""
    x, y = synthetic_cifar(STEPS * BATCH, seed=2)
    xs = [x[i * BATCH:(i + 1) * BATCH].astype(np.float32) for i in range(STEPS)]
    ohs = [onehot_padded(y[i * BATCH:(i + 1) * BATCH], 10, MOBILENET_V2_NITI_LOGITS)
           for i in range(STEPS)]
    labels = y[:BATCH].astype(np.int64)
    model = j_mobilenet_v2_niti(width_mult=0.5, proj_bits=15)
    params = model.init(jax.random.PRNGKey(4))
    start = to_numpy(params)
    step = jax.jit(j_make_train_step(model))
    losses = []
    for xb, oh in zip(xs, ohs):
        params, loss = step(params, jnp.asarray(xb), jnp.asarray(oh))
        losses.append(float(loss))
    correct = int(jax.jit(j_make_eval_step(model))(params, jnp.asarray(xs[0]),
                                                  jnp.asarray(labels)))
    return start, (xs, ohs, labels), losses, to_numpy(params), correct


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_mnv2_proj15_steps_byte_identical_to_jax(mnv2_p15_jax, backend):
    """MobileNetV2 at width 0.5 with int16 projection outputs: two train
    steps and an eval step from the JAX package's params give its params,
    byte for byte, its losses and its correct count; the int16-A products
    ran (17 a train step at this width, as at full width)."""
    start, (xs, ohs, labels), losses_j, final_j, correct_j = mnv2_p15_jax
    model = load_jax_params(mobilenet_v2_niti(width_mult=0.5, proj_bits=15), start)
    step = make_train_step(model)
    seen = []
    real = tmm.matmul_acc_plain

    def counted(a, b):
        seen.append(a.dtype)
        return real(a, b)
    tmm.matmul_acc_plain = counted
    try:
        with use_backend(backend):
            losses = [float(step(torch.from_numpy(x), torch.from_numpy(oh)))
                      for x, oh in zip(xs, ohs)]
            correct = int(make_eval_step(model)(torch.from_numpy(xs[0]),
                                                torch.from_numpy(labels)))
    finally:
        tmm.matmul_acc_plain = real
    got, want = flat_weights(export_jax_params(model)), flat_weights(final_j)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(losses, losses_j, rtol=1e-6, atol=0)
    assert correct == correct_j
    assert seen.count(torch.int16) == STEPS * 34 + 17


def test_trainer_runs_mnv2_proj15_on_the_cpu():
    """train_niti(model=mobilenet_v2_niti(proj_bits=15)) trains through the
    same loop; backends "cuda" (plain versions on CPU tensors) and "torch"
    agree, and the params move."""
    tr, te = synthetic_cifar(2 * BATCH, seed=3), synthetic_cifar(BATCH, seed=4)
    runs = []
    for backend in ("cuda", "torch"):
        model, acc = train_niti(tr, te, epochs=1, batch=BATCH, seed=0, log=lambda _: None,
                                device="cpu", backend=backend,
                                model=mobilenet_v2_niti(width_mult=0.25, proj_bits=15))
        runs.append((flat_weights(export_jax_params(model)), acc))
    start = flat_weights(export_jax_params(
        mobilenet_v2_niti(width_mult=0.25, proj_bits=15).reset_parameters(
            torch.Generator().manual_seed(0))))
    for a, b in zip(runs[0][0], runs[1][0]):
        np.testing.assert_array_equal(a, b)
    assert runs[0][1] == runs[1][1]
    assert any(not np.array_equal(a, b) for a, b in zip(runs[0][0], start))
