"""K8 (ops/kernels/pool_concat_int8.py), the max pool, the zero-padded
average pool and the exponent-aligned channel concat: its plain versions
against the JAX package's ops, byte for byte, at every pool and concat
shape of Inception-v3 at batch 2 (the 75x75 network and each module alone)
and at hand-made edges (odd sizes, planted ties, extremes, negative values
at truncation, unequal exponents, a nested concat); the forms the kernel
takes; and every routed site, with the launches stubbed by the plain
versions, calling K8 and giving the bytes it gave before."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import mandheling_tpu.nn.blocks as jblocks
from mandheling_tpu.ops import depthwise as jdw
from mandheling_tpu.ops import eltwise as jelt
from mandheling_tpu.ops import pool as jpool
from mandheling_tpu.ops.qtensor import QTensor as JQ
import mandheling_tpu_torch.nn.blocks as tblocks
from mandheling_tpu_torch.models import inception as tinception
from mandheling_tpu_torch.models import inceptionv3_niti, lenet_niti, squeezenet_niti
from mandheling_tpu_torch.ops import depthwise as tdw
from mandheling_tpu_torch.ops import eltwise as telt
from mandheling_tpu_torch.ops import kernels
from mandheling_tpu_torch.ops import pool as tpool
from mandheling_tpu_torch.ops.kernels import dispatch
from mandheling_tpu_torch.ops.kernels import pool_concat_int8 as pc
from mandheling_tpu_torch.ops.qtensor import QTensor
from mandheling_tpu_torch.train import make_train_step
from mandheling_tpu_torch.utils import device_trace

KINDS = ("maxpool", "maxpool_grad", "avgpool", "avgpool_grad", "concat")

# each Inception module alone at batch 2, its widths in the full network
MODULES = {"a": ("_inception_a", (192, 32), (2, 7, 7, 192)),
           "b": ("_inception_b", (288,), (2, 9, 9, 288)),
           "c": ("_inception_c", (768, 128), (2, 5, 5, 768)),
           "d": ("_inception_d", (768,), (2, 7, 7, 768)),
           "e": ("_inception_e", (1280,), (2, 3, 3, 1280))}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t8(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int8))


def i32(v):
    return torch.tensor(v, dtype=torch.int32)


def draw(shape, flavor, rng):
    """int8 values: "random" over the whole range, "ties" from four values
    (every window holds ties), "extremes" from the rails and zero."""
    if flavor == "random":
        return rng.integers(-128, 128, shape).astype(np.int8)
    pick = [-2, 0, 1, 5] if flavor == "ties" else [-128, -127, 0, 127]
    return rng.choice(np.array(pick, dtype=np.int8), shape)


def _record(monkeypatch):
    """Record the site of every K8 dispatch call: {kind: [key]}."""
    sites = collections.defaultdict(list)
    keys = {"maxpool": lambda x, window, stride: (tuple(x.shape), tuple(window), tuple(stride)),
            "maxpool_grad": lambda x, y, gy, window, stride: (tuple(x.shape), tuple(window),
                                                              tuple(stride)),
            "avgpool": lambda x, window, stride, pad=0: (tuple(x.shape), tuple(window),
                                                         tuple(stride), pad),
            "avgpool_grad": lambda gy, xs, window, stride, pad=0: (
                tuple(gy.shape), tuple(xs), tuple(window), tuple(stride), pad),
            "concat": lambda datas, exps: tuple(tuple(d.shape) for d in datas)}
    for kind in KINDS:
        real = getattr(pc, kind)

        def rec(*a, _kind=kind, _real=real, **k):
            sites[_kind].append(keys[_kind](*a, **k))
            return _real(*a, **k)
        monkeypatch.setattr(pc, kind, rec)
    return sites


def _step(model, shape, n_logits, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32))
    oh = torch.zeros((shape[0], n_logits), dtype=torch.int32)
    oh[torch.arange(shape[0]), torch.from_numpy(rng.integers(0, 10, shape[0]))] = 1
    make_train_step(model)(x, oh)


@pytest.fixture(scope="module")
def inception_sites():
    """The distinct K8 sites of a train step of Inception-v3 at 75x75 and of
    each module alone's forward and backward, batch 2."""
    mp = pytest.MonkeyPatch()
    try:
        sites = _record(mp)
        model = inceptionv3_niti(num_classes=10)
        model.reset_parameters(torch.Generator().manual_seed(0))
        _step(model, (2, 75, 75, 3), 12)
        for ctor, args, shape in MODULES.values():
            layer = getattr(tinception, ctor)(*args)
            layer.reset_parameters(torch.Generator().manual_seed(1))
            q = QTensor(t8(draw(shape, "random", np.random.default_rng(2))), i32(-3))
            y, res = layer.fwd(q)
            layer.bwd(res, t8(draw(tuple(y.data.shape), "random", np.random.default_rng(3))))
    finally:
        mp.undo()
    return {k: sorted(set(v)) for k, v in sites.items()}


def test_the_inception_sites(inception_sites):
    """The 75x75 network's 4 max pools (3x3/2), its 9 pad-1 average pools
    and its 15 concats, with the modules alone, reach every kind."""
    assert set(inception_sites) == set(KINDS)
    assert {k[1:] for k in inception_sites["maxpool"]} == {((3, 3), (2, 2))}
    assert {k[1:] for k in inception_sites["avgpool"]} == {((3, 3), (1, 1), 1)}
    assert max(len(k) for k in inception_sites["concat"]) == 4
    assert min(len(k) for k in inception_sites["concat"]) == 2  # module E's split 3x3


FLAVORS = ["random", "ties", "extremes"]


@pytest.mark.parametrize("flavor", FLAVORS)
def test_maxpool_plain_is_jax_at_inception_sites(inception_sites, flavor):
    rng = np.random.default_rng(10)
    for shape, window, stride in inception_sites["maxpool"]:
        x = draw(shape, flavor, rng)
        y_j, e_j = jpool.maxpool2d(jnp.asarray(x), jnp.int32(-4), window, stride)
        np.testing.assert_array_equal(pc.maxpool_plain(t8(x), window, stride).numpy(),
                                      np.asarray(y_j))
        y_t, e_t = tpool.maxpool2d(t8(x), i32(-4), window, stride)
        np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
        assert int(e_t) == int(e_j) == -4


@pytest.mark.parametrize("flavor", FLAVORS)
def test_maxpool_grad_plain_is_jax_at_inception_sites(inception_sites, flavor):
    rng = np.random.default_rng(11)
    for shape, window, stride in inception_sites["maxpool_grad"]:
        x = draw(shape, flavor, rng)
        y = pc.maxpool_plain(t8(x), window, stride)
        gy = draw(tuple(y.shape), flavor, rng)
        want = np.asarray(jpool.maxpool2d_grad(jnp.asarray(x), jnp.asarray(y.numpy()),
                                               jnp.asarray(gy), window, stride))
        np.testing.assert_array_equal(pc.maxpool_grad_plain(t8(x), y, t8(gy), window,
                                                            stride).numpy(), want)
        np.testing.assert_array_equal(tpool.maxpool2d_grad(t8(x), y, t8(gy), window,
                                                           stride).numpy(), want)


def _jax_avgpool(x, window, stride, pad):
    return np.asarray(jdw.avgpool2d_int8(jelt.pad_int8(jnp.asarray(x), pad) if pad else
                                         jnp.asarray(x), jnp.int32(0), window, stride)[0])


def _jax_avgpool_grad(gy, x_spatial, window, stride, pad):
    h, w = x_spatial
    g = np.asarray(jdw.avgpool2d_grad(jnp.asarray(gy), (h + 2 * pad, w + 2 * pad), window,
                                      stride))
    return g[:, pad:pad + h, pad:pad + w, :]


@pytest.mark.parametrize("flavor", FLAVORS)
def test_avgpool_plain_is_jax_at_inception_sites(inception_sites, flavor):
    rng = np.random.default_rng(12)
    for shape, window, stride, pad in inception_sites["avgpool"]:
        x = draw(shape, flavor, rng)
        want = _jax_avgpool(x, window, stride, pad)
        np.testing.assert_array_equal(pc.avgpool_plain(t8(x), window, stride, pad).numpy(), want)
        np.testing.assert_array_equal(
            tdw.avgpool2d_int8(t8(x), i32(2), window, stride, pad=pad)[0].numpy(), want)


@pytest.mark.parametrize("flavor", FLAVORS)
def test_avgpool_grad_plain_is_jax_at_inception_sites(inception_sites, flavor):
    rng = np.random.default_rng(13)
    for gy_shape, x_spatial, window, stride, pad in inception_sites["avgpool_grad"]:
        gy = draw(gy_shape, flavor, rng)
        want = _jax_avgpool_grad(gy, x_spatial, window, stride, pad)
        assert pc.supports_avgpool_grad(t8(gy), x_spatial, window, stride, pad)
        np.testing.assert_array_equal(
            pc.avgpool_grad_plain(t8(gy), x_spatial, window, stride, pad).numpy(), want)


@pytest.mark.parametrize("exps", ["equal", "unequal"])
@pytest.mark.parametrize("flavor", FLAVORS)
def test_concat_plain_is_jax_at_inception_sites(inception_sites, flavor, exps):
    rng = np.random.default_rng(14)
    for shapes in inception_sites["concat"]:
        datas = [draw(s, flavor, rng) for s in shapes]
        es = ([-3] * len(shapes) if exps == "equal"
              else [int(v) for v in rng.integers(-9, 4, len(shapes))])
        y_j, e_j = jelt.concat_int8([jnp.asarray(d) for d in datas], [jnp.int32(e) for e in es])
        y_t, e_t = pc.concat_plain([t8(d) for d in datas], [i32(e) for e in es])
        np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
        assert int(e_t) == int(e_j) == max(es)
        y_o, e_o = telt.concat_int8([t8(d) for d in datas], [i32(e) for e in es])
        assert torch.equal(y_o, y_t) and int(e_o) == int(e_t)


# (shape, window, stride): odd sizes, overlapping and disjoint, a window
# of one row
POOLS = [((2, 9, 11, 5), (3, 3), (2, 2)), ((1, 7, 7, 3), (2, 2), (2, 2)),
         ((2, 8, 8, 4), (3, 3), (1, 1)), ((1, 10, 9, 16), (3, 2), (2, 3)),
         ((3, 5, 6, 2), (1, 3), (1, 2)), ((1, 13, 13, 64), (3, 3), (2, 2))]


@pytest.mark.parametrize("shape,window,stride", POOLS, ids=lambda v: str(v))
@pytest.mark.parametrize("flavor", FLAVORS)
def test_maxpool_plain_is_jax_at_edges(shape, window, stride, flavor):
    rng = np.random.default_rng(20)
    x = draw(shape, flavor, rng)
    y = pc.maxpool_plain(t8(x), window, stride)
    y_j, _ = jpool.maxpool2d(jnp.asarray(x), jnp.int32(0), window, stride)
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_j))
    gy = draw(tuple(y.shape), flavor, rng)
    np.testing.assert_array_equal(
        pc.maxpool_grad_plain(t8(x), y, t8(gy), window, stride).numpy(),
        np.asarray(jpool.maxpool2d_grad(jnp.asarray(x), jnp.asarray(y.numpy()), jnp.asarray(gy),
                                        window, stride)))


def test_maxpool_grad_clips_overlaps_but_not_disjoint_windows():
    """Every value a tie: each 3x3/2 window sends gy to its first position.
    One maximum shared by four windows takes the sum of their gy, clipped
    (-400 to -127); 2x2/2 windows pass -128 through unclipped, as the
    chain gives it."""
    x = torch.zeros((1, 5, 5, 1), dtype=torch.int8)
    y = pc.maxpool_plain(x, (3, 3), (2, 2))
    g = pc.maxpool_grad_plain(x, y, torch.full_like(y, 127), (3, 3), (2, 2))
    assert g[0, :, :, 0].tolist() == [[127, 0, 127, 0, 0], [0] * 5, [127, 0, 127, 0, 0],
                                      [0] * 5, [0] * 5]
    x[0, 2, 2, 0] = 5
    y = pc.maxpool_plain(x, (3, 3), (2, 2))
    g = pc.maxpool_grad_plain(x, y, torch.full_like(y, -100), (3, 3), (2, 2))
    assert int(g[0, 2, 2, 0]) == -127 and int(g.abs().sum()) == 127
    x2 = torch.zeros((1, 4, 4, 1), dtype=torch.int8)
    y2 = pc.maxpool_plain(x2, (2, 2), (2, 2))
    g2 = pc.maxpool_grad_plain(x2, y2, torch.full_like(y2, -128), (2, 2), (2, 2))
    assert int(g2.min()) == -128


# (shape, window, stride, pad)
AVGPOOLS = [((2, 9, 11, 5), (3, 3), (1, 1), 1), ((1, 7, 7, 3), (2, 2), (2, 2), 0),
            ((2, 8, 8, 4), (3, 3), (2, 2), 1), ((1, 10, 9, 16), (5, 3), (1, 2), 2),
            ((1, 6, 6, 32), (3, 3), (1, 1), 0), ((2, 3, 3, 4), (3, 3), (1, 1), 1)]


@pytest.mark.parametrize("shape,window,stride,pad", AVGPOOLS, ids=lambda v: str(v))
@pytest.mark.parametrize("flavor", FLAVORS)
def test_avgpool_plain_is_jax_at_edges(shape, window, stride, pad, flavor):
    rng = np.random.default_rng(21)
    x = draw(shape, flavor, rng)
    y = pc.avgpool_plain(t8(x), window, stride, pad)
    np.testing.assert_array_equal(y.numpy(), _jax_avgpool(x, window, stride, pad))
    gy = draw(tuple(y.shape), flavor, rng)
    assert pc.supports_avgpool_grad(t8(gy), shape[1:3], window, stride, pad)
    np.testing.assert_array_equal(
        pc.avgpool_grad_plain(t8(gy), shape[1:3], window, stride, pad).numpy(),
        _jax_avgpool_grad(gy, shape[1:3], window, stride, pad))


def test_avgpool_truncates_toward_zero():
    """-8 / 9 is 0 and 17 / 9 is 1, each way."""
    x = torch.full((1, 3, 3, 2), -1, dtype=torch.int8)
    x[..., 1] = 2
    assert pc.avgpool_plain(x, (3, 3), (1, 1), 0).flatten().tolist() == [-1, 2]
    y = pc.avgpool_plain(x, (3, 3), (1, 1), 1)
    assert y[0, 0, 0].tolist() == [0, 0]  # -4 / 9 and 8 / 9 with the pad's zeros
    gy = torch.tensor([[[[-17, 17]]]], dtype=torch.int8)
    g = pc.avgpool_grad_plain(gy, (3, 3), (3, 3), (1, 1), 0)
    assert g[..., 0].unique().tolist() == [-1] and g[..., 1].unique().tolist() == [1]


def test_a_clamped_avgpool_grad_takes_the_plain_form():
    """A gy whose windows overrun the given input: the chain clamps the
    update's start, which K8 does not do, so it is not K8's form."""
    gy = t8(np.ones((1, 3, 3, 4)))
    assert pc.supports_avgpool_grad(gy, (3, 3), (1, 1), (1, 1))
    assert not pc.supports_avgpool_grad(gy, (3, 3), (2, 2), (1, 1))
    assert not pc.supports_avgpool_grad(gy.to(torch.int16), (5, 5), (3, 3), (1, 1))


def test_nested_concat_is_jax():
    """Module E's layout: a concat whose second branch is itself a concat,
    with unequal exponents at each level and negative values that the
    shift truncates toward zero."""
    rng = np.random.default_rng(22)
    a, b, c = (draw((2, 3, 3, n), "random", rng) for n in (4, 8, 12))
    b[0, 0, 0, :] = [-5, -1, -128, 3, 7, -7, 1, -2]
    inner_t = pc.concat_plain([t8(b), t8(c)], [i32(1), i32(4)])
    outer_t = pc.concat_plain([t8(a), inner_t[0]], [i32(-2), inner_t[1]])
    inner_j = jelt.concat_int8([jnp.asarray(b), jnp.asarray(c)], [jnp.int32(1), jnp.int32(4)])
    outer_j = jelt.concat_int8([jnp.asarray(a), inner_j[0]], [jnp.int32(-2), inner_j[1]])
    np.testing.assert_array_equal(outer_t[0].numpy(), np.asarray(outer_j[0]))
    assert int(outer_t[1]) == int(outer_j[1]) == 4
    # -5 >> 3 truncating is 0, -128 >> 3 is -16
    assert inner_t[0][0, 0, 0, :3].tolist() == [0, 0, -16]


@pytest.mark.parametrize("pad", [0, 1, 2])
def test_avgpool_layer_is_jax(pad):
    """NITIAvgPool, which pads inside K8's forms now, against the JAX
    layer that pads first and crops the gradient."""
    rng = np.random.default_rng(23 + pad)
    x = draw((2, 7, 6, 8), "random", rng)
    tl = tblocks.NITIAvgPool((3, 3), (1, 1), pad=pad)
    jl = jblocks.NITIAvgPool((3, 3), (1, 1), pad=pad)
    yt, rt = tl.fwd(QTensor(t8(x), i32(-5)))
    yj, rj = jl.fwd({}, JQ(jnp.asarray(x), jnp.int32(-5)))
    np.testing.assert_array_equal(yt.data.numpy(), np.asarray(yj.data))
    assert int(yt.exp) == int(yj.exp)
    gy = draw(tuple(yt.data.shape), "random", rng)
    gt, _ = tl.bwd(rt, t8(gy))
    gj, _ = jl.bwd({}, rj, jnp.asarray(gy))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))


def test_forms_the_kernel_takes():
    x = torch.zeros((2, 5, 5, 16), dtype=torch.int8)
    assert pc.supports_pool(x, (3, 3), (2, 2))
    assert not pc.supports_pool(x, (6, 6), (1, 1))
    assert pc.supports_pool(x, (6, 6), (1, 1), pad=1)
    assert not pc.supports_pool(x.to(torch.int32), (3, 3), (2, 2))
    y = torch.zeros((2, 2, 2, 16), dtype=torch.int8)
    assert pc.supports_maxpool_grad(x, y, y, (3, 3), (2, 2))
    assert not pc.supports_maxpool_grad(x, y, y, (1, 1), (1, 1))  # wants a 5x5 y
    assert pc.supports_concat([x, x[..., :4]])
    assert not pc.supports_concat([x] * (pc.MAX_BRANCHES + 1))
    assert not pc.supports_concat([x, y])
    assert not pc.supports_concat([x, x.to(torch.int16)])


def test_rows_and_channel_runs():
    """A channel slice is rows at the whole tensor's stride, taken as it is;
    a transposed view is copied; the run is 16, 4 or 1 channels."""
    big = torch.zeros((2, 3, 3, 48), dtype=torch.int8)
    part = big[..., 16:32]
    t, ld = pc._rows(part)
    assert t is part and ld == 48
    t, ld = pc._rows(big.transpose(1, 2)[..., :8])
    assert t.is_contiguous() and ld == 8
    assert pc._rows(big)[1] == 48
    assert pc._vec([16, 32], [48], [big]) == 16
    assert pc._vec([16, 12], [48], [big]) == 4
    assert pc._vec([6], [6], [big]) == 1
    assert pc._vec([16], [48], [big[..., 1:17]]) == 1


def test_counters_and_trace_names():
    counts = kernels.launch_counts()
    names = ("pool_concat_maxpool", "pool_concat_maxpool_grad", "pool_concat_avgpool",
             "pool_concat_avgpool_grad", "pool_concat_concat")
    assert set(names) <= set(counts) and set(names) <= kernels.NO_CONTRACTION
    for symbol, name in zip(("k8_maxpool_kernel", "k8_maxpool_grad_kernel", "k8_avgpool_kernel",
                             "k8_avgpool_grad_kernel", "k8_concat_kernel"), names):
        assert device_trace.category(
            f"void (anonymous namespace)::{symbol}<16>((anonymous namespace)::K8Pool)") == name


def test_the_kernel_is_taken_only_on_the_card_under_cuda():
    x = torch.zeros((1, 4, 4, 4), dtype=torch.int8)
    assert not pc._kernel_takes(x)
    with dispatch.use_backend("torch"):
        assert not pc._kernel_takes(x)
    with pytest.raises(ValueError, match="CUDA"):
        pc.maxpool_cuda(x)


@pytest.fixture
def stubbed(monkeypatch):
    """K8's launches stubbed by the plain versions on CPU tensors: a list of
    the kinds launched."""
    calls = []
    monkeypatch.setattr(pc, "_kernel_takes", lambda t: dispatch.get_backend() == "cuda")
    plains = {"maxpool": pc.maxpool_plain, "maxpool_grad": pc.maxpool_grad_plain,
              "avgpool": pc.avgpool_plain, "avgpool_grad": pc.avgpool_grad_plain,
              "concat": pc.concat_plain}
    for kind, plain in plains.items():
        def cuda(*a, _kind=kind, _plain=plain, **k):
            calls.append(_kind)
            return _plain(*a, **k)
        monkeypatch.setattr(pc, f"{kind}_cuda", cuda)
    return calls


# (builder, input shape, logits, K8 launches of a train step by kind)
NETS = {"inceptionv3": (lambda: inceptionv3_niti(num_classes=10), (2, 75, 75, 3), 12,
                        {"maxpool": 4, "maxpool_grad": 4, "avgpool": 9, "avgpool_grad": 9,
                         "concat": 15}),
        "squeezenet": (lambda: squeezenet_niti(num_classes=10), (2, 64, 64, 3), 12,
                       {"maxpool": 3, "maxpool_grad": 3, "concat": 8}),
        "lenet": (lenet_niti, (4, 28, 28, 1), 12, {"maxpool": 2, "maxpool_grad": 2})}


@pytest.mark.parametrize("net", sorted(NETS))
def test_routed_sites_call_k8_and_keep_their_bytes(stubbed, net):
    build, shape, n_logits, want = NETS[net]
    models = []
    for backend in ("cuda", "torch"):
        model = build()
        model.reset_parameters(torch.Generator().manual_seed(5))
        with dispatch.use_backend(backend):
            _step(model, shape, n_logits, seed=6)
        models.append(model)
        if backend == "cuda":
            assert collections.Counter(stubbed) == want
            stubbed.clear()
    assert not stubbed
    for a, b in zip(*(m.state_dict().values() for m in models)):
        assert torch.equal(a, b)


def test_the_padded_avgpool_writes_no_padded_copy(stubbed, monkeypatch):
    """Under the kernel, NITIAvgPool hands K8 the unpadded input and its
    pad, and takes back the unpadded gradient: no pad, no crop."""
    pads = []
    monkeypatch.setattr(F, "pad", lambda *a, **k: pads.append(a) or torch.zeros(()))
    layer = tblocks.NITIAvgPool((3, 3), (1, 1), pad=1)
    x = t8(draw((1, 5, 5, 16), "random", np.random.default_rng(30)))
    monkeypatch.setattr(pc, "avgpool_cuda", lambda x, w, s, pad=0: (
        stubbed.append(("avgpool", tuple(x.shape), pad)) or torch.zeros((1, 5, 5, 16),
                                                                        dtype=torch.int8)))
    y, res = layer.fwd(QTensor(x, i32(0)))
    g, _ = layer.bwd(res, y.data)
    assert stubbed == [("avgpool", (1, 5, 5, 16), 1), "avgpool_grad"]
    assert tuple(g.shape) == (1, 5, 5, 16) and not pads
