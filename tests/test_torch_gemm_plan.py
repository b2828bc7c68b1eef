"""The plan that routes K1 and K2 (``ops/kernels/matmul_int8.plan``): the
operand layout classes, the copy widths from alignment, the tile choice and
the K split, on the four layouts the training steps give the GEMM; and a
meta-device rehearsal of the K1 and K2 shapes `chip_smoke.py` records in a
batch-256 MobileNetV2 step. The kernels themselves run only on the card
(tests/test_torch_cuda.py)."""

import importlib.util
from pathlib import Path

import pytest
import torch

from mandheling_tpu_torch.models import MOBILENET_V2_NITI_LOGITS, lenet_niti, mobilenet_v2_niti
from mandheling_tpu_torch.ops.kernels import fused_matmul_int8 as fmm
from mandheling_tpu_torch.ops.kernels import matmul_int8 as mm
from mandheling_tpu_torch.train import make_eval_step, make_train_step

KS = [12, 16, 24, 25, 27, 500, 1300, 262144]


def _load_chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def operands(layout, m, k, n):
    """Empty CPU operands with the strides of a layout of the step: "fwd"
    (im2col x HWIO), "igrad" (the rot180 / io-swapped 1x1 weights), "fgrad"
    (im2col^T x gy) and "k2" (the fused 1x1 input grad)."""
    z = lambda *s: torch.empty(s, dtype=torch.int8)  # noqa: E731
    if layout == "fwd":
        return z(m, k), z(k, n)
    if layout in ("igrad", "k2"):
        return z(m, k), z(n, k).t()
    return z(k, m).t(), z(k, n)


@pytest.mark.parametrize("layout,want", [
    ("fwd", ("k", "n")), ("igrad", ("k", "k")), ("fgrad", ("m", "n")), ("k2", ("k", "k")),
])
@pytest.mark.parametrize("k", KS)
def test_layout_classes_and_routes(layout, want, k):
    m, n = 40, 24
    a, b = operands(layout, m, k, n)
    assert mm.layout(m, k, n, a.stride(), b.stride()) == want
    pl = mm.plan(m, k, n, a.stride(), b.stride(), fused=layout == "k2")
    assert pl.route == ("mnmajor" if layout == "fgrad" else "kmajor")
    assert not pl.copy_a
    # 8-bit wgmma reads B K-major only: the forwards' HWIO B is copied
    assert pl.copy_b == (layout == "fwd")
    pa, pb = mm.prepare(a, b, pl)
    if pl.route == "kmajor":
        assert pa.stride(1) == 1 and pb.stride(0) == 1
    else:
        assert pa.stride(0) == 1 and pb.stride(1) == 1


@pytest.mark.parametrize("k,want", [(12, 4), (16, 16), (24, 8), (25, 1), (27, 1), (500, 4),
                                    (1300, 4), (262144, 16)])
def test_copy_width_from_row_stride(k, want):
    """Rows of K bytes: the widest aligned copy, the byte path for odd K."""
    assert mm.copy_width(0, k) == want
    a, b = operands("fwd", 300, k, 8)
    pl = mm.plan(300, k, 8, a.stride(), b.stride())
    assert pl.a_width == want and pl.b_width == want  # B copied K-major: rows of K
    # the filter grads copy rows of M bytes (A^T) and N bytes (gy)
    a, b = operands("fgrad", k, 4096, 96)
    assert mm.plan(k, 4096, 96, a.stride(), b.stride()).a_width == want


@pytest.mark.parametrize("ptr,stride,want", [(1, 16, 1), (2, 16, 1), (4, 16, 4), (8, 16, 8),
                                             (16, 16, 16), (0, 0, 16), (8, 0, 8), (4, 6, 1)])
def test_copy_width_from_base_address(ptr, stride, want):
    assert mm.copy_width(ptr, stride) == want


def test_copy_width_of_an_offset_view():
    """A view at an odd address takes the byte path whatever its rows."""
    base = torch.empty(64 * 100 + 1, dtype=torch.int8)
    a = base[1:].view(100, 64)
    b = torch.empty((64, 32), dtype=torch.int8)
    pl = mm.plan(100, 64, 32, a.stride(), b.stride(), a.data_ptr(), b.data_ptr())
    assert pl.a_width == mm.copy_width(a.data_ptr(), 64) == 1


def test_strided_a_is_copied():
    a = torch.empty((50, 80), dtype=torch.int8)[:, ::2]
    b = torch.empty((40, 16), dtype=torch.int8)
    assert mm.layout(50, 40, 16, a.stride(), b.stride())[0] == "strided"
    pl = mm.plan(50, 40, 16, a.stride(), b.stride())
    assert pl.route == "kmajor" and pl.copy_a
    assert mm.prepare(a, b, pl)[0].is_contiguous()


@pytest.mark.parametrize("n", [12, 16, 20, 24, 32, 52, 96, 144, 192, 256, 320, 384, 500, 576,
                               832, 960, 1280])
def test_kmajor_tile_width(n):
    """One tile of BN >= N up to 256 (a K2 phase reads A once), else the
    fewest padded columns counting each tile's re-read of A."""
    bn = mm.kmajor_bn(n)
    assert bn in mm._KMAJOR_BN
    if n <= 256:  # the narrowest tile that covers N
        assert n <= bn and not any(n <= c < bn for c in mm._KMAJOR_BN)
    cost = lambda c: -(-n // c) * (c + 32)  # noqa: E731
    assert cost(bn) == min(cost(c) for c in mm._KMAJOR_BN)


@pytest.mark.parametrize("m,n", [(16, 96), (27, 32), (144, 24), (1280, 12), (320, 1280),
                                 (500, 52)])
def test_mnmajor_tile_fits_m_and_n(m, n):
    """The filter grads' tile: the least padded area of 64 x 128, 128 x 64
    and 256 x 32 (a 16-row M wastes no more than it must)."""
    a, b = operands("fgrad", m, 4096, n)
    pl = mm.plan(m, 4096, n, a.stride(), b.stride())
    area = lambda bm, bn: -(-m // bm) * bm * -(-n // bn) * bn  # noqa: E731
    assert area(64 * pl.warps, pl.bn) == min(area(64, 128), area(128, 64), area(256, 32))
    assert 64 * pl.warps * pl.bn == 64 * 128


@pytest.mark.parametrize("layout", ["fwd", "igrad", "fgrad"])
@pytest.mark.parametrize("k", KS)
def test_split_covers_k(layout, k):
    """K1's split (in 32-byte k-steps) covers K exactly once; the filter
    grads split on their own tiles; K2 never splits."""
    m, n = (24, 144) if layout == "fgrad" else (64, 500)
    a, b = operands(layout, m, k, n)
    pl = mm.plan(m, k, n, a.stride(), b.stride())
    ksteps = -(-k // 32)
    assert pl.per * pl.splits >= ksteps and pl.per * (pl.splits - 1) < max(ksteps, 1)
    if layout == "fgrad":
        tiles = -(-m // (64 * pl.warps)) * -(-n // pl.bn)
        assert (pl.per, pl.splits) == mm.split_k(m, n, k, tiles)
    else:
        assert (pl.per, pl.splits) == mm.split_k(m, n, k)
    fused = mm.plan(m, k, n, a.stride(), b.stride(), fused=True)
    assert fused.splits == 1 and fused.route == "kmajor"


def test_fused_plan_copies_an_mn_major_a():
    a, b = operands("fgrad", 2048, 24, 144)
    pl = mm.plan(2048, 24, 144, a.stride(), b.stride(), fused=True)
    assert pl.route == "kmajor" and pl.copy_a and pl.a_width == 8


def _step_keys(model, hwc, batch):
    """{"K1"|"K2": Counter} of one train step and one eval step on the meta
    device, keyed as chip_smoke.py keys them."""
    cs = _load_chip_smoke()
    model = model.to("meta")
    x = torch.zeros((batch,) + hwc, device="meta")
    oh = torch.zeros((batch, MOBILENET_V2_NITI_LOGITS), dtype=torch.int32, device="meta")
    spec = {"K1": (mm, "matmul_acc", cs.k1_key), "K2": (fmm, "matmul_max", cs.k1_key)}
    with cs.recording(spec) as train:
        make_train_step(model)(x, oh)
    with cs.recording(spec) as evals:
        make_eval_step(model)(x, torch.zeros(batch, dtype=torch.int64, device="meta"))
    return cs, train, evals


def test_chip_smoke_k2_path_cases_are_the_step_shapes():
    """chip_smoke.py times K2 at K2_PATH_CASES and weights them by the
    launches it records in a batch-256 MobileNetV2 step: a train step's K2
    shapes and layouts are the listed ones, an eval step's among them, and
    their counts are EXPECTED_PER_STEP's."""
    cs, train, evals = _step_keys(mobilenet_v2_niti(), (32, 32, 3), 256)
    assert set(train["K2"]) == set(cs.K2_PATH_CASES) and len(cs.K2_PATH_CASES) == 24
    assert set(evals["K2"]) <= set(cs.K2_PATH_CASES)
    per_train, per_eval = cs.EXPECTED_PER_STEP[("mnv2", 256, "matmul_only")]
    assert sum(train["K2"].values()) == per_train["K2"]
    assert sum(evals["K2"].values()) == per_eval["K2"]
    for m, k, n, al, bl in cs.K2_PATH_CASES:
        assert fmm.supports(m, k, n) and al == "k" and bl in ("k", "n")
        assert mm.kmajor_bn(n) >= n or n > 256


def test_chip_smoke_k1_layouts_are_the_step_layouts():
    """K1's recorded keys in a batch-256 MobileNetV2 step: every A is
    K-major (forwards, input grads: the wgmma route) or MN-major (the
    filter grads: the mma.sync route), never copied; 65 launches a train
    step, of which 29 row-major, and 15 an eval step."""
    _, train, evals = _step_keys(mobilenet_v2_niti(), (32, 32, 3), 256)
    assert sum(train["K1"].values()) == 65 and sum(evals["K1"].values()) == 15
    assert sum(c for key, c in train["K1"].items() if key[3] == "k") == 29
    for key in set(train["K1"]) | set(evals["K1"]):
        m, k, n, al, bl = key
        assert (al, bl) in {("k", "n"), ("k", "k"), ("m", "n")}
        pl = mm.plan(m, k, n, (k, 1) if al == "k" else (1, m), (n, 1) if bl == "n" else (1, k))
        assert pl.route == ("kmajor" if al == "k" else "mnmajor") and not pl.copy_a


def test_chip_smoke_lenet_k1_shapes_are_the_step_shapes():
    cs, train, evals = _step_keys(lenet_niti(), (28, 28, 1), 64)
    assert set(train["K1"]) == {tuple(c[1:]) for c in cs.K1_SHAPES}
    assert set(evals["K1"]) <= set(train["K1"]) and not train["K2"]
