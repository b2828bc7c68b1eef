"""The port's CUDA kernels against their plain versions on the card, at
ragged shapes that catch fragment-layout and masking faults. A CUDA kernel
has no interpret mode, so these tests need an NVIDIA GPU and nvcc; without
them they skip. This file imports no JAX, so it also runs where only the
port is installed, without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import contextlib

import pytest
import torch

from mandheling_tpu_torch.ops import numerics
from mandheling_tpu_torch.ops.kernels import fused_conv_int8 as fconv
from mandheling_tpu_torch.ops.kernels import fused_dwconv_int8 as fdw
from mandheling_tpu_torch.ops.kernels import fused_matmul_int8 as fmm
from mandheling_tpu_torch.ops.kernels import matmul_int8 as mm

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def rand_int8(shape, gen, lo=-128, hi=128):
    return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int8, device="cuda")


@pytest.mark.parametrize("m,k,n", [
    (1, 1, 1), (17, 12, 20), (65, 25, 52), (64, 31, 12), (63, 33, 500),
    (129, 1300, 20), (500, 4096, 52), (25, 36864, 20), (100, 0, 9),
])
@pytest.mark.parametrize("a_t", [False, True])
def test_matmul_kernel_matches_plain(gen, m, k, n, a_t):
    a = rand_int8((k, m), gen).t() if a_t else rand_int8((m, k), gen)
    b = rand_int8((k, n), gen)
    got = mm.matmul_acc_cuda(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, mm.matmul_acc_plain(a, b))


def test_matmul_kernel_wraps(gen):
    """Sums past 2^31 wrap as int32 (split-K partials included)."""
    k = 140000
    a = torch.full((3, k), -128, dtype=torch.int8, device="cuda")
    b = torch.full((k, 5), -128, dtype=torch.int8, device="cuda")
    assert mm.split_k(3, 5, k)[1] > 1
    want = (k * 128 * 128 + 2**31) % 2**32 - 2**31  # the int32 wrap of the true sum
    got = mm.matmul_acc_cuda(a, b)
    assert torch.equal(got, mm.matmul_acc_plain(a, b))
    assert int(got[0, 0]) == int(want)


def _shift_cases(mx):
    bw = numerics.range_estimate_from_max(mx)
    return [(numerics.forward_shift(bw), False), (torch.zeros_like(bw), False),
            (bw - 3, True), (bw - 40, True), (bw + 40, True)]


def _operands(layout, m, k, n, gen):
    """(a, b) of shape (m, k) x (k, n) in one of the layouts K1 meets: "fwd"
    (A K-major, B N-major: im2col x HWIO), "igrad" (A and B K-major: the
    rot180 / io-swapped 1x1 weights), "fgrad" (A MN-major: im2col^T; B
    N-major: gy), "strided" (neither of A's strides is 1) and "offset" (A
    K-major at an odd address: the byte path)."""
    if layout == "fwd":
        return rand_int8((m, k), gen), rand_int8((k, n), gen)
    if layout == "igrad":
        return rand_int8((m, k), gen), rand_int8((n, k), gen).t()
    if layout == "fgrad":
        return rand_int8((k, m), gen).t(), rand_int8((k, n), gen)
    if layout == "strided":
        return rand_int8((m, 2 * k), gen)[:, ::2], rand_int8((k, n), gen)
    return rand_int8((m * k + 1,), gen)[1:].view(m, k), rand_int8((k, n), gen)


@pytest.mark.parametrize("layout", ["fwd", "igrad", "fgrad", "strided", "offset"])
@pytest.mark.parametrize("width", [64, 40, 36, 27])  # K % 16 = 0, 8, 4, odd
def test_matmul_layouts_and_alignments(gen, layout, width):
    """Each layout class at each alignment class of the rows the kernel
    copies (K for the K-major route, M for the filter grads' MN-major one),
    at ragged M and N; the filter grads over a K long enough to split."""
    m, k, n = (width, 3000, 70) if layout == "fgrad" else (129, width, 70)
    a, b = _operands(layout, m, k, n, gen)
    pl = mm.plan(m, k, n, a.stride(), b.stride(), a.data_ptr(), b.data_ptr())
    assert pl.route == ("mnmajor" if layout == "fgrad" else "kmajor")
    got = mm.matmul_acc_cuda(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, mm.matmul_acc_plain(a, b)), pl


@pytest.mark.parametrize("layout", ["fwd", "igrad"])
@pytest.mark.parametrize("k,n", [(16, 96), (24, 144)])
def test_matmul_below_one_wgmma_kstep(gen, layout, k, n):
    """K = 16 and 24: less than one 32-byte wgmma k-step, the rest zero-filled."""
    a, b = _operands(layout, 300, k, n, gen)
    assert torch.equal(mm.matmul_acc_cuda(a, b), mm.matmul_acc_plain(a, b))
    mx = fmm.matmul_max_cuda(a, b)
    assert torch.equal(mx, fmm.matmul_max_plain(a, b))
    for shift, grad in _shift_cases(mx):
        got = fmm.matmul_requant_cuda(a, b, shift, grad)
        assert torch.equal(got, fmm.matmul_requant_plain(a, b, shift, grad))


@pytest.mark.parametrize("layout", ["fwd", "igrad"])
@pytest.mark.parametrize("n", [16, 96, 144, 384])
def test_fused_kernels_tile_width(gen, layout, n):
    """K2 at the MobileNetV2 widths: one tile of BN >= N up to 256 (each
    phase reads A once), two at 384; M not a multiple of the tile."""
    a, b = _operands(layout, 2056, 24, n, gen)
    assert (mm.kmajor_bn(n) >= n) == (n <= 256)
    mx = fmm.matmul_max_cuda(a, b)
    assert torch.equal(mx, fmm.matmul_max_plain(a, b))
    for shift, grad in _shift_cases(mx):
        got = fmm.matmul_requant_cuda(a, b, shift, grad)
        assert torch.equal(got, fmm.matmul_requant_plain(a, b, shift, grad)), (shift, grad)


def test_matmul_kernel_wraps_unsplit_wgmma(gen):
    """Sums past 2^31 wrap in wgmma's own accumulators: enough output tiles
    that K is not split, K = 140000 of (-128)^2 each."""
    m, k, n = 1024, 140000, 1056
    a = torch.full((m, k), -128, dtype=torch.int8, device="cuda")
    b = torch.full((n, k), -128, dtype=torch.int8, device="cuda").t()
    pl = mm.plan(m, k, n, a.stride(), b.stride())
    assert pl.route == "kmajor" and pl.splits == 1
    got = mm.matmul_acc_cuda(a, b)
    assert bool((got == (k * 128 * 128 + 2**31) % 2**32 - 2**31).all())


def test_matmul_kernel_wraps_mnmajor_split(gen):
    """The filter grads' MN-major route: split-K partial sums whose total
    wraps past 2^31."""
    k = 140000
    a = torch.full((k, 3), -128, dtype=torch.int8, device="cuda").t()
    b = torch.full((k, 5), -128, dtype=torch.int8, device="cuda")
    pl = mm.plan(3, k, 5, a.stride(), b.stride())
    assert pl.route == "mnmajor" and pl.splits > 1
    got = mm.matmul_acc_cuda(a, b)
    assert torch.equal(got, mm.matmul_acc_plain(a, b))
    assert bool((got == (k * 128 * 128 + 2**31) % 2**32 - 2**31).all())


@pytest.mark.parametrize("m,k,n", [(2048, 12, 500), (300, 100, 70), (1024, 24, 144),
                                   (2047, 37, 513), (5, 3, 2), (1100, 0, 40),
                                   (2048, 832, 500), (1024, 512, 512)])
def test_fused_kernels_match_plain(gen, m, k, n):
    a, b = rand_int8((m, k), gen), rand_int8((k, n), gen)
    mx = fmm.matmul_max_cuda(a, b)
    assert torch.equal(mx, fmm.matmul_max_plain(a, b))
    bw = numerics.range_estimate_from_max(mx)
    for shift, grad in [(numerics.forward_shift(bw), False), (torch.zeros_like(bw), False),
                        (bw - 3, True), (bw - 40, True), (bw + 40, True)]:
        got = fmm.matmul_requant_cuda(a, b, shift, grad)
        assert torch.equal(got, fmm.matmul_requant_plain(a, b, shift, grad)), (shift, grad)


@pytest.mark.parametrize("x_shape,w_shape,stride,pad", [
    ((2, 9, 9, 3), (3, 3, 3, 8), (2, 2), ((0, 1), (0, 1))),
    ((2, 9, 9, 3), (5, 5, 3, 8), (2, 2), ((1, 2), (1, 2))),
    ((2, 33, 33, 8), (3, 3, 8, 16), (2, 2), ((1, 1), (1, 1))),
    ((3, 32, 32, 3), (3, 3, 3, 32), (1, 1), ((1, 1), (1, 1))),
    ((5, 28, 28, 1), (5, 5, 1, 20), (1, 1), ((0, 0), (0, 0))),
    ((5, 12, 12, 20), (5, 5, 20, 52), (1, 1), ((0, 0), (0, 0))),
    ((3, 8, 8, 52), (5, 5, 52, 20), (1, 1), ((4, 4), (4, 4))),
    ((1, 7, 5, 70), (3, 2, 70, 65), (1, 2), ((2, 0), (0, 3))),
])
def test_fused_conv_kernels_match_plain(gen, x_shape, w_shape, stride, pad):
    x, w = rand_int8(x_shape, gen), rand_int8(w_shape, gen)
    mx = fconv.conv_max_cuda(x, w, pad, stride)
    assert torch.equal(mx, fconv.conv_max_plain(x, w, pad, stride))
    for shift, grad in _shift_cases(mx):
        got = fconv.conv_requant_cuda(x, w, shift, pad, stride, grad)
        assert torch.equal(got, fconv.conv_requant_plain(x, w, shift, pad, stride, grad))


# K3 at each gather class (C % 16 == 0 on cp.async; C in {1, 3, 20, 52, 70}
# on the byte path), each N class (20, 32, 52, 64, 128, 256, 512: BN 32 to
# 256, N = 512 in two tiles), K of one stage and of more than four (the
# ring route past 4 stages), both routes (B resident, or the 128-row ring),
# strides 1 and 2 apart and asymmetric pads.
K3_CLASS_CASES = [
    ((2, 8, 8, 64), (3, 3, 64, 64), (1, 1), ((1, 1), (1, 1))),      # C % 16, K 576, stream
    ((2, 8, 8, 64), (3, 3, 64, 128), (2, 2), ((0, 1), (0, 1))),     # N 128 s2, ring
    ((2, 4, 4, 256), (3, 3, 256, 256), (1, 1), ((1, 1), (1, 1))),   # K 2304: 18 stages
    ((2, 4, 4, 256), (3, 3, 256, 512), (2, 2), ((0, 1), (0, 1))),   # N 512: two tiles
    ((3, 7, 9, 32), (3, 3, 32, 32), (1, 2), ((2, 0), (1, 2))),      # N 32, strides apart
    ((2, 9, 7, 48), (3, 3, 48, 20), (2, 1), ((0, 2), (1, 1))),      # N 20
    ((2, 5, 6, 64), (3, 3, 64, 52), (1, 1), ((2, 1), (0, 2))),      # N 52, pads past a row
    ((2, 7, 7, 96), (5, 5, 96, 64), (1, 1), ((2, 2), (2, 2))),      # 5x5, K 2400, ring
    ((2, 10, 10, 3), (3, 3, 3, 256), (1, 1), ((1, 1), (1, 1))),     # C 3, N 256
    ((1, 12, 12, 20), (3, 3, 20, 512), (1, 1), ((1, 1), (1, 1))),   # C 20, N 512
    ((2, 11, 13, 1), (5, 5, 1, 64), (2, 1), ((2, 1), (0, 3))),      # C 1
    ((1, 9, 9, 52), (5, 5, 52, 128), (1, 1), ((4, 4), (4, 4))),     # C 52, K 1360
    ((2, 6, 5, 70), (3, 3, 70, 64), (2, 2), ((1, 0), (0, 1))),      # C 70: runs not of 16
]


@pytest.mark.parametrize("x_shape,w_shape,stride,pad", K3_CLASS_CASES)
@pytest.mark.parametrize("offset", [0, 1])
def test_fused_conv_gather_classes(gen, x_shape, w_shape, stride, pad, offset):
    """K3 byte-equal to its plain version in both phases and every shift
    case; offset 1: x one byte off 16-byte alignment (a slice), which sends
    C % 16 == 0 to the byte path too."""
    n = x_shape[0] * x_shape[1] * x_shape[2] * x_shape[3]
    x = rand_int8((n + offset,), gen)[offset:].view(x_shape)
    w = rand_int8(w_shape, gen)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    mx = fconv.conv_max_cuda(x, w, pad, stride)
    assert torch.equal(mx, fconv.conv_max_plain(x, w, pad, stride))
    for shift, grad in _shift_cases(mx):
        got = fconv.conv_requant_cuda(x, w, shift, pad, stride, grad)
        assert torch.equal(got, fconv.conv_requant_plain(x, w, shift, pad, stride, grad)), (
            int(shift), grad)


@pytest.mark.parametrize("x_shape,w_shape", [((2, 4, 4, 256), (3, 3, 256, 256)),
                                             ((2, 9, 9, 3), (3, 3, 3, 32))])
def test_fused_conv_saturated(gen, x_shape, w_shape):
    """All -128 operands: the exact max (interior sums of K products of
    2^14) in both gather classes, and both phase-2 variants."""
    x = torch.full(x_shape, -128, dtype=torch.int8, device="cuda")
    w = torch.full(w_shape, -128, dtype=torch.int8, device="cuda")
    pad = ((1, 1), (1, 1))
    mx = fconv.conv_max_cuda(x, w, pad)
    assert int(mx) == w_shape[0] * w_shape[1] * w_shape[2] * 2**14
    assert torch.equal(mx, fconv.conv_max_plain(x, w, pad))
    for shift, grad in _shift_cases(mx):
        got = fconv.conv_requant_cuda(x, w, shift, pad, (1, 1), grad)
        assert torch.equal(got, fconv.conv_requant_plain(x, w, shift, pad, (1, 1), grad))


def test_fused_conv_max_back_to_back(gen):
    """Phase 1 at three shapes (both routes and gather classes), three
    rounds on one stream without a synchronisation: its state is back at
    {INT32_MIN, 0} after every call, so each call gives the plain max, and
    so does the last state read."""
    cases = [(rand_int8(xs, gen), rand_int8(ws, gen), pad, st)
             for xs, ws, st, pad in (K3_CLASS_CASES[0], K3_CLASS_CASES[2], K3_CLASS_CASES[8])]
    outs = [fconv.conv_max_cuda(x, w, p, s) for x, w, p, s in cases * 3]
    torch.cuda.synchronize()
    for i, (x, w, p, s) in enumerate(cases):
        want = fconv.conv_max_plain(x, w, p, s)
        for j in range(3):
            assert torch.equal(outs[i + j * len(cases)], want), (i, j)
    stream = torch.cuda.current_stream().cuda_stream
    assert fconv._state(x.device, stream).tolist() == [-(2**31), 0]


@pytest.mark.parametrize("xp_shape,k", [
    ((4, 18, 18, 24), (3, 3)), ((2, 34, 34, 144), (3, 3)), ((2, 10, 10, 576), (3, 3)),
    ((3, 6, 6, 960), (3, 3)), ((2, 11, 45, 33), (3, 3)), ((1, 9, 9, 7), (5, 5)),
    ((2, 12, 12, 40), (7, 7)), ((2, 5, 5, 3), (1, 1)), ((2, 12, 40, 40), (3, 1)),
    ((1, 7, 37, 65), (1, 3)), ((1, 4, 11, 9), (4, 11)),
])
def test_fused_dwconv_kernels_match_plain(gen, xp_shape, k):
    xp, w = rand_int8(xp_shape, gen), rand_int8(k + (1, xp_shape[3]), gen)
    mx = fdw.dwconv_max_cuda(xp, w)
    assert torch.equal(mx, fdw.dwconv_max_plain(xp, w))
    for shift, grad in _shift_cases(mx):
        got = fdw.dwconv_requant_cuda(xp, w, shift, grad)
        assert torch.equal(got, fdw.dwconv_requant_plain(xp, w, shift, grad))


@pytest.mark.parametrize("x_shape,k,pads,dil", [
    ((2, 32, 32, 144), (3, 3), ((1, 1), (1, 1)), (1, 1)),    # C % 16 = 0, 32x32
    ((3, 16, 16, 192), (3, 3), ((1, 1), (1, 1)), (1, 1)),    # 16x16
    ((2, 8, 8, 576), (3, 3), ((1, 1), (1, 1)), (1, 1)),      # 8x8
    ((5, 4, 4, 960), (3, 3), ((1, 1), (1, 1)), (1, 1)),      # 4x4
    ((2, 13, 11, 20), (3, 3), ((1, 1), (1, 1)), (1, 1)),     # C % 4 = 0 only; 13 rows
    ((2, 19, 9, 33), (3, 3), ((0, 1), (1, 0)), (1, 1)),      # ragged C: untiled; 18 rows
    ((3, 9, 10, 7), (3, 3), ((1, 1), (1, 1)), (1, 1)),       # ragged C 7: untiled
    ((2, 16, 16, 144), (3, 3), ((2, 1), (2, 1)), (2, 2)),    # stride-2 input grad to 32x32
    ((2, 4, 4, 576), (3, 3), ((2, 1), (2, 1)), (2, 2)),      # stride-2 input grad to 8x8
    ((2, 5, 7, 33), (3, 3), ((1, 2), (0, 1)), (2, 2)),       # ragged C, dilation 2
    ((2, 9, 9, 7), (5, 5), ((2, 2), (2, 2)), (1, 1)),        # 5x5, untiled
    ((2, 6, 5, 24), (5, 5), ((3, 2), (2, 3)), (2, 2)),       # 5x5, dilation 2
    ((2, 12, 40, 40), (3, 1), ((1, 1), (0, 0)), (1, 1)),     # 3x1
    ((1, 7, 9, 36), (3, 1), ((2, 0), (0, 0)), (1, 2)),       # 3x1, dilation along W
])
def test_fused_dwconv_widened_operands_match_plain(gen, x_shape, k, pads, dil):
    """K4 with x unpadded and its pads, a dilation, w as given and rotated,
    per-tensor and with per-channel shifts in [0, 12]: phase 1 and both
    phase-2 variants byte-equal to the plain version."""
    c = x_shape[3]
    x, w = rand_int8(x_shape, gen), rand_int8(k + (1, c), gen)
    pc = torch.randint(0, 13, (c,), generator=gen, dtype=torch.int32, device="cuda")
    for pcs, rot in [(None, False), (None, True), (pc, False), (pc, True)]:
        k4 = dict(pads=pads, dilation=dil, pc_shift=pcs, rot180=rot)
        mx = fdw.dwconv_max_cuda(x, w, **k4)
        assert torch.equal(mx, fdw.dwconv_max_plain(x, w, **k4)), (pcs is not None, rot)
        for shift, grad in _shift_cases(mx):
            got = fdw.dwconv_requant_cuda(x, w, shift, grad, **k4)
            assert torch.equal(got, fdw.dwconv_requant_plain(x, w, shift, grad, **k4)), (
                pcs is not None, rot, int(shift), grad)


@pytest.mark.parametrize("c", [48, 7])
def test_fused_dwconv_saturated_shifts(gen, c):
    """All -128 operands with per-channel shifts 0..12: interior accumulators
    147456 << 12, the largest the 3x3 cap allows, in both instances."""
    x = torch.full((3, 13, 11, c), -128, dtype=torch.int8, device="cuda")
    w = torch.full((3, 3, 1, c), -128, dtype=torch.int8, device="cuda")
    pc = torch.arange(c, dtype=torch.int32, device="cuda") % 13
    k4 = dict(pads=((1, 1), (1, 1)), pc_shift=pc)
    mx = fdw.dwconv_max_cuda(x, w, **k4)
    assert torch.equal(mx, fdw.dwconv_max_plain(x, w, **k4))
    assert int(mx) == (147456 << int(pc.max()))
    for shift, grad in _shift_cases(mx):
        got = fdw.dwconv_requant_cuda(x, w, shift, grad, **k4)
        assert torch.equal(got, fdw.dwconv_requant_plain(x, w, shift, grad, **k4))


@pytest.mark.parametrize("xp_shape,k", [
    ((4, 18, 18, 24), (3, 3)), ((2, 34, 34, 144), (3, 3)), ((3, 10, 10, 576), (3, 3)),
    ((5, 6, 6, 960), (3, 3)), ((3, 11, 45, 33), (3, 3)), ((5, 12, 12, 7), (3, 3)),
    ((1, 3, 3, 1), (3, 3)), ((2, 13, 13, 24), (5, 5)), ((2, 12, 40, 40), (3, 1)),
    ((1, 7, 37, 65), (1, 3)), ((2, 12, 12, 40), (7, 7)),
])
def test_dwconv_fgrad_kernel_matches_plain(gen, xp_shape, k):
    """K5: the int32 depthwise filter-grad accumulator, byte for byte."""
    b, hp, wp, c = xp_shape
    xp = rand_int8(xp_shape, gen)
    gy = rand_int8((b, hp - k[0] + 1, wp - k[1] + 1, c), gen)
    got = fdw.dwconv_fgrad_acc_cuda(xp, gy, k)
    torch.cuda.synchronize()
    assert torch.equal(got, fdw.dwconv_fgrad_acc_plain(xp, gy, k))


def test_dwconv_fgrad_kernel_wraps(gen):
    """Sums past 2^31 wrap as int32: all -128 over 147456 products a channel."""
    xp = torch.full((9, 130, 130, 33), -128, dtype=torch.int8, device="cuda")
    gy = torch.full((9, 128, 128, 33), -128, dtype=torch.int8, device="cuda")
    want = (9 * 128 * 128 * 2**14 + 2**31) % 2**32 - 2**31
    got = fdw.dwconv_fgrad_acc_cuda(xp, gy, (3, 3))
    assert torch.equal(got, fdw.dwconv_fgrad_acc_plain(xp, gy, (3, 3)))
    assert bool((got == want).all())


@pytest.mark.parametrize("x_shape,k,pads,stride", [
    ((2, 32, 32, 144), (3, 3), ((1, 1), (1, 1)), (1, 1)),    # packed, SAME, 32x32
    ((3, 8, 8, 576), (3, 3), ((1, 1), (1, 1)), (1, 1)),      # packed, 8x8
    ((2, 32, 32, 144), (3, 3), ((0, 1), (0, 1)), (2, 2)),    # packed, stride 2, pads (0, 1)
    ((3, 16, 16, 192), (3, 3), ((0, 1), (0, 1)), (2, 2)),    # packed, stride 2, 16x16
    ((5, 8, 8, 576), (3, 3), ((0, 1), (0, 1)), (2, 2)),      # packed, stride 2 to 4x4
    ((3, 15, 13, 20), (3, 3), ((0, 1), (0, 1)), (2, 2)),     # packed, odd maps, C 20
    ((2, 9, 14, 36), (3, 3), ((1, 1), (2, 0)), (1, 2)),      # packed, strides apart
    ((2, 14, 9, 36), (3, 3), ((2, 1), (0, 1)), (2, 1)),      # packed, strides apart
    ((2, 19, 21, 40), (3, 3), ((0, 0), (0, 0)), (1, 1)),     # packed, no pads, ragged OW groups
    ((2, 17, 19, 33), (3, 3), ((1, 1), (1, 1)), (2, 2)),     # ragged C: byte-wise
    ((2, 9, 14, 7), (3, 3), ((1, 1), (2, 0)), (1, 2)),       # ragged C 7: byte-wise
    ((1, 10, 10, 12), (3, 3), ((0, 0), (0, 0)), (3, 3)),     # stride 3: byte-wise
    ((2, 11, 11, 24), (5, 5), ((1, 2), (1, 2)), (2, 2)),     # 5x5 at stride 2: byte-wise
    ((2, 12, 10, 40), (3, 1), ((1, 1), (0, 0)), (2, 1)),     # 3x1: byte-wise
])
@pytest.mark.parametrize("aligned", [True, False])
def test_dwconv_fgrad_kernel_pads_and_strides(gen, x_shape, k, pads, stride, aligned):
    """K5 with x unpadded, its pads and a stride, byte for byte; unaligned:
    x and gy sliced one byte into their storage (the byte-wise instance);
    a second call on the same stream gives the same bytes (the scratch
    accumulator and the tickets reset themselves)."""
    b, _, _, c = x_shape
    oh, ow = fdw.fgrad_out_spatial(x_shape, k, pads, stride)

    def operand(shape):
        if aligned:
            return rand_int8(shape, gen)
        n = shape[0] * shape[1] * shape[2] * shape[3]
        return rand_int8((n + 1,), gen)[1:].view(shape)

    x, gy = operand(x_shape), operand((b, oh, ow, c))
    assert (x.data_ptr() % 4 == 0) == aligned
    got = fdw.dwconv_fgrad_acc_cuda(x, gy, k, stride, pads=pads)
    again = fdw.dwconv_fgrad_acc_cuda(x, gy, k, stride, pads=pads)
    torch.cuda.synchronize()
    assert torch.equal(got, fdw.dwconv_fgrad_acc_plain(x, gy, k, stride, pads=pads))
    assert torch.equal(again, got)


@pytest.mark.parametrize("c", [36, 33])
def test_dwconv_fgrad_kernel_wraps_at_stride_2(gen, c):
    """Sums past 2^31 wrap as int32 at stride 2, in the packed (C 36) and
    the byte-wise (C 33) instance: all -128 over 147456 products a channel."""
    x = torch.full((9, 257, 257, c), -128, dtype=torch.int8, device="cuda")
    gy = torch.full((9, 128, 128, c), -128, dtype=torch.int8, device="cuda")
    want = (9 * 128 * 128 * 2**14 + 2**31) % 2**32 - 2**31
    got = fdw.dwconv_fgrad_acc_cuda(x, gy, (3, 3), (2, 2))
    assert torch.equal(got, fdw.dwconv_fgrad_acc_plain(x, gy, (3, 3), (2, 2)))
    assert bool((got == want).all())


def test_dwconv_fgrad_kernel_back_to_back(gen):
    """Calls of other sizes between two calls on the same operands, all on
    one stream without a synchronisation: every call's scratch and tickets
    are back at 0 for the next, so the repeated call gives the same bytes."""
    shapes = [((2, 32, 32, 144), ((1, 1), (1, 1)), (1, 1)),
              ((2, 32, 32, 144), ((0, 1), (0, 1)), (2, 2)),
              ((3, 9, 43, 33), ((1, 1), (1, 1)), (1, 1))]
    cases = []
    for xs, pads, stride in shapes:
        oh, ow = fdw.fgrad_out_spatial(xs, (3, 3), pads, stride)
        cases.append((rand_int8(xs, gen), rand_int8((xs[0], oh, ow, xs[3]), gen), pads, stride))
    outs = [fdw.dwconv_fgrad_acc_cuda(x, gy, (3, 3), s, pads=p) for x, gy, p, s in cases * 3]
    torch.cuda.synchronize()
    for i, (x, gy, p, s) in enumerate(cases):
        want = fdw.dwconv_fgrad_acc_plain(x, gy, (3, 3), s, pads=p)
        for j in range(3):
            assert torch.equal(outs[i + j * len(cases)], want), (i, j)


def test_dwconv_fgrad_kernel_no_grid_limit(gen):
    """More (b, oh) rows than the 32 x 65535 the first K5 took: 70000 x 32."""
    x = rand_int8((70000, 32, 1, 4), gen)
    gy = rand_int8((70000, 32, 1, 4), gen)
    pads = ((1, 1), (1, 1))
    got = fdw.dwconv_fgrad_acc_cuda(x, gy, (3, 3), pads=pads)
    assert torch.equal(got, fdw.dwconv_fgrad_acc_plain(x, gy, (3, 3), pads=pads))


@pytest.mark.parametrize("m,k,n", [(49152, 28, 512), (1000, 256, 512), (65, 37, 70),
                                   (3, 5, 2), (128, 2600, 64), (49152, 128, 512),
                                   (49152, 256, 512), (300, 100, 70), (129, 0, 33)])
def test_matmul_max_bf16_kernel_matches_plain(gen, m, k, n):
    """K6 at operands in [-80, 80), where every float32 sum is exact."""
    a, b = rand_int8((m, k), gen, -80, 80), rand_int8((k, n), gen, -80, 80)
    got = fmm.matmul_max_bf16_cuda(a, b)
    assert torch.equal(got, fmm.matmul_max_bf16_plain(a, b))
    assert torch.equal(got, fmm.matmul_max_plain(a, b))


def test_matmul_kernel_wraps_resnet18_layer1_filter_grad(gen):
    """ResNet-18 layer1's filter grad at batch 256: im2col(x)^T (576 x
    262144, MN-major) times gy (262144 x 64), split over K. All -128
    operands give 262144 * 2^14 = 2^32, which wraps to 0; random operands
    are held to the plain version's int32 wrap too."""
    m, k, n = 576, 262144, 64
    a = torch.full((k, m), -128, dtype=torch.int8, device="cuda").t()
    b = torch.full((k, n), -128, dtype=torch.int8, device="cuda")
    pl = mm.plan(m, k, n, a.stride(), b.stride())
    assert pl.route == "mnmajor" and pl.splits > 1
    got = mm.matmul_acc_cuda(a, b)
    assert bool((got == 0).all())
    assert torch.equal(got, mm.matmul_acc_plain(a, b))
    a, b = rand_int8((k, m), gen).t(), rand_int8((k, n), gen)
    assert torch.equal(mm.matmul_acc_cuda(a, b), mm.matmul_acc_plain(a, b))


# the three strided 1x1 projections of a batch-256 ResNet-18 (B N-major)
# and their input grads (B K-major: the io-swapped weight)
RESNET18_K2_CASES = [
    ("fwd", 65536, 64, 128), ("fwd", 16384, 128, 256), ("fwd", 4096, 256, 512),
    ("igrad", 262144, 128, 64), ("igrad", 65536, 256, 128), ("igrad", 16384, 512, 256),
]


@pytest.mark.parametrize("layout,m,k,n", RESNET18_K2_CASES)
def test_fused_kernels_at_resnet18_projections(gen, layout, m, k, n):
    a, b = _operands(layout, m, k, n, gen)
    assert fmm.supports(m, k, n)
    mx = fmm.matmul_max_cuda(a, b)
    assert torch.equal(mx, fmm.matmul_max_plain(a, b))
    for shift, grad in _shift_cases(mx):
        got = fmm.matmul_requant_cuda(a, b, shift, grad)
        assert torch.equal(got, fmm.matmul_requant_plain(a, b, shift, grad)), (shift, grad)


@pytest.mark.parametrize("in_c,out_c,stride", [(64, 64, 1), (64, 128, 2)])
def test_resnet18_block_under_fused_mode_all(gen, in_c, out_c, stride):
    """A ResNet-18 basic block (identity, and projected with stride 2) at
    batch 16, forward and backward under fused mode "all" with the kernels
    (K3 on the 3x3 convs `supports` takes, K2 / K1 on the rest) against the
    plain versions on the card: outputs, exponents, input grad and weight
    grads byte-equal."""
    from mandheling_tpu_torch.models.resnet import _basic_block
    from mandheling_tpu_torch.ops.conv import use_fused_conv_mode
    from mandheling_tpu_torch.ops.kernels import launch_counts, reset_launch_counts, use_backend
    from mandheling_tpu_torch.ops.qtensor import QTensor

    block = _basic_block(in_c, out_c, stride)
    block.reset_parameters(torch.Generator().manual_seed(1))
    block.to("cuda")
    x = rand_int8((16, 32, 32, in_c), gen)
    gy = rand_int8((16, 32 // stride, 32 // stride, out_c), gen)
    exp = torch.tensor(-7, dtype=torch.int32, device="cuda")
    runs = []
    for backend in ("cuda", "torch"):
        reset_launch_counts()
        with use_backend(backend), use_fused_conv_mode("all"):
            y, res = block.fwd(QTensor(x, exp))
            gx, grads = block.bwd(res, gy)
        torch.cuda.synchronize()
        runs.append((y.data, y.exp, gx, grads, launch_counts()))
    (y, e, gx, grads, counts), (y_p, e_p, gx_p, grads_p, counts_p) = runs
    assert torch.equal(y, y_p) and torch.equal(e, e_p) and torch.equal(gx, gx_p)
    flat = [g.data for g in _grad_leaves(grads)]
    flat_p = [g.data for g in _grad_leaves(grads_p)]
    assert len(flat) == len(flat_p) == (2 if stride == 1 else 3)
    assert all(torch.equal(a, b) for a, b in zip(flat, flat_p))
    assert counts["fused_conv_max"] >= 2 and not any(counts_p.values())


def _grad_leaves(grads):
    if isinstance(grads, list):
        return [leaf for g in grads for leaf in _grad_leaves(g)]
    if isinstance(grads, dict) and "branch" in grads:
        return _grad_leaves(grads["branch"]) + _grad_leaves(grads["proj"])
    return [grads["w"]] if grads else []


def rand_int16(shape, gen, lo=-32768, hi=32768):
    return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int16, device="cuda")


# (m, k, n): ragged tiles, K = 25 (the byte path), a K-major A wide enough
# for two warpgroups in the int8 route, and MobileNetV2 proj_bits=15's
# largest filter grad (split over K)
INT16_CASES = [(1, 1, 1), (17, 12, 20), (65, 25, 52), (300, 100, 70), (4096, 320, 1280),
               (262144, 24, 144), (24, 262144, 144)]


@pytest.mark.parametrize("m,k,n", INT16_CASES)
@pytest.mark.parametrize("a_t", [False, True])
def test_matmul_int16_route_matches_plain(gen, m, k, n, a_t):
    """K1's int16-A route, int16 (M, K) x int8 (K, N), in both of K1's
    layouts (the forwards' K-major A, the filter grads' MN-major
    im2col(x)^T), against the plain version's int32 wrap."""
    a = rand_int16((k, m), gen).t() if a_t else rand_int16((m, k), gen)
    b = rand_int8((k, n), gen)
    got = mm.matmul_acc_int16_cuda(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, mm.matmul_acc_plain(a, b))


@pytest.mark.parametrize("a_val,b_val,k", [(32767, 127, 100), (-32768, -128, 600),
                                            (-32768, 127, 1030), (32767, -128, 140000)])
@pytest.mark.parametrize("a_t", [False, True])
def test_matmul_int16_route_extremes_and_wraps(gen, a_val, b_val, k, a_t):
    """The extremes of int16 against those of int8, with sums that wrap
    past 2^31 (600 x 2^22), past 2^32 (1030 products) and over a split K;
    each output equal to the int32 wrap of the exact sum."""
    m, n = 70, 33
    a = torch.full((k, m) if a_t else (m, k), a_val, dtype=torch.int16, device="cuda")
    a = a.t() if a_t else a
    b = torch.full((k, n), b_val, dtype=torch.int8, device="cuda")
    want = (k * a_val * b_val + 2**31) % 2**32 - 2**31
    got = mm.matmul_acc_int16_cuda(a, b)
    assert bool((got == want).all())
    assert torch.equal(got, mm.matmul_acc_plain(a, b))


# K3 at the zoo's shapes: an Inception-v3 1x7 and 1x3 conv (b4 of its b32),
# and SqueezeNet's 7x7/2 stem at 224 (C = 3: the byte path)
ZOO_K3_CASES = [
    ((4, 17, 17, 160), (1, 7, 160, 160), (1, 1), ((0, 0), (3, 3))),
    ((4, 8, 8, 384), (1, 3, 384, 384), (1, 1), ((0, 0), (1, 1))),
    ((4, 224, 224, 3), (7, 7, 3, 96), (2, 2), ((2, 3), (2, 3))),
]


@pytest.mark.parametrize("x_shape,w_shape,stride,pad", ZOO_K3_CASES)
def test_fused_conv_kernels_at_zoo_shapes(gen, x_shape, w_shape, stride, pad):
    x, w = rand_int8(x_shape, gen), rand_int8(w_shape, gen)
    assert fconv.supports(w_shape, x_shape[2] + pad[1][0] + pad[1][1], stride)
    mx = fconv.conv_max_cuda(x, w, pad, stride)
    assert torch.equal(mx, fconv.conv_max_plain(x, w, pad, stride))
    for shift, grad in _shift_cases(mx):
        got = fconv.conv_requant_cuda(x, w, shift, pad, stride, grad)
        assert torch.equal(got, fconv.conv_requant_plain(x, w, shift, pad, stride, grad))


@pytest.mark.parametrize("kernel,mode", [((1, 1), "matmul_only"), ((3, 3), "matmul_only"),
                                         ((3, 3), "all")])
def test_kernels_take_a_channel_sliced_gy(gen, kernel, mode):
    """ParallelConcat's backward hands each branch gy[..., off:off + c], a
    strided view. The input and filter grads of a conv given such a view,
    with the kernels (a 1x1: K2 for the input grad, K1 for the filter grad;
    a 3x3: K1 for both, or K3 for the input grad under "all"), equal those
    given a contiguous copy of it and the plain versions'."""
    from mandheling_tpu_torch.ops import conv as conv_ops
    from mandheling_tpu_torch.ops.kernels import launch_counts, reset_launch_counts, use_backend

    x = rand_int8((64, 16, 16, 64), gen)
    w = rand_int8(kernel + (64, 96), gen)
    gy_full = rand_int8((64, 16, 16, 160), gen)
    gy = gy_full[..., 32:128]
    assert not gy.is_contiguous()
    runs = []
    for backend, g in (("cuda", gy), ("cuda", gy.contiguous()), ("torch", gy)):
        reset_launch_counts()
        with use_backend(backend), conv_ops.use_fused_conv_mode(mode):
            gx = conv_ops.conv2d_input_grad(g, w, (16, 16), (1, 1), "SAME")
            gw = conv_ops.conv2d_filter_grad(x, g, kernel, (1, 1), "SAME")
        torch.cuda.synchronize()
        runs.append((gx, gw, launch_counts()))
    for gx, gw, _ in runs[1:]:
        assert torch.equal(runs[0][0], gx) and torch.equal(runs[0][1], gw)
    counts = runs[0][2]
    want = ("fused_matmul_max" if kernel == (1, 1) else
            "fused_conv_max" if mode == "all" else "matmul_int8")
    assert counts[want] >= 1 and counts["matmul_int8"] >= 1


@pytest.mark.parametrize("m,k,n", [(64, 832, 500), (64, 500, 12), (256, 1280, 12),
                                   (3, 140000, 2)])
def test_matmul_ops_through_k1_match_plain(gen, m, k, n):
    """ops/matmul.py's forward and gradient requants through K1 against the
    plain version on the card, at the fc shapes and at a K whose all -128
    sums wrap past 2^31."""
    from mandheling_tpu_torch.ops import matmul as matmul_ops
    from mandheling_tpu_torch.ops.kernels import launch_counts, reset_launch_counts, use_backend

    if k > 100000:
        a = torch.full((m, k), -128, dtype=torch.int8, device="cuda")
        b = torch.full((k, n), -128, dtype=torch.int8, device="cuda")
    else:
        a, b = rand_int8((m, k), gen), rand_int8((k, n), gen)
    a_exp, b_exp = (torch.tensor(e, dtype=torch.int32, device="cuda") for e in (-7, -5))
    runs = []
    for backend in ("cuda", "torch"):
        reset_launch_counts()
        with use_backend(backend):
            runs.append((*matmul_ops.matmul_int8_forward(a, a_exp, b, b_exp),
                         matmul_ops.matmul_int8_grad(a, b)))
        torch.cuda.synchronize()
        assert launch_counts()["matmul_int8"] == (2 if backend == "cuda" else 0)
    assert all(torch.equal(x, y) for x, y in zip(*runs))


def test_transfer_step_at_full_width_matches_plain(gen):
    """One MobilenetV2Transfer step (full-width MobileNetV2 frozen up to its
    global pool, a 1280 -> 12 head) and one eval step at b8 with the kernels
    and with the plain versions on the card: head params byte-identical,
    the features unchanged."""
    import numpy as np

    from mandheling_tpu_torch.models import mobilenet_v2_niti
    from mandheling_tpu_torch.ops.kernels import launch_counts, reset_launch_counts, use_backend
    from mandheling_tpu_torch.train.transfer import (make_transfer_eval_step,
                                                     make_transfer_train_step, transfer_from)

    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.integers(0, 256, (8, 32, 32, 3)).astype(np.float32)).cuda()
    y = rng.integers(0, 10, 8)
    oh = torch.zeros((8, 12), dtype=torch.int32, device="cuda")
    oh[torch.arange(8), torch.from_numpy(y)] = 1
    runs = []
    for backend in ("cuda", "torch"):
        full = mobilenet_v2_niti().reset_parameters(torch.Generator().manual_seed(0))
        model = transfer_from(full).reset_parameters(torch.Generator().manual_seed(1)).to("cuda")
        before = [t.clone() for t in model.features.buffers()]
        head0 = model.head.layers[0].w.clone()
        reset_launch_counts()
        with use_backend(backend):
            loss = make_transfer_train_step(model)(x, oh)
            correct = make_transfer_eval_step(model)(x, torch.from_numpy(y).cuda())
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(before, model.features.buffers()))
        assert not torch.equal(model.head.layers[0].w, head0)
        runs.append((model.head.layers[0].w.clone(), float(loss), int(correct),
                     sum(launch_counts().values())))
    assert torch.equal(runs[0][0], runs[1][0]) and runs[0][1:3] == runs[1][1:3]
    assert runs[0][3] > 0 and runs[1][3] == 0


def test_lenet_qat_step_card_matches_cpu(gen):
    """One MnistInt8Train step of LeNetQAT in float64 with dropout (its mask
    drawn on the CPU for both), on the card and on the CPU: every parameter
    and observer within 1e-9 of its largest magnitude."""
    import numpy as np

    from mandheling_tpu_torch.models.lenet_qat import LeNetQAT
    from mandheling_tpu_torch.train.qat_train import make_qat_train_step

    rng = np.random.default_rng(9)
    x = torch.from_numpy((rng.integers(0, 256, (64, 28, 28, 1)) / 255.0 - 0.5) * 2.0)
    oh = torch.zeros((64, 10), dtype=torch.float64)
    oh[torch.arange(64), torch.from_numpy(rng.integers(0, 10, 64))] = 1.0
    states = []
    for device in ("cuda", "cpu"):
        model = LeNetQAT().reset_parameters(torch.Generator().manual_seed(0)).double().to(device)
        make_qat_train_step(model, torch.Generator().manual_seed(3))(
            x.to(device), oh.to(device), 0.01)
        states.append({k: v.detach().cpu() for k, v in
                       [*model.named_parameters(), *model.named_buffers()]})
    for name, want in states[1].items():
        err = float((states[0][name] - want).abs().max())
        assert err <= 1e-9 * max(float(want.abs().max()), 1e-300), name


def test_imported_resnet18_step_matches_plain(gen):
    """Full-width NITI ResNet-18 exported to TFLite and imported back
    (utils/tflite_model.py, onto the card): one train step and one eval step
    at b8 with the kernels and with the plain versions on the card, params
    byte-identical, and the same as the built model's step from the same
    params."""
    import numpy as np

    from mandheling_tpu_torch.models import resnet18_niti
    from mandheling_tpu_torch.ops.kernels import launch_counts, reset_launch_counts, use_backend
    from mandheling_tpu_torch.train import make_eval_step, make_train_step
    from mandheling_tpu_torch.utils.jax_params import export_jax_params, flat_weights
    from mandheling_tpu_torch.utils.tflite_model import (niti_model_from_tflite,
                                                         tflite_from_sequential)

    built = resnet18_niti().reset_parameters(torch.Generator().manual_seed(0))
    buf = tflite_from_sequential(built, None, (8, 32, 32, 3))
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.integers(0, 256, (8, 32, 32, 3)).astype(np.float32)).cuda()
    y = rng.integers(0, 10, 8)
    oh = torch.zeros((8, 12), dtype=torch.int32, device="cuda")
    oh[torch.arange(8), torch.from_numpy(y)] = 1
    runs = []
    for which, backend in (("imported", "cuda"), ("imported", "torch"), ("built", "cuda")):
        model = (niti_model_from_tflite(buf, device="cuda")[0] if which == "imported"
                 else built.to("cuda"))
        reset_launch_counts()
        with use_backend(backend):
            loss = make_train_step(model)(x, oh)
            correct = make_eval_step(model)(x, torch.from_numpy(y).cuda())
        torch.cuda.synchronize()
        runs.append((flat_weights(export_jax_params(model)), float(loss), int(correct),
                     sum(launch_counts().values())))
    for other in runs[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(runs[0][0], other[0]))
        assert runs[0][1:3] == other[1:3]
    assert runs[0][3] == runs[2][3] > 0 and runs[1][3] == 0


def _ranks_ready():
    """The kernels built in this process, before ranks that share the card
    start and load them."""
    from mandheling_tpu_torch.ops.kernels import build

    build.build_all()


def _lenet_start():
    from mandheling_tpu_torch.models import lenet_niti
    from mandheling_tpu_torch.utils.jax_params import export_jax_params

    return export_jax_params(lenet_niti().reset_parameters(torch.Generator().manual_seed(0)))


def _same_weights(a, b):
    import numpy as np

    from mandheling_tpu_torch.utils.jax_params import flat_weights

    fa, fb = flat_weights(a), flat_weights(b)
    return len(fa) == len(fb) and all(np.array_equal(x, y) for x, y in zip(fa, fb))


def test_dp_lenet_two_ranks_on_the_card_match_one_process(gen):
    """Two gloo ranks on cuda:0, each with half of a global batch of 128, two
    train steps and one eval step through the kernels: the single process's
    weights, losses and count, and each rank launches K1 as one process at
    batch 64 does (11 a train step, 4 an eval step)."""
    import numpy as np

    from mandheling_tpu_torch.data import onehot_padded, synthetic_mnist
    from mandheling_tpu_torch.models import lenet_niti
    from mandheling_tpu_torch.parallel import distributed, runs

    _ranks_ready()
    x, y = synthetic_mnist(384, seed=3)
    spec = dict(model=lenet_niti(), params=_lenet_start(), device="cuda",
                batches=[(x[i:i + 128].astype(np.float32), onehot_padded(y[i:i + 128], 10, 12))
                         for i in (0, 128)],
                eval=(x[256:].astype(np.float32), y[256:].astype(np.int64)))
    ranks = distributed.run_local(2, runs.dp_steps, spec, timeout_s=300)
    one = runs.dp_steps(dict(spec, world=0))
    for r in ranks:
        assert _same_weights(r["params"], one["params"])
        assert max(abs(a - b) for a, b in zip(r["losses"], one["losses"])) < 1e-5
        assert r["correct"] == one["correct"]
        assert r["launches"]["matmul_int8"] == 2 * 11 + 4


@pytest.mark.parametrize("op,x_shape,w_shape,per_channel", [
    ("conv", (64, 12, 12, 20), (5, 5, 20, 52), False),   # LeNet conv2: K3
    ("conv", (128, 32, 32, 3), (3, 3, 3, 32), False),    # MobileNetV2 stem: K3
    ("dw", (128, 32, 32, 32), (3, 3, 1, 32), False),     # MobileNetV2 depthwise: K4
    ("dw", (128, 16, 16, 96), (3, 3, 1, 96), True),      # the recipe's per-channel form
])
def test_group_max_between_fused_phases_matches_plain(gen, op, x_shape, w_shape, per_channel):
    """A forward in fused mode "all" over two gloo ranks on cuda:0, each with
    half of the batch: the fused kernel's phase 1, the maximum over the
    group, phase 2; against the plain versions under the same group and
    against one process on the whole batch."""
    import numpy as np

    from mandheling_tpu_torch.ops import conv as conv_ops
    from mandheling_tpu_torch.ops import depthwise as dw_ops
    from mandheling_tpu_torch.parallel import distributed
    from torch_rank_workers import op_rows

    _ranks_ready()
    rng = np.random.default_rng(sum(x_shape))
    x = rng.integers(-128, 128, x_shape).astype(np.int8)
    x[:x_shape[0] // 2] //= 32  # the first rank's rows alone would take a smaller shift
    w = rng.integers(-128, 128, w_shape).astype(np.int8)
    w_exp = (rng.integers(-9, -5, w_shape[-1]) if per_channel else np.int64(-7)).astype(np.int32)
    x_exp = np.int32(-3)
    fn = conv_ops.conv2d_forward if op == "conv" else dw_ops.dwconv2d_forward
    spec = dict(op=fn, args=[x, x_exp, w, w_exp], kwargs=dict(padding="SAME"), device="cuda",
                mode="all")
    got = {b: distributed.run_local(2, op_rows, dict(spec, backend=b), timeout_s=300)
           for b in ("cuda", "torch")}
    fused = "fused_conv_max" if op == "conv" else "fused_dwconv_max"
    assert all(r["launches"][fused] == 1 for r in got["cuda"])
    assert all(not any(r["launches"].values()) for r in got["torch"])
    one = fn(*(torch.as_tensor(a).cuda() for a in (x, x_exp, w, w_exp)), padding="SAME")
    for b in ("cuda", "torch"):
        y = np.concatenate([r["out"][0] for r in got[b]])
        assert np.array_equal(y, one[0].cpu().numpy()), b
        assert all(int(r["out"][1]) == int(one[1]) for r in got[b]), b


def test_gpipe_two_stages_on_the_card_match_one_process(gen):
    """GPipe LeNet over two gloo ranks on cuda:0 at one microbatch (the
    stage boundary crosses as host copies by send / recv): the single
    process's train step on the same batch, byte for byte; each stage
    launches K1."""
    import numpy as np

    from mandheling_tpu_torch.data import onehot_padded, synthetic_mnist
    from mandheling_tpu_torch.models import lenet_niti
    from mandheling_tpu_torch.parallel import distributed, quantize_microbatches, runs

    _ranks_ready()
    x, y = synthetic_mnist(64, seed=5)
    xf, oh = x.astype(np.float32), onehot_padded(y, 10, 12)
    x_d, x_e = quantize_microbatches(torch.from_numpy(xf), 1)
    spec = dict(model=lenet_niti(), params=_lenet_start(), device="cuda", mb_shape=(64, 28, 28, 1),
                n_stages=2, n_microbatches=1, microbatches=[(x_d.numpy(), x_e.numpy(), oh[None])])
    stages = distributed.run_local(2, runs.gpipe_steps, spec, timeout_s=300)
    one = runs.dp_steps(dict(model=lenet_niti(), params=_lenet_start(), device="cuda",
                             batches=[(xf, oh)], world=0))
    got = [p for r in sorted(stages, key=lambda r: r["coords"]["pipe"]) for p in r["params"]]
    assert _same_weights(got, one["params"])
    assert all(abs(r["losses"][0] - one["losses"][0]) < 1e-5 for r in stages)
    assert all(r["launches"]["matmul_int8"] > 0 for r in stages)


# The compiled step (train/step_graph.py): (model, batch, side, channels, the r5 recipe)
GRAPH_NETS = {
    "lenet_b64": ("lenet_niti", 64, 28, 1, False),
    "mnv2_recipe_b32": ("mobilenet_v2_niti", 32, 32, 3, True),
    "resnet18_b8": ("resnet18_niti", 8, 32, 3, False),
}


def _graph_batches(batch, side, channels, n, seed=0):
    """n seeded integer-pixel batches on the card and their padded one-hot
    labels (10 classes in 12 channels), and eval labels."""
    import numpy as np

    from mandheling_tpu_torch.data import onehot_padded

    rng = np.random.default_rng(seed)
    xs = [torch.from_numpy(rng.integers(0, 256, (batch, side, side, channels))
                           .astype(np.float32)).cuda() for _ in range(n)]
    ys = rng.integers(0, 10, (n, batch))
    ohs = [torch.from_numpy(onehot_padded(y, 10, 12)).cuda() for y in ys]
    return xs, ohs, torch.from_numpy(ys[0]).cuda()


def _graph_model(name, recipe):
    import mandheling_tpu_torch.models as models

    kw = {"dw_per_channel": True} if recipe else {}
    model = getattr(models, name)(**kw)
    return model.reset_parameters(torch.Generator().manual_seed(0)).to("cuda")


def _run_steps(name, recipe, mode, compiled, xs, ohs, labels):
    """Train steps on (xs, ohs), then two eval steps, eager or compiled ->
    (params, losses, correct counts, family launches of each call)."""
    from mandheling_tpu_torch.ops.conv import use_fused_conv_mode
    from mandheling_tpu_torch.ops.depthwise import recipe_margins
    from mandheling_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from mandheling_tpu_torch.train import (jit_eval_step, jit_train_step, make_eval_step,
                                            make_train_step)

    model = _graph_model(name, recipe)
    step, evals = ((jit_train_step(model), jit_eval_step(model)) if compiled else
                   (make_train_step(model), make_eval_step(model)))
    losses, correct, launches = [], [], []
    margins = recipe_margins() if recipe else contextlib.nullcontext()
    with use_fused_conv_mode(mode), margins:
        for x, oh in zip(xs, ohs):
            reset_launch_counts()
            losses.append(step(x, oh))
            torch.cuda.synchronize()
            launches.append(launch_counts())
        for _ in range(2):
            correct.append(evals(xs[0], labels))
    torch.cuda.synchronize()
    reset_launch_counts()
    return ([t.clone() for t in model.buffers()], [float(v) for v in losses],
            [int(c) for c in correct], launches, step)


@pytest.mark.parametrize("mode", ["matmul_only", "all"])
@pytest.mark.parametrize("net", list(GRAPH_NETS))
def test_compiled_step_replays_the_eager_bytes(gen, net, mode):
    """4 train steps (the first the warm-up and capture, then 3 replays) and
    2 eval steps through jit_train_step / jit_eval_step against the eager
    steps from the same params on the same batches: params, losses and
    correct counts byte-identical; every replayed step counts the eager
    step's launches; the kernels' per-stream state is back at its initial
    value after the replays."""
    from mandheling_tpu_torch.ops.kernels import stream_state

    name, batch, side, channels, recipe = GRAPH_NETS[net]
    xs, ohs, labels = _graph_batches(batch, side, channels, 4)
    eager = _run_steps(name, recipe, mode, False, xs, ohs, labels)
    graph = _run_steps(name, recipe, mode, True, xs, ohs, labels)
    assert all(torch.equal(a, b) for a, b in zip(eager[0], graph[0]))
    assert eager[1:3] == graph[1:3]
    assert all(g == eager[3][0] for g in graph[3]) and sum(eager[3][0].values()) > 0
    assert graph[4].graphs == 1
    for key, t in stream_state._STATE.items():
        if key[0] in ("fused_conv_state", "requant_int32_state"):
            assert t.tolist() == [-(2**31), 0], key
        elif key[0] in ("fused_dwconv_ticket", "fused_dwconv_fgrad_state"):
            assert not bool(t.any()), key


def test_compiled_step_captures_a_graph_per_batch_shape(gen):
    """A second batch shape captures a second graph; each replays its own
    shape's bytes, as the eager step gives them."""
    from mandheling_tpu_torch.train import jit_train_step, make_train_step

    runs = []
    for compiled in (False, True):
        model = _graph_model("lenet_niti", False)
        step = jit_train_step(model) if compiled else make_train_step(model)
        losses = []
        for batch in (64, 32, 64, 32):
            xs, ohs, _ = _graph_batches(batch, 28, 1, 1, seed=batch)
            losses.append(float(step(xs[0], ohs[0])))
        runs.append(([t.clone() for t in model.buffers()], losses))
        if compiled:
            assert step.graphs == 2
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert runs[0][1] == runs[1][1]


def test_compiled_step_does_not_replay_a_stale_mode(gen):
    """Captured under fused mode "matmul_only", then called under "all": a
    new graph, which launches K3 (the old one launches none), with the eager
    "all" step's bytes."""
    from mandheling_tpu_torch.ops.conv import use_fused_conv_mode
    from mandheling_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from mandheling_tpu_torch.train import jit_train_step, make_train_step

    xs, ohs, _ = _graph_batches(64, 28, 1, 3, seed=1)
    runs = []
    for compiled in (False, True):
        model = _graph_model("lenet_niti", False)
        step = jit_train_step(model) if compiled else make_train_step(model)
        k3 = []
        for x, oh, mode in zip(xs, ohs, ("matmul_only", "all", "all")):
            reset_launch_counts()
            with use_fused_conv_mode(mode):
                step(x, oh)
            torch.cuda.synchronize()
            k3.append(launch_counts()["fused_conv_max"])
        runs.append(([t.clone() for t in model.buffers()], k3))
        if compiled:
            assert step.graphs == 2
    reset_launch_counts()
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert runs[0][1] == runs[1][1] and runs[1][1][0] == 0 and runs[1][1][1] > 0


def test_compiled_step_capture_failure_raises(gen):
    """A step that reads a device value on the host cannot be captured: the
    call raises, and so does the next, which runs nothing eagerly in its
    place. The capture stream is usable again afterwards."""
    from mandheling_tpu_torch.train.step_graph import compile_step

    def step(x):
        return x * int(x.sum().item())

    compiled = compile_step(step, "cuda")
    x = torch.ones(4, device="cuda")
    for _ in range(2):
        with pytest.raises(RuntimeError):
            compiled(x)
    assert compiled.graphs == 0
    doubled = compile_step(lambda t: 2 * t, "cuda")
    assert [float(doubled(x + i).sum()) for i in range(3)] == [8.0, 16.0, 24.0]


def _qat_batches(n, batch=64):
    import numpy as np

    rng = np.random.default_rng(11)
    xs = [torch.from_numpy(((rng.integers(0, 256, (batch, 28, 28, 1)) / 255.0 - 0.5) * 2.0)
                           .astype(np.float32)).cuda() for _ in range(n)]
    ohs = [torch.eye(10, device="cuda")[torch.from_numpy(rng.integers(0, 10, batch)).cuda()]
           for _ in range(n)]
    return xs, ohs


def test_compiled_qat_steps_replay_the_eager_dropout(gen):
    """MnistInt8Train's and DistillTrainQuant's steps through compile_step,
    dropout drawn from a CUDA generator registered with the graph: 6 steps
    (the first the capture, then replays) bitwise the 6 eager steps from the
    same seeds, under cudnn.deterministic; one graph each."""
    from mandheling_tpu_torch.models import LeNetFP32
    from mandheling_tpu_torch.models.lenet_qat import LeNetQAT
    from mandheling_tpu_torch.train.qat_train import make_distill_step, make_qat_train_step
    from mandheling_tpu_torch.train.step_graph import compile_step

    xs, ohs = _qat_batches(6)
    lrs = [torch.full((), 0.01 / (i + 1), device="cuda") for i in range(6)]
    teacher = LeNetFP32().reset_parameters(torch.Generator().manual_seed(0)).cuda()
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for kind in ("qat", "distill"):
            runs = []
            for compiled in (False, True):
                model = LeNetQAT().reset_parameters(torch.Generator().manual_seed(0)).cuda()
                g = torch.Generator(device="cuda").manual_seed(5)
                step = (make_qat_train_step(model, g) if kind == "qat"
                        else make_distill_step(model, teacher, g))
                step = compile_step(step, "cuda") if compiled else step
                args = [(x, oh, lr) if kind == "qat" else (x, oh) for x, oh, lr in
                        zip(xs, ohs, lrs)]
                losses = [step(*a).clone() for a in args]
                torch.cuda.synchronize()
                runs.append((losses, [t.clone() for t in model.state_dict().values()], step))
            (le, se, _), (lc, sc, step) = runs
            assert all(torch.equal(a, b) for a, b in zip(le, lc)), kind
            assert all(torch.equal(a, b) for a, b in zip(se, sc)), kind
            assert step.graphs == 1
    finally:
        torch.backends.cudnn.deterministic = prev


def test_per_op_profile_of_the_compiled_lenet_step(gen):
    """per_op_profile of 2 replays of the compiled LeNet b64 step: K1's
    category holds 2 x 11 launches with their flops; flops_per_step on the
    card equals the CPU's in both fused modes."""
    from mandheling_tpu_torch.models import lenet_niti
    from mandheling_tpu_torch.ops.conv import use_fused_conv_mode
    from mandheling_tpu_torch.train import jit_train_step, make_train_step
    from mandheling_tpu_torch.utils import profiler

    x = torch.randint(0, 256, (64, 28, 28, 1), generator=gen, device="cuda").float()
    oh = torch.zeros((64, 12), dtype=torch.int32, device="cuda")
    oh[:, 3] = 1
    model = lenet_niti().reset_parameters(torch.Generator().manual_seed(0)).cuda()
    rows, cats = profiler.per_op_profile(jit_train_step(model), x, oh, iters=2)
    k1 = {c["category"]: c for c in cats}["matmul_int8"]
    assert k1["occurrences"] == 22 and k1["flops"] > 0
    counts = set()
    for mode in ("matmul_only", "all"):
        with use_fused_conv_mode(mode):
            for dev in ("cpu", "cuda"):
                m = lenet_niti().reset_parameters(torch.Generator().manual_seed(0)).to(dev)
                counts.add(profiler.flops_per_step(make_train_step(m), x.to(dev), oh.to(dev)))
    assert len(counts) == 1 and 2 * counts.pop() == sum(c["flops"] for c in cats)


def test_spans_mark_the_compiled_lenet_step_on_one_clock(gen):
    """The compiled LeNet b64 step fed by to_device under profiler.spans:
    one device interval a step call and a batch copy, each inside the
    recording's anchors, none resolved more than 20 us before the host
    recorded it; step.graph_kernels per replay equals the kernels
    torch.profiler sees a replayed call launch (memcpy and memset apart)."""
    import numpy as np

    from mandheling_tpu_torch.data import onehot_padded, to_device
    from mandheling_tpu_torch.models import lenet_niti
    from mandheling_tpu_torch.train import jit_train_step
    from mandheling_tpu_torch.utils import device_trace, profiler

    rng = np.random.default_rng(3)
    xs = [rng.integers(0, 256, (64, 28, 28, 1)).astype(np.float32) for _ in range(4)]
    ohs = [onehot_padded(rng.integers(0, 10, 64), 10, 12) for _ in range(4)]
    model = lenet_niti().reset_parameters(torch.Generator().manual_seed(0)).cuda()
    step = jit_train_step(model)
    dev = torch.device("cuda")
    step(to_device(xs[0], dev), to_device(ohs[0], dev))  # the capture, outside
    with profiler.spans(dev) as rec:
        for x, oh in zip(xs, ohs):
            step(to_device(x, dev), to_device(oh, dev))
    names = [i.name for i in rec.intervals]
    assert names.count("step.call") == 4 and names.count("loader.to_device") == 8
    lo, hi = rec.anchors_ns
    assert all(lo <= i.start_ns <= i.end_ns <= hi for i in rec.intervals)
    assert rec.lead_ns < 20_000 and abs(rec.drift_ns) < 0.01 * (hi - lo)
    assert rec.counters["step.replays"] == 4 and "step.captures" not in rec.counters
    assert rec.counters["loader.h2d_bytes"] == 4 * (64 * 28 * 28 * 4 + 64 * 12 * 4)
    kernels = rec.counters["step.graph_kernels"] // 4
    x, oh = to_device(xs[0], dev), to_device(ohs[0], dev)
    events = profiler.trace_device_events(step, x, oh, iters=2)
    rows = device_trace.per_op_rows(events)
    traced = sum(r["occurrences"] for r in rows if r["category"] not in ("memcpy", "memset"))
    assert kernels > 0 and traced == 2 * kernels


I32_MIN = -(2**31)


def _k7_values(form, shape, gen, bits=20):
    """K7's values of `form` on the card: "acc" an int32 accumulator,
    "pc_left" / "pc_right" one with per-channel shifts in [0, 12], "sum"
    (int8, int8) and the other (int8 / int16) pairs with unequal exponents."""
    from mandheling_tpu_torch.ops.kernels import requant_int32 as rq

    if form.startswith("sum"):
        ta, tb = {"sum": (torch.int8, torch.int8), "sum16": (torch.int16, torch.int16),
                  "sum8_16": (torch.int8, torch.int16), "sum16_8": (torch.int16, torch.int8)}[form]
        a = torch.randint(torch.iinfo(ta).min, torch.iinfo(ta).max + 1, shape, generator=gen,
                          dtype=ta, device="cuda")
        b = torch.randint(torch.iinfo(tb).min, torch.iinfo(tb).max + 1, shape, generator=gen,
                          dtype=tb, device="cuda")
        e = torch.randint(-12, 3, (2,), generator=gen, dtype=torch.int32, device="cuda")
        return rq.aligned_sum(a, e[0], b, e[1])
    acc = torch.randint(-(2**bits), 2**bits, shape, generator=gen, dtype=torch.int32,
                        device="cuda")
    if form == "acc":
        return rq.Values(acc)
    pc = torch.randint(0, 13, (shape[-1],), generator=gen, dtype=torch.int32, device="cuda")
    return rq.Values(acc, pc_shift=pc if form == "pc_left" else pc.reshape(
        (1,) * (len(shape) - 1) + (-1,)), pc_right=form == "pc_right")


def _k7_equal(v, exps=(), out_bits=7, act=None, margins=(0, 2, 3)):
    """Both phases of K7 against their plain versions on `v`, the forward
    requant (with `exps`, `out_bits`, `act`) and the gradient requant at
    `margins` (int8 outputs only)."""
    from mandheling_tpu_torch.ops.kernels import requant_int32 as rq

    m = rq.absmax_cuda(v)
    assert torch.equal(m, rq.absmax_plain(v)), (int(m), int(rq.absmax_plain(v)))
    y, e = rq.requant_forward_cuda(v, m, exps, out_bits, act)
    y0, e0 = rq.requant_forward_plain(v, m, exps, out_bits, act)
    assert y.dtype == y0.dtype and torch.equal(y, y0) and torch.equal(e, e0)
    if out_bits == 7 and act is None:
        for margin in margins:
            assert torch.equal(rq.requant_grad_cuda(v, m, margin), rq.requant_grad_plain(v, m, margin))


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1023, 4099, 1 << 20, (1 << 22) + 7])
@pytest.mark.parametrize("form", ["acc", "sum", "sum8_16", "sum16_8", "sum16"])
def test_requant_kernel_matches_plain(gen, n, form):
    _k7_equal(_k7_values(form, (n,), gen))


@pytest.mark.parametrize("form", ["pc_left", "pc_right"])
@pytest.mark.parametrize("shape", [(2, 3, 3, 144), (1, 1, 1, 7), (5, 9, 3), (256, 8, 8, 96)])
def test_requant_kernel_per_channel_shifts(gen, form, shape):
    _k7_equal(_k7_values(form, shape, gen, bits=18))


@pytest.mark.parametrize("values", [
    [0] * 40, [I32_MIN] * 9, [I32_MIN, 5, -7] * 5, [1, -1, 0] * 7, [2**24] * 3 + [-5] * 5,
    [2**24 + 1, -3] * 4, [2**30 + 1, -(2**30)] * 6, [2**31 - 1, 12345] * 3,
    [127, -128, 128, 255, 256] * 9, [2, -3, 4] * 11,
])
@pytest.mark.parametrize("offset", [0, 1])
def test_requant_kernel_edges(gen, values, offset):
    """INT32_MIN, all-zero, bw 0 and 1, a max of exactly 2^24 and 2^24 + 1,
    above 2^30; a view one element past an aligned address (scalar path);
    exps that make every relu6 cap and shift 0, 1 (promoted to 2) and more."""
    from mandheling_tpu_torch.ops.kernels import requant_int32 as rq

    base = torch.tensor([0] * offset + values, dtype=torch.int32, device="cuda")
    acc = base[offset:]
    for exps in [(), (torch.tensor(-9, dtype=torch.int32, device="cuda"),),
                 (torch.tensor(2, dtype=torch.int32, device="cuda"),
                  torch.tensor(-1, dtype=torch.int32, device="cuda"))]:
        _k7_equal(acc, exps)
        _k7_equal(acc, exps, out_bits=15)
        _k7_equal(acc, exps, act="relu6")


@pytest.mark.parametrize("bits", range(0, 31, 3))
def test_requant_kernel_every_shift(gen, bits):
    """Maxima from 2^0 to 2^30: forward shifts 0, 2 and above, relu6 at
    exponents from -8 to 4 (caps 127 down to 0), grad margins 0, 2, 3."""
    acc = torch.randint(-(2**bits), 2**bits + 1, (3001,), generator=gen, dtype=torch.int32,
                        device="cuda")
    for e in range(-8, 5):
        _k7_equal(acc, (torch.tensor(e, dtype=torch.int32, device="cuda"),), act="relu6")
    _k7_equal(acc, out_bits=15)


def _k7_site_cases(name, batch):
    """The requant sites of one train step and one eval step of a benchmark
    model at `batch`, rehearsed on the meta device: (form, shape, exps given,
    out_bits, act, margin or None) each."""
    from mandheling_tpu_torch.models import mobilenet_v2_niti, resnet18_niti
    from mandheling_tpu_torch.ops.depthwise import recipe_margins
    from mandheling_tpu_torch.ops.kernels import requant_int32 as rq
    from mandheling_tpu_torch.train import make_eval_step, make_train_step

    sites = set()

    def form(v):
        if v.b is not None:
            return {(torch.int8, torch.int8): "sum", (torch.int16, torch.int16): "sum16",
                    (torch.int8, torch.int16): "sum8_16"}.get((v.a.dtype, v.b.dtype), "sum16_8")
        if v.pc_shift is None:
            return "acc"
        return "pc_right" if v.pc_right else "pc_left"

    real_f, real_g = rq.requant_forward, rq.requant_grad

    def fwd(v, m, exps=(), out_bits=7, act=None):
        w = rq._values(v)
        sites.add((form(w), tuple(w.a.shape), len(exps), out_bits, act, None))
        return real_f(v, m, exps, out_bits, act)

    def grad(v, m, margin):
        w = rq._values(v)
        sites.add((form(w), tuple(w.a.shape), 0, 7, None, margin))
        return real_g(v, m, margin)

    model = (mobilenet_v2_niti(dw_per_channel=True) if name == "mnv2_recipe"
             else resnet18_niti()).to("meta")
    x = torch.zeros((batch, 32, 32, 3), device="meta")
    oh = torch.zeros((batch, 12), dtype=torch.int32, device="meta")
    margins = recipe_margins() if name == "mnv2_recipe" else contextlib.nullcontext()
    rq.requant_forward, rq.requant_grad = fwd, grad
    try:
        with margins:
            make_train_step(model)(x, oh)
            make_eval_step(model)(x, torch.zeros(batch, dtype=torch.int64, device="meta"))
    finally:
        rq.requant_forward, rq.requant_grad = real_f, real_g
    return sorted(sites, key=repr)


@pytest.mark.parametrize("name,batch", [("mnv2_recipe", 256), ("mnv2_recipe", 32),
                                        ("resnet18", 256), ("resnet18", 32)])
def test_requant_kernel_at_the_benchmark_sites(gen, name, batch):
    """K7 byte-equal to its plain version at every non-fused requant site of
    the benchmark's models (the MobileNetV2 recipe, ResNet-18) at batch 256
    and 32, each site in its own form, mode, exps, out_bits, act and margin,
    on random values."""
    from mandheling_tpu_torch.ops.kernels import requant_int32 as rq

    sites = _k7_site_cases(name, batch)
    assert len(sites) > 5
    for form, shape, n_exps, out_bits, act, margin in sites:
        v = _k7_values(form, shape, gen)
        m = rq.absmax_cuda(v)
        assert torch.equal(m, rq.absmax_plain(v)), (form, shape)
        if margin is None:
            exps = tuple(torch.randint(-8, 2, (n_exps,), generator=gen, dtype=torch.int32,
                                       device="cuda"))
            y, e = rq.requant_forward_cuda(v, m, exps, out_bits, act)
            y0, e0 = rq.requant_forward_plain(v, m, exps, out_bits, act)
            assert torch.equal(y, y0) and torch.equal(e, e0), (form, shape, act)
        else:
            assert torch.equal(rq.requant_grad_cuda(v, m, margin),
                               rq.requant_grad_plain(v, m, margin)), (form, shape, margin)


def test_requant_kernel_replayed_in_a_graph(gen):
    """Both phases captured in a CUDA graph (the state made on the capturing
    stream first) and replayed twice: the same bytes as the eager calls, and
    the stream's phase-1 state back to {INT32_MIN, 0}."""
    from mandheling_tpu_torch.ops.kernels import requant_int32 as rq
    from mandheling_tpu_torch.ops.kernels import stream_state

    acc = torch.randint(-(2**22), 2**22, (64, 16, 16, 96), generator=gen, dtype=torch.int32,
                        device="cuda")
    v = _k7_values("sum", (4099,), gen)
    exp = torch.tensor(-6, dtype=torch.int32, device="cuda")

    def calls():
        y, e = rq.requant_forward(acc, rq.absmax(acc), (exp,), act="relu6")
        g = rq.requant_grad(acc, rq.absmax(acc), 2)
        s, es = rq.requant_forward(v, rq.absmax(v))
        return y, e, g, s, es

    want = calls()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        calls()  # the stream's state, made outside the capture
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            got = calls()
    torch.cuda.current_stream().wait_stream(stream)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    states = [t for key, t in stream_state._STATE.items() if key[0] == "requant_int32_state"]
    assert len(states) >= 2 and all(t.tolist() == [I32_MIN, 0] for t in states)


# K8 (ops/kernels/pool_concat_int8.py): the pools and concats of an
# Inception-v3 train step at 299, batch 32, and ragged forms.
K8_MAXPOOLS = [(32, 147, 147, 64), (32, 71, 71, 192), (32, 35, 35, 288), (32, 17, 17, 768)]
K8_AVGPOOLS = [(32, 35, 35, 192), (32, 35, 35, 256), (32, 35, 35, 288), (32, 17, 17, 768),
               (32, 8, 8, 1280), (32, 8, 8, 2048)]
K8_CONCATS = [(35, (64, 64, 96, 32)), (35, (64, 64, 96, 64)), (17, (384, 96, 288)),
              (17, (192, 192, 192, 192)), (8, (320, 192, 768)), (8, (384, 384)),
              (8, (320, 768, 768, 192))]


def _k8_int8(shape, gen, flavor):
    """int8 values over the whole range, or from four values (ties in
    every window), or the rails and zero."""
    if flavor == "random":
        return rand_int8(shape, gen)
    pick = torch.tensor([-2, 0, 1, 5] if flavor == "ties" else [-128, -127, 0, 127],
                        dtype=torch.int8, device="cuda")
    return pick[torch.randint(0, 4, shape, generator=gen, device="cuda")]


@pytest.mark.parametrize("flavor", ["random", "ties", "extremes"])
@pytest.mark.parametrize("shape", K8_MAXPOOLS, ids=str)
def test_k8_maxpool_matches_plain_at_inception_b32(gen, shape, flavor):
    from mandheling_tpu_torch.ops.kernels import pool_concat_int8 as pc

    x = _k8_int8(shape, gen, flavor)
    y = pc.maxpool_cuda(x, (3, 3), (2, 2))
    assert torch.equal(y, pc.maxpool_plain(x, (3, 3), (2, 2)))
    gy = _k8_int8(tuple(y.shape), gen, flavor)
    assert torch.equal(pc.maxpool_grad_cuda(x, y, gy, (3, 3), (2, 2)),
                       pc.maxpool_grad_plain(x, y, gy, (3, 3), (2, 2)))
    # gy as the concat's backward hands it: a channel slice of a wider tensor
    wide = _k8_int8(tuple(y.shape[:3]) + (y.shape[3] + 48,), gen, flavor)
    part = wide[..., 32:32 + y.shape[3]]
    assert torch.equal(pc.maxpool_grad_cuda(x, y, part, (3, 3), (2, 2)),
                       pc.maxpool_grad_plain(x, y, part, (3, 3), (2, 2)))


@pytest.mark.parametrize("flavor", ["random", "extremes"])
@pytest.mark.parametrize("shape", K8_AVGPOOLS, ids=str)
def test_k8_avgpool_matches_plain_at_inception_b32(gen, shape, flavor):
    from mandheling_tpu_torch.ops.kernels import pool_concat_int8 as pc

    x = _k8_int8(shape, gen, flavor)
    y = pc.avgpool_cuda(x, (3, 3), (1, 1), 1)
    assert torch.equal(y, pc.avgpool_plain(x, (3, 3), (1, 1), 1))
    gy = _k8_int8(tuple(y.shape), gen, flavor)
    assert torch.equal(pc.avgpool_grad_cuda(gy, shape[1:3], (3, 3), (1, 1), 1),
                       pc.avgpool_grad_plain(gy, shape[1:3], (3, 3), (1, 1), 1))


@pytest.mark.parametrize("shape,window,stride", [
    ((2, 9, 11, 5), (3, 3), (2, 2)), ((3, 7, 7, 12), (2, 2), (2, 2)),
    ((2, 8, 8, 20), (3, 3), (1, 1)), ((1, 10, 9, 16), (3, 2), (2, 3)),
    ((64, 24, 24, 20), (2, 2), (2, 2)), ((2, 13, 13, 1), (3, 3), (2, 2))])
@pytest.mark.parametrize("flavor", ["random", "ties", "extremes"])
def test_k8_maxpool_ragged_forms(gen, shape, window, stride, flavor):
    """Odd sizes, channel runs of 1 and 4, disjoint windows (whose -128
    passes unclipped) and overlapping ones."""
    from mandheling_tpu_torch.ops.kernels import pool_concat_int8 as pc

    x = _k8_int8(shape, gen, flavor)
    y = pc.maxpool_cuda(x, window, stride)
    assert torch.equal(y, pc.maxpool_plain(x, window, stride))
    gy = _k8_int8(tuple(y.shape), gen, flavor)
    assert torch.equal(pc.maxpool_grad_cuda(x, y, gy, window, stride),
                       pc.maxpool_grad_plain(x, y, gy, window, stride))


@pytest.mark.parametrize("shape,window,stride,pad", [
    ((2, 9, 11, 5), (3, 3), (1, 1), 1), ((1, 7, 7, 12), (2, 2), (2, 2), 0),
    ((2, 8, 8, 4), (3, 3), (2, 2), 1), ((1, 10, 9, 16), (5, 3), (1, 2), 2),
    ((2, 3, 3, 48), (3, 3), (1, 1), 1)])
@pytest.mark.parametrize("flavor", ["random", "extremes"])
def test_k8_avgpool_ragged_forms(gen, shape, window, stride, pad, flavor):
    from mandheling_tpu_torch.ops.kernels import pool_concat_int8 as pc

    x = _k8_int8(shape, gen, flavor)
    y = pc.avgpool_cuda(x, window, stride, pad)
    assert torch.equal(y, pc.avgpool_plain(x, window, stride, pad))
    gy = _k8_int8(tuple(y.shape), gen, flavor)
    assert torch.equal(pc.avgpool_grad_cuda(gy, shape[1:3], window, stride, pad),
                       pc.avgpool_grad_plain(gy, shape[1:3], window, stride, pad))


@pytest.mark.parametrize("exps", ["equal", "unequal", "wide"])
@pytest.mark.parametrize("side,channels", K8_CONCATS + [(5, (7, 12, 3)), (4, (8, 4)), (3, (16,))],
                         ids=str)
def test_k8_concat_matches_plain(gen, side, channels, exps):
    """Every concat of an Inception-v3 b32 step, and channel runs of 1 and
    4; the exponents equal, unequal, and 40 apart (a shift past 31)."""
    from mandheling_tpu_torch.ops.kernels import pool_concat_int8 as pc

    datas = [rand_int8((32, side, side, c), gen) for c in channels]
    spread = {"equal": 0, "unequal": 6, "wide": 40}[exps]
    es = [torch.tensor(-3 + (spread * i) % (spread + 1), dtype=torch.int32, device="cuda")
          for i in range(len(channels))]
    y, e = pc.concat_cuda(datas, es)
    y0, e0 = pc.concat_plain(datas, es)
    assert torch.equal(y, y0) and int(e) == int(e0)


def test_k8_nested_concat_and_sliced_branch(gen):
    """A concat of a concat's output, and a branch that is a channel slice
    of a wider tensor (rows at its stride)."""
    from mandheling_tpu_torch.ops.kernels import pool_concat_int8 as pc

    a, b = rand_int8((32, 8, 8, 384), gen), rand_int8((32, 8, 8, 384), gen)
    wide = rand_int8((32, 8, 8, 512), gen)
    e = [torch.tensor(v, dtype=torch.int32, device="cuda") for v in (2, -1, 5)]
    inner, ei = pc.concat_cuda([a, b], e[:2])
    inner0, ei0 = pc.concat_plain([a, b], e[:2])
    assert torch.equal(inner, inner0) and int(ei) == int(ei0)
    got = pc.concat_cuda([wide[..., 16:336], inner], [e[2], ei])
    assert torch.equal(got[0], pc.concat_plain([wide[..., 16:336], inner0], [e[2], ei0])[0])


def test_k8_replayed_in_a_graph(gen):
    """The five kernels captured in a CUDA graph and replayed after the
    inputs and the concat's exponents change in place: the bytes the eager
    calls give on the new values (the exponents are read on the device)."""
    from mandheling_tpu_torch.ops.kernels import pool_concat_int8 as pc

    x = rand_int8((4, 35, 35, 64), gen)
    gy = rand_int8((4, 17, 17, 64), gen)
    exps = [torch.tensor(v, dtype=torch.int32, device="cuda") for v in (0, 3)]

    def calls():
        y = pc.maxpool_cuda(x, (3, 3), (2, 2))
        gx = pc.maxpool_grad_cuda(x, y, gy, (3, 3), (2, 2))
        a = pc.avgpool_cuda(x, (3, 3), (1, 1), 1)
        ga = pc.avgpool_grad_cuda(a, (35, 35), (3, 3), (1, 1), 1)
        return (y, gx, a, ga) + pc.concat_cuda([a, x], exps)

    calls()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = calls()
    x.copy_(rand_int8(tuple(x.shape), gen))
    gy.copy_(rand_int8(tuple(gy.shape), gen))
    exps[0].fill_(7)
    graph.replay()
    torch.cuda.synchronize()
    want = calls()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(got[5]) == 7
