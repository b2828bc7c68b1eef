"""The port's CUDA kernels against their plain versions on the card, at
ragged shapes that catch fragment-layout and masking faults. A CUDA kernel
has no interpret mode, so these tests need an NVIDIA GPU and nvcc; without
them they skip. This file imports no JAX, so it also runs where only the
port is installed, without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

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
        make_qat_train_step(model)(x.to(device), oh.to(device), 0.01,
                                   torch.Generator().manual_seed(3))
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
