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


@pytest.mark.parametrize("m,k,n", [(2048, 12, 500), (300, 100, 70), (1024, 24, 144),
                                   (2047, 37, 513), (5, 3, 2)])
def test_fused_kernels_match_plain(gen, m, k, n):
    a, b = rand_int8((m, k), gen), rand_int8((k, n), gen)
    mx = fmm.matmul_max_cuda(a, b)
    assert torch.equal(mx, fmm.matmul_max_plain(a, b))
    bw = numerics.range_estimate_from_max(mx)
    for shift, grad in [(numerics.forward_shift(bw), False), (torch.zeros_like(bw), False),
                        (bw - 3, True), (bw - 40, True), (bw + 40, True)]:
        got = fmm.matmul_requant_cuda(a, b, shift, grad)
        assert torch.equal(got, fmm.matmul_requant_plain(a, b, shift, grad)), (shift, grad)
