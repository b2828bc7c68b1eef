"""K3's plain version (``kernels/fused_conv_int8.py``) against the JAX
package's banded Pallas kernels in interpret mode, bit for bit; and the
port's conv forward / input grad under fused mode "all" against the JAX
package under `use_backend("pallas_interpret"), use_fused_conv_mode("all")`.
The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mandheling_tpu.ops import conv as jconv
from mandheling_tpu.ops import numerics as jnum
from mandheling_tpu.ops.kernels import fused_conv_int8 as jfc
from mandheling_tpu.ops.kernels import use_backend as j_use_backend
from mandheling_tpu_torch.ops import conv as tconv
from mandheling_tpu_torch.ops import numerics as tnum
from mandheling_tpu_torch.ops.kernels import fused_conv_int8 as tfc
from mandheling_tpu_torch.ops.kernels import use_backend as t_use_backend


def t(a):
    return torch.from_numpy(np.asarray(a))


def rand_int8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


# (x shape, w shape, stride, pads): the shapes of the JAX package's
# test_fused_conv_strided_and_1x1_parity, those of the main paths at batch
# 2 (the MobileNetV2 stem; LeNet's conv1, conv2 and conv2 input grad), and
# ResNet18's 3x3 widths at batch 2 (K = 2304 turns the kernel's ring past 4
# stages; N = 512 takes two tiles).
KERNEL_CASES = [
    ((2, 9, 9, 3), (3, 3, 3, 8), (2, 2), ((0, 1), (0, 1))),
    ((2, 9, 9, 3), (5, 5, 3, 8), (2, 2), ((1, 2), (1, 2))),
    ((2, 33, 33, 8), (3, 3, 8, 16), (2, 2), ((1, 1), (1, 1))),
    ((2, 32, 32, 3), (3, 3, 3, 32), (1, 1), ((1, 1), (1, 1))),
    ((2, 28, 28, 1), (5, 5, 1, 20), (1, 1), ((0, 0), (0, 0))),
    ((2, 12, 12, 20), (5, 5, 20, 52), (1, 1), ((0, 0), (0, 0))),
    ((2, 8, 8, 52), (5, 5, 52, 20), (1, 1), ((4, 4), (4, 4))),
    ((2, 8, 8, 64), (3, 3, 64, 64), (1, 1), ((1, 1), (1, 1))),
    ((2, 8, 8, 64), (3, 3, 64, 128), (2, 2), ((0, 1), (0, 1))),
    ((2, 4, 4, 256), (3, 3, 256, 256), (1, 1), ((1, 1), (1, 1))),
    ((2, 4, 4, 256), (3, 3, 256, 512), (2, 2), ((0, 1), (0, 1))),
]


@pytest.mark.parametrize("x_shape,w_shape,stride,pad", KERNEL_CASES)
def test_fused_conv_plain_matches_pallas(x_shape, w_shape, stride, pad):
    rng = np.random.default_rng(sum(x_shape) + sum(w_shape))
    x, w = rand_int8(rng, x_shape), rand_int8(rng, w_shape)
    kernel = w_shape[:2]
    mx_j = jfc.conv_max_pallas(jnp.asarray(x), jnp.asarray(w), kernel, pad, stride,
                               interpret=True)
    mx_t = tfc.conv_max(t(x), t(w), pad, stride)
    assert mx_t.dtype == torch.int32 and int(mx_t) == int(mx_j)
    bw = int(jnum.range_estimate_from_max(mx_j))
    for shift, grad in [(int(jnum.forward_shift(jnp.int32(bw))), False), (0, False),
                        (-3, False), (bw - 2, True), (bw - 40, True)]:
        y_j = jfc.conv_requant_pallas(jnp.asarray(x), jnp.asarray(w), jnp.int32(shift),
                                      kernel, pad, stride, grad=grad, interpret=True)
        y_t = tfc.conv_requant(t(x), t(w), torch.tensor(shift, dtype=torch.int32), pad,
                               stride, grad)
        np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    wp = x_shape[2] + pad[1][0] + pad[1][1]
    assert tfc.supports(w_shape, wp, stride) == jfc.supports(w_shape, wp, stride)


def test_fused_conv_supports_is_the_jax_rule():
    for w_shape in [(3, 3, 3, 32), (5, 5, 20, 52), (5, 5, 52, 20), (3, 3, 64, 64),
                    (7, 7, 3, 64), (3, 3, 256, 256), (1, 1, 8, 8)]:
        for wp in (6, 16, 34, 58, 226):
            for stride in ((1, 1), (2, 2)):
                assert tfc.supports(w_shape, wp, stride) == jfc.supports(w_shape, wp, stride)


# ResNet18's CIFAR 3x3 convs at b256 (w shape, padded input width, stride):
# the seven `supports` admits, then the 512 -> 512 ones it refuses.
RESNET18_CONVS = [
    ((3, 3, 3, 64), 34, (1, 1)), ((3, 3, 64, 64), 34, (1, 1)), ((3, 3, 64, 128), 33, (2, 2)),
    ((3, 3, 128, 128), 18, (1, 1)), ((3, 3, 128, 256), 17, (2, 2)),
    ((3, 3, 256, 256), 10, (1, 1)), ((3, 3, 256, 512), 9, (2, 2)),
]
RESNET18_REFUSED = [((3, 3, 512, 512), 6, (1, 1))]


@pytest.mark.parametrize("w_shape,wp,stride", RESNET18_CONVS + RESNET18_REFUSED)
def test_fused_conv_supports_resnet18_shapes(w_shape, wp, stride):
    """The port's `supports` agrees with the JAX rule at ResNet18's 3x3
    convs: it admits the seven that fused mode "all" will send to K3 and
    refuses the 512 -> 512 ones."""
    want = (w_shape, wp, stride) in RESNET18_CONVS
    assert tfc.supports(w_shape, wp, stride) == jfc.supports(w_shape, wp, stride) == want


def test_kmajor_weight_is_the_gemm_b():
    """K3's B: the HWIO weight K-major with each kernel row's KW*C bytes
    padded to a multiple of 16; the padded GEMM of the conv's patches (each
    row's taps padded alike) gives the plain version's accumulator."""
    rng = np.random.default_rng(7)
    for x_shape, w_shape, stride, pad in [((2, 9, 9, 3), (3, 3, 3, 8), (2, 2), ((0, 1), (0, 1))),
                                          ((1, 7, 5, 70), (3, 2, 70, 65), (1, 2), ((2, 0), (0, 3))),
                                          ((2, 6, 6, 32), (3, 3, 32, 5), (1, 1), ((1, 1), (1, 1)))]:
        x, w = t(rand_int8(rng, x_shape)), t(rand_int8(rng, w_shape))
        kh, kw, c, oc = w_shape
        r = tfc.run_bytes(w_shape)
        assert r % 16 == 0 and kw * c <= r < kw * c + 16
        wk = tfc.kmajor_weight(w)
        assert tuple(wk.shape) == (oc, kh * r) and wk.is_contiguous()
        rows = wk.reshape(oc, kh, r)
        assert torch.equal(rows[:, :, :kw * c], w.reshape(kh, kw * c, oc).permute(2, 0, 1))
        assert not rows[:, :, kw * c:].any()
        xp = torch.nn.functional.pad(x, (0, 0, pad[1][0], pad[1][1], pad[0][0], pad[0][1]))
        oh, ow = tfc._out_spatial(x, w, pad, stride)
        taps = torch.stack([xp[:, dy:dy + (oh - 1) * stride[0] + 1:stride[0],
                               dx:dx + (ow - 1) * stride[1] + 1:stride[1], :]
                            for dy in range(kh) for dx in range(kw)], dim=3)
        a = torch.nn.functional.pad(taps.reshape(-1, kh, kw * c), (0, r - kw * c))
        acc = a.reshape(-1, kh * r).to(torch.int64) @ wk.to(torch.int64).t()
        want = tfc.conv_acc_plain(x, w, pad, stride).reshape(-1, oc).to(torch.int64)
        assert torch.equal(acc, want)


def test_plain_max_of_empty_is_int32_min():
    x = torch.zeros((0, 9, 9, 3), dtype=torch.int8)
    w = torch.zeros((3, 3, 3, 8), dtype=torch.int8)
    assert int(tfc.conv_max_plain(x, w, ((1, 1), (1, 1)))) == -(2**31)
    assert tnum.abs_max(torch.tensor([-(2**31)], dtype=torch.int32)) == -(2**31)


# (x shape, w shape, stride, padding): the JAX test's shapes, 1x1 included
# (K2's route under "all"), plus LeNet's convs and the MobileNetV2 stem.
ROUTE_CASES = [
    ((2, 9, 9, 3), (3, 3, 3, 8), (2, 2), "SAME"),
    ((2, 9, 9, 3), (5, 5, 3, 8), (2, 2), "SAME"),
    ((2, 33, 33, 8), (3, 3, 8, 16), (2, 2), "SAME"),
    ((4, 16, 16, 256), (1, 1, 256, 128), (1, 1), "VALID"),
    ((4, 16, 16, 256), (1, 1, 256, 128), (2, 2), "VALID"),
    ((2, 28, 28, 1), (5, 5, 1, 20), (1, 1), "VALID"),
    ((2, 12, 12, 20), (5, 5, 20, 52), (1, 1), "VALID"),
    ((2, 32, 32, 3), (3, 3, 3, 32), (1, 1), "SAME"),
]


@pytest.mark.parametrize("x_shape,w_shape,stride,padding", ROUTE_CASES)
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_conv_ops_under_fused_mode_all_match_jax(monkeypatch, x_shape, w_shape, stride,
                                                  padding, backend):
    """The forward and the input grad under "all": the port's "cuda" backend
    routes the non-1x1 convs through K3 (its plain version on a CPU tensor)
    and "torch" through no fused kernel; both give the JAX bytes."""
    rng = np.random.default_rng(sum(x_shape) + sum(w_shape))
    x, w = rand_int8(rng, x_shape), rand_int8(rng, w_shape)
    with j_use_backend("pallas_interpret"), jconv.use_fused_conv_mode("all"):
        y_j, e_j = jconv.conv2d_forward(jnp.asarray(x), jnp.int32(-5), jnp.asarray(w),
                                        jnp.int32(-6), stride, padding)
        gy = rand_int8(rng, np.asarray(y_j).shape)
        g_j = jconv.conv2d_input_grad(jnp.asarray(gy), jnp.asarray(w), x_shape[1:3],
                                      stride, padding)
    calls = []
    real = tfc.conv_max
    monkeypatch.setattr(tfc, "conv_max", lambda *a, **k: calls.append(1) or real(*a, **k))
    with t_use_backend(backend), tconv.use_fused_conv_mode("all"):
        y_t, e_t = tconv.conv2d_forward(t(x), torch.tensor(-5, dtype=torch.int32), t(w),
                                        torch.tensor(-6, dtype=torch.int32), stride, padding)
        g_t = tconv.conv2d_input_grad(t(gy), t(w), x_shape[1:3], stride, padding)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    assert int(e_t) == int(e_j)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    if backend == "torch" or w_shape[:2] == (1, 1):
        assert not calls
    else:  # the forward, and the input grad on the dilated gy
        assert len(calls) == 2


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CPU tensor never reaches a kernel: the `*_cuda` wrappers raise, and
    the dispatching wrappers take the plain version only for a CPU tensor."""
    from mandheling_tpu_torch.ops.kernels import fused_dwconv_int8 as tfdw

    x, w = torch.zeros((1, 5, 5, 3), dtype=torch.int8), torch.zeros((3, 3, 3, 4), dtype=torch.int8)
    s = torch.zeros((), dtype=torch.int32)
    pad = ((1, 1), (1, 1))
    with pytest.raises(ValueError):
        tfc.conv_max_cuda(x, w, pad)
    with pytest.raises(ValueError):
        tfc.conv_requant_cuda(x, w, s, pad)
    xp, wd = torch.zeros((1, 5, 5, 3), dtype=torch.int8), torch.zeros((3, 3, 1, 3), dtype=torch.int8)
    with pytest.raises(ValueError):
        tfdw.dwconv_max_cuda(xp, wd)
    with pytest.raises(ValueError):
        tfdw.dwconv_requant_cuda(xp, wd, s)
    assert int(tfc.conv_max(x, w, pad)) == 0 and int(tfdw.dwconv_max(xp, wd)) == 0
