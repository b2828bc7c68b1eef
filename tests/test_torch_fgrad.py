"""K5, the depthwise filter-grad accumulator, its route and the per-channel
transform, against the JAX package, byte for byte:

- K5's plain version (``kernels/fused_dwconv_int8.dwconv_fgrad_acc_plain``,
  which the dispatcher takes on a CPU tensor) against the Pallas kernel
  ``dwconv_fgrad_acc_pallas`` in interpret mode on a pre-padded input, at
  3x3, 5x5, 3x1 and 1x3, ragged C, and sums that wrap past 2^31; with x
  unpadded, its pads and strides 1, 2 and 3 against the JAX package's
  batch-grouped conv, the wrap at stride 2 included; `supports_fgrad`
  against the cases where the JAX kernel returns None, and `fgrad_takes`
  (what K5 takes);
- the routed ``dwconv2d_filter_grad`` against the JAX one (a batch-grouped
  conv) at stride 1 and 2, per-tensor and per-channel, margins 0 and 2,
  under both port backends, with K5's dispatcher called exactly where the
  route says (every stride under "cuda");
- ``nn.transform.dw_to_per_channel`` against the JAX transform.

The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mandheling_tpu.models import mobilenet_v2_niti as j_mobilenet_v2_niti
from mandheling_tpu.nn import transform as jtransform
from mandheling_tpu.ops import depthwise as jdw
from mandheling_tpu.ops.kernels import fused_dwconv_int8 as jfdw
from mandheling_tpu_torch.models import mobilenet_v2_niti
from mandheling_tpu_torch.nn import NITIDepthwiseConv2D, ResidualBlock, dw_to_per_channel
from mandheling_tpu_torch.nn.transform import ceil_log2
from mandheling_tpu_torch.ops import depthwise as tdw
from mandheling_tpu_torch.ops.kernels import fused_dwconv_int8 as tfdw
from mandheling_tpu_torch.ops.kernels import use_backend
from mandheling_tpu_torch.utils.jax_params import export_jax_params, load_jax_params


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
    return torch.from_numpy(np.asarray(a))


def rand_int8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def to_numpy(params):
    """JAX params -> the carrier's layout with numpy arrays, nested lists kept."""
    if isinstance(params, list):
        return [to_numpy(p) for p in params]
    if not params:
        return ()
    return {"w": (np.asarray(params["w"].data), np.asarray(params["w"].exp))}


@pytest.mark.parametrize("xp_shape,kernel", [
    ((4, 18, 18, 24), (3, 3)), ((3, 11, 45, 33), (3, 3)), ((2, 9, 9, 7), (3, 3)),
    ((2, 13, 13, 24), (5, 5)), ((2, 12, 40, 40), (3, 1)), ((1, 7, 37, 65), (1, 3)),
])
def test_fgrad_plain_matches_pallas(xp_shape, kernel):
    rng = np.random.default_rng(sum(xp_shape) + kernel[0])
    b, hp, wp, c = xp_shape
    xp = rand_int8(rng, xp_shape)
    gy = rand_int8(rng, (b, hp - kernel[0] + 1, wp - kernel[1] + 1, c))
    want = jfdw.dwconv_fgrad_acc_pallas(jnp.asarray(xp), jnp.asarray(gy), kernel, interpret=True)
    got = tfdw.dwconv_fgrad_acc(t(xp), t(gy), kernel)
    assert got.dtype == torch.int32 and tuple(got.shape) == kernel + (1, c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fgrad_plain_wraps_like_pallas():
    """36 x 61 x 61 products of (-128)^2 = 2^14 per channel pass 2^31: the
    int32 sums wrap, in both."""
    xp = np.full((36, 63, 63, 2), -128, np.int8)
    gy = np.full((36, 61, 61, 2), -128, np.int8)
    true_sum = 36 * 61 * 61 * 2**14
    assert true_sum > 2**31
    want = jfdw.dwconv_fgrad_acc_pallas(jnp.asarray(xp), jnp.asarray(gy), (3, 3), interpret=True)
    got = tfdw.dwconv_fgrad_acc_plain(t(xp), t(gy), (3, 3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == (true_sum + 2**31) % 2**32 - 2**31).all()


@pytest.mark.parametrize("xp_shape,gy_shape,kernel,stride", [
    ((256, 34, 34, 144), (256, 32, 32, 144), (3, 3), (1, 1)),
    ((256, 6, 6, 960), (256, 4, 4, 960), (3, 3), (1, 1)),
    ((256, 34, 34, 144), (256, 16, 16, 144), (3, 3), (2, 2)),
    ((256, 34, 34, 144), (256, 31, 31, 144), (3, 3), (1, 1)),
    ((1, 66, 66, 600), (1, 64, 64, 600), (3, 3), (1, 1)),
    ((2, 13, 13, 24), (2, 9, 9, 24), (5, 5), (1, 1)),
])
def test_supports_fgrad_is_the_jax_rule(xp_shape, gy_shape, kernel, stride):
    """The port routes K5 exactly where the JAX kernel computes (and does
    not return None)."""
    got = jax.eval_shape(
        lambda a, b: jfdw.dwconv_fgrad_acc_pallas(a, b, kernel, stride, interpret=True),
        jax.ShapeDtypeStruct(xp_shape, jnp.int8), jax.ShapeDtypeStruct(gy_shape, jnp.int8))
    assert tfdw.supports_fgrad(xp_shape, gy_shape, kernel, stride) == (got is not None)


@pytest.mark.parametrize("stride", [(1, 1), (2, 2)])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("margin", [0, 2])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_routed_filter_grad_matches_jax(monkeypatch, stride, per_channel, margin, backend):
    rng = np.random.default_rng(11 + stride[0] + 2 * per_channel + margin)
    x = rand_int8(rng, (4, 16, 16, 24))
    gy = rand_int8(rng, (4, 16 // stride[0], 16 // stride[1], 24))
    w_exp = (rng.integers(-12, -4, 24) if per_channel else np.array(-6)).astype(np.int32)
    calls = []
    real = tfdw.dwconv_fgrad_acc

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(tfdw, "dwconv_fgrad_acc", counted)
    jdw.set_dw_fgrad_margin(margin)
    tdw.set_dw_fgrad_margin(margin)
    try:
        want = jdw.dwconv2d_filter_grad(jnp.asarray(x), jnp.asarray(gy), (3, 3), stride, "SAME",
                                        w_exp=jnp.asarray(w_exp) if per_channel else None)
        with use_backend(backend):
            got = tdw.dwconv2d_filter_grad(t(x), t(gy), (3, 3), stride, "SAME",
                                           w_exp=t(w_exp) if per_channel else None)
    finally:
        jdw.set_dw_fgrad_margin(2)
        tdw.set_dw_fgrad_margin(2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # K5 takes x unpadded at every stride under "cuda"
    assert calls == ([(4, 16, 16, 24)] if backend == "cuda" else [])


def _grouped_conv_acc(x, gy, kernel, pads, stride):
    """The JAX package's depthwise filter-grad accumulator: one batch-grouped
    conv with rhs_dilation = stride (mandheling_tpu/ops/depthwise.py), its
    leading kh x kw taps."""
    kh, kw = kernel
    acc = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(gy), (1, 1), pads, rhs_dilation=stride,
        dimension_numbers=("CHWN", "IHWO", "NHWC"), batch_group_count=x.shape[3],
        preferred_element_type=jnp.int32)
    return np.asarray(acc[:, :kh, :kw, :].transpose(1, 2, 0, 3))


@pytest.mark.parametrize("x_shape,kernel,pads,stride", [
    ((4, 16, 16, 24), (3, 3), ((1, 1), (1, 1)), (1, 1)),     # SAME, stride 1
    ((4, 16, 16, 24), (3, 3), ((0, 1), (0, 1)), (2, 2)),     # SAME, stride 2
    ((3, 15, 13, 20), (3, 3), ((0, 1), (0, 1)), (2, 2)),     # odd maps: gy shorter than x/2
    ((2, 17, 19, 33), (3, 3), ((1, 1), (1, 1)), (2, 2)),     # ragged C, SAME on odd maps
    ((2, 9, 14, 7), (3, 3), ((1, 1), (2, 0)), (1, 2)),       # ragged C 7, strides apart
    ((2, 11, 11, 24), (5, 5), ((1, 2), (1, 2)), (2, 2)),     # 5x5 at stride 2
    ((2, 12, 10, 40), (3, 1), ((1, 1), (0, 0)), (2, 1)),     # 3x1
    ((1, 10, 10, 12), (3, 3), ((0, 0), (0, 0)), (3, 3)),     # stride 3, no pads
])
def test_fgrad_plain_with_pads_and_stride_matches_jax(x_shape, kernel, pads, stride):
    """K5's plain version with x unpadded, its pads and a stride (which the
    dispatcher takes on a CPU tensor) against the JAX package's batch-grouped
    conv, byte for byte."""
    rng = np.random.default_rng(sum(x_shape) + 3 * stride[0] + stride[1])
    oh, ow = tfdw.fgrad_out_spatial(x_shape, kernel, pads, stride)
    x = rand_int8(rng, x_shape)
    gy = rand_int8(rng, (x_shape[0], oh, ow, x_shape[3]))
    assert tfdw.fgrad_takes(x.shape, gy.shape, kernel, pads, stride)
    got = tfdw.dwconv_fgrad_acc(t(x), t(gy), kernel, stride, pads=pads)
    assert got.dtype == torch.int32 and tuple(got.shape) == kernel + (1, x_shape[3])
    np.testing.assert_array_equal(got.numpy(), _grouped_conv_acc(x, gy, kernel, pads, stride))


def test_fgrad_plain_wraps_at_stride_2_like_jax():
    """9 x 128 x 128 products of (-128)^2 = 2^14 per channel at stride 2
    pass 2^31: the int32 sums wrap, in both."""
    x = np.full((9, 257, 257, 2), -128, np.int8)
    gy = np.full((9, 128, 128, 2), -128, np.int8)
    pads = ((0, 0), (0, 0))
    true_sum = 9 * 128 * 128 * 2**14
    assert true_sum > 2**31
    got = tfdw.dwconv_fgrad_acc(t(x), t(gy), (3, 3), (2, 2), pads=pads)
    np.testing.assert_array_equal(got.numpy(), _grouped_conv_acc(x, gy, (3, 3), pads, (2, 2)))
    assert (got.numpy() == (true_sum + 2**31) % 2**32 - 2**31).all()


@pytest.mark.parametrize("x_shape,gy_shape,kernel,pads,stride,takes", [
    ((256, 32, 32, 144), (256, 32, 32, 144), (3, 3), ((1, 1), (1, 1)), (1, 1), True),
    ((256, 32, 32, 144), (256, 16, 16, 144), (3, 3), ((0, 1), (0, 1)), (2, 2), True),
    ((256, 34, 34, 144), (256, 32, 32, 144), (3, 3), ((0, 0), (0, 0)), (1, 1), True),
    ((1, 64, 64, 600), (1, 64, 64, 600), (3, 3), ((1, 1), (1, 1)), (1, 1), True),
    ((2, 10, 10, 12), (2, 3, 3, 12), (3, 3), ((0, 0), (0, 0)), (3, 3), True),
    ((2, 10, 10, 12), (2, 2, 3, 12), (3, 3), ((0, 0), (0, 0)), (3, 3), True),   # gy within
    ((2, 10, 10, 12), (2, 4, 3, 12), (3, 3), ((0, 0), (0, 0)), (3, 3), False),  # gy too tall
    ((2, 8, 8, 12), (2, 8, 8, 12), (3, 3), ((1, 1), (-1, 1)), (1, 1), False),   # negative pad
    ((2, 8, 8, 12), (3, 8, 8, 12), (3, 3), ((1, 1), (1, 1)), (1, 1), False),    # batch differs
    ((2, 8, 8, 12), (2, 8, 8, 13), (3, 3), ((1, 1), (1, 1)), (1, 1), False),    # C differs
    ((4096, 512, 512, 4), (4096, 512, 512, 4), (3, 3), ((1, 1), (1, 1)), (1, 1), False),
])
def test_fgrad_takes(x_shape, gy_shape, kernel, pads, stride, takes):
    """What K5 takes: gy within the VALID strided output of x padded by pads
    >= 0, any stride, int32-indexable tensors (the last case has 2^32
    elements); the JAX kernel's rule `supports_fgrad` stays stride 1 only."""
    assert tfdw.fgrad_takes(x_shape, gy_shape, kernel, pads, stride) == takes


def test_ceil_log2_is_the_jax_one():
    """At every value d * 2^e a range of int8 data takes (d <= 127), powers
    of two included, where jnp.log2 lands above the integer at some e."""
    d = np.arange(1, 128, dtype=np.float32)
    e = np.arange(-126, 100, dtype=np.float32)
    x = (d[:, None] * np.float32(2.0) ** e[None, :]).astype(np.float32).ravel()
    x = x[(x >= np.finfo(np.float32).tiny) & np.isfinite(x)]
    want = np.ceil(np.asarray(jnp.log2(jnp.asarray(x)))).astype(np.int32)
    np.testing.assert_array_equal(ceil_log2(torch.from_numpy(x)).numpy(), want)


def _dw_leaves(params, model, pkg_blocks):
    """(data, exp) of every depthwise layer, in layer order."""
    out = []
    for layer, p in zip(model.layers, params):
        if isinstance(layer, pkg_blocks[1]):
            out += _dw_leaves(p, layer.branch, pkg_blocks)
        elif isinstance(layer, pkg_blocks[0]):
            out.append((np.asarray(p["w"][0]), np.asarray(p["w"][1]), layer.per_channel))
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_dw_to_per_channel_matches_jax(seed):
    """Every per-tensor depthwise layer of a width-0.25 MobileNetV2 (17 of
    them, the residual blocks' inside their branches) flips to per-channel
    with the JAX transform's bytes; every other weight is unchanged."""
    from mandheling_tpu.nn.blocks import NITIDepthwiseConv2D as JDw
    from mandheling_tpu.nn.blocks import ResidualBlock as JRes

    jmodel = j_mobilenet_v2_niti(width_mult=0.25)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    start = to_numpy(jparams)
    jmodel, jnew = jtransform.dw_to_per_channel(jmodel, jparams)
    want = to_numpy(jnew)

    model = load_jax_params(mobilenet_v2_niti(width_mult=0.25), start)
    assert dw_to_per_channel(model) is model
    got = export_jax_params(model)
    dws_t = _dw_leaves(got, model, (NITIDepthwiseConv2D, ResidualBlock))
    dws_j = _dw_leaves(want, jmodel, (JDw, JRes))
    assert len(dws_t) == len(dws_j) == 17
    for (dt, et, pc_t), (dj, ej, pc_j) in zip(dws_t, dws_j):
        assert pc_t and pc_j and et.shape == (dt.shape[3],)
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_array_equal(et, ej)
    from mandheling_tpu_torch.utils.jax_params import flat_weights
    for a, b in zip(flat_weights(got), flat_weights(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    dw_to_per_channel(model)  # already per-channel: unchanged
    for a, b in zip(flat_weights(export_jax_params(model)), flat_weights(got)):
        np.testing.assert_array_equal(a, b)


def test_dw_to_per_channel_refuses_parallel_branches():
    """The walk goes into the branches of a ParallelConcat and a ParallelAdd
    (one of them an empty identity branch) and into a Sequential used as a
    layer, as the JAX walk does: every per-tensor depthwise layer there flips to per-channel with the
    JAX transform's bytes, and every other weight is unchanged."""
    import mandheling_tpu.nn.blocks as jblocks
    import mandheling_tpu.nn.layers as jlayers
    import mandheling_tpu.nn.module as jmodule
    import mandheling_tpu_torch.nn.blocks as tblocks
    import mandheling_tpu_torch.nn.layers as tlayers
    import mandheling_tpu_torch.nn.module as tmodule

    def build(blocks, layers, module):
        def dw(c):
            return blocks.NITIDepthwiseConv2D(c, (3, 3), (1, 1), "SAME")

        seq = module.Sequential
        return seq([
            layers.NITIConv2D(3, 8, (3, 3), (1, 1), "SAME"),
            blocks.ParallelConcat([seq([dw(8), layers.NITIRelu()]),
                                   seq([layers.NITIConv2D(8, 4, (1, 1)), dw(4)])]),
            seq([dw(12), blocks.ParallelAdd([seq([dw(12)]), seq([])])]),
        ])

    jmodel = build(jblocks, jlayers, jmodule)
    jparams = jmodel.init(jax.random.PRNGKey(6))
    start = to_numpy(jparams)
    _, jnew = jtransform.dw_to_per_channel(jmodel, jparams)
    model = load_jax_params(build(tblocks, tlayers, tmodule), start)
    assert dw_to_per_channel(model) is model
    got, want = export_jax_params(model), to_numpy(jnew)
    from mandheling_tpu_torch.utils.jax_params import flat_weights
    leaves_got, leaves_want = flat_weights(got), flat_weights(want)
    assert len(leaves_got) == len(leaves_want) == 12
    for a, b in zip(leaves_got, leaves_want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    per_channel = [layer.per_channel for layer in model.modules()
                   if isinstance(layer, NITIDepthwiseConv2D)]
    assert per_channel == [True] * 4
    assert [leaves_got[i].shape for i in (3, 7, 9, 11)] == [(8,), (4,), (12,), (12,)]
