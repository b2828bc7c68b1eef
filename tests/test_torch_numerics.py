"""The port's NITI numerics against the JAX package's, bit for bit: every
shift 0-30 (and clamped ones outside), +/-2^30, INT32_MIN, all-zero
accumulators and both rails."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mandheling_tpu.ops import numerics as jnum
from mandheling_tpu.ops import qtensor as jq
from mandheling_tpu_torch.ops import numerics as tnum
from mandheling_tpu_torch.ops import qtensor as tq

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def adversarial_acc(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    edges = [0, 1, -1, 2, -2, 127, -127, 128, -128, 255, -255, 2**30, -(2**30),
             2**30 - 1, -(2**30) + 1, 2**31 - 1, I32_MIN, I32_MIN + 1]
    edges += [s * (2**k + d) for k in range(31) for d in (-1, 0, 1) for s in (1, -1)
              if -(2**31) <= s * (2**k + d) < 2**31]
    rand = [rng.integers(I32_MIN, I32_MAX, n, dtype=np.int64),
            rng.integers(-(2**16), 2**16, n), rng.integers(-300, 300, n)]
    return np.concatenate([np.array(edges, np.int64)] + rand).astype(np.int32)


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("shift", list(range(-2, 34)))
@pytest.mark.parametrize("rail", [127, 32767])
def test_psto_round_matches_jax(shift, rail):
    acc = adversarial_acc(shift + 2)
    want = np.asarray(jnum.psto_round(jnp.asarray(acc), jnp.int32(shift), rail))
    got = tnum.psto_round(t(acc), torch.tensor(shift, dtype=torch.int32), rail).numpy()
    np.testing.assert_array_equal(got, want)
    got_int = tnum.psto_round(t(acc), shift, rail).numpy()
    np.testing.assert_array_equal(got_int, want)


def test_range_estimate_and_trunc_shift_div():
    acc = adversarial_acc(1)
    for chunk in np.array_split(acc, 64):
        assert int(tnum.range_estimate(t(chunk))) == int(jnum.range_estimate(jnp.asarray(chunk)))
    for m in [0, 1, 2, 3, 4, 5, 2**24, 2**24 + 1, 2**30, 2**30 + 1, I32_MAX, I32_MIN]:
        mm = np.int32(m)
        assert int(tnum.range_estimate_from_max(torch.tensor(mm))) == int(
            jnum.range_estimate_from_max(jnp.int32(mm))), m
    assert int(tnum.range_estimate(torch.zeros(5, dtype=torch.int32))) == 0
    for s in range(31):
        np.testing.assert_array_equal(
            tnum.trunc_shift_div(t(acc), torch.tensor(s, dtype=torch.int32)).numpy(),
            np.asarray(jnum.trunc_shift_div(jnp.asarray(acc), jnp.int32(s))))


def test_forward_shift_and_requant_forward():
    for bw in range(0, 32):
        for out_bits in (7, 15):
            assert int(tnum.forward_shift(torch.tensor(bw, dtype=torch.int32), out_bits)) == int(
                jnum.forward_shift(jnp.int32(bw), out_bits))
    rng = np.random.default_rng(3)
    exp_in = np.int32(-11)
    for scale in [0, 1, 100, 127, 128, 255, 256, 1000, 2**15, 2**20, 2**30]:
        for out_bits in (7, 15):
            acc = np.clip(rng.integers(-scale - 1, scale + 2, (64, 33)), I32_MIN, I32_MAX).astype(np.int32)
            y_j, e_j = jnum.requant_forward(jnp.asarray(acc), jnp.int32(exp_in), out_bits)
            y_t, e_t = tnum.requant_forward(t(acc), torch.tensor(exp_in), out_bits)
            np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
            assert y_t.dtype == (torch.int8 if out_bits == 7 else torch.int16)
            assert int(e_t) == int(e_j)
    with pytest.raises(ValueError):
        tnum.requant_forward(torch.zeros(3, dtype=torch.int32), torch.tensor(0), 8)


@pytest.mark.parametrize("margin", [0, 2, 3])
def test_requant_grad(margin):
    for acc in [adversarial_acc(margin), np.zeros((7, 5), np.int32),
                np.full(9, I32_MIN, np.int32), np.array([1, -1, 0, 3], np.int32)]:
        np.testing.assert_array_equal(
            tnum.requant_grad(t(acc), margin).numpy(),
            np.asarray(jnum.requant_grad(jnp.asarray(acc), margin)))


def test_int8_clip_and_sign():
    acc = adversarial_acc(5)
    np.testing.assert_array_equal(tnum.int8_clip(t(acc)).numpy(),
                                  np.asarray(jnum.int8_clip(jnp.asarray(acc))))
    np.testing.assert_array_equal(tnum.int_sign(t(acc)).numpy(),
                                  np.asarray(jnum.int_sign(jnp.asarray(acc))))


def test_qtensor_quantize_matches_jax():
    """Float standardization: both frameworks do the same float32 ops, the
    sums in another order. Tolerance: exponents equal, data within 1 count
    (a value on a rounding boundary may round the other way)."""
    rng = np.random.default_rng(9)
    for shape in [(4, 28, 28, 1), (5, 3, 3, 20)]:
        x = (rng.normal(0, 1, shape) * 3).astype(np.float32)
        for jf, tf in [(jq.quantize_input, tq.quantize_input),
                       (jq.quantize_weights, tq.quantize_weights)]:
            qj, qt = jf(jnp.asarray(x)), tf(t(x))
            assert int(qt.exp) == int(qj.exp)
            diff = np.abs(qt.data.numpy().astype(np.int32) - np.asarray(qj.data, np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
            np.testing.assert_allclose(qt.dequantize().numpy(), np.asarray(qj.dequantize()),
                                       atol=float(2.0 ** int(qj.exp)))
