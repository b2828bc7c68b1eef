"""The port's copies of the trainer's data path and step timer against the
JAX package's: synthetic MNIST, idx files, the shuffled loader and the
padded one-hot give the same bytes from the same seed."""

import struct

import numpy as np
import pytest

from mandheling_tpu import data as jdata
from mandheling_tpu.data import cifar as jcifar
from mandheling_tpu_torch import data as tdata
from mandheling_tpu_torch.utils.profiler import StepTimer


@pytest.mark.parametrize("n,seed", [(64, 0), (100, 7)])
def test_synthetic_mnist_matches_jax(n, seed):
    xj, yj = jdata.synthetic_mnist(n, seed=seed)
    xt, yt = tdata.synthetic_mnist(n, seed=seed)
    for got, want in ((xt, xj), (yt, yj)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def write_idx(path, arr):
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


def test_idx_files_and_load_or_synthesize(tmp_path):
    rng = np.random.default_rng(1)
    write_idx(tmp_path / tdata.mnist.TRAIN_IMAGES, rng.integers(0, 256, (6, 28, 28)))
    write_idx(tmp_path / tdata.mnist.TRAIN_LABELS, rng.integers(0, 10, 6))
    for train in (True, False):  # no test files: both fall back to synthetic
        got = tdata.load_or_synthesize(str(tmp_path), train, synth_n=40)
        want = jdata.load_or_synthesize(str(tmp_path), train, synth_n=40)
        assert got[2] == want[2] == train
        for g, w in zip(got[:2], want[:2]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        tdata.read_idx(str(tmp_path / tdata.mnist.TRAIN_LABELS)),
        jdata.mnist.read_idx(str(tmp_path / tdata.mnist.TRAIN_LABELS)))
    (tmp_path / "bad").write_bytes(struct.pack(">II", 0x0D01, 1) + b"\0" * 4)
    with pytest.raises(ValueError, match="only ubyte"):
        tdata.read_idx(str(tmp_path / "bad"))


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_batches_match_jax(shuffle):
    x, y = tdata.synthetic_mnist(50, seed=3)
    jl = jdata.DataLoader(x, y, 16, shuffle=shuffle, seed=4)
    tl = tdata.DataLoader(x, y, 16, shuffle=shuffle, seed=4)
    assert len(tl) == len(jl) == 3
    for _ in range(2):  # a new order each epoch
        got, want = list(tl.epoch()), list(jl.epoch())
        assert len(got) == len(want) == 3
        for (gx, gy), (wx, wy) in zip(got, want):
            assert (gx.dtype, gy.dtype) == (np.float32, np.int32)
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    with pytest.raises(ValueError):
        tdata.DataLoader(x, y[:-1], 16)


def test_onehot_padded_matches_jax():
    labels = np.array([0, 9, 3, 3], np.int32)
    got = tdata.onehot_padded(labels, 10, 12)
    np.testing.assert_array_equal(got, jdata.onehot_padded(labels, 10, 12))
    assert got.shape == (4, 12) and got[:, 10:].sum() == 0


def test_step_timer_syncs_each_step():
    synced = []
    timer = StepTimer(lambda: synced.append(1))
    for _ in range(3):
        with timer.step(64):
            pass
    assert len(synced) == 3 and timer.samples_per_sec > 0
    assert timer.summary().startswith("3 steps, ")
    assert StepTimer().samples_per_sec == 0.0


@pytest.mark.parametrize("n,seed", [(64, 0), (40, 1)])
def test_synthetic_cifar_matches_jax(n, seed):
    xj, yj = jcifar.synthetic_cifar(n, seed=seed)
    xt, yt = tdata.synthetic_cifar(n, seed=seed)
    assert xt.dtype == xj.dtype == np.uint8 and xt.shape == (n, 32, 32, 3)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)


def test_cifar_bin_files_and_load_or_synthesize(tmp_path):
    """The CIFAR-10 binary reader (label byte + CHW image) on files written
    here, against the JAX package's; without files, the synthetic stand-in."""
    rng = np.random.default_rng(0)
    for name, n in [(f"data_batch_{i}.bin", 3) for i in range(1, 6)] + [("test_batch.bin", 4)]:
        rec = np.concatenate([rng.integers(0, 10, (n, 1)), rng.integers(0, 256, (n, 3072))], 1)
        rec.astype(np.uint8).tofile(tmp_path / name)
    for train in (True, False):
        xj, yj = jcifar.load_cifar10(str(tmp_path), train)
        xt, yt = tdata.load_cifar10(str(tmp_path), train)
        assert xt.shape == ((15 if train else 4), 32, 32, 3)
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(yt, yj)
        assert tdata.load_or_synthesize_cifar(str(tmp_path), train)[2]
    x, y, real = tdata.load_or_synthesize_cifar(str(tmp_path / "none"), train=False, synth_n=64)
    xj, yj, real_j = jcifar.load_or_synthesize_cifar(str(tmp_path / "none"), train=False,
                                                          synth_n=64)
    assert not real and not real_j and x.shape == (16, 32, 32, 3)
    np.testing.assert_array_equal(x, xj)
