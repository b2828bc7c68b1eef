"""The port's binding of the native C++ data pipeline (data/native.py) and
`make_loader` (data/loader.py) against the JAX package's: the committed
library loads read-only and is never built; its loader gives the JAX
binding's batches byte for byte, shuffled, in order and augmented; its idx
parser and JPEG decoder give the JAX binding's arrays; `make_loader` takes
the native loader when the library loads and the Python loader otherwise,
as the JAX package's does, and each test asserts which one it took."""

import struct

import numpy as np
import pytest

from mandheling_tpu.data import native as jnative
from mandheling_tpu.data.mnist import read_idx as j_read_idx
from mandheling_tpu_torch.data import loader as tloader
from mandheling_tpu_torch.data import native as tnative
from mandheling_tpu_torch.data import synthetic_mnist
from mandheling_tpu_torch.data.mnist import read_idx


@pytest.fixture(scope="module")
def lib():
    lib = tnative.load_native()
    assert lib is not None, "the committed native/libmandheling_native.so loads on this machine"
    return lib


def _epochs(loader, n=2):
    return [[(x.copy(), y.copy()) for x, y in loader.epoch()] for _ in range(n)]


def _batches_equal(a, b):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert len(ea) == len(eb)
        for (xa, ya), (xb, yb) in zip(ea, eb):
            assert xa.dtype == xb.dtype == np.float32 and xa.tobytes() == xb.tobytes()
            assert ya.dtype == yb.dtype == np.int32 and np.array_equal(ya, yb)


def test_loads_read_only_and_never_builds(lib):
    assert not hasattr(tnative, "build_native")
    assert tnative.load_native() is lib


@pytest.mark.parametrize("shuffle,seed", [(True, 3), (False, 0)])
def test_native_loader_batches_equal_jax(lib, shuffle, seed):
    x, y = synthetic_mnist(512, seed=1)
    t = tnative.NativeLoader(x, y, batch=64, shuffle=shuffle, seed=seed, workers=3)
    j = jnative.NativeLoader(x, y, batch=64, shuffle=shuffle, seed=seed, workers=3)
    tb, jb = _epochs(t), _epochs(j)
    _batches_equal(tb, jb)
    seen = np.concatenate([by for _, by in tb[0]])
    assert np.array_equal(np.bincount(seen, minlength=10), np.bincount(y, minlength=10))
    if not shuffle:
        assert np.array_equal(np.concatenate([bx for bx, _ in tb[0]]), x.astype(np.float32))


def test_augment_equals_jax(lib):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, (64, 8, 8, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, 64).astype(np.int32)
    kw = dict(seed=7, workers=2, augment_pad=2, augment_flip=True)
    tb = _epochs(tnative.NativeLoader(imgs, labels, 16, **kw), 1)
    _batches_equal(tb, _epochs(jnative.NativeLoader(imgs, labels, 16, **kw), 1))
    assert any((x == 0).any() for x, _ in tb[0])


def test_idx_parse_equals_python_and_jax(lib, tmp_path):
    data = np.arange(2 * 4 * 5, dtype=np.uint8).reshape(2, 4, 5)
    path = str(tmp_path / "test-idx3-ubyte")
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x00000803))
        f.write(struct.pack(">3I", 2, 4, 5))
        f.write(data.tobytes())
    got = tnative.read_idx_native(path)
    assert np.array_equal(got, data)
    assert np.array_equal(got, read_idx(path)) and np.array_equal(got, j_read_idx(path))
    assert np.array_equal(got, jnative.read_idx_native(path))


def test_jpeg_decode_equals_pil_and_jax(lib, tmp_path):
    PIL = pytest.importorskip("PIL.Image")
    img = np.random.default_rng(0).integers(0, 255, (40, 60, 3)).astype(np.uint8)
    p = str(tmp_path / "a.jpg")
    PIL.fromarray(img).save(p, quality=95)
    out = tnative.native_load_image(p, 40, 60)
    assert np.array_equal(out, np.asarray(PIL.open(p).convert("RGB")))
    for args in ((24, 32), (16, 16, (0.5, 0.5)), (16, 16, (0.5, 0.5), (3, 7))):
        a, b = tnative.native_load_image(p, *args), jnative.native_load_image(p, *args)
        assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)
    assert tnative.native_load_image(str(tmp_path / "missing.jpg"), 8, 8) is None


def test_make_loader_takes_the_native_loader_when_it_loads(lib):
    x, y = synthetic_mnist(256, seed=2)
    native = tloader.make_loader(x, y, 32, seed=5)
    assert isinstance(native, tnative.NativeLoader)
    python = tloader.make_loader(x, y, 32, seed=5, prefer_native=False)
    assert type(python) is tloader.DataLoader
    # the JAX factory makes the same choices, and the same batches
    from mandheling_tpu.data import loader as jloader

    assert isinstance(jloader.make_loader(x, y, 32, seed=5), jnative.NativeLoader)
    _batches_equal(_epochs(native, 1), _epochs(jloader.make_loader(x, y, 32, seed=5), 1))
    _batches_equal(_epochs(python, 1),
                   _epochs(jloader.make_loader(x, y, 32, seed=5, prefer_native=False), 1))


def test_without_the_library_the_python_loader_runs(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "_NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_lib_tried", False)
    assert tnative.load_native() is None
    assert tnative.read_idx_native(str(tmp_path / "x")) is None
    assert tnative.native_load_image(str(tmp_path / "x.jpg"), 4, 4) is None
    x, y = synthetic_mnist(64, seed=3)
    assert type(tloader.make_loader(x, y, 32)) is tloader.DataLoader


def test_a_library_that_does_not_load_is_absent(monkeypatch, tmp_path):
    """A library whose dependency (libjpeg) is missing raises in dlopen; the
    port takes it as absent."""
    (tmp_path / tnative._LIB_NAME).write_bytes(b"not an ELF file")
    monkeypatch.setattr(tnative, "_NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_lib_tried", False)
    assert tnative.load_native() is None
