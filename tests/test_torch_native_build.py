"""The port's native build (data/native.build_native) on the CPU: native/'s
sources compiled with g++ and -ljpeg, as native/Makefile builds them, into
BUILD_DIR (here a temporary directory; never into native/); the built
library's loader gives the Python DataLoader's batches and the JAX
binding's, and
`load_native` takes it where the committed library does not load, building
it first when there is none. Without a compiler (CXX not one) the build
returns False and nothing is left behind, as the JAX package's build_native
returns False when make fails."""

import ctypes
import os

import numpy as np
import pytest

from mandheling_tpu.data import native as jnative
from mandheling_tpu_torch.data import DataLoader, synthetic_mnist
from mandheling_tpu_torch.data import native as tnative


def _epochs(loader, n=2):
    return [[(x.copy(), y.copy()) for x, y in loader.epoch()] for _ in range(n)]


def _same(a, b):
    assert len(a) == len(b) > 0
    for ea, eb in zip(a, b):
        assert len(ea) == len(eb)
        for (xa, ya), (xb, yb) in zip(ea, eb):
            assert xa.tobytes() == xb.tobytes() and np.array_equal(ya, yb)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("native_build"))
    native_dir = os.listdir(tnative._NATIVE_DIR)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnative, "BUILD_DIR", out)
        assert tnative.build_native()
    assert sorted(os.listdir(tnative._NATIVE_DIR)) == sorted(native_dir)  # nothing written there
    assert os.listdir(out) == [tnative._LIB_NAME]
    return out


def load_from(monkeypatch, native_dir, build_dir):
    monkeypatch.setattr(tnative, "_NATIVE_DIR", native_dir)
    monkeypatch.setattr(tnative, "BUILD_DIR", build_dir)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_lib_tried", False)
    return tnative.load_native()


def test_the_built_library_loads_where_the_committed_one_does_not(built, monkeypatch,
                                                                  tmp_path):
    broken = tmp_path / "native"
    broken.mkdir()
    (broken / tnative._LIB_NAME).write_bytes(b"not an ELF file")
    lib = load_from(monkeypatch, str(broken), built)
    assert lib is not None and lib._name == os.path.join(built, tnative._LIB_NAME)
    x, y = synthetic_mnist(200, seed=4)
    for shuffle, seed in ((True, 3), (False, 0)):
        got = _epochs(tnative.NativeLoader(x, y, batch=32, shuffle=shuffle, seed=seed))
        _same(got, _epochs(jnative.NativeLoader(x, y, batch=32, shuffle=shuffle, seed=seed)))
        if not shuffle:  # unshuffled, the native order is the Python loader's
            _same(got, _epochs(DataLoader(x, y, 32, shuffle=False, seed=seed)))


def test_load_native_builds_when_no_library_is_there(monkeypatch, tmp_path):
    calls = []
    real = tnative.build_native

    def build(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(tnative, "build_native", build)
    (tmp_path / "native").mkdir()
    for name in tnative._SOURCES:  # the sources without a committed library
        (tmp_path / "native" / name).write_bytes(
            open(os.path.join(tnative._NATIVE_DIR, name), "rb").read())
    lib = load_from(monkeypatch, str(tmp_path / "native"), str(tmp_path / "build"))
    assert isinstance(lib, ctypes.CDLL) and len(calls) == 1
    assert os.path.exists(tmp_path / "build" / tnative._LIB_NAME)
    assert load_from(monkeypatch, str(tmp_path / "native"), str(tmp_path / "build")) is not None
    assert len(calls) == 1  # a built library is taken, not built again


@pytest.mark.parametrize("cxx", ["false", "/nonexistent/g++", ""])
def test_no_compiler_returns_false(monkeypatch, tmp_path, cxx):
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    assert tnative.build_native() is False
    assert os.listdir(tmp_path) == []
