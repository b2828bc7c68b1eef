"""ctypes binding to the native C++ data pipeline (native/dataloader.cpp,
native/imagedec.cpp): the port's own copy of ``mandheling_tpu/data/native.py``.

It loads the library committed at ``native/libmandheling_native.so``
read-only and never builds it (`make -C native` would write a file of the
repository). When the library is absent or does not load (it links
libjpeg), `load_native()` returns None and the callers take the Python
loader and PIL, as the JAX package's do.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB_NAME = "libmandheling_native.so"
_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_lib = None
_lib_tried = False


def load_native():
    """Returns the loaded CDLL or None."""
    global _lib, _lib_tried
    if _lib is not None:
        return _lib
    if _lib_tried:
        return None
    _lib_tried = True
    path = os.path.join(_NATIVE_DIR, _LIB_NAME)
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:  # a dependency (libjpeg) is missing on this machine
        return None
    lib.mdl_create.restype = ctypes.c_void_p
    lib.mdl_create.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.mdl_destroy.argtypes = [ctypes.c_void_p]
    lib.mdl_epoch_start.restype = ctypes.c_int64
    lib.mdl_epoch_start.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_uint64,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.mdl_set_augment.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.mdl_next.restype = ctypes.c_int
    lib.mdl_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.mdl_read_idx.restype = ctypes.c_int64
    lib.mdl_read_idx.argtypes = [
        ctypes.c_char_p,
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
    ]
    lib.mnd_load_image.restype = ctypes.c_int
    lib.mnd_load_image.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    _lib = lib
    return _lib


class NativeLoader:
    """Worker-threaded shuffled batch loader backed by C++."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, batch: int,
                 shuffle: bool = True, seed: int = 0, workers: int = 2,
                 prefetch: int = 4, augment_pad: int = 0,
                 augment_flip: bool = False):
        """augment_pad/augment_flip: native per-sample random pad-crop and
        horizontal mirror (the reference's random-crop / mirror image
        transforms), applied in the C++ workers."""
        lib = load_native()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.images = np.ascontiguousarray(images, np.uint8)
        self.labels = np.ascontiguousarray(labels, np.int32)
        n, h, w, c = self.images.shape
        self.batch = batch
        self.shuffle = shuffle
        self.seed = seed
        self.workers = workers
        self.prefetch = prefetch
        self.sample_shape = (h, w, c)
        self._epoch = 0
        self._handle = lib.mdl_create(
            self.images.ctypes.data_as(ctypes.c_void_p),
            self.labels.ctypes.data_as(ctypes.c_void_p),
            n, h, w, c,
        )
        if augment_pad or augment_flip:
            lib.mdl_set_augment(self._handle, int(augment_pad), int(augment_flip))

    def __len__(self):
        return len(self.images) // self.batch

    def epoch(self):
        h, w, c = self.sample_shape
        nb = self._lib.mdl_epoch_start(
            self._handle, self.batch, int(self.shuffle),
            self.seed + self._epoch, self.workers, self.prefetch,
        )
        self._epoch += 1
        for _ in range(nb):
            x = np.empty((self.batch, h, w, c), np.float32)
            y = np.empty((self.batch,), np.int32)
            ok = self._lib.mdl_next(
                self._handle,
                x.ctypes.data_as(ctypes.c_void_p),
                y.ctypes.data_as(ctypes.c_void_p),
            )
            if not ok:
                return
            yield x, y

    def __del__(self):
        lib = getattr(self, "_lib", None)
        handle = getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.mdl_destroy(handle)


def read_idx_native(path: str) -> Optional[np.ndarray]:
    """idx parse through the C++ parser; None if the library is missing."""
    lib = load_native()
    if lib is None:
        return None
    dims = (ctypes.c_int64 * 8)()
    total = lib.mdl_read_idx(path.encode(), None, 0, dims, 8)
    if total < 0:
        raise IOError(f"bad idx file: {path}")
    out = np.empty(total, np.uint8)
    got = lib.mdl_read_idx(
        path.encode(), out.ctypes.data_as(ctypes.c_void_p), total, dims, 8
    )
    assert got == total
    shape = tuple(d for d in dims if d > 0)
    return out.reshape(shape)


def native_load_image(
    path: str,
    out_h: int,
    out_w: int,
    crop_frac=(1.0, 1.0),
    crop_yx=(-1, -1),
) -> Optional[np.ndarray]:
    """Decode + crop + bilinear-resize a JPEG in native code
    (native/imagedec.cpp, the stb_image analog of the reference's
    ImageDataset). Returns (out_h, out_w, 3) uint8, or None when the native
    lib is unavailable or decode fails (caller falls back to PIL).

    The JPEG decode is bit-identical to PIL (both libjpeg); the resize is
    corner-aligned bilinear (PIL's BILINEAR uses a triangle filter for
    downscale, so resized pixels differ slightly — both feed the same
    float normalize, and a dataset uses one path consistently)."""
    lib = load_native()
    if lib is None:
        return None
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.mnd_load_image(
        path.encode(),
        ctypes.c_int(out_h),
        ctypes.c_int(out_w),
        ctypes.c_double(float(crop_frac[0])),
        ctypes.c_double(float(crop_frac[1])),
        ctypes.c_int(int(crop_yx[0])),
        ctypes.c_int(int(crop_yx[1])),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out if rc == 0 else None
