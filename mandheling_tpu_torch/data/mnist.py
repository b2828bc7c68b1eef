"""MNIST idx-format dataset and its deterministic synthetic stand-in (copy
of ``mandheling_tpu/data/mnist.py``; reference `MnistDataset.cpp:17-70`)."""

from __future__ import annotations

import os
import struct
from typing import Optional, Tuple

import numpy as np

TRAIN_IMAGES = "train-images-idx3-ubyte"
TRAIN_LABELS = "train-labels-idx1-ubyte"
TEST_IMAGES = "t10k-images-idx3-ubyte"
TEST_LABELS = "t10k-labels-idx1-ubyte"


def read_idx(path: str) -> np.ndarray:
    """Parse an idx file (big-endian header: magic, dims...)."""
    with open(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dtype_code = (magic >> 8) & 0xFF
        if dtype_code != 0x08:
            raise ValueError(f"only ubyte idx supported, got {dtype_code:#x}")
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def load_mnist(root: str, train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """-> (images (N, 28, 28, 1) uint8, labels (N,) int32)."""
    img = read_idx(os.path.join(root, TRAIN_IMAGES if train else TEST_IMAGES))
    lab = read_idx(os.path.join(root, TRAIN_LABELS if train else TEST_LABELS))
    return img[..., None], lab.astype(np.int32)


def synthetic_mnist(n: int = 8192, seed: int = 0, image_size: int = 28,
                    num_classes: int = 10) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic class-structured fake MNIST: a smooth template per class
    plus noise. uint8 (N, S, S, 1) images + int32 labels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32) / image_size
    templates = np.stack([
        np.sin((c + 1) * np.pi * xx + c)
        + np.cos((c + 2) * np.pi * yy - c / 2.0)
        + np.sin((c + 1) * 2 * np.pi * (xx * yy))
        for c in range(num_classes)
    ])  # (C, S, S)
    labels = rng.integers(0, num_classes, n).astype(np.int32)
    imgs = templates[labels] + rng.normal(0, 0.45, (n, image_size, image_size))
    imgs = imgs - imgs.min()
    imgs = (imgs / imgs.max() * 255.0).astype(np.uint8)
    return imgs[..., None], labels


def load_or_synthesize(root: Optional[str], train: bool = True,
                       synth_n: int = 8192) -> Tuple[np.ndarray, np.ndarray, bool]:
    """-> (images, labels, is_real). Uses real MNIST when present."""
    if root:
        img_file = os.path.join(root, TRAIN_IMAGES if train else TEST_IMAGES)
        if os.path.exists(img_file):
            x, y = load_mnist(root, train)
            return x, y, True
    x, y = synthetic_mnist(synth_n if train else max(synth_n // 4, 512),
                           seed=0 if train else 1)
    return x, y, False
