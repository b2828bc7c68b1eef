"""CIFAR-10 in its binary format, and a deterministic synthetic stand-in
(copy of ``mandheling_tpu/data/cifar.py``).

Binary format per record: 1 label byte + 3072 image bytes (3x32x32, CHW);
files data_batch_{1..5}.bin / test_batch.bin. Images come out NHWC uint8.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

TRAIN_FILES = [f"data_batch_{i}.bin" for i in range(1, 6)]
TEST_FILES = ["test_batch.bin"]
RECORD = 1 + 3 * 32 * 32


def _read_bin(path: str) -> Tuple[np.ndarray, np.ndarray]:
    raw = np.fromfile(path, np.uint8).reshape(-1, RECORD)
    labels = raw[:, 0].astype(np.int32)
    imgs = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # NHWC
    return imgs, labels


def load_cifar10(root: str, train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """-> (images (N, 32, 32, 3) uint8, labels (N,) int32)."""
    xs, ys = [], []
    for f in TRAIN_FILES if train else TEST_FILES:
        x, y = _read_bin(os.path.join(root, f))
        xs.append(x)
        ys.append(y)
    return np.concatenate(xs), np.concatenate(ys)


def synthetic_cifar(n: int = 4096, seed: int = 0,
                    num_classes: int = 10) -> Tuple[np.ndarray, np.ndarray]:
    """Class-structured synthetic 32x32x3 dataset: a smooth template per
    class plus noise. uint8 NHWC images + int32 labels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32
    temps = []
    for c in range(num_classes):
        ch = [
            np.sin((c + 1) * np.pi * xx + k) + np.cos((c + 2) * np.pi * yy * (k + 1))
            for k in range(3)
        ]
        temps.append(np.stack(ch, -1))
    temps = np.stack(temps)  # (C, 32, 32, 3)
    labels = rng.integers(0, num_classes, n).astype(np.int32)
    imgs = temps[labels] + rng.normal(0, 0.4, (n, 32, 32, 3))
    imgs = imgs - imgs.min()
    imgs = (imgs / imgs.max() * 255.0).astype(np.uint8)
    return imgs, labels


def load_or_synthesize_cifar(root: Optional[str], train: bool = True,
                             synth_n: int = 4096) -> Tuple[np.ndarray, np.ndarray, bool]:
    """-> (images, labels, is_real): the CIFAR-10 bin files under `root`
    when they are there, else `synthetic_cifar`."""
    if root and os.path.exists(os.path.join(root, (TRAIN_FILES if train else TEST_FILES)[0])):
        x, y = load_cifar10(root, train)
        return x, y, True
    x, y = synthetic_cifar(synth_n if train else synth_n // 4, seed=0 if train else 1)
    return x, y, False
