"""Batched, shuffled, prefetching data loader (copy of
``mandheling_tpu/data/loader.py``): the Python `DataLoader`, and
`make_loader`, which prefers the native C++ loader of ``data/native.py``
as the JAX package's does. Batches are host numpy arrays; the trainer moves
them to the device."""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Tuple

import numpy as np


class DataLoader:
    """Shuffled fixed-batch iterator with background prefetch. Drops the
    trailing partial batch, like the reference."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, batch_size: int,
                 shuffle: bool = True, seed: int = 0, prefetch: int = 2):
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images but {len(labels)} labels")
        self.images = images
        self.labels = labels
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.prefetch = prefetch
        self._epoch = 0
        self._rng_seed = seed

    def __len__(self) -> int:
        return len(self.images) // self.batch_size

    def _order(self) -> np.ndarray:
        n = len(self.images)
        if not self.shuffle:
            return np.arange(n)
        rng = np.random.default_rng(self._rng_seed + self._epoch)
        return rng.permutation(n)

    def epoch(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (float32 images, int32 labels) batches for one epoch,
        prefetched on a background thread."""
        order = self._order()
        self._epoch += 1
        nb = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            for i in range(nb):
                if stop.is_set():
                    return
                idx = order[i * self.batch_size : (i + 1) * self.batch_size]
                q.put((self.images[idx].astype(np.float32),
                       self.labels[idx].astype(np.int32)))
            q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()


def make_loader(
    images: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    prefer_native: bool = True,
):
    """Factory: native C++ worker-thread loader when its library loads,
    Python fallback (the JAX package's choice: same batches either way).

    Note: the native path feeds raw [0,255] float batches like the Python
    path — normalization/quantization runs on-device in the step."""
    if prefer_native:
        try:
            from .native import NativeLoader

            return NativeLoader(images, labels, batch_size, shuffle, seed)
        except (RuntimeError, OSError):
            pass
    return DataLoader(images, labels, batch_size, shuffle, seed)


def onehot_padded(labels: np.ndarray, num_classes: int, width: int) -> np.ndarray:
    """One-hot with zero padding out to the model's logit width (10 classes
    in 12 NITI logit channels)."""
    out = np.zeros((len(labels), width), np.int32)
    out[np.arange(len(labels)), labels] = 1
    return out
