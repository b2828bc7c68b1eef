"""Batched, shuffled, prefetching data loader (copy of
``mandheling_tpu/data/loader.py``): the Python `DataLoader`, and
`make_loader`, which prefers the native C++ loader of ``data/native.py``
as the JAX package's does. Batches are host numpy arrays; `to_device`
moves them to the device."""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..utils.spans import count, span


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
        prefetched on a background thread (named "loader"). Spans
        (utils/spans.py): `loader.epoch_start` (the order, the worker's
        start and the first batch's wait), `loader.wait` (the wait for each
        later batch) and, on the worker's thread, `loader.gather`."""
        stop = threading.Event()
        try:
            with span("loader.epoch_start"):
                order = self._order()
                self._epoch += 1
                nb = len(self)
                q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)

                def worker():
                    for i in range(nb):
                        if stop.is_set():
                            return
                        with span("loader.gather"):
                            idx = order[i * self.batch_size : (i + 1) * self.batch_size]
                            item = (self.images[idx].astype(np.float32),
                                    self.labels[idx].astype(np.int32))
                        q.put(item)
                    q.put(None)

                threading.Thread(target=worker, daemon=True, name="loader").start()
                item = q.get()
            while item is not None:
                yield item
                with span("loader.wait"):
                    item = q.get()
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


def shard_for_host(images: np.ndarray, labels: np.ndarray, host_id: int,
                   num_hosts: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static per-host shard of the dataset for multi-host data
    parallelism: every num_hosts-th sample from host_id on (JAX
    `data/loader.py:110-117`; parallel/distributed.host_index and
    host_count give a rank its host)."""
    return images[host_id::num_hosts], labels[host_id::num_hosts]


def onehot_padded(labels: np.ndarray, num_classes: int, width: int) -> np.ndarray:
    """One-hot with zero padding out to the model's logit width (10 classes
    in 12 NITI logit channels)."""
    with span("loader.onehot"):
        out = np.zeros((len(labels), width), np.int32)
        out[np.arange(len(labels)), labels] = 1
        return out


def to_device(a: np.ndarray, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host batch as a tensor on `device`, cast to `dtype` on the host.
    On a CUDA device it is staged in pinned host memory and copied
    non-blocking, so the copy overlaps the host's next work. The pinned
    block is not overwritten before its copy has run: torch's host
    allocator records the copy's event on it and hands the block out again
    only once that event has passed. On the CPU: the array's tensor.
    Span `loader.to_device`, its device marks around the copy alone, its
    child `loader.pin`, and counter `loader.h2d_bytes` (utils/spans.py)."""
    with span("loader.to_device") as sp:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dtype is not None:
            t = t.to(dtype)
        if device.type != "cuda":
            return t
        with span("loader.pin"):
            t = t.pin_memory()
        count("loader.h2d_bytes", t.numel() * t.element_size())
        with sp.device():
            return t.to(device, non_blocking=True)
