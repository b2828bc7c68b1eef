"""ImageDataset: folder-of-images + label-txt dataset with crop/resize/normalize.

TPU-native analog of the reference's `tools/train/source/datasets/ImageDataset.cpp`
(config at :31-60, crop-then-resize at :119-199) used by the MobileNetV2
transfer-learning demo (`demo/MobilenetV2Utils.cpp:45-56`):

- txt file: one `relative/path.jpg label` pair per line
- optional fractional crop (center or random) of the ORIGINAL image, then
  resize to (resizeHeight, resizeWidth)
- per-channel normalize: (pixel - mean) * scale, float32 HWC output

Decoding uses PIL (the reference links stb_image). `read_all_to_memory`
mirrors the reference's eager-load flag.

The port's own copy of ``mandheling_tpu/data/image.py``: the same choice of
decoder, so the arrays are the JAX package's byte for byte. A JPEG goes to
the native decoder (``data/native.py``) when its library loads, else, like
every other file, to PIL; `decoded_by` records which one took the last
image. PIL is imported where it is used, so the package imports without it.
Images are host numpy arrays; the trainer moves batches to the device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class ImageConfig:
    """Mirror of ImageDataset::ImageConfig (ImageDataset.cpp:31-60)."""

    resize_height: int = 224
    resize_width: int = 224
    scales: Sequence[float] = field(default_factory=lambda: [1 / 127.5] * 3)
    means: Sequence[float] = field(default_factory=lambda: [127.5] * 3)
    crop_fraction: Tuple[float, float] = (1.0, 1.0)
    random_crop: bool = False  # center crop when False


def _parse_txt(txt_path: str) -> List[Tuple[str, int]]:
    pairs = []
    with open(txt_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            path, label = line.rsplit(maxsplit=1)
            pairs.append((path, int(label)))
    return pairs


class ImageDataset:
    """len() + __getitem__ -> (float32 HWC image, int label)."""

    def __init__(
        self,
        image_folder: str,
        txt_path: str,
        config: Optional[ImageConfig] = None,
        read_all_to_memory: bool = False,
        seed: int = 0,
    ):
        self.folder = image_folder
        self.config = config or ImageConfig()
        self.samples = _parse_txt(txt_path)
        self._rng = np.random.default_rng(seed)
        self._cache: Optional[List[np.ndarray]] = None
        self.decoded_by: Optional[str] = None  # "native" or "pil"
        if read_all_to_memory:
            self._cache = [self._load(i) for i in range(len(self.samples))]

    def __len__(self) -> int:
        return len(self.samples)

    def _load(self, idx: int) -> np.ndarray:
        cfg = self.config
        path = os.path.join(self.folder, self.samples[idx][0])

        # native decode+crop+resize path (libjpeg, native/imagedec.cpp) —
        # the reference decodes with stb_image inside the dataset; here the
        # worker does it in C++ and Python never touches pixels
        if path.lower().endswith((".jpg", ".jpeg")) and cfg.resize_height > 0:
            from .native import native_load_image

            crop_yx = (-1, -1)
            ch_, cw_ = cfg.crop_fraction
            if cfg.random_crop and (ch_ < 1.0 or cw_ < 1.0):
                # pin the seeded random crop on the host (decode happens
                # after, so probe the image size cheaply via PIL header)
                from PIL import Image

                with Image.open(path) as im:
                    w0, h0 = im.size
                hc, wc = int(h0 * ch_), int(w0 * cw_)
                crop_yx = (
                    int(self._rng.integers(0, h0 - hc + 1)),
                    int(self._rng.integers(0, w0 - wc + 1)),
                )
            arr = native_load_image(
                path, cfg.resize_height, cfg.resize_width,
                cfg.crop_fraction, crop_yx,
            )
            if arr is not None:
                self.decoded_by = "native"
                out = arr.astype(np.float32)
                out = (out - np.asarray(cfg.means, np.float32)) * np.asarray(
                    cfg.scales, np.float32
                )
                return out

        from PIL import Image

        self.decoded_by = "pil"
        img = Image.open(path).convert("RGB")
        arr = np.asarray(img)  # HWC uint8

        ch, cw = cfg.crop_fraction
        if abs(ch - 1.0) > 1e-6 or abs(cw - 1.0) > 1e-6:
            h, w = arr.shape[:2]
            hc, wc = int(h * ch), int(w * cw)
            if cfg.random_crop:
                y0 = int(self._rng.integers(0, h - hc + 1))
                x0 = int(self._rng.integers(0, w - wc + 1))
            else:
                y0, x0 = (h - hc) // 2, (w - wc) // 2
            arr = arr[y0 : y0 + hc, x0 : x0 + wc]

        if cfg.resize_height > 0 and cfg.resize_width > 0:
            img = Image.fromarray(arr).resize(
                (cfg.resize_width, cfg.resize_height), Image.BILINEAR
            )
            arr = np.asarray(img)

        out = arr.astype(np.float32)
        out = (out - np.asarray(self.config.means, np.float32)) * np.asarray(
            self.config.scales, np.float32
        )
        return out

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        img = self._cache[idx] if self._cache is not None else self._load(idx)
        return img, self.samples[idx][1]


class ImageNoLabelDataset:
    """Every image in a folder, no labels — used by PTQ calibration
    (reference `datasets/ImageNoLabelDataset.cpp`, `demo/quanByMSE.cpp`)."""

    EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm")

    def __init__(self, image_folder: str, config: Optional[ImageConfig] = None):
        self.folder = image_folder
        self.config = config or ImageConfig()
        files = sorted(
            f for f in os.listdir(image_folder) if f.lower().endswith(self.EXTS)
        )
        self._inner = ImageDataset.__new__(ImageDataset)
        self._inner.folder = image_folder
        self._inner.config = self.config
        self._inner.samples = [(f, 0) for f in files]
        self._inner._rng = np.random.default_rng(0)
        self._inner._cache = None
        self._inner.decoded_by = None

    @property
    def decoded_by(self) -> Optional[str]:
        return self._inner.decoded_by

    def __len__(self) -> int:
        return len(self._inner.samples)

    def __getitem__(self, idx: int) -> np.ndarray:
        return self._inner._load(idx)
