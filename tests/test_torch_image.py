"""The port's image datasets (data/image.py) against the JAX package's: the
same PNG and JPEG files, written here by PIL, give byte-equal float32
arrays through `ImageDataset` (resize, centre and seeded random crops, the
eager cache) and `ImageNoLabelDataset`, on the native decoder and on PIL;
each test asserts which decoder took the file (`decoded_by`)."""

import numpy as np
import pytest

from mandheling_tpu.data import image as jimage
from mandheling_tpu.data import native as jnative
from mandheling_tpu_torch.data import image as timage
from mandheling_tpu_torch.data import native as tnative

PIL = pytest.importorskip("PIL")


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("imgs")
    (root / "sub").mkdir()
    rng = np.random.default_rng(0)
    lines = []
    for i in range(8):
        arr = rng.integers(0, 255, (40, 48, 3)).astype("uint8")
        ext = "png" if i % 2 == 0 else "jpg"
        Image.fromarray(arr).save(root / "sub" / f"im{i}.{ext}", quality=95)
        lines.append(f"sub/im{i}.{ext} {i % 3}")
    (root / "labels.txt").write_text("\n".join(lines) + "\n")
    return root


def _pairs(image_dir, **cfg):
    kw = {k: v for k, v in cfg.items() if k in ("read_all_to_memory", "seed")}
    cfg = {k: v for k, v in cfg.items() if k not in kw}
    j = jimage.ImageDataset(str(image_dir), str(image_dir / "labels.txt"),
                            jimage.ImageConfig(**cfg), **kw)
    t = timage.ImageDataset(str(image_dir), str(image_dir / "labels.txt"),
                            timage.ImageConfig(**cfg), **kw)
    return j, t


def _equal(a, b):
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("cfg", [
    dict(resize_height=32, resize_width=32),
    dict(resize_height=16, resize_width=24, crop_fraction=(0.5, 0.75)),
    dict(resize_height=16, resize_width=16, crop_fraction=(0.875, 0.875), random_crop=True,
         seed=3),
    dict(resize_height=0, resize_width=0, scales=[1 / 255.0] * 3, means=[0.0] * 3),
    dict(resize_height=20, resize_width=20, read_all_to_memory=True),
])
def test_arrays_equal_jax_on_each_decoder(image_dir, cfg):
    """PNGs go to PIL; JPEGs to the native decoder where it loads (this
    machine: it does), and with a resize only; labels too."""
    assert tnative.load_native() is not None
    j, t = _pairs(image_dir, **cfg)
    assert len(t) == len(j) == 8
    for i in range(8):
        (a, la), (b, lb) = j[i], t[i]
        _equal(a, b)
        assert la == lb == i % 3
        if not cfg.get("read_all_to_memory"):
            want = "native" if i % 2 and cfg["resize_height"] > 0 else "pil"
            assert t.decoded_by == want


def test_pil_path_when_the_native_decoder_is_missing(image_dir, monkeypatch):
    monkeypatch.setattr(tnative, "native_load_image", lambda *a, **k: None)
    monkeypatch.setattr(jnative, "native_load_image", lambda *a, **k: None)
    j, t = _pairs(image_dir, resize_height=24, resize_width=24, crop_fraction=(0.5, 0.5))
    for i in (1, 3):  # the JPEGs
        _equal(j[i][0], t[i][0])
        assert t.decoded_by == "pil"


def test_center_crop_deterministic_and_cache_matches_lazy(image_dir):
    _, t = _pairs(image_dir, resize_height=16, resize_width=16, crop_fraction=(0.5, 0.5))
    _equal(t[0][0], t[0][0])
    _, eager = _pairs(image_dir, resize_height=16, resize_width=16, crop_fraction=(0.5, 0.5),
                      read_all_to_memory=True)
    _equal(t[5][0], eager[5][0])
    img = t[3][0]
    assert -1.1 < img.min() and img.max() < 1.1


def test_nolabel_dataset_equals_jax(image_dir):
    cfg = dict(resize_height=28, resize_width=28, scales=[1 / 127.5], means=[127.5])
    j = jimage.ImageNoLabelDataset(str(image_dir / "sub"), jimage.ImageConfig(**cfg))
    t = timage.ImageNoLabelDataset(str(image_dir / "sub"), timage.ImageConfig(**cfg))
    assert len(t) == len(j) == 8 and t.decoded_by is None
    for i in range(8):
        _equal(j[i], t[i])
        assert t.decoded_by == ("native" if i % 2 else "pil")


def test_package_imports_without_pil_at_import_time():
    """PIL is imported where an image is decoded, never at import."""
    import ast
    from pathlib import Path

    src = Path(timage.__file__).read_text()
    top = [n for n in ast.parse(src).body if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert not any("PIL" in ast.dump(n) for n in top)
