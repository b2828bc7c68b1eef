"""The training set a cell's traffic file describes, drawn from the seed:
a class-structured synthetic CIFAR-10 stand-in (one smooth template a
class, sines along x and cosines along y at the class's frequencies, one
phase a colour channel, plus Gaussian noise, scaled to 0-255 over the
whole set), drawn on the device in a few large calls and handed back as
host arrays, NHWC uint8 images and int32 labels, which is what a training
loop reads from disk."""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def templates(classes: int, height: int, width: int, channels: int, device) -> torch.Tensor:
    """(classes, H, W, C) float32 class templates."""
    yy = torch.arange(height, dtype=torch.float32, device=device).view(-1, 1) / height
    xx = torch.arange(width, dtype=torch.float32, device=device).view(1, -1) / width
    return torch.stack([
        torch.stack([torch.sin((c + 1) * math.pi * xx + k)
                     + torch.cos((c + 2) * math.pi * yy * (k + 1)) for k in range(channels)], -1)
        for c in range(classes)])


def images(traffic: dict, gen: torch.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """(images (N, H, W, C) uint8, labels (N,) int32) of the traffic's data
    set, drawn from `gen` on its device."""
    n, classes = traffic["images"], traffic["classes"]
    h, w, c = traffic["image_shape"]
    dev = gen.device
    labels = torch.randint(0, classes, (n,), generator=gen, device=dev, dtype=torch.int64)
    x = templates(classes, h, w, c, dev)[labels]
    x += torch.randn(x.shape, generator=gen, device=dev) * traffic["noise_std"]
    x -= x.amin()
    x *= 255.0 / x.amax()
    return x.to(torch.uint8).cpu().numpy(), labels.to(torch.int32).cpu().numpy()
