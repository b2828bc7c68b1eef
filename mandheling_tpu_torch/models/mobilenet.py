"""MobileNetV2 and MobileNetV1, NITI int8 (port of the NITI part of
``mandheling_tpu/models/mobilenet.py``; reference
`tools/train/source/models/MobilenetV2.cpp`, `MobilenetV1.cpp`).

Every conv is an int8 NITI layer; residual adds are the exponent-aligned
int8 eltwise. The "cifar" plans take 32x32 inputs (stride plan 1-1-2-2-2);
the "imagenet" plans are the 224x224 geometry (stem stride 2).
"""

from __future__ import annotations

from typing import List

from ..nn.blocks import GlobalAvgPool, NITIDepthwiseConv2D, ResidualBlock
from ..nn.layers import NITIConv2D, SqueezeLogits
from ..nn.module import NITILayer, Sequential

# MobileNetV2 plans: (expansion, out_channels, num_blocks, stride)
CIFAR_PLAN = [
    (1, 16, 1, 1),
    (6, 24, 2, 1),  # stride 1 for 32x32 inputs
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]
IMAGENET_PLAN = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]

# MobileNetV1 plans: (out_channels, stride)
V1_CIFAR_PLAN = [
    (64, 1), (128, 1), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1),
]
V1_IMAGENET_PLAN = [
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1),
]

MOBILENET_V2_NITI_LOGITS = 12  # 10 classes padded to a multiple of 4


def _bottleneck(in_c: int, out_c: int, expansion: int, stride: int,
                dw_per_channel: bool = False, proj_bits: int = 7) -> NITILayer:
    """expand 1x1 (relu6) -> depthwise 3x3 (relu6) -> project 1x1; a
    ResidualBlock when stride is 1 and in_c == out_c, else a Sequential."""
    mid = in_c * expansion
    layers: List[NITILayer] = []
    if expansion != 1:
        layers += [NITIConv2D(in_c, mid, (1, 1), act="relu6")]
    layers += [
        NITIDepthwiseConv2D(mid, (3, 3), (stride, stride), "SAME",
                            per_channel=dw_per_channel, act="relu6"),
        NITIConv2D(mid, out_c, (1, 1), out_bits=proj_bits),
    ]
    seq = Sequential(layers)
    if stride == 1 and in_c == out_c:
        return ResidualBlock(seq)
    return seq


def _width(ch: int, width_mult: float) -> int:
    return max(4, int(ch * width_mult) // 4 * 4)


def _check_variant(variant: str) -> None:
    if variant not in ("cifar", "imagenet"):
        raise ValueError(f"variant must be 'cifar' or 'imagenet', got {variant!r}")


def mobilenet_v2_niti(
    num_classes: int = 10, width_mult: float = 1.0, variant: str = "cifar",
    dw_per_channel: bool = False, proj_bits: int = 7,
) -> Sequential:
    """NITI int8 MobileNetV2; logit channels padded to a multiple of 4.
    `proj_bits=15` requantizes the linear projections' outputs (and the
    residual adds they feed) to int16; the convs that read them take K1's
    int16-A route on the card."""
    _check_variant(variant)
    stem_stride = 2 if variant == "imagenet" else 1
    plan = IMAGENET_PLAN if variant == "imagenet" else CIFAR_PLAN
    in_c = _width(32, width_mult)
    layers: List[NITILayer] = [
        NITIConv2D(3, in_c, (3, 3), (stem_stride, stem_stride), "SAME", act="relu6"),
    ]
    for expansion, out_c, n, stride in plan:
        out_c = _width(out_c, width_mult)
        for i in range(n):
            block = _bottleneck(in_c, out_c, expansion, stride if i == 0 else 1,
                                dw_per_channel=dw_per_channel, proj_bits=proj_bits)
            if isinstance(block, ResidualBlock):
                layers.append(block)
            else:
                layers.extend(block.layers)
            in_c = out_c
    head = _width(1280, width_mult)
    layers += [
        NITIConv2D(in_c, head, (1, 1), act="relu6"),
        GlobalAvgPool(),
        NITIConv2D(head, (num_classes + 3) // 4 * 4, (1, 1)),
        SqueezeLogits(),
    ]
    return Sequential(layers)


def mobilenet_v1_niti(
    num_classes: int = 10, width_mult: float = 1.0, variant: str = "cifar",
    dw_per_channel: bool = False,
) -> Sequential:
    """NITI int8 MobileNetV1: depthwise 3x3 + pointwise 1x1 pairs."""
    _check_variant(variant)
    stem_stride = 2 if variant == "imagenet" else 1
    plan = V1_IMAGENET_PLAN if variant == "imagenet" else V1_CIFAR_PLAN
    in_c = _width(32, width_mult)
    layers: List[NITILayer] = [
        NITIConv2D(3, in_c, (3, 3), (stem_stride, stem_stride), "SAME", act="relu6"),
    ]
    for out_c, stride in plan:
        out_c = _width(out_c, width_mult)
        layers += [
            NITIDepthwiseConv2D(in_c, (3, 3), (stride, stride), "SAME",
                                per_channel=dw_per_channel, act="relu6"),
            NITIConv2D(in_c, out_c, (1, 1), act="relu6"),
        ]
        in_c = out_c
    layers += [
        GlobalAvgPool(),
        NITIConv2D(in_c, (num_classes + 3) // 4 * 4, (1, 1)),
        SqueezeLogits(),
    ]
    return Sequential(layers)
