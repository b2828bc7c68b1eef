"""ResNet-v2-50 (He et al., "Identity Mappings in Deep Residual Networks",
arXiv:1603.05027) for 224x224x3 inputs, as the reference's layers.
Departures, as the program builds it: no batch norm (the power-of-two
requant takes its place), so each BN-ReLU pre-activation is a ReLU; the
3x3/2 maxpool after the stem is VALID; the logits padded to a multiple
of 4."""

from typing import List

from h100bench.reference import Conv, GlobalAvgPool, MaxPool, Relu, Residual


def bottleneck(in_c: int, mid_c: int, stride: int) -> List:
    """Pre-activation bottleneck: 1x1, 3x3 (the stride), 1x1 to 4 * mid_c,
    a relu before each. An identity block's skip carries its input before
    the first relu; a block that changes the shape shares that relu with a
    1x1 strided projection on the skip."""
    out_c = 4 * mid_c
    core = [Conv(in_c, mid_c), Relu(), Conv(mid_c, mid_c, (3, 3), (stride, stride), "SAME"),
            Relu(), Conv(mid_c, out_c)]
    if stride == 1 and in_c == out_c:
        return [Residual([Relu()] + core)]
    return [Relu(), Residual(core, Conv(in_c, out_c, (1, 1), (stride, stride)))]


def build(num_classes=1000) -> List:
    """7x7/2 stem (no activation: the first block's relu follows), 3x3/2
    maxpool, stages [3, 4, 6, 3] of bottlenecks with mid widths 64-512 and
    strides 1-2-2-2, a final relu, global pool, 1x1 logits."""
    layers: List = [Conv(3, 64, (7, 7), (2, 2), "SAME"), MaxPool((3, 3), (2, 2))]
    c = 64
    for mid, blocks, stride in [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]:
        for i in range(blocks):
            layers += bottleneck(c, mid, stride if i == 0 else 1)
            c = 4 * mid
    return layers + [Relu(), GlobalAvgPool(), Conv(c, (num_classes + 3) // 4 * 4)]
