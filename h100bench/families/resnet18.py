"""ResNet-18 (arXiv:1512.03385) with the CIFAR stem, as the reference's
layers."""

from typing import List

from h100bench.reference import Conv, GlobalAvgPool, Relu, Residual


def build(num_classes=10) -> List:
    """3x3 stem, no maxpool; stages [2, 2, 2, 2] of basic blocks (3x3 conv,
    relu, 3x3 conv; a 1x1 strided projection where the shape changes), each
    block followed by a relu; widths 64-512, strides 1-2-2-2; global pool;
    1x1 logits padded to a multiple of 4. No batch norm: the power-of-two
    requant takes its place."""
    layers: List = [Conv(3, 64, (3, 3), (1, 1), "SAME"), Relu()]
    c_in = 64
    for c, s in [(64, 1), (128, 2), (256, 2), (512, 2)]:
        for i in range(2):
            stride = s if i == 0 else 1
            branch = [Conv(c_in, c, (3, 3), (stride, stride), "SAME"), Relu(),
                      Conv(c, c, (3, 3), (1, 1), "SAME")]
            proj = None if (stride == 1 and c_in == c) else Conv(c_in, c, (1, 1), (stride, stride))
            layers += [Residual(branch, proj), Relu()]
            c_in = c
    return layers + [GlobalAvgPool(), Conv(c_in, (num_classes + 3) // 4 * 4)]
