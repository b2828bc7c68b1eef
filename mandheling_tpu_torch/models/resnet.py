"""ResNet-18 (CIFAR) and ResNet-v2-50, NITI int8 (port of
``mandheling_tpu/models/resnet.py``).

ResNet-18: a 3x3 stem (no maxpool), stages [2, 2, 2, 2] of basic blocks with
the channel plan 64-128-256-512 and strides 1-2-2-2, a global average pool
and 1x1 logits. A basic block is conv3x3 -> relu -> conv3x3, with a 1x1
strided projection on the skip where the shape changes; the residual is the
exponent-aligned int8 add. NITI networks carry no batch norm: the per-tensor
power-of-two rescaling plays its part.

ResNet-v2-50: a 7x7/2 stem and a 3x3/2 maxpool, stages [3, 4, 6, 3] of
pre-activation bottlenecks (mid channels 64-128-256-512, expansion 4), a
final relu, the pool and the logits; for 224x224 inputs, and fully
convolutional down to the pool.
"""

from __future__ import annotations

from typing import List

from ..nn.blocks import GlobalAvgPool, ProjectedResidualBlock, ResidualBlock
from ..nn.layers import NITIConv2D, NITIMaxPool, NITIRelu, SqueezeLogits
from ..nn.module import NITILayer, Sequential

__all__ = ["ProjectedResidualBlock", "RESNET18_NITI_LOGITS", "resnet18_niti",
           "resnet50v2_niti"]


def _basic_block(in_c: int, out_c: int, stride: int) -> NITILayer:
    branch = Sequential([
        NITIConv2D(in_c, out_c, (3, 3), (stride, stride), "SAME"),
        NITIRelu(),
        NITIConv2D(out_c, out_c, (3, 3), (1, 1), "SAME"),
    ])
    if stride == 1 and in_c == out_c:
        return ResidualBlock(branch)
    return ProjectedResidualBlock(branch, NITIConv2D(in_c, out_c, (1, 1), (stride, stride)))


def resnet18_niti(num_classes: int = 10) -> Sequential:
    """NITI ResNet-18 for 32x32 inputs; logit channels padded to a multiple
    of 4. Weights are zero until `reset_parameters` or a load."""
    layers: List[NITILayer] = [NITIConv2D(3, 64, (3, 3), (1, 1), "SAME"), NITIRelu()]
    in_c = 64
    for out_c, stride in [(64, 1), (128, 2), (256, 2), (512, 2)]:
        for i in range(2):
            layers += [_basic_block(in_c, out_c, stride if i == 0 else 1), NITIRelu()]
            in_c = out_c
    layers += [GlobalAvgPool(), NITIConv2D(in_c, (num_classes + 3) // 4 * 4, (1, 1)),
               SqueezeLogits()]
    return Sequential(layers)


RESNET18_NITI_LOGITS = 12


def _bottleneck_v2(in_c: int, mid_c: int, stride: int) -> List[NITILayer]:
    """Pre-activation bottleneck in NITI form (v2's BN-ReLU pre-activation
    is a ReLU here). A shape-changing block shares one pre-activation relu
    between the branch and the 1x1 strided projection: ``[NITIRelu(),
    ProjectedResidualBlock(...)]``. An identity block's skip carries the
    input before the relu: ``ResidualBlock(Sequential([NITIRelu()] + core))``."""
    out_c = 4 * mid_c
    core = [
        NITIConv2D(in_c, mid_c, (1, 1)),
        NITIRelu(),
        NITIConv2D(mid_c, mid_c, (3, 3), (stride, stride), "SAME"),
        NITIRelu(),
        NITIConv2D(mid_c, out_c, (1, 1)),
    ]
    if stride == 1 and in_c == out_c:
        return [ResidualBlock(Sequential([NITIRelu()] + core))]
    return [NITIRelu(), ProjectedResidualBlock(
        Sequential(core), NITIConv2D(in_c, out_c, (1, 1), (stride, stride)))]


def resnet50v2_niti(num_classes: int = 1000) -> Sequential:
    """NITI ResNet-v2-50 for 224x224x3 inputs; logit channels padded to a
    multiple of 4."""
    layers: List[NITILayer] = [NITIConv2D(3, 64, (7, 7), (2, 2), "SAME"),
                               NITIMaxPool((3, 3), (2, 2))]
    in_c = 64
    for mid_c, blocks, stride in [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]:
        for i in range(blocks):
            layers += _bottleneck_v2(in_c, mid_c, stride if i == 0 else 1)
            in_c = 4 * mid_c
    layers += [NITIRelu(), GlobalAvgPool(), NITIConv2D(in_c, (num_classes + 3) // 4 * 4, (1, 1)),
               SqueezeLogits()]
    return Sequential(layers)
