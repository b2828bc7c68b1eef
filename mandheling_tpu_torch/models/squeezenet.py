"""SqueezeNet v1.0, NITI int8 (port of ``mandheling_tpu/models/squeezenet.py``).

A 7x7/2 stem (3 -> 96) and a 3x3/2 maxpool, eight Fire modules with
maxpools after fire4 and fire8, then conv10 (1x1 to the logits), a relu
and the global average pool: SqueezeNet has no FC layer. A Fire module is
a 1x1 squeeze and a relu, then two expand branches (1x1 and 3x3 SAME, each
with a relu) joined by the exponent-aligned int8 channel concat
(`nn/blocks.ParallelConcat`). Maxpools are VALID, and there is no dropout,
as in the JAX package.
"""

from __future__ import annotations

from typing import List

from ..nn.blocks import GlobalAvgPool, ParallelConcat
from ..nn.layers import NITIConv2D, NITIMaxPool, NITIRelu, SqueezeLogits
from ..nn.module import NITILayer, Sequential

__all__ = ["fire", "squeezenet_niti"]


def fire(in_c: int, squeeze_c: int, expand1_c: int, expand3_c: int) -> Sequential:
    """squeeze 1x1 -> relu -> concat[expand 1x1 + relu, expand 3x3 + relu]."""
    return Sequential([
        NITIConv2D(in_c, squeeze_c, (1, 1)),
        NITIRelu(),
        ParallelConcat([
            Sequential([NITIConv2D(squeeze_c, expand1_c, (1, 1)), NITIRelu()]),
            Sequential([NITIConv2D(squeeze_c, expand3_c, (3, 3), (1, 1), "SAME"), NITIRelu()]),
        ]),
    ])


# (squeeze, expand 1x1, expand 3x3) of fire2..fire9, "pool" where v1.0 pools
_FIRE_PLAN = [
    (16, 64, 64),
    (16, 64, 64),
    (32, 128, 128),
    "pool",
    (32, 128, 128),
    (48, 192, 192),
    (48, 192, 192),
    (64, 256, 256),
    "pool",
    (64, 256, 256),
]


def squeezenet_niti(num_classes: int = 1000) -> Sequential:
    """SqueezeNet v1.0 for 224x224x3 inputs (fully convolutional, so CIFAR
    sizes run too); logit channels padded to a multiple of 4. Weights are
    zero until `reset_parameters` or a load."""
    layers: List[NITILayer] = [NITIConv2D(3, 96, (7, 7), (2, 2), "SAME"), NITIRelu(),
                               NITIMaxPool((3, 3), (2, 2))]
    in_c = 96
    for entry in _FIRE_PLAN:
        if entry == "pool":
            layers.append(NITIMaxPool((3, 3), (2, 2)))
            continue
        s, e1, e3 = entry
        layers.append(fire(in_c, s, e1, e3))
        in_c = e1 + e3
    layers += [NITIConv2D(in_c, (num_classes + 3) // 4 * 4, (1, 1)), NITIRelu(),
               GlobalAvgPool(), SqueezeLogits()]
    return Sequential(layers)
