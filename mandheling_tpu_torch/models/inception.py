"""Inception-v3, NITI int8 (port of ``mandheling_tpu/models/inception.py``).

Every conv is the int8 NITI conv followed by a relu (the original's batch
norm has no NITI form), the asymmetric 1x7 / 7x1 and 1x3 / 3x1 convs
included. The modules' branches join through the exponent-aligned int8
channel concat (`nn/blocks.ParallelConcat`); the pooling branches use the
zero-padded int8 average pool (``NITIAvgPool(pad=1)``). Maxpools are VALID,
and the auxiliary classifier and dropout are left out, as in the JAX
package.
"""

from __future__ import annotations

from typing import List

from ..nn.blocks import GlobalAvgPool, NITIAvgPool, ParallelConcat
from ..nn.layers import NITIConv2D, NITIMaxPool, NITIRelu, SqueezeLogits
from ..nn.module import NITILayer, Sequential

__all__ = ["inceptionv3_niti"]


def _conv(in_c, out_c, kh, kw, stride=1, padding="SAME") -> List[NITILayer]:
    return [NITIConv2D(in_c, out_c, (kh, kw), (stride, stride), padding), NITIRelu()]


def _branch(*specs) -> Sequential:
    """A Sequential of the given layers and lists of layers, in order."""
    layers: List[NITILayer] = []
    for s in specs:
        layers += s if isinstance(s, list) else [s]
    return Sequential(layers)


def _pool_branch(in_c: int, out_c: int) -> Sequential:
    return _branch(NITIAvgPool((3, 3), (1, 1), pad=1), _conv(in_c, out_c, 1, 1))


def _inception_a(in_c: int, pool_c: int) -> ParallelConcat:
    return ParallelConcat([
        _branch(_conv(in_c, 64, 1, 1)),
        _branch(_conv(in_c, 48, 1, 1), _conv(48, 64, 5, 5)),
        _branch(_conv(in_c, 64, 1, 1), _conv(64, 96, 3, 3), _conv(96, 96, 3, 3)),
        _pool_branch(in_c, pool_c),
    ])


def _inception_b(in_c: int) -> ParallelConcat:
    return ParallelConcat([
        _branch(_conv(in_c, 384, 3, 3, stride=2, padding="VALID")),
        _branch(_conv(in_c, 64, 1, 1), _conv(64, 96, 3, 3),
                _conv(96, 96, 3, 3, stride=2, padding="VALID")),
        _branch(NITIMaxPool((3, 3), (2, 2))),
    ])


def _inception_c(in_c: int, c7: int) -> ParallelConcat:
    return ParallelConcat([
        _branch(_conv(in_c, 192, 1, 1)),
        _branch(_conv(in_c, c7, 1, 1), _conv(c7, c7, 1, 7), _conv(c7, 192, 7, 1)),
        _branch(_conv(in_c, c7, 1, 1), _conv(c7, c7, 7, 1), _conv(c7, c7, 1, 7),
                _conv(c7, c7, 7, 1), _conv(c7, 192, 1, 7)),
        _pool_branch(in_c, 192),
    ])


def _inception_d(in_c: int) -> ParallelConcat:
    return ParallelConcat([
        _branch(_conv(in_c, 192, 1, 1), _conv(192, 320, 3, 3, stride=2, padding="VALID")),
        _branch(_conv(in_c, 192, 1, 1), _conv(192, 192, 1, 7), _conv(192, 192, 7, 1),
                _conv(192, 192, 3, 3, stride=2, padding="VALID")),
        _branch(NITIMaxPool((3, 3), (2, 2))),
    ])


def _split_3x3(in_c: int) -> ParallelConcat:
    """The E module's factorized 3x3: concat[1x3, 3x1] of the same input."""
    return ParallelConcat([_branch(_conv(in_c, 384, 1, 3)), _branch(_conv(in_c, 384, 3, 1))])


def _inception_e(in_c: int) -> ParallelConcat:
    return ParallelConcat([
        _branch(_conv(in_c, 320, 1, 1)),
        _branch(_conv(in_c, 384, 1, 1), _split_3x3(384)),
        _branch(_conv(in_c, 448, 1, 1), _conv(448, 384, 3, 3), _split_3x3(384)),
        _pool_branch(in_c, 192),
    ])


def inceptionv3_niti(num_classes: int = 1000) -> Sequential:
    """Inception-v3 for 299x299x3 inputs (fully convolutional down to the
    global average pool, so any input from about 75 pixels runs); logit
    channels padded to a multiple of 4. Weights are zero until
    `reset_parameters` or a load."""
    layers: List[NITILayer] = []
    layers += _conv(3, 32, 3, 3, stride=2, padding="VALID")
    layers += _conv(32, 32, 3, 3, padding="VALID")
    layers += _conv(32, 64, 3, 3)
    layers.append(NITIMaxPool((3, 3), (2, 2)))
    layers += _conv(64, 80, 1, 1)
    layers += _conv(80, 192, 3, 3, padding="VALID")
    layers.append(NITIMaxPool((3, 3), (2, 2)))
    layers += [
        _inception_a(192, 32),  # -> 256
        _inception_a(256, 64),  # -> 288
        _inception_a(288, 64),  # -> 288
        _inception_b(288),  # -> 768, /2
        _inception_c(768, 128),
        _inception_c(768, 160),
        _inception_c(768, 160),
        _inception_c(768, 192),
        _inception_d(768),  # -> 1280, /2
        _inception_e(1280),  # -> 2048
        _inception_e(2048),
    ]
    layers += [GlobalAvgPool(), NITIConv2D(2048, (num_classes + 3) // 4 * 4, (1, 1)),
               SqueezeLogits()]
    return Sequential(layers)
