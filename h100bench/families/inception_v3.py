"""Inception-v3 (Szegedy et al., "Rethinking the Inception Architecture for
Computer Vision", arXiv:1512.00567) for 299x299x3 inputs, as the
reference's layers. Departures, as the program builds it: no batch norm
(each conv is followed by a relu alone; the power-of-two requant takes the
norm's place); no auxiliary classifier and no dropout; the maxpools are
VALID; the logits padded to a multiple of 4. The modules' branches join by
the exponent-aligned channel concat, and the pooling branches average over
3x3 windows of the input zero-padded by one pixel."""

from typing import List

from h100bench.reference import AvgPool, Concat, Conv, GlobalAvgPool, MaxPool, Relu


def conv(in_c: int, out_c: int, kh: int, kw: int, stride: int = 1, padding="SAME") -> List:
    return [Conv(in_c, out_c, (kh, kw), (stride, stride), padding), Relu()]


def pool_branch(in_c: int, out_c: int) -> List:
    return [AvgPool((3, 3), (1, 1), pad=1)] + conv(in_c, out_c, 1, 1)


def module_a(in_c: int, pool_c: int) -> Concat:
    return Concat([conv(in_c, 64, 1, 1),
                   conv(in_c, 48, 1, 1) + conv(48, 64, 5, 5),
                   conv(in_c, 64, 1, 1) + conv(64, 96, 3, 3) + conv(96, 96, 3, 3),
                   pool_branch(in_c, pool_c)])


def module_b(in_c: int) -> Concat:
    return Concat([conv(in_c, 384, 3, 3, 2, "VALID"),
                   conv(in_c, 64, 1, 1) + conv(64, 96, 3, 3) + conv(96, 96, 3, 3, 2, "VALID"),
                   [MaxPool((3, 3), (2, 2))]])


def module_c(in_c: int, c7: int) -> Concat:
    return Concat([conv(in_c, 192, 1, 1),
                   conv(in_c, c7, 1, 1) + conv(c7, c7, 1, 7) + conv(c7, 192, 7, 1),
                   conv(in_c, c7, 1, 1) + conv(c7, c7, 7, 1) + conv(c7, c7, 1, 7)
                   + conv(c7, c7, 7, 1) + conv(c7, 192, 1, 7),
                   pool_branch(in_c, 192)])


def module_d(in_c: int) -> Concat:
    return Concat([conv(in_c, 192, 1, 1) + conv(192, 320, 3, 3, 2, "VALID"),
                   conv(in_c, 192, 1, 1) + conv(192, 192, 1, 7) + conv(192, 192, 7, 1)
                   + conv(192, 192, 3, 3, 2, "VALID"),
                   [MaxPool((3, 3), (2, 2))]])


def split_3x3(in_c: int) -> Concat:
    """Module E's factorized 3x3: the concat of a 1x3 and a 3x1 of one input."""
    return Concat([conv(in_c, 384, 1, 3), conv(in_c, 384, 3, 1)])


def module_e(in_c: int) -> Concat:
    return Concat([conv(in_c, 320, 1, 1),
                   conv(in_c, 384, 1, 1) + [split_3x3(384)],
                   conv(in_c, 448, 1, 1) + conv(448, 384, 3, 3) + [split_3x3(384)],
                   pool_branch(in_c, 192)])


def build(num_classes=1000) -> List:
    """Stem (3x3/2, 3x3, 3x3 SAME, maxpool, 1x1, 3x3, maxpool), modules
    A x3 (-> 256, 288, 288), B (-> 768, /2), C x4 (c7 128, 160, 160, 192),
    D (-> 1280, /2), E x2 (-> 2048), global pool, 1x1 logits."""
    layers: List = (conv(3, 32, 3, 3, 2, "VALID") + conv(32, 32, 3, 3, 1, "VALID")
                    + conv(32, 64, 3, 3) + [MaxPool((3, 3), (2, 2))]
                    + conv(64, 80, 1, 1) + conv(80, 192, 3, 3, 1, "VALID")
                    + [MaxPool((3, 3), (2, 2))])
    layers += [module_a(192, 32), module_a(256, 64), module_a(288, 64), module_b(288),
               module_c(768, 128), module_c(768, 160), module_c(768, 160), module_c(768, 192),
               module_d(768), module_e(1280), module_e(2048)]
    return layers + [GlobalAvgPool(), Conv(2048, (num_classes + 3) // 4 * 4)]
