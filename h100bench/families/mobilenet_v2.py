"""MobileNetV2 (arXiv:1801.04381, Table 2) with the CIFAR stride plan, as
the reference's layers."""

from typing import List

from h100bench.reference import Conv, DepthwiseConv, GlobalAvgPool, Residual

# (expansion, out channels, blocks, first stride); the 24-channel stage at
# stride 1 for 32x32 inputs
CIFAR_PLAN = [(1, 16, 1, 1), (6, 24, 2, 1), (6, 32, 3, 2), (6, 64, 4, 2),
              (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]


def _width(c: int, mult: float) -> int:
    return max(4, int(c * mult) // 4 * 4)


def build(num_classes=10, width_mult=1.0, dw_per_channel=False) -> List:
    """3x3 stride-1 stem (relu6), inverted residuals (1x1 expand relu6, 3x3
    depthwise relu6, 1x1 linear projection; the skip where the stride is 1
    and the width unchanged), 1x1 head to 1280 (relu6), global pool, 1x1
    logits padded to a multiple of 4."""
    c_in = _width(32, width_mult)
    layers: List = [Conv(3, c_in, (3, 3), (1, 1), "SAME", act="relu6")]
    for t, c, n, s in CIFAR_PLAN:
        c_out = _width(c, width_mult)
        for i in range(n):
            stride = s if i == 0 else 1
            mid = c_in * t
            block = ([Conv(c_in, mid, act="relu6")] if t != 1 else []) + [
                DepthwiseConv(mid, (3, 3), (stride, stride), "SAME", dw_per_channel, "relu6"),
                Conv(mid, c_out)]
            if stride == 1 and c_in == c_out:
                layers.append(Residual(block))
            else:
                layers += block
            c_in = c_out
    head = _width(1280, width_mult)
    return layers + [Conv(c_in, head, act="relu6"), GlobalAvgPool(),
                     Conv(head, (num_classes + 3) // 4 * 4)]
