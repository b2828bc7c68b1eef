"""LeNet as Mandheling's NITIInt8 network (demo/mnistTrain.cpp:132-188), as
the reference's layers, for 28x28x1 MNIST inputs. The source has no batch
norm, and already pads its widths to multiples of 4 (52 channels, 832
features, 12 logits), so nothing departs from it."""

from typing import List

from h100bench.reference import Conv, Flatten, MaxPool, Relu


def build(num_classes=10) -> List:
    """5x5 conv (1 -> 20), relu, 2x2/2 maxpool; 5x5 conv (20 -> 52), relu,
    2x2/2 maxpool; the NHWC flatten (4x4x52 = 832); fc 832 -> 500 and relu;
    fc 500 -> the logits padded to a multiple of 4 (the FCs as 1x1 convs)."""
    return [Conv(1, 20, (5, 5)), Relu(), MaxPool((2, 2), (2, 2)),
            Conv(20, 52, (5, 5)), Relu(), MaxPool((2, 2), (2, 2)),
            Flatten(), Conv(832, 500), Relu(), Conv(500, (num_classes + 3) // 4 * 4)]
