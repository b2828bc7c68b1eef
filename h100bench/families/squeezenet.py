"""SqueezeNet v1.0 (Iandola et al., arXiv:1602.07360, Table 1) for 224x224x3
inputs, as the reference's layers. Departures, as the program builds it:
the 7x7/2 stem is SAME-padded and the 3x3/2 maxpools are VALID (floor);
no dropout after fire9; the logits padded to a multiple of 4. Like the
source, it has no batch norm and no FC layer."""

from typing import List

from h100bench.reference import Concat, Conv, GlobalAvgPool, MaxPool, Relu

# (squeeze, expand 1x1, expand 3x3) of fire2..fire9, "pool" where v1.0 pools
FIRE_PLAN = [(16, 64, 64), (16, 64, 64), (32, 128, 128), "pool", (32, 128, 128),
             (48, 192, 192), (48, 192, 192), (64, 256, 256), "pool", (64, 256, 256)]


def fire(in_c: int, squeeze: int, e1: int, e3: int) -> List:
    """1x1 squeeze and relu, then the channel concat of a 1x1 and a 3x3
    SAME expand, each with a relu."""
    return [Conv(in_c, squeeze), Relu(),
            Concat([[Conv(squeeze, e1), Relu()],
                    [Conv(squeeze, e3, (3, 3), (1, 1), "SAME"), Relu()]])]


def build(num_classes=1000) -> List:
    """7x7/2 stem (3 -> 96) and relu, 3x3/2 maxpool, fire2-fire9 with
    maxpools after fire4 and fire8, conv10 (1x1 to the logits) and relu,
    global average pool."""
    layers: List = [Conv(3, 96, (7, 7), (2, 2), "SAME"), Relu(), MaxPool((3, 3), (2, 2))]
    c = 96
    for entry in FIRE_PLAN:
        if entry == "pool":
            layers.append(MaxPool((3, 3), (2, 2)))
            continue
        layers += fire(c, *entry)
        c = entry[1] + entry[2]
    return layers + [Conv(c, (num_classes + 3) // 4 * 4), Relu(), GlobalAvgPool()]
