"""The NITI int8 LeNet (port of ``mandheling_tpu/models/lenet.py``):
channels 1->20->52, FC 832->500->12, as the reference `NITIInt8` module
(demo/mnistTrain.cpp:132-188)."""

from __future__ import annotations

from ..nn.layers import Flatten, NITIConv2D, NITIMaxPool, NITIRelu, SqueezeLogits
from ..nn.module import Sequential


def lenet_niti() -> Sequential:
    """conv5x5(1->20) relu pool / conv5x5(20->52) relu pool / fc(832->500)
    relu / fc(500->12). Logits have 12 channels; targets are one-hot over
    the first 10. Weights are zero until `reset_parameters` or a load."""
    return Sequential(
        [
            NITIConv2D(1, 20, (5, 5)),
            NITIRelu(),
            NITIMaxPool((2, 2), (2, 2)),
            NITIConv2D(20, 52, (5, 5)),
            NITIRelu(),
            NITIMaxPool((2, 2), (2, 2)),
            Flatten(),
            NITIConv2D(832, 500, (1, 1)),
            NITIRelu(),
            NITIConv2D(500, 12, (1, 1)),
            SqueezeLogits(),
        ]
    )


NUM_CLASSES = 10
NITI_LOGIT_CHANNELS = 12
