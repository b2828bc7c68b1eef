from .init import niti_xavier_int8
from .layers import Flatten, NITIConv2D, NITIMaxPool, NITIRelu, NITIRelu6, SqueezeLogits
from .module import NITILayer, Sequential

__all__ = [
    "niti_xavier_int8",
    "Flatten",
    "NITIConv2D",
    "NITIMaxPool",
    "NITIRelu",
    "NITIRelu6",
    "SqueezeLogits",
    "NITILayer",
    "Sequential",
]
