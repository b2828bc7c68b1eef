from .blocks import (GlobalAvgPool, NITIAvgPool, NITIDepthwiseConv2D, ParallelAdd, ParallelConcat,
                     ProjectedResidualBlock, ResidualBlock)
from .init import niti_xavier_int8, niti_xavier_int8_dw_per_channel
from .layers import Flatten, NITIConv2D, NITIMaxPool, NITIRelu, NITIRelu6, SqueezeLogits
from .module import NITILayer, Sequential
from .transform import dw_to_per_channel

__all__ = [
    "niti_xavier_int8",
    "niti_xavier_int8_dw_per_channel",
    "Flatten",
    "GlobalAvgPool",
    "NITIAvgPool",
    "NITIConv2D",
    "NITIDepthwiseConv2D",
    "NITIMaxPool",
    "NITIRelu",
    "NITIRelu6",
    "ParallelAdd",
    "ParallelConcat",
    "ProjectedResidualBlock",
    "ResidualBlock",
    "SqueezeLogits",
    "NITILayer",
    "Sequential",
    "dw_to_per_channel",
]
