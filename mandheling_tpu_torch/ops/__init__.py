from . import allreduce, conv, depthwise, eltwise, loss, numerics, pool, relu
from .qtensor import QTensor, quantize_input, quantize_weights

__all__ = [
    "allreduce",
    "conv",
    "depthwise",
    "eltwise",
    "loss",
    "numerics",
    "pool",
    "relu",
    "QTensor",
    "quantize_input",
    "quantize_weights",
]
