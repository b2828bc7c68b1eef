from . import allreduce, conv, depthwise, eltwise, loss, matmul, numerics, pool, relu, softmax
from .qtensor import QTensor, quantize_input, quantize_weights

__all__ = [
    "allreduce",
    "conv",
    "depthwise",
    "eltwise",
    "loss",
    "matmul",
    "numerics",
    "pool",
    "relu",
    "softmax",
    "QTensor",
    "quantize_input",
    "quantize_weights",
]
