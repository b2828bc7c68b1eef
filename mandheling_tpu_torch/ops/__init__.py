from . import allreduce, conv, loss, numerics, pool, relu
from .qtensor import QTensor, quantize_input, quantize_weights

__all__ = [
    "allreduce",
    "conv",
    "loss",
    "numerics",
    "pool",
    "relu",
    "QTensor",
    "quantize_input",
    "quantize_weights",
]
