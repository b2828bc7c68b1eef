from . import optim, train_step
from .train_step import make_eval_step, make_train_step, quantize_batch

__all__ = ["optim", "train_step", "make_eval_step", "make_train_step", "quantize_batch"]
