from . import optim, step_graph, train_step
from .train_step import (jit_eval_step, jit_train_step, make_eval_step, make_train_step,
                         quantize_batch)

__all__ = ["optim", "step_graph", "train_step", "jit_eval_step", "jit_train_step",
           "make_eval_step", "make_train_step", "quantize_batch"]
