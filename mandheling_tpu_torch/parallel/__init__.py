"""Data, tensor and pipeline parallelism on ``torch.distributed`` (port of
``mandheling_tpu/parallel``): process meshes, the data-parallel and
tensor-parallel steps, GPipe, the multi-process runtime and a local
launcher. Every step is bit-identical to one process (the JAX package's
contract, `parallel/sharded_step.py:1-16`)."""

from . import distributed, mesh, pp, pp_general, sharded_step, tp
from .mesh import DATA_AXIS, MODEL_AXIS, data_mesh, make_mesh
from .pp import PIPE_AXIS, homogeneous_blocks, pipe_mesh, quantize_microbatches
from .pp_general import GPipePlan, make_gpipe_train_step
from .sharded_step import make_dp_eval_step, make_dp_train_step, replicate, shard_batch

__all__ = [
    "mesh",
    "pp",
    "pp_general",
    "sharded_step",
    "DATA_AXIS",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "data_mesh",
    "make_mesh",
    "make_dp_eval_step",
    "make_dp_train_step",
    "GPipePlan",
    "make_gpipe_train_step",
    "homogeneous_blocks",
    "pipe_mesh",
    "quantize_microbatches",
    "replicate",
    "shard_batch",
]
