"""Data-parallel NITI training over a process mesh (port of
``mandheling_tpu/parallel/sharded_step.py``).

Numerics contract: sharded training is BIT-IDENTICAL to one process.
- forward and input-grad requant shifts come from the maximum of |acc|
  over the data group (ops/conv.py, between the fused kernels' phases);
- weight-gradient int32 accumulators are summed over the group BEFORE the
  single global range estimate and pseudo-stochastic shift
  (ops/allreduce.py);
- the batch statistics of the input quantization are global
  (train/train_step.py).

Every rank then applies the same int8 delta, so the weights never diverge
and are never re-synchronized. Where the JAX package wraps the step in
`shard_map` and `jit`, each rank here runs the local step with the data
group bound, on its own rows of the global batch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..nn.module import Sequential
from ..train.train_step import make_eval_step, make_train_step
from .mesh import DATA_AXIS, Mesh


def make_dp_train_step(model: Sequential, mesh: Mesh):
    """step(x, onehot) -> loss on this rank's rows, updating the model in
    place (JAX `sharded_step.py:29-42`)."""
    return make_train_step(model, group=mesh.group(DATA_AXIS))


def make_dp_eval_step(model: Sequential, mesh: Mesh, num_classes: int = 10):
    """eval(x, labels) -> the global correct count."""
    return make_eval_step(model, num_classes, group=mesh.group(DATA_AXIS))


def shard_batch(mesh: Mesh, *arrays) -> Tuple[torch.Tensor, ...]:
    """This rank's rows of each global batch array, as tensors on the CPU."""
    n, d = mesh.shape[DATA_AXIS], mesh.index(DATA_AXIS)
    out = []
    for a in arrays:
        a = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
        if a.shape[0] % n:
            raise ValueError(f"batch {a.shape[0]} not divisible by {n} data ranks")
        per = a.shape[0] // n
        out.append(a[d * per:(d + 1) * per])
    return tuple(out)


def replicate(mesh: Mesh, model):
    """The JAX package places the params on every device; here every rank
    holds its own copy, equal by construction. This checks it: rank 0's
    weights are broadcast and must equal each rank's own. Returns `model`."""
    if mesh.world is None:
        return model
    for name, buf in model.named_buffers():
        ref = buf.detach().clone()
        dist.broadcast(ref, src=0, group=mesh.world)
        if not torch.equal(ref, buf):
            raise AssertionError(f"rank {mesh.rank}: {name} differs from rank 0's")
    return model
