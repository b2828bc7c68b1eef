"""Rank workers of the port's parallel tests, for
`mandheling_tpu_torch.parallel.distributed.run_local` and for processes a
test starts as a launcher would. The ranks import this module, so it
imports nothing of JAX (the JAX references run in the test's process)."""

import os
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from mandheling_tpu_torch.ops import allreduce
from mandheling_tpu_torch.ops import conv as conv_ops
from mandheling_tpu_torch.ops import kernels
from mandheling_tpu_torch.parallel import distributed


def op_rows(spec) -> Dict[str, Any]:
    """`op` (a module-level function) on `args`, each cut to this rank's
    rows (the batch axis first) where `split` (one flag an argument; by
    default the first only) says so, `kwargs` added, with the world group
    as `group=`, on `device` under the kernel `backend` and fused `mode`:
    {"out": the outputs as numpy arrays, "launches": the kernel launches
    of the call}."""
    device = torch.device(spec.get("device", "cpu"))
    n, r = dist.get_world_size(), dist.get_rank()
    args = []
    splits = spec.get("split", [True] + [False] * (len(spec["args"]) - 1))
    for a, split in zip(spec["args"], splits):
        a = torch.as_tensor(np.asarray(a))
        if split:
            per = a.shape[0] // n
            a = a[r * per:(r + 1) * per]
        args.append(a.to(device))
    kernels.reset_launch_counts()
    with kernels.use_backend(spec.get("backend", "cuda")), \
            conv_ops.use_fused_conv_mode(spec.get("mode", "matmul_only")):
        out = spec["op"](*args, **spec.get("kwargs", {}), group=dist.group.WORLD)
    out = out if isinstance(out, tuple) else (out,)
    return {"out": [o.detach().cpu().numpy() for o in out],
            "launches": kernels.launch_counts()}


def join_from_env(env, results) -> None:
    """A process as a launcher starts one: `env` (the torchrun variables)
    set, `distributed.initialize()`, one maximum over the world; puts
    (rank, world, largest rank, local_batch_slice(128)) on `results`."""
    os.environ.update(env)
    distributed.initialize(timeout_s=60)
    try:
        top = allreduce.pmax(torch.tensor(dist.get_rank()), dist.group.WORLD)
        results.put((distributed.process_index(), distributed.process_count(), int(top),
                     distributed.local_batch_slice(128)))
    finally:
        dist.destroy_process_group()


def global_mesh_coords(spec) -> Dict[str, Any]:
    """This rank's host and its place on `make_global_mesh(n_model)` for
    each `n_model` of the spec (the error text where it raises)."""
    out = {"host": distributed.host_index(), "hosts": distributed.host_count()}
    for n_model in spec["n_model"]:
        try:
            out[n_model] = dict(distributed.make_global_mesh(n_model).coords)
        except ValueError as e:
            out[n_model] = str(e)
    return out
