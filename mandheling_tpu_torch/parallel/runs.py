"""The ranks' side of a parallel run, for :func:`distributed.run_local`: a
few data-, tensor- or pipeline-parallel train steps from given params on
given batches, returning what the caller compares (the weights in the JAX
layout, the losses, the eval count) and measures (each rank's kernel
launches, its collectives and its wall time per step).

A spec is a dict: `model` (a NITI model, pickled to the ranks with its
weights), `params` (JAX-layout arrays that replace them, if given),
`device` ("cpu" or "cuda"), `backend` ("cuda" or "torch"), `mode` (the
fused mode), `allreduce` ("int32" or "int8"), `margins` (the dense and
depthwise filter-grad margins) and `batches` [(x, onehot), ...] of the
global batch; run-specific keys are named where they are read. With
`world` 0, :func:`dp_steps` runs the same steps in the calling process,
without a group: the single-process reference.
"""

from __future__ import annotations

import contextlib
import copy
import time
from typing import Any, Dict, List

import numpy as np
import torch

from ..ops import allreduce
from ..ops import conv as conv_ops
from ..ops import depthwise as dw_ops
from ..ops import kernels
from ..train.train_step import make_eval_step, make_train_step
from ..train.transfer import make_transfer_train_step
from ..utils.jax_params import export_jax_params, load_jax_params
from . import tp as tp_mod
from .distributed import (host_index, local_batch_slice, local_world_size, make_global_mesh,
                          shard_host_batch)
from .mesh import data_mesh, make_mesh
from .pp import pipe_mesh
from .pp_general import GPipePlan, make_gpipe_train_step
from .sharded_step import replicate, shard_batch


@contextlib.contextmanager
def _settings(spec):
    with contextlib.ExitStack() as stack:
        stack.enter_context(kernels.use_backend(spec.get("backend", "cuda")))
        stack.enter_context(conv_ops.use_fused_conv_mode(spec.get("mode", "matmul_only")))
        stack.enter_context(allreduce.use_grad_allreduce(spec.get("allreduce", "int32")))
        if spec.get("margins") is not None:
            stack.enter_context(dw_ops.recipe_margins(*spec["margins"]))
        yield


def _device(spec) -> torch.device:
    device = torch.device(spec.get("device", "cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(0)
    return device


def _model(spec, device):
    # a rank's own copy: torch's multiprocessing pickler hands the ranks the
    # parent's tensors in shared memory
    model = copy.deepcopy(spec["model"])
    if spec.get("params") is not None:
        load_jax_params(model.head if spec.get("transfer") else model, spec["params"])
    return model.to(device)


def _timed_steps(device, steps) -> Dict[str, Any]:
    """Run the step closures in order: per step its wall ms (the device
    synchronised after it), its collectives and their host ms (each timed
    from an idle card: `allreduce.timed_collectives`), those of each named
    site, and the kernel launches of all of them."""
    out = {"step_ms": [], "collectives": [], "collective_ms": [], "sites": [], "results": []}
    kernels.reset_launch_counts()
    for fn in steps:
        allreduce.reset_collective_stats()
        t0 = time.perf_counter()
        with allreduce.timed_collectives():
            r = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        calls, seconds = allreduce.collective_stats()
        out["collectives"].append(calls)
        out["collective_ms"].append(seconds * 1e3)
        out["sites"].append({k: (n, t * 1e3) for k, (n, t) in allreduce.collective_sites().items()})
        out["results"].append(r)
    out["launches"] = kernels.launch_counts()
    kernels.reset_launch_counts()
    return out


def _to_numpy(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


def _rows(mesh, global_mesh: bool, *arrays):
    """This rank's rows of global batch arrays: its data rank's
    (shard_batch), or on the global mesh its process's local slice, as the
    JAX multi-host worker feeds them (local_batch_slice,
    shard_host_batch)."""
    if not global_mesh:
        return shard_batch(mesh, *arrays)
    lo, hi = local_batch_slice(len(arrays[0]))
    return shard_host_batch(mesh, *(np.asarray(a)[lo:hi] for a in arrays))


def dp_steps(spec) -> Dict[str, Any]:
    """Data parallel over every rank of the world (`world` 0: one process,
    no group): the train steps, then an eval step on `eval` (x, labels) if
    given. With `transfer` True the model is a TransferModel, `params` its
    head's, and the step its transfer step. With `global_mesh` True the mesh
    is the multi-host one (distributed.make_global_mesh) and each rank feeds
    its process's rows; the result then has the rank's `host` and the ranks
    of a host, `local_world`."""
    device = _device(spec)
    single = spec.get("world", 1) == 0
    global_mesh = spec.get("global_mesh", False)
    mesh = None if single else make_global_mesh() if global_mesh else data_mesh()
    group = None if single else mesh.group("data")
    with _settings(spec):
        model = _model(spec, device)
        if not single:
            replicate(mesh, model)
        if spec.get("transfer"):
            step = make_transfer_train_step(model, group)
        else:
            step = make_train_step(model, group)
        batches = []
        for x, oh in spec["batches"]:
            if not single:
                x, oh = _rows(mesh, global_mesh, x, oh)
            batches.append((torch.as_tensor(x).to(device), torch.as_tensor(oh).to(device)))
        fns = [lambda b=b: step(*b) for b in batches]
        if spec.get("eval") is not None:
            xe, ye = spec["eval"]
            if not single:
                xe, ye = _rows(mesh, global_mesh, xe, ye)
            evals = make_eval_step(model, spec.get("num_classes", 10), group)
            xe, ye = torch.as_tensor(xe).to(device), torch.as_tensor(ye).to(device)
            fns.append(lambda: evals(xe, ye))
        run = _timed_steps(device, fns)
        head = model.head if spec.get("transfer") else model
        run["params"] = export_jax_params(head)
    results = [_to_numpy(r) for r in run.pop("results")]
    n_train = len(batches)
    run["losses"] = [float(v) for v in results[:n_train]]
    run["correct"] = int(results[n_train]) if len(results) > n_train else None
    if global_mesh:
        run["host"], run["local_world"] = host_index(), local_world_size()
    return run


def tp_steps(spec) -> Dict[str, Any]:
    """DP x TP over a (`n_data`, `n_model`) mesh of the world: the model's
    TPConv2D weights cut to this rank's OC slice; returns its own slices."""
    device = _device(spec)
    mesh = make_mesh(spec["n_data"], spec["n_model"])
    with _settings(spec):
        model = tp_mod.shard_params(mesh, _model(spec, device))
        step = tp_mod.make_tp_train_step(model, mesh)
        fns = []
        for x, oh in spec["batches"]:
            x, oh = shard_batch(mesh, x, oh)
            fns.append(lambda b=(x.to(device), oh.to(device)): step(*b))
        run = _timed_steps(device, fns)
        run["params"] = export_jax_params(model)
    run["losses"] = [float(_to_numpy(r)) for r in run.pop("results")]
    run["coords"] = dict(mesh.coords)
    return run


def gpipe_steps(spec) -> Dict[str, Any]:
    """GPipe over a (`n_data`, `n_stages`) mesh of the world: `microbatches`
    [(x_d (M, mb, ...) int8, x_e (M,) int32, onehot (M, mb, C)), ...] the
    steps' quantized inputs; the plan at microbatch shape `mb_shape`.
    Returns the rank's stage layers' weights and `bounds`."""
    device = _device(spec)
    mesh = pipe_mesh(spec["n_stages"], spec.get("n_data", 1))
    with _settings(spec):
        model = _model(spec, device)
        plan = GPipePlan(model, tuple(spec["mb_shape"]), spec["n_stages"])
        dp = spec.get("n_data", 1) > 1 or spec.get("data_parallel", False)
        step = make_gpipe_train_step(plan, mesh, spec["n_microbatches"], data_parallel=dp)
        fns = [lambda b=tuple(torch.as_tensor(a).to(device) for a in mbs): step(*b)
               for mbs in spec["microbatches"]]
        run = _timed_steps(device, fns)
        s = mesh.index("pipe")
        params = export_jax_params(model)
        run["params"] = params[plan.bounds[s]:plan.bounds[s + 1]]
    run["losses"] = [float(_to_numpy(r)) for r in run.pop("results")]
    run["coords"] = dict(mesh.coords)
    run["bounds"] = plan.bounds
    return run


def _row0(results, inner: str):
    return sorted((r for r in results if r["coords"]["data"] == 0),
                  key=lambda r: r["coords"][inner])


def pipeline_weights(results) -> List[Any]:
    """A pipeline's whole weights from :func:`gpipe_steps`' results: data
    row 0's stages, in pipe order."""
    return [p for r in _row0(results, "pipe") for p in r["params"]]


def tp_weights(results, model) -> List[Any]:
    """A TP model's whole weights from :func:`tp_steps`' results: each
    TPConv2D's OC slices of data row 0 joined in model-rank order, every
    other layer's from that row's first rank."""
    row = _row0(results, "model")
    out = []
    for i, layer in enumerate(model.layers):
        if isinstance(layer, tp_mod.TPConv2D):
            out.append({"w": (np.concatenate([r["params"][i]["w"][0] for r in row], axis=-1),
                              row[0]["params"][i]["w"][1])})
        else:
            out.append(row[0]["params"][i])
    return out


def sequence(items) -> List[Any]:
    """Several runs [(fn, spec), ...] one after the other in the same ranks
    (one process group, one start-up)."""
    return [fn(spec) for fn, spec in items]
