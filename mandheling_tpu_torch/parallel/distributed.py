"""Multi-process data parallelism (port of
``mandheling_tpu/parallel/distributed.py``).

The JAX package joins its processes with `jax.distributed.initialize`,
configured by JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID;
here `torch.distributed` joins them, configured as `torchrun` sets the
environment: MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK. Every process is
one rank of the mesh (parallel/mesh.py) and feeds its own rows of the
global batch.

A host is the ranks that share a LOCAL_WORLD_SIZE, numbered host-major as
torchrun numbers them (rank = host * LOCAL_WORLD_SIZE + local rank), where
the JAX package's process is a host and its devices the host's ranks.

With nothing configured, `initialize()` is a no-op and everything runs as
one process (JAX `distributed.py:49-57`). Once configured, a failure to join
raises: there is no quiet fallback to one process.

:func:`run_local` starts `world` ranks as local processes on a FileStore in a
fresh temporary directory (never a fixed TCP port) and returns each rank's
result; the tests and `chip_smoke.py` run their groups with it (the demos
join through `initialize()` under a launcher). Given `local_world`, it
numbers its ranks as hosts of that many ranks, as torchrun does.
Every group is a gloo group: on one GPU the ranks share the card, which
NCCL refuses (one device a rank), and the collectives of ops/allreduce.py
hand torch.distributed host tensors only.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh
from .sharded_step import replicate

DEFAULT_TIMEOUT_S = 120.0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group; a no-op for one process or when already
    joined. The arguments fall back to the environment a `torchrun`
    launcher sets: MASTER_ADDR:MASTER_PORT, WORLD_SIZE and RANK."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if not coordinator_address or (num_processes or 1) <= 1 or dist.is_initialized():
        return
    if process_id is None:
        raise ValueError("a multi-process run needs its rank (RANK or process_id)")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_world_size() -> int:
    """The ranks of this rank's host: LOCAL_WORLD_SIZE, as torchrun sets
    it; without it, every rank of the world."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", process_count()))


def host_index() -> int:
    return process_index() // local_world_size()


def host_count() -> int:
    return process_count() // local_world_size()


def make_global_mesh(n_model: int = 1) -> Mesh:
    """(data, model) mesh over every rank of every host: the data axis
    host-major (a gradient sum crosses hosts once), the model axis within a
    host (JAX `distributed.py:74-82`). With torchrun's host-major ranks, the
    mesh's row-major grid is that layout wherever `n_model` divides the
    ranks of a host; otherwise a model group would cross hosts, and it
    raises."""
    n, local = process_count(), local_world_size()
    if n % local or local % n_model:
        raise ValueError(f"n_model={n_model} must divide the {local} ranks of a host, and "
                         f"{local} the {n} ranks of the world")
    return make_mesh(n // n_model, n_model)


def local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """[start, stop) rows of the global batch this process feeds."""
    p, n = process_index(), process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    per = global_batch // n
    return p * per, (p + 1) * per


def shard_host_batch(mesh: Mesh, *local_arrays) -> Tuple[torch.Tensor, ...]:
    """This process's rows (its `local_batch_slice`) as tensors: with one
    rank a process, they already are its shard of the mesh's data axis."""
    return tuple(torch.as_tensor(np.asarray(a)) for a in local_arrays)


# one rank a process: the global replication is the mesh's
replicate_global = replicate


def _rank_main(rank: int, world: int, local_world: Optional[int], store: str, timeout_s: float,
               threads: Optional[int], fn: Callable, args: tuple, results) -> None:
    try:
        if local_world:  # as torchrun numbers the ranks of a host
            os.environ.update(LOCAL_WORLD_SIZE=str(local_world), LOCAL_RANK=str(rank % local_world),
                              GROUP_RANK=str(rank // local_world))
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                                rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_local(world: int, fn: Callable, *args, timeout_s: float = DEFAULT_TIMEOUT_S,
              threads: Optional[int] = None, local_world: Optional[int] = None) -> List[Any]:
    """Run fn(*args) in `world` fresh processes joined as one process group
    (spawned, so `fn` must be importable: a module-level function) and
    return their results in rank order. Raises if a rank raises, exits
    without a result or does not finish within `timeout_s` (the ranks'
    collective timeout too); every process is ended before it returns.
    `threads` sets each rank's intra-op threads (torch's default: all
    cores, in every rank). `local_world` makes the ranks hosts of that many
    ranks (LOCAL_WORLD_SIZE, LOCAL_RANK and GROUP_RANK, as torchrun sets
    them), so that one machine can stand for several hosts."""
    if local_world and world % local_world:
        raise ValueError(f"{world} ranks are no whole number of hosts of {local_world}")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="mh_dist_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, local_world, store, timeout_s, threads, fn, args,
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, errors = {}, []
    try:
        deadline = timeout_s + 60.0  # process start and imports come first
        t_end = time.monotonic() + deadline
        while len(out) + len(errors) < world:
            left = t_end - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_local: {world - len(out) - len(errors)} of {world} "
                                   f"ranks gave no result within {deadline:.0f} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"run_local: rank(s) {dead} exited with "
                                       f"{[procs[r].exitcode for r in dead]} and no result")
                continue
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
        if errors:
            raise RuntimeError("run_local: a rank raised\n" + "\n".join(errors))
    finally:
        for p in procs:
            p.join(timeout=10 if len(out) == world else 0.5)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
