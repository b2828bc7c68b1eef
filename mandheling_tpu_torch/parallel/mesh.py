"""Process meshes for data, model and pipeline parallel NITI training (port
of ``mandheling_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a `jax.sharding.Mesh` and names the
axes its collectives run over. Here each rank of the ``torch.distributed``
world is one point of a two-axis grid, laid out row-major as in JAX (rank =
i * n_inner + j), and holds a process group per axis: the ranks that share
its other coordinate. The groups come from `dist.new_group`, which every
rank calls for every group in the same order. `dist.init_device_mesh`
would pick NCCL for CUDA tensors, which cannot put two ranks on one card;
these groups take the world's backend (gloo there).

Without an initialized process group a 1 x 1 mesh has no groups: its steps
take the single-process path (`group` None).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """This rank's place in an (outer x inner) grid of ranks: `shape` and
    `coords` by axis name, the process group of each axis (`group`) and of
    the whole grid (`world`); groups are None for a mesh of one process."""

    def __init__(self, axes: Tuple[str, str], shape: Tuple[int, int]):
        self.axis_names = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        n_outer, n_inner = shape
        size = n_outer * n_inner
        self.groups: Dict[str, Optional[dist.ProcessGroup]] = {a: None for a in axes}
        self.world: Optional[dist.ProcessGroup] = None
        if not dist.is_initialized():
            if size != 1:
                raise RuntimeError(f"a {n_outer}x{n_inner} mesh needs {size} processes; "
                                   "torch.distributed is not initialized")
            self.rank = 0
        else:
            if dist.get_world_size() != size:
                raise ValueError(f"a {n_outer}x{n_inner} mesh needs {size} processes, "
                                 f"the world has {dist.get_world_size()}")
            self.rank = dist.get_rank()
            outer, inner = axes
            # every rank creates every group, in the same order
            for o in range(n_outer):
                g = dist.new_group([o * n_inner + i for i in range(n_inner)])
                if self.rank // n_inner == o:
                    self.groups[inner] = g
            for i in range(n_inner):
                g = dist.new_group([o * n_inner + i for o in range(n_outer)])
                if self.rank % n_inner == i:
                    self.groups[outer] = g
            self.world = dist.new_group(list(range(size)))
        self.coords: Dict[str, int] = dict(zip(axes, divmod(self.rank, n_inner)))

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis` (`lax.axis_index`)."""
        return self.coords[axis]

    def rank_at(self, **coords: int) -> int:
        """The global rank at the given coordinates (the others: this rank's)."""
        o, i = (coords.get(a, self.coords[a]) for a in self.axis_names)
        return o * self.shape[self.axis_names[1]] + i

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords})"


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """(data, model) mesh over the world; data on the outer axis, as in the
    JAX package (JAX `parallel/mesh.py:16-33`)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None:
        n_data = world // n_model
    return Mesh((DATA_AXIS, MODEL_AXIS), (n_data, n_model))


def data_mesh(n: Optional[int] = None) -> Mesh:
    """Pure data-parallel mesh, (n, 1)."""
    return make_mesh(n, 1)
