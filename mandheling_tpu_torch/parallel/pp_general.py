"""General pipeline parallelism: contiguous `Sequential` slices as stages
(port of ``mandheling_tpu/parallel/pp_general.py``).

GPipe over the pipe axis of a (data, pipe) mesh: each pipe rank runs its own
slice of the model's layers. The JAX package runs one SPMD program, so it
pads every boundary activation and every stage's params into flat buffers
of one shape and picks the stage's code with `lax.switch`; here each rank
holds its stage's layers and sends the real int8 activation (and its int32
exponent) to its neighbour. `pack_params` / `unpack_params` remain as
converters to and from the JAX package's packed layout.

The schedule is the JAX package's (`pp_general.py:515-743`):
- M forward ticks; each stage keeps its input and residuals per microbatch;
- the loss and `loss_grad_int8` on the last stage;
- M backward ticks, the int8 output grads going back a stage each tick;
- per-weight int32 filter-grad accumulators (`bwd_acc`) summed over the
  microbatches and over the data group BEFORE one range estimate and shift
  per tensor with the layer's `grad_margin` (the reference's split-batch
  gradient contract, `NITI_DSPGradientSplitBatchConv_Int8.cpp`), then the
  clipped update;
- the mean loss over the microbatches, global over pipe and data.

With one microbatch the pipeline is bit-identical to one process on the
same quantized batch; with data parallelism the stage forwards take their
range estimates over the data group, as in parallel/sharded_step.py. The JAX
package recomputes each stage forward in the backward; keeping the
residuals gives the same bytes. Activations and grads cross stages by
`send` / `recv` (ops/allreduce.py), through host memory.
"""

from __future__ import annotations

import copy
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..nn.module import Sequential
from ..ops import allreduce, numerics
from ..ops.loss import loss_cross_entropy_float, loss_grad_int8
from ..ops.numerics import int8_clip
from ..ops.qtensor import QTensor
from ..train.train_step import det_psum
from ..utils.jax_params import export_jax_params, flat_weights
from .mesh import DATA_AXIS, Mesh
from .pp import PIPE_AXIS, pipe_mesh  # noqa: F401  (re-exported, as in the JAX package)


def _int8_elems(layer) -> int:
    return sum(b.numel() for b in layer.buffers() if b.dtype == torch.int8)


def _fill(p: Any, leaves: Iterator[np.ndarray]) -> Any:
    """JAX-layout params shaped like `p`, their arrays taken from `leaves`
    in flat_weights' order."""
    if isinstance(p, list):
        return [_fill(q, leaves) for q in p]
    if p and "branch" in p:
        return {"branch": _fill(p["branch"], leaves), "proj": {"w": (next(leaves), next(leaves))}}
    if p:
        return {"w": (next(leaves), next(leaves))}
    return ()


class GPipePlan:
    """Static stage plan: the layer slices (`bounds`), the activation shape
    at every layer boundary and the layout of JAX's packed params.

    The shapes are traced on the meta device at the microbatch shape, the
    stages balanced by the JAX package's planner (its arithmetic, so
    `bounds` are its bounds)."""

    def __init__(self, model: Sequential, microbatch_shape: Tuple[int, ...], n_stages: int,
                 bounds: Optional[Sequence[int]] = None):
        self.model = model
        self.n_stages = n_stages
        n_layers = len(model.layers)
        shadow = copy.deepcopy(model).to("meta")
        q = QTensor(torch.zeros(tuple(microbatch_shape), dtype=torch.int8, device="meta"),
                    torch.zeros((), dtype=torch.int32, device="meta"))
        shapes = [tuple(microbatch_shape)]
        for layer in shadow.layers:
            q, _ = layer.fwd(q)
            shapes.append(tuple(q.data.shape))
        self.act_shapes = shapes
        if bounds is None:
            bounds = self._balance([_int8_elems(layer) for layer in model.layers], shapes,
                                   n_layers, n_stages)
        if not (len(bounds) == n_stages + 1 and bounds[0] == 0 and bounds[-1] == n_layers):
            raise ValueError(f"bounds {bounds} do not split {n_layers} layers into "
                             f"{n_stages} stages")
        if not all(b1 > b0 for b0, b1 in zip(bounds, bounds[1:])):
            raise ValueError(f"empty stage in bounds {bounds}")
        self.bounds = list(bounds)
        self.stage_in_shapes = [shapes[b] for b in self.bounds[:-1]]
        self.stage_out_shapes = [shapes[b] for b in self.bounds[1:]]

        # the JAX packed layout: per stage, per leaf (kind, offset, shape)
        self._template = export_jax_params(model)
        self.layouts = []
        p8max = p32max = 0
        for k in range(n_stages):
            entries, o8, o32 = [], 0, 0
            for leaf in flat_weights(self._template[self.bounds[k]:self.bounds[k + 1]]):
                if leaf.dtype == np.int8:
                    entries.append(("i8", o8, leaf.shape))
                    o8 += leaf.size
                else:
                    entries.append(("i32", o32, leaf.shape))
                    o32 += leaf.size
            self.layouts.append(entries)
            p8max, p32max = max(p8max, o8), max(p32max, o32)
        self.flat_p8, self.flat_p32 = max(p8max, 1), max(p32max, 1)

    @staticmethod
    def _balance(int8_elems: Sequence[int], act_shapes, n_layers: int,
                 n_stages: int) -> List[int]:
        """Contiguous stages minimizing the largest stage's compute (JAX
        `pp_general.py:139-181`): per layer, MACs for a layer with int8
        weights (out_elems x weight_elems / oc), output elements otherwise;
        an exact min-max by dynamic programming."""
        costs = []
        for i, p8 in enumerate(int8_elems):
            out_elems = int(np.prod(act_shapes[i + 1]))
            if p8:
                oc = act_shapes[i + 1][-1]
                costs.append(out_elems * max(p8 // max(oc, 1), 1))
            else:
                costs.append(out_elems)
        prefix = np.concatenate([[0], np.cumsum(costs)])
        inf = float("inf")
        dp = [[inf] * (n_layers + 1) for _ in range(n_stages + 1)]
        cut = [[0] * (n_layers + 1) for _ in range(n_stages + 1)]
        dp[0][0] = 0.0
        for s in range(1, n_stages + 1):
            for i in range(s, n_layers + 1):
                for j in range(s - 1, i):
                    v = max(dp[s - 1][j], prefix[i] - prefix[j])
                    if v < dp[s][i]:
                        dp[s][i] = v
                        cut[s][i] = j
        bounds = [n_layers]
        i = n_layers
        for s in range(n_stages, 0, -1):
            i = cut[s][i]
            bounds.append(i)
        return list(reversed(bounds))

    def stage_layers(self, k: int):
        return list(self.model.layers[self.bounds[k]:self.bounds[k + 1]])

    def pack_params(self, params: List[Any]) -> Tuple[np.ndarray, np.ndarray]:
        """JAX-layout params -> the JAX package's ((S, FLAT_P8) int8,
        (S, FLAT_P32) int32) packed buffers."""
        p8 = np.zeros((self.n_stages, self.flat_p8), np.int8)
        p32 = np.zeros((self.n_stages, self.flat_p32), np.int32)
        for k in range(self.n_stages):
            leaves = flat_weights(params[self.bounds[k]:self.bounds[k + 1]])
            for leaf, (kind, off, shape) in zip(leaves, self.layouts[k]):
                buf = p8 if kind == "i8" else p32
                buf[k, off:off + int(np.prod(shape))] = np.ravel(leaf)
        return p8, p32

    def unpack_params(self, packed: Tuple[np.ndarray, np.ndarray]) -> List[Any]:
        """The JAX package's packed buffers -> JAX-layout params."""
        p8, p32 = (np.asarray(b) for b in packed)
        leaves = []
        for k in range(self.n_stages):
            for kind, off, shape in self.layouts[k]:
                buf = p8 if kind == "i8" else p32
                leaves.append(buf[k, off:off + int(np.prod(shape))].reshape(shape))
        return _fill(self._template, iter(leaves))


def make_gpipe_train_step(plan: GPipePlan, mesh: Mesh, n_microbatches: int,
                          data_parallel: bool = False):
    """GPipe train step over `mesh` (data, pipe) for this rank's stage.

    step(x_d (M, mb, ...) int8, x_e (M,) int32, onehot (M, mb, C)) -> mean
    loss, updating the rank's stage layers in place. The inputs are the
    whole microbatches, quantized per microbatch (pp.quantize_microbatches);
    under `data_parallel` each rank takes its data rank's rows of each."""
    S, M = plan.n_stages, n_microbatches
    if mesh.shape[PIPE_AXIS] != S:
        raise ValueError(f"mesh has {mesh.shape[PIPE_AXIS]} pipe ranks, the plan {S} stages")
    group = mesh.group(DATA_AXIS) if data_parallel else None
    n_data = mesh.shape[DATA_AXIS] if data_parallel else 1
    s = mesh.index(PIPE_AXIS)
    layers = plan.stage_layers(s)
    first, last = s == 0, s == S - 1
    prev = None if first else mesh.rank_at(pipe=s - 1)
    nxt = None if last else mesh.rank_at(pipe=s + 1)

    def step(x_d: torch.Tensor, x_e: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
        device = x_d.device
        mbl = x_d.shape[1] // n_data
        rows = slice(mesh.index(DATA_AXIS) * mbl, (mesh.index(DATA_AXIS) + 1) * mbl) \
            if data_parallel else slice(None)
        in_shape = (mbl,) + tuple(plan.stage_in_shapes[s][1:])
        out_shape = (mbl,) + tuple(plan.stage_out_shapes[s][1:])
        residuals, logits = [], []
        for m in range(M):  # forward ticks
            if first:
                q = QTensor(x_d[m, rows], x_e[m])
            else:
                q = QTensor(allreduce.recv(in_shape, torch.int8, prev, device),
                            allreduce.recv((), torch.int32, prev, device))
            res = []
            for layer in layers:
                q, r = layer.fwd(q, group)
                res.append(r)
            residuals.append(res)
            if last:
                logits.append(q)
            else:
                allreduce.send(q.data, nxt)
                allreduce.send(q.exp, nxt)

        zero = torch.zeros((), dtype=torch.float64, device=device)
        gys = []
        if last:
            oh = onehot[:, rows].to(torch.int32)
            losses = [loss_cross_entropy_float(lg.data, lg.exp, oh[m])
                      for m, lg in enumerate(logits)]
            gys = [loss_grad_int8(lg.data, lg.exp, oh[m]) for m, lg in enumerate(logits)]
            loss = torch.stack(losses).mean()
        else:
            loss = zero
        if mesh.group(PIPE_AXIS) is not None:
            loss = allreduce.psum(loss, mesh.group(PIPE_AXIS))
        if group is not None:
            loss = det_psum(loss, group) / float(n_data)

        accs = {}  # stage layer index -> int32 filter-grad accumulator
        for m in range(M):  # backward ticks
            g = gys[m].reshape(out_shape) if last else allreduce.recv(out_shape, torch.int8, nxt, device)
            for i in range(len(layers) - 1, -1, -1):
                layer, r = layers[i], residuals[m][i]
                need_gx = not (first and i == 0)
                if hasattr(layer, "bwd_acc"):
                    g, acc = layer.bwd_acc(r, g, group, need_input_grad=need_gx)
                    accs[i] = acc["w"] if i not in accs else accs[i] + acc["w"]
                else:
                    if _int8_elems(layer):
                        raise TypeError(f"layer {type(layer).__name__} has weights but no "
                                        "bwd_acc: exact microbatch accumulation is impossible")
                    g = layer.bwd(r, g, group)[0] if need_gx else None
            if not first:
                allreduce.send(g, prev)
            residuals[m] = None

        if accs and group is not None:  # one sum of every accumulator over the data group
            order = sorted(accs)
            flat = allreduce.psum(torch.cat([accs[i].reshape(-1) for i in order]), group)
            for i, part in zip(order, torch.split(flat, [accs[i].numel() for i in order])):
                accs[i] = part.reshape(accs[i].shape)
        for i, acc in accs.items():
            layer = layers[i]
            gq = numerics.requant_grad_from_bw(acc, numerics.range_estimate(acc),
                                               layer.grad_margin)
            layer.w.copy_(int8_clip(layer.w.to(torch.int32) - gq.to(torch.int32)))
        return loss

    return step
