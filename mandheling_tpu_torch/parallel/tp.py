"""Tensor parallelism: output-channel-sharded NITI conv layers (port of
``mandheling_tpu/parallel/tp.py``).

A TPConv2D shards its output channels over the mesh's model axis:

- forward: each rank computes its OC slice of the int32 accumulator (K1 on
  the card); the requant shift comes from the maximum over BOTH axes (the
  NITI range estimate is per-tensor), then the int8 slices are gathered
  along the channel axis;
- backward dx: each rank's transposed conv gives the partial sum over its
  OC slice; the int32 partials are summed over the model group BEFORE the
  single bw-7 shift;
- backward dw: each rank keeps its OC slice of the filter gradient, summed
  over the data group only; its range estimate is the maximum over both
  axes, so every rank applies the same shift, and the integer update stays
  rank-local.

So DP x TP training is bit-identical to one process. In the JAX package
the layer finds the model axis by tracing inside `shard_map`; here
:func:`shard_params` binds the mesh to each TPConv2D and cuts its weight
to the rank's slice. An unbound TPConv2D is the dense layer.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..nn.layers import Flatten, NITIConv2D, NITIMaxPool, NITIRelu, SqueezeLogits
from ..nn.module import Sequential
from ..ops import allreduce, numerics
from ..ops.conv import conv2d_filter_grad_acc, conv2d_input_grad_acc, conv2d_int8_acc
from ..ops.qtensor import QTensor
from ..train.train_step import make_train_step
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh


class TPConv2D(NITIConv2D):
    """NITIConv2D with its output channels sharded over the model axis of
    the mesh that :func:`shard_params` binds; `w` then holds this rank's
    OC slice."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.mesh: Optional[Mesh] = None

    def _model_group(self):
        return None if self.mesh is None else self.mesh.group(MODEL_AXIS)

    def _both(self, group):
        """The group of the maximum over the data axis (`group`) and the
        model axis (JAX `tp.py:112-118`)."""
        if self.mesh is None:
            return group
        return self.mesh.world if group is not None else self._model_group()

    def fwd(self, q: QTensor, group=None):
        acc = conv2d_int8_acc(q.data, self.w, self.stride, self.padding)
        bw = numerics.range_estimate_from_max(
            allreduce.maybe_pmax(numerics.abs_max(acc), self._both(group)))
        exp_in = q.exp.to(torch.int32) + self.w_exp.to(torch.int32)
        y, e = numerics.requant_forward_from_bw(acc, exp_in, bw)
        if self.mesh is not None:
            y = torch.cat(allreduce.all_gather(y, self._model_group()), dim=-1)
        return QTensor(y, e), q.data

    def bwd(self, res, gy, group=None):
        x = res
        oc_local = self.w.shape[-1]
        if self.mesh is not None:
            idx = self.mesh.index(MODEL_AXIS)
            gy = gy[..., idx * oc_local:(idx + 1) * oc_local]
        # dx: partial over the local OC slice -> int32 sum -> one shift
        acc_dx = conv2d_input_grad_acc(gy, self.w, (x.shape[1], x.shape[2]), self.stride,
                                       self.padding)
        if self.mesh is not None:
            acc_dx = allreduce.psum(acc_dx, self._model_group())
        bw = numerics.range_estimate_from_max(
            allreduce.maybe_pmax(numerics.abs_max(acc_dx), group))
        gx, _ = numerics.requant_forward_from_bw(
            acc_dx, torch.zeros((), dtype=torch.int32, device=acc_dx.device), bw)
        # dw: the local OC slice, summed over the data group; one global bw
        acc_dw = conv2d_filter_grad_acc(x, gy, self.kernel, self.stride, self.padding)
        if group is not None:
            acc_dw = allreduce.psum(acc_dw, group)
        bww = numerics.range_estimate_from_max(
            allreduce.maybe_pmax(numerics.abs_max(acc_dw), self._both(group)))
        gw = numerics.requant_grad_from_bw(acc_dw, bww, margin=2)
        return gx, {"w": QTensor(gw, torch.zeros((), dtype=torch.int32, device=gw.device))}

    def bwd_params_only(self, res, gy, group=None):
        # the model group's collectives of the input grad run on every rank
        return self.bwd(res, gy, group)[1]


def tp_param_specs(model: Sequential) -> List[Optional[dict]]:
    """Per layer, how its weight is laid out on the mesh: {"w": axis name
    per dimension} for a TPConv2D (OC over the model axis), None where
    every rank holds the whole weight (JAX's PartitionSpec tree)."""
    return [{"w": (None, None, None, MODEL_AXIS)} if isinstance(layer, TPConv2D) else None
            for layer in model.layers]


def shard_params(mesh: Mesh, model: Sequential) -> Sequential:
    """Bind `mesh` to every TPConv2D of `model` and cut its weight to this
    rank's OC slice, in place. Returns the model."""
    n, idx = mesh.shape[MODEL_AXIS], mesh.index(MODEL_AXIS)
    for layer, spec in zip(model.layers, tp_param_specs(model)):
        if spec is None:
            continue
        oc = layer.w.shape[-1]
        if oc % n:
            raise ValueError(f"{oc} output channels do not split over {n} model ranks")
        per = oc // n
        layer.w = layer.w[..., idx * per:(idx + 1) * per].clone()
        layer.mesh = mesh
    return model


def make_tp_train_step(model: Sequential, mesh: Mesh):
    """DP x TP train step over a (data, model) mesh: the model's TPConv2D
    layers bound by :func:`shard_params`, the data group passed down."""
    return make_train_step(model, group=mesh.group(DATA_AXIS))


def lenet_niti_tp() -> Sequential:
    """The NITI LeNet with its 832 -> 500 FC sharded over the model axis;
    the 12-logit head stays replicated, so every rank holds all the logits
    for the loss."""
    return Sequential([
        NITIConv2D(1, 20, (5, 5)),
        NITIRelu(),
        NITIMaxPool((2, 2), (2, 2)),
        NITIConv2D(20, 52, (5, 5)),
        NITIRelu(),
        NITIMaxPool((2, 2), (2, 2)),
        Flatten(),
        TPConv2D(832, 500, (1, 1)),
        NITIRelu(),
        NITIConv2D(500, 12, (1, 1)),
        SqueezeLogits(),
    ])
