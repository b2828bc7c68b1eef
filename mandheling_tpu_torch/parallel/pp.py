"""Pipeline-parallel helpers: the (data, pipe) mesh, per-microbatch input
quantization and the homogeneous block stack (port of
``mandheling_tpu/parallel/pp.py``).

The reference's only inter-engine concurrency is its CPU||DSP
co-scheduling plus a batch-split gradient strategy
(`NITI_DSPGradientSplitBatchConv_Int8.cpp`); the JAX package generalizes
both to GPipe over a 'pipe' mesh axis, implemented once for any
`Sequential` in parallel/pp_general.py.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..nn.layers import NITIConv2D, NITIRelu, SqueezeLogits
from ..nn.module import NITILayer, Sequential
from ..train.train_step import quantize_batch
from .mesh import DATA_AXIS, Mesh

PIPE_AXIS = "pipe"


def pipe_mesh(n_stages: int, n_data: int = 1) -> Mesh:
    """(data, pipe) mesh, pipe on the inner axis: rank = d * n_stages + s."""
    return Mesh((DATA_AXIS, PIPE_AXIS), (n_data, n_stages))


def quantize_microbatches(x: torch.Tensor, n_microbatches: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a float batch into microbatches and quantize each with its own
    statistics -> (int8 (M, mb, ...), int32 (M,)); with one microbatch this
    is exactly quantize_batch."""
    xs = x.reshape((n_microbatches, -1) + tuple(x.shape[1:]))
    qs = [quantize_batch(xm) for xm in xs]
    return torch.stack([d for d, _ in qs]), torch.stack([e for _, e in qs])


def homogeneous_blocks(n_blocks: int, channels: int, kernel=(1, 1), padding="VALID",
                       squeeze_logits: bool = True) -> Sequential:
    """The homogeneous NITI block stack (conv C->C + relu per block) the
    reference's NITI models repeat (`demo/mnistTrain.cpp:132-158`); with a
    1x1 kernel on 1x1 inputs it is an integer MLP. The GPipe demo's and
    tests' minimal pipeline model."""
    layers: List[NITILayer] = []
    for _ in range(n_blocks):
        layers += [NITIConv2D(channels, channels, tuple(kernel), (1, 1), padding), NITIRelu()]
    if squeeze_logits:
        layers.append(SqueezeLogits())
    return Sequential(layers)
