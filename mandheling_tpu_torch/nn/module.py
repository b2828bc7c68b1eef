"""Explicit forward/backward layer protocol (port of
``mandheling_tpu/nn/module.py``).

The NITI backward is not autodiff: each grad op has its own requant (bw-7
for input grads, bw-2 for filter grads, a fixed 4 for the loss) and integer
tensors carry no autograd. So, as in the JAX package, each layer implements
`fwd` (returning residuals) and `bwd` (int8 output-diff -> int8 input-diff
and parameter grads), and `Sequential` composes them.

PyTorch idiom inside: layers are `nn.Module`s that hold their int8 weights
as buffers, where the JAX package threads a params pytree. The grads keep
the JAX structure: one entry per layer, {"w": QTensor} or ().

Where the JAX package threads a mesh `axis_name` through `fwd` and `bwd`,
the port threads a ``torch.distributed`` process group, `group`, with the
same default (None: one replica); every op below takes it as `group=`.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.qtensor import QTensor

Residuals = Any
Grads = Any


class NITILayer(nn.Module):
    """Base class: int8-in/int8-out layer with an explicit backward."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw the layer's weights (the JAX `init`); none by default."""

    def fwd(self, q: QTensor, group=None) -> Tuple[QTensor, Residuals]:
        raise NotImplementedError

    def bwd(self, res: Residuals, gy: torch.Tensor, group=None) -> Tuple[torch.Tensor, Grads]:
        raise NotImplementedError

    def bwd_params_only(self, res: Residuals, gy: torch.Tensor, group=None) -> Grads:
        """Parameter gradients without the input gradient (the model's first
        layer never needs one). Default: the full backward."""
        _, grads = self.bwd(res, gy, group)
        return grads


class Sequential(nn.Module):
    """Ordered layer list (the reference's Module/registerModel)."""

    def __init__(self, layers: Sequence[NITILayer]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> "Sequential":
        """Draw every layer's weights from one generator, in layer order."""
        for layer in self.layers:
            layer.reset_parameters(generator)
        return self

    def fwd(self, q: QTensor, group=None) -> Tuple[QTensor, List[Residuals]]:
        residuals = []
        for layer in self.layers:
            q, r = layer.fwd(q, group)
            residuals.append(r)
        return q, residuals

    def bwd(
        self, residuals: List[Residuals], gy: torch.Tensor, group=None,
        need_input_grad: bool = True,
    ) -> Tuple[Optional[torch.Tensor], List[Grads]]:
        """Reverse sweep. With need_input_grad=False the first layer's input
        gradient is skipped (None in its place): the training step never
        consumes it, and for a conv that drops a whole transposed conv."""
        grads: List[Grads] = [None] * len(self.layers)
        for i in range(len(self.layers) - 1, -1, -1):
            if i == 0 and not need_input_grad:
                grads[0] = self.layers[0].bwd_params_only(residuals[0], gy, group)
                return None, grads
            gy, grads[i] = self.layers[i].bwd(residuals[i], gy, group)
        return gy, grads
