"""MnistInt8: the fake-quant QAT LeNet (port of
``mandheling_tpu/models/lenet_qat.py``; reference `MnistInt8`,
demo/mnistTrain.cpp:78-130): conv 5x5 (1->20), pool, conv 5x5 (20->50),
pool, fc 800->500 with relu6 and dropout 0.5, fc 500->10, each a
fake-quant conv (nn/qat.py), trained with float SGD by autograd.

Documented deviation, kept from the JAX package: the reference sets
`convOption.depthwise = true` on conv2 while giving it channel = {20, 50}
(demo/mnistTrain.cpp:86-92), a depthwise conv with ic != oc that MNN
resolves through its grouped-conv path; conv2 here is a dense 20->50 conv,
the straightforward reading of the layer's shape.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import qat

OBSERVER_KEYS = tuple(qat.qat_observer_init())


class _Observers(nn.Module):
    """One layer's observer state as 0-d buffers (they follow the model's
    device and float dtype)."""

    def __init__(self):
        super().__init__()
        for key, value in qat.qat_observer_init().items():
            self.register_buffer(key, value)

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return {key: getattr(self, key) for key in OBSERVER_KEYS}


def _relu6(v: torch.Tensor) -> torch.Tensor:
    # jnp.clip(v, 0, 6) is maximum then minimum, whose gradients split ties
    # in half; torch.maximum / minimum do the same (torch.clamp does not)
    return torch.minimum(torch.maximum(v, v.new_zeros(())), v.new_full((), 6.0))


def _pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 / 2 max pool of NHWC x; the gradient goes to the first maximum of
    each window in row-major order, as the JAX package's reduce_window."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def dropout(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Keep each unit with probability 0.5 and scale it by 1 / 0.5. The mask
    is drawn on the generator's device, so one seed gives one mask on every
    device (jax.random.bernoulli's stream cannot be reproduced)."""
    keep = torch.rand(x.shape, generator=generator, device=generator.device) < 0.5
    return torch.where(keep.to(x.device), x / 0.5, 0.0)


class LeNetQAT(nn.Module):
    """Parameters ``{"conv1": {"w", "b"}, "conv2", "ip1", "ip2"}`` (HWIO
    weights; the FCs as 1x1 convs), as the JAX dict, and one observer set a
    layer (``observers[name].in_min`` ...), which a training forward updates
    in place. ``utils/jax_params.py`` carries both across. Weights are zero
    until `reset_parameters` or a load."""

    SHAPES = {"conv1": (5, 5, 1, 20), "conv2": (5, 5, 20, 50),
              "ip1": (1, 1, 800, 500), "ip2": (1, 1, 500, 10)}

    def __init__(self, bits: int = 8):
        super().__init__()
        self.bits = bits
        self.layers = nn.ModuleDict({
            name: nn.ParameterDict({"w": nn.Parameter(torch.zeros(shape)),
                                    "b": nn.Parameter(torch.zeros(shape[3]))})
            for name, shape in self.SHAPES.items()})
        self.observers = nn.ModuleDict({name: _Observers() for name in self.SHAPES})

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> "LeNetQAT":
        """Glorot-normal weights and zero biases drawn in layer order from
        one generator (qat.qat_conv_init); observers back to 0."""
        with torch.no_grad():
            for name, shape in self.SHAPES.items():
                p = qat.qat_conv_init(shape, generator)
                for key in ("w", "b"):
                    self.layers[name][key].copy_(p[key])
            for obs in self.observers.values():
                for buf in obs.buffers():
                    buf.zero_()
        return self

    def _layer(self, name: str, x: torch.Tensor, training: bool, activation=None):
        obs = self.observers[name]
        y, new = qat.qat_conv_apply(dict(self.layers[name]), obs.as_dict(), x, bits=self.bits,
                                    activation=activation, training=training)
        if training:
            with torch.no_grad():
                for key in OBSERVER_KEYS:
                    getattr(obs, key).copy_(new[key])
        return y

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                training: bool = True) -> torch.Tensor:
        """x: (B, 28, 28, 1) float -> logits (B, 10). A training forward
        updates the observers and, given a `generator`, applies dropout
        after ip1; without one there is no dropout, as without a dropout key
        in the JAX package."""
        x = _pool(self._layer("conv1", x, training))
        x = _pool(self._layer("conv2", x, training))
        x = x.reshape(x.shape[0], 1, 1, -1)
        x = self._layer("ip1", x, training, activation=_relu6)
        if training and generator is not None:
            x = dropout(x, generator)
        x = self._layer("ip2", x, training)
        return x.reshape(x.shape[0], -1)
