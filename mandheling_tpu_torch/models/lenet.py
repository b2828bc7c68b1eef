"""LeNet-family MNIST models (port of ``mandheling_tpu/models/lenet.py``):

- :func:`lenet_niti`: the NITI int8 LeNet, channels 1->20->52, FC
  832->500->12, as the reference `NITIInt8` module
  (demo/mnistTrain.cpp:132-188);
- :class:`LeNetFP32`: the float32 `MnistV2` baseline (mnistTrain.cpp:28-77;
  channels 1->20->50, FC 800->500->10, relu6 on ip1), trained by autograd.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Flatten, NITIConv2D, NITIMaxPool, NITIRelu, SqueezeLogits
from ..nn.module import Sequential


def lenet_niti() -> Sequential:
    """conv5x5(1->20) relu pool / conv5x5(20->52) relu pool / fc(832->500)
    relu / fc(500->12). Logits have 12 channels; targets are one-hot over
    the first 10. Weights are zero until `reset_parameters` or a load."""
    return Sequential(
        [
            NITIConv2D(1, 20, (5, 5)),
            NITIRelu(),
            NITIMaxPool((2, 2), (2, 2)),
            NITIConv2D(20, 52, (5, 5)),
            NITIRelu(),
            NITIMaxPool((2, 2), (2, 2)),
            Flatten(),
            NITIConv2D(832, 500, (1, 1)),
            NITIRelu(),
            NITIConv2D(500, 12, (1, 1)),
            SqueezeLogits(),
        ]
    )


NUM_CLASSES = 10
NITI_LOGIT_CHANNELS = 12


class LeNetFP32(nn.Module):
    """The fp32 MnistV2 baseline in the JAX package's layout: NHWC inputs,
    HWIO weights, the FCs as 1x1 convs over the NHWC-flattened features.
    Its parameters are ``{"conv1": {"w", "b"}, "conv2": ..., "ip1": ...,
    "ip2": ...}``, as the JAX dict (:meth:`load_params`, :meth:`params_numpy`
    carry them across). Weights are zero until `reset_parameters` or a load."""

    SHAPES = {"conv1": (5, 5, 1, 20), "conv2": (5, 5, 20, 50),
              "ip1": (1, 1, 800, 500), "ip2": (1, 1, 500, 10)}

    def __init__(self):
        super().__init__()
        self.layers = nn.ModuleDict({
            name: nn.ParameterDict({"w": nn.Parameter(torch.zeros(shape)),
                                    "b": nn.Parameter(torch.zeros(shape[3]))})
            for name, shape in self.SHAPES.items()})

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> "LeNetFP32":
        """Glorot-normal weights (std sqrt(2 / (fan_in + fan_out))), zero
        biases, as the JAX init draws them (from torch's generator)."""
        with torch.no_grad():
            for name, (kh, kw, i, o) in self.SHAPES.items():
                std = math.sqrt(2.0 / (kh * kw * i + kh * kw * o))
                w = torch.randn((kh, kw, i, o), generator=generator) * std
                self.layers[name]["w"].copy_(w)
                self.layers[name]["b"].zero_()
        return self

    def load_params(self, params: Dict) -> "LeNetFP32":
        """Copy a JAX-layout float dict into the parameters."""
        with torch.no_grad():
            for name in self.SHAPES:
                for key in ("w", "b"):
                    dst = self.layers[name][key]
                    src = torch.from_numpy(np.array(params[name][key], dtype=np.float32))
                    if tuple(src.shape) != tuple(dst.shape):
                        raise ValueError(f"{name}.{key}: shape {tuple(src.shape)} != "
                                         f"{tuple(dst.shape)}")
                    dst.copy_(src)
        return self

    def params_numpy(self) -> Dict:
        return {name: {key: self.layers[name][key].detach().cpu().numpy() for key in ("w", "b")}
                for name in self.SHAPES}

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        p = self.layers[name]
        y = F.conv2d(x.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1))
        return y.permute(0, 2, 3, 1) + p["b"]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 28, 28, 1) float32 -> logits (B, 10)."""
        def pool(t):
            return F.max_pool2d(t.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)

        x = pool(self._conv("conv1", x))
        x = pool(self._conv("conv2", x))
        x = x.reshape(x.shape[0], -1)  # NHWC order, as the JAX reshape
        ip1, ip2 = self.layers["ip1"], self.layers["ip2"]
        x = torch.clamp(x @ ip1["w"].reshape(800, 500) + ip1["b"], 0.0, 6.0)  # relu6
        return x @ ip2["w"].reshape(500, 10) + ip2["b"]
