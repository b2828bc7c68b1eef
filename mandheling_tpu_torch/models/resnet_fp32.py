"""Float ResNet-18 with batch norm, CIFAR geometry (port of
``mandheling_tpu/models/resnet_fp32.py``): the fp32 twin of
``resnet18_niti``, trained by ``train_fp32_bn``. The same stem and stage
plan as the NITI model (3x3 stem, stages [(64, 1), (128, 2), (256, 2),
(512, 2)] x 2 blocks), conv + BN + relu blocks, identity or projected skips.

Its params tree is the JAX package's: ``[{"w", "bn"}, {"w1", "bn1", "w2",
"bn2"[, "wp", "bnp"]} x 8, {"w", "b"}]``. The JAX init draws a block's
projection ``wp`` with the key of its ``w2``; torch cannot reproduce
jax.random (params are carried across), so each weight here is a draw of
its own.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .mobilenet_fp32 import FP32Tree, _bn_apply, _bn_init, _conv, _conv_init

PLAN = [(64, 1), (128, 2), (256, 2), (512, 2)]


class ResNet18FP32(FP32Tree):
    def __init__(self, num_classes: int = 10):
        self.num_classes = num_classes
        super().__init__()

    @staticmethod
    def _blocks():
        blocks, in_c = [], 64
        for out_c, stride in PLAN:
            for i in range(2):
                blocks.append((in_c, out_c, stride if i == 0 else 1))
                in_c = out_c
        return blocks

    def _init_tree(self, generator: Optional[torch.Generator]) -> List:
        params = [{"w": _conv_init((3, 3, 3, 64), generator), "bn": _bn_init(64)}]
        for in_c, out_c, s in self._blocks():
            p = {"w1": _conv_init((3, 3, in_c, out_c), generator), "bn1": _bn_init(out_c),
                 "w2": _conv_init((3, 3, out_c, out_c), generator), "bn2": _bn_init(out_c)}
            if s != 1 or in_c != out_c:
                p["wp"] = _conv_init((1, 1, in_c, out_c), generator)
                p["bnp"] = _bn_init(out_c)
            params.append(p)
        params.append({"w": _conv_init((1, 1, 512, self.num_classes), generator),
                       "b": torch.zeros(self.num_classes)})
        return params

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        """x: (B, 32, 32, 3) float32 -> logits (B, num_classes). A training
        forward normalises by the batch and updates the running stats."""
        stem = self.params[0]
        x = torch.relu(_bn_apply(stem.bn, _conv(x, stem.w), training))
        for p, (_, _, s) in zip(self.params[1:-1], self._blocks()):
            y = torch.relu(_bn_apply(p.bn1, _conv(x, p.w1, s), training))
            y = _bn_apply(p.bn2, _conv(y, p.w2), training)
            skip = _bn_apply(p.bnp, _conv(x, p.wp, s), training) if "wp" in p.keys else x
            x = torch.relu(y + skip)
        x = x.mean(dim=(1, 2), keepdim=True)
        head = self.params[-1]
        x = _conv(x, head.w) + head.b
        return x.reshape(x.shape[0], -1)
