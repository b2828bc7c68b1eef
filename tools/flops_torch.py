#!/usr/bin/env python3
"""The work of one train step of every configuration chip_smoke.py compiles
(phase 17) and of the fine-tuning demos' steps, at full width, from
`utils/profiler.cost_analysis`:

    python3 tools/flops_torch.py [--out PATH]

The NITI integer contractions count 2 flops a multiply-add from their
shapes (ops/flops.py), the float convs and matmuls as torch's
FlopCounterMode counts them; bytes are each contraction's operands and
result once and every other aten op's arguments and results. The steps run
on the meta device, on shapes only, so the full-width table takes seconds
on any host and is the same as on the CPU or the card (the tests and
chip_smoke.py hold both to it). Prints one line a configuration; `--out`
writes them as JSON too.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mandheling_tpu_torch.models import (NITI_LOGIT_CHANNELS, NUM_CLASSES,  # noqa: E402
                                         LeNetFP32, ResNet18FP32, inceptionv3_niti, lenet_niti,
                                         mobilenet_v2_niti, resnet18_niti)
from mandheling_tpu_torch.models.lenet_qat import LeNetQAT  # noqa: E402
from mandheling_tpu_torch.ops.conv import use_fused_conv_mode  # noqa: E402
from mandheling_tpu_torch.ops.depthwise import recipe_margins  # noqa: E402
from mandheling_tpu_torch.train import make_train_step  # noqa: E402
from mandheling_tpu_torch.train.optim import sgd_init  # noqa: E402
from mandheling_tpu_torch.train.qat_train import (make_distill_step,  # noqa: E402
                                                  make_qat_train_step, make_teacher_step)
from mandheling_tpu_torch.train.trainer import make_float_step  # noqa: E402
from mandheling_tpu_torch.train.transfer import (make_transfer_train_step,  # noqa: E402
                                                 transfer_from)
from mandheling_tpu_torch.utils.profiler import cost_analysis  # noqa: E402


def niti(build, batch, hwc, logits=NITI_LOGIT_CHANNELS, transfer=False):
    def make(device):
        model = build().to(device)
        step = (make_transfer_train_step if transfer else make_train_step)(model)
        return step, (torch.zeros((batch,) + hwc, device=device),
                      torch.zeros((batch, logits), dtype=torch.int32, device=device))
    return make


def mnv2_transfer():
    full = mobilenet_v2_niti(num_classes=NUM_CLASSES)
    return transfer_from(full, NUM_CLASSES)


def float_step(kind, batch=64):
    def make(device):
        x = torch.zeros((batch, 32, 32, 3) if kind == "resnet18_fp32" else (batch, 28, 28, 1),
                        device=device)
        oh = torch.zeros((batch, NUM_CLASSES), device=device)
        lr = torch.full((), 0.01, device=device)
        if kind == "resnet18_fp32":
            model = ResNet18FP32().to(device)
            params = list(model.parameters())
            return make_float_step(model, params, sgd_init(params), training=True), (x, oh, lr)
        if kind == "lenet_qat":
            return make_qat_train_step(LeNetQAT().to(device)), (x, oh, lr)
        teacher = LeNetFP32().to(device)
        if kind == "lenet_fp32_teacher":
            return make_teacher_step(teacher), (x, oh)
        return make_distill_step(LeNetQAT().to(device), teacher), (x, oh)
    return make


# name -> (fused mode, the step's maker, its settings)
CONFIGS = {
    "lenet b64": ("matmul_only", niti(lenet_niti, 64, (28, 28, 1)), None),
    "lenet b2048": ("matmul_only", niti(lenet_niti, 2048, (28, 28, 1)), None),
    "mnv2 b256": ("matmul_only", niti(mobilenet_v2_niti, 256, (32, 32, 3)), None),
    "mnv2 recipe b256": ("matmul_only", niti(functools.partial(
        mobilenet_v2_niti, dw_per_channel=True), 256, (32, 32, 3)), recipe_margins),
    "resnet18 b256 matmul_only": ("matmul_only", niti(resnet18_niti, 256, (32, 32, 3)), None),
    "resnet18 b256 all": ("all", niti(resnet18_niti, 256, (32, 32, 3)), None),
    "inceptionv3 b32 299 matmul_only": ("matmul_only", niti(functools.partial(
        inceptionv3_niti, num_classes=1000), 32, (299, 299, 3), 1000), None),
    "inceptionv3 b32 299 all": ("all", niti(functools.partial(
        inceptionv3_niti, num_classes=1000), 32, (299, 299, 3), 1000), None),
    "mnv2_transfer b256": ("matmul_only", niti(mnv2_transfer, 256, (32, 32, 3),
                                               transfer=True), None),
    "ResNet18FP32 b256 (train_fp32_bn's step)": ("matmul_only", float_step("resnet18_fp32", 256),
                                                 None),
    "MnistInt8Train LeNetQAT b64": ("matmul_only", float_step("lenet_qat"), None),
    "DistillTrainQuant teacher LeNetFP32 b64": ("matmul_only", float_step("lenet_fp32_teacher"),
                                                None),
    "DistillTrainQuant student LeNetQAT b64": ("matmul_only", float_step("distill_student"),
                                               None),
}


def flop_table():
    """{configuration: cost_analysis of one train step} on the meta device."""
    out = {}
    for name, (mode, make, settings) in CONFIGS.items():
        with use_fused_conv_mode(mode), (settings or contextlib.nullcontext)():
            step, step_args = make("meta")
            out[name] = cost_analysis(step, *step_args)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the table here as JSON")
    args = ap.parse_args()
    table = flop_table()
    for name, cost in table.items():
        print(f"{name}: {cost['flops']} flops ({cost['integer flops']} integer, "
              f"{cost['float flops']} float), {cost['contraction bytes']} contraction bytes",
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": "meta", "torch": torch.__version__, "steps": table}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
