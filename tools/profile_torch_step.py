#!/usr/bin/env python3
"""Where the time of one training step of the PyTorch/CUDA port goes, on the GPU.

    python3 tools/profile_torch_step.py [--model lenet|mnv2|mnv2_transfer|resnet18|resnet18_fp32|squeezenet|inceptionv3|lenet_qat|distill_student|lenet_fp32_teacher]
                                        [--mode matmul_only|all] [--recipe] [--batch 64 2048]
                                        [--graph] [--steps 20] [--out PATH]

For each batch size: the NITI train step of mandheling_tpu_torch with the
hand-written kernels (the step `train_niti` runs, host-to-device copies
included) for the NITI LeNet on synthetic MNIST (default batches 64 and
2048), the full-width NITI MobileNetV2 on synthetic CIFAR (default batch
256; `--recipe`: the r5 recipe, per-channel depthwise exponents and
filter-grad margins 0/0, as `MobilenetV2Train` trains it; `mnv2_transfer`:
the MobilenetV2Transfer step at full width, MobileNetV2 frozen up to its
global pool and a trained 1280 -> 12 head), the NITI
ResNet-18 on synthetic CIFAR (default batch 256; `resnet18_fp32`: its float
twin ResNet18FP32 through `train_fp32_bn`'s float step, TF32 off), or the zoo's NITI
SqueezeNet v1.0 (224x224, default batch 128) and Inception-v3 (299x299,
default batch 32) with 1000 classes on seeded integer pixels, or the
fine-tuning demos' float steps at batch 64 on synthetic MNIST
(train/qat_train.py, TF32 off): `lenet_qat` MnistInt8Train's LeNetQAT step
(normalised pixels, lr a 0-d tensor, dropout from a CUDA generator),
`distill_student` DistillTrainQuant's student step (LeNetQAT against a
frozen LeNetFP32 teacher, dropout) and `lenet_fp32_teacher` its teacher's
step, in fused mode `--mode`, timed without tracing, then traced with
torch.profiler. The
batches come from pinned host memory, as the trainer's (`to_device`). With
`--graph` the step is the compiled one (`jit_train_step`, or the transfer
and float steps through `compile_step`: one CUDA graph, captured at the
first step and replayed), which `train_niti` and the demos run; without it,
the eager step. Prints
wall ms/step (back to back, and synchronised after each step as the
trainer's StepTimer does), device busy ms/step (the union of the CUDA activity
intervals), the device's starved share, CUDA activities and top-level host ops
per step, and the device time by name (utils/device_trace.per_op_rows, the
rows of profiler.per_op_profile, from the same trace; the JSON adds each
name's category and flops) and host time by name. The starved share comes
from one untraced run recorded by `profiler.spans` (no tracer, so a
replayed graph is launched as it is untraced): one less the union of the
run's device intervals (each batch copy and each step, from the event
before its first device operation to the one after its last) over the
stretch from the first one's start to the last one's end, all on one
clock. It is the share of that stretch in which the card had none of the
run's work queued; gaps inside a step are not in it. With --out, the full
table is also written there as JSON. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mandheling_tpu_torch.data import (onehot_padded, synthetic_cifar, synthetic_mnist,  # noqa: E402
                                       to_device)
from mandheling_tpu_torch.models import (NITI_LOGIT_CHANNELS, NUM_CLASSES,  # noqa: E402
                                         LeNetFP32, ResNet18FP32, inceptionv3_niti, lenet_niti,
                                         mobilenet_v2_niti, resnet18_niti, squeezenet_niti)
from mandheling_tpu_torch.models.lenet_qat import LeNetQAT  # noqa: E402
from mandheling_tpu_torch.ops import flops  # noqa: E402
from mandheling_tpu_torch.ops.conv import use_fused_conv_mode  # noqa: E402
from mandheling_tpu_torch.ops.depthwise import recipe_margins  # noqa: E402
from mandheling_tpu_torch.ops.kernels import build  # noqa: E402
from mandheling_tpu_torch.train import make_train_step  # noqa: E402
from mandheling_tpu_torch.train.optim import sgd_init  # noqa: E402
from mandheling_tpu_torch.train.qat_train import (make_distill_step,  # noqa: E402
                                                  make_qat_train_step, make_teacher_step)
from mandheling_tpu_torch.train.step_graph import compile_step  # noqa: E402
from mandheling_tpu_torch.train.trainer import (_normalize, full_float32,  # noqa: E402
                                                make_float_step)
from mandheling_tpu_torch.train.transfer import make_transfer_train_step, transfer_from  # noqa: E402
from mandheling_tpu_torch.utils import device_trace, profiler  # noqa: E402

def imagenet_like(side: int):
    """Seeded integer pixels at (side, side, 3) and labels of 1000 classes."""
    def data(n: int, seed: int):
        rng = np.random.default_rng(seed)
        return rng.integers(0, 256, (n, side, side, 3), dtype=np.uint8), rng.integers(0, 1000, n)
    return data


def mnv2_transfer():
    """MobilenetV2Transfer at full width, the features drawn from seed 0
    (reset_parameters then draws the head)."""
    full = mobilenet_v2_niti().reset_parameters(torch.Generator().manual_seed(0))
    return transfer_from(full, NUM_CLASSES)


# model -> (constructor, synthetic data, default batches, classes, logit channels)
MODELS = {
    "lenet": (lenet_niti, synthetic_mnist, [64, 2048], NUM_CLASSES, NITI_LOGIT_CHANNELS),
    "mnv2": (mobilenet_v2_niti, synthetic_cifar, [256], NUM_CLASSES, NITI_LOGIT_CHANNELS),
    "mnv2_transfer": (mnv2_transfer, synthetic_cifar, [256], NUM_CLASSES, NITI_LOGIT_CHANNELS),
    "resnet18": (resnet18_niti, synthetic_cifar, [256], NUM_CLASSES, NITI_LOGIT_CHANNELS),
    "resnet18_fp32": (ResNet18FP32, synthetic_cifar, [256], NUM_CLASSES, NUM_CLASSES),
    "squeezenet": (functools.partial(squeezenet_niti, num_classes=1000), imagenet_like(224),
                   [128], 1000, 1000),
    "inceptionv3": (functools.partial(inceptionv3_niti, num_classes=1000), imagenet_like(299),
                    [32], 1000, 1000),
    "lenet_qat": (LeNetQAT, synthetic_mnist, [64], NUM_CLASSES, NUM_CLASSES),
    "distill_student": (LeNetQAT, synthetic_mnist, [64], NUM_CLASSES, NUM_CLASSES),
    "lenet_fp32_teacher": (LeNetFP32, synthetic_mnist, [64], NUM_CLASSES, NUM_CLASSES),
}
FLOAT_STEPS = ("resnet18_fp32", "lenet_qat", "distill_student", "lenet_fp32_teacher")


def float_step(model_name, model, device):
    """(step, its last argument or None, whether it takes normalised pixels)
    of a float model: train_fp32_bn's float step for the twin, the demos'
    steps for the fine-tuning models (their dropout from a CUDA generator)."""
    gen = torch.Generator(device=device).manual_seed(1)
    lr = torch.full((), 0.01, device=device)
    if model_name == "resnet18_fp32":  # the float loop's step, its lr a 0-d tensor
        params = list(model.parameters())
        return make_float_step(model, params, sgd_init(params), training=True), lr, True
    if model_name == "lenet_qat":
        return make_qat_train_step(model, gen), lr, True
    if model_name == "lenet_fp32_teacher":
        return make_teacher_step(model), None, False
    teacher = LeNetFP32().reset_parameters(torch.Generator().manual_seed(2)).to(device)
    return make_distill_step(model, teacher, gen), None, False


def union_us(intervals):
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profile_batch(model_name: str, batch: int, steps: int, recipe: bool = False,
                  graph: bool = False):
    build_model, data, _, classes, logits = MODELS[model_name]
    if recipe:
        build_model = functools.partial(build_model, dw_per_channel=True)
    model = build_model().reset_parameters(torch.Generator().manual_seed(0)).to("cuda")
    device = torch.device("cuda")
    x, y = data(batch * steps, seed=5)
    xs = [x[i * batch:(i + 1) * batch].astype(np.float32) for i in range(steps)]
    ohs = [onehot_padded(y[i * batch:(i + 1) * batch], classes, logits) for i in range(steps)]
    extra = ()
    if model_name in FLOAT_STEPS:
        step, last, normalised = float_step(model_name, model, device)
        xs = [_normalize(x) if normalised else x for x in xs]
        ohs = [oh.astype(np.float32) for oh in ohs]
        extra = () if last is None else (last,)
    else:
        step = (make_transfer_train_step if model_name == "mnv2_transfer"
                else make_train_step)(model)
    if graph:
        step = compile_step(step, device)

    def run(step_times=None):
        for xb, oh in zip(xs, ohs):
            t0 = time.perf_counter()
            args = to_device(xb, device), to_device(oh, device)
            # an eager step has no span of its own (the compiled one's is step.call)
            with profiler.span("tool.step") as sp, sp.device():
                step(*args, *extra)
            if step_times is not None:  # as train_niti's StepTimer times a step
                torch.cuda.synchronize()
                step_times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()

    first = []
    run(first)  # warm-up: kernel libraries loaded, allocator filled
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3 / steps)
    synced = []
    run(synced)
    with profiler.spans(device) as rec:
        run()
    starved = None
    if rec.intervals:
        marked = [(i.start_ns, i.end_ns) for i in rec.intervals]
        stretch = max(e for _, e in marked) - min(s for s, _ in marked)
        starved = 1 - union_us(marked) / stretch
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        run()  # the first trace of a process also pays the tracer's start-up
    t0 = time.perf_counter()
    with flops.recording() as notes, \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    traced_ms = (time.perf_counter() - t0) * 1e3 / steps

    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    rows = device_trace.per_op_rows(device_trace.device_events(events, notes, True))
    top_host = [e for e in events if e.device_type == DeviceType.CPU and e.cpu_parent is None]
    by_host = collections.defaultdict(lambda: [0, 0.0])
    for e in top_host:
        by_host[e.name][0] += 1
        by_host[e.name][1] += e.time_range.elapsed_us()
    busy_ms = union_us([(e.time_range.start, e.time_range.end) for e in dev]) / 1e3 / steps
    wall_ms = float(np.median(walls))
    res = {
        "model": model_name, "recipe": recipe, "graph": graph, "batch": batch, "steps": steps,
        "wall_ms_per_step": wall_ms,
        "wall_ms_per_step_runs": walls, "traced_ms_per_step": traced_ms,
        "synced_step_ms_median": float(np.median(synced)),
        "synced_step_ms_quartiles": [float(np.percentile(synced, 25)),
                                     float(np.percentile(synced, 75))],
        "first_run_step_ms": first,
        "device_busy_ms_per_step": busy_ms if dev else None,
        # from the device marks of one untraced run (profiler.spans)
        "device_starved_share": starved,
        "clock_drift_ns": rec.drift_ns,
        "cuda_activities_per_step": len(dev) / steps,
        "top_level_host_ops_per_step": len(top_host) / steps,
        "device_by_name_us_per_step": [(r["name"], r["occurrences"] / steps,
                                        r["total_us"] / steps) for r in rows[:15]],
        "device_by_name_category_flops_per_step": [
            (r["name"], r["category"], r["flops"] / steps) for r in rows[:15]],
        "device_by_category_us_per_step": [
            (c["category"], c["occurrences"] / steps, c["total_us"] / steps)
            for c in device_trace.by_category(rows)],
        "host_by_name_us_per_step": sorted(
            ((n, c / steps, t / steps) for n, (c, t) in by_host.items()),
            key=lambda r: -r[2])[:15],
    }
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="lenet")
    ap.add_argument("--mode", choices=["matmul_only", "all"], default="matmul_only",
                    help="fused conv mode")
    ap.add_argument("--batch", type=int, nargs="+",
                    help="batch sizes (default: 64 2048 for lenet, 256 for mnv2, mnv2_transfer, "
                         "resnet18 and resnet18_fp32, "
                         "128 for squeezenet, 32 for inceptionv3, 64 for lenet_qat, "
                         "distill_student and lenet_fp32_teacher)")
    ap.add_argument("--recipe", action="store_true",
                    help="mnv2 only: per-channel depthwise exponents and margins 0/0")
    ap.add_argument("--graph", action="store_true",
                    help="profile the compiled step (a CUDA graph replayed), as train_niti runs it")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", help="write the full table here as JSON")
    args = ap.parse_args()
    if args.recipe and args.model != "mnv2":
        ap.error("--recipe is the MobileNetV2 recipe: use it with --model mnv2")
    if not torch.cuda.is_available():
        print("profile_torch_step: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}; model {args.model}"
          f"{' (r5 recipe)' if args.recipe else ''}, fused mode {args.mode}, "
          f"{'compiled (CUDA graph)' if args.graph else 'eager'} step", flush=True)
    build.build_all()
    results = []
    for batch in args.batch or MODELS[args.model][2]:
        margins = recipe_margins() if args.recipe else contextlib.nullcontext()
        fp32 = full_float32() if args.model in FLOAT_STEPS else contextlib.nullcontext()
        with use_fused_conv_mode(args.mode), margins, fp32:
            r = profile_batch(args.model, batch, args.steps, args.recipe, args.graph)
        results.append(r)
        busy, starved = r["device_busy_ms_per_step"], r["device_starved_share"]
        print(f"batch {batch}: wall {r['wall_ms_per_step']:.3f} ms/step "
              f"({batch / r['wall_ms_per_step'] * 1e3:.0f} samples/s), traced "
              f"{r['traced_ms_per_step']:.3f} ms/step, device busy "
              f"{'not measured' if busy is None else '%.3f ms/step' % busy}, starved share "
              f"{'not measured' if starved is None else '%.4f' % starved}, "
              f"{r['cuda_activities_per_step']:.0f} CUDA activities and "
              f"{r['top_level_host_ops_per_step']:.0f} top-level host ops per step", flush=True)
        print(f"  synchronised after each step (as train_niti times it): median "
              f"{r['synced_step_ms_median']:.3f} ms, quartiles "
              f"{r['synced_step_ms_quartiles'][0]:.3f}-{r['synced_step_ms_quartiles'][1]:.3f} ms; "
              f"first steps of a fresh model: "
              f"{', '.join('%.1f' % t for t in r['first_run_step_ms'][:4])} ms", flush=True)
        for n, c, t in r["device_by_name_us_per_step"][:10]:
            print(f"  device {t:9.1f} us/step {c:5.1f}x  {n[:90]}")
        for n, c, t in r["host_by_name_us_per_step"][:10]:
            print(f"  host   {t:9.1f} us/step {c:5.1f}x  {n[:90]}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "torch": torch.__version__, "mode": args.mode,
                       "recipe": args.recipe, "graph": args.graph,
                       "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
