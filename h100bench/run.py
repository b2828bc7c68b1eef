#!/usr/bin/env python3
"""The benchmark of mandheling_tpu_torch: NITI training on one NVIDIA GPU.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run draws the cell's training set and the model's weights from the seed
on the card, builds the configuration's model with the program
(`mandheling_tpu_torch.models`), compiles its step with
`train.train_step.jit_train_step`, and feeds it as the port's trainer does
(`data.loader.DataLoader(...).epoch()`, `onehot_padded`, `to_device`).
Set-up ends after the step's first three calls (the first captures the
CUDA graph); the program's losses and weights after steps 1 and 3 are
kept. The benchmark's warm-up, `WARMUP_S` seconds of the cell's own steps,
runs straight into the window, which issues steps for `--seconds`, with
no synchronise after a step (loop.py), and ends in one; its length is the
device's, from the warm-up's last step to the window's last. With
`--trace 1` a stretch of steady steps after the window runs under
torch.profiler and the cell's per-layer metrics are read from it
(metrics/); otherwise the end-to-end metrics. Last, the program is freed
and the plain reference (reference.py) runs the same three steps from the
same weights on the same batches; judge.py compares them, and the run
prints each number compared beside its limit, on standard error and in
the result, the last line of standard output.

Exits 2 without a CUDA device or with fewer than the cell's chips, and 3
if a JAX module was loaded; both print no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100bench import judge, manifest, reference, trace, trainset, weights, work  # noqa: E402
from h100bench.loop import Loop, Marks, endless  # noqa: E402

FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "mandheling_tpu"))
SETUP_STEPS = 3
# Seconds of the cell's own steps after set-up that run straight into the
# window: the H100 runs a step of thousands of small kernels about 0.35 us a
# kernel slower for a while after it starts to work (0-21 s; PERF.md), and a
# synchronise before the window can bring that back.
WARMUP_S = 20.0
# the kernel and JIT caches of a run, at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda"}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


@dataclass
class RunInfo:
    """What a per-layer metric's reader reads."""

    window_steps: int
    window_s: float
    trainer_s: List[float]
    step_s: List[float]
    step_ops: int
    peak_ops: Optional[float]
    bound_s: Optional[float]
    stretch: Optional[trace.Stretch] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _port_layers(model) -> list:
    return [m for m in model.modules()
            if isinstance(getattr(m, "w", None), torch.Tensor) and hasattr(m, "w_exp")]


def _give(model, leaves) -> None:
    """Copy the benchmark's (data, exponent) leaves into the program's
    weighted layers, in module order, shape by shape."""
    layers = _port_layers(model)
    if len(layers) != len(leaves):
        raise ValueError(f"the program's model has {len(layers)} weighted layers, "
                         f"the reference {len(leaves)}")
    with torch.no_grad():
        for layer, (w, e) in zip(layers, leaves):
            if layer.w.shape != w.shape or layer.w_exp.shape != e.shape:
                raise ValueError(f"weight {tuple(layer.w.shape)}/{tuple(layer.w_exp.shape)} "
                                 f"against {tuple(w.shape)}/{tuple(e.shape)}")
            layer.w.copy_(w)
            layer.w_exp.copy_(e)


def _snapshot(layers) -> list:
    return [(layer.w.clone(), layer.w_exp.clone()) for layer in layers]


def _peaks(kind: str) -> Optional[dict]:
    return manifest.load_json(manifest.HERE / "peaks.json").get(kind)


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile, linear between the closest ranks."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def traced_stretch(loop: Loop, steps: int, device: torch.device) -> trace.Stretch:
    """`steps` steady steps under torch.profiler, from an idle device to an
    idle device, each call inside its span; one traced step before pays the
    tracer's start-up."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    warnings.filterwarnings("ignore", message="Profiler clears events")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts):
        loop.run(lambda n: n >= 1)
        _sync(device)
    with profile(activities=acts) as prof:
        loop.run(lambda n: n >= steps, spans=True)
        _sync(device)
    return trace.from_profiler(prof, steps)


def reference_ctx(c: dict, p: reference.Precision = reference.INT8) -> reference.Ctx:
    """The reference's arithmetic for cell `c`: precision `p` and the
    configuration's margins (the program's defaults, 2 and 2, where it
    states none)."""
    margins = c["config"].get("margins") or {"dense": 2, "dw": 2}
    return reference.Ctx(p, margins["dense"], margins["dw"])


def reference_steps(c: dict, start, fed, device: torch.device, ctx=None,
                    step=reference.train_step):
    """The reference's first three steps from `start` on the batches `fed`
    -> (losses, weights after step 1, weights after step 3)."""
    cfg = c["config"]
    model = reference.build(cfg["reference"]["family"], **cfg["reference"]["kwargs"])
    reference.load(model, start)
    ctx = ctx or reference_ctx(c)
    losses, after = [], []
    for bx, oh in fed:
        losses.append(step(model, torch.from_numpy(bx).to(device),
                           torch.from_numpy(oh).to(device), ctx))
        after.append([(w.clone(), e.clone()) for w, e in reference.weights(model)])
    return [float(x) for x in losses], after[0], after[-1]


def draw(c: dict, seed: int, device: torch.device):
    """The cell's training set and the model's weights from `seed`, on
    `device`: (images, labels, the reference's model, its weight leaves)."""
    cfg = c["config"]
    gen = torch.Generator(device=device).manual_seed(seed)
    images, labels = trainset.images(c["traffic"], gen)
    ref_model = reference.build(cfg["reference"]["family"], **cfg["reference"]["kwargs"])
    return images, labels, ref_model, weights.make(ref_model, gen)


def run_cell(bench: dict, c: dict, name: str, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float = T_START, log=print) -> dict:
    """One run of cell `name` (manifest.cell's dict `c`) on `device` -> the
    result object. `log` takes the lines for standard error."""
    from mandheling_tpu_torch import models as port_models
    from mandheling_tpu_torch.data.loader import DataLoader, onehot_padded, to_device
    from mandheling_tpu_torch.ops.depthwise import recipe_margins
    from mandheling_tpu_torch.ops.kernels import build
    from mandheling_tpu_torch.train.train_step import jit_train_step

    cfg, traffic, own = c["config"], c["traffic"], c["cell"]
    batch = traffic["batch"]
    if device.type == "cuda":
        build.build_all()
    images, labels, ref_model, start = draw(c, seed, device)
    if device.type == "cuda":  # the peak from here on is the program's, not the data set's draw
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    model = getattr(port_models, cfg["program"]["builder"])(**cfg["program"]["kwargs"]).to(device)
    _give(model, start)
    layers = _port_layers(model)
    margins = cfg.get("margins")
    fed = []

    def feed(b):
        bx, by = b
        oh = onehot_padded(by, cfg["classes"], cfg["logit_width"])
        if len(fed) < SETUP_STEPS:
            fed.append((bx.copy(), oh.copy()))
        return to_device(bx, device), to_device(oh, device)

    with recipe_margins(margins["dense"], margins["dw"]) if margins else contextlib.nullcontext():
        step = jit_train_step(model)
        dl = DataLoader(images, labels, batch, seed=seed)
        batches = endless(dl.epoch)
        loop = Loop(step, batches, feed, device)
        loop.run(lambda n: n >= 1)
        prog1 = _snapshot(layers)
        loop.run(lambda n: n >= SETUP_STEPS - 1)
        prog3 = _snapshot(layers)
        _sync(device)
        setup_s = time.perf_counter() - t_start
        prog_losses = [float(x) for x in loop.losses]
        marks = Marks(device)
        t_warm = time.perf_counter()
        loop.run(lambda n: n >= 1 and time.perf_counter() - t_warm >= WARMUP_S, marks=marks)
        loop.clear()

        first = len(marks.events) - 1  # the window starts as the device ends the warm-up
        t0 = time.perf_counter()
        steps = loop.run(lambda n: time.perf_counter() - t0 >= seconds, marks=marks)
        _sync(device)
        host_s = time.perf_counter() - t0
        window_s = marks.seconds(first)
        intervals = marks.intervals_ms(first)
        losses = torch.stack(loop.losses) if loop.losses else torch.zeros(0)
        failed = int((~torch.isfinite(losses)).sum())
        trainer_s, step_s = list(loop.trainer_s), list(loop.step_s)
        stretch = traced_stretch(loop, own["trace_steps"], device) if traced else None
    batches.close()
    if stretch is not None:
        log(f"trace: {own['trace_steps']} steps, {len(stretch.activities)} device activities, "
            f"{len(stretch.spans)} host spans; left out {stretch.left_out}")

    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if cuda else 0}
    p95 = percentile(intervals, 95) if intervals else float("nan")
    log(f"window: {steps} steps of batch {batch} in {window_s:.6f} s of the device "
        f"({host_s:.6f} s of the host's issue); {len(intervals)} step "
        f"intervals, p95 {p95:.6f} ms with {sum(v > p95 for v in intervals)} beyond it; "
        f"set-up {setup_s:.6f} s; {failed} non-finite losses")

    del step, loop, model, layers, dl, batches, losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref_losses, ref1, ref3 = reference_steps(c, start, fed, device)
    _sync(device)
    log(f"reference: {SETUP_STEPS} steps in {time.perf_counter() - t_ref:.3f} s")
    numbers = judge.readings(prog_losses, ref_losses, start, prog1, ref1, prog3, ref3)
    limits = own["limits"]
    correct = judge.verdict(numbers, limits)

    shape = (batch, *cfg["input_shape"])
    peaks = _peaks(kind)
    info = RunInfo(window_steps=steps, window_s=window_s, trainer_s=trainer_s, step_s=step_s,
                   step_ops=work.step_ops(ref_model, shape),
                   peak_ops=peaks["int8_ops_per_s"] if peaks else None,
                   bound_s=(work.bound_seconds(ref_model, shape, peaks["int8_ops_per_s"],
                                               peaks["hbm_bytes_per_s"]) if peaks else None),
                   stretch=stretch)
    metrics = {}
    if traced:
        for m in manifest.metrics_of(bench, "per_layer", name):
            value = manifest.reader(m["name"])(info)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = trace.busy_us(stretch) / 1e6
        dev["window_s"] = trace.span_us(stretch) / 1e6
    else:
        e2e = {"train_samples_per_s": steps * batch / window_s, "step_ms_p95": p95,
               "setup_s": setup_s}
        for m in manifest.metrics_of(bench, "end_to_end", name):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    if cuda:
        dev["power_limit"] = _power_limit()
    result = {"correct": correct, "attempted": steps, "failed": failed, "metrics": metrics,
              "device": dev}
    if traced:
        bd = trace.breakdown(stretch)
        if bd:
            result["breakdown"] = bd
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in judge.NUMBERS}
    for k in judge.NUMBERS:
        log(f"check {k} {numbers[k]!r} limit {limits[k]!r}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "_bench_cache" / sub)
    bench = manifest.benchmark()
    c = manifest.cell(bench, args.workload)
    chips = c["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100bench: cell {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    lines: List[str] = []
    result = run_cell(bench, c, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), log=lines.append)
    found = forbidden_modules()
    if found:
        print(f"h100bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
