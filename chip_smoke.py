#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mandheling_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package. Phases, each of which
raises on failure (the script then exits non-zero and prints no result):

1. the card's name and power limit (nvidia-smi);
2. build every kernel from csrc/ with nvcc for sm_90a, one process per
   source, all started together;
3. each kernel against its plain PyTorch version on the card, byte for byte,
   at the shapes the training step gives it: K1 (matmul_int8) at the 11
   contractions of a batch-64 LeNet step, K2 (fused_matmul_max / _requant)
   at the fc2 input grad of batch 2048 and at a shape of the JAX package's
   tiled branch (K > 512); kernel, plain and library times;
4. the main path at batch 64: `train_niti` on the card with the kernels,
   launch counts reset just before and read just after; then the same steps
   from the same params with the plain versions on the card and on the CPU.
   Params must be byte-identical across the three, losses within 1e-5;
5. the same at batch 2048, where the fc2 input grad takes the fused route
   (K2); then steps/s of the kernel path at both batches;
6. one JSON line listing every kernel, then the result line.

The last line of standard output is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from mandheling_tpu_torch.data import synthetic_mnist
from mandheling_tpu_torch.models import NITI_LOGIT_CHANNELS, NUM_CLASSES, lenet_niti
from mandheling_tpu_torch.ops import numerics
from mandheling_tpu_torch.ops import kernels
from mandheling_tpu_torch.ops.kernels import build, fused_matmul_int8, matmul_int8
from mandheling_tpu_torch.data.loader import onehot_padded
from mandheling_tpu_torch.train import make_eval_step, make_train_step
from mandheling_tpu_torch.train.trainer import train_niti
from mandheling_tpu_torch.utils.jax_params import export_jax_params

# (what, M, K, N, A transposed) of every int8 contraction of a LeNet train
# step at batch 64. The filter grads multiply im2col(x)^T, a strided view.
K1_SHAPES = [
    ("conv1 fwd", 36864, 25, 20, False),
    ("conv2 fwd", 4096, 500, 52, False),
    ("fc1 fwd", 64, 832, 500, False),
    ("fc2 fwd", 64, 500, 12, False),
    ("fc2 igrad", 64, 12, 500, False),
    ("fc2 fgrad", 500, 64, 12, True),
    ("fc1 igrad", 64, 500, 832, False),
    ("fc1 fgrad", 832, 64, 500, True),
    ("conv2 igrad", 9216, 1300, 20, False),
    ("conv2 fgrad", 500, 4096, 52, True),
    ("conv1 fgrad", 25, 36864, 20, True),
]
K2_SHAPE = ("fc2 igrad b2048", 2048, 12, 500)
# K > 512: a shape of the JAX package's tiled branch (matmul_max_pallas /
# matmul_requant_pallas past `_small_max`), which `supports` keeps off the
# main path; the one CUDA design serves both branches, timed at each.
K2_TILED_SHAPE = ("tiled branch, fc1 fwd widths b2048", 2048, 832, 500)
K1_PER_TRAIN_STEP, K1_PER_EVAL_STEP = 11, 4


def peak_rates(name: str):
    """(int8 dense ops/s, device memory bytes/s) from NVIDIA's data sheets."""
    if "PCIe" in name:
        return 756e12, 2.0e12, "H100 PCIe data sheet"
    if "NVL" in name:
        return 1671e12, 3.9e12, "H100 NVL data sheet"
    return 1979e12, 3.35e12, "H100 SXM data sheet"


def bound(ops: float, nbytes: float, rates):
    """(least time in ms, what bounds it) for `ops` int8 operations that
    must move `nbytes` of device memory."""
    t_ops, t_bytes = ops / rates[0] * 1e3, nbytes / rates[1] * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def time_ms(fn, launches: int = 50, rounds: int = 5) -> float:
    """Median over `rounds` of the device time per call of `fn`, for calls
    issued back to back: a sleep kernel holds the stream while the host
    queues them, so host overhead between calls does not reach the clock."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / launches)
    return statistics.median(per_call)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def rand_int8(shape, gen):
    return torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8, device="cuda")


def int_mm_accepts(m: int, k: int, n: int) -> bool:
    """torch._int_mm's shape rule on CUDA: M > 16, K and N multiples of 8."""
    return m > 16 and k > 0 and k % 8 == 0 and n % 8 == 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def check_k1(rates, gen):
    rows = []
    for what, m, k, n, trans in K1_SHAPES:
        a = rand_int8((k, m), gen).t() if trans else rand_int8((m, k), gen)
        b = rand_int8((k, n), gen)
        got = matmul_int8.matmul_acc_cuda(a, b)
        err = max_abs_err(got, matmul_int8.matmul_acc_plain(a, b))
        if err:
            raise AssertionError(f"K1 {what} ({m}x{k}x{n}) differs from plain by {err}")
        ms = time_ms(lambda: matmul_int8.matmul_acc_cuda(a, b))
        plain_ms = time_ms(lambda: matmul_int8.matmul_acc_plain(a, b))
        # the yardstick only (the port never calls torch._int_mm): timed
        # where its documented shape rule takes the operands
        lib_ms = time_ms(lambda: torch._int_mm(a, b)) if int_mm_accepts(m, k, n) else None
        ops, nbytes = 2.0 * m * n * k, m * k + k * n + 4.0 * m * n
        b_ms, b_by = bound(ops, nbytes, rates)
        rows.append(dict(what=what, m=m, k=k, n=n, a_transposed=trans, max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, library_ms=lib_ms, ops=ops, bytes=nbytes,
                         bound_ms=b_ms, bound_by=b_by))
        print(f"  K1 {what:12s} ({m:5d},{k:5d})x({k:5d},{n:3d}){' A^T' if trans else '    '}"
              f" err {err} | kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"_int_mm {'%.4f ms' % lib_ms if lib_ms is not None else 'n/a (K, N not multiples of 8)'}"
              f"  bound {b_ms * 1e3:.2f} us ({b_by})", flush=True)
    return rows


def check_k2(rates, gen):
    what, m, k, n = K2_SHAPE
    a, b = rand_int8((m, k), gen), rand_int8((k, n), gen)
    mx = fused_matmul_int8.matmul_max_cuda(a, b)
    err_max = max_abs_err(mx, fused_matmul_int8.matmul_max_plain(a, b))
    shift = numerics.forward_shift(numerics.range_estimate_from_max(mx))
    errs = []
    cases = [(shift, False), (torch.zeros_like(shift), False),
             (numerics.range_estimate_from_max(mx) - 3, True), (shift - 20, True)]
    for s, grad in cases:
        got = fused_matmul_int8.matmul_requant_cuda(a, b, s, grad)
        errs.append(max_abs_err(got, fused_matmul_int8.matmul_requant_plain(a, b, s, grad)))
    # ragged and tiled shapes of the JAX package's own tests
    for mm, kk, nn in [(300, 100, 70), (1024, 24, 144), (2047, 37, 513)]:
        aa, bb = rand_int8((mm, kk), gen), rand_int8((kk, nn), gen)
        mx2 = fused_matmul_int8.matmul_max_cuda(aa, bb)
        errs.append(max_abs_err(mx2, fused_matmul_int8.matmul_max_plain(aa, bb)))
        s2 = numerics.forward_shift(numerics.range_estimate_from_max(mx2))
        errs.append(max_abs_err(fused_matmul_int8.matmul_requant_cuda(aa, bb, s2),
                                fused_matmul_int8.matmul_requant_plain(aa, bb, s2)))
    if err_max or any(errs):
        raise AssertionError(f"K2 differs from plain: max {err_max}, requant {errs}")
    print(f"  K2 {what}: shift {int(shift)}; max and requant (fwd, shift 0, grad, "
          f"grad shift<0) byte-equal to plain, and at 3 ragged shapes", flush=True)
    rows = k2_timings(what, a, b, shift, err_max, max(errs), rates)

    what_t, mt, kt, nt = K2_TILED_SHAPE
    at, bt = rand_int8((mt, kt), gen), rand_int8((kt, nt), gen)
    mx_t = fused_matmul_int8.matmul_max_cuda(at, bt)
    err_max_t = max_abs_err(mx_t, fused_matmul_int8.matmul_max_plain(at, bt))
    shift_t = numerics.forward_shift(numerics.range_estimate_from_max(mx_t))
    err_req_t = max_abs_err(fused_matmul_int8.matmul_requant_cuda(at, bt, shift_t),
                            fused_matmul_int8.matmul_requant_plain(at, bt, shift_t))
    if err_max_t or err_req_t:
        raise AssertionError(f"K2 {what_t} differs from plain: max {err_max_t}, "
                             f"requant {err_req_t}")
    print(f"  K2 {what_t}: shift {int(shift_t)}; max and requant byte-equal to plain",
          flush=True)
    tiled = k2_timings(what_t, at, bt, shift_t, err_max_t, err_req_t, rates)
    for row, row_t in zip(rows, tiled):
        row["tiled_branch"] = {key: row_t[key] for key in
                               ("what", "m", "k", "n", "ms", "plain_ms", "bound_ms", "bound_by")}
    return rows


def k2_timings(what, a, b, shift, err_max, err_requant, rates):
    """Kernel, plain and bound times of K2's two phases on (a, b)."""
    m, k = a.shape
    n = b.shape[1]
    ops = 2.0 * m * n * k
    rows = []
    for name, fn, plain, nbytes, err in [
        ("fused_matmul_max", lambda: fused_matmul_int8.matmul_max_cuda(a, b),
         lambda: fused_matmul_int8.matmul_max_plain(a, b), m * k + k * n + 4.0, err_max),
        ("fused_matmul_requant",
         lambda: fused_matmul_int8.matmul_requant_cuda(a, b, shift),
         lambda: fused_matmul_int8.matmul_requant_plain(a, b, shift),
         m * k + k * n + 4.0 + m * n, err_requant),
    ]:
        ms, plain_ms = time_ms(fn), time_ms(plain)
        b_ms, b_by = bound(ops, nbytes, rates)
        rows.append(dict(name=name, what=what, m=m, k=k, n=n, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by))
        print(f"  {name:22s} ({m},{k})x({k},{n}) kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"bound {b_ms * 1e3:.2f} us ({b_by})", flush=True)
    return rows


def params_equal(p, q) -> bool:
    return all(bool(a) == bool(b) and (not a or all(np.array_equal(x, y) for x, y in zip(a["w"], b["w"])))
               for a, b in zip(p, q)) and len(p) == len(q)


def train_run(batch, epochs, train, test, start, device, backend):
    lines = []
    model, acc = train_niti(train, test, epochs=epochs, batch=batch, seed=0,
                            log=lines.append, start_params=start, device=device,
                            backend=backend)
    losses = [float(re.search(r"loss (\S+)", ln).group(1)) for ln in lines]
    rate = float(re.search(r"([\d.]+) samples/s", lines[-1]).group(1))
    return dict(params=export_jax_params(model), acc=acc, losses=losses, lines=lines,
                samples_per_s=rate, model=model)


def main_path(batch, epochs, start, k1_per_step, k2_per_step, record_shapes=False):
    """train_niti on the card with the kernels (launches counted from 0),
    then with the plain versions on the card and on the CPU."""
    train = synthetic_mnist(batch, seed=2 * batch)      # one step per epoch
    test = synthetic_mnist(batch, seed=2 * batch + 1)   # one eval step per epoch
    shapes = set()
    real = matmul_int8.matmul_acc_cuda
    if record_shapes:
        def recording(a, b):
            shapes.add((a.shape[0], a.shape[1], b.shape[1], a.stride(0) == 1 and a.stride(1) != 1))
            return real(a, b)
        matmul_int8.matmul_acc_cuda = recording
    kernels.reset_launch_counts()
    try:
        run = train_run(batch, epochs, train, test, start, "cuda", "cuda")
    finally:
        matmul_int8.matmul_acc_cuda = real
    counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    plain_card = train_run(batch, epochs, train, test, start, "cuda", "torch")
    plain_cpu = train_run(batch, epochs, train, test, start, "cpu", "cuda")
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"plain runs launched kernels: {kernels.launch_counts()}")
    for ln in run["lines"]:
        print(f"  [b{batch} cuda] {ln}", flush=True)
    for other, label in ((plain_card, "plain on the card"), (plain_cpu, "plain on the CPU")):
        if not params_equal(run["params"], other["params"]):
            raise AssertionError(f"b{batch}: params differ between the kernels and {label}")
        if max(abs(x - y) for x, y in zip(run["losses"], other["losses"])) > 1e-5:
            raise AssertionError(f"b{batch}: losses {run['losses']} vs {label} {other['losses']}")
        if run["acc"] != other["acc"]:
            raise AssertionError(f"b{batch}: accuracy {run['acc']} vs {label} {other['acc']}")
    if not all(np.isfinite(run["losses"])):
        raise AssertionError(f"b{batch}: non-finite losses {run['losses']}")
    moved = any(not np.array_equal(a["w"][0], s["w"][0]) for a, s in zip(run["params"], start) if a)
    if not moved:
        raise AssertionError(f"b{batch}: training did not change the params")
    want = {"matmul_int8": epochs * (k1_per_step + K1_PER_EVAL_STEP),
            "fused_matmul_max": epochs * k2_per_step, "fused_matmul_requant": epochs * k2_per_step}
    if counts != want:
        raise AssertionError(f"b{batch}: launches {counts}, expected {want}")
    print(f"  b{batch}: {epochs} train + {epochs} eval steps; params byte-identical across "
          f"kernels / plain on card / plain on CPU; losses {run['losses']}; "
          f"launches {counts}", flush=True)
    return run, counts, shapes


def per_step_counts(model, batch):
    """K1 launches of one train step and of one eval step, each counted alone."""
    x, y = synthetic_mnist(batch, seed=7)
    xb = torch.from_numpy(x.astype(np.float32)).cuda()
    oh = torch.from_numpy(onehot_padded(y, NUM_CLASSES, NITI_LOGIT_CHANNELS)).cuda()
    out = {}
    for what, fn in (("train", lambda: make_train_step(model)(xb, oh)),
                     ("eval", lambda: make_eval_step(model)(xb, torch.from_numpy(y.astype(np.int64)).cuda()))):
        kernels.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        out[what] = kernels.launch_counts()
    kernels.reset_launch_counts()
    return out


def throughput(batch, steps, start):
    x, y = synthetic_mnist(batch * steps, seed=11)
    test = synthetic_mnist(batch, seed=12)
    run = train_run(batch, 1, (x, y), test, start, "cuda", "cuda")
    return run["samples_per_s"], run["lines"][-1]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs the GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    rates = peak_rates(name)
    print(f"card (nvidia-smi name, power.limit): {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; peaks from the {rates[2]}: "
          f"{rates[0] / 1e12:.0f} int8 TOP/s, {rates[1] / 1e12:.2f} TB/s", flush=True)

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"phase 2: built {sorted(logs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for lib, log in logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  [{lib}] {ln.strip()}", flush=True)

    print("phase 3: kernels against their plain versions on the card", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1_rows = check_k1(rates, gen)
    k2_rows = check_k2(rates, gen)

    start = export_jax_params(lenet_niti().reset_parameters(torch.Generator().manual_seed(0)))
    print("phase 4: main path at batch 64", flush=True)
    run64, counts64, shapes = main_path(64, 3, start, K1_PER_TRAIN_STEP, 0, record_shapes=True)
    want_shapes = {(m, k, n, tr) for _, m, k, n, tr in K1_SHAPES}
    if shapes != want_shapes:
        raise AssertionError(f"K1 shapes of the step {sorted(shapes)} != checked {sorted(want_shapes)}")
    steps64 = per_step_counts(run64["model"], 64)
    print(f"  K1 launches: {steps64['train']['matmul_int8']} per train step, "
          f"{steps64['eval']['matmul_int8']} per eval step (batch 64)", flush=True)
    if steps64["train"]["matmul_int8"] != K1_PER_TRAIN_STEP or \
            steps64["eval"]["matmul_int8"] != K1_PER_EVAL_STEP:
        raise AssertionError(f"per-step launches {steps64}")

    print("phase 5: main path at batch 2048", flush=True)
    run2k, counts2k, _ = main_path(2048, 2, start, K1_PER_TRAIN_STEP - 1, 1)
    rate64, line64 = throughput(64, 50, start)
    rate2k, line2k = throughput(2048, 10, start)
    print(f"  throughput on {name}: batch 64 {rate64:.0f} samples/s [{line64}]", flush=True)
    print(f"  throughput on {name}: batch 2048 {rate2k:.0f} samples/s [{line2k}]", flush=True)

    k1_ops = sum(r["ops"] for r in k1_rows)
    k1_bytes = sum(r["bytes"] for r in k1_rows)
    k1_bound, k1_by = bound(k1_ops, k1_bytes, rates)
    lib_all = all(r["library_ms"] is not None for r in k1_rows)
    kernels_line = {"kernels": [
        {"name": "matmul_int8", "route": "cuda",
         "source": "mandheling_tpu_torch/csrc/matmul_int8.cu",
         "replaces": "mandheling_tpu/ops/kernels/matmul_int8.py:65",
         "launches": counts64["matmul_int8"] + counts2k["matmul_int8"],
         "launches_by_run": {"b64": counts64["matmul_int8"], "b2048": counts2k["matmul_int8"]},
         "max_abs_err": max(r["max_abs_err"] for r in k1_rows),
         "ms": sum(r["ms"] for r in k1_rows), "plain_ms": sum(r["plain_ms"] for r in k1_rows),
         "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": sum(r["library_ms"] for r in k1_rows) if lib_all else None,
         "shapes": "the 11 contractions of one batch-64 train step; times are their sum"},
    ]}
    for r in k2_rows:
        replaces = {"fused_matmul_max": "mandheling_tpu/ops/kernels/fused_matmul_int8.py:162",
                    "fused_matmul_requant": "mandheling_tpu/ops/kernels/fused_matmul_int8.py:182"}
        kernels_line["kernels"].append({
            "name": r["name"], "route": "cuda",
            "source": "mandheling_tpu_torch/csrc/fused_matmul_int8.cu",
            "replaces": replaces[r["name"]],
            "launches": counts64[r["name"]] + counts2k[r["name"]],
            "launches_by_run": {"b64": counts64[r["name"]], "b2048": counts2k[r["name"]]},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "shapes": f"{r['what']}: ({r['m']},{r['k']})x({r['k']},{r['n']})",
            "tiled_branch": r["tiled_branch"]})
    for kern in kernels_line["kernels"]:
        if kern["launches"] <= 0:
            raise AssertionError(f"{kern['name']} was not launched on the main path")

    print(f"done in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"{card}")
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
