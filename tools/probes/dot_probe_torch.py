#!/usr/bin/env python3
"""Micro-probe of the PyTorch/CUDA port: max|A.B| at the grid of
tools/probes/dot_probe.py, on the GPU.

    python3 tools/probes/dot_probe_torch.py

(49152, K) x (K, 512) with K in {28, 128, 256}, int8 operands drawn from
np.random.default_rng(0) in [-80, 80), in two variants:

- int8: K2's phase 1 (``fused_matmul_int8.matmul_max``), s8 x s8 -> s32
  on the tensor cores;
- bf16: K6 (``fused_matmul_int8.matmul_max_bf16``), the operands as bf16,
  float32 sums converted to int32.

Each dispatcher launches its kernel on the card's tensors and takes its
plain version on the CPU's (:func:`plain`).

At these ranges every sum is below 2^24, so both must equal the exact plain
``matmul_max_plain``; :func:`probe` raises if one does not. For each K and
variant it prints the kernel's time (median device time per launch,
launches back to back), GMAC/s and the least time the card could take
(operations at the data sheet's dense int8 or bf16 rate, or bytes at its
memory rate, whichever is larger). `chip_smoke.py` runs :func:`probe` as one
of its phases. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from mandheling_tpu_torch.ops.kernels import fused_matmul_int8  # noqa: E402

ROWS = 49152
KS = (28, 128, 256)
N = 512
VARIANTS = {
    "int8": (fused_matmul_int8.matmul_max, "fused_matmul_max"),
    "bf16": (fused_matmul_int8.matmul_max_bf16, "fused_matmul_max_bf16"),
}


def peak_rates(name: str):
    """{int8 ops/s, bf16 FLOP/s, bytes/s} dense, from NVIDIA's data sheets."""
    if "PCIe" in name:
        return {"int8": 1513e12, "bf16": 756e12, "bytes": 2.0e12}
    if "NVL" in name:
        return {"int8": 1671e12, "bf16": 835e12, "bytes": 3.9e12}
    return {"int8": 1979e12, "bf16": 989e12, "bytes": 3.35e12}


def operands(rows: int = ROWS, ks=KS, n: int = N):
    """{K: (A (rows, K), B (K, n))} int8 numpy arrays, drawn in the JAX
    probe's order from one np.random.default_rng(0)."""
    rng = np.random.default_rng(0)
    out = {}
    for k in ks:
        a = rng.integers(-80, 80, (rows, k)).astype(np.int8)
        b = rng.integers(-80, 80, (k, n)).astype(np.int8)
        out[k] = (a, b)
    return out


def plain(a: torch.Tensor, b: torch.Tensor, variant: str) -> torch.Tensor:
    """The plain version of a variant (0-d int32 max|A.B|) on any device."""
    fn = {"int8": fused_matmul_int8.matmul_max_plain,
          "bf16": fused_matmul_int8.matmul_max_bf16_plain}[variant]
    return fn(a, b)


def time_ms(fn, launches: int = 50, rounds: int = 5) -> float:
    """Median over `rounds` of the device time per call of `fn`, for calls
    issued back to back behind a sleep kernel that holds the stream while
    the host queues them."""
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


def probe(rates=None, log=print):
    """Each variant at each K on the card: checked against the plain
    version (exactly), then timed. Returns one row per (K, variant)."""
    rates = rates or peak_rates(torch.cuda.get_device_name(0))
    rows = []
    for k, (a_np, b_np) in operands().items():
        a, b = torch.from_numpy(a_np).cuda(), torch.from_numpy(b_np).cuda()
        want = fused_matmul_int8.matmul_max_plain(a, b)
        for variant, (fn, kernel) in VARIANTS.items():
            got = fn(a, b)
            err = abs(int(got) - int(want))
            if err:
                raise AssertionError(f"probe K={k} {variant}: {int(got)} != plain {int(want)}")
            ms = time_ms(lambda: fn(a, b))
            plain_ms = time_ms(lambda: plain(a, b, variant), launches=5, rounds=3)
            ops, nbytes = 2.0 * ROWS * k * N, ROWS * k + k * N + 4.0
            t_ops, t_bytes = ops / rates[variant] * 1e3, nbytes / rates["bytes"] * 1e3
            bound_ms, bound_by = (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")
            gmacs = ROWS * k * N / 1e9
            rows.append(dict(k=k, n=N, rows=ROWS, variant=variant, kernel=kernel,
                             max_abs=int(got), max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             gmac_per_s=gmacs / ms * 1e3, bound_ms=bound_ms, bound_by=bound_by))
            log(f"K={k:4d} N={N} {variant}: {ms:7.4f} ms ({gmacs / ms * 1000:.0f} GMAC/s); "
                f"max|A.B| {int(got)} = plain; plain {plain_ms:.4f} ms; bound "
                f"{bound_ms * 1e3:.2f} us ({bound_by})")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("dot_probe_torch: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    probe()
    return 0


if __name__ == "__main__":
    sys.exit(main())
