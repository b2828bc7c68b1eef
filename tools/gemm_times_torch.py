#!/usr/bin/env python3
"""Device times of the GEMM kernels of `mandheling_tpu_torch`: K1 and K2 at
every shape and operand layout the LeNet and MobileNetV2 training steps give
them, through the public wrappers `matmul_acc_cuda`, `matmul_max_cuda` and
`matmul_requant_cuda`; K3's two phases (`conv_max_cuda`, `conv_requant_cuda`)
at the MobileNetV2 stem, LeNet's three fused-mode-"all" convs and ResNet18's
seven b256 3x3 shapes (K3_CASES), each beside the cuDNN fp32 conv of the same
operands (TF32 off) and the non-fused route fused mode "all" replaces
(`conv2d_forward` under "matmul_only"); and K6 (`matmul_max_bf16_cuda`) at
the dot probe's (49152, K) x (K, 512), K in {28, 128, 256}.

    python3 tools/gemm_times_torch.py [--root DIR] [--label L] [--out FILE]

`--root` names the checkout whose package is timed (default: the one this
script is in), so one copy of the script compares two trees in one call, in
turns. For example, with the parent commit and the working tree unpacked by
`git archive` into an ignored directory:

    for side in parent change change parent; do
      python3 tools/gemm_times_torch.py --root _ab/$side --label $side \\
          --out chiprun_out/gemm_$side.json
    done

The shapes are recorded, not listed: one train step and one eval step of
each model run on the meta device through the tree's own package, with the
wrappers' callers counted by (M, K, N, A's layout, B's layout). Times are
medians of the device time per call issued back to back (a sleep kernel
holds the stream while the host queues them), warm (the same operands each
call) and cold (operand copies rotated over more than 64 MB, above the
H100's 50 MB L2). A card is required; without one the script exits 2.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
COLD_BYTES = 64 * 2**20
# (what, x shape, w shape, stride, pads), as chip_smoke.py's K3_CASES
K3_CASES = [
    ("MNv2 stem b256", (256, 32, 32, 3), (3, 3, 3, 32), (1, 1), ((1, 1), (1, 1))),
    ("LeNet conv1 b64", (64, 28, 28, 1), (5, 5, 1, 20), (1, 1), ((0, 0), (0, 0))),
    ("LeNet conv2 b64", (64, 12, 12, 20), (5, 5, 20, 52), (1, 1), ((0, 0), (0, 0))),
    ("LeNet conv2 igrad b64", (64, 8, 8, 52), (5, 5, 52, 20), (1, 1), ((4, 4), (4, 4))),
    ("ResNet18 stem 3->64", (256, 32, 32, 3), (3, 3, 3, 64), (1, 1), ((1, 1), (1, 1))),
    ("ResNet18 layer1 64->64", (256, 32, 32, 64), (3, 3, 64, 64), (1, 1), ((1, 1), (1, 1))),
    ("ResNet18 layer2 s2 64->128", (256, 32, 32, 64), (3, 3, 64, 128), (2, 2), ((0, 1), (0, 1))),
    ("ResNet18 layer2 128->128", (256, 16, 16, 128), (3, 3, 128, 128), (1, 1), ((1, 1), (1, 1))),
    ("ResNet18 layer3 s2 128->256", (256, 16, 16, 128), (3, 3, 128, 256), (2, 2),
     ((0, 1), (0, 1))),
    ("ResNet18 layer3 256->256", (256, 8, 8, 256), (3, 3, 256, 256), (1, 1), ((1, 1), (1, 1))),
    ("ResNet18 layer4 s2 256->512", (256, 8, 8, 256), (3, 3, 256, 512), (2, 2), ((0, 1), (0, 1))),
]
K6_KS = (28, 128, 256)
BUDGET_MS = 200.0  # device time a timed loop may take: a slow kernel gets fewer launches


def layout_key(a, b):
    """(M, K, N, A's layout, B's layout): A "k" (k contiguous) or "m";
    B "k" or "n"; a dimension of size 1 counts as contiguous."""
    m, k = a.shape
    n = b.shape[1]
    (sam, sak), (sbk, sbn) = a.stride(), b.stride()
    al = "k" if sak == 1 or k <= 1 else "m" if sam == 1 or m <= 1 else "strided"
    bl = "k" if sbk == 1 or k <= 1 else "n" if sbn == 1 or n <= 1 else "strided"
    return (m, k, n, al, bl)


@contextlib.contextmanager
def recording(targets):
    """Counts the calls of each (module, name) of `targets` by layout_key."""
    seen = {name: collections.Counter() for _, name in targets}
    reals = [(mod, name, getattr(mod, name)) for mod, name in targets]
    for mod, name, real in reals:
        def counted(a, b, *rest, _real=real, _seen=seen[name], **kw):
            _seen[layout_key(a, b)] += 1
            return _real(a, b, *rest, **kw)
        setattr(mod, name, counted)
    try:
        yield seen
    finally:
        for mod, name, real in reals:
            setattr(mod, name, real)


def step_shapes(pkg, model_fn, hwc, batch):
    """{"K1": Counter, "K2": Counter} of one train step plus one eval step
    on the meta device."""
    mm, fmm = pkg["matmul_int8"], pkg["fused_matmul_int8"]
    model = model_fn().to("meta")
    x = torch.zeros((batch,) + hwc, device="meta")
    oh = torch.zeros((batch, pkg["logits"]), dtype=torch.int32, device="meta")
    labels = torch.zeros(batch, dtype=torch.int64, device="meta")
    out = {}
    for step, run in (("train", lambda: pkg["make_train_step"](model)(x, oh)),
                      ("eval", lambda: pkg["make_eval_step"](model)(x, labels))):
        with recording([(mm, "matmul_acc"), (fmm, "matmul_max")]) as seen:
            run()
        out[step] = {"K1": seen["matmul_acc"], "K2": seen["matmul_max"]}
    return out


def time_ms(fn, sets, launches=20, rounds=5):
    """Median over `rounds` of the device time per call of fn(*s), cycling
    through the operand sets `sets`."""
    fn(*sets[0])
    torch.cuda.synchronize()
    n = max(launches, len(sets))
    per_call = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for i in range(n):
            fn(*sets[i % len(sets)])
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / n)
    return statistics.median(per_call)


def time_budgeted(fn, sets=((),), rounds=5):
    """time_ms with as many launches (at most 20, at least 2) as fit
    BUDGET_MS, from one timed call."""
    fn(*sets[0])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn(*sets[0])
    end.record()
    torch.cuda.synchronize()
    launches = int(max(2, min(20, BUDGET_MS / max(start.elapsed_time(end), 1e-3))))
    return time_ms(fn, list(sets), launches=launches, rounds=rounds)


def time_k3(pkg, gen):
    """Both phases of K3 at each of K3_CASES, the cuDNN fp32 conv and the
    non-fused route, with the bound's operations and bytes."""
    fc, num, conv = pkg["fused_conv_int8"], pkg["numerics"], pkg["conv"]
    zero = torch.zeros((), dtype=torch.int32, device="cuda")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for what, xs, ws, stride, pads in K3_CASES:
        x = torch.randint(-128, 128, xs, generator=gen, dtype=torch.int8, device="cuda")
        w = torch.randint(-128, 128, ws, generator=gen, dtype=torch.int8, device="cuda")
        shift = num.forward_shift(num.range_estimate_from_max(fc.conv_max_cuda(x, w, pads, stride)))
        oh, ow = fc._out_spatial(x, w, pads, stride)
        m, k, n = xs[0] * oh * ow, ws[0] * ws[1] * ws[2], ws[3]
        with conv.use_fused_conv_mode("matmul_only"):
            nonfused = time_budgeted(lambda: conv.conv2d_forward(x, zero, w, zero, stride, pads),
                                     rounds=3)
        (pt, pb), (pl, pr) = pads
        xf = torch.nn.functional.pad(x.permute(0, 3, 1, 2).float(), (pl, pr, pt, pb)).contiguous(
            memory_format=torch.channels_last)
        wf = w.permute(3, 2, 0, 1).float().contiguous(memory_format=torch.channels_last)
        rows.append(dict(
            what=what, x=xs, w=ws, stride=stride, pads=pads, m=m, k=k, n=n,
            ops=2.0 * m * k * n, max_bytes=x.numel() + w.numel() + 4.0,
            requant_bytes=x.numel() + w.numel() + 4.0 + m * n,
            max_ms=time_budgeted(lambda: fc.conv_max_cuda(x, w, pads, stride)),
            requant_ms=time_budgeted(lambda: fc.conv_requant_cuda(x, w, shift, pads, stride)),
            nonfused_ms=nonfused,
            cudnn_fp32_ms=time_budgeted(
                lambda: torch.nn.functional.conv2d(xf, wf, stride=stride), rounds=3)))
        del xf, wf
    torch.backends.cudnn.allow_tf32 = tf32
    return rows


def time_k6(pkg, gen):
    fmm = pkg["fused_matmul_int8"]
    rows = []
    for k in K6_KS:
        a = torch.randint(-80, 80, (49152, k), generator=gen, dtype=torch.int8, device="cuda")
        b = torch.randint(-80, 80, (k, 512), generator=gen, dtype=torch.int8, device="cuda")
        rows.append(dict(k=k, ops=2.0 * 49152 * k * 512, bytes=49152 * k + k * 512 + 4.0,
                         ms=time_budgeted(fmm.matmul_max_bf16_cuda, [(a, b)])))
    return rows


def operands(key, gen, copies=1):
    m, k, n, al, bl = key

    def one():
        a = torch.randint(-128, 128, (k, m) if al == "m" else (m, k), generator=gen,
                          dtype=torch.int8, device="cuda")
        b = torch.randint(-128, 128, (n, k) if bl == "k" else (k, n), generator=gen,
                          dtype=torch.int8, device="cuda")
        return (a.t() if al == "m" else a, b.t() if bl == "k" else b)
    return [one() for _ in range(copies)]


def cold_copies(key):
    m, k, n = key[:3]
    return min(1000, max(2, -(-COLD_BYTES // (m * k + k * n))))


def time_k1(pkg, shapes, gen, library=False):
    mm = pkg["matmul_int8"]
    rows = []
    for key, count in sorted(shapes.items()):
        sets = operands(key, gen)
        row = dict(key=list(key), launches=count,
                   ms=time_ms(mm.matmul_acc_cuda, sets),
                   cold_ms=time_ms(mm.matmul_acc_cuda, operands(key, gen, cold_copies(key))))
        if library and key[3] == "k" and key[0] > 16 and key[1] % 8 == 0 and key[2] % 8 == 0:
            a, b = sets[0]
            try:
                torch._int_mm(a, b)
            except RuntimeError:
                a, b = a.contiguous(), b.contiguous()
            row["library_ms"] = time_ms(torch._int_mm, [(a, b)])
        rows.append(row)
    return rows


def time_k2(pkg, shapes, gen):
    fmm, num = pkg["fused_matmul_int8"], pkg["numerics"]
    rows = []
    for key, count in sorted(shapes.items()):
        sets = operands(key, gen)
        cold = operands(key, gen, cold_copies(key))
        shift = num.forward_shift(num.range_estimate_from_max(fmm.matmul_max_cuda(*sets[0])))
        requant = lambda a, b: fmm.matmul_requant_cuda(a, b, shift)  # noqa: E731
        rows.append(dict(key=list(key), launches=count,
                         max_ms=time_ms(fmm.matmul_max_cuda, sets),
                         max_cold_ms=time_ms(fmm.matmul_max_cuda, cold),
                         requant_ms=time_ms(requant, sets), requant_cold_ms=time_ms(requant, cold)))
    return rows


def total(rows, field, pred=lambda r: True):
    return sum(r["launches"] * r[field] for r in rows if pred(r))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT), help="checkout whose package is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--out", help="write every row here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gemm_times_torch: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from mandheling_tpu_torch.models import (MOBILENET_V2_NITI_LOGITS, lenet_niti,
                                             mobilenet_v2_niti)
    from mandheling_tpu_torch.ops import conv, numerics
    from mandheling_tpu_torch.ops.kernels import (build, fused_conv_int8, fused_matmul_int8,
                                                  matmul_int8)
    from mandheling_tpu_torch.train import make_eval_step, make_train_step
    pkg = dict(matmul_int8=matmul_int8, fused_matmul_int8=fused_matmul_int8, numerics=numerics,
               fused_conv_int8=fused_conv_int8, conv=conv,
               make_train_step=make_train_step, make_eval_step=make_eval_step,
               logits=MOBILENET_V2_NITI_LOGITS)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[{args.label}] card: {card}; package {matmul_int8.__file__}", flush=True)
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)

    lenet = step_shapes(pkg, lenet_niti, (28, 28, 1), 64)
    lenet2k = step_shapes(pkg, lenet_niti, (28, 28, 1), 2048)
    mnv2 = step_shapes(pkg, mobilenet_v2_niti, (32, 32, 3), 256)
    res = {"card": card, "label": args.label, "root": args.root}
    res["lenet_b64_k1"] = time_k1(pkg, lenet["train"]["K1"], gen)
    res["lenet_b2048_k1"] = time_k1(pkg, lenet2k["train"]["K1"], gen)
    res["lenet_b2048_k2"] = time_k2(pkg, lenet2k["train"]["K2"], gen)
    res["mnv2_b256_k1"] = time_k1(pkg, mnv2["train"]["K1"], gen, library=True)
    res["mnv2_b256_k2"] = time_k2(pkg, mnv2["train"]["K2"], gen)

    res["k3"] = time_k3(pkg, gen)
    res["k6"] = time_k6(pkg, gen)

    k1, k2 = res["mnv2_b256_k1"], res["mnv2_b256_k2"]
    row_major = lambda r: r["key"][3] == "k"  # noqa: E731
    res["sums"] = {
        "lenet_b64_k1_ms": total(res["lenet_b64_k1"], "ms"),
        "lenet_b2048_k1_ms": total(res["lenet_b2048_k1"], "ms"),
        "lenet_b2048_k2_max_ms": total(res["lenet_b2048_k2"], "max_ms"),
        "lenet_b2048_k2_requant_ms": total(res["lenet_b2048_k2"], "requant_ms"),
        "mnv2_k1_launches": sum(r["launches"] for r in k1),
        "mnv2_k1_ms": total(k1, "ms"), "mnv2_k1_cold_ms": total(k1, "cold_ms"),
        "mnv2_k1_row_major_launches": sum(r["launches"] for r in k1 if row_major(r)),
        "mnv2_k1_row_major_ms": total(k1, "ms", row_major),
        "mnv2_k1_int_mm_launches": sum(r["launches"] for r in k1 if "library_ms" in r),
        "mnv2_k1_where_int_mm_ms": total(k1, "ms", lambda r: "library_ms" in r),
        "mnv2_k1_int_mm_ms": total(k1, "library_ms", lambda r: "library_ms" in r),
        "mnv2_k1_fgrad_launches": sum(r["launches"] for r in k1 if not row_major(r)),
        "mnv2_k1_fgrad_ms": total(k1, "ms", lambda r: not row_major(r)),
        "mnv2_k1_fgrad_cold_ms": total(k1, "cold_ms", lambda r: not row_major(r)),
        "mnv2_k2_launches": sum(r["launches"] for r in k2),
        "mnv2_k2_max_ms": total(k2, "max_ms"), "mnv2_k2_max_cold_ms": total(k2, "max_cold_ms"),
        "mnv2_k2_requant_ms": total(k2, "requant_ms"),
        "mnv2_k2_requant_cold_ms": total(k2, "requant_cold_ms"),
    }
    k3 = {r["what"]: [round(r[f], 5) for f in ("max_ms", "requant_ms", "nonfused_ms",
                                               "cudnn_fp32_ms")] for r in res["k3"]}
    k6 = {r["k"]: round(r["ms"], 5) for r in res["k6"]}
    print(f"[{args.label}] " + json.dumps({**res["sums"], "K3 max, requant, non-fused, cuDNN "
                                           "fp32 ms": k3, "K6 ms by K": k6}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
