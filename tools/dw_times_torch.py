#!/usr/bin/env python3
"""Device times of the depthwise forwards, input grads and filter grads of
a full-width MobileNetV2 train step at batch 256 in `mandheling_tpu_torch`,
through the public ops `ops.depthwise.dwconv2d_forward` /
`dwconv2d_input_grad` / `dwconv2d_filter_grad_acc`: the fused depthwise
kernel K4 and the filter-grad kernel K5 where they take them, with whatever
torch ops the tree runs around them (pads, dilations, flips, shifts, the
plain taps where a form does not take a kernel). All 17 filter grads are
timed, stride 1 and 2, summed apart. Per-tensor and as the r5 recipe
(per-channel depthwise exponents). As a yardstick only, one cuDNN float32
depthwise call per shape (`conv2d` with groups = C, `conv_transpose2d` for
the strided input grads, `torch.nn.grad.conv2d_weight` for the filter
grads; TF32 off), which computes the accumulator only, inexactly past 2^24;
the port never calls it.

    python3 tools/dw_times_torch.py [--root DIR] [--label L] [--out FILE]

`--root` names the checkout whose package is timed (default: the one this
script is in), so one copy of the script compares two trees in one call, in
turns. With the parent commit and the working tree unpacked by `git
archive` into an ignored directory:

    for side in parent change change parent; do
      python3 tools/dw_times_torch.py --root _ab/$side --label $side \\
          --out out/dw_$side.json
    done

The calls are recorded, not listed: one train step of each model runs on the
meta device through the tree's own package, the ops' arguments counted.
Times are medians of the device time per call launched back to back (a sleep
kernel holds the stream while the host queues them), summed over one train
step's calls. A card is required; without one the script exits 2.
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
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def recording(dw):
    """Counts the calls of the depthwise forward, input grad and filter-grad
    accumulator of module `dw` by their arguments."""
    seen = {"fwd": collections.Counter(), "igrad": collections.Counter(),
            "fgrad": collections.Counter()}
    reals = {n: getattr(dw, n) for n in ("dwconv2d_forward", "dwconv2d_input_grad",
                                         "dwconv2d_filter_grad_acc")}

    def fwd(x, x_exp, w, w_exp, stride=(1, 1), padding="SAME", act=None):
        seen["fwd"][(tuple(x.shape), tuple(w.shape), tuple(w_exp.shape), tuple(stride),
                     padding, act)] += 1
        return reals["dwconv2d_forward"](x, x_exp, w, w_exp, stride, padding, act)

    def igrad(gy, w, x_spatial, stride=(1, 1), padding="SAME", w_exp=None):
        seen["igrad"][(tuple(gy.shape), tuple(w.shape), None if w_exp is None else
                       tuple(w_exp.shape), tuple(x_spatial), tuple(stride), padding)] += 1
        return reals["dwconv2d_input_grad"](gy, w, x_spatial, stride, padding, w_exp)

    def fgrad(x, gy, kernel, stride=(1, 1), padding="SAME"):
        seen["fgrad"][(tuple(x.shape), tuple(gy.shape), tuple(kernel), tuple(stride),
                       padding)] += 1
        return reals["dwconv2d_filter_grad_acc"](x, gy, kernel, stride, padding)

    dw.dwconv2d_forward, dw.dwconv2d_input_grad, dw.dwconv2d_filter_grad_acc = fwd, igrad, fgrad
    try:
        yield seen
    finally:
        for n, f in reals.items():
            setattr(dw, n, f)


def time_ms(fn, launches=20, rounds=3):
    """Median over `rounds` of the device time per call of fn()."""
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


def rand8(shape, gen):
    return torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8, device="cuda")


def w_exp_like(shape, gen):
    if not shape:
        return torch.full((), -6, dtype=torch.int32, device="cuda")
    return torch.randint(-12, -4, shape, generator=gen, dtype=torch.int32, device="cuda")


def cudnn_ms(kind, key, gen):
    """One float32 depthwise conv of cuDNN on the call's shapes (TF32 off),
    channels-last: the yardstick. For a filter grad, cuDNN's depthwise weight
    grad (`torch.nn.grad.conv2d_weight`, groups = C) at symmetric pads of
    kernel // 2, which give the same gy shape as the SAME pads (at stride 2
    the top and left pad differ by one, the work does not); float32 sums are
    not exact past 2^24, so it is not the same function."""
    if kind == "fgrad":
        (b, h, w, c), (_, oh, ow, _), (kh, kw), stride = key[:4]
        x = torch.randn((b, c, h, w), generator=gen, device="cuda").to(
            memory_format=torch.channels_last)
        gy = torch.randn((b, c, oh, ow), generator=gen, device="cuda").to(
            memory_format=torch.channels_last)
        return time_ms(lambda: torch.nn.grad.conv2d_weight(
            x, (c, 1, kh, kw), gy, stride=stride, padding=(kh // 2, kw // 2), groups=c))
    if kind == "fwd":
        (b, h, w, c), (kh, kw, _, _) = key[0], key[1]
        stride = key[3]
        x = torch.randn((b, c, h, w), generator=gen, device="cuda").to(
            memory_format=torch.channels_last)
        wt = torch.randn((c, 1, kh, kw), generator=gen, device="cuda")
        return time_ms(lambda: F.conv2d(x, wt, stride=stride, padding=(kh // 2, kw // 2),
                                        groups=c))
    (b, oh, ow, c), (kh, kw, _, _), _, (ih, iw), stride = key[:5]
    gy = torch.randn((b, c, oh, ow), generator=gen, device="cuda").to(
        memory_format=torch.channels_last)
    wt = torch.randn((c, 1, kh, kw), generator=gen, device="cuda")
    if stride == (1, 1):
        return time_ms(lambda: F.conv2d(gy, wt, padding=(kh // 2, kw // 2), groups=c))
    out_pad = (ih - ((oh - 1) * stride[0] - 2 * (kh // 2) + kh),
               iw - ((ow - 1) * stride[1] - 2 * (kw // 2) + kw))
    return time_ms(lambda: F.conv_transpose2d(gy, wt, stride=stride, padding=(kh // 2, kw // 2),
                                              output_padding=out_pad, groups=c))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT), help="checkout whose package is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--out", help="write every row here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dw_times_torch: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(Path(args.root).resolve()))
    from mandheling_tpu_torch.models import MOBILENET_V2_NITI_LOGITS, mobilenet_v2_niti
    from mandheling_tpu_torch.ops import depthwise as dw
    from mandheling_tpu_torch.ops.kernels import build
    from mandheling_tpu_torch.train import make_train_step
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[{args.label}] card: {card}; package {dw.__file__}", flush=True)
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"card": card, "label": args.label, "root": args.root, "models": {}}
    yard = {}
    for name, per_channel in (("mnv2", False), ("recipe", True)):
        model = mobilenet_v2_niti(dw_per_channel=per_channel).to("meta")
        x = torch.zeros((256, 32, 32, 3), device="meta")
        oh = torch.zeros((256, MOBILENET_V2_NITI_LOGITS), dtype=torch.int32, device="meta")
        with recording(dw) as seen:
            make_train_step(model)(x, oh)
        rows = []
        for key, count in sorted(seen["fwd"].items(), key=str):
            xs, ws, es, stride, padding, act = key
            xx, ww, ee = rand8(xs, gen), rand8(ws, gen), w_exp_like(es, gen)
            x_exp = torch.zeros((), dtype=torch.int32, device="cuda")
            rows.append(dict(op="fwd", key=list(map(str, key)), launches=count, ms=time_ms(
                lambda: dw.dwconv2d_forward(xx, x_exp, ww, ee, stride, padding, act))))
            if stride == (1, 1):
                yard.setdefault(("fwd", key[:2] + (None, stride)), cudnn_ms("fwd", key, gen))
                rows[-1]["cudnn_ms"] = yard[("fwd", key[:2] + (None, stride))]
        for key, count in sorted(seen["igrad"].items(), key=str):
            gs, ws, es, xsp, stride, padding = key
            gy, ww = rand8(gs, gen), rand8(ws, gen)
            ee = None if es is None else w_exp_like(es, gen)
            rows.append(dict(op="igrad", key=list(map(str, key)), launches=count, ms=time_ms(
                lambda: dw.dwconv2d_input_grad(gy, ww, xsp, stride, padding, ee))))
            yk = ("igrad", (gs, ws, None, xsp, stride))
            yard.setdefault(yk, cudnn_ms("igrad", yk[1], gen))
            rows[-1]["cudnn_ms"] = yard[yk]
        for key, count in sorted(seen["fgrad"].items(), key=str):
            xs, gs, kernel, stride, padding = key
            xx, gy = rand8(xs, gen), rand8(gs, gen)
            rows.append(dict(op="fgrad", key=list(map(str, key)), launches=count, ms=time_ms(
                lambda: dw.dwconv2d_filter_grad_acc(xx, gy, kernel, stride, padding))))
            yk = ("fgrad", key[:4])
            yard.setdefault(yk, cudnn_ms("fgrad", key, gen))
            rows[-1]["cudnn_ms"] = yard[yk]
        k4 = [r for r in rows if r["op"] == "igrad" or (r["op"] == "fwd" and "cudnn_ms" in r)]
        res["models"][name] = {
            "rows": rows,
            "k4_ops_launches": sum(r["launches"] for r in k4),
            "k4_ops_ms": sum(r["launches"] * r["ms"] for r in k4),
            "fwd_s1_ms": sum(r["launches"] * r["ms"] for r in k4 if r["op"] == "fwd"),
            "igrad_ms": sum(r["launches"] * r["ms"] for r in k4 if r["op"] == "igrad"),
            "strided_fwd_ms": sum(r["launches"] * r["ms"] for r in rows
                                  if r["op"] == "fwd" and "cudnn_ms" not in r),
            "cudnn_fp32_ms": sum(r["launches"] * r["cudnn_ms"] for r in k4),
        }
        for part, strides in (("fgrad", ("(1, 1)", "(2, 2)")), ("fgrad_s1", ("(1, 1)",)),
                              ("fgrad_s2", ("(2, 2)",))):
            sub = [r for r in rows if r["op"] == "fgrad" and r["key"][3] in strides]
            res["models"][name].update({
                f"{part}_launches": sum(r["launches"] for r in sub),
                f"{part}_ms": sum(r["launches"] * r["ms"] for r in sub),
                f"{part}_cudnn_fp32_ms": sum(r["launches"] * r["cudnn_ms"] for r in sub)})
        del model
    torch.cuda.synchronize()
    sums = {f"{m}_{k}": v for m, d in res["models"].items() for k, v in d.items() if k != "rows"}
    print(f"[{args.label}] " + json.dumps(sums), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
