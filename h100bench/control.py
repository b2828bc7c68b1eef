#!/usr/bin/env python3
"""Readings of the control and of the planted faults at a cell's own size:

    python3 h100bench/control.py --workload <cell> --seeds <n> [<n> ...] [--out FILE]

For each seed: the cell's data set and weights as a run draws them, and the
first three batches as the window's feed gives them (the port's
DataLoader and onehot_padded). The int8 reference takes its three steps;
in the program's place, each of these takes the same three and is judged
against it by the numbers a run compares (judge.py):

- `control`: the reference in int4, every activation and gradient
  requantized to 3 magnitude bits (weights stay int8);
- `half_batch`: the reference on the first half of each batch, its loss the
  mean over that half;
- `altered`: the reference with one weight element moved by one after each
  step (an answer altered where it is produced);
- `unchanged`: the state returned unchanged (the start weights; losses the
  reference's, so that only the updates tell).

A run's own steps never run these. Prints one JSON line a reading, and with
--out writes them all there as JSON lines. Runs on the card when there is
one, else on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100bench import judge, manifest, reference  # noqa: E402
from h100bench.run import draw, reference_ctx, reference_steps  # noqa: E402


def half(fed):
    """The first half of each batch."""
    return [(bx[: max(1, len(bx) // 2)], oh[: max(1, len(oh) // 2)]) for bx, oh in fed]


def altered_step(model, x, onehot, ctx):
    """The reference's step, then one weight element moved by one."""
    loss = reference.train_step(model, x, onehot, ctx)
    w = reference.weights(model)[0][0].view(-1)
    w[0] = torch.where(w[0] < 127, w[0] + 1, w[0] - 1)
    return loss


def first_batches(c: dict, images, labels, seed: int, n: int = 3):
    """The first `n` (float images, padded one-hot) batches the window's
    feed gives the step."""
    from mandheling_tpu_torch.data.loader import DataLoader, onehot_padded

    cfg = c["config"]
    epoch = DataLoader(images, labels, c["traffic"]["batch"], seed=seed).epoch()
    out = []
    for bx, by in epoch:
        out.append((bx.copy(), onehot_padded(by, cfg["classes"], cfg["logit_width"])))
        if len(out) == n:
            break
    epoch.close()
    return out


def readings(c: dict, seed: int, device: torch.device) -> dict:
    """{variant: the judge's numbers} for one seed."""
    images, labels, _, start = draw(c, seed, device)
    fed = first_batches(c, images, labels, seed)
    ref = reference_steps(c, start, fed, device)
    variants = {"control": reference_steps(c, start, fed, device,
                                           ctx=reference_ctx(c, reference.INT4)),
                "half_batch": reference_steps(c, start, half(fed), device),
                "altered": reference_steps(c, start, fed, device, step=altered_step),
                "unchanged": (ref[0], start, start)}
    return {name: judge.readings(v[0], ref[0], start, v[1], ref[1], v[2], ref[2])
            for name, v in variants.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    c = manifest.cell(manifest.benchmark(), args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    lines = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        for variant, numbers in readings(c, seed, device).items():
            line = {"workload": args.workload, "seed": seed, "variant": variant,
                    "device": kind, "numbers": numbers,
                    "fails": not judge.verdict(numbers, c["cell"]["limits"])}
            lines.append(line)
            print(json.dumps(line), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
