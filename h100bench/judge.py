"""What decides `correct` for a training cell: the program's first three
steps against the reference's, from the same weights on the same batches.

- `loss_gap`: the largest relative gap of a step's loss.
- `update1_gap`: the first update (w1 - w0, the integer gradient as the
  optimizer applied it), and `change3_gap`: the change after three steps
  (w3 - w0); each by its worst leaf: the gap between the program's norm of
  the leaf and the reference's, over the reference's norm of that leaf or
  of the median leaf, whichever is larger. Leaves whose reference update
  is under a thousandth of the median leaf's are left out.
- `weights_differ`: the weight and exponent elements that differ after
  three steps; NITI arithmetic is exact, so its limit is 0.

A number passes when it is at most its limit.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

Leaves = Sequence[Tuple[torch.Tensor, torch.Tensor]]
NUMBERS = ("loss_gap", "update1_gap", "change3_gap", "weights_differ")
NEGLIGIBLE = 1e-3


def _norms(a: Leaves, b: Leaves) -> List[float]:
    return [float(torch.linalg.vector_norm((wa.to(torch.float64) - wb.to(torch.float64))))
            for (wa, _), (wb, _) in zip(a, b)]


def worst_leaf_gap(prog: Leaves, ref: Leaves, start: Leaves) -> float:
    """The worst leaf's |norm(prog - start) - norm(ref - start)| over
    max(norm(ref - start), median leaf's)."""
    p, r = _norms(prog, start), _norms(ref, start)
    med = sorted(r)[len(r) // 2]
    kept = [(a, b) for a, b in zip(p, r) if b >= NEGLIGIBLE * med]
    if med == 0 or not kept:
        return 0.0 if p == r else float("inf")
    return max(abs(a - b) / max(b, med) for a, b in kept)


def differ(a: Leaves, b: Leaves) -> int:
    return sum(int((wa != wb).sum()) + int((ea != eb).sum())
               for (wa, ea), (wb, eb) in zip(a, b))


def readings(prog_losses, ref_losses, start: Leaves, prog1: Leaves, ref1: Leaves,
             prog3: Leaves, ref3: Leaves) -> Dict[str, float]:
    gaps = [abs(float(p) - float(r)) / abs(float(r)) for p, r in zip(prog_losses, ref_losses)]
    loss_gap = max(gaps) if all(math.isfinite(g) for g in gaps) else float("inf")
    return {"loss_gap": loss_gap,
            "update1_gap": worst_leaf_gap(prog1, ref1, start),
            "change3_gap": worst_leaf_gap(prog3, ref3, start),
            "weights_differ": float(differ(prog3, ref3))}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Whether every number is finite and within its limit."""
    return all(math.isfinite(numbers.get(name, math.inf)) and numbers[name] <= limits[name]
               for name in limits)
