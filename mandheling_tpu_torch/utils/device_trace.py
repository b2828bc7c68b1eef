"""Per-op tables of a device trace: the port of the analysis half of
``mandheling_tpu/utils/xplane.py`` (`per_op_rows`, `by_category`,
`format_table`, `overlap_report`, `source_ranges_of`), read by
utils/profiler.py.

The JAX package parses the XSpace protobuf a jax.profiler trace writes;
torch.profiler hands its events over directly, so the port has no reader.
:func:`device_events` takes the place of `device_planes`: an event is a dict
with the keys `name`, `category`, `start_us`, `dur_us`, `flops`,
`bytes_accessed` and `source`.

- On a card the events are its activities: CUDA kernels, memcpys and
  memsets. On the CPU they are the host's ops, each with its own time (the
  time its callees took taken out), so that nested ops are not counted
  twice.
- `category`: for a kernel of csrc/, the launch counter it counts under
  (ops/kernels.launch_counts: "matmul_int8", "fused_conv_max", ...), told
  from its symbol and, where one symbol serves two counters, from its
  template arguments (the profiler gives the demangled name); K1's sum of
  its K splits is "matmul_int8 split-K sum". Every other activity takes a
  family from its name: "memcpy", "memset", "cuDNN/cuBLAS" (aten's GEMMs
  and convs on the CPU), "reduction", "copy", "elementwise" or "other".
- `flops`, `bytes_accessed` and `source` are those of the counted op
  (ops/flops.py) that launched a kernel of csrc/; the profiler joins its
  launch notes to the traced kernels of each launch counter in order. Every
  other event has 0, 0 and "" (the JAX package's CPU traces carry none
  either). A two-phase kernel computes the contraction in each phase, so
  both carry the op's flops.
"""

from __future__ import annotations

import collections
import inspect
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# symbol of a kernel of csrc/ -> (index of the template argument that picks
# the counter, or None) and the counter (by that argument: false/0, true/1,
# 2)
_KERNELS = {
    "matmul_kmajor_kernel": (2, ("matmul_int8", "matmul_int16a")),
    "matmul_mnmajor_kernel": (1, ("matmul_int8", "matmul_int16a")),
    "reduce_splits_kernel": (None, "matmul_int8 split-K sum"),
    "fused_max_kernel": (None, "fused_matmul_max"),
    "tiled_max_kernel": (None, "fused_matmul_max"),
    "fused_requant_kernel": (None, "fused_matmul_requant"),
    "tiled_requant_kernel": (None, "fused_matmul_requant"),
    "conv_stream_kernel": (1, ("fused_conv_max",) + ("fused_conv_requant",) * 2),
    "conv_ring_kernel": (1, ("fused_conv_max",) + ("fused_conv_requant",) * 2),
    "dw3x3_kernel": (1, ("fused_dwconv_max",) + ("fused_dwconv_requant",) * 2),
    "dw_any_kernel": (0, ("fused_dwconv_max",) + ("fused_dwconv_requant",) * 2),
    "fgrad3x3_packed_kernel": (None, "fused_dwconv_fgrad"),
    "fgrad_any_kernel": (None, "fused_dwconv_fgrad"),
    "max_bf16_kernel": (None, "fused_matmul_max_bf16"),
    "max_bf16_resident_kernel": (None, "fused_matmul_max_bf16"),
    "k7_absmax_kernel": (None, "requant_int32_absmax"),
    "k7_requant_kernel": (None, "requant_int32_requant"),
    "k8_maxpool_kernel": (None, "pool_concat_maxpool"),
    "k8_maxpool_grad_kernel": (None, "pool_concat_maxpool_grad"),
    "k8_avgpool_kernel": (None, "pool_concat_avgpool"),
    "k8_avgpool_grad_kernel": (None, "pool_concat_avgpool_grad"),
    "k8_concat_kernel": (None, "pool_concat_concat"),
}
_SYMBOL = re.compile(r"(?<![A-Za-z_])(" + "|".join(_KERNELS) + r")(<[^>]*>)?")
# the categories that are launch counters (K1's split-K sum is counted
# with its matmul)
_COUNTERS = frozenset(
    c for _, cs in _KERNELS.values() for c in ((cs,) if isinstance(cs, str) else cs)
) - {"matmul_int8 split-K sum"}
_ARG_VALUES = {"false": 0, "true": 1}

# (family, substrings of a lower-cased name), the first that matches
_FAMILIES = (
    ("memcpy", ("memcpy",)),
    ("memset", ("memset",)),
    ("cuDNN/cuBLAS", ("gemm", "cutlass", "cudnn", "cublas", "xmma", "conv", "winograd",
                      "dgrad", "wgrad", "fprop", "nchwtonhwc", "nhwctonchw", "aten::mm",
                      "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::_int_mm")),
    ("reduction", ("reduce", "softmax", "argmax", "argmin", "aten::sum", "aten::mean",
                   "aten::amax", "aten::amin", "aten::max", "aten::min", "aten::norm",
                   "aten::any", "aten::all", "aten::cumsum", "scan")),
    ("copy", ("copy", "aten::cat", "catarray", "aten::clone", "aten::contiguous",
              "aten::_to_copy", "index", "gather", "scatter", "aten::flip", "aten::pad",
              "constant_pad", "transpose")),
    ("elementwise", ("elementwise", "aten::", "fill")),
)


def category(name: str) -> str:
    """The category of an activity or an aten op (see the module docstring)."""
    m = _SYMBOL.search(name)
    if m:
        index, counter = _KERNELS[m.group(1)]
        if index is None:
            return counter
        arg = m.group(2)[1:-1].split(",")[index].strip()  # the profiler's names: <64, 0, true>
        return counter[_ARG_VALUES[arg] if arg in _ARG_VALUES else int(arg)]
    low = name.lower()
    for family, keys in _FAMILIES:
        if any(k in low for k in keys):
            return family
    return "other"


def device_events(events: Iterable, launches: Sequence[Tuple[str, int, int, str]],
                  cuda: bool) -> List[dict]:
    """The events of a torch.profiler run (`prof.events()`): on a card its
    CUDA activities, on the CPU its host ops (each with its own time), in
    the order they started, with the launch notes of ops/flops.recording
    joined to the kernels of each counter in order. Raises ValueError when
    a counter's notes and traced kernels differ in number (a kernel of
    csrc/ launched outside a counted op, or notes of calls not traced):
    the join would then give kernels another op's flops."""
    from torch.autograd import DeviceType

    picked = [e for e in events if e.device_type == (DeviceType.CUDA if cuda else DeviceType.CPU)]
    picked.sort(key=lambda e: e.time_range.start)
    cats = [category(e.name) for e in picked]
    traced = collections.Counter(c for c in cats if c in _COUNTERS)
    noted = collections.Counter(counter for counter, *_ in launches)
    if traced != noted:
        raise ValueError(f"launch notes {dict(noted)} do not match the traced kernels "
                         f"{dict(traced)}")
    notes: Dict[str, collections.deque] = collections.defaultdict(collections.deque)
    for counter, flops, nbytes, source in launches:
        notes[counter].append((flops, nbytes, source))
    out = []
    for e, cat in zip(picked, cats):
        flops, nbytes, source = notes[cat].popleft() if notes.get(cat) else (0, 0, "")
        out.append({"name": e.name, "category": cat, "start_us": float(e.time_range.start),
                    "dur_us": float(e.time_range.elapsed_us() if cuda
                                    else e.self_cpu_time_total), "flops": flops,
                    "bytes_accessed": nbytes, "source": source})
    return out


def per_op_rows(events: Iterable[dict]) -> List[dict]:
    """One row an event name: {name, category, occurrences, total_us,
    flops, bytes_accessed, source}, flops and bytes summed over its
    occurrences (the JAX rows hold one occurrence's), the largest total
    first."""
    agg: Dict[str, dict] = {}
    for ev in events:
        row = agg.setdefault(ev["name"], {
            "name": ev["name"], "category": ev["category"], "occurrences": 0,
            "total_us": 0.0, "flops": 0, "bytes_accessed": 0, "source": ""})
        row["occurrences"] += 1
        row["total_us"] += ev["dur_us"]
        row["flops"] += ev["flops"]
        row["bytes_accessed"] += ev["bytes_accessed"]
        row["source"] = row["source"] or ev["source"]
    return sorted(agg.values(), key=lambda r: -r["total_us"])


def by_category(rows: List[dict]) -> List[dict]:
    """Per-op rows collapsed into one row a category (the per-OpType view
    of the reference's Profiler::dump)."""
    agg: Dict[str, dict] = {}
    for r in rows:
        row = agg.setdefault(r["category"], {
            "category": r["category"], "ops": 0, "occurrences": 0, "total_us": 0.0,
            "flops": 0, "bytes_accessed": 0})
        row["ops"] += 1
        for key in ("occurrences", "total_us", "flops", "bytes_accessed"):
            row[key] += r[key]
    return sorted(agg.values(), key=lambda r: -r["total_us"])


def format_table(rows: List[dict], top: Optional[int] = None) -> str:
    """Render rows like the reference's per-OpType dump
    (express/Executor.cpp:60-76: name, time, %, flops)."""
    total = sum(r["total_us"] for r in rows) or 1.0
    out = [f"{'op/category':48s} {'n':>6s} {'time_us':>12s} {'%':>6s} "
           f"{'GFLOP':>10s} {'GB':>8s}  source"]
    for r in rows[: top or len(rows)]:
        name = r.get("name") or r.get("category", "?")
        out.append(
            f"{name[:48]:48s} {r['occurrences']:6d} {r['total_us']:12.1f} "
            f"{100 * r['total_us'] / total:6.1f} "
            f"{r.get('flops', 0) / 1e9:10.3f} "
            f"{r.get('bytes_accessed', 0) / 1e9:8.3f}  "
            f"{r.get('source', '')[-60:]}"
        )
    return "\n".join(out)


# data movement; everything else is compute
_COPY_CATEGORIES = frozenset(("memcpy", "memset", "copy"))


def _merged(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _union(intervals) -> float:
    return sum(e - s for s, e in _merged(intervals))


def _intersect_len(a, b) -> float:
    """Total overlap of two interval lists (each merged first)."""
    am, bm = _merged(a), _merged(b)
    i = j = 0
    total = 0.0
    while i < len(am) and j < len(bm):
        s, e = max(am[i][0], bm[j][0]), min(am[i][1], bm[j][1])
        if s < e:
            total += e - s
        if am[i][1] < bm[j][1]:
            i += 1
        else:
            j += 1
    return total


def _in_ranges(src: str, ranges) -> bool:
    """Whether a 'path:line' source falls inside one of the
    (path_substring, first_line, last_line) ranges."""
    path, _, line = src.rpartition(":")
    if not path or not line.isdigit():
        return False
    return any(p in path and lo <= int(line) <= hi for p, lo, hi in ranges)


def source_ranges_of(*funcs) -> List[Tuple[str, int, int]]:
    """(file, first_line, last_line) of each function, decorators included
    (the lines a counted op's `source` names): overlap_report's
    `fgrad_ranges` from the ops themselves, so the attribution follows the
    code."""
    out = []
    for f in funcs:
        f = inspect.unwrap(f)
        lines, start = inspect.getsourcelines(f)
        out.append((os.path.abspath(inspect.getsourcefile(f)), start, start + len(lines) - 1))
    return out


def overlap_report(events: Iterable[dict], fgrad_marker: str = "",
                   fgrad_ranges=()) -> dict:
    """Compute/copy concurrency of a device trace: every event is data
    movement (memcpy, memset, copy kernels) or compute; the union of each
    class, their intersection, and the span. Filter-grad events are those
    whose name or category holds `fgrad_marker`, or whose source lies in
    `fgrad_ranges` (see source_ranges_of); their overlap with the other
    compute and with data movement is reported too (the reference runs its
    weight-gradient DSP graph beside the CPU's other ops,
    CPUBackend.cpp:209-263)."""
    copy_iv, compute_iv, fgrad_iv, other_iv = [], [], [], []
    want_fgrad = bool(fgrad_marker or fgrad_ranges)
    for ev in events:
        iv = (ev["start_us"], ev["start_us"] + ev["dur_us"])
        if ev["category"] in _COPY_CATEGORIES:
            copy_iv.append(iv)
            continue
        compute_iv.append(iv)
        is_fgrad = want_fgrad and (
            (fgrad_marker and (fgrad_marker in ev["name"] or fgrad_marker in ev["category"]))
            or _in_ranges(ev["source"], fgrad_ranges))
        (fgrad_iv if is_fgrad else other_iv).append(iv)
    every = copy_iv + compute_iv
    copy_u, both = _union(copy_iv), _intersect_len(copy_iv, compute_iv)
    out = {
        "span_us": max(e for _, e in every) - min(s for s, _ in every) if every else 0.0,
        "busy_us": _union(every),
        "compute_union_us": _union(compute_iv),
        "copy_union_us": copy_u,
        "copy_compute_overlap_us": both,
        "copy_hidden_frac": both / copy_u if copy_u else 0.0,
        "copy_exposed_us": copy_u - both,
    }
    if want_fgrad:
        out["fgrad_union_us"] = _union(fgrad_iv)
        out["fgrad_overlap_other_compute_us"] = _intersect_len(fgrad_iv, other_iv)
        out["fgrad_overlap_copy_us"] = _intersect_len(fgrad_iv, copy_iv)
    return out
