"""A traced stretch of steps, reduced: the device's activities (kernels,
copies, fills) each with its category, and the benchmark's host spans,
on one clock; the busy union, the span, and the idle gaps, each put down
to the innermost host span open when the device ran dry."""

from __future__ import annotations

import collections
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from .categories import category

SPAN_PREFIX = "h100bench."
# the profiler's activity types of work on the device: not its device-side
# mirrors of host ranges, nor its records of synchronisations (which a
# profiler without activity types names as below)
DEVICE_WORK = frozenset(("kernel", "gpu_memcpy", "gpu_memset"))
SYNC_NAMES = frozenset(("Context Sync", "Stream Sync", "Event Sync", "Stream Wait Event"))


def _left_out(e) -> str:
    """The kind of a device record that is not work on the device, or ""."""
    if hasattr(e, "activity_type"):
        kind = e.activity_type()
        return "" if kind in DEVICE_WORK else kind
    if e.is_user_annotation() or e.name().startswith(SPAN_PREFIX):
        return "gpu_user_annotation"
    return "cuda_sync" if e.name() in SYNC_NAMES else ""


class Activity(NamedTuple):
    name: str
    category: str
    start_us: float
    end_us: float

    @property
    def dur_us(self) -> float:
        return self.end_us - self.start_us


class Stretch(NamedTuple):
    """The device activities and host spans of `steps` traced steps, and
    the count of each kind of the profiler's device records left out."""

    activities: List[Activity]
    spans: List[Tuple[str, float, float]]
    steps: int
    left_out: Dict[str, int] = {}


def from_profiler(prof, steps: int) -> Stretch:
    """The stretch a torch.profiler run traced (its kineto events)."""
    from torch.autograd import DeviceType

    acts, spans, left_out = [], [], collections.Counter()
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3
        if e.device_type() == DeviceType.CUDA:
            kind = _left_out(e)
            if kind:
                left_out[kind] += 1
            else:
                acts.append(Activity(e.name(), category(e.name()), start, end))
        elif e.name().startswith(SPAN_PREFIX):
            spans.append((e.name()[len(SPAN_PREFIX):], start, end))
    acts.sort(key=lambda a: a.start_us)
    return Stretch(acts, spans, steps, dict(left_out))


def merged(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_us(st: Stretch) -> float:
    return sum(e - s for s, e in merged((a.start_us, a.end_us) for a in st.activities))


def span_us(st: Stretch) -> float:
    if not st.activities:
        return 0.0
    return max(a.end_us for a in st.activities) - st.activities[0].start_us


def gaps(st: Stretch) -> List[Tuple[float, float]]:
    busy = merged((a.start_us, a.end_us) for a in st.activities)
    return [(a[1], b[0]) for a, b in zip(busy, busy[1:])]


def owner(t: float, spans: Sequence[Tuple[str, float, float]]) -> str:
    """The innermost host span open at time t, or "no span"."""
    open_ = [(s, name) for name, s, e in spans if s <= t < e]
    return max(open_)[1] if open_ else "no span"


def idle_by_span(st: Stretch) -> List[Tuple[str, float]]:
    """Idle seconds of the stretch by the host span open as each gap began,
    the largest first."""
    out: Dict[str, float] = collections.defaultdict(float)
    for g0, g1 in gaps(st):
        out[owner(g0, st.spans)] += (g1 - g0) / 1e6
    return sorted(out.items(), key=lambda kv: -kv[1])


def device_by_category(st: Stretch) -> List[Tuple[str, float]]:
    """Device seconds of the stretch by category, the largest first."""
    out: Dict[str, float] = collections.defaultdict(float)
    for a in st.activities:
        out[a.category] += a.dur_us / 1e6
    return sorted(out.items(), key=lambda kv: -kv[1])


def breakdown(st: Stretch, top: int = 10) -> Optional[dict]:
    if not st.activities:
        return None
    return {"device_ops": [[n, s] for n, s in device_by_category(st)[:top]],
            "idle_gaps": [[n, s] for n, s in idle_by_span(st)[:top]]}
