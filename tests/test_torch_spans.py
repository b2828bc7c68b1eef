"""The port's span recorder (utils/spans.py) on the CPU: off it leaves
nothing behind; on, the loader's spans nest, name their parents, threads
and steps; the two-anchor clock map takes out an offset and a drift; a
Chrome trace round-trips; the libcuda kernel count walks child graphs.
The compiled step's spans are in test_torch_jit_step.py, the device marks
on the card in test_torch_cuda.py."""

import ctypes
import json
import threading

import numpy as np
import pytest
import torch

from mandheling_tpu_torch.data.loader import DataLoader, onehot_padded, to_device
from mandheling_tpu_torch.train import step_graph
from mandheling_tpu_torch.utils import profiler
from mandheling_tpu_torch.utils import spans as sp

CPU = torch.device("cpu")


def _loader(n=10, batch=2):
    x = np.arange(n * 4, dtype=np.uint8).reshape(n, 2, 2, 1)
    return DataLoader(x, np.arange(n) % 3, batch, seed=1)


def _train(dl):
    """One epoch fed as train_niti feeds its step, the step a span."""
    for bx, by in dl.epoch():
        with profiler.span("step.call"):
            onehot_padded(by, 3, 4)
            to_device(bx, CPU)


def test_off_leaves_nothing_behind():
    assert sp._REC is None
    site = profiler.span("loader.wait")
    assert site is sp._OFF and profiler.span("step.call") is site
    with site as inner, inner.device() as dev:
        assert dev is site
    profiler.count("loader.h2d_bytes", 5)
    _train(_loader())
    assert sp._REC is None


def test_loader_spans_nest_and_carry_threads_and_steps():
    with profiler.spans(CPU) as rec:
        _train(_loader())
    assert sp._REC is None
    names = [s.name for s in rec.spans]
    assert names.count("loader.epoch_start") == 1 and names.count("loader.gather") == 5
    assert names.count("loader.wait") == 5  # after each of 5 batches, the last one the end
    calls = [s for s in rec.spans if s.name == "step.call"]
    assert rec.steps == 5 and [s.step for s in calls] == [1, 2, 3, 4, 5]
    by_id = {s.id: s for s in rec.spans}
    main = threading.current_thread().name
    for s in rec.spans:
        if s.name in ("loader.onehot", "loader.to_device"):
            parent = by_id[s.parent]
            assert parent.name == "step.call" and s.step == parent.step
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        elif s.name == "loader.gather":  # the worker's own thread, its own stack
            assert s.thread == "loader" and s.parent is None
        else:
            assert s.thread == main and s.parent is None
    waits = [s.step for s in rec.spans if s.name == "loader.wait"]
    assert waits == [1, 2, 3, 4, 5]  # each waits for the batch after step k
    assert [s.start_ns for s in rec.spans] == sorted(s.start_ns for s in rec.spans)
    assert rec.intervals == [] and rec.drift_ns is None and rec.counters == {}


def test_one_recording_at_a_time():
    with profiler.spans(CPU) as rec:
        with pytest.raises(RuntimeError, match="already open"):
            with profiler.spans(CPU):
                pass
        with profiler.span("a"):
            profiler.count("n", 2)
            profiler.count("n")
    assert rec.counters == {"n": 3} and [s.name for s in rec.spans] == ["a"]
    with profiler.spans(CPU) as again:
        pass
    assert again.spans == [] and sp._REC is None


def test_an_error_inside_closes_the_recording():
    with pytest.raises(ValueError):
        with profiler.spans(CPU):
            raise ValueError("inside")
    assert sp._REC is None and profiler.span("a") is sp._OFF


class FakeEvent:
    """An event the device completed at `ms` on its own clock."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


@pytest.mark.parametrize("drift_ns", [0, 50_000, -30_000])
def test_the_clock_map_takes_out_offset_and_drift(drift_ns):
    host0 = 7_000_000_000
    clock = sp._ClockMap((FakeEvent(250.0), host0),
                         (FakeEvent(1250.0), host0 + 1_000_000_000 + drift_ns))
    assert clock.drift_ns == pytest.approx(drift_ns)
    assert clock(FakeEvent(250.0)) == host0
    assert clock(FakeEvent(750.0)) == pytest.approx(host0 + 500_000_000 + drift_ns / 2, abs=1)
    assert clock(FakeEvent(1250.0)) == pytest.approx(host0 + 1_000_000_000 + drift_ns, abs=1)


def test_marks_resolve_to_intervals_and_a_lead():
    rec = sp._Recorder(CPU)
    host0 = 1_000_000
    clock = sp._ClockMap((FakeEvent(0.0), host0), (FakeEvent(10.0), host0 + 10_000_000))
    # span 3 recorded its marks at +1.000 and +2.000 ms, the device ran them
    # at +1.005 and +4.000; span 5's start mark resolves 3 us before its
    # record call
    rec.marks = [(3, "step.call", sp._Mark(host0 + 1_000_000, FakeEvent(1.005)),
                  sp._Mark(host0 + 2_000_000, FakeEvent(4.0))),
                 (5, "loader.to_device", sp._Mark(host0 + 6_003_000, FakeEvent(6.0)),
                  sp._Mark(host0 + 6_100_000, FakeEvent(6.5)))]
    out = sp.Record()
    sp._resolve(rec, out, clock)
    assert out.intervals == [sp.Interval(3, "step.call", host0 + 1_005_000, host0 + 4_000_000),
                             sp.Interval(5, "loader.to_device", host0 + 6_000_000,
                                         host0 + 6_500_000)]
    assert out.lead_ns == 3_000 and out.drift_ns == 0


def test_write_chrome_round_trip(tmp_path):
    with profiler.spans(CPU) as rec:
        _train(_loader(6))
        profiler.count("step.replays", 3)
    rec.intervals = [sp.Interval(rec.spans[-1].id, "step.call", rec.spans[-1].start_ns + 2_000,
                                 rec.spans[-1].start_ns + 9_000)]
    path = tmp_path / "trace.json"
    rec.write_chrome(str(path))
    doc = json.loads(path.read_text())
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X" and e["pid"] == 0]
    device = [e for e in doc["traceEvents"] if e["ph"] == "X" and e["pid"] == 1]
    threads = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
               if e["name"] == "thread_name"}
    t0 = rec.spans[0].start_ns
    assert len(spans) == len(rec.spans)
    for e, s in zip(spans, rec.spans):
        assert e["name"] == s.name and threads[e["tid"]] == s.thread
        assert e["ts"] == pytest.approx((s.start_ns - t0) / 1e3)
        assert e["dur"] == pytest.approx((s.end_ns - s.start_ns) / 1e3)
        assert e["args"] == {"id": s.id, "parent": s.parent, "step": s.step}
    assert [(e["name"], e["dur"]) for e in device] == [("step.call", 7.0)]
    assert set(threads.values()) == {threading.current_thread().name, "loader"}
    assert doc["otherData"]["counters"] == {"step.replays": 3}
    assert doc["otherData"]["steps"] == 3


class FakeLibcuda:
    """libcuda's three graph queries over a graph table: handle -> node
    handles, node -> (type, child graph)."""

    def __init__(self, graphs, nodes):
        self.graphs, self.nodes = graphs, nodes

    def cuGraphGetNodes(self, graph, out, n):
        have = self.graphs[graph]
        if out is not None:
            for i, node in enumerate(have[:n._obj.value]):
                out[i] = node
        n._obj.value = len(have)
        return 0

    def cuGraphNodeGetType(self, node, kind):
        kind._obj.value = self.nodes[node][0]
        return 0

    def cuGraphChildGraphNodeGetGraph(self, node, child):
        child._obj.value = self.nodes[node][1]
        return 0


def test_graph_kernels_counts_kernel_nodes_and_child_graphs():
    # graph 100: 3 kernels, a memcpy (1), a memset (2), an event record (7)
    # and a child graph (4) of 2 kernels and an empty node (5)
    nodes = {1: (0, None), 2: (0, None), 3: (1, None), 4: (2, None), 5: (0, None),
             6: (7, None), 7: (4, 200), 8: (0, None), 9: (5, None), 10: (0, None)}
    lib = FakeLibcuda({100: [1, 2, 3, 4, 5, 6, 7], 200: [8, 9, 10]}, nodes)
    assert step_graph.graph_kernels(100, lib) == 5
    assert step_graph.graph_kernels(200, lib) == 2
    lib.cuGraphNodeGetType = lambda node, kind: 700
    with pytest.raises(RuntimeError, match="CUresult 700"):
        step_graph.graph_kernels(100, lib)


def test_the_libcuda_queries_declare_their_types(monkeypatch):
    """_libcuda() declares argtypes and restype of each query it binds."""
    class Lib:
        def __init__(self, name):
            self.name = name
            for f in ("cuGraphGetNodes", "cuGraphNodeGetType", "cuGraphChildGraphNodeGetGraph"):
                setattr(self, f, type("F", (), {})())

    monkeypatch.setattr(ctypes, "CDLL", Lib)
    lib = step_graph._libcuda()
    assert lib.name == "libcuda.so.1"
    for f in (lib.cuGraphGetNodes, lib.cuGraphNodeGetType, lib.cuGraphChildGraphNodeGetGraph):
        assert f.restype is ctypes.c_int and len(f.argtypes) in (2, 3)
