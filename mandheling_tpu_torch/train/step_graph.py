"""The compiled step: a whole step function captured as CUDA graphs and
replayed (the port of `jax.jit` over a step: `jit_train_step` /
`jit_eval_step`, ``mandheling_tpu/train/train_step.py:118-125``, and the
trainer's jitted float steps; the reference's `NITIDSPInt8Train` runs one
prepared DSP graph per iteration).

:func:`compile_step` returns the step itself on the CPU, where it runs
eagerly (the kernels' plain versions), and a :class:`CompiledStep` on a
CUDA device:

- One graph per signature: the shapes and dtypes of the arguments, and the
  dispatch settings a step reads while it is captured (:func:`settings`).
  A change of any of them captures a new graph; a stale one is never
  replayed.
- The first call of a signature is the warm-up: it copies its arguments
  into new static inputs, runs the step eagerly on the capture stream (the
  kernels build at first use, and their per-stream state and caches are
  made there, ``ops/kernels/stream_state.py``), then captures it on that
  stream, and returns the eager call's result. Every later call copies its
  arguments into the static inputs and replays the graph on the current
  stream, and returns a clone of the outputs, which the next replay does
  not overwrite (as a jitted call returns fresh arrays). Replays run in the
  order of the stream they are issued on.
- A graph reads and writes the step's state where it lies: params,
  optimizer state and running stats are written in place (the JAX step's
  donated params). A step that replaced them could not be replayed.
- A capture that fails raises. A CUDA device has no eager fallback.
- A step that draws random numbers (dropout) names its generators in
  `fn.generators`: CUDA generators of the step's device, registered with
  every graph (`CUDAGraph.register_generator_state`). A capture draws
  nothing from them; each replay draws from the generator's offset at that
  moment and advances it as the eager call would, so replay i draws what
  eager call i would have drawn from the same seed.
- The kernels count their launches in Python (``ops/kernels.launch_counts``),
  which a replay does not run. The replay hooks (:func:`replay_hook`) make
  up for it: the launches a capture counted are taken back, and added again
  at every replay, so the counts stay launches executed. So are the launch
  notes the profiler reads (ops/flops.py), in the same hook.
- Spans and counters (utils/spans.py, recorded only inside
  `profiler.spans`): `step.call` around every call, with device marks from
  the replay's first copy-in to its last clone; `step.capture` (warm-up and
  capture) and counter `step.captures`; inside a replay `step.copy_in`,
  `step.replay` (the `CUDAGraph.replay()` call alone), `step.hooks` and
  `step.clone`, counter `step.replays`, and counter `step.graph_kernels`,
  the kernel nodes of the replayed graph, counted once when it is captured
  (:func:`graph_kernels`).
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Any, Callable, Dict, List, Tuple

import torch

from ..ops import conv as conv_ops
from ..ops import depthwise as dw_ops
from ..ops import flops
from ..ops import kernels
from ..utils.spans import count, span


def settings() -> Tuple:
    """The dispatch settings a step reads at capture time: the kernel
    backend, the fused conv mode, the dense and depthwise filter-grad
    margins, and for the float steps TF32 in cuDNN and cuBLAS and cuDNN's
    deterministic algorithms."""
    return (kernels.get_backend(), conv_ops.get_fused_conv_mode(), conv_ops.get_fgrad_margin(),
            dw_ops.get_dw_fgrad_margin(), torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.deterministic)


class LaunchCounts:
    """The replay hook of the kernels' launch counters and of the launch
    notes of ops/flops.py."""

    def begin(self):
        return kernels.launch_counts(), flops.hold_launches()

    def end(self, token) -> Tuple[Dict[str, int], List[flops.Launch]]:
        before, held = token
        after = kernels.launch_counts()
        delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        kernels.add_launch_counts({k: -n for k, n in delta.items()})
        return delta, flops.take_launches(held)

    def replay(self, made: Tuple[Dict[str, int], List[flops.Launch]]) -> None:
        delta, notes = made
        kernels.add_launch_counts(delta)
        flops.add_launches(notes)


_HOOKS: List[Any] = [LaunchCounts()]


@contextlib.contextmanager
def replay_hook(hook):
    """While inside, `hook` sees every capture and replay: hook.begin()
    before a capture returns a token; hook.end(token) after it takes back
    what the capture counted on the host and returns it; hook.replay(that)
    runs at every replay of that graph while the hook is in place."""
    _HOOKS.append(hook)
    try:
        yield hook
    finally:
        _HOOKS.remove(hook)


_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _streams(device: torch.device):
    """(the current stream, the capture stream) of `device`: one capture
    stream a device, so the kernels' per-stream state of every graph is
    made once."""
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return torch.cuda.current_stream(device), _STREAMS[device]


def _warm_up(stream, fn: Callable, args: Tuple):
    with torch.cuda.stream(stream):
        return fn(*args)


# libcuda's node types (CUgraphNodeType) that graph_kernels reads
_KERNEL_NODE, _CHILD_GRAPH_NODE = 0, 4


def _libcuda():
    """libcuda's graph queries, their argument types declared."""
    lib = ctypes.CDLL("libcuda.so.1")
    ptr, out = ctypes.c_void_p, ctypes.POINTER
    lib.cuGraphGetNodes.argtypes = [ptr, ptr, out(ctypes.c_size_t)]
    lib.cuGraphNodeGetType.argtypes = [ptr, out(ctypes.c_int)]
    lib.cuGraphChildGraphNodeGetGraph.argtypes = [ptr, out(ptr)]
    for f in (lib.cuGraphGetNodes, lib.cuGraphNodeGetType, lib.cuGraphChildGraphNodeGetGraph):
        f.restype = ctypes.c_int
    return lib


def _check(status: int) -> None:
    if status != 0:
        raise RuntimeError(f"a libcuda graph query failed with CUresult {status}")


def graph_kernels(graph: int, lib=None) -> int:
    """The kernel nodes of a captured `cudaGraph_t` (its handle as an int,
    `CUDAGraph.raw_cuda_graph()`), those of child graphs included, read
    through libcuda."""
    lib = lib or _libcuda()
    n = ctypes.c_size_t(0)
    _check(lib.cuGraphGetNodes(graph, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    _check(lib.cuGraphGetNodes(graph, nodes, ctypes.byref(n)))
    kind, child, total = ctypes.c_int(0), ctypes.c_void_p(), 0
    for node in nodes[:n.value]:
        _check(lib.cuGraphNodeGetType(node, ctypes.byref(kind)))
        if kind.value == _KERNEL_NODE:
            total += 1
        elif kind.value == _CHILD_GRAPH_NODE:
            _check(lib.cuGraphChildGraphNodeGetGraph(node, ctypes.byref(child)))
            total += graph_kernels(child.value, lib)
    return total


def _new_graph():
    return torch.cuda.CUDAGraph(keep_graph=True)


def _capture(graph, stream, fn: Callable, args: Tuple):
    """fn(*args) captured into `graph` on `stream`; its kernel nodes are
    counted into `graph.kernels` before it is instantiated."""
    with torch.cuda.graph(graph, stream=stream):
        out = fn(*args)
    graph.kernels = graph_kernels(graph.raw_cuda_graph())
    graph.instantiate()
    return out


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (tuple, list)):
        return type(out)(_clone(o) for o in out)
    return out


def _generators(fn: Callable, device: torch.device) -> Tuple[torch.Generator, ...]:
    """The generators `fn` draws from (`fn.generators`), each on `device`."""
    gens = tuple(getattr(fn, "generators", ()))
    for g in gens:
        at = g.device
        if at.type != device.type or (None not in (at.index, device.index)
                                      and at.index != device.index):
            raise ValueError(f"a step captured on {device} cannot draw from a generator on {at}")
    return gens


class _Graph:
    """One captured signature: static inputs, the graph, its outputs and
    what the hooks recorded at its capture."""

    def __init__(self, fn: Callable, args: Tuple, device: torch.device):
        gens = _generators(fn, device)
        current, stream = _streams(device)
        with span("step.capture"):
            self.inputs = tuple(torch.empty(a.shape, dtype=a.dtype, device=device)
                                for a in args)
            self._copy_in(args)
            stream.wait_stream(current)
            first = _warm_up(stream, fn, self.inputs)
            tokens = [(hook, hook.begin()) for hook in _HOOKS]
            self.graph = _new_graph()
            for g in gens:
                self.graph.register_generator_state(g)
            try:
                self.outputs = _capture(self.graph, stream, fn, self.inputs)
            finally:
                self.recorded = [(hook, hook.end(token)) for hook, token in tokens]
            current.wait_stream(stream)
            self.first = _clone(first)
        count("step.captures")
        # what _capture counted (a graph it did not count reads 0)
        self.kernels = getattr(self.graph, "kernels", 0)

    def _copy_in(self, args: Tuple) -> None:
        for dst, src in zip(self.inputs, args):
            dst.copy_(src, non_blocking=True)

    def replay(self, args: Tuple):
        with span("step.copy_in"):
            self._copy_in(args)
        with span("step.replay"):
            self.graph.replay()
        with span("step.hooks"):
            for hook, recorded in self.recorded:
                if any(h is hook for h in _HOOKS):
                    hook.replay(recorded)
        count("step.replays")
        count("step.graph_kernels", self.kernels)
        with span("step.clone"):
            return _clone(self.outputs)


class CompiledStep:
    """`fn` captured once per signature on `device` and replayed (see the
    module docstring). Its arguments are tensors (on the host or the
    device); it returns what `fn` returns, a tensor or a tuple of them."""

    def __init__(self, fn: Callable, device):
        self.fn = fn
        self.device = torch.device(device)
        self._graphs: Dict[Tuple, _Graph] = {}

    def __call__(self, *args: torch.Tensor):
        with span("step.call") as call:
            key = tuple((tuple(a.shape), a.dtype) for a in args) + settings()
            graph = self._graphs.get(key)
            if graph is None:
                graph = self._graphs[key] = _Graph(self.fn, args, self.device)
                out, graph.first = graph.first, None
                return out
            with call.device():
                return graph.replay(args)

    @property
    def graphs(self) -> int:
        """The signatures captured so far."""
        return len(self._graphs)


def compile_step(fn: Callable, device):
    """`fn` as one device program per signature: a :class:`CompiledStep`
    on a CUDA device; on the CPU `fn` itself, run eagerly."""
    device = torch.device(device)
    return CompiledStep(fn, device) if device.type == "cuda" else fn
