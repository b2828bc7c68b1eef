"""Generic dataflow-region walker for model importers.

Turns an arbitrary single-input/single-output op DAG into the NITI layer
tree (`Sequential` chains with `ResidualBlock` / `ParallelAdd` /
`ParallelConcat` at fan-outs) — the structural core of the reference's
whole-graph `turnModelToTrainable` rewrite
(`tools/train/source/transformer/Transformer.cpp:69`), shared by the ONNX
and TFLite importers (`utils/onnx_model.py`, `utils/tflite_model.py`).

Region construction: at a fan-out tensor t, the join is the nearest common
post-dominator of all paths t -> end; each activation input of the join is
a branch built by recursing on the (t -> input) region. Handles arbitrary
nesting (concat inside a residual branch, staggered adds).

The importer supplies a `GraphOps` adapter:
  - consumers(t)      -> list of nodes consuming tensor t as an activation
  - act_inputs(node)  -> list of activation input tensors
  - outputs(node)     -> list of output tensors
  - convert_node(node, st, layers, params) -> output tensor (converts one
    single-activation-input node, mutating the shape state `st` — any
    object with .copy() and .c/.h/.w attributes — and the layer/param
    lists; may consume lookahead nodes, e.g. BN folding)
  - join_kind(node)   -> "add" | "concat" | None

The port's own copy of ``mandheling_tpu/utils/graph_import.py``, over the
port's `Sequential` and blocks; `live_params` gives an imported model's
weights in the JAX package's params layout.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..device import resolve_device
from ..nn.blocks import ParallelAdd, ParallelConcat, ProjectedResidualBlock, ResidualBlock
from ..nn.module import Sequential
from ..ops.qtensor import QTensor
from .jax_params import load_jax_params


class RegionWalker:
    def __init__(self, ops):
        self.ops = ops
        self._reach_memo: Dict[Tuple[int, object], bool] = {}

    # ------------------------------------------------------- reachability

    def _node_reaches(self, node, name) -> bool:
        """True if `node` produces tensor `name` or any successor does."""
        key = (id(node), name)
        memo = self._reach_memo
        if key in memo:
            return memo[key]
        memo[key] = False  # cycle guard (graphs are DAGs, but be safe)
        if name in self.ops.outputs(node):
            memo[key] = True
            return True
        for out in self.ops.outputs(node):
            for succ in self.ops.consumers(out):
                if self._node_reaches(succ, name):
                    memo[key] = True
                    return True
        return memo[key]

    def _nearest_common_pdom(self, cons, end):
        """Nearest node through which every path from each node in `cons`
        to the producer of `end` passes (post-dominator sets over the
        region, intersected across the fan-out's consumers)."""
        region: List = []
        seen = set()
        stack = list(cons)
        while stack:
            n = stack.pop()
            if id(n) in seen or not self._node_reaches(n, end):
                continue
            seen.add(id(n))
            region.append(n)
            for out in self.ops.outputs(n):
                for succ in self.ops.consumers(out):
                    stack.append(succ)
        order: List = []
        marked = set()

        def visit(n):
            if id(n) in marked or id(n) not in seen:
                return
            marked.add(id(n))
            for out in self.ops.outputs(n):
                for succ in self.ops.consumers(out):
                    visit(succ)
            order.append(n)  # appended after successors: reverse topo

        for n in region:
            visit(n)
        topo_idx = {id(n): i for i, n in enumerate(reversed(order))}
        pdom: Dict[int, set] = {}
        for n in order:  # successors first
            succs = [
                s
                for out in self.ops.outputs(n)
                for s in self.ops.consumers(out)
                if id(s) in seen
            ]
            if end in self.ops.outputs(n) or not succs:
                pdom[id(n)] = {id(n)}
                continue
            inter = set(pdom[id(succs[0])])
            for s in succs[1:]:
                inter &= pdom[id(s)]
            inter.add(id(n))
            pdom[id(n)] = inter
        common = None
        for n in cons:
            s = pdom.get(id(n), set())
            common = set(s) if common is None else common & s
        common = common or set()
        common -= {
            id(n) for n in cons if len(self.ops.act_inputs(n)) == 1
        }
        if not common:
            raise ValueError(
                "fan-out branches do not reconverge before the output — "
                "unsupported topology"
            )
        by_id = {id(n): n for n in region}
        join_id = min(common, key=lambda i: topo_idx[i])
        return by_id[join_id]

    # ----------------------------------------------------------- building

    def build_segment(self, t, end, st, layers: List, params: List) -> None:
        """Convert every node on the paths from tensor `t` to tensor `end`
        (inclusive of the node producing `end`)."""
        while t != end:
            cons = [
                n
                for n in self.ops.consumers(t)
                if self._node_reaches(n, end)
            ]
            if not cons:
                raise ValueError(
                    f"no path from tensor {t!r} to {end!r} — malformed "
                    "graph or a join input that does not derive from the "
                    "fan-out tensor"
                )
            if len(cons) == 1 and len(self.ops.act_inputs(cons[0])) == 1:
                t = self.ops.convert_node(cons[0], st, layers, params)
                continue
            t = self._convert_fanout(t, end, cons, st, layers, params)

    def _convert_fanout(self, t, end, cons, st,
                        layers: List, params: List):
        join = self._nearest_common_pdom(cons, end)
        kind = self.ops.join_kind(join)
        if kind is None:
            raise ValueError(
                f"unsupported join op at fan-out (expected Add/Concat)"
            )
        ordered = []
        for name in self.ops.act_inputs(join):
            if name == t:
                ordered.append(([], [], st.copy()))
                continue
            bl: List = []
            bp: List = []
            bst = st.copy()
            self.build_segment(t, name, bst, bl, bp)
            ordered.append((bl, bp, bst))

        if kind == "add":
            if len(ordered) != 2:
                raise ValueError("Add join must have exactly 2 inputs")
            (l0, p0, s0), (l1, p1, s1) = ordered
            if (s0.c, s0.h, s0.w) != (s1.c, s1.h, s1.w):
                raise ValueError("Add branches disagree on shape")
            if not l1:  # identity skip -> classic residual
                layers.append(ResidualBlock(Sequential(l0)))
                params.append(p0)
            elif not l0:
                layers.append(ResidualBlock(Sequential(l1)))
                params.append(p1)
            else:
                layers.append(ParallelAdd([Sequential(l0), Sequential(l1)]))
                params.append([p0, p1])
            st.c, st.h, st.w = s0.c, s0.h, s0.w
        else:  # concat
            hw = {(s.h, s.w) for _, _, s in ordered}
            if len(hw) != 1:
                raise ValueError("Concat branches disagree on spatial shape")
            layers.append(
                ParallelConcat([Sequential(bl) for bl, _, _ in ordered])
            )
            params.append([bp for _, bp, _ in ordered])
            st.c = sum(s.c for _, _, s in ordered)
            st.h, st.w = next(iter(hw))
        return self.ops.outputs(join)[0]


# ------------------------------------------------------- the port's model


def live_params(model) -> List[Any]:
    """The model's weights in the JAX params layout ({"w": QTensor} per
    weighted layer, () otherwise, nested lists for blocks), as QTensors of
    the weight buffers themselves: they follow the model through training."""
    out: List[Any] = []
    for layer in model.layers:
        if isinstance(layer, ProjectedResidualBlock):
            out.append({"branch": live_params(layer.branch),
                        "proj": {"w": QTensor(layer.proj.w, layer.proj.w_exp)}})
        elif isinstance(layer, ResidualBlock):
            out.append(live_params(layer.branch))
        elif isinstance(layer, Sequential):
            out.append(live_params(layer))
        elif isinstance(layer, (ParallelAdd, ParallelConcat)):
            out.append([live_params(branch) for branch in layer.branches])
        elif hasattr(layer, "w"):
            out.append({"w": QTensor(layer.w, layer.w_exp)})
        else:
            out.append(())
    return out


def finish_model(layers: List, params: List,
                 device: Optional[Union[str, torch.device]] = None):
    """-> (model, params): the walked layer tree as a `Sequential` holding
    the imported weights, on `device` (the card unless the caller asks for
    the CPU), and its `live_params`."""
    device = resolve_device(device)
    model = load_jax_params(Sequential(layers), params).to(device)
    return model, live_params(model)
