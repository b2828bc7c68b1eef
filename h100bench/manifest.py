"""`BENCHMARK.json` and the files it names: a cell's configuration
(configs/<config>.json), its traffic (traffic/<traffic>.json), its own
file (workloads/<cell>.json: the limits of its correctness numbers and the
steps its trace covers), the reference's network family a configuration
names (families/<family>.py), and one reader a per-layer metric
(metrics/<metric>.py, a function read(run) -> number or None). The harness
finds every one of them by the name in `BENCHMARK.json`, so a cell, a
configuration, a traffic mix or a metric is added as files alone."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    """The cell `name` with its configuration, traffic and own file:
    {"entry", "config", "traffic", "cell"}."""
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    config = [c for c in bench["configs"] if c["name"] == entry["config"]][0]
    return {"entry": entry,
            "config": load_json(ROOT / config["file"]),
            "traffic": load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
            "cell": load_json(HERE / "workloads" / f"{name}.json")}


def metrics_of(bench: dict, kind: str, name: str) -> List[dict]:
    """The `kind` ("end_to_end" or "per_layer") metrics that cell `name`
    reports."""
    return [m for m in bench[kind] if "workloads" not in m or name in m["workloads"]]


def reader(metric: str) -> Callable:
    """read(run) of metrics/<metric>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"h100bench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def problems(bench: dict, root: Path = ROOT) -> List[str]:
    """What in `bench` and its files breaks the benchmark's rules (empty when
    nothing does)."""
    out: List[str] = []
    names = ([c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    out += [f"bad name {n!r}" for n in names if not NAME.match(n)]
    for kind in ("configs", "workloads"):
        seen = [x["name"] for x in bench[kind]]
        out += [f"{kind}: {n!r} twice" for n in set(seen) if seen.count(n) > 1]
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    out += [f"metric {n!r} twice" for n in set(metric_names) if metric_names.count(n) > 1]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not UNIT.match(m["unit"]) or m["better"] not in ("lower", "higher"):
            out.append(f"metric {m['name']!r}: unit or better")
        out += [f"metric {m['name']!r}: unknown cell {w!r}" for w in m.get("workloads", [])
                if w not in cells]
    out += [f"end-to-end {n!r}: source" for n, m in e2e.items()
            if m["source"] not in ("host_clock", "device_trace")]
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in bench["per_layer"]:
        target = e2e.get(m["moves"])
        if target is None:
            out.append(f"per-layer {m['name']!r} moves unknown {m['moves']!r}")
            continue
        for w in m.get("workloads", list(cells)):
            if w in cells and m["moves"] not in [x["name"] for x in
                                                 metrics_of(bench, "end_to_end", w)]:
                out.append(f"per-layer {m['name']!r} in {w!r}, which lacks {m['moves']!r}")
        if not (root / "h100bench" / "metrics" / f"{m['name']}.py").exists():
            out.append(f"per-layer {m['name']!r}: no reader")
    configs = {c["name"]: c for c in bench["configs"]}
    for name, w in cells.items():
        if w["config"] not in configs:
            out.append(f"cell {name!r}: unknown config")
        for path in (root / "h100bench" / "traffic" / f"{w['traffic']}.json",
                     root / "h100bench" / "workloads" / f"{name}.json"):
            if not path.exists():
                out.append(f"cell {name!r}: missing {path.relative_to(root)}")
        if len(metrics_of(bench, "end_to_end", name)) < 2 or not metrics_of(bench, "per_layer",
                                                                             name):
            out.append(f"cell {name!r}: reports too few metrics")
    for c in configs.values():
        if not (root / c["file"]).exists():
            out.append(f"config {c['name']!r}: missing {c['file']}")
        else:
            family = load_json(root / c["file"])["reference"]["family"]
            if not (root / "h100bench" / "families" / f"{family}.py").exists():
                out.append(f"config {c['name']!r}: no reference family {family!r}")
        if not any(w["config"] == c["name"] for w in cells.values()):
            out.append(f"config {c['name']!r}: no cell")
    return out
