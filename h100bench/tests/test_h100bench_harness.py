"""The harness on the CPU: the metric arithmetic on hand-made traces, the
manifest's rules, that nothing of JAX is imported or loaded, that a sound
run comes out correct, and that the control and every fault a training
cell can have come out not correct."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from h100bench import categories, control, judge, manifest, run, trace

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "mandheling_tpu"}


def _stretch():
    a = trace.Activity
    acts = [a("void matmul_kmajor_kernel<64, 0, false>(x)", "matmul_int8", 0.0, 10.0),
            a("void at::native::vectorized_elementwise_kernel<4>", "elementwise", 5.0, 20.0),
            a("Memcpy HtoD (Pinned -> Device)", "memcpy", 30.0, 34.0),
            a("void dw3x3_kernel<64, 2>(y)", "fused_dwconv_requant", 50.0, 60.0)]
    spans = [("trainer", 18.0, 32.0), ("step", 40.0, 55.0), ("wait", 41.0, 45.0)]
    return trace.Stretch(acts, spans, 2)


def _info(st, **kw):
    base = dict(window_steps=10, window_s=2.0, trainer_s=[0.001, 0.003], step_s=[0.002],
                step_ops=10**12, peak_ops=2e15, bound_s=1e-5, stretch=st)
    base.update(kw)
    return run.RunInfo(**base)


def test_busy_span_gaps_and_owners():
    st = _stretch()
    assert trace.busy_us(st) == 20 + 4 + 10
    assert trace.span_us(st) == 60
    assert trace.gaps(st) == [(20.0, 30.0), (34.0, 50.0)]
    assert trace.owner(20.0, st.spans) == "trainer"
    assert trace.owner(42.0, st.spans) == "wait"  # the innermost open span
    assert trace.owner(100.0, st.spans) == "no span"
    assert trace.idle_by_span(st) == [("no span", 16e-6), ("trainer", 10e-6)]
    bd = trace.breakdown(st)
    assert bd["device_ops"][0] == ["elementwise", 15e-6]
    assert trace.breakdown(trace.Stretch([], [], 1)) is None


def test_readers():
    st = _stretch()
    read = {m["name"]: manifest.reader(m["name"])(_info(st))
            for m in manifest.benchmark()["per_layer"]}
    assert read["trainer.host_ms_per_step"] == pytest.approx(2.0)
    assert read["step.host_ms_per_step"] == pytest.approx(2.0)
    assert read["step.mfu"] == pytest.approx(100 * 1e12 * 10 / 2.0 / 2e15)
    assert read["ops.torch_ms_per_step"] == pytest.approx((15 + 4) / 1e3 / 2)
    assert read["ops.launches_per_step"] == 3 / 2
    assert read["kernels.csrc_ms_per_step"] == pytest.approx(20 / 1e3 / 2)
    assert read["kernels.contraction_roofline"] == pytest.approx(100 * 1e-5 / (34e-6 / 2))
    assert read["device.idle_share"] == pytest.approx(100 * (1 - 34 / 60))
    # nothing to read: no peak, no trace, no hand-written kernel
    for name in ("step.mfu", "kernels.contraction_roofline"):
        assert manifest.reader(name)(_info(st, peak_ops=None, bound_s=None)) is None
    for m in manifest.benchmark()["per_layer"]:
        if m["source"] == "device_trace" and m["name"] != "step.mfu":  # mfu reads the window
            assert manifest.reader(m["name"])(_info(None)) is None
    only_torch = trace.Stretch(st.activities[1:3], [], 1)
    assert manifest.reader("kernels.csrc_ms_per_step")(_info(only_torch)) is None


def test_the_window_runs_from_the_warm_ups_last_mark_to_its_own_last():
    from h100bench.loop import Marks

    marks = Marks(torch.device("cpu"))
    marks.events += [1.0, 1.5, 1.75, 2.5]
    assert marks.seconds(1) == pytest.approx(1.0)
    assert marks.intervals_ms(1) == pytest.approx([250.0, 750.0])
    assert sum(marks.intervals_ms(1)) == pytest.approx(1e3 * marks.seconds(1))


def test_the_faults_are_planted_around_a_plain_reference():
    import numpy as np

    fed = [(np.zeros((4, 2)), np.ones((4, 3))), (np.zeros((1, 2)), np.ones((1, 3)))]
    assert [(len(x), len(o)) for x, o in control.half(fed)] == [(2, 2), (1, 1)]


def test_percentile_and_categories():
    assert run.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    assert categories.category("void matmul_mnmajor_kernel<128, true>(z)") == "matmul_int16a"
    assert categories.category("void conv_ring_kernel<3, 1, 2>(z)") == "fused_conv_requant"
    assert categories.category("fgrad3x3_packed_kernel(z)") == "fused_dwconv_fgrad"
    assert categories.category("Memset (Device)") == "memset"
    assert categories.category("void at::native::reduce_kernel<512, 1>") == "reduction"
    assert categories.category("something else") == "other"
    assert categories.is_csrc("fused_matmul_max") and not categories.is_csrc("copy")


def test_judge():
    w = [(torch.zeros(4, dtype=torch.int8), torch.zeros((), dtype=torch.int32)),
         (torch.zeros(9, dtype=torch.int8), torch.zeros((), dtype=torch.int32))]
    moved = [(torch.tensor([1, 0, 0, 0], dtype=torch.int8), w[0][1]),
             (torch.tensor([0] * 8 + [3], dtype=torch.int8), w[1][1])]
    assert judge.worst_leaf_gap(moved, moved, w) == 0.0
    assert judge.worst_leaf_gap(w, moved, w) == 1.0  # a state left unchanged
    assert judge.differ(moved, w) == 2
    n = judge.readings([2.0, 1.0, 1.0], [2.0, 1.0, 0.5], w, moved, moved, moved, moved)
    assert n == {"loss_gap": 1.0, "update1_gap": 0.0, "change3_gap": 0.0, "weights_differ": 0.0}
    limits = {"loss_gap": 0.5, "update1_gap": 0.1, "change3_gap": 0.1, "weights_differ": 0}
    assert not judge.verdict(n, limits)
    assert judge.verdict(dict(n, loss_gap=0.0), limits)
    assert not judge.verdict(dict(n, loss_gap=float("nan")), limits)


def test_manifest_is_sound():
    bench = manifest.benchmark()
    assert manifest.problems(bench) == []
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for w in bench["workloads"]:
        c = manifest.cell(bench, w["name"])
        assert set(c["cell"]["limits"]) == set(judge.NUMBERS)
        assert w["chips"] == 1
    broken = json.loads(json.dumps(bench))
    broken["per_layer"][0]["moves"] = "nothing"
    broken["workloads"][0]["name"] = "bad name"
    assert len(manifest.problems(broken)) >= 2


def test_a_configuration_needs_its_reference_family(tmp_path):
    bench = manifest.benchmark()
    (tmp_path / "h100bench" / "metrics").mkdir(parents=True)
    for sub in ("configs", "traffic", "workloads", "metrics"):
        for f in (HERE / sub).glob("*.*"):
            (tmp_path / "h100bench" / sub).mkdir(exist_ok=True)
            (tmp_path / "h100bench" / sub / f.name).write_text(f.read_text())
    assert manifest.problems(bench, tmp_path) == [
        f"config {c['name']!r}: no reference family "
        f"{manifest.load_json(HERE.parent / c['file'])['reference']['family']!r}"
        for c in bench["configs"]]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: p.name)
def test_no_file_imports_jax(path):
    assert {n.split(".")[0] for n in _imports(path)} & FORBIDDEN == set()


def test_a_run_loads_no_jax_module():
    code = f"""
import copy, json, sys, torch
sys.path.insert(0, {str(ROOT)!r})
from h100bench import manifest, run
bench = manifest.benchmark()
c = copy.deepcopy(manifest.cell(bench, "mnv2_recipe.b256"))
c["config"]["program"]["kwargs"]["width_mult"] = 0.25
c["config"]["reference"]["kwargs"]["width_mult"] = 0.25
c["traffic"].update(batch=4, images=32)
c["cell"]["trace_steps"] = 1
run.WARMUP_S = 0.1
r = run.run_cell(bench, c, "mnv2_recipe.b256", 11, 0.2, True, torch.device("cpu"),
                 log=lambda s: 0)
print(json.dumps({{"correct": r["correct"], "loaded": run.forbidden_modules(),
                  "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert got["loaded"] == [] and FORBIDDEN.isdisjoint(got["tops"])
    assert "mandheling_tpu_torch" in got["tops"]


def test_without_a_card_the_command_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "h100bench/run.py", "--workload", "resnet18.b32",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def _quiet(*args):
    pass


# (cell, family in place of the cell's configuration, or None)
SOUND = [("mnv2_recipe.b256", None), ("resnet18.b32", None), ("resnet18.b32", "inception_v3")]
SOUND_IDS = ["mnv2_recipe.b256", "resnet18.b32", "inception_v3"]


@pytest.mark.parametrize("name,family", SOUND, ids=SOUND_IDS)
def test_a_sound_run_is_correct(tiny_cell, monkeypatch, name, family):
    bench, c = tiny_cell(name, family)
    monkeypatch.setattr(run, "WARMUP_S", 0.2)
    r = run.run_cell(bench, c, name, 2**31 + 99, 0.3, False, torch.device("cpu"), log=_quiet)
    assert r["correct"] is True
    assert all(v["value"] <= v["limit"] for v in r["checks"].values())
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"train_samples_per_s", "step_ms_p95", "setup_s"}


def _unchanged(monkeypatch):
    monkeypatch.setattr("mandheling_tpu_torch.train.train_step.niti_sgd_update",
                        lambda model, grads: None)


def _half_batch(monkeypatch):
    from mandheling_tpu_torch.train import train_step as ts

    def compiled(model, group=None):
        step = ts.make_train_step(model)
        return lambda x, oh: step(x[: len(x) // 2], oh[: len(oh) // 2])

    monkeypatch.setattr(ts, "jit_train_step", compiled)


def _altered(monkeypatch):
    from mandheling_tpu_torch.train import train_step as ts

    def compiled(model, group=None):
        step = ts.make_train_step(model)

        def altered(x, oh):
            loss = step(x, oh)
            w = model.layers[0].w.view(-1)
            w[0] = torch.where(w[0] < 127, w[0] + 1, w[0] - 1)
            return loss

        return altered

    monkeypatch.setattr(ts, "jit_train_step", compiled)


# The faults a single-chip training cell can have; it has no exchange
# between chips to leave out.
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("name,family", SOUND, ids=SOUND_IDS)
def test_a_broken_step_is_not_correct(tiny_cell, monkeypatch, fault, name, family):
    bench, c = tiny_cell(name, family)
    fault(monkeypatch)
    monkeypatch.setattr(run, "WARMUP_S", 0.1)
    r = run.run_cell(bench, c, name, 2**31 + 99, 0.2, False, torch.device("cpu"), log=_quiet)
    assert r["correct"] is False


@pytest.mark.parametrize("name,family", [("mnv2_recipe.b32", None), ("resnet18.b256", None),
                                         ("resnet18.b256", "inception_v3")],
                         ids=["mnv2_recipe.b32", "resnet18.b256", "inception_v3"])
def test_the_control_is_not_correct(tiny_cell, name, family):
    _, c = tiny_cell(name, family)
    for seed in (1, 2, 3):
        got = control.readings(c, seed, torch.device("cpu"))
        for variant in ("control", "half_batch", "altered", "unchanged"):
            assert not judge.verdict(got[variant], c["cell"]["limits"]), (seed, variant)
