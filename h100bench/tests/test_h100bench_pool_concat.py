"""The byte count of the pools and concats (pool_concat.py) and the two
readers of K8's kernels, on the CPU."""

import ast
from pathlib import Path

import pytest

from h100bench import categories, manifest, pool_concat, reference, run, trace

HERE = Path(__file__).resolve().parents[1]
CELL = "inceptionv3_imagenet.b32"
H100 = "NVIDIA H100 80GB HBM3"


def _cell_shape_and_layers():
    c = manifest.cell(manifest.benchmark(), CELL)
    cfg = c["config"]
    layers = reference.build(cfg["reference"]["family"], **cfg["reference"]["kwargs"])
    return (c["traffic"]["batch"], *cfg["input_shape"]), layers


def test_step_bytes_of_the_cell():
    shape, layers = _cell_shape_and_layers()
    assert shape == (32, 299, 299, 3)
    sites = pool_concat.site_bytes(layers, shape)
    # 4 max pools, 9 average pools, 15 concats (4 of them inside module E)
    assert len(sites) == 28
    assert pool_concat.step_bytes(layers, shape) == 776_050_688


def test_step_bytes_by_hand():
    R = reference
    shape = (2, 9, 9, 4)
    layers = [R.MaxPool((3, 3), (2, 2)),  # 9x9 -> 4x4
              R.Concat([[R.AvgPool((3, 3), (1, 1), 1)],
                        [R.Conv(4, 6)],
                        [R.Concat([[R.Conv(4, 2)], [R.Conv(4, 3)]])]])]
    x, y = 2 * 81 * 4, 2 * 16 * 4
    inner, outer = 2 * 16 * 5, 2 * 16 * 15
    assert pool_concat.site_bytes(layers, shape) == [
        3 * x + 3 * y, 4 * y, 2 * inner, 2 * outer]
    assert pool_concat.step_bytes([R.Conv(4, 4), R.Relu()], shape) == 0


def _stretch(with_k8: bool, steps: int = 2):
    a = trace.Activity
    acts = [a("void matmul_kmajor_kernel<64, 0, false>(x)", "matmul_int8", 0.0, 10.0),
            a("void at::native::vectorized_elementwise_kernel<4>", "elementwise", 10.0, 20.0)]
    if with_k8:
        acts += [a("void (anonymous namespace)::k8_maxpool_grad_kernel<3, 3>"
                   "((anonymous namespace)::K8Pool)", "other", 20.0, 26.0),
                 a("void (anonymous namespace)::k8_concat_kernel<4>"
                   "((anonymous namespace)::K8Join)", "other", 30.0, 34.0)]
    return trace.Stretch(acts, [], steps)


def _info(st):
    return run.RunInfo(window_steps=10, window_s=2.0, trainer_s=[], step_s=[], step_ops=1,
                       peak_ops=None, bound_s=None, stretch=st)


def test_the_readers_read_nothing_without_k8():
    for name in ("kernels.pool_concat_ms_per_step", "kernels.pool_concat_roofline"):
        read = manifest.reader(name)
        assert read(_info(None)) is None
        assert read(_info(_stretch(False))) is None
    assert manifest.reader("kernels.pool_concat_roofline")(_info(_stretch(True)),
                                                           kind="cpu") is None


def test_the_readers_read_k8():
    st = _stretch(True)
    assert manifest.reader("kernels.pool_concat_ms_per_step")(_info(st)) == pytest.approx(
        10 / 1e3 / 2)
    shape, layers = _cell_shape_and_layers()
    floor_s = pool_concat.step_bytes(layers, shape) / 3.35e12
    got = manifest.reader("kernels.pool_concat_roofline")(_info(st), kind=H100)
    assert got == pytest.approx(100 * floor_s / (10e-6 / 2))


def test_the_roofline_reads_one_cell_only():
    bench = manifest.benchmark()
    m = [m for m in bench["per_layer"] if m["name"] == "kernels.pool_concat_roofline"][0]
    assert m["workloads"] == [CELL]
    m["workloads"] = [CELL, "resnet18.b32"]
    read = manifest.reader("kernels.pool_concat_roofline")
    assert read(_info(_stretch(True)), kind=H100, bench=bench) is None


def test_the_k8_symbols_read_other_in_the_frozen_table():
    for s in pool_concat.SYMBOLS:
        assert categories.category(f"void (anonymous namespace)::{s}<3>(K8Pool)") == "other"
        assert pool_concat.is_k8(s)
    assert not pool_concat.is_k8("void at::native::max_pool2d_kernel")


def test_the_manifest_is_sound_with_the_new_cell():
    bench = manifest.benchmark()
    assert manifest.problems(bench) == []
    entry = [w for w in bench["workloads"] if w["name"] == CELL][0]
    assert entry["config"] == "inception_v3_imagenet299" and entry["chips"] == 1
    assert [m["name"] for m in manifest.metrics_of(bench, "per_layer", CELL)] == [
        "kernels.pool_concat_ms_per_step", "kernels.pool_concat_roofline"]
    cfg = manifest.cell(bench, CELL)["config"]
    assert cfg["reduced"] == [c for c in bench["configs"]
                              if c["name"] == "inception_v3_imagenet299"][0]["reduced"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


def test_pool_concat_imports_nothing_of_the_program_or_jax():
    """The rule the reference and its families keep."""
    names = set(_imports(HERE / "pool_concat.py"))
    assert {n.split(".")[0] for n in names} <= {"__future__", "math", "dataclasses", "typing",
                                                "importlib", "pathlib", "torch", "h100bench"}
    assert {n for n in names if n.startswith("h100bench")} <= {"h100bench.reference"}
