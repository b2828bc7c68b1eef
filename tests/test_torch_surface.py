"""Every public top-level function and class of the JAX package
(`mandheling_tpu/**/*.py`, read with `ast`, not imported) has a counterpart
in the port: a top-level name of the same name in the port's module of the
same path, or an entry of ELSEWHERE (the port's module and name), or an
entry of NOT_PORTED with its reason. ROADMAP.md copies these tables. Only
the TPU scheduling knobs, xplane's XSpace reader and `shard_packed_params`
stay unported."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT = ROOT / "mandheling_tpu", ROOT / "mandheling_tpu_torch"

# (JAX module, name) -> (the port's module, name)
ELSEWHERE = {
    ("utils/profiler.py", "xla_trace"): ("utils/profiler.py", "trace"),
    ("utils/profiler.py", "trace_device_planes"): ("utils/profiler.py", "trace_device_events"),
    ("utils/xplane.py", "device_planes"): ("utils/device_trace.py", "device_events"),
    ("utils/xplane.py", "per_op_rows"): ("utils/device_trace.py", "per_op_rows"),
    ("utils/xplane.py", "by_category"): ("utils/device_trace.py", "by_category"),
    ("utils/xplane.py", "format_table"): ("utils/device_trace.py", "format_table"),
    ("utils/xplane.py", "overlap_report"): ("utils/device_trace.py", "overlap_report"),
    ("utils/xplane.py", "source_ranges_of"): ("utils/device_trace.py", "source_ranges_of"),
    # the persistent XLA cache: the kernels' hashed builds under _build/
    ("utils/compile_cache.py", "enable"): ("ops/kernels/build.py", "build_all"),
    ("utils/compile_cache.py", "default_dir"): ("ops/kernels/build.py", "BUILD_DIR"),
    ("train/train_step.py", "det_psum_f32"): ("train/train_step.py", "det_psum"),
    # the Pallas kernels: the wrappers of their Hopper kernels (csrc/)
    ("ops/kernels/matmul_int8.py", "matmul_acc_pallas"):
        ("ops/kernels/matmul_int8.py", "matmul_acc_cuda"),
    ("ops/kernels/matmul_int8.py", "matmul_acc_pallas_padded"):
        ("ops/kernels/matmul_int8.py", "matmul_acc_cuda"),
    ("ops/kernels/conv_int8.py", "conv_acc_pallas"): ("ops/kernels/conv_int8.py", "conv_acc"),
    ("ops/kernels/fused_matmul_int8.py", "matmul_max_pallas"):
        ("ops/kernels/fused_matmul_int8.py", "matmul_max_cuda"),
    ("ops/kernels/fused_matmul_int8.py", "matmul_requant_pallas"):
        ("ops/kernels/fused_matmul_int8.py", "matmul_requant_cuda"),
    ("ops/kernels/fused_conv_int8.py", "conv_max_pallas"):
        ("ops/kernels/fused_conv_int8.py", "conv_max_cuda"),
    ("ops/kernels/fused_conv_int8.py", "conv_requant_pallas"):
        ("ops/kernels/fused_conv_int8.py", "conv_requant_cuda"),
    ("ops/kernels/fused_dwconv_int8.py", "dwconv_max_pallas"):
        ("ops/kernels/fused_dwconv_int8.py", "dwconv_max_cuda"),
    ("ops/kernels/fused_dwconv_int8.py", "dwconv_requant_pallas"):
        ("ops/kernels/fused_dwconv_int8.py", "dwconv_requant_cuda"),
    ("ops/kernels/fused_dwconv_int8.py", "dwconv_fgrad_acc_pallas"):
        ("ops/kernels/fused_dwconv_int8.py", "dwconv_fgrad_acc_cuda"),
}

_FGRAD_KNOB = ("a TPU scheduling knob: the 'matmul', 'conv' and 'corr' filter-grad forms give "
               "the same int32; the port computes the 'matmul' form (ops/conv.py)")
_REQUANT_KNOB = ("a TPU scheduling knob: where XLA places the requant of a conv gives the same "
                 "bytes; the port requantizes in ops/numerics.py or in a fused kernel's epilogue")
_DW_KNOB = ("a TPU scheduling knob: the 'taps' and 'grouped' depthwise forms give the same "
            "bytes; the port computes the taps (K4 and K5 on the card)")
_READER = ("xplane's XSpace protobuf reader: torch.profiler hands over its events, which "
           "utils/device_trace.py reads")
NOT_PORTED = {
    ("ops/conv.py", "set_filter_grad_strategy"): _FGRAD_KNOB,
    ("ops/conv.py", "get_filter_grad_strategy"): _FGRAD_KNOB,
    ("ops/conv.py", "use_filter_grad_strategy"): _FGRAD_KNOB,
    ("ops/conv.py", "set_requant_impl"): _REQUANT_KNOB,
    ("ops/conv.py", "get_requant_impl"): _REQUANT_KNOB,
    ("ops/conv.py", "use_requant_impl"): _REQUANT_KNOB,
    ("ops/depthwise.py", "set_dw_impl"): _DW_KNOB,
    ("ops/depthwise.py", "get_dw_impl"): _DW_KNOB,
    **{("utils/xplane.py", name): _READER
       for name in ("XStat", "XEvent", "XLine", "XEventMetadata", "XPlane", "parse_xspace",
                    "find_xplane_files")},
    ("parallel/pp_general.py", "shard_packed_params"):
        "places the packed stage buffers on the pipe axis's devices; in the port every rank "
        "holds its model and make_gpipe_train_step updates its own stage's layers in place "
        "(GPipePlan.pack_params / unpack_params carry the JAX packed layout)",
}


def public_defs(path: Path):
    return [n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def top_level_names(path: Path):
    names = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            for target in (n.targets if isinstance(n, ast.Assign) else [n.target]):
                names |= {t.id for t in ast.walk(target) if isinstance(t, ast.Name)}
        elif isinstance(n, ast.ImportFrom):
            names |= {a.asname or a.name for a in n.names}
    return names


JAX_NAMES = [(str(p.relative_to(JAX_PKG)), name)
             for p in sorted(JAX_PKG.rglob("*.py")) for name in public_defs(p)]


def test_the_walk_sees_the_package():
    assert len(JAX_NAMES) > 250
    assert ("utils/profiler.py", "per_op_profile") in JAX_NAMES
    assert set(ELSEWHERE) | set(NOT_PORTED) <= set(JAX_NAMES)
    assert not set(ELSEWHERE) & set(NOT_PORTED)


@pytest.mark.parametrize("module", sorted({m for m, _ in JAX_NAMES}))
def test_every_name_has_its_counterpart(module):
    for jax_module, name in [k for k in JAX_NAMES if k[0] == module]:
        if (jax_module, name) in NOT_PORTED:
            continue
        port_module, port_name = ELSEWHERE.get((jax_module, name), (jax_module, name))
        path = PORT / port_module
        assert path.exists(), f"{jax_module}:{name}: no {port_module} in the port"
        assert port_name in top_level_names(path), \
            f"{jax_module}:{name} has no counterpart {port_module}:{port_name}"


def test_only_the_knobs_the_reader_and_shard_packed_params_stay_unported():
    assert {reason for reason in NOT_PORTED.values()} == {
        _FGRAD_KNOB, _REQUANT_KNOB, _DW_KNOB, _READER, NOT_PORTED[
            ("parallel/pp_general.py", "shard_packed_params")]}
    assert {m for m, _ in NOT_PORTED} == {"ops/conv.py", "ops/depthwise.py", "utils/xplane.py",
                                          "parallel/pp_general.py"}
