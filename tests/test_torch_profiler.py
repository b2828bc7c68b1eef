"""The port's profiler (utils/profiler.py, utils/device_trace.py) and its
counts of the NITI integer contractions (ops/flops.py) on the CPU:

- `flops_per_step` of a NITI train step equals a count this file writes out
  from the layers' shapes (2 flops a multiply-add; 3 contractions a layer,
  the first layer without its input grad), exactly, for LeNet b64, a narrow
  MobileNetV2 and ResNet-18, in fused modes "matmul_only" and "all", on the
  CPU and on the meta device (shapes only, which is how tools/flops_torch.py
  counts full-width steps); the float QAT step's flops are the float convs'
  (torch's FlopCounterMode), and the plain versions' float64 GEMMs are not
  counted as float work;
- the JAX package's XLA count of the same steps, printed beside the port's
  (XLA also counts elementwise work and only the conv taps inside the
  unpadded input, so the two are not equal; a lone VALID conv shows the
  same convention);
- `per_op_profile` on the CPU: occurrences proportional to `iters`;
  `trace(None)` does nothing and `trace(dir)` writes a Chrome trace;
- the kernel symbols of csrc/ and other activities by category, the launch
  notes joined to the traced kernels in order (a replayed graph's too), and
  `overlap_report` with `source_ranges_of`.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mandheling_tpu.data import onehot_padded as j_onehot_padded
from mandheling_tpu.models import lenet_niti as j_lenet_niti
from mandheling_tpu.models import resnet18_niti as j_resnet18_niti
from mandheling_tpu.models.mobilenet import mobilenet_v2_niti as j_mobilenet_v2_niti
from mandheling_tpu.ops import conv as jconv
from mandheling_tpu.ops import depthwise as jdw
from mandheling_tpu.train import make_train_step as j_make_train_step
from mandheling_tpu.utils.profiler import flops_per_step as j_flops_per_step
from mandheling_tpu_torch.models import lenet_niti, mobilenet_v2_niti, resnet18_niti
from mandheling_tpu_torch.models.lenet_qat import LeNetQAT
from mandheling_tpu_torch.nn.blocks import NITIDepthwiseConv2D
from mandheling_tpu_torch.nn.layers import NITIConv2D
from mandheling_tpu_torch.ops import conv as tconv
from mandheling_tpu_torch.ops import depthwise as tdw
from mandheling_tpu_torch.ops import flops
from mandheling_tpu_torch.ops import kernels
from mandheling_tpu_torch.train import make_train_step, step_graph
from mandheling_tpu_torch.train.qat_train import make_qat_train_step
from mandheling_tpu_torch.utils import device_trace, profiler

MODELS = {  # name -> (constructor, input HWC, batch)
    "lenet": (lenet_niti, (28, 28, 1), 64),
    "mnv2_w025": (lambda: mobilenet_v2_niti(width_mult=0.25), (32, 32, 3), 4),
    "resnet18": (resnet18_niti, (32, 32, 3), 2),
}
J_MODELS = {"lenet": j_lenet_niti, "mnv2_w025": lambda: j_mobilenet_v2_niti(width_mult=0.25),
            "resnet18": j_resnet18_niti}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def step_args(name, device):
    build, hwc, batch = MODELS[name]
    model = build().reset_parameters(torch.Generator().manual_seed(0)).to(device)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, 256, (batch,) + hwc).astype(np.float32)).to(device)
    oh = torch.zeros((batch, 12), dtype=torch.int32)
    oh[torch.arange(batch), torch.from_numpy(rng.integers(0, 10, batch))] = 1
    return model, x, oh.to(device)


def layer_count(name):
    """2 x the multiply-adds of one train step, from the layers' input and
    output shapes seen in one forward: each conv's forward, input grad and
    filter grad compute B*OH*OW*KH*KW*IC*OC products (a depthwise conv
    IC = 1), the model's first layer no input grad."""
    model, x, oh = step_args(name, "meta")
    seen = []
    real = {cls: cls.fwd for cls in (NITIConv2D, NITIDepthwiseConv2D)}

    def recording(cls):
        def fwd(self, q, group=None):
            y, res = real[cls](self, q, group)
            b, oh_, ow_, oc = y.data.shape
            kh, kw = self.kernel
            ic = 1 if cls is NITIDepthwiseConv2D else q.data.shape[-1]
            seen.append((self, b * oh_ * ow_ * kh * kw * ic * oc))
            return y, res
        return fwd

    with pytest.MonkeyPatch.context() as m:
        for cls in real:
            m.setattr(cls, "fwd", recording(cls))
        make_train_step(model)(x, oh)
    first = model.layers[0]
    assert seen[0][0] is first
    return 2 * sum(macs * (2 if layer is first else 3) for layer, macs in seen)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_flops_per_step_is_the_layer_count(name):
    want = layer_count(name)
    nbytes = set()
    for device in ("cpu", "meta"):
        for mode in ("matmul_only", "all"):
            with tconv.use_fused_conv_mode(mode):
                got = profiler.cost_analysis(make_train_step(step_args(name, device)[0]),
                                             *step_args(name, device)[1:])
            assert got["flops"] == got["integer flops"] == want, (device, mode)
            assert got["float flops"] == 0
            nbytes.add(got["contraction bytes"])
    assert len(nbytes) == 1 and nbytes.pop() > 0  # the same on every route


def test_xla_counts_beside_the_port():
    """The JAX package's XLA flops_per_step of the same train steps, printed
    beside the port's count (PERF.md's flop table cites these lines). A lone
    VALID conv: XLA's count is the port's convention, 2 a multiply-add, give
    or take its elementwise converts."""
    x = jnp.zeros((8, 16, 16, 32), jnp.int8)
    w = jnp.zeros((3, 3, 32, 64), jnp.int8)
    macs = 8 * 14 * 14 * 9 * 32 * 64
    xla = j_flops_per_step(lambda a, b: jconv.conv2d_int8_acc(a, b, (1, 1), "VALID"), x, w)
    with flops.counting() as c:
        tconv.conv2d_int8_acc(torch.zeros((8, 16, 16, 32), dtype=torch.int8),
                              torch.zeros((3, 3, 32, 64), dtype=torch.int8), (1, 1), "VALID")
    assert c.flops == 2 * macs and 0 <= xla - 2 * macs <= 0.01 * xla
    # where they part: a SAME conv (XLA counts the taps inside the unpadded
    # input) and a depthwise conv (XLA's taps are elementwise multiply-adds)
    dw = jnp.zeros((3, 3, 1, 32), jnp.int8)
    for what, fn, arg, port in (
            ("SAME 3x3 conv", lambda a, b: jconv.conv2d_int8_acc(a, b, (1, 1), "SAME"), w,
             2 * 8 * 16 * 16 * 9 * 32 * 64),
            ("SAME 3x3 depthwise conv", lambda a, b: jdw.dwconv2d_int8_acc(a, b, (1, 1), "SAME"),
             dw, 2 * 8 * 16 * 16 * 9 * 32)):
        xla = j_flops_per_step(fn, x, arg)
        print(f"{what} (8, 16, 16, 32): port {port} flops, XLA {xla:.0f}, XLA / port "
              f"{xla / port:.4f}")
    for name in sorted(MODELS):
        _, hwc, batch = MODELS[name]
        jm = J_MODELS[name]()
        params = jm.init(jax.random.PRNGKey(0))
        oh = jnp.asarray(j_onehot_padded(np.zeros(batch, int), 10, 12))
        xla = j_flops_per_step(j_make_train_step(jm), params, jnp.zeros((batch,) + hwc), oh)
        port = profiler.flops_per_step(make_train_step(step_args(name, "meta")[0]),
                                       *step_args(name, "meta")[1:])
        print(f"{name} b{batch}: port {port:.0f} flops, XLA {xla:.0f}, XLA / port "
              f"{xla / port:.4f}")
        assert port > 0 and xla > 0


def test_float_flops_of_the_qat_step():
    """The QAT step's float convs, as FlopCounterMode counts them: forward,
    weight grads, and input grads but conv1's (x takes no gradient)."""
    shapes = {"conv1": (24, 5, 1, 20), "conv2": (8, 5, 20, 50), "ip1": (1, 1, 800, 500),
              "ip2": (1, 1, 500, 10)}
    batch = 4
    fwd = {k: batch * o * o * k_ * k_ * i * c for k, (o, k_, i, c) in shapes.items()}
    want = 2 * (3 * sum(fwd.values()) - fwd["conv1"])
    model = LeNetQAT().reset_parameters(torch.Generator().manual_seed(0))
    x = torch.zeros((batch, 28, 28, 1))
    oh = torch.eye(10)[:batch]
    got = profiler.cost_analysis(make_qat_train_step(model), x, oh, torch.tensor(0.01))
    assert got["float flops"] == got["flops"] == want and got["integer flops"] == 0


def test_plain_versions_float_gemms_are_not_float_flops():
    """On the CPU K1's plain version multiplies in float64; that GEMM is the
    integer contraction, counted once from its shapes."""
    a = torch.ones((64, 32), dtype=torch.int8)
    b = torch.ones((32, 16), dtype=torch.int8)
    from mandheling_tpu_torch.ops import matmul as tmatmul

    got = profiler.cost_analysis(tmatmul.matmul_int8_acc, a, b)
    assert got["integer flops"] == got["flops"] == 2 * 64 * 32 * 16 and got["float flops"] == 0
    assert got["contraction bytes"] == 64 * 32 + 32 * 16 + 64 * 16 * 4


def test_float_contraction_bytes_are_operands_and_result():
    """A float conv and a matmul with bias: their tensors once each; the
    elementwise op between them moves no contraction bytes."""
    x, w, b = torch.ones((2, 3, 8, 8)), torch.ones((4, 3, 3, 3)), torch.ones(4)
    m = torch.ones((144, 5))

    def fn(x, w, b, m):
        y = torch.nn.functional.conv2d(x, w, b)  # (2, 4, 6, 6)
        return (y * 2).reshape(2, 144) @ m

    got = profiler.cost_analysis(fn, x, w, b, m)
    conv = 4 * (x.numel() + w.numel() + b.numel() + 2 * 4 * 6 * 6)
    mm = 4 * (2 * 144 + m.numel() + 2 * 5)
    assert got["contraction bytes"] == conv + mm and got["integer flops"] == 0


def test_cost_analysis_counts_a_compiled_step_through_its_eager_form():
    model, x, oh = step_args("lenet", "cpu")
    compiled = step_graph.CompiledStep(make_train_step(model), "cpu")
    assert profiler.flops_per_step(compiled, x, oh) == layer_count("lenet")
    assert compiled.graphs == 0  # nothing captured


def test_per_op_profile_occurrences_scale_with_iters():
    model, x, oh = step_args("lenet", "cpu")
    step = make_train_step(model)
    (rows1, cats1), (rows2, cats2) = (profiler.per_op_profile(step, x, oh, iters=n)
                                      for n in (1, 2))
    one = {r["name"]: r["occurrences"] for r in rows1}
    two = {r["name"]: r["occurrences"] for r in rows2}
    assert one and set(one) == set(two)
    assert all(two[k] == 2 * one[k] for k in one)
    assert {c["category"]: 2 * c["occurrences"] for c in cats1} == \
        {c["category"]: c["occurrences"] for c in cats2}
    assert "cuDNN/cuBLAS" in {c["category"] for c in cats1}  # the plain versions' GEMMs
    assert device_trace.format_table(cats1).splitlines()[0].startswith("op/category")


def test_trace(tmp_path):
    with profiler.trace(None) as prof:
        torch.ones(3).sum()
    assert prof is None
    logdir = tmp_path / "trace"
    with profiler.trace(str(logdir)):
        torch.ones(3).sum()
    (path,) = logdir.glob("*.json")
    assert "traceEvents" in json.loads(path.read_text())


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::matmul_kmajor_kernel<2, 128, false>(mh90::Gemm, signed "
     "char const*, int*, int*)", "matmul_int8"),
    ("void (anonymous namespace)::matmul_kmajor_kernel<1, 64, true>(mh90::Gemm, signed "
     "char const*, int*, int*)", "matmul_int16a"),
    ("void (anonymous namespace)::matmul_mnmajor_kernel<4, false>(mh90::Gemm)", "matmul_int8"),
    ("void (anonymous namespace)::reduce_splits_kernel(int const*, int*, long long, int)",
     "matmul_int8 split-K sum"),
    ("void (anonymous namespace)::fused_max_kernel<128>(mh90::Gemm, int*)", "fused_matmul_max"),
    ("void (anonymous namespace)::tiled_requant_kernel<64, true>(mh90::Gemm, int const*, "
     "signed char*)", "fused_matmul_requant"),
    ("void (anonymous namespace)::conv_stream_kernel<64, 0, true>((anonymous "
     "namespace)::ConvArgs, mh90::Gemm, int*, int*, int const*, signed char*)",
     "fused_conv_max"),
    ("void (anonymous namespace)::conv_ring_kernel<256, 2, false>(ConvArgs)",
     "fused_conv_requant"),
    ("void (anonymous namespace)::dw3x3_kernel<true, 1>(DwArgs, int const*, int*, signed "
     "char*)", "fused_dwconv_requant"),
    ("void (anonymous namespace)::dw_any_kernel<0>(DwArgs, int const*, int*, signed char*)",
     "fused_dwconv_max"),
    ("void (anonymous namespace)::fgrad3x3_packed_kernel<2, 2>(FgArgs)", "fused_dwconv_fgrad"),
    ("void (anonymous namespace)::max_bf16_resident_kernel<128>(Args, int*)",
     "fused_matmul_max_bf16"),
    ("Memcpy HtoD (Pageable -> Device)", "memcpy"),
    ("Memset (Device)", "memset"),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32", "cuDNN/cuBLAS"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<int, "
     "at::native::func_wrapper_t<int, at::native::MaxNanFunctor<int>>>>()", "reduction"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AbsFunctor<int>>()",
     "elementwise"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<int>()", "copy"),
    ("aten::mm", "cuDNN/cuBLAS"), ("aten::amax", "reduction"), ("aten::add", "elementwise"),
    ("void histogram_kernel()", "other"),
])
def test_categories(name, want):
    assert device_trace.category(name) == want


def event(name, start, dur):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA, cpu_children=[], self_cpu_time_total=0,
        time_range=types.SimpleNamespace(start=start, elapsed_us=lambda: dur))


def test_launch_notes_join_the_kernels_in_order():
    k1 = "void (anonymous namespace)::matmul_kmajor_kernel<1, 64, false>(mh90::Gemm)"
    k5 = "void (anonymous namespace)::fgrad_any_kernel(FgArgs)"
    events = [event(k1, 10.0, 2.0), event("Memcpy HtoD", 0.0, 1.0), event(k5, 20.0, 3.0),
              event(k1, 30.0, 4.0)]
    notes = [("matmul_int8", 100, 7, "a.py:1"), ("fused_dwconv_fgrad", 50, 5, "b.py:9"),
             ("matmul_int8", 200, 8, "a.py:2")]
    got = device_trace.device_events(events, notes, cuda=True)
    assert [e["name"] for e in got] == ["Memcpy HtoD", k1, k5, k1]
    assert [(e["flops"], e["bytes_accessed"], e["source"]) for e in got] == [
        (0, 0, ""), (100, 7, "a.py:1"), (50, 5, "b.py:9"), (200, 8, "a.py:2")]
    rows = device_trace.per_op_rows(got)
    assert rows[0] == {"name": k1, "category": "matmul_int8", "occurrences": 2,
                       "total_us": 6.0, "flops": 300, "bytes_accessed": 15, "source": "a.py:1"}
    cats = {c["category"]: c for c in device_trace.by_category(rows)}
    assert cats["memcpy"]["occurrences"] == 1 and cats["fused_dwconv_fgrad"]["flops"] == 50

    report = device_trace.overlap_report(got, fgrad_ranges=[("b.py", 5, 12)])
    assert report["busy_us"] == 10.0 and report["span_us"] == 34.0
    assert report["copy_union_us"] == 1.0 and report["copy_compute_overlap_us"] == 0.0
    assert report["fgrad_union_us"] == 3.0
    assert device_trace.overlap_report(got, fgrad_marker="fgrad")["fgrad_union_us"] == 3.0


@pytest.mark.parametrize("notes", [
    [("matmul_int8", 100, 7, "a.py:1")],  # a kernel launched outside a counted op
    [("matmul_int8", 100, 7, "a.py:1")] * 3,  # notes of a call not traced
    [("matmul_int8", 100, 7, "a.py:1"), ("fused_conv_max", 1, 1, "c.py:1")],
])
def test_launch_notes_that_do_not_match_the_kernels_raise(notes):
    k1 = "void (anonymous namespace)::matmul_kmajor_kernel<1, 64, false>(mh90::Gemm)"
    split = "void (anonymous namespace)::reduce_splits_kernel(int const*, int*, long long, int)"
    events = [event(k1, 0.0, 1.0), event(split, 1.0, 1.0), event(k1, 2.0, 1.0)]
    with pytest.raises(ValueError, match="do not match"):
        device_trace.device_events(events, notes, cuda=True)
    # the split-K sum is counted with its matmul: two notes for two K1 kernels
    assert len(device_trace.device_events(events, notes[:1] * 2, cuda=True)) == 3


def test_launch_notes_of_counted_ops_and_replays():
    """A counted op's launches are noted with its flops and source; a
    captured graph keeps its capture's notes out of the open records and
    adds them at every replay (step_graph.LaunchCounts, with the counts)."""
    a = torch.ones((8, 4), dtype=torch.int8)
    b = torch.ones((4, 2), dtype=torch.int8)
    from mandheling_tpu_torch.ops import matmul as tmatmul

    def launching(x, y):  # a pretended K1 launch inside the counted op
        kernels.matmul_int8.LAUNCHES += 1
        return x

    with pytest.MonkeyPatch.context() as m:
        m.setattr(tmatmul.dispatch, "matmul_acc", launching)
        kernels.reset_launch_counts()
        with flops.recording() as notes:
            tmatmul.matmul_int8_acc(a, b)
            hook = step_graph.LaunchCounts()
            token = hook.begin()
            tmatmul.matmul_int8_acc(a, b)  # captured: runs nothing
            delta, made = hook.end(token)
            assert kernels.launch_counts()["matmul_int8"] == 1 and delta == {"matmul_int8": 1}
            hook.replay((delta, made))
            hook.replay((delta, made))
            assert kernels.launch_counts()["matmul_int8"] == 3
        kernels.reset_launch_counts()
    (src,) = device_trace.source_ranges_of(tmatmul.matmul_int8_acc)
    assert len(notes) == 3 and len(made) == 1
    for counter, n_flops, nbytes, source in notes:
        assert (counter, n_flops, nbytes) == ("matmul_int8", 2 * 8 * 4 * 2, 32 + 8 + 64)
        assert device_trace._in_ranges(source, [src])
    assert not flops.inside()


def test_source_ranges_of_counted_ops():
    (path, lo, hi), = device_trace.source_ranges_of(tdw.dwconv2d_filter_grad_acc)
    assert path.endswith("ops/depthwise.py") and lo < hi
    assert device_trace._in_ranges(f"{path}:{lo}", [(path, lo, hi)])
    assert not device_trace._in_ranges("no line", [(path, lo, hi)])
