"""The category of a device activity, from its name: for a kernel of the
program's hand-written CUDA sources (K1-K6), the launch counter it counts
under, told from its symbol and, where one symbol serves two counters,
from a template argument of the demangled name; every other activity a
family by substrings of its name. A frozen copy of the program's table at
the benchmark's first version: a new hand-written kernel needs a row here
before its time counts as the kernels layer's."""

from __future__ import annotations

import re

# symbol -> (index of the template argument that picks the counter, or
# None) and the counter, or the counters by that argument (false/0, true/1, 2)
KERNELS = {
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
}
_SYMBOL = re.compile(r"(?<![A-Za-z_])(" + "|".join(KERNELS) + r")(<[^>]*>)?")
CSRC = frozenset(c for _, cs in KERNELS.values() for c in ((cs,) if isinstance(cs, str) else cs))
_ARG_VALUES = {"false": 0, "true": 1}

# (family, substrings of a lower-cased name): the first that matches
FAMILIES = (
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
TRANSFERS = frozenset(("memcpy", "memset"))


def category(name: str) -> str:
    m = _SYMBOL.search(name)
    if m:
        index, counter = KERNELS[m.group(1)]
        if index is None:
            return counter
        if m.group(2) is None:  # a name without its template arguments
            return counter[0]
        arg = m.group(2)[1:-1].split(",")[index].strip()
        return counter[_ARG_VALUES[arg] if arg in _ARG_VALUES else int(arg)]
    low = name.lower()
    for family, keys in FAMILIES:
        if any(k in low for k in keys):
            return family
    return "other"


def is_csrc(cat: str) -> bool:
    return cat in CSRC
