"""Build and load the hand-written CUDA kernels of ``mandheling_tpu_torch/csrc``.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The library name
carries a hash of the sources and flags, so an edited kernel is rebuilt and
an unchanged one is reused from ``mandheling_tpu_torch/_build/`` (listed in
``.gitignore``). A failed build raises with the compiler's output.

Nothing is built when this module is imported: the first launch builds what
it needs, and :func:`build_all` builds every kernel at once, one ``nvcc``
process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# library name -> its source under csrc/; every source includes the headers
SOURCES = {
    "matmul_int8": "matmul_int8.cu",
    "fused_matmul_int8": "fused_matmul_int8.cu",
    "fused_conv_int8": "fused_conv_int8.cu",
    "fused_dwconv_int8": "fused_dwconv_int8.cu",
    "fused_dwconv_fgrad_int8": "fused_dwconv_fgrad_int8.cu",
    "matmul_max_bf16": "matmul_max_bf16.cu",
    "requant_int32": "requant_int32.cu",
    "pool_concat_int8": "pool_concat_int8.cu",
}
_HEADERS = ("gemm_s8_sm90.cuh", "niti_epilogue.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found (on PATH, or under CUDA_HOME/bin)")
    return cand


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (SOURCES[name],) + _HEADERS:
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (default: all) that are not built yet, in
    parallel. Returns {name: compiler output} for the ones compiled (ptxas
    reports registers, shared memory and spills there)."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in jobs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib
