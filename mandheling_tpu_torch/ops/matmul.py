"""NITI int8 matmul with its gradient and forward requants (port of
``mandheling_tpu/ops/matmul.py``; reference NITI_Matmul_Int8.cpp:140-245).

int8 x int8 -> int32 through the kernel dispatch (K1 under backend "cuda"
on CUDA tensors), then either the FC-gradient requant (range estimate, psto
shift by bw - 3, an all-zero accumulator gives zeros) or the forward
requant (bw - 7 with the forward shift's branch rules), both by K7
(kernels/requant_int32.py) under the "cuda" backend. The JAX package
recomputes the accumulator behind an optimization barrier for large
outputs, which only schedules memory; the port computes it once. With a
replica `group`, the gradient sums over it before its shift and the forward
takes the maximum over it (JAX `ops/matmul.py:29-51`). Each op counts its
work from its shapes (ops/flops.py).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import allreduce, flops
from .kernels import dispatch
from .kernels import requant_int32 as _rq


def _work(args, out_size: int) -> Tuple[int, int]:
    """(multiply-adds, bytes): a (M, K) and b (K, N) read once, the (M, N)
    result written once (`out_size` bytes an element)."""
    (m, k), n = args["a"].shape, args["b"].shape[1]
    return m * k * n, flops.nbytes(args["a"], args["b"]) + m * n * out_size


@flops.counted(lambda args: _work(args, 4))
def matmul_int8_acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x int8 (K, N) -> int32 (M, N)."""
    return dispatch.matmul_acc(a, b)


@flops.counted(lambda args: _work(args, 1))
def matmul_int8_grad(a: torch.Tensor, b: torch.Tensor, group=None) -> torch.Tensor:
    """int8 GEMM + bw-3 psto requant (NITI_Matmul_Int8.cpp:219-231)."""
    return allreduce.grad_allreduce_requant(matmul_int8_acc(a, b), group, margin=3)


@flops.counted(lambda args: _work(args, 1))
def matmul_int8_forward(a: torch.Tensor, a_exp: torch.Tensor, b: torch.Tensor,
                        b_exp: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-style requant of an int8 GEMM -> (int8 (M, N), int32 exp_out):
    the matmul analog of conv2d_forward."""
    acc = matmul_int8_acc(a, b)
    m = allreduce.maybe_pmax(_rq.absmax(acc), group)
    return _rq.requant_forward(acc, m, (a_exp, b_exp))
