// K1: int8 (M, K) x int8 (K, N) -> int32 (M, N) on Hopper's tensor cores.
//
// Replaces the TPU kernel mandheling_tpu/ops/kernels/matmul_int8.py
// `_matmul_kernel` (pallas_call in `matmul_acc_pallas_padded`). On the card it
// serves every NITI contraction of the training step: forwards, input grads
// (through im2col) and filter grads (patches^T read by strides).
//
// Bound: at the LeNet shapes every contraction does at most ~90 int8
// operations per byte it must move, far below the ~590 at which an H100
// SXM's tensor cores (1979 TOP/s) rather than its memory (3.35 TB/s) would
// bound it; so the bytes bound it and, at batch 64, the launch.
//
// Design: 64x64x32 shared tiles, mma.sync m16n8k32, ragged edges masked in
// the kernel (no host-side padding). When the M x N tiles alone cannot fill
// the card (the filter grads: 25 x 20 outputs over K = 36864), the K loop is
// split across blocks that add their partial sums with atomicAdd; int32
// addition wraps and is associative, so the result is exact and independent
// of the order.
#include "gemm_s8.cuh"

namespace {

__global__ void __launch_bounds__(mh::THREADS)
    matmul_s8s32_kernel(mh::Operands p, int32_t* c, int kt_per_split) {
  __shared__ __align__(16) mh::Smem s;
  const int m0 = blockIdx.x * mh::BM, n0 = blockIdx.y * mh::BN;
  const int kt_total = (p.K + mh::BK - 1) / mh::BK;
  const int kt0 = blockIdx.z * kt_per_split;
  const int kt1 = min(kt_total, kt0 + kt_per_split);
  mh::Acc acc;
  mh::mainloop(s, p, m0, n0, kt0, kt1, acc);
  const bool split = gridDim.z > 1;
  const long long ldc = p.N;
  mh::for_each_acc(p, m0, n0, acc, [&](int row, int col, int v) {
    int32_t* dst = c + row * ldc + col;
    if (split)
      atomicAdd(dst, v);
    else
      *dst = v;
  });
}

}  // namespace

// c must be zeroed by the caller when splits > 1. Returns cudaGetLastError().
extern "C" int mh_matmul_s8s32(const void* a, const void* b, void* c, int M,
                               int N, int K, long long sam, long long sak,
                               long long sbk, long long sbn, int kt_per_split,
                               int splits, void* stream) {
  const mh::Operands p{static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
                       M, N, K, sam, sak, sbk, sbn};
  const dim3 grid((M + mh::BM - 1) / mh::BM, (N + mh::BN - 1) / mh::BN, splits);
  matmul_s8s32_kernel<<<grid, mh::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<int32_t*>(c), kt_per_split);
  return static_cast<int>(cudaGetLastError());
}
