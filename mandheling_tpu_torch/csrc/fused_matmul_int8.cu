// K2: the two-phase fused NITI matmul. The int32 accumulator never reaches
// device memory: phase 1 keeps only max|A*B|, phase 2 recomputes A*B and
// writes the requantized int8 directly.
//
// Replaces the TPU kernels of mandheling_tpu/ops/kernels/fused_matmul_int8.py:
// `_small_max_kernel` / `_max_kernel` (pallas_calls in `_small_max` and
// `matmul_max_pallas`) and `_small_requant_kernel` / `_requant_kernel`
// (`_small_requant` and `matmul_requant_pallas`). One design covers both the
// small-K/N and the tiled TPU branch, since a CUDA block masks its ragged
// edges itself.
//
// Bound: the fc2 input grad at batch 2048, (2048, 12) x (12, 500), does ~23
// int8 operations per byte, so the bytes bound it: about 1 MB, 0.3 us at
// 3.35 TB/s. Phase 1 reads A and B and writes 4 bytes; phase 2 reads them
// again and writes M x N int8, where the unfused path writes and re-reads
// an int32 accumulator (4 bytes an element each way). Both phases run the
// K1 mainloop (gemm_s8.cuh) with the epilogues of niti_epilogue.cuh, which
// K3 and K4 share.
#include "gemm_s8.cuh"
#include "niti_epilogue.cuh"

namespace {

// Phase 1: per-thread max |acc|, then one atomicMax per block into
// *out_max, which the caller sets to INT32_MIN.
__global__ void __launch_bounds__(mh::THREADS)
    fused_max_kernel(mh::Operands p, int* out_max) {
  __shared__ __align__(16) mh::Smem s;
  const int m0 = blockIdx.x * mh::BM, n0 = blockIdx.y * mh::BN;
  mh::Acc acc;
  mh::mainloop(s, p, m0, n0, 0, (p.K + mh::BK - 1) / mh::BK, acc);
  int local = INT_MIN;
  mh::for_each_acc(p, m0, n0, acc,
                   [&](int, int, int v) { local = max(local, mh::wrap_abs(v)); });
  mh::block_max_atomic(local, out_max);
}

// Phase 2: recompute, then the psto epilogue. The shift is read from device
// memory, where the phase-1 glue (range_estimate_from_max, forward_shift)
// left it, so the host never waits between the phases. kGrad = false is the
// forward requant: a shift <= 0 is a plain wrapping int8 cast.
template <bool kGrad>
__global__ void __launch_bounds__(mh::THREADS)
    fused_requant_kernel(mh::Operands p, const int* shift_ptr, int8_t* y) {
  __shared__ __align__(16) mh::Smem s;
  const int m0 = blockIdx.x * mh::BM, n0 = blockIdx.y * mh::BN;
  mh::Acc acc;
  mh::mainloop(s, p, m0, n0, 0, (p.K + mh::BK - 1) / mh::BK, acc);
  const int shift = *shift_ptr;
  const long long ldy = p.N;
  mh::for_each_acc(p, m0, n0, acc, [&](int row, int col, int v) {
    y[row * ldy + col] = mh::requant(v, shift, kGrad);
  });
}

mh::Operands operands(const void* a, const void* b, int M, int N, int K,
                      long long sam, long long sak, long long sbk, long long sbn) {
  return mh::Operands{static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
                      M, N, K, sam, sak, sbk, sbn};
}

dim3 grid_of(int M, int N) {
  return dim3((M + mh::BM - 1) / mh::BM, (N + mh::BN - 1) / mh::BN);
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int mh_fused_matmul_max(const void* a, const void* b, void* out_max,
                                   int M, int N, int K, long long sam,
                                   long long sak, long long sbk, long long sbn,
                                   void* stream) {
  fused_max_kernel<<<grid_of(M, N), mh::THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      operands(a, b, M, N, K, sam, sak, sbk, sbn), static_cast<int*>(out_max));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mh_fused_matmul_requant(const void* a, const void* b,
                                       const void* shift, void* y, int M, int N,
                                       int K, long long sam, long long sak,
                                       long long sbk, long long sbn, int grad,
                                       void* stream) {
  const mh::Operands p = operands(a, b, M, N, K, sam, sak, sbk, sbn);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(shift);
  int8_t* yp = static_cast<int8_t*>(y);
  if (grad)
    fused_requant_kernel<true><<<grid_of(M, N), mh::THREADS, 0, st>>>(p, sp, yp);
  else
    fused_requant_kernel<false><<<grid_of(M, N), mh::THREADS, 0, st>>>(p, sp, yp);
  return static_cast<int>(cudaGetLastError());
}
