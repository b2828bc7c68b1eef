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
// Bound: every shape `supports` sends here (K, N <= 512, M >= 1024) does few
// int8 operations per byte, so the bytes bound it: phase 1 reads A and B and
// writes 4 bytes, phase 2 reads them again and writes M x N int8. Phase 2
// also has a second floor, on the CUDA cores: psto_round costs about 30
// integer operations an output.
//
// Design: K1's K-major wgmma route (gemm_s8_sm90.cuh, `stream_kmajor`),
// with the wrapper choosing the tile width BN = N where N <= 256, so that
// each phase reads A once. The whole K (at most 512 bytes) of B's BN columns
// stays in shared memory while a block walks many 64-row M tiles, their A
// tiles streaming through a 4-slot cp.async ring: a small-K tile is one
// copy and one wgmma, so a block per tile would wait out every copy alone.
// Phase 1 takes max|acc| per thread over its tiles and one atomicMax per
// block; phase 2 applies the unchanged psto epilogue (niti_epilogue.cuh)
// into an int8 tile in shared memory and stores it 16 bytes a thread where N
// allows.
#include <algorithm>

#include "gemm_s8_sm90.cuh"
#include "niti_epilogue.cuh"

namespace {

// Phase 1: per-thread max |acc|, then one atomicMax per block into
// *out_max, which the caller sets to INT32_MIN. With K <= 512 no sum
// reaches 2^31 (|acc| <= 512 * 2^14), so |acc| is exact, and the zeros of
// the rows and columns past M and N, which the ring holds as zeros, leave
// a max of absolute values unchanged: no range test per output.
template <int BN>
__global__ void __launch_bounds__(128) fused_max_kernel(mh90::Gemm p, int* out_max) {
  uint8_t* smem = mh90::aligned_smem();
  const int n0 = blockIdx.x * BN;
  int acc[BN / 32][16];
  int local = INT_MIN;
  mh90::stream_kmajor<BN>(smem, p, n0, acc, [&](const int (&a)[BN / 32][16], int) {
#pragma unroll
    for (int j = 0; j < BN / 32; ++j)
#pragma unroll
      for (int v = 0; v < 16; ++v) local = max(local, abs(a[j][v]));
  });
  mh::block_max_atomic(local, out_max);
}

// Phase 2: recompute, then the psto epilogue. The shift is read from device
// memory, where the phase-1 glue (range_estimate_from_max, forward_shift)
// left it, so the host never waits between the phases. kGrad = false is the
// forward requant: a shift <= 0 is a plain wrapping int8 cast.
template <int BN, bool kGrad>
__global__ void __launch_bounds__(128)
    fused_requant_kernel(mh90::Gemm p, const int* shift_ptr, int8_t* y) {
  uint8_t* smem = mh90::aligned_smem();
  const int n0 = blockIdx.x * BN;
  int8_t* ys = reinterpret_cast<int8_t*>(smem + mh90::stream_smem(p.K, BN, 0) - 1024);
  const int shift = *shift_ptr;
  int acc[BN / 32][16];
  mh90::stream_kmajor<BN>(smem, p, n0, acc, [&](const int (&a)[BN / 32][16], int m0) {
    mh90::for_each_kmajor<BN>(
        a, [&](int r, int q, int v) { ys[r * (BN + 16) + q] = mh::requant(v, shift, kGrad); });
    __syncthreads();
    mh90::store_tile_s8<64, BN, 128>(ys, y, p.M, p.N, m0, n0);
  });
}

// K > 512 (the TPU's tiled branch, which `supports` keeps off the main
// path): one 64 x BN tile a block on K1's ring mainloop, the same epilogues.
template <int BN>
__global__ void __launch_bounds__(128) tiled_max_kernel(mh90::Gemm p, int* out_max) {
  uint8_t* ring = mh90::aligned_smem();
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * BN;
  int acc[BN / 32][16];
  mh90::mainloop_kmajor<1, BN>(ring, p, m0, n0, 0, p.K, acc);
  int local = INT_MIN;
  mh90::for_each_kmajor<BN>(acc, [&](int r, int q, int v) {
    if (m0 + r < p.M && n0 + q < p.N) local = max(local, mh::wrap_abs(v));
  });
  mh::block_max_atomic(local, out_max);
}

template <int BN, bool kGrad>
__global__ void __launch_bounds__(128)
    tiled_requant_kernel(mh90::Gemm p, const int* shift_ptr, int8_t* y) {
  uint8_t* ring = mh90::aligned_smem();
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * BN;
  int acc[BN / 32][16];
  mh90::mainloop_kmajor<1, BN>(ring, p, m0, n0, 0, p.K, acc);
  const int shift = *shift_ptr;
  int8_t* ys = reinterpret_cast<int8_t*>(ring);
  mh90::for_each_kmajor<BN>(
      acc, [&](int r, int q, int v) { ys[r * (BN + 16) + q] = mh::requant(v, shift, kGrad); });
  __syncthreads();
  mh90::store_tile_s8<64, BN, 128>(ys, y, p.M, p.N, m0, n0);
}

template <int BN>
int launch_tiled(int phase, const mh90::Gemm& p, void* out, const int* shift,
                 cudaStream_t st) {
  using T = mh90::KMajor<1, BN>;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + 63) / 64);
  const int smem = T::smem(p.K, 64 * (BN + 16));
  if (phase == 0)
    return mh90::launch(tiled_max_kernel<BN>, grid, 128, smem, T::MAX_SMEM, st, p,
                        static_cast<int*>(out));
  return mh90::launch(phase == 1 ? tiled_requant_kernel<BN, false> : tiled_requant_kernel<BN, true>,
                      grid, 128, smem, T::MAX_SMEM, st, p, shift, static_cast<int8_t*>(out));
}

// phase: 0 max, 1 forward requant, 2 gradient requant. The grid: the N
// tiles, times as many M groups as fill every SM with the blocks that fit.
template <int BN>
int launch_phase(int phase, const mh90::Gemm& p, void* out, const int* shift, cudaStream_t st) {
  const int smem = mh90::stream_smem(p.K, BN, phase == 0 ? 0 : 64 * (BN + 16));
  int dev = 0, sms = 0, limit = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the TPU's tiled branch (K > 512, off the main path), or a B too wide to
  // stay resident beside the ring
  if (p.K > 512 || smem > limit) return launch_tiled<BN>(phase, p, out, shift, st);
  void (*kmax)(mh90::Gemm, int*) = fused_max_kernel<BN>;
  void (*kreq)(mh90::Gemm, const int*, int8_t*) =
      phase == 1 ? fused_requant_kernel<BN, false> : fused_requant_kernel<BN, true>;
  const void* kernel =
      phase == 0 ? reinterpret_cast<const void*>(kmax) : reinterpret_cast<const void*>(kreq);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 128, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (p.N + BN - 1) / BN, m_tiles = (p.M + 63) / 64;
  const int want = (sms * std::max(per_sm, 1) + n_tiles - 1) / n_tiles;
  const dim3 grid(n_tiles, std::max(1, std::min(m_tiles, want)));
  if (phase == 0)
    kmax<<<grid, 128, smem, st>>>(p, static_cast<int*>(out));
  else
    kreq<<<grid, 128, smem, st>>>(p, shift, static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

int launch_bn(int bn, int phase, const mh90::Gemm& p, void* out, const int* shift,
              cudaStream_t st) {
  switch (bn) {
    case 32: return launch_phase<32>(phase, p, out, shift, st);
    case 64: return launch_phase<64>(phase, p, out, shift, st);
    case 96: return launch_phase<96>(phase, p, out, shift, st);
    case 128: return launch_phase<128>(phase, p, out, shift, st);
    case 160: return launch_phase<160>(phase, p, out, shift, st);
    case 192: return launch_phase<192>(phase, p, out, shift, st);
    case 256: return launch_phase<256>(phase, p, out, shift, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int run(int phase, const void* a, const void* b, void* out, const void* shift, int M, int N,
        int K, long long sam, long long sbn, int a_width, int b_width, int bn, void* stream) {
  // K-major operands only: A(m, k) = a[m * sam + k], B(k, n) = b[n * sbn + k]
  const mh90::Gemm p{static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), M, N, K,
                     sam, 1, 1, sbn, a_width, b_width, K};
  return launch_bn(bn, phase, p, out, static_cast<const int*>(shift),
                   static_cast<cudaStream_t>(stream));
}

}  // namespace

// Both return the first CUDA error of the launch.
// Both return the first CUDA error of the launch.
extern "C" int mh_fused_matmul_max(const void* a, const void* b, void* out_max, int M, int N,
                                   int K, long long sam, long long sbn, int a_width,
                                   int b_width, int bn, void* stream) {
  return run(0, a, b, out_max, nullptr, M, N, K, sam, sbn, a_width, b_width, bn, stream);
}

extern "C" int mh_fused_matmul_requant(const void* a, const void* b, const void* shift, void* y,
                                       int M, int N, int K, long long sam, long long sbn,
                                       int a_width, int b_width, int bn, int grad,
                                       void* stream) {
  return run(grad ? 2 : 1, a, b, y, shift, M, N, K, sam, sbn, a_width, b_width, bn, stream);
}
