// K1: int8 (M, K) x int8 (K, N) -> int32 (M, N) on Hopper's tensor cores.
//
// Replaces the TPU kernel mandheling_tpu/ops/kernels/matmul_int8.py
// `_matmul_kernel` (pallas_call in `matmul_acc_pallas_padded`). On the card it
// serves every NITI contraction of the training step: forwards, input grads
// (through im2col) and filter grads (patches^T read by strides).
//
// Bound: every contraction of the LeNet and MobileNetV2 steps does far fewer
// int8 operations per byte it must move than the ~590 at which an H100 SXM's
// tensor cores (1979 TOP/s) rather than its memory (3.35 TB/s) would bound
// it; so the bytes bound it and, at LeNet's batch 64, the launch.
//
// Design (gemm_s8_sm90.cuh): a K-major route on wgmma for the forwards and
// input grads, an MN-major route on mma.sync with in-register byte
// transposes for the filter grads, both fed by cp.async rings. Each block
// stages its int32 tile in shared memory and stores it 16 bytes a thread.
// When the output tiles alone cannot fill the card (the filter grads' skinny
// outputs over K up to 262144), blockIdx.z splits K: each split stores its
// partial tile into a workspace slice, and a second kernel adds the slices
// modulo 2^32, which is exact (int32 sums wrap) and the same in any order.
// Atomic adds into one output were the first design: hundreds of splits
// adding into the same few thousand words serialised at L2.
//
// The int16-A route (WIDE; the conv forwards and filter grads of MobileNetV2
// with int16 projection outputs, proj_bits=15, which the JAX package
// computes in XLA outside Pallas): int16 (M, K) x int8 (K, N) -> int32, the
// int32 wrap of the exact product. The wrapper splits A into a signed high
// byte and an unsigned low byte, a = 256 hi + lo; each block runs the
// mainloop over the hi plane, multiplies its sums by 256 (mod 2^32), and
// runs it again over the lo plane with the tensor cores' u8 x s8 form, so
// lo needs no correction term. One launch, the same routes, tiles and
// split-K; twice the tensor-core work of an int8 product, and A's bytes
// doubled: the bytes bound it as they bound the int8 route.
#include "gemm_s8_sm90.cuh"

namespace {

// The output of split blockIdx.z: c itself, or its slice of the workspace.
__device__ __forceinline__ int32_t* split_out(const mh90::Gemm& p, int32_t* c, int32_t* ws) {
  return gridDim.z > 1 ? ws + static_cast<long long>(blockIdx.z) * p.M * p.N : c;
}

// The lo plane of the int16-A route: p with A at a_lo (read as unsigned).
__device__ __forceinline__ mh90::Gemm lo_plane(mh90::Gemm p, const int8_t* a_lo) {
  p.a = a_lo;
  return p;
}

template <int WG, int BN, bool WIDE>
__global__ void __launch_bounds__(128 * WG)
    matmul_kmajor_kernel(mh90::Gemm p, const int8_t* a_lo, int32_t* c, int32_t* ws) {
  using T = mh90::KMajor<WG, BN>;
  uint8_t* ring = mh90::aligned_smem();
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * p.k_per_split;
  const int k_end = min(p.K, k_begin + p.k_per_split);
  int acc[BN / 32][16];
  mh90::mainloop_kmajor<WG, BN>(ring, p, m0, n0, k_begin, k_end, acc);
  if constexpr (WIDE)
    mh90::mainloop_kmajor<WG, BN, true>(ring, lo_plane(p, a_lo), m0, n0, k_begin, k_end, acc);
  int32_t* cs = reinterpret_cast<int32_t*>(ring);
  mh90::for_each_kmajor<BN>(acc, [&](int r, int q, int v) { cs[r * (BN + 4) + q] = v; });
  __syncthreads();
  mh90::store_tile_s32<T::BM, BN, T::NT>(cs, split_out(p, c, ws), p.M, p.N, m0, n0);
}

template <int WGM, bool WIDE>
__global__ void __launch_bounds__(128)
    matmul_mnmajor_kernel(mh90::Gemm p, const int8_t* a_lo, int32_t* c, int32_t* ws) {
  using T = mh90::MNMajor<WGM>;
  extern __shared__ __align__(16) uint8_t ring[];
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int k_begin = blockIdx.z * p.k_per_split;
  const int k_end = min(p.K, k_begin + p.k_per_split);
  mh90::MNAcc acc;
  mh90::mainloop_mnmajor<WGM>(ring, p, m0, n0, k_begin, k_end, acc);
  if constexpr (WIDE)
    mh90::mainloop_mnmajor<WGM, true>(ring, lo_plane(p, a_lo), m0, n0, k_begin, k_end, acc);
  int32_t* cs = reinterpret_cast<int32_t*>(ring);
  mh90::for_each_mnmajor<WGM>(acc, [&](int r, int q, int v) { cs[r * (T::BN + 4) + q] = v; });
  __syncthreads();
  mh90::store_tile_s32<T::BM, T::BN, T::NT>(cs, split_out(p, c, ws), p.M, p.N, m0, n0);
}

// c[i] = the sum modulo 2^32 of ws[z][i] over the splits z; 16 bytes a
// load and store where M * N % 4 == 0 (every slice is then 16-byte aligned).
__global__ void __launch_bounds__(256)
    reduce_splits_kernel(const int32_t* ws, int32_t* c, long long mn, int splits) {
  const long long i = 4 * (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (i >= mn) return;
  if ((mn & 3) == 0) {
    uint4 sum = make_uint4(0, 0, 0, 0);
    for (int z = 0; z < splits; ++z) {
      const uint4 v = *reinterpret_cast<const uint4*>(ws + z * mn + i);
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    *reinterpret_cast<uint4*>(c + i) = sum;
    return;
  }
  for (long long j = i; j < min(i + 4, mn); ++j) {
    unsigned sum = 0;
    for (int z = 0; z < splits; ++z) sum += static_cast<unsigned>(ws[z * mn + j]);
    c[j] = static_cast<int32_t>(sum);
  }
}

template <int WG, int BN, bool WIDE>
int launch_kmajor(const mh90::Gemm& p, const int8_t* a_lo, int32_t* c, int32_t* ws, int splits,
                  cudaStream_t st) {
  using T = mh90::KMajor<WG, BN>;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + T::BM - 1) / T::BM, splits);
  const int smem = T::smem(p.k_per_split, T::BM * (BN + 4) * 4);
  return mh90::launch(matmul_kmajor_kernel<WG, BN, WIDE>, grid, T::NT, smem, T::MAX_SMEM, st, p,
                      a_lo, c, ws);
}

template <int WG, bool WIDE>
int launch_kmajor_bn(const mh90::Gemm& p, const int8_t* a_lo, int32_t* c, int32_t* ws, int bn,
                     int splits, cudaStream_t st) {
  switch (bn) {
    case 32: return launch_kmajor<WG, 32, WIDE>(p, a_lo, c, ws, splits, st);
    case 64: return launch_kmajor<WG, 64, WIDE>(p, a_lo, c, ws, splits, st);
    case 96: return launch_kmajor<WG, 96, WIDE>(p, a_lo, c, ws, splits, st);
    case 128: return launch_kmajor<WG, 128, WIDE>(p, a_lo, c, ws, splits, st);
    case 160: return launch_kmajor<WG, 160, WIDE>(p, a_lo, c, ws, splits, st);
    case 192: return launch_kmajor<WG, 192, WIDE>(p, a_lo, c, ws, splits, st);
    case 256: return launch_kmajor<WG, 256, WIDE>(p, a_lo, c, ws, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int WGM, bool WIDE>
int launch_mnmajor(const mh90::Gemm& p, const int8_t* a_lo, int32_t* c, int32_t* ws, int splits,
                   cudaStream_t st) {
  using T = mh90::MNMajor<WGM>;
  const dim3 grid((p.N + T::BN - 1) / T::BN, (p.M + T::BM - 1) / T::BM, splits);
  return mh90::launch(matmul_mnmajor_kernel<WGM, WIDE>, grid, T::NT, T::SMEM, T::SMEM, st, p,
                      a_lo, c, ws);
}

// The int16-A route runs one warpgroup a block on the K-major route (the
// wrapper's plan asks for no more), which halves its template instances.
int launch(const mh90::Gemm& p, const int8_t* a_lo, int32_t* c, int32_t* ws, int route,
           int warps, int bn, int splits, cudaStream_t st) {
  if (a_lo != nullptr) {
    if (route == 0 && warps == 1) return launch_kmajor_bn<1, true>(p, a_lo, c, ws, bn, splits, st);
    if (route == 1) {
      if (warps == 1) return launch_mnmajor<1, true>(p, a_lo, c, ws, splits, st);
      if (warps == 2) return launch_mnmajor<2, true>(p, a_lo, c, ws, splits, st);
      if (warps == 4) return launch_mnmajor<4, true>(p, a_lo, c, ws, splits, st);
    }
  } else if (route == 0) {
    if (warps == 1) return launch_kmajor_bn<1, false>(p, a_lo, c, ws, bn, splits, st);
    if (warps == 2) return launch_kmajor_bn<2, false>(p, a_lo, c, ws, bn, splits, st);
  } else if (route == 1) {
    if (warps == 1) return launch_mnmajor<1, false>(p, a_lo, c, ws, splits, st);
    if (warps == 2) return launch_mnmajor<2, false>(p, a_lo, c, ws, splits, st);
    if (warps == 4) return launch_mnmajor<4, false>(p, a_lo, c, ws, splits, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// route 0: K-major (sak == sbk == 1), `warps` = warpgroups (1 or 2), bn the
// tile width; route 1: MN-major (sam == sbn == 1), `warps` = warps along M
// (1, 2 or 4). With splits > 1, ws holds splits x M x N int32. A non-null
// a_lo selects the int16-A route: a is then the high-byte plane (int8) and
// a_lo the low-byte plane (uint8), with a's strides. Returns the first CUDA
// error of the launches.
extern "C" int mh_matmul_s8s32(const void* a, const void* a_lo, const void* b, void* c, void* ws,
                               int M, int N, int K, long long sam, long long sak, long long sbk,
                               long long sbn, int route, int a_width, int b_width, int warps,
                               int bn, int k_per_split, int splits, void* stream) {
  const mh90::Gemm p{static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), M, N, K,
                     sam, sak, sbk, sbn, a_width, b_width, k_per_split};
  int32_t* cp = static_cast<int32_t*>(c);
  int32_t* wp = static_cast<int32_t*>(ws);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err =
      launch(p, static_cast<const int8_t*>(a_lo), cp, wp, route, warps, bn, splits, st);
  if (err || splits == 1) return err;
  const long long mn = static_cast<long long>(M) * N;
  const unsigned blocks = static_cast<unsigned>((mn + 4 * 256 - 1) / (4 * 256));
  reduce_splits_kernel<<<blocks, 256, 0, st>>>(wp, cp, mn, splits);
  return static_cast<int>(cudaGetLastError());
}
