// K6: max|A*B| with int8 operands multiplied as bf16 on the tensor cores:
// the bf16-operand instance of K2's phase-1 (max) kernel.
//
// Replaces the bf16 variant of the TPU micro-probe's kernel,
// tools/probes/dot_probe.py `make_dot.kernel` (its pallas_call in `run`):
// int8 tiles converted to bf16, a dot with float32 accumulation, the result
// converted to int32, then max|.|. Its int8 variant is K2's phase 1 itself.
//
// The loader converts each int8 to bf16 while it stages a tile in shared
// memory (exact: bf16 holds every integer of 8 bits), mma.sync.m16n8k16
// accumulates in float32, and the epilogue converts each sum to int32 and
// reduces max|.| as K2 does (niti_epilogue.cuh). A float32 sum is exact
// while every partial sum stays below 2^24, as it does for the probe's
// operands in [-80, 80) up to K = 2621; beyond, it rounds as the TPU dot does.
//
// Bound: the probe's largest shape, (49152, 256) x (256, 512), does 12.9 G
// operations on 12.7 MB: 13.0 us at the H100 SXM's dense bf16 rate (989
// TFLOP/s) against 3.8 us of bytes, so operations bound it. This first
// version stages tiles element by element with no copy in flight, as K1
// does; wgmma and TMA come later.
#include <cuda_bf16.h>

#include "gemm_s8.cuh"
#include "niti_epilogue.cuh"

namespace {

constexpr int BK = 32;        // two k16 steps of the MMA per tile
constexpr int LDS = BK + 8;   // 80-byte rows: fragment loads are conflict-free

struct SmemBf16 {
  __nv_bfloat16 a[mh::BM][LDS];  // row m, k contiguous
  __nv_bfloat16 b[mh::BN][LDS];  // row n, k contiguous: B transposed on the way in
};

__device__ __forceinline__ void load_tiles(SmemBf16& s, const mh::Operands& p, int m0, int n0,
                                           int k0) {
  const bool a_k_fast = p.sak == 1 || p.sam != 1;
  for (int i = threadIdx.x; i < mh::BM * BK; i += mh::THREADS) {
    const int r = a_k_fast ? i / BK : i % mh::BM;
    const int c = a_k_fast ? i % BK : i / mh::BM;
    const int m = m0 + r, k = k0 + c;
    const int v = (m < p.M && k < p.K) ? p.a[m * p.sam + k * p.sak] : 0;
    s.a[r][c] = __int2bfloat16_rn(v);
  }
  const bool b_n_fast = p.sbn == 1 || p.sbk != 1;
  for (int i = threadIdx.x; i < mh::BN * BK; i += mh::THREADS) {
    const int r = b_n_fast ? i % mh::BN : i / BK;
    const int c = b_n_fast ? i / mh::BN : i % BK;
    const int n = n0 + r, k = k0 + c;
    const int v = (n < p.N && k < p.K) ? p.b[k * p.sbk + n * p.sbn] : 0;
    s.b[r][c] = __int2bfloat16_rn(v);
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(mh::THREADS) max_bf16_kernel(mh::Operands p, int* out_max) {
  __shared__ __align__(16) SmemBf16 s;
  const int m0 = blockIdx.x * mh::BM, n0 = blockIdx.y * mh::BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;
  float facc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) facc[mi][ni][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    load_tiles(s, p, m0, n0, k0);
    __syncthreads();
    // PTX fragment layout of m16n8k16 .bf16 (groupID g = lane/4, t = lane%4):
    // A regs {row g, k 2t..}, {row g+8, k 2t..}, {row g, k 8+2t..},
    // {row g+8, k 8+2t..}; B regs {k 2t.., col g}, {k 8+2t.., col g}.
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g;
        af[mi][0] = ld32(&s.a[r][kk + t * 2]);
        af[mi][1] = ld32(&s.a[r + 8][kk + t * 2]);
        af[mi][2] = ld32(&s.a[r][kk + 8 + t * 2]);
        af[mi][3] = ld32(&s.a[r + 8][kk + 8 + t * 2]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn + ni * 8 + g;
        bf[ni][0] = ld32(&s.b[n][kk + t * 2]);
        bf[ni][1] = ld32(&s.b[n][kk + 8 + t * 2]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(facc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // The C layout of m16n8k16 .f32 is that of the s8 MMA, so K2's walk over
  // the fragments applies; float -> int32 truncates, exact for integers.
  mh::Acc acc;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = __float2int_rz(facc[mi][ni][j]);
  int local = INT_MIN;
  mh::for_each_acc(p, m0, n0, acc,
                   [&](int, int, int v) { local = max(local, mh::wrap_abs(v)); });
  mh::block_max_atomic(local, out_max);
}

}  // namespace

// Returns cudaGetLastError() after the launch; *out_max must hold INT32_MIN.
extern "C" int mh_matmul_max_bf16(const void* a, const void* b, void* out_max, int M, int N,
                                  int K, long long sam, long long sak, long long sbk,
                                  long long sbn, void* stream) {
  const mh::Operands p{static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
                       M, N, K, sam, sak, sbk, sbn};
  const dim3 grid((M + mh::BM - 1) / mh::BM, (N + mh::BN - 1) / mh::BN);
  max_bf16_kernel<<<grid, mh::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<int*>(out_max));
  return static_cast<int>(cudaGetLastError());
}
