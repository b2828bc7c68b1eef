// Shared mainloop of the int8 GEMM kernels (K1, K2 and the implicit-GEMM
// conv K3): s8 x s8 -> s32 on the tensor cores with mma.sync.m16n8k32.
//
// A block computes a BM x BN tile of C = A * B. A(m, k) and B(k, n) are read
// through element strides, so a transposed operand (the filter gradient's
// patches^T) needs no copy. Ragged M, N and K are masked while a tile is
// staged in shared memory: out-of-range elements load as 0, which leaves
// every sum unchanged. The int32 sums wrap (no .satfinite), as XLA's do.
// The A tile comes from a loader, so that K3 can gather it from an NHWC
// activation instead of reading a matrix.
#pragma once

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace mh {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
// Shared row stride in bytes. 48 bytes = 12 words, so the 8 rows that one
// fragment load touches (groupID 0..7, 4 words each) fall in 32 distinct banks.
constexpr int LDS = BK + 16;
constexpr int THREADS = 128;  // 4 warps as 2 x 2, each owning a 32 x 32 tile

struct Operands {
  const int8_t* a;
  const int8_t* b;
  int M, N, K;
  long long sam, sak;  // A(m, k) = a[m * sam + k * sak]
  long long sbk, sbn;  // B(k, n) = b[k * sbk + n * sbn]
};

struct Smem {
  int8_t a[BM][LDS];  // row m, k contiguous
  int8_t b[BN][LDS];  // row n, k contiguous: B is transposed on the way in
};

// One accumulator fragment set per thread: [m16 tile][n8 tile][4 values].
using Acc = int[2][4][4];

// Stages B[k0:k0+BK, n0:n0+BN] into s.b, transposed (row n, k contiguous).
__device__ __forceinline__ void load_b(Smem& s, const Operands& p, int n0, int k0) {
  // Neighbouring threads walk the operand's contiguous axis, so that a warp
  // reads neighbouring bytes of device memory.
  const bool b_n_fast = p.sbn == 1 || p.sbk != 1;
  for (int i = threadIdx.x; i < BN * BK; i += THREADS) {
    const int r = b_n_fast ? i % BN : i / BK;  // n
    const int c = b_n_fast ? i / BN : i % BK;  // k
    const int n = n0 + r, k = k0 + c;
    s.b[r][c] = (n < p.N && k < p.K) ? p.b[k * p.sbk + n * p.sbn] : int8_t(0);
  }
}

// The A tile of a plain GEMM: A(m, k) = a[m * sam + k * sak].
struct StridedA {
  const Operands& p;
  __device__ __forceinline__ void operator()(Smem& s, int m0, int k0) const {
    const bool a_k_fast = p.sak == 1 || p.sam != 1;
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int r = a_k_fast ? i / BK : i % BM;
      const int c = a_k_fast ? i % BK : i / BM;
      const int m = m0 + r, k = k0 + c;
      s.a[r][c] = (m < p.M && k < p.K) ? p.a[m * p.sam + k * p.sak] : int8_t(0);
    }
  }
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Accumulates A[m0:m0+BM, k] * B[k, n0:n0+BN] over the k-steps [kt0, kt1).
// `load_a(s, m0, k0)` stages the A tile; it masks what lies outside A to 0.
template <typename LoadA>
__device__ __forceinline__ void mainloop(Smem& s, const Operands& p, int m0,
                                         int n0, int kt0, int kt1, Acc& acc,
                                         const LoadA& load_a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  for (int kt = kt0; kt < kt1; ++kt) {
    load_a(s, m0, kt * BK);
    load_b(s, p, n0, kt * BK);
    __syncthreads();
    // PTX fragment layout of m16n8k32 .s8 (groupID g = lane/4, t = lane%4):
    // A regs {row g, k 4t..}, {row g+8, k 4t..}, {row g, k 16+4t..},
    // {row g+8, k 16+4t..}; B regs {k 4t.., col g}, {k 16+4t.., col g}.
    uint32_t af[2][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm + mi * 16 + g;
      af[mi][0] = ld32(&s.a[r][t * 4]);
      af[mi][1] = ld32(&s.a[r + 8][t * 4]);
      af[mi][2] = ld32(&s.a[r][16 + t * 4]);
      af[mi][3] = ld32(&s.a[r + 8][16 + t * 4]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = wn + ni * 8 + g;
      bf[ni][0] = ld32(&s.b[n][t * 4]);
      bf[ni][1] = ld32(&s.b[n][16 + t * 4]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    __syncthreads();
  }
}

__device__ __forceinline__ void mainloop(Smem& s, const Operands& p, int m0,
                                         int n0, int kt0, int kt1, Acc& acc) {
  mainloop(s, p, m0, n0, kt0, kt1, acc, StridedA{p});
}

// Calls f(row, col, value) for every in-range element of this thread's
// fragments. C/D layout: value j sits at row g + 8*(j/2), col 2t + j%2.
template <typename F>
__device__ __forceinline__ void for_each_acc(const Operands& p, int m0, int n0,
                                             const Acc& acc, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = m0 + wm + mi * 16 + g + (j >> 1) * 8;
        const int col = n0 + wn + ni * 8 + t * 2 + (j & 1);
        if (row < p.M && col < p.N) f(row, col, acc[mi][ni][j]);
      }
}

}  // namespace mh
