// Hopper mainloops of the int8 GEMM kernels K1 (matmul_int8.cu), K2
// (fused_matmul_int8.cu) and K3 (fused_conv_int8.cu, whose A tile is
// gathered from an NHWC input through the loader hook of the K-major
// mainloops), and the primitives K6 (matmul_max_bf16.cu) builds its bf16
// mainloop from: s8 x s8 -> s32 with int32 sums that wrap (no .satfinite),
// as XLA's do. The mainloops also take A's bytes unsigned (LO): the second
// pass of K1's int16-A route, which adds the low-byte plane's products to
// the high-byte plane's sums times 256.
//
// Two routes, chosen by the wrapper from the operands' strides
// (ops/kernels/matmul_int8.py `plan`):
//
// - K-major (A(m, k) with k contiguous, B(k, n) with k contiguous): the
//   forwards, the input grads and every K2 call. Tiles of 64 x WG rows of A
//   and BN rows of B, 128 bytes of K a stage, go by cp.async into a ring of 4
//   stages in dynamic shared memory, laid out in the 128-byte swizzle that
//   wgmma's descriptors read; each warpgroup runs wgmma.m64n32k32 over its 64
//   rows. A K range of at most 4 stages (every K2 call) is loaded whole into
//   a ring of its own size, so that small-K blocks share an SM, and only the
//   32-byte k-steps that hold data are copied and multiplied. 8-bit wgmma
//   takes no transpose, so an N-major B is copied K-major by the wrapper (a
//   weight of at most 1280 x 320 bytes).
// - MN-major (A(m, k) with m contiguous, B(k, n) with n contiguous): the
//   filter grads, im2col(x)^T x gy, K up to 262144. Rows of K are staged as
//   they lie in memory (64 of them a stage, a ring of 3, cp.async); each
//   warp turns 4 x 4 byte blocks into mma.sync.m16n8k32 fragments with byte
//   permutes. The tensor-core rate does not bound these; the bytes do.
//
// Copies are 16, 8 or 4 bytes wide, as the base pointer and the row stride
// allow (`w`), with the src-size zero fill masking ragged edges; rows that
// allow none (K = 25, 27) take a byte path (w = 1) that reads the aligned
// words holding 16 bytes and shifts them into place.
#pragma once

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace mh90 {

struct Gemm {
  const int8_t* a;
  const int8_t* b;
  int M, N, K;
  long long sam, sak;  // A(m, k) = a[m * sam + k * sak]
  long long sbk, sbn;  // B(k, n) = b[k * sbk + n * sbn]
  int aw, bw;          // copy widths of A and B in bytes: 16, 8, 4 or 1
  int k_per_split;     // bytes of K per blockIdx.z (a multiple of 32)
};

constexpr int STAGES = 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int W>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int bytes) {
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(W), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies `bytes` (0..w) from src to dst and zero-fills the rest of w bytes
// (w = 16, 8 or 4; cp.async). A unit with no bytes is a plain store of
// zeros: a cp.async with src-size 0 still sends a request, and every empty
// unit of a tile would send it to the same address.
__device__ __forceinline__ void copy_unit(uint8_t* dst, const int8_t* src, int bytes, int w) {
  switch (w) {
    case 16:
      if (bytes > 0)
        cp_async<16>(smem_u32(dst), src, bytes);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      break;
    case 8:
      if (bytes > 0)
        cp_async<8>(smem_u32(dst), src, bytes);
      else
        *reinterpret_cast<uint2*>(dst) = make_uint2(0, 0);
      break;
    default:
      if (bytes > 0)
        cp_async<4>(smem_u32(dst), src, bytes);
      else
        *reinterpret_cast<uint32_t*>(dst) = 0u;
  }
}

// The byte path, for rows that allow no aligned copy: `bytes` (0..16) from
// src at any address into 16 bytes at dst, the rest zero. It reads the
// aligned 32-bit words that hold them (never a word without one of them)
// and shifts them into place.
__device__ __forceinline__ void copy16_unaligned(uint8_t* dst, const int8_t* src, int bytes) {
  uint32_t o[4] = {0, 0, 0, 0};
  if (bytes > 0) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
    const uint32_t* q = reinterpret_cast<const uint32_t*>(addr & ~uintptr_t(3));
    const int off = static_cast<int>(addr & 3), nw = (off + bytes + 3) >> 2;
    uint32_t w[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) w[i] = i < nw ? q[i] : 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int keep = bytes - 4 * i;
      const uint32_t v = __funnelshift_r(w[i], w[i + 1], 8 * off);
      o[i] = keep >= 4 ? v : keep > 0 ? v & ((1u << (8 * keep)) - 1u) : 0u;
    }
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
}

// ---------------------------------------------------------------- K-major

// The bytes of K a stage must hold from k0: whole 32-byte wgmma k-steps up
// to k_end, at most 128.
__device__ __forceinline__ int kspan(int k0, int k_end) {
  return min(128, (k_end - k0 + 31) & ~31);
}

// Stages rows [0, ROWS) x K bytes [k0, k0 + kspan) of a K-major operand
// (row r at base + r * pitch) into a 128-byte-swizzled tile: byte c of row r
// at r * 128 + ((c / 16) ^ (r % 8)) * 16 + c % 16. Rows >= `rows` and bytes
// at k >= k_end are zero; bytes past the span are left unwritten.
template <int ROWS, int NT>
__device__ __forceinline__ void load_kmajor(uint8_t* tile, const int8_t* base, long long pitch,
                                            int rows, int k0, int k_end, int w) {
  const int unit = w == 1 ? 16 : w;
  const int per_row = kspan(k0, k_end) / unit;
  for (int i = threadIdx.x; i < ROWS * per_row; i += NT) {
    const int r = i / per_row, c = (i - r * per_row) * unit, k = k0 + c;
    const int bytes = r < rows ? min(max(k_end - k, 0), unit) : 0;
    const int8_t* src = bytes > 0 ? base + r * pitch + k : base;
    uint8_t* dst = tile + r * 128 + ((((c >> 4) ^ (r & 7))) << 4) + (c & 15);
    if (w == 1)
      copy16_unaligned(dst, src, bytes);
    else
      copy_unit(dst, src, bytes, w);
  }
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// 8-row groups 1024 bytes apart (SBO), leading offset unused (1).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

#define MH_WGMMA_N32(ATYPE)                                                              \
  asm volatile(                                                                          \
      "{\n"                                                                              \
      ".reg .pred p;\n"                                                                  \
      "setp.ne.b32 p, %18, 0;\n"                                                         \
      "wgmma.mma_async.sync.aligned.m64n32k32.s32." ATYPE ".s8 "                          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "          \
      "%16, %17, p;\n"                                                                   \
      "}\n"                                                                              \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),          \
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),        \
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])                               \
      : "l"(da), "l"(db), "r"(1))

// d += A * B over one 32-byte k-step; A's bytes are unsigned where UA (the
// low-byte plane of K1's int16-A route), signed otherwise.
template <bool UA = false>
__device__ __forceinline__ void wgmma_n32(int (&d)[16], uint64_t da, uint64_t db) {
  if constexpr (UA)
    MH_WGMMA_N32("u8");
  else
    MH_WGMMA_N32("s8");
}
#undef MH_WGMMA_N32

// The starting sums of a mainloop: 0, or with LO (the low-byte pass of K1's
// int16-A route) the high-byte plane's sums times 256, modulo 2^32.
template <bool LO, int NJ>
__device__ __forceinline__ void init_acc(int (&acc)[NJ][16]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i)
      acc[j][i] = LO ? static_cast<int>(static_cast<unsigned>(acc[j][i]) << 8) : 0;
}

template <int NJ>
__device__ __forceinline__ void fence_acc(int (&acc)[NJ][16]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(acc[j][i])::"memory");
}

template <int WG, int BN>
struct KMajor {
  static constexpr int BM = 64 * WG, NT = 128 * WG, NJ = BN / 32;
  static constexpr int A_BYTES = BM * 128, STAGE_BYTES = (BM + BN) * 128;
  // The ring holds at most STAGES stages; a K range of fewer stages gets a
  // ring of its own size (`smem`). + 1024: the ring is aligned to the
  // swizzle's 1024-byte period by hand. `epilogue` is the tile the
  // epilogue stages in the ring's place.
  static constexpr int MAX_SMEM = STAGES * STAGE_BYTES + 1024;
  static int smem(int k_range, int epilogue) {
    const int need = (k_range + 127) / 128;
    const int ring = (need < 1 ? 1 : need > STAGES ? STAGES : need) * STAGE_BYTES;
    return (ring > epilogue ? ring : epilogue) + 1024;
  }
};

// The dynamic shared memory, aligned to 1024 bytes.
__device__ __forceinline__ uint8_t* aligned_smem() {
  extern __shared__ __align__(16) uint8_t dyn_smem[];
  return dyn_smem + ((1024 - (smem_u32(dyn_smem) & 1023)) & 1023);
}

// Sums A[m0:m0+BM, k] * B[k, n0:n0+BN] over k in [k_begin, k_end) into acc:
// acc[j][i] of thread (warp w of its warpgroup wg, lane = 4g + t) is row
// m0 + 64 wg + 16 w + g + 8 ((i >> 1) & 1), column n0 + 32 j + 8 (i >> 2)
// + 2 t + (i & 1). load_a(tile, m0, k0) stages A's rows [m0, m0 + BM) x K
// bytes [k0, k0 + kspan(k0, k_end)) as load_kmajor does (the hook of K3's
// gather); the overload below reads A from p. With LO, A's bytes are
// unsigned and acc starts from its own value times 256 (init_acc).
template <int WG, int BN, bool LO = false, typename LoadA>
__device__ __forceinline__ void mainloop_kmajor(uint8_t* ring, const Gemm& p, int m0, int n0,
                                                int k_begin, int k_end,
                                                int (&acc)[BN / 32][16], LoadA load_a) {
  using T = KMajor<WG, BN>;
  init_acc<LO>(acc);
  const int kt_n = k_end > k_begin ? (k_end - k_begin + 127) / 128 : 0;
  const int8_t* b = p.b + n0 * p.sbn;
  const int brows = p.N - n0;
  auto load = [&](int kt) {
    uint8_t* st = ring + (kt % STAGES) * T::STAGE_BYTES;
    const int k0 = k_begin + kt * 128;
    load_a(st, m0, k0);
    load_kmajor<BN, T::NT>(st + T::A_BYTES, b, p.sbn, brows, k0, k_end, p.bw);
  };
  // A K range of at most STAGES stages is loaded whole, with no ring turns
  // (every K2 call: K <= 512); a longer one turns the ring.
  const bool resident = kt_n <= STAGES;
  for (int s = 0; s < (resident ? kt_n : STAGES - 1); ++s) {
    load(s);
    if (!resident) cp_async_commit();
  }
  if (resident) {
    cp_async_commit();
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
  const int wg = threadIdx.x >> 7;
  for (int kt = 0; kt < kt_n; ++kt) {
    if (!resident) {
      cp_async_wait<STAGES - 2>();
      // this thread's copies (cp.async and the byte path) before wgmma's reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (kt + STAGES - 1 < kt_n) load(kt + STAGES - 1);
      cp_async_commit();
    }
    const uint8_t* st = ring + (kt % STAGES) * T::STAGE_BYTES;
    const uint32_t sa = smem_u32(st) + wg * 64 * 128, sb = smem_u32(st + T::A_BYTES);
    const int nk = kspan(k_begin + kt * 128, k_end) / 32;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int kk = 0; kk < nk; ++kk)
#pragma unroll
      for (int j = 0; j < T::NJ; ++j)
        wgmma_n32<LO>(acc[j], desc_sw128(sa + kk * 32), desc_sw128(sb + j * 32 * 128 + kk * 32));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
  }
  __syncthreads();  // the ring is free for the epilogue
}

template <int WG, int BN, bool LO = false>
__device__ __forceinline__ void mainloop_kmajor(uint8_t* ring, const Gemm& p, int m0, int n0,
                                                int k_begin, int k_end,
                                                int (&acc)[BN / 32][16]) {
  mainloop_kmajor<WG, BN, LO>(ring, p, m0, n0, k_begin, k_end, acc,
                          [&](uint8_t* st, int m, int k0) {
                            load_kmajor<64 * WG, 128 * WG>(st, p.a + m * p.sam, p.sam, p.M - m,
                                                           k0, k_end, p.aw);
                          });
}

// K2's mainloop (a whole K of at most 4 stages, K <= 512) and K3's (any K
// whose B fits beside the ring). B's BN columns from n0 (the whole K) stay
// resident; the block (one warpgroup) walks the 64-row M tiles m0 = 64
// (blockIdx.y + i gridDim.y), and their A stages, (tile i, stage kt) in
// turn, stream through a ring of SLOTS, so that the next copies are in
// flight while one stage is multiplied and a tile's epilogue runs. epi(acc, m0) runs on each tile's sums (acc as in
// mainloop_kmajor with WG = 1); every thread calls it. The shared memory is
// B, then the ring, then `extra` bytes for the epilogue. load_a(tile, m0,
// k0) stages 64 rows of A as in mainloop_kmajor; the overload below reads A
// from p.
constexpr int SLOTS = 4;

__host__ __device__ constexpr int stream_smem(int K, int BN, int extra) {
  return ((K + 127) / 128 * BN + SLOTS * 64) * 128 + extra + 1024;
}

template <int BN, typename Epi, typename LoadA>
__device__ __forceinline__ void stream_kmajor(uint8_t* smem, const Gemm& p, int n0,
                                              int (&acc)[BN / 32][16], Epi epi, LoadA load_a) {
  constexpr int BM = 64, NT = 128, SLOT_BYTES = BM * 128;
  const int kt_n = (p.K + 127) / 128;
  uint8_t* bt = smem;
  uint8_t* ring = smem + kt_n * BN * 128;
  const int tiles = (p.M + BM - 1) / BM;
  const int mine = tiles > static_cast<int>(blockIdx.y)
                       ? (tiles - blockIdx.y + gridDim.y - 1) / gridDim.y
                       : 0;
  const int steps = mine * kt_n;  // (tile, stage) pairs
  if (kt_n == 0) {  // K = 0: every sum is 0
#pragma unroll
    for (int j = 0; j < BN / 32; ++j)
#pragma unroll
      for (int v = 0; v < 16; ++v) acc[j][v] = 0;
    for (int i = 0; i < mine; ++i) epi(acc, (blockIdx.y + i * gridDim.y) * BM);
    return;
  }
  auto load_step = [&](int f) {
    const int i = f / kt_n, kt = f - i * kt_n;
    load_a(ring + (f % SLOTS) * SLOT_BYTES, (blockIdx.y + i * gridDim.y) * BM, kt * 128);
  };
  for (int kt = 0; kt < kt_n; ++kt)
    load_kmajor<BN, NT>(bt + kt * BN * 128, p.b + n0 * p.sbn, p.sbn, p.N - n0, kt * 128, p.K,
                        p.bw);
  cp_async_commit();
#pragma unroll
  for (int f = 0; f < SLOTS - 1; ++f) {
    if (f < steps) load_step(f);
    cp_async_commit();
  }
  const uint32_t sb = smem_u32(bt);
  for (int f = 0; f < steps; ++f) {
    const int i = f / kt_n, kt = f - i * kt_n;
    cp_async_wait<SLOTS - 2>();  // B and stage f have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (f + SLOTS - 1 < steps) load_step(f + SLOTS - 1);
    cp_async_commit();
    if (kt == 0) {
#pragma unroll
      for (int j = 0; j < BN / 32; ++j)
#pragma unroll
        for (int v = 0; v < 16; ++v) acc[j][v] = 0;
    }
    const uint32_t sa = smem_u32(ring + (f % SLOTS) * SLOT_BYTES);
    const int nk = kspan(kt * 128, p.K) / 32;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int kk = 0; kk < nk; ++kk)
#pragma unroll
      for (int j = 0; j < BN / 32; ++j)
        wgmma_n32(acc[j], desc_sw128(sa + kk * 32),
                  desc_sw128(sb + kt * BN * 128 + j * 32 * 128 + kk * 32));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if (kt == kt_n - 1) epi(acc, (blockIdx.y + i * gridDim.y) * BM);
  }
}

template <int BN, typename Epi>
__device__ __forceinline__ void stream_kmajor(uint8_t* smem, const Gemm& p, int n0,
                                              int (&acc)[BN / 32][16], Epi epi) {
  stream_kmajor<BN>(smem, p, n0, acc, epi, [&](uint8_t* st, int m0, int k0) {
    load_kmajor<64, 128>(st, p.a + m0 * p.sam, p.sam, p.M - m0, k0, p.K, p.aw);
  });
}

// Calls f(row, col, value) for each of this thread's sums, in the block's
// coordinates (row < BM, col < BN), whether in range or not.
template <int BN, typename T, typename F>
__device__ __forceinline__ void for_each_kmajor(const T (&acc)[BN / 32][16], F f) {
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 32; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i)
      f(64 * wg + 16 * w + g + 8 * ((i >> 1) & 1), 32 * j + 8 * (i >> 2) + 2 * t + (i & 1),
        acc[j][i]);
}

// --------------------------------------------------------------- MN-major

constexpr int MN_BK = 64;  // rows of K a stage

constexpr int MN_STAGES = 3;  // small rings, so that several blocks share an SM

template <int WGM>  // warps along M (1, 2 or 4); the other 4 / WGM along N
struct MNMajor {
  static constexpr int BM = 64 * WGM, BN = 32 * (4 / WGM), NT = 128;
  static constexpr int PA = BM + 16, PB = BN + 16;  // row pitches, 16-byte aligned
  static constexpr int A_BYTES = MN_BK * PA, STAGE_BYTES = MN_BK * (PA + PB);
  static constexpr int SMEM = MN_STAGES * STAGE_BYTES;
};

// Stages K rows [k0, k0 + 64) x COLS bytes of an MN-major operand (row k at
// base + k * pitch, `cols` bytes valid) into a tile with row pitch P.
template <int COLS, int NT>
__device__ __forceinline__ void load_mnmajor(uint8_t* tile, int P, const int8_t* base,
                                             long long pitch, int cols, int k0, int k_end,
                                             int w) {
  const int unit = w == 1 ? 16 : w;
  const int lg = __ffs(COLS / unit) - 1;  // log2(COLS / unit)
  const int mask = (1 << lg) - 1;
  for (int i = threadIdx.x; i < (MN_BK << lg); i += NT) {
    const int r = i >> lg, c = (i & mask) * unit, k = k0 + r;
    const int bytes = k < k_end ? min(max(cols - c, 0), unit) : 0;
    const int8_t* src = bytes > 0 ? base + k * pitch + c : base;
    if (w == 1)
      copy16_unaligned(tile + r * P + c, src, bytes);
    else
      copy_unit(tile + r * P + c, src, bytes, w);
  }
}

// 4 x 4 byte transpose: byte b of x[j] = byte j of w[b].
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4], uint32_t (&x)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140), t3 = __byte_perm(w[2], w[3], 0x7362);
  x[0] = __byte_perm(t0, t2, 0x5410);
  x[1] = __byte_perm(t0, t2, 0x7632);
  x[2] = __byte_perm(t1, t3, 0x5410);
  x[3] = __byte_perm(t1, t3, 0x7632);
}

#define MH_MMA_S8(ATYPE)                                                     \
  asm volatile(                                                              \
      "mma.sync.aligned.m16n8k32.row.col.s32." ATYPE ".s8.s32 "             \
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"             \
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])                       \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]))

// c += A * B (m16n8k32); A's bytes unsigned where UA, as in wgmma_n32.
template <bool UA = false>
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  if constexpr (UA)
    MH_MMA_S8("u8");
  else
    MH_MMA_S8("s8");
}
#undef MH_MMA_S8

using MNAcc = int[4][4][4];  // [m16 tile][n8 tile][value]

// Each warp owns 64 rows x 32 columns. The mma's row and column labels are
// mapped onto the tile so that one 4 x 4 byte transpose of four 32-bit
// shared loads (4 k-rows x 4 m-bytes) yields a fragment register for four
// m16 tiles: label row g (+8) of tile j is m = 4 g + j (+32); label column
// g of n8 tile j is n = 4 g + j; k keeps its order. See for_each_mnmajor.
// LO as in mainloop_kmajor: A unsigned, acc starting from itself times 256.
template <int WGM, bool LO = false>
__device__ __forceinline__ void mainloop_mnmajor(uint8_t* ring, const Gemm& p, int m0, int n0,
                                                 int k_begin, int k_end, MNAcc& acc) {
  using T = MNMajor<WGM>;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        acc[i][j][v] = LO ? static_cast<int>(static_cast<unsigned>(acc[i][j][v]) << 8) : 0;
  const int kt_n = k_end > k_begin ? (k_end - k_begin + MN_BK - 1) / MN_BK : 0;
  const int8_t* a = p.a + m0;
  const int8_t* b = p.b + n0;
  const int acols = p.M - m0, bcols = p.N - n0;
  auto load = [&](int kt) {
    uint8_t* st = ring + (kt % MN_STAGES) * T::STAGE_BYTES;
    const int k0 = k_begin + kt * MN_BK;
    load_mnmajor<T::BM, T::NT>(st, T::PA, a, p.sak, acols, k0, k_end, p.aw);
    load_mnmajor<T::BN, T::NT>(st + T::A_BYTES, T::PB, b, p.sbk, bcols, k0, k_end, p.bw);
  };
#pragma unroll
  for (int s = 0; s < MN_STAGES - 1; ++s) {
    if (s < kt_n) load(s);
    cp_async_commit();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % WGM, wn = warp / WGM, g = lane >> 2, t = lane & 3;
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<MN_STAGES - 2>();
    __syncthreads();
    if (kt + MN_STAGES - 1 < kt_n) load(kt + MN_STAGES - 1);
    cp_async_commit();
    const uint8_t* as = ring + (kt % MN_STAGES) * T::STAGE_BYTES;
    const uint8_t* bs = as + T::A_BYTES;
#pragma unroll
    for (int ks = 0; ks < MN_BK; ks += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const int kr = ks + 16 * kh + 4 * t;
#pragma unroll
        for (int mh = 0; mh < 2; ++mh) {
          const uint8_t* src = as + kr * T::PA + wm * 64 + 32 * mh + 4 * g;
          uint32_t w[4], x[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] = *reinterpret_cast<const uint32_t*>(src + i * T::PA);
          transpose4(w, x);
#pragma unroll
          for (int j = 0; j < 4; ++j) af[j][mh + 2 * kh] = x[j];
        }
        const uint8_t* src = bs + kr * T::PB + wn * 32 + 4 * g;
        uint32_t w[4], y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = *reinterpret_cast<const uint32_t*>(src + i * T::PB);
        transpose4(w, y);
#pragma unroll
        for (int j = 0; j < 4; ++j) bf[j][kh] = y[j];
      }
#pragma unroll
      for (int jm = 0; jm < 4; ++jm)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) mma_s8<LO>(acc[jm][jn], af[jm], bf[jn]);
    }
  }
  __syncthreads();  // the ring is free for the epilogue
}

// Calls f(row, col, value) for each of this thread's sums, in the block's
// coordinates, whether in range or not.
template <int WGM, typename F>
__device__ __forceinline__ void for_each_mnmajor(const MNAcc& acc, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % WGM, wn = warp / WGM, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int jm = 0; jm < 4; ++jm)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        f(wm * 64 + 32 * (v >> 1) + 4 * g + jm, wn * 32 + 4 * (2 * t + (v & 1)) + jn,
          acc[jm][jn][v]);
}

// ---------------------------------------------------------------- epilogues

// Stores a BM x BN int32 tile, staged in shared memory with row pitch
// BN + 4, to c (row pitch N) at (m0, n0): 16 bytes a store where N % 4 == 0.
template <int BM, int BN, int NT>
__device__ __forceinline__ void store_tile_s32(const int32_t* cs, int32_t* c, int M, int N,
                                               int m0, int n0) {
  const int rows = min(BM, M - m0), cols = min(BN, N - n0);
  if ((N & 3) == 0) {
    for (int i = threadIdx.x; i < BM * (BN / 4); i += NT) {
      const int r = i / (BN / 4), q = 4 * (i % (BN / 4));
      if (r < rows && q < cols)
        *reinterpret_cast<int4*>(c + static_cast<long long>(m0 + r) * N + n0 + q) =
            *reinterpret_cast<const int4*>(cs + r * (BN + 4) + q);
    }
  } else {
    for (int i = threadIdx.x; i < BM * BN; i += NT) {
      const int r = i / BN, q = i % BN;
      if (r < rows && q < cols) c[static_cast<long long>(m0 + r) * N + n0 + q] = cs[r * (BN + 4) + q];
    }
  }
}

// Stores a BM x BN int8 tile, staged in shared memory with row pitch
// BN + 16, to y (row pitch N) at (m0, n0), w bytes a store: the largest of
// 16, 8, 4 and 1 that divides N.
template <int BM, int BN, int NT>
__device__ __forceinline__ void store_tile_s8(const int8_t* ys, int8_t* y, int M, int N, int m0,
                                              int n0) {
  const int rows = min(BM, M - m0), cols = min(BN, N - n0);
  const int w = (N & 15) == 0 ? 16 : (N & 7) == 0 ? 8 : (N & 3) == 0 ? 4 : 1;
  const int per_row = BN / w;
  for (int i = threadIdx.x; i < BM * per_row; i += NT) {
    const int r = i / per_row, q = (i % per_row) * w;
    if (r >= rows || q >= cols) continue;
    int8_t* dst = y + static_cast<long long>(m0 + r) * N + n0 + q;
    const int8_t* src = ys + r * (BN + 16) + q;
    switch (w) {
      case 16: *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src); break;
      case 8: *reinterpret_cast<int2*>(dst) = *reinterpret_cast<const int2*>(src); break;
      case 4: *reinterpret_cast<int*>(dst) = *reinterpret_cast<const int*>(src); break;
      default: *dst = *src;
    }
  }
}

// Sets the kernel's dynamic shared memory limit to `top` (its largest
// launch), launches it with `smem` and returns the first CUDA error.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, int smem, int top, cudaStream_t stream,
           Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, top);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mh90
