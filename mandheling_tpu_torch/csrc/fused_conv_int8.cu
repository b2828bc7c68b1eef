// K3: the two-phase fused NITI conv, an implicit-GEMM int8 convolution. The
// int32 accumulator never reaches device memory: phase 1 keeps only
// max|conv(x, w)|, phase 2 recomputes the conv and writes the requantized
// int8 output directly.
//
// Replaces the TPU kernels of mandheling_tpu/ops/kernels/fused_conv_int8.py:
// `_max_kernel` (the pallas_call in `conv_max_pallas`) and `_requant_kernel`
// (`conv_requant_pallas`). It keeps their contract (NHWC x, HWIO w, any
// forward stride, explicit pads, the forward or the gradient psto epilogue)
// but not their banding: the TPU kernel builds banded weight matrices and
// row slabs so that its matrix unit sees plain 2-D blocks. Here it is a GEMM
// of M = B*OH*OW rows, N = OC columns and K = KH*KW*C, whose A tile each
// block gathers straight from x. The whole K runs inside the block (no
// split-K): the max and the psto need whole sums.
//
// Bound (chip_smoke.py computes it for each shape): phase 2 writes M x N
// int8, so at the stems and LeNet (K <= 1360) the bytes bound both phases or
// sit near the ridge; at ResNet18's 3x3 convs (K = 576..2304) the tensor
// cores' operations bound phase 1, and phase 2 is within 3% of its byte
// bound. Every x pixel is read by up to KH*KW output rows, mostly from L2.
//
// Design, on K1's and K2's wgmma machinery (gemm_s8_sm90.cuh):
// - The gather. For one output pixel and one kernel row dy the KW*C bytes of
//   taps dx = 0..KW-1 lie contiguous in NHWC x, so K is laid out as KH runs
//   of R = KW*C bytes rounded up to 16 (the wrapper pads the weight's runs
//   with zero rows to match), and a 16-byte unit of K is one copy from one
//   run, clipped where the run crosses a pad. Where C % 16 == 0 and x is
//   16-byte aligned a unit is one tap's 16 channels: one cp.async, or zeros
//   in the padding, straight into the 128-byte swizzle wgmma reads. Any
//   other C (the stems' 3, LeNet's 1, 20 and 52) or an unaligned x takes the
//   byte path: the aligned words holding the unit's valid bytes, loaded for
//   all of a thread's rows before any is shifted into place. Each thread
//   stages one 16-byte column of K for 4 rows of a tile, and keeps those
//   rows' pixel (offset, ih0, valid byte range) in registers while its tile
//   lasts: no division per unit.
// - The routes. Where B (the whole K of BN columns) fits twice per SM beside
//   a 4-slot ring, K2's stream_kmajor keeps it resident while one warpgroup
//   walks many 64-row M tiles, their A stages streaming through the ring
//   (the stems, LeNet, ResNet18's layer1). Otherwise a block of two
//   warpgroups computes one 128-row tile on K1's 4-stage ring. BN is N
//   rounded up to 32, 64, 128 or 256 (N = 512 in two tiles), so x is
//   gathered once per call (twice at N = 512).
// - B is the HWIO weight, N-major; 8-bit wgmma takes no transpose, so the
//   wrapper copies it K-major (with the padded runs) once per call, as K1's
//   and K2's forwards do: one small copy (at most 1.2 MB), against a
//   transposing load in every block's every stage.
// - Phase 1 ends in its own launch (mh::block_max_ticket): no fill launch
//   before it, and its two-int state is back at {INT32_MIN, 0} after each
//   call. Phase 2 requantizes into an int8 tile in shared memory and stores
//   it 16 bytes a thread where N allows. The psto epilogue is mh::requant.
#include <algorithm>

#include "gemm_s8_sm90.cuh"
#include "niti_epilogue.cuh"

namespace {

struct ConvArgs {
  const int8_t* x;  // NHWC (B, H, W, C), contiguous
  int B, H, W, C;
  int OH, OW;
  int KH, KW, SH, SW, PT, PL;
  int R;  // bytes of K one kernel row takes: KW * C rounded up to 16
};

// The byte path, in two halves so that a thread's loads for all its rows
// are in flight together: `fetch` reads the aligned 32-bit words that hold
// bytes [lo, hi) of the 16 at src (any alignment, 0 <= lo <= hi <= 16; no
// word without one of them), and `place` shifts them into 16 bytes at dst,
// the others zero.
struct Words {
  uint32_t w[5];
  int off, lo, hi;
};

// *p where `load`, else 0; the load is predicated in PTX, so that it is
// never issued for a word outside x (the compiler may not hoist it).
__device__ __forceinline__ uint32_t load_if(const uint32_t* p, bool load) {
  uint32_t v;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "mov.b32 %0, 0;\n"
      "@p ld.global.nc.b32 %0, [%1];\n"
      "}\n"
      : "=r"(v)
      : "l"(p), "r"(static_cast<int>(load)));
  return v;
}

// An empty range [lo, lo) loads nothing: src then need not point into x
// (a row in the padding), and the word at src & ~3 may lie before x's first
// byte, outside any allocation.
__device__ __forceinline__ void fetch(Words& u, const int8_t* src, int lo, int hi) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  const uint32_t* q = reinterpret_cast<const uint32_t*>(addr & ~uintptr_t(3));
  u.off = static_cast<int>(addr & 3);
  u.lo = lo;
  u.hi = hi;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int s = 4 * i - u.off;  // word i holds bytes [s, s + 4) of the unit
    u.w[i] = load_if(q + i, lo < hi && s < hi && s + 4 > lo);
  }
}

__device__ __forceinline__ void place(uint8_t* dst, const Words& u) {
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = min(max(u.lo - 4 * i, 0), 4), b = min(max(u.hi - 4 * i, 0), 4);
    const uint32_t below_b = b >= 4 ? 0xffffffffu : (1u << (8 * b)) - 1u;
    const uint32_t below_a = a >= 4 ? 0xffffffffu : (1u << (8 * a)) - 1u;
    o[i] = __funnelshift_r(u.w[i], u.w[i + 1], 8 * u.off) & (below_b & ~below_a);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
}

// The A tile of the implicit GEMM: A(m, k) = x[b, ih0 + dy, iw0 + dx, c] for
// k = dy * R + dx * C + c (dx * C + c < KW * C), 0 in the padding, in a run's
// tail and past M or K. Staged as load_kmajor stages a K-major operand (rows
// [0, BM) x bytes [k0, k0 + kspan), 128-byte swizzle): thread t takes the
// 16-byte column t % 8 of rows t / 8 + i * NT / 8, i < 4.
template <int BM, int NT, bool kVec>
struct Gather {
  static constexpr int ROWS = BM * 8 / NT;
  const ConvArgs g;
  const int M, K;
  int m_rows = -1;             // the tile whose rows are cached
  long long base[ROWS];        // offset of x[b, ih0, iw0, 0]
  int ih0[ROWS], lo[ROWS], hi[ROWS];  // [lo, hi): the bytes of a run inside x

  __device__ __forceinline__ void rows(int m0) {
    m_rows = m0;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int m = m0 + (threadIdx.x >> 3) + i * (NT / 8);
      ih0[i] = 0;
      base[i] = 0;
      lo[i] = hi[i] = 0;
      if (m < M) {
        const int per = g.OH * g.OW;
        const int b = m / per, rem = m - b * per;
        const int oh = rem / g.OW, ow = rem - oh * g.OW;
        const int iw0 = ow * g.SW - g.PL;
        ih0[i] = oh * g.SH - g.PT;
        base[i] = ((static_cast<long long>(b) * g.H + ih0[i]) * g.W + iw0) * g.C;
        lo[i] = max(-iw0, 0) * g.C;
        hi[i] = min(g.KW, g.W - iw0) * g.C;
      }
    }
  }

  __device__ __forceinline__ void operator()(uint8_t* tile, int m0, int k0) {
    const int u = threadIdx.x & 7;
    if (16 * u >= mh90::kspan(k0, K)) return;  // past the span: not read
    if (m0 != m_rows) rows(m0);
    const int k = k0 + 16 * u;
    const bool kin = k < K;
    const int dy = kin ? k / g.R : 0, j = k - dy * g.R;
    const long long run = static_cast<long long>(dy) * g.W * g.C + j;
    Words words[kVec ? 1 : ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = (threadIdx.x >> 3) + i * (NT / 8);
      uint8_t* dst = tile + r * 128 + ((u ^ (r & 7)) << 4);
      const int ih = ih0[i] + dy;
      const int a = max(lo[i] - j, 0), b = min(hi[i] - j, 16);
      const bool any = kin && ih >= 0 && ih < g.H && b > a;
      const int8_t* src = g.x + (base[i] + run);
      if constexpr (kVec) {  // a unit is one tap's 16 channels: all in x or none
        if (any)
          mh90::cp_async<16>(mh90::smem_u32(dst), src, 16);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      } else {
        fetch(words[i], src, any ? a : 0, any ? b : 0);
      }
    }
    if constexpr (!kVec) {
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int r = (threadIdx.x >> 3) + i * (NT / 8);
        place(tile + r * 128 + ((u ^ (r & 7)) << 4), words[i]);
      }
    }
  }
};

// kMode: 0 = phase 1 (max), 1 = phase 2 forward, 2 = phase 2 gradient.
// y is NHWC (B, OH, OW, OC), i.e. row-major (M, N).
template <int BN, int kMode, bool kVec>
__global__ void __launch_bounds__(128)
    conv_stream_kernel(ConvArgs g, mh90::Gemm p, int* state, int* out_max,
                       const int* shift_ptr, int8_t* y) {
  uint8_t* smem = mh90::aligned_smem();
  const int n0 = blockIdx.x * BN;
  int acc[BN / 32][16];
  Gather<64, 128, kVec> gather{g, p.M, p.K};
  if constexpr (kMode == 0) {
    int local = INT_MIN;
    mh90::stream_kmajor<BN>(
        smem, p, n0, acc,
        [&](const int (&a)[BN / 32][16], int m0) {
          mh90::for_each_kmajor<BN>(a, [&](int r, int q, int v) {
            if (m0 + r < p.M && n0 + q < p.N) local = max(local, mh::wrap_abs(v));
          });
        },
        gather);
    mh::block_max_ticket(local, state, out_max);
  } else {
    int8_t* ys = reinterpret_cast<int8_t*>(smem + mh90::stream_smem(p.K, BN, 0) - 1024);
    const int shift = *shift_ptr;
    mh90::stream_kmajor<BN>(
        smem, p, n0, acc,
        [&](const int (&a)[BN / 32][16], int m0) {
          mh90::for_each_kmajor<BN>(a, [&](int r, int q, int v) {
            ys[r * (BN + 16) + q] = mh::requant(v, shift, kMode == 2);
          });
          __syncthreads();
          mh90::store_tile_s8<64, BN, 128>(ys, y, p.M, p.N, m0, n0);
        },
        gather);
  }
}

template <int BN, int kMode, bool kVec>
__global__ void __launch_bounds__(256)
    conv_ring_kernel(ConvArgs g, mh90::Gemm p, int* state, int* out_max, const int* shift_ptr,
                     int8_t* y) {
  uint8_t* ring = mh90::aligned_smem();
  const int m0 = blockIdx.x * 128, n0 = blockIdx.y * BN;
  int acc[BN / 32][16];
  mh90::mainloop_kmajor<2, BN>(ring, p, m0, n0, 0, p.K, acc,
                               Gather<128, 256, kVec>{g, p.M, p.K});
  if constexpr (kMode == 0) {
    int local = INT_MIN;
    mh90::for_each_kmajor<BN>(acc, [&](int r, int q, int v) {
      if (m0 + r < p.M && n0 + q < p.N) local = max(local, mh::wrap_abs(v));
    });
    mh::block_max_ticket(local, state, out_max);
  } else {
    const int shift = *shift_ptr;
    int8_t* ys = reinterpret_cast<int8_t*>(ring);
    mh90::for_each_kmajor<BN>(acc, [&](int r, int q, int v) {
      ys[r * (BN + 16) + q] = mh::requant(v, shift, kMode == 2);
    });
    __syncthreads();
    mh90::store_tile_s8<128, BN, 256>(ys, y, p.M, p.N, m0, n0);
  }
}

struct Out {
  int* state;
  int* out_max;
  const int* shift;
  int8_t* y;
};

// The route for these operands (see the note above), launched.
template <int BN, int kMode, bool kVec>
int launch_bn(const ConvArgs& g, const mh90::Gemm& p, const Out& o, cudaStream_t st) {
  int dev = 0, sms = 0, limit = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (p.N + BN - 1) / BN;
  const int smem = mh90::stream_smem(p.K, BN, kMode == 0 ? 0 : 64 * (BN + 16));
  if (2 * smem <= limit) {
    auto kernel = conv_stream_kernel<BN, kMode, kVec>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 128, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int m_tiles = (p.M + 63) / 64;
    const int want = (sms * std::max(per_sm, 1) + n_tiles - 1) / n_tiles;
    const dim3 grid(n_tiles, std::max(1, std::min(m_tiles, want)));
    kernel<<<grid, 128, smem, st>>>(g, p, o.state, o.out_max, o.shift, o.y);
    return static_cast<int>(cudaGetLastError());
  }
  using T = mh90::KMajor<2, BN>;
  const dim3 grid((p.M + 127) / 128, n_tiles);
  return mh90::launch(conv_ring_kernel<BN, kMode, kVec>, grid, 256,
                      T::smem(p.K, 128 * (BN + 16)), T::MAX_SMEM, st, g, p, o.state, o.out_max,
                      o.shift, o.y);
}

template <int kMode, bool kVec>
int launch_mode(const ConvArgs& g, const mh90::Gemm& p, const Out& o, cudaStream_t st) {
  if (p.N <= 32) return launch_bn<32, kMode, kVec>(g, p, o, st);
  if (p.N <= 64) return launch_bn<64, kMode, kVec>(g, p, o, st);
  if (p.N <= 128) return launch_bn<128, kMode, kVec>(g, p, o, st);
  return launch_bn<256, kMode, kVec>(g, p, o, st);
}

template <int kMode>
int launch_vec(bool vec, const ConvArgs& g, const mh90::Gemm& p, const Out& o, cudaStream_t st) {
  return vec ? launch_mode<kMode, true>(g, p, o, st) : launch_mode<kMode, false>(g, p, o, st);
}

int run(int mode, const void* x, const void* wk, const Out& o, int B, int H, int W, int C,
        int OH, int OW, int OC, int KH, int KW, int SH, int SW, int PT, int PL, int R,
        void* stream) {
  const ConvArgs g{static_cast<const int8_t*>(x), B, H, W, C, OH, OW, KH, KW, SH, SW, PT, PL, R};
  const int K = KH * R;
  // B(k, n) = wk[n * K + k]: the weight K-major with its runs padded to R
  const mh90::Gemm p{nullptr, static_cast<const int8_t*>(wk), B * OH * OW, OC, K,
                     0, 1, 1, K, 16, 16, K};
  const bool vec = C % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) return launch_vec<0>(vec, g, p, o, st);
  if (mode == 1) return launch_vec<1>(vec, g, p, o, st);
  return launch_vec<2>(vec, g, p, o, st);
}

}  // namespace

// Both return the first CUDA error of the launch. wk is the weight as the
// K-major (OC, KH * R) matrix, 16-byte aligned: row n holds, for each dy,
// w[dy, :, :, n] flattened (KW * C bytes) and zeros up to R.
// state: two ints, {INT32_MIN, 0} before the first call on `stream`; every
// call leaves them so.
extern "C" int mh_fused_conv_max(const void* x, const void* wk, void* state, void* out_max, int B,
                                 int H, int W, int C, int OH, int OW, int OC, int KH, int KW,
                                 int SH, int SW, int PT, int PL, int R, void* stream) {
  const Out o{static_cast<int*>(state), static_cast<int*>(out_max), nullptr, nullptr};
  return run(0, x, wk, o, B, H, W, C, OH, OW, OC, KH, KW, SH, SW, PT, PL, R, stream);
}

extern "C" int mh_fused_conv_requant(const void* x, const void* wk, const void* shift, void* y,
                                     int B, int H, int W, int C, int OH, int OW, int OC, int KH,
                                     int KW, int SH, int SW, int PT, int PL, int R, int grad,
                                     void* stream) {
  const Out o{nullptr, nullptr, static_cast<const int*>(shift), static_cast<int8_t*>(y)};
  return run(grad ? 2 : 1, x, wk, o, B, H, W, C, OH, OW, OC, KH, KW, SH, SW, PT, PL, R, stream);
}
