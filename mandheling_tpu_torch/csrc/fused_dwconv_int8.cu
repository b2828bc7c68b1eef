// K4: the two-phase fused NITI depthwise conv. The int32 accumulator never
// reaches device memory: phase 1 keeps only max|acc|, phase 2 recomputes
// the taps and writes the requantized int8 output directly.
//
// Replaces the TPU kernels of mandheling_tpu/ops/kernels/fused_dwconv_int8.py:
// `_max_kernel` (the pallas_call in `dwconv_max_pallas`) and
// `_requant_kernel` (`dwconv_requant_pallas`). Same contract: a VALID
// stride-1 depthwise conv with w (KH, KW, 1, C) over the padded input; the
// forward or the gradient psto epilogue. Three operands widen it, each doing
// in the kernel what a caller did in torch around it:
//
// - x comes unpadded, with its top and left pads (the bottom and right ones
//   follow from OH, OW): taps outside x read zero;
// - a dilation (dh, dw): the input is x with dh-1 zero rows and dw-1 zero
//   columns inserted between its own, as the input grad of a strided conv
//   sees the output diff. The kernel reads x undilated and skips the taps
//   that land on inserted zeros; with `rot`, it reads w rotated by 180
//   degrees, the input grad's filter;
// - an optional per-channel left shift s_c (int32 (C,), or null), applied
//   to each accumulator as (int)((unsigned)acc << s_c) before phase 1's
//   absolute value and phase 2's epilogue: the wrap of torch's and XLA's
//   int32 <<, the per-channel depthwise exponents' alignment.
//
// No channel contraction, so no tensor-core work: KH*KW multiply-adds of
// int8 operands per output on the CUDA cores. Every depthwise layer of the
// MobileNets is 3x3 with C % 4 == 0, and it has an instance of its own. NHWC
// keeps channels contiguous, so there a thread takes 4 channels in one
// 32-bit word and neighbouring threads neighbouring words of one output row:
// each load of a warp covers 128 contiguous bytes, and so does each phase-2
// store. A thread walks a run of up to kRows output rows of one column with
// its 3x3 window in registers: each output row loads one new input row of 3
// words (the next one in flight while the current one is multiplied), and 6
// PRMT turn them into one word per channel holding that row's 3 horizontal
// taps, so a row of the window costs one IDP4A per channel (3 an output, not
// 9). The three window rows rotate through the registers, never copied.
// Columns and pads are resolved once per thread and rows by a cursor, with
// no division per element; the grid is flat over (image, row run, column,
// channel word), so a block spans images at small maps and every block has
// 256 threads of work. With a dilation the columns are ordered by class (ow
// mod dw), so a warp's threads share which columns are inserted zeros and
// skip those loads together, and a block which rows are (their IDP4A skipped
// too). Phase 1 ends in one launch: per-block maxima and a last-block
// reduction. Every other input (another kernel size, as the JAX kernel takes
// any, C % 4 != 0 or an unaligned pointer) goes to one untiled instance, a
// thread an output byte, that reads its taps through the cache. The
// epilogues are K2's and K3's (niti_epilogue.cuh), unchanged.
//
// Bound, at (256, 32, 32, 144) stride 1, 37.7 M outputs: a phase reads 37.7
// MB (11.3 us at 3.35 TB/s); per output, phase 1 runs 3 IDP4A, the shift,
// |.| and max (13.5 us at 64 integer instructions a clock on each of 132
// SMs, 16.7 T/s at 1.98 GHz) and phase 2 3 IDP4A, the shift, psto_round's
// ~25 and the byte pack (68 us). So phase 1 is bound by bytes and
// instructions alike, and phase 2 by the CUDA cores' integer instructions,
// not by bytes: the psto epilogue is most of it.
#include "niti_epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;  // output rows a thread of the 3x3 instance walks

struct DwArgs {
  const int8_t* x;  // (B, H, W, C), contiguous, unpadded and undilated
  const int8_t* w;  // (KH*KW, C), contiguous
  const int* pc;    // (C,) per-channel left shifts, or null
  int B, H, W, C, KH, KW;
  int pt, pl;       // top and left pads of the dilated input
  int dh, dw;       // dilation
  int OH, OW;
  int rot;          // read w rotated by 180 degrees
  int rows;         // output rows a thread walks (3x3 instance)
  int row_blocks;   // ceil(OH / rows)
  unsigned items;   // threads with work (< 2^31: the wrapper checks the output's size)
  int* partials;    // phase 1: one max per block
  unsigned* ticket; // phase 1: 0 between calls
};

// q = floor(s / d), m = s - q * d in [0, d), for d > 0 and any s.
__device__ __forceinline__ void floor_div(int s, int d, int& q, int& m) {
  q = s >= 0 ? s / d : -((d - 1 - s) / d);
  m = s - q * d;
}

// The weight word of tap t (w read rotated by 180 degrees if a.rot) for
// channel word cw of 4 channels.
__device__ __forceinline__ unsigned tap_word(const DwArgs& a, int t, int cw) {
  if (a.rot) t = a.KH * a.KW - 1 - t;
  return __ldg(reinterpret_cast<const unsigned*>(a.w + static_cast<long long>(t) * a.C) + cw);
}

// The shared tail of an output of V channels: the per-channel shift, then
// phase 1's max or phase 2's requant and one V-byte store.
template <int V, int kMode>
__device__ __forceinline__ void epilogue(const int (&acc)[V], const int (&sh)[V], int shift,
                                         int& local, int8_t* y) {
  unsigned packed = 0;
#pragma unroll
  for (int c = 0; c < V; ++c) {
    const int v = static_cast<int>(static_cast<unsigned>(acc[c]) << sh[c]);
    if constexpr (kMode == 0)
      local = max(local, mh::wrap_abs(v));
    else
      packed |= static_cast<unsigned>(static_cast<uint8_t>(mh::requant(v, shift, kMode == 2)))
                << (8 * c);
  }
  if constexpr (kMode != 0) {
    if constexpr (V == 4)
      *reinterpret_cast<unsigned*>(y) = packed;
    else
      *y = static_cast<int8_t>(packed);
  }
}

template <int V>
__device__ __forceinline__ void load_shifts(const DwArgs& a, int cw, int (&sh)[V]) {
#pragma unroll
  for (int c = 0; c < V; ++c) sh[c] = a.pc ? __ldg(a.pc + cw * V + c) : 0;
}

// Walks the input rows of a thread's window: logical row s of the padded,
// dilated input is x's row q when s = q * dh (m == 0) and 0 <= q < H.
struct RowCursor {
  int q, m;
};

template <bool kDil>
__device__ __forceinline__ bool next_row(const DwArgs& a, const int8_t* xb, RowCursor& cur,
                                         const int (&coff)[3], const bool (&cv)[3],
                                         unsigned (&dst)[3]) {
  const bool valid = cur.q >= 0 && cur.q < a.H && (!kDil || cur.m == 0);
  const int8_t* row = xb + static_cast<long long>(cur.q) * a.W * a.C;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
    dst[dx] = valid && cv[dx] ? __ldg(reinterpret_cast<const unsigned*>(row + coff[dx])) : 0u;
  if (kDil) {
    if (++cur.m == a.dh) {
      cur.m = 0;
      ++cur.q;
    }
  } else {
    ++cur.q;
  }
  return valid;
}

// Phase 1's end in one launch: each block stores its max, and the block that
// takes the last ticket reduces them into *out and sets the ticket back to 0
// for the next call on its stream. (A separate kernel to set *out to INT32_MIN
// first, or one to reduce, costs a launch a call, ~3 us each back to back.)
__device__ __forceinline__ void block_max_last(int local, int* partials, unsigned* ticket,
                                               int* out) {
  __shared__ int warp_max[kThreads / 32];
  __shared__ bool last;
  local = __reduce_max_sync(0xffffffffu, local);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) m = max(m, warp_max[w]);
    partials[blockIdx.x] = m;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  int m = INT_MIN;
  for (unsigned i = threadIdx.x; i < gridDim.x; i += kThreads) m = max(m, __ldcg(partials + i));
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = max(m, warp_max[w]);
    *out = m;
    *ticket = 0u;
  }
}

// The 3 words of one input row (columns ow..ow+2, 4 channels each) ->
// for each channel c the word (col0.c, col1.c, col2.c, junk), the operand of
// one IDP4A over the row's 3 horizontal taps: 6 PRMT.
__device__ __forceinline__ void transpose_row(const unsigned (&cols)[3], unsigned (&t)[4]) {
  const unsigned lo = __byte_perm(cols[0], cols[1], 0x5140);
  const unsigned hi = __byte_perm(cols[0], cols[1], 0x7362);
  t[0] = __byte_perm(lo, cols[2], 0x0410);
  t[1] = __byte_perm(lo, cols[2], 0x0532);
  t[2] = __byte_perm(hi, cols[2], 0x0610);
  t[3] = __byte_perm(hi, cols[2], 0x0732);
}

// kMode: 0 = phase 1 (max), 1 = phase 2 forward, 2 = phase 2 gradient.
// A row of the window is kept as 4 words, one per channel, each holding the
// row's 3 horizontal taps.
template <bool kDil, int kMode>
__global__ void __launch_bounds__(kThreads)
    dw3x3_kernel(DwArgs a, const int* shift_ptr, int* out_max, int8_t* y) {
  const unsigned gid = blockIdx.x * kThreads + threadIdx.x;
  int local = INT_MIN;
  if (gid < a.items) {  // 32-bit index math: a 64-bit division is a long subroutine
    const unsigned cw_n = a.C / 4;
    const int cw = static_cast<int>(gid % cw_n);
    unsigned rest = gid / cw_n;
    int j = static_cast<int>(rest % static_cast<unsigned>(a.OW));
    rest /= static_cast<unsigned>(a.OW);
    const int rb = static_cast<int>(rest % static_cast<unsigned>(a.row_blocks));
    const int b = static_cast<int>(rest / static_cast<unsigned>(a.row_blocks));
    int ow = j;
    if (kDil && a.dw > 1) {  // columns by class ow mod dw, class 0 first: see the note above
      int o0 = 0, n = (a.OW + a.dw - 1) / a.dw;
      while (j >= n) {
        j -= n;
        ++o0;
        n = (a.OW - o0 + a.dw - 1) / a.dw;
      }
      ow = o0 + a.dw * j;
    }

    int coff[3];
    bool cv[3];
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      int q = ow + dx - a.pl, m = 0;
      if (kDil) floor_div(q, a.dw, q, m);
      cv[dx] = q >= 0 && q < a.W && m == 0;
      coff[dx] = cv[dx] ? q * a.C + cw * 4 : 0;
    }
    unsigned wrow[3][4];  // row dy's 3 taps of channel c, byte 3 zero
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const unsigned taps[3] = {tap_word(a, dy * 3, cw), tap_word(a, dy * 3 + 1, cw),
                                tap_word(a, dy * 3 + 2, cw)};
      transpose_row(taps, wrow[dy]);
#pragma unroll
      for (int c = 0; c < 4; ++c) wrow[dy][c] &= 0x00ffffffu;
    }
    int sh[4];
    load_shifts<4>(a, cw, sh);
    const int shift = kMode == 0 ? 0 : __ldg(shift_ptr);

    const int oh0 = rb * a.rows, oh1 = min(oh0 + a.rows, a.OH);
    const int8_t* xb = a.x + static_cast<long long>(b) * a.H * a.W * a.C;
    RowCursor cur;
    cur.q = oh0 - a.pt;
    cur.m = 0;
    if (kDil) floor_div(oh0 - a.pt, a.dh, cur.q, cur.m);
    auto fetch = [&](unsigned (&dst)[4]) {
      unsigned cols[3];
      const bool valid = next_row<kDil>(a, xb, cur, coff, cv, cols);
      transpose_row(cols, dst);
      return valid;
    };
    unsigned r0[4], r1[4], r2[4];
    bool v0 = fetch(r0), v1 = fetch(r1), v2 = fetch(r2);
    int8_t* yrow = y + ((static_cast<long long>(b) * a.OH + oh0) * a.OW + ow) * a.C + cw * 4;
    const long long ystep = static_cast<long long>(a.OW) * a.C;

    // One output row from the window (top, mid, bot); then the next input
    // row, loaded before the multiply-adds, takes top's registers. Called
    // with the three rows rotated, so the window never moves.
    int oh = oh0;
    auto step = [&](unsigned (&top)[4], unsigned (&mid)[4], unsigned (&bot)[4], bool& vt,
                    bool vm, bool vb) {
      unsigned cols[3] = {0u, 0u, 0u};
      bool nv = false;
      if (oh + 1 < oh1) nv = next_row<kDil>(a, xb, cur, coff, cv, cols);
      int acc[4] = {0, 0, 0, 0};
      auto row_mac = [&](const unsigned (&r)[4], int dy) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[c] = __dp4a(static_cast<int>(r[c]), static_cast<int>(wrow[dy][c]), acc[c]);
      };
      // an inserted zero row (kDil) is skipped: uniform across the block
      if (!kDil || vt) row_mac(top, 0);
      if (!kDil || vm) row_mac(mid, 1);
      if (!kDil || vb) row_mac(bot, 2);
      epilogue<4, kMode>(acc, sh, shift, local, yrow);
      yrow += ystep;
      transpose_row(cols, top);
      vt = nv;
      ++oh;
    };
    while (oh < oh1) {
      step(r0, r1, r2, v0, v1, v2);
      if (oh >= oh1) break;
      step(r1, r2, r0, v1, v2, v0);
      if (oh >= oh1) break;
      step(r2, r0, r1, v2, v0, v1);
    }
  }
  if (kMode == 0) block_max_last(local, a.partials, a.ticket, out_max);
}

// Every other input: one thread per output byte, the taps read through the
// cache with their bounds and dilation tested per tap.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
    dw_any_kernel(DwArgs a, const int* shift_ptr, int* out_max, int8_t* y) {
  const unsigned gid = blockIdx.x * kThreads + threadIdx.x;
  int local = INT_MIN;
  if (gid < a.items) {
    const int c = static_cast<int>(gid % static_cast<unsigned>(a.C));
    unsigned rest = gid / static_cast<unsigned>(a.C);
    const int ow = static_cast<int>(rest % static_cast<unsigned>(a.OW));
    rest /= static_cast<unsigned>(a.OW);
    const int oh = static_cast<int>(rest % static_cast<unsigned>(a.OH));
    const int b = static_cast<int>(rest / static_cast<unsigned>(a.OH));
    const int8_t* xb = a.x + static_cast<long long>(b) * a.H * a.W * a.C + c;
    const int taps = a.KH * a.KW;
    int acc[1] = {0};
    for (int ty = 0; ty < a.KH; ++ty) {
      int q = oh + ty - a.pt, m;
      floor_div(q, a.dh, q, m);
      if (q < 0 || q >= a.H || m != 0) continue;
      for (int tx = 0; tx < a.KW; ++tx) {
        int p = ow + tx - a.pl, n;
        floor_div(p, a.dw, p, n);
        if (p < 0 || p >= a.W || n != 0) continue;
        const int t = a.rot ? taps - 1 - (ty * a.KW + tx) : ty * a.KW + tx;
        acc[0] += static_cast<int>(__ldg(xb + (static_cast<long long>(q) * a.W + p) * a.C)) *
                  static_cast<int>(__ldg(a.w + static_cast<long long>(t) * a.C + c));
      }
    }
    int sh[1];
    load_shifts<1>(a, c, sh);
    const int shift = kMode == 0 ? 0 : __ldg(shift_ptr);
    epilogue<1, kMode>(acc, sh, shift, local,
                       y + ((static_cast<long long>(b) * a.OH + oh) * a.OW + ow) * a.C + c);
  }
  if (kMode == 0) block_max_last(local, a.partials, a.ticket, out_max);
}

template <int kMode>
void launch_mode(const DwArgs& a, bool tiled, bool dil, const int* shift, int* out_max,
                 int8_t* y, cudaStream_t st) {
  const unsigned grid = (a.items + kThreads - 1) / kThreads;
  if (!tiled)
    dw_any_kernel<kMode><<<grid, kThreads, 0, st>>>(a, shift, out_max, y);
  else if (dil)
    dw3x3_kernel<true, kMode><<<grid, kThreads, 0, st>>>(a, shift, out_max, y);
  else
    dw3x3_kernel<false, kMode><<<grid, kThreads, 0, st>>>(a, shift, out_max, y);
}

// Returns cudaGetLastError().
int launch(const void* x, const void* w, const void* pc, int B, int H, int W, int C, int KH,
           int KW, int pt, int pl, int dh, int dw, int OH, int OW, int rot, int mode,
           const void* shift, void* out_max, void* partials, void* ticket, void* y,
           void* stream) {
  DwArgs a;
  a.partials = static_cast<int*>(partials);
  a.ticket = static_cast<unsigned*>(ticket);
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.pc = static_cast<const int*>(pc);
  a.B = B;
  a.H = H;
  a.W = W;
  a.C = C;
  a.KH = KH;
  a.KW = KW;
  a.pt = pt;
  a.pl = pl;
  a.dh = dh;
  a.dw = dw;
  a.OH = OH;
  a.OW = OW;
  a.rot = rot;
  const bool tiled = KH == 3 && KW == 3 && C % 4 == 0 &&
                     ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                       reinterpret_cast<uintptr_t>(y)) & 3u) == 0;
  const int words = tiled ? C / 4 : C;
  a.rows = tiled ? min(OH, kRows) : 1;
  a.row_blocks = (OH + a.rows - 1) / a.rows;
  a.items = static_cast<unsigned>(B) * a.row_blocks * OW * words;
  const bool dil = dh > 1 || dw > 1;
  const int* sp = static_cast<const int*>(shift);
  int* mp = static_cast<int*>(out_max);
  int8_t* yp = static_cast<int8_t*>(y);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    launch_mode<0>(a, tiled, dil, sp, mp, yp, st);
  } else if (mode == 1) {
    launch_mode<1>(a, tiled, dil, sp, mp, yp, st);
  } else {
    launch_mode<2>(a, tiled, dil, sp, mp, yp, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// partials: at least one int per block (ceil(B*OH*OW*C / 256) will do);
// ticket: one unsigned, 0 before the first call on `stream`, left at 0.
extern "C" int mh_fused_dwconv_max(const void* x, const void* w, const void* pc, void* out_max,
                                   void* partials, void* ticket, int B, int H, int W, int C,
                                   int KH, int KW, int pt, int pl, int dh, int dw, int OH, int OW,
                                   int rot, void* stream) {
  return launch(x, w, pc, B, H, W, C, KH, KW, pt, pl, dh, dw, OH, OW, rot, 0, nullptr, out_max,
                partials, ticket, nullptr, stream);
}

extern "C" int mh_fused_dwconv_requant(const void* x, const void* w, const void* pc,
                                       const void* shift, void* y, int B, int H, int W, int C,
                                       int KH, int KW, int pt, int pl, int dh, int dw, int OH,
                                       int OW, int rot, int grad, void* stream) {
  return launch(x, w, pc, B, H, W, C, KH, KW, pt, pl, dh, dw, OH, OW, rot, grad ? 2 : 1, shift,
                nullptr, nullptr, nullptr, y, stream);
}
