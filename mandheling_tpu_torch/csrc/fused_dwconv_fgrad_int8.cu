// K5: the int32 depthwise filter-grad accumulator in one launch.
//
//   dw[dy, dx, 0, c] = sum_{b, oh, ow} xpad[b, oh*sh + dy, ow*sw + dx, c] * gy[b, oh, ow, c]
//
// over the int8 input x (B, H, W, C), read unpadded with its top and left
// pads (the bottom and right ones follow from gy's shape: taps outside x read
// zero), a stride (sh, sw), and the int8 output diff gy (B, OH, OW, C) of the
// strided depthwise conv. The output is (KH*KW, C) int32.
//
// Replaces the TPU kernel of mandheling_tpu/ops/kernels/fused_dwconv_int8.py:
// `_fgrad_kernel` (the pallas_call in `dwconv_fgrad_acc_pallas`), whose
// per-batch-tile int32 partial sums XLA then adds up. That kernel takes a
// pre-padded input at stride 1 only; this one takes the pads and any stride,
// so it also serves the strided filter grads, which the JAX package computes
// as a batch-grouped conv (mandheling_tpu/ops/depthwise.py) with the same
// bytes.
//
// Exactness: the sums wrap modulo 2^32, as the TPU kernel's int32 partials
// and XLA's int32 accumulation do. Addition modulo 2^32 is associative and
// commutative, so the order in which threads and blocks add does not change
// a single bit.
//
// The sum in one launch, with no zeroed output: each block adds its partial
// sums into a scratch accumulator `acc` (KH*KW, C) with atomicAdd; the grid
// is cut into columns of 32 channels, and the block that takes the last
// ticket of its column moves that column's sums into `out` by atomicExch,
// which leaves `acc` at 0, and sets the ticket back to 0. INVARIANT: `acc`
// and `tickets` are all 0 before and after every call, so the wrapper zeroes
// them once per stream and a captured CUDA graph can replay the launch.
//
// Layout and instances. No channel contraction, so no tensor-core work:
// KH*KW multiply-adds of int8 operands per gy element on the CUDA cores.
// Every MobileNet depthwise layer is 3x3 with C % 4 == 0 at stride 1 or 2,
// and has the packed instance (one per stride class (sh, sw) in {1, 2}^2):
//
// - a thread owns 4 channels (one 32-bit word of NHWC) and 4 neighbouring
//   output columns ow0..ow0+3, and walks a run of gy rows. Neighbouring
//   threads take neighbouring channel words (32 bytes) and neighbouring
//   column groups, so a warp's loads cover whole 32-byte sectors;
// - it walks the x rows under its run once each, top to bottom. x row p
//   meets gy row oh at tap row dy = p - oh*sh; those gy rows (up to 3 at
//   stride 1, 2 at stride 2) stay in registers, so each x row and each gy
//   row is loaded once by the thread (the x rows where two runs meet, twice);
// - the loads are cp.async copies into a per-thread ring of kStages rows in
//   shared memory, kStages - 1 rows ahead of the row being multiplied, so no
//   registers hold rows in flight (one, two or three rows ahead time the same
//   on the MobileNetV2 shapes);
// - the loaded words are transposed by PRMT (__byte_perm): gy's 4 columns x
//   4 channels into one word per channel holding its 4 columns, and x's
//   3*sw + 3 columns into, per channel, the words of the 3 horizontal taps
//   (dx = 1, 2 are byte funnels of two neighbouring transposed words at
//   stride 1; at stride 2 the even and odd columns part, and dx = 2 is the
//   even word funnelled with the next column). One IDP4A then adds one tap
//   of one channel over 4 output columns;
// - per x row and thread: 3*sw + 3 word loads of x, 18 (sw 1) or 20 (sw 2)
//   PRMT, and 12 IDP4A for each gy row it meets; per gy row and thread 4
//   word loads and 8 PRMT. At stride 1 that is 36 IDP4A, 26 PRMT and 10 loads
//   per 16 gy elements (each 9 multiply-adds): 2.25 IDP4A, 1.6 PRMT and 0.6
//   loads a gy element;
// - the thread's 36 sums are reduced over the block by warp shuffles and
//   shared memory before the 288 atomics of a block's 32 channels.
//
// One untiled, byte-wise instance takes every other input (any kernel size,
// as the JAX kernel does, C % 4 != 0, unaligned pointers, any stride): a lane
// a channel, a warp a gy row at a time, a block one tap.
//
// Bound: bytes. At the MobileNetV2 batch-256 shapes, (256, 32, 32, 144) at
// stride 1 reads 37.7 MB of x and 37.7 MB of gy (22.5 us at 3.35 TB/s)
// against 340 M multiply-adds (5.1 us at the CUDA cores' IDP4A rate, 67 T/s
// on an H100 SXM). The design's instructions (above, ~6.5 a gy element with
// the address arithmetic) take about half the byte time at 64 a clock per SM.
// What the byte bound does not count: each launch ends in a chain of L2
// round trips (the blocks' atomics, the fence, the ticket, the last block's
// drain) after a first row's load latency, about 5 us a launch back to back
// even on a tiny input, which the small MobileNetV2 maps feel most.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTX = 8;                // channel words (4 channels each) per block
constexpr int kTY = 16;               // column groups and row runs per block
constexpr int kThreads = kTX * kTY;   // the packed instance's block
constexpr int kCol = 32;              // channels per grid column (both instances)
constexpr int kWarps = kThreads / 32;

struct FgArgs {
  const int8_t* x;    // (B, H, W, C), contiguous, unpadded
  const int8_t* gy;   // (B, OH, OW, C), contiguous
  unsigned* out;      // (KH*KW, C)
  unsigned* acc;      // (KH*KW, C) scratch: 0 before and after every call
  unsigned* tickets;  // one per grid column: 0 before and after every call
  int B, H, W, C, KH, KW;
  int pt, pl;         // top and left pads
  int sh, sw;         // stride
  int OH, OW;
  int rows;           // packed: gy rows a unit walks
  int row_blocks;     // packed: ceil(OH / rows)
  int groups;         // packed: ceil(OW / 4), groups of 4 output columns
  unsigned units;     // packed: B * row_blocks * groups (< 2^31)
};

// Adds `v` into acc[i] (the block's partial sum) and, once every block of
// the grid column has added its own, the last one moves the column's sums
// into out and leaves acc and its ticket at 0. `n` is the column's entries,
// `col_index(j)` the j-th one's index into acc / out (or -1 past C).
template <typename ColIndex>
__device__ __forceinline__ void column_finish(const FgArgs& a, unsigned blocks_per_column,
                                              int n, ColIndex col_index) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  if (tid == 0) last = atomicAdd(a.tickets + blockIdx.x, 1u) == blocks_per_column - 1;
  __syncthreads();
  if (!last) return;
  for (int j = tid; j < n; j += nthreads) {
    const int i = col_index(j);
    if (i >= 0) a.out[i] = atomicExch(a.acc + i, 0u);
  }
  if (tid == 0) a.tickets[blockIdx.x] = 0u;
}

// T[k] = (w0.byte k, w1.byte k, w2.byte k, w3.byte k): a 4x4 byte transpose, 8 PRMT.
__device__ __forceinline__ void transpose4(unsigned w0, unsigned w1, unsigned w2, unsigned w3,
                                           unsigned (&t)[4]) {
  const unsigned a = __byte_perm(w0, w1, 0x5140), b = __byte_perm(w0, w1, 0x7362);
  const unsigned c = __byte_perm(w2, w3, 0x5140), d = __byte_perm(w2, w3, 0x7362);
  t[0] = __byte_perm(a, c, 0x5410);
  t[1] = __byte_perm(a, c, 0x7632);
  t[2] = __byte_perm(b, d, 0x5410);
  t[3] = __byte_perm(b, d, 0x7632);
}

// The x words of one row (columns ow0*SW + j - pl, j < 3*SW + 3, 4 channels
// each) -> X[dx][k]: channel k's values at the 4 output columns' tap dx.
template <int SW>
__device__ __forceinline__ void x_taps(const unsigned (&w)[3 * SW + 3], unsigned (&X)[3][4]) {
  if constexpr (SW == 1) {
    transpose4(w[0], w[1], w[2], w[3], X[0]);
    const unsigned lo = __byte_perm(w[4], w[5], 0x5140);  // columns 4, 5 of channels 0, 1
    const unsigned hi = __byte_perm(w[4], w[5], 0x7362);  // of channels 2, 3
    X[1][0] = __byte_perm(X[0][0], lo, 0x4321);
    X[2][0] = __byte_perm(X[0][0], lo, 0x5432);
    X[1][1] = __byte_perm(X[0][1], lo, 0x6321);
    X[2][1] = __byte_perm(X[0][1], lo, 0x7632);
    X[1][2] = __byte_perm(X[0][2], hi, 0x4321);
    X[2][2] = __byte_perm(X[0][2], hi, 0x5432);
    X[1][3] = __byte_perm(X[0][3], hi, 0x6321);
    X[2][3] = __byte_perm(X[0][3], hi, 0x7632);
  } else {
    transpose4(w[0], w[2], w[4], w[6], X[0]);  // even columns: dx = 0
    transpose4(w[1], w[3], w[5], w[7], X[1]);  // odd columns: dx = 1
#pragma unroll
    for (int k = 0; k < 4; ++k)  // columns 2, 4, 6, 8: dx = 2
      X[2][k] = __byte_perm(X[0][k], w[8], 0x4321 + 0x1000 * k);
  }
}

// acc[dy][dx][k] += the 4 output columns' products of tap (dy, dx), channel k.
template <int DY>
__device__ __forceinline__ void mac_row(int (&acc)[9][4], const unsigned (&X)[3][4],
                                        const unsigned (&G)[4]) {
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc[DY * 3 + dx][k] = __dp4a(static_cast<int>(X[dx][k]), static_cast<int>(G[k]),
                                   acc[DY * 3 + dx][k]);
}

__device__ __forceinline__ void cp_async4(unsigned* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Words of one x row and one gy row per thread in the packed instance's
// shared-memory ring, and the ring's depth: kStages - 1 rows in flight per
// thread, with no registers held for them.
template <int SW>
constexpr int kRingWords = 3 * SW + 3 + 4;
constexpr int kStages = 3;

// One unit of the packed instance: gy rows [oh0, oh1) of image b at output
// columns ow0..ow0+3 and channel word cw. ring[s][w][tid] is word w of
// stage s of this thread: each thread copies its own words asynchronously
// and reads only its own, so no barrier is needed.
template <int SH, int SW>
__device__ __forceinline__ void packed_unit(const FgArgs& a, int b, int rb, int g, int cw,
                                            int (&acc)[9][4],
                                            unsigned (*ring)[kRingWords<SW>][kThreads],
                                            int tid) {
  constexpr int NJ = 3 * SW + 3;
  const int oh0 = rb * a.rows, oh1 = min(oh0 + a.rows, a.OH);
  const int ow0 = 4 * g;
  const int xc0 = ow0 * SW - a.pl;
  unsigned xmask = 0, gmask = 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) xmask |= (xc0 + j >= 0 && xc0 + j < a.W ? 1u : 0u) << j;
#pragma unroll
  for (int k = 0; k < 4; ++k) gmask |= (ow0 + k < a.OW ? 1u : 0u) << k;
  const int8_t* xb = a.x + static_cast<long long>(b) * a.H * a.W * a.C + xc0 * a.C + cw * 4;
  const int8_t* gb = a.gy + static_cast<long long>(b) * a.OH * a.OW * a.C + ow0 * a.C + cw * 4;
  const int xrow = a.W * a.C, grow = a.OW * a.C;
  // x row p of the padded input lies on x; gy row p (stride 1) or p/2 (at
  // even p, stride 2) enters the window and lies in the run
  auto x_valid = [&](int p) { return p - a.pt >= 0 && p - a.pt < a.H; };
  auto g_valid = [&](int p) { return (SH == 1 || (p & 1) == 0) && (SH == 1 ? p : p / 2) < oh1; };

  // copy x row p and its gy row into stage s; words outside x, or past the
  // gy row's width, are zero-filled
  auto issue = [&](int p, int s) {
    if (x_valid(p)) {
      const int8_t* xrp = xb + (p - a.pt) * xrow;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const bool v = xmask >> j & 1u;
        cp_async4(&ring[s][j][tid], v ? xrp + j * a.C : a.x, v);
      }
    }
    if (g_valid(p)) {
      const int8_t* grp = gb + (SH == 1 ? p : p / 2) * grow;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool v = gmask >> k & 1u;
        cp_async4(&ring[s][NJ + k][tid], v ? grp + k * a.C : a.gy, v);
      }
    }
  };

  // the gy rows in registers: at stride 1 G0, G1, G2 are rows p, p-1, p-2
  // (tap rows 0, 1, 2 of x row p); at stride 2 G0 is row floor(p/2) (tap row
  // 0 at even p, 1 at odd p) and G2 the one before (tap row 2 at even p)
  unsigned G0[4] = {0u, 0u, 0u, 0u}, G1[4] = {0u, 0u, 0u, 0u}, G2[4] = {0u, 0u, 0u, 0u};
  bool v0 = false, v1 = false, v2 = false;
  const int p0 = oh0 * SH, p1 = (oh1 - 1) * SH + 3;
  int is = 0, cs = 0;  // the stages being filled and consumed
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (p0 + q < p1) issue(p0 + q, is);
    cp_async_commit();
    is = is + 1 == kStages ? 0 : is + 1;
  }
  for (int p = p0; p < p1; ++p) {
    // stage is was consumed one row ago: its words are in registers
    if (p + kStages - 1 < p1) issue(p + kStages - 1, is);
    cp_async_commit();
    is = is + 1 == kStages ? 0 : is + 1;
    cp_async_wait<kStages - 1>();  // row p's group has landed
    if (SH == 1 || (p & 1) == 0) {  // a new gy row enters (or none, past the run)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (SH == 1) G2[k] = G1[k];
        else G2[k] = G0[k];
        if (SH == 1) G1[k] = G0[k];
      }
      if (SH == 1) {
        v2 = v1;
        v1 = v0;
      } else {
        v2 = v0;
      }
      v0 = g_valid(p);
      if (v0) {
        transpose4(ring[cs][NJ][tid], ring[cs][NJ + 1][tid], ring[cs][NJ + 2][tid],
                   ring[cs][NJ + 3][tid], G0);
      }
    }
    if (x_valid(p)) {
      unsigned xw[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) xw[j] = ring[cs][j][tid];
      unsigned X[3][4];
      x_taps<SW>(xw, X);
      if (SH == 1) {
        if (v0) mac_row<0>(acc, X, G0);
        if (v1) mac_row<1>(acc, X, G1);
        if (v2) mac_row<2>(acc, X, G2);
      } else if ((p & 1) == 0) {
        if (v0) mac_row<0>(acc, X, G0);
        if (v2) mac_row<2>(acc, X, G2);
      } else {
        if (v0) mac_row<1>(acc, X, G0);
      }
    }
    cs = cs + 1 == kStages ? 0 : cs + 1;
  }
}

// 3x3, C % 4 == 0, x and gy 4-byte aligned, stride (SH, SW) in {1, 2}^2.
// blockIdx.x: a column of kTX channel words; the block's kTY rows of threads
// and blockIdx.y stride over the units (image, row run, column group).
template <int SH, int SW>
__global__ void __launch_bounds__(kThreads, 2) fgrad3x3_packed_kernel(FgArgs a) {
  constexpr int NW = kRingWords<SW>;
  static_assert(kStages * NW * kThreads >= kWarps * 36 * kTX,
                "the block's partial sums reuse the ring");
  __shared__ unsigned ring[kStages][NW][kThreads];
  // after the walk, the ring holds the warps' partial sums
  auto part = reinterpret_cast<unsigned (*)[36][kTX]>(&ring[0][0][0]);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int cw = blockIdx.x * kTX + tx;
  const int cwn = a.C / 4;
  int acc[9][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[t][k] = 0;
  if (cw < cwn) {
    for (unsigned u = blockIdx.y * kTY + ty; u < a.units; u += gridDim.y * kTY) {
      const unsigned groups = static_cast<unsigned>(a.groups);
      const unsigned rest = u / groups;
      const int g = static_cast<int>(u - rest * groups);
      const int b = static_cast<int>(rest / static_cast<unsigned>(a.row_blocks));
      const int rb = static_cast<int>(rest - static_cast<unsigned>(b) * a.row_blocks);
      packed_unit<SH, SW>(a, b, rb, g, cw, acc, ring, tid);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // lanes 8 and 16 apart hold the same channel word: sum them, then the warps
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      unsigned v = static_cast<unsigned>(acc[t][k]);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < kTX) part[warp][t * 4 + k][lane] = v;
    }
  __syncthreads();
  for (int i = ty * kTX + tx; i < 36 * kTX; i += kThreads) {
    const int tk = i / kTX, w = i - tk * kTX;
    unsigned s = 0u;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) s += part[q][tk][w];
    const int c = (blockIdx.x * kTX + w) * 4 + (tk & 3);
    if (c < a.C) atomicAdd(a.acc + (tk >> 2) * a.C + c, s);
  }
  column_finish(a, gridDim.y, 9 * kCol, [&](int j) {
    const int c = blockIdx.x * kCol + (j & (kCol - 1));
    return c < a.C ? (j / kCol) * a.C + c : -1;
  });
}

// Every other input: a lane a channel, each warp walks gy rows (b, oh) in
// steps of the grid's warps along y; blockIdx.z is the tap.
__global__ void __launch_bounds__(kThreads) fgrad_any_kernel(FgArgs a) {
  __shared__ unsigned part[kWarps][32];
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int c = blockIdx.x * kCol + lane;
  const int tap = blockIdx.z, dy = tap / a.KW, dx = tap - dy * a.KW;
  const unsigned rows = static_cast<unsigned>(a.B) * a.OH;
  unsigned acc = 0u;
  if (c < a.C) {
    for (unsigned r = blockIdx.y * kWarps + wy; r < rows; r += gridDim.y * kWarps) {
      const int b = static_cast<int>(r / static_cast<unsigned>(a.OH));
      const int oh = static_cast<int>(r - static_cast<unsigned>(b) * a.OH);
      const int xr = oh * a.sh + dy - a.pt;
      if (xr < 0 || xr >= a.H) continue;
      const int8_t* x = a.x + (static_cast<long long>(b) * a.H + xr) * a.W * a.C + c;
      const int8_t* g = a.gy + static_cast<long long>(r) * a.OW * a.C + c;
      for (int ow = 0; ow < a.OW; ++ow) {
        const int xc = ow * a.sw + dx - a.pl;
        if (xc < 0 || xc >= a.W) continue;
        acc += static_cast<unsigned>(static_cast<int>(__ldg(x + xc * a.C)) *
                                     static_cast<int>(__ldg(g + ow * a.C)));
      }
    }
  }
  part[wy][lane] = acc;
  __syncthreads();
  if (wy == 0) {
    unsigned s = 0u;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) s += part[q][lane];
    if (c < a.C) atomicAdd(a.acc + tap * a.C + c, s);
  }
  column_finish(a, gridDim.y * gridDim.z, a.KH * a.KW * kCol, [&](int j) {
    const int cc = blockIdx.x * kCol + (j % kCol);
    return cc < a.C ? (j / kCol) * a.C + cc : -1;
  });
}

int resident_blocks(const void* kernel) {
  int dev = 0, sms = 0, occ = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, 0);
  return sms * (occ > 0 ? occ : 1);
}

// Blocks along y for `work` items of `per_block` each, at most `cap`, with
// the passes of the grid-stride loop balanced.
unsigned grid_y(long long work, int per_block, long long cap) {
  const long long need = (work + per_block - 1) / per_block;
  const long long passes = (need + cap - 1) / cap;
  return static_cast<unsigned>((need + passes - 1) / passes);
}

template <int SH, int SW>
void launch_packed(FgArgs a, int cols, cudaStream_t st) {
  const void* kern = reinterpret_cast<const void*>(&fgrad3x3_packed_kernel<SH, SW>);
  const long long target = static_cast<long long>(resident_blocks(kern)) * kTY;
  // shorter row runs until the units would fill half the resident threads:
  // each run reads the x rows under it and first waits out a load's latency,
  // so longer runs read fewer rows twice and wait less (on the MobileNetV2
  // shapes, filling all resident threads took longer)
  a.groups = (a.OW + 3) / 4;
  a.rows = a.OH;
  auto units = [&](int rows) {
    return static_cast<long long>(a.B) * ((a.OH + rows - 1) / rows) * a.groups;
  };
  while (a.rows > 1 && 2 * units(a.rows) * cols < target) a.rows = (a.rows + 1) / 2;
  a.row_blocks = (a.OH + a.rows - 1) / a.rows;
  a.units = static_cast<unsigned>(units(a.rows));
  const long long cap = (target / kTY + cols - 1) / cols;
  const dim3 grid(cols, grid_y(a.units, kTY, cap > 0 ? cap : 1), 1);
  fgrad3x3_packed_kernel<SH, SW><<<grid, dim3(kTX, kTY), 0, st>>>(a);
}

}  // namespace

// Returns cudaGetLastError() after the launch. `acc` (KH*KW*C) and
// `tickets` (ceil(C/32)) must be 0 on entry; the kernel leaves them at 0.
// OH, OW: gy's spatial shape, with (OH-1)*sh + KH <= pt + H + bottom pad
// (the caller checks gy against x and its pads).
extern "C" int mh_dwconv_fgrad_acc(const void* x, const void* gy, void* out, void* acc,
                                   void* tickets, int B, int H, int W, int C, int KH, int KW,
                                   int pt, int pl, int sh, int sw, int OH, int OW,
                                   void* stream) {
  FgArgs a;
  a.x = static_cast<const int8_t*>(x);
  a.gy = static_cast<const int8_t*>(gy);
  a.out = static_cast<unsigned*>(out);
  a.acc = static_cast<unsigned*>(acc);
  a.tickets = static_cast<unsigned*>(tickets);
  a.B = B;
  a.H = H;
  a.W = W;
  a.C = C;
  a.KH = KH;
  a.KW = KW;
  a.pt = pt;
  a.pl = pl;
  a.sh = sh;
  a.sw = sw;
  a.OH = OH;
  a.OW = OW;
  a.rows = a.row_blocks = a.groups = 1;
  a.units = 0;
  const int cols = (C + kCol - 1) / kCol;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool packed = KH == 3 && KW == 3 && C % 4 == 0 && sh >= 1 && sh <= 2 && sw >= 1 &&
                      sw <= 2 &&
                      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(gy)) & 3u) == 0;
  if (packed) {
    if (sh == 1 && sw == 1) launch_packed<1, 1>(a, cols, st);
    else if (sh == 1) launch_packed<1, 2>(a, cols, st);
    else if (sw == 1) launch_packed<2, 1>(a, cols, st);
    else launch_packed<2, 2>(a, cols, st);
  } else {
    const long long cap =
        (resident_blocks(reinterpret_cast<const void*>(&fgrad_any_kernel)) +
         static_cast<long long>(cols) * KH * KW - 1) / (static_cast<long long>(cols) * KH * KW);
    const dim3 grid(cols, grid_y(static_cast<long long>(B) * OH, kWarps, cap > 0 ? cap : 1),
                    KH * KW);
    fgrad_any_kernel<<<grid, dim3(32, kWarps), 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
