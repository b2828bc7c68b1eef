// K5: the int32 depthwise filter-grad accumulator in one pass.
//
//   dw[dy, dx, 0, c] = sum_{b, oh, ow} xp[b, oh + dy, ow + dx, c] * gy[b, oh, ow, c]
//
// over the pre-padded int8 input xp (B, Hp, Wp, C) and the int8 output diff
// gy (B, OH, OW, C) of a VALID stride-1 depthwise conv, OH = Hp - KH + 1 and
// OW = Wp - KW + 1. The output is (KH*KW, C) int32.
//
// Replaces the TPU kernel of mandheling_tpu/ops/kernels/fused_dwconv_int8.py:
// `_fgrad_kernel` (the pallas_call in `dwconv_fgrad_acc_pallas`), whose
// per-batch-tile int32 partial sums XLA then adds up.
//
// Exactness: the sums wrap modulo 2^32, as the TPU kernel's int32 partials
// and jnp.sum do. They are kept in uint32, where the wrap is defined, and
// each block ends with one atomicAdd per (tap, channel) into an output the
// caller zeroes. Addition modulo 2^32 is associative and commutative, so the
// order in which blocks arrive does not change a single bit.
//
// Layout: NHWC, one channel per lane, so that a warp reads 32 neighbouring
// bytes; ragged C is masked. A block takes 32 channels and a range of
// RPB (b, oh) rows of gy; each of its TY warps walks every TY-th of them
// along ow. The 3x3 instance (every MobileNet depthwise layer) keeps its 9
// sums and a 3x3 window of xp in registers, sliding the window one column a
// step: per output position a lane loads one byte of gy and three of xp and
// does 9 multiply-adds. One untiled instance takes any other KH x KW, as the
// JAX kernel does: a block owns one tap and reads both operands through the
// cache.
//
// Bound: at (256, 34, 34, 144) the kernel must read 42.6 MB of xp and 37.7
// MB of gy, 24.0 us at 3.35 TB/s, against 340 M int8 multiply-adds, 5.1 us at
// the CUDA cores' IDP4A rate (67 T/s on an H100 SXM): bytes bound it. This
// first version does one multiply-add per IMAD and reads one byte per lane
// per load; four channels per lane with IDP4A, and TMA, come later.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int CT = 32;   // channels per block, one per lane
constexpr int TY = 8;    // warps per block
constexpr int RPB = 32;  // (b, oh) rows of gy per block

struct FgArgs {
  const int8_t* xp;  // (B, Hp, Wp, C), contiguous
  const int8_t* gy;  // (B, OH, OW, C), contiguous
  unsigned* out;     // (KH*KW, C), zeroed by the caller
  int B, Hp, Wp, C, KH, KW, OH, OW;
};

// Adds the TY warps' partial sums of `n` taps and issues one atomicAdd per
// (tap, channel) of the block. part[t][w][lane] holds warp w's sum of tap t.
__device__ __forceinline__ void block_add(const FgArgs& a, unsigned (*part)[TY][CT], int n,
                                          int tap0, int c0) {
  __syncthreads();
  const int tid = threadIdx.y * CT + threadIdx.x;
  for (int i = tid; i < n * CT; i += CT * TY) {
    const int t = i / CT, lane = i - t * CT;
    unsigned s = 0;
#pragma unroll
    for (int w = 0; w < TY; ++w) s += part[t][w][lane];
    if (c0 + lane < a.C) atomicAdd(a.out + static_cast<long long>(tap0 + t) * a.C + c0 + lane, s);
  }
}

__global__ void __launch_bounds__(CT* TY) fgrad3x3_kernel(FgArgs a) {
  __shared__ unsigned part[9][TY][CT];
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int c = blockIdx.x * CT + lane;
  const long long rows = static_cast<long long>(a.B) * a.OH;
  const long long r0 = static_cast<long long>(blockIdx.y) * RPB;
  const long long r1 = min(r0 + RPB, rows);
  unsigned acc[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) acc[t] = 0u;

  if (c < a.C) {
    const long long xrow = static_cast<long long>(a.Wp) * a.C;
    for (long long r = r0 + wy; r < r1; r += TY) {
      const long long b = r / a.OH;
      const int oh = static_cast<int>(r - b * a.OH);
      const int8_t* x = a.xp + ((b * a.Hp + oh) * a.Wp) * a.C + c;
      const int8_t* g = a.gy + r * a.OW * a.C + c;
      // win[dy][j] = xp[b, oh + dy, ow + j, c] for the current ow
      int win[3][3];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        win[dy][0] = x[dy * xrow];
        win[dy][1] = x[dy * xrow + a.C];
      }
      for (int ow = 0; ow < a.OW; ++ow) {
        const long long col = static_cast<long long>(ow + 2) * a.C;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) win[dy][2] = x[dy * xrow + col];
        const int gv = g[static_cast<long long>(ow) * a.C];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            acc[dy * 3 + dx] += static_cast<unsigned>(win[dy][dx] * gv);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          win[dy][0] = win[dy][1];
          win[dy][1] = win[dy][2];
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 9; ++t) part[t][wy][lane] = acc[t];
  block_add(a, part, 9, 0, blockIdx.x * CT);
}

// Any kernel size: blockIdx.z is the tap.
__global__ void __launch_bounds__(CT* TY) fgrad_any_kernel(FgArgs a) {
  __shared__ unsigned part[1][TY][CT];
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int c = blockIdx.x * CT + lane;
  const int tap = blockIdx.z, dy = tap / a.KW, dx = tap - dy * a.KW;
  const long long rows = static_cast<long long>(a.B) * a.OH;
  const long long r0 = static_cast<long long>(blockIdx.y) * RPB;
  const long long r1 = min(r0 + RPB, rows);
  unsigned acc = 0u;
  if (c < a.C) {
    for (long long r = r0 + wy; r < r1; r += TY) {
      const long long b = r / a.OH;
      const int oh = static_cast<int>(r - b * a.OH);
      const int8_t* x = a.xp + ((b * a.Hp + oh + dy) * a.Wp + dx) * a.C + c;
      const int8_t* g = a.gy + r * a.OW * a.C + c;
      for (int ow = 0; ow < a.OW; ++ow) {
        const long long off = static_cast<long long>(ow) * a.C;
        acc += static_cast<unsigned>(static_cast<int>(x[off]) * static_cast<int>(g[off]));
      }
    }
  }
  part[0][wy][lane] = acc;
  block_add(a, part, 1, tap, blockIdx.x * CT);
}

}  // namespace

// Returns cudaGetLastError() after the launch. `out` must hold KH*KW*C
// zeroed int32.
extern "C" int mh_dwconv_fgrad_acc(const void* xp, const void* gy, void* out, int B, int Hp,
                                   int Wp, int C, int KH, int KW, void* stream) {
  FgArgs a;
  a.xp = static_cast<const int8_t*>(xp);
  a.gy = static_cast<const int8_t*>(gy);
  a.out = static_cast<unsigned*>(out);
  a.B = B;
  a.Hp = Hp;
  a.Wp = Wp;
  a.C = C;
  a.KH = KH;
  a.KW = KW;
  a.OH = Hp - KH + 1;
  a.OW = Wp - KW + 1;
  const long long rows = static_cast<long long>(B) * a.OH;
  const unsigned row_blocks = static_cast<unsigned>((rows + RPB - 1) / RPB);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(CT, TY);
  if (KH == 3 && KW == 3)
    fgrad3x3_kernel<<<dim3((C + CT - 1) / CT, row_blocks, 1), block, 0, st>>>(a);
  else
    fgrad_any_kernel<<<dim3((C + CT - 1) / CT, row_blocks, KH * KW), block, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
