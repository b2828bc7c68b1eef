// K4: the two-phase fused NITI depthwise conv. The int32 accumulator never
// reaches device memory: phase 1 keeps only max|acc|, phase 2 recomputes
// the taps and writes the requantized int8 output directly.
//
// Replaces the TPU kernels of mandheling_tpu/ops/kernels/fused_dwconv_int8.py:
// `_max_kernel` (the pallas_call in `dwconv_max_pallas`) and
// `_requant_kernel` (`dwconv_requant_pallas`). Same contract: a VALID
// stride-1 depthwise conv over the pre-padded xp (B, Hp, Wp, C) with w
// (KH, KW, 1, C); the forward or the gradient psto epilogue. Strided input
// gradients reach it on the zero-dilated output diff.
//
// A depthwise conv has no channel contraction, so there is no tensor-core
// work: KH*KW multiply-adds of int8 operands into int32 per output, on the
// CUDA cores. A block takes 32 channels (one per lane: NHWC channels are
// contiguous, so a warp reads 32 neighbouring bytes; ragged C is masked), TR
// output rows and TW output columns of one image, and each of its TY warps
// computes every TY-th output column. The 3x3 instance, the only kernel size
// of the MobileNet paths, stages the (TR+KH-1) x (TW+KW-1) halo tile of xp
// for its channels in shared memory and keeps the 9 weights of its lane's
// channel in registers. Every other kernel size, as the JAX kernel takes any,
// goes to one instance that reads the taps of xp and w from global memory
// through the cache. The epilogues are K2's and K3's (niti_epilogue.cuh).
//
// Bound: at (256, 34, 34, 144), 3x3, phase 1 does 340 M multiply-adds of
// int8 operands on 43 MB. The CUDA cores' int8 rate is that of IDP4A, four
// int8 multiply-adds per instruction at the IMAD issue rate of 64 per SM and
// clock: 67 T/s on an H100 SXM (132 SMs x 64 x 4 x 1.98 GHz), so 5.1 us of
// operations against 12.7 us of bytes. Bytes bound both phases; phase 2
// also writes 38 MB of int8, 24.0 us in all.
#include "niti_epilogue.cuh"

namespace {

constexpr int CT = 32;  // channels per block, one per lane
constexpr int TY = 8;   // warps per block
constexpr int TR = 8;   // output rows per block
constexpr int TW = 32;  // output columns per block

struct DwArgs {
  const int8_t* xp;  // (B, Hp, Wp, C), contiguous
  const int8_t* w;   // (KH*KW, C), contiguous
  int B, Hp, Wp, C, KH, KW, OH, OW, col_tiles;
};

// kMode: 0 = phase 1 (max), 1 = phase 2 forward, 2 = phase 2 gradient.
// KH = KW = 0: any kernel size (a.KH x a.KW), untiled.
template <int KH, int KW, int kMode>
__global__ void __launch_bounds__(CT* TY)
    dwconv_kernel(DwArgs a, const int* shift_ptr, int* out_max, int8_t* y) {
  constexpr bool kTiled = KH > 0;
  __shared__ int8_t tile[kTiled ? TR + KH - 1 : 1][kTiled ? TW + KW - 1 : 1][CT];
  const int lane = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * CT + lane;
  const bool cin = c < a.C;
  const int oh0 = (blockIdx.y / a.col_tiles) * TR;
  const int ow0 = (blockIdx.y % a.col_tiles) * TW;
  const long long b = blockIdx.z;

  int wr[kTiled ? KH * KW : 1];
  if constexpr (kTiled) {
#pragma unroll
    for (int t = 0; t < KH * KW; ++t) wr[t] = cin ? a.w[t * a.C + c] : 0;

    // The halo tile; rows and columns past xp's edge feed no output and stay
    // unloaded.
    const int rows = min(TR + KH - 1, a.Hp - oh0);
    const int cols = min(TW + KW - 1, a.Wp - ow0);
    for (int i = ty; i < rows * cols; i += TY) {
      const int r = i / cols, q = i - r * cols;
      tile[r][q][lane] =
          cin ? a.xp[((b * a.Hp + oh0 + r) * a.Wp + ow0 + q) * a.C + c] : int8_t(0);
    }
    __syncthreads();
  }

  const int shift = kMode == 0 ? 0 : *shift_ptr;
  int local = INT_MIN;
  for (int r = 0; r < TR && oh0 + r < a.OH; ++r) {
    for (int q = ty; q < TW && ow0 + q < a.OW; q += TY) {
      if (!cin) continue;
      int acc = 0;
      if constexpr (kTiled) {
#pragma unroll
        for (int dy = 0; dy < KH; ++dy)
#pragma unroll
          for (int dx = 0; dx < KW; ++dx)
            acc += static_cast<int>(tile[r + dy][q + dx][lane]) * wr[dy * KW + dx];
      } else {
        const int8_t* x0 = a.xp + ((b * a.Hp + oh0 + r) * a.Wp + ow0 + q) * a.C + c;
        for (int dy = 0; dy < a.KH; ++dy)
          for (int dx = 0; dx < a.KW; ++dx)
            acc += static_cast<int>(x0[(dy * a.Wp + dx) * a.C]) *
                   static_cast<int>(a.w[(dy * a.KW + dx) * a.C + c]);
      }
      if (kMode == 0)
        local = max(local, mh::wrap_abs(acc));
      else
        y[((b * a.OH + oh0 + r) * a.OW + ow0 + q) * a.C + c] =
            mh::requant(acc, shift, kMode == 2);
    }
  }
  if (kMode == 0) mh::block_max_atomic(local, out_max);
}

template <int KH, int KW>
void launch_k(const DwArgs& a, dim3 grid, int mode, const int* shift, int* out_max,
              int8_t* y, cudaStream_t st) {
  const dim3 block(CT, TY);
  if (mode == 0)
    dwconv_kernel<KH, KW, 0><<<grid, block, 0, st>>>(a, shift, out_max, y);
  else if (mode == 1)
    dwconv_kernel<KH, KW, 1><<<grid, block, 0, st>>>(a, shift, out_max, y);
  else
    dwconv_kernel<KH, KW, 2><<<grid, block, 0, st>>>(a, shift, out_max, y);
}

// Returns cudaGetLastError().
int launch(const void* xp, const void* w, int B, int Hp, int Wp, int C, int KH,
           int KW, int mode, const void* shift, void* out_max, void* y, void* stream) {
  DwArgs a;
  a.xp = static_cast<const int8_t*>(xp);
  a.w = static_cast<const int8_t*>(w);
  a.B = B;
  a.Hp = Hp;
  a.Wp = Wp;
  a.C = C;
  a.KH = KH;
  a.KW = KW;
  a.OH = Hp - KH + 1;
  a.OW = Wp - KW + 1;
  a.col_tiles = (a.OW + TW - 1) / TW;
  const dim3 grid((C + CT - 1) / CT, ((a.OH + TR - 1) / TR) * a.col_tiles, B);
  const int* sp = static_cast<const int*>(shift);
  int* mp = static_cast<int*>(out_max);
  int8_t* yp = static_cast<int8_t*>(y);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KH == 3 && KW == 3)
    launch_k<3, 3>(a, grid, mode, sp, mp, yp, st);
  else
    launch_k<0, 0>(a, grid, mode, sp, mp, yp, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mh_fused_dwconv_max(const void* xp, const void* w, void* out_max, int B,
                                   int Hp, int Wp, int C, int KH, int KW, void* stream) {
  return launch(xp, w, B, Hp, Wp, C, KH, KW, 0, nullptr, out_max, nullptr, stream);
}

extern "C" int mh_fused_dwconv_requant(const void* xp, const void* w, const void* shift,
                                       void* y, int B, int Hp, int Wp, int C, int KH,
                                       int KW, int grad, void* stream) {
  return launch(xp, w, B, Hp, Wp, C, KH, KW, grad ? 2 : 1, shift, nullptr, y, stream);
}
