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
// row slabs so that its matrix unit sees plain 2-D blocks. Here the GEMM is
// M = B*OH*OW, N = OC, K = KH*KW*IC, on K1's mma.sync mainloop (gemm_s8.cuh);
// each block gathers its A tile straight from x into shared memory, with the
// stride and the padding applied by index and the pads and ragged edges
// masked to 0. No im2col copy, no band matrix. The whole K loop runs inside
// the block (no split-K): the max and the psto need whole sums.
//
// Bound (chip_smoke.py computes it for each shape): phase 2 writes M x N
// int8 and does at most ~50 int8 operations per byte it must move at the
// shapes it serves (the MobileNetV2 stem, LeNet's conv1, conv2 and conv2
// input grad), far below the ~590 at which an H100 SXM's tensor cores rather
// than its memory bound it: the bytes bound it. Phase 1 writes 4 bytes, so
// it sits near the ridge at the stem and past it, bound by the operations,
// at LeNet's conv2 input grad (K = 1300). The gather re-reads each input
// pixel up to KH*KW times, mostly from L2.
#include "gemm_s8.cuh"
#include "niti_epilogue.cuh"

namespace {

struct ConvGeom {
  const int8_t* x;  // NHWC (B, H, W, C), contiguous
  int B, H, W, C;
  int OH, OW;
  int KH, KW, SH, SW, PT, PL;
};

// The output pixel of each of the block's BM rows.
struct Rows {
  int b[mh::BM];    // batch index; -1 past M
  int ih0[mh::BM];  // oh * SH - PT
  int iw0[mh::BM];  // ow * SW - PL
};

__device__ __forceinline__ void fill_rows(Rows& rows, const ConvGeom& g, int M,
                                          int m0) {
  for (int r = threadIdx.x; r < mh::BM; r += mh::THREADS) {
    const int m = m0 + r;
    int b = -1, ih0 = 0, iw0 = 0;
    if (m < M) {
      const int per = g.OH * g.OW;
      b = m / per;
      const int rem = m - b * per;
      const int oh = rem / g.OW, ow = rem - oh * g.OW;
      ih0 = oh * g.SH - g.PT;
      iw0 = ow * g.SW - g.PL;
    }
    rows.b[r] = b;
    rows.ih0[r] = ih0;
    rows.iw0[r] = iw0;
  }
  __syncthreads();
}

// The A tile of the implicit GEMM: A(m, k) = x[b, ih0 + dy, iw0 + dx, c] with
// k = (dy * KW + dx) * C + c, the order of the HWIO weights reshaped to
// (KH*KW*C, OC); 0 in the padding and past M or K. A thread keeps one k
// column through a k-step (THREADS is a multiple of BK), so it decomposes k
// once, and a warp reads 32 neighbouring k: neighbouring channels of x.
struct ConvA {
  const ConvGeom& g;
  const Rows& rows;
  int K;
  __device__ __forceinline__ void operator()(mh::Smem& s, int, int k0) const {
    static_assert(mh::THREADS % mh::BK == 0, "one k column per thread");
    const int c = threadIdx.x % mh::BK;
    const int k = k0 + c;
    const bool kin = k < K;
    int dy = 0, dx = 0, ch = 0;
    if (kin) {
      const int span = g.KW * g.C;
      dy = k / span;
      const int rem = k - dy * span;
      dx = rem / g.C;
      ch = rem - dx * g.C;
    }
    for (int r = threadIdx.x / mh::BK; r < mh::BM; r += mh::THREADS / mh::BK) {
      const int ih = rows.ih0[r] + dy, iw = rows.iw0[r] + dx;
      int8_t v = 0;
      if (kin && rows.b[r] >= 0 && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
        v = g.x[((static_cast<long long>(rows.b[r]) * g.H + ih) * g.W + iw) * g.C + ch];
      s.a[r][c] = v;
    }
  }
};

// Phase 1: max |acc| -> one atomicMax per block into *out_max (set to
// INT32_MIN by the caller).
__global__ void __launch_bounds__(mh::THREADS)
    conv_max_kernel(ConvGeom g, mh::Operands p, int* out_max) {
  __shared__ __align__(16) mh::Smem s;
  __shared__ Rows rows;
  const int m0 = blockIdx.x * mh::BM, n0 = blockIdx.y * mh::BN;
  fill_rows(rows, g, p.M, m0);
  mh::Acc acc;
  mh::mainloop(s, p, m0, n0, 0, (p.K + mh::BK - 1) / mh::BK, acc, ConvA{g, rows, p.K});
  int local = INT_MIN;
  mh::for_each_acc(p, m0, n0, acc,
                   [&](int, int, int v) { local = max(local, mh::wrap_abs(v)); });
  mh::block_max_atomic(local, out_max);
}

// Phase 2: recompute, then the psto epilogue with the shift read from device
// memory; y is NHWC (B, OH, OW, OC), i.e. row-major (M, N).
template <bool kGrad>
__global__ void __launch_bounds__(mh::THREADS)
    conv_requant_kernel(ConvGeom g, mh::Operands p, const int* shift_ptr, int8_t* y) {
  __shared__ __align__(16) mh::Smem s;
  __shared__ Rows rows;
  const int m0 = blockIdx.x * mh::BM, n0 = blockIdx.y * mh::BN;
  fill_rows(rows, g, p.M, m0);
  mh::Acc acc;
  mh::mainloop(s, p, m0, n0, 0, (p.K + mh::BK - 1) / mh::BK, acc, ConvA{g, rows, p.K});
  const int shift = *shift_ptr;
  const long long ldy = p.N;
  mh::for_each_acc(p, m0, n0, acc, [&](int row, int col, int v) {
    y[row * ldy + col] = mh::requant(v, shift, kGrad);
  });
}

struct Launch {
  ConvGeom g;
  mh::Operands p;
  dim3 grid;
};

// w is the HWIO weight, contiguous, read as the (KH*KW*C, OC) matrix B.
Launch setup(const void* x, const void* w, int B, int H, int W, int C, int OH,
             int OW, int OC, int KH, int KW, int SH, int SW, int PT, int PL) {
  Launch l;
  l.g = ConvGeom{static_cast<const int8_t*>(x), B, H, W, C, OH, OW, KH, KW, SH, SW, PT, PL};
  const int M = B * OH * OW, K = KH * KW * C;
  l.p = mh::Operands{nullptr, static_cast<const int8_t*>(w), M, OC, K, 0, 0, OC, 1};
  l.grid = dim3((M + mh::BM - 1) / mh::BM, (OC + mh::BN - 1) / mh::BN);
  return l;
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int mh_fused_conv_max(const void* x, const void* w, void* out_max, int B,
                                 int H, int W, int C, int OH, int OW, int OC, int KH,
                                 int KW, int SH, int SW, int PT, int PL, void* stream) {
  const Launch l = setup(x, w, B, H, W, C, OH, OW, OC, KH, KW, SH, SW, PT, PL);
  conv_max_kernel<<<l.grid, mh::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      l.g, l.p, static_cast<int*>(out_max));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mh_fused_conv_requant(const void* x, const void* w, const void* shift,
                                     void* y, int B, int H, int W, int C, int OH,
                                     int OW, int OC, int KH, int KW, int SH, int SW,
                                     int PT, int PL, int grad, void* stream) {
  const Launch l = setup(x, w, B, H, W, C, OH, OW, OC, KH, KW, SH, SW, PT, PL);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(shift);
  int8_t* yp = static_cast<int8_t*>(y);
  if (grad)
    conv_requant_kernel<true><<<l.grid, mh::THREADS, 0, st>>>(l.g, l.p, sp, yp);
  else
    conv_requant_kernel<false><<<l.grid, mh::THREADS, 0, st>>>(l.g, l.p, sp, yp);
  return static_cast<int>(cudaGetLastError());
}
