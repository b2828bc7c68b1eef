// K8: the NITI int8 max pool, the zero-padded average pool (each forward
// and backward) and the exponent-aligned channel concat, one launch each,
// where the plain PyTorch chains take 5-40 launches and int32 / int64
// temporaries of many times the tensors' size.
//
// Replaces no Pallas kernel: the JAX package leaves these ops to XLA
// (mandheling_tpu/ops/pool.py `maxpool2d`, `maxpool2d_grad`;
// ops/depthwise.py `avgpool2d_int8`, `avgpool2d_grad`; ops/eltwise.py
// `pad_int8`, `concat_int8`). NITI is exact, and every kernel gives the
// chain's bytes:
//
// - `k8_maxpool_kernel`: VALID max pool, any window and stride.
// - `k8_maxpool_grad_kernel`: a gather over the input. Each input position
//   sums, in int32, gy of the windows that cover it and chose it: the
//   first position of the window in row-major scan order whose value is at
//   least the window's max (NITI_CPUPoolGrad_Int8.cpp:60-66). The sum is
//   clipped to +-127, except where windows do not overlap (window ==
//   stride): there the chain passes gy through unclipped, and so does the
//   kernel. No atomics, no int64, no stack of window copies.
// - `k8_avgpool_kernel`: the int32 sum over the window of the input
//   zero-padded by `pad` pixels a side (the pad is read as zeros, never
//   written), divided by |window| truncating toward zero, clipped.
// - `k8_avgpool_grad_kernel`: a gather over the unpadded input: the int32
//   sum of trunc(gy / |window|) over the windows that cover the position in
//   the padded frame, clipped; the pad's gradient is never formed. Equal to
//   the chain's clamped dynamic_update_slice form where no start is clamped,
//   the only form the wrapper sends here (`supports`).
// - `k8_concat_kernel`: every branch's int8 values shifted right,
//   truncating toward zero as numerics.trunc_shift_div does, by
//   max(exps) - e_i, into its channel slice of the output. The exponents
//   are read on the device and block 0 writes max(exps), so the host never
//   waits and the launch captures into a CUDA graph.
//
// Bound: bytes. Each kernel reads its operands and writes its result once
// from device memory; the windows' overlapping reads hit L1 / L2. At the
// main path's sizes (Inception-v3 at 299, batch 32) the 28 sites of a step
// move 0.776 GB, 0.232 ms at 3.35 TB/s.
//
// Design: one thread a (position, run of V channels), NHWC, neighbouring
// threads on neighbouring channels, so loads and stores are V-byte vectors
// (V = 16 where every channel count, row stride and pointer allows it,
// else 4, else 1). The window loops run at run time (any window, stride
// and pad); the sums are int32 in registers. A tensor may be rows of C
// channels at a row stride (a channel slice of a larger tensor, as the
// concat's backward hands a branch its gy): the wrapper passes it.
#include <cstdint>

#include "niti_epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBranches = 8;

struct K8Pool {
  const int8_t* x;   // forward input (B, H, W, C); the max pool's grad reads it too
  const int8_t* y;   // max pool grad: the forward output (B, OH, OW, C)
  const int8_t* gy;  // grads: (B, OH, OW, C) rows at stride ld_gy
  int8_t* out;       // y (forward) or gx (B, H, W, C)
  int B, H, W, C, OH, OW, kh, kw, sh, sw, pad;
  long long ld_gy;   // elements between rows of gy
  int clip;          // max pool grad: clip the sum to +-127
};

struct K8Join {
  const int8_t* src[kMaxBranches];
  const int* exp[kMaxBranches];
  long long ld[kMaxBranches];  // row stride of each branch, in elements
  int off[kMaxBranches + 1];   // channel offset of each branch in the output
  int n;                       // branches
  long long rows;
  int8_t* out;                 // (rows, off[n])
  int* exp_out;
};

template <int V>
__device__ __forceinline__ void load(const int8_t* p, int (&v)[V]) {
  if constexpr (V == 16) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = static_cast<int8_t>((w[k >> 2] >> (8 * (k & 3))) & 0xffu);
  } else if constexpr (V == 4) {
    const unsigned q = __ldg(reinterpret_cast<const unsigned*>(p));
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = static_cast<int8_t>((q >> (8 * k)) & 0xffu);
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store(int8_t* p, const int (&v)[V]) {
  if constexpr (V == 16) {
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < 16; ++k) w[k >> 2] |= (static_cast<unsigned>(v[k]) & 0xffu) << (8 * (k & 3));
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (V == 4) {
    unsigned w = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) w |= (static_cast<unsigned>(v[k]) & 0xffu) << (8 * k);
    *reinterpret_cast<unsigned*>(p) = w;
  } else {
    p[0] = static_cast<int8_t>(v[0]);
  }
}

__device__ __forceinline__ int clip127(int v) { return min(max(v, -127), 127); }

// The thread's (row, first channel) over rows x C channels in runs of V;
// false past the end.
template <int V>
__device__ __forceinline__ bool position(long long rows, int C, long long& row, int& c) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int runs = C / V;
  if (t >= rows * runs) return false;
  row = t / runs;
  c = static_cast<int>(t - row * runs) * V;
  return true;
}

// The first and last window index that covers padded coordinate p:
// windows o with o * s <= p <= o * s + k - 1, 0 <= o < n.
__device__ __forceinline__ void covering(int p, int k, int s, int n, int& lo, int& hi) {
  lo = p >= k ? (p - k) / s + 1 : 0;
  hi = min(n - 1, p / s);
}

template <int V>
__global__ void __launch_bounds__(kThreads) k8_maxpool_kernel(K8Pool p) {
  long long row;
  int c;
  if (!position<V>(static_cast<long long>(p.B) * p.OH * p.OW, p.C, row, c)) return;
  const int ow = static_cast<int>(row % p.OW);
  const long long bo = row / p.OW;
  const int oh = static_cast<int>(bo % p.OH);
  const int b = static_cast<int>(bo / p.OH);
  int m[V], v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) m[k] = -128;
  for (int i = 0; i < p.kh; ++i) {
    const int8_t* r = p.x + ((static_cast<long long>(b) * p.H + oh * p.sh + i) * p.W + ow * p.sw) * p.C + c;
    for (int j = 0; j < p.kw; ++j) {
      load<V>(r + static_cast<long long>(j) * p.C, v);
#pragma unroll
      for (int k = 0; k < V; ++k) m[k] = max(m[k], v[k]);
    }
  }
  store<V>(p.out + row * p.C + c, m);
}

template <int V>
__global__ void __launch_bounds__(kThreads) k8_maxpool_grad_kernel(K8Pool p) {
  long long row;
  int c;
  if (!position<V>(static_cast<long long>(p.B) * p.H * p.W, p.C, row, c)) return;
  const int iw = static_cast<int>(row % p.W);
  const long long bh = row / p.W;
  const int ih = static_cast<int>(bh % p.H);
  const int b = static_cast<int>(bh / p.H);
  int oh0, oh1, ow0, ow1;
  covering(ih, p.kh, p.sh, p.OH, oh0, oh1);
  covering(iw, p.kw, p.sw, p.OW, ow0, ow1);
  int own[V], acc[V];
  load<V>(p.x + row * p.C + c, own);
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0;
  const int8_t* xb = p.x + static_cast<long long>(b) * p.H * p.W * p.C + c;
  for (int oh = oh0; oh <= oh1; ++oh) {
    for (int ow = ow0; ow <= ow1; ++ow) {
      const long long orow = (static_cast<long long>(b) * p.OH + oh) * p.OW + ow;
      int y[V], g[V], v[V];
      bool found[V];
      load<V>(p.y + orow * p.C + c, y);
      load<V>(p.gy + orow * p.ld_gy + c, g);
#pragma unroll
      for (int k = 0; k < V; ++k) found[k] = false;
      // the window's positions before this one, in row-major scan order
      const int i_end = ih - oh * p.sh;
      const int j_own = iw - ow * p.sw;
      for (int i = 0; i <= i_end; ++i) {
        const int j_end = i < i_end ? p.kw : j_own;
        const int8_t* r = xb + (static_cast<long long>(oh * p.sh + i) * p.W + ow * p.sw) * p.C;
        for (int j = 0; j < j_end; ++j) {
          load<V>(r + static_cast<long long>(j) * p.C, v);
#pragma unroll
          for (int k = 0; k < V; ++k) found[k] = found[k] || v[k] >= y[k];
        }
      }
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (!found[k] && own[k] >= y[k]) acc[k] += g[k];
    }
  }
  if (p.clip) {
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = clip127(acc[k]);
  }
  store<V>(p.out + row * p.C + c, acc);
}

template <int V>
__global__ void __launch_bounds__(kThreads) k8_avgpool_kernel(K8Pool p) {
  long long row;
  int c;
  if (!position<V>(static_cast<long long>(p.B) * p.OH * p.OW, p.C, row, c)) return;
  const int ow = static_cast<int>(row % p.OW);
  const long long bo = row / p.OW;
  const int oh = static_cast<int>(bo % p.OH);
  const int b = static_cast<int>(bo / p.OH);
  int acc[V], v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0;
  for (int i = 0; i < p.kh; ++i) {
    const int h = oh * p.sh + i - p.pad;
    if (h < 0 || h >= p.H) continue;
    for (int j = 0; j < p.kw; ++j) {
      const int w = ow * p.sw + j - p.pad;
      if (w < 0 || w >= p.W) continue;
      load<V>(p.x + ((static_cast<long long>(b) * p.H + h) * p.W + w) * p.C + c, v);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] += v[k];
    }
  }
  const int n = p.kh * p.kw;
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = clip127(acc[k] / n);
  store<V>(p.out + row * p.C + c, acc);
}

template <int V>
__global__ void __launch_bounds__(kThreads) k8_avgpool_grad_kernel(K8Pool p) {
  long long row;
  int c;
  if (!position<V>(static_cast<long long>(p.B) * p.H * p.W, p.C, row, c)) return;
  const int iw = static_cast<int>(row % p.W);
  const long long bh = row / p.W;
  const int ih = static_cast<int>(bh % p.H);
  const int b = static_cast<int>(bh / p.H);
  int oh0, oh1, ow0, ow1;
  covering(ih + p.pad, p.kh, p.sh, p.OH, oh0, oh1);
  covering(iw + p.pad, p.kw, p.sw, p.OW, ow0, ow1);
  const int n = p.kh * p.kw;
  int acc[V], g[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0;
  for (int oh = oh0; oh <= oh1; ++oh) {
    for (int ow = ow0; ow <= ow1; ++ow) {
      load<V>(p.gy + ((static_cast<long long>(b) * p.OH + oh) * p.OW + ow) * p.ld_gy + c, g);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] += g[k] / n;
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = clip127(acc[k]);
  store<V>(p.out + row * p.C + c, acc);
}

template <int V>
__global__ void __launch_bounds__(kThreads) k8_concat_kernel(K8Join p) {
  const int C = p.off[p.n];
  int e = *p.exp[0];
  for (int i = 1; i < p.n; ++i) e = max(e, *p.exp[i]);
  if (blockIdx.x == 0 && threadIdx.x == 0) *p.exp_out = e;
  long long row;
  int c;
  if (!position<V>(p.rows, C, row, c)) return;
  int i = 0;
  while (c >= p.off[i + 1]) ++i;
  const int s = static_cast<int>(static_cast<unsigned>(e) - static_cast<unsigned>(*p.exp[i]));
  int v[V];
  load<V>(p.src[i] + row * p.ld[i] + (c - p.off[i]), v);
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = mh::trunc_div(v[k], s);
  store<V>(p.out + row * C + c, v);
}

int blocks_of(long long threads) { return static_cast<int>((threads + kThreads - 1) / kThreads); }

template <int V>
int launch_pool(int kind, const K8Pool& p, cudaStream_t st) {
  const long long in_rows = static_cast<long long>(p.B) * p.H * p.W;
  const long long out_rows = static_cast<long long>(p.B) * p.OH * p.OW;
  const int runs = p.C / V;
  switch (kind) {
    case 0: k8_maxpool_kernel<V><<<blocks_of(out_rows * runs), kThreads, 0, st>>>(p); break;
    case 1: k8_maxpool_grad_kernel<V><<<blocks_of(in_rows * runs), kThreads, 0, st>>>(p); break;
    case 2: k8_avgpool_kernel<V><<<blocks_of(out_rows * runs), kThreads, 0, st>>>(p); break;
    case 3: k8_avgpool_grad_kernel<V><<<blocks_of(in_rows * runs), kThreads, 0, st>>>(p); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind: 0 max pool, 1 its grad, 2 average pool, 3 its grad. vec: the
// channel run a thread takes (16, 4 or 1), which C, ld_gy and every
// pointer must allow. Returns the first CUDA error of the launch.
extern "C" int mh_k8_pool(int kind, int vec, const void* x, const void* y, const void* gy,
                          void* out, int B, int H, int W, int C, int OH, int OW, int kh, int kw,
                          int sh, int sw, int pad, long long ld_gy, int clip, void* stream) {
  K8Pool p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(y),
           static_cast<const int8_t*>(gy), static_cast<int8_t*>(out), B, H, W, C, OH, OW,
           kh, kw, sh, sw, pad, ld_gy, clip};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 16) return launch_pool<16>(kind, p, st);
  if (vec == 4) return launch_pool<4>(kind, p, st);
  if (vec == 1) return launch_pool<1>(kind, p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// n branches (1..8): src, exps, ld and channels arrays of n; rows of the
// output (the product of the leading dims). Returns the first CUDA error.
extern "C" int mh_k8_concat(int vec, int n, const void* const* src, const void* const* exps,
                            const long long* ld, const int* channels, long long rows, void* out,
                            void* exp_out, void* stream) {
  if (n < 1 || n > kMaxBranches) return static_cast<int>(cudaErrorInvalidValue);
  K8Join p{};
  p.n = n, p.rows = rows, p.out = static_cast<int8_t*>(out);
  p.exp_out = static_cast<int*>(exp_out);
  for (int i = 0; i < n; ++i) {
    p.src[i] = static_cast<const int8_t*>(src[i]);
    p.exp[i] = static_cast<const int*>(exps[i]);
    p.ld[i] = ld[i];
    p.off[i + 1] = p.off[i] + channels[i];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long threads = rows * (p.off[n] / vec);
  const int blocks = blocks_of(threads > 0 ? threads : 1);
  if (vec == 16) k8_concat_kernel<16><<<blocks, kThreads, 0, st>>>(p);
  else if (vec == 4) k8_concat_kernel<4><<<blocks, kThreads, 0, st>>>(p);
  else if (vec == 1) k8_concat_kernel<1><<<blocks, kThreads, 0, st>>>(p);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
