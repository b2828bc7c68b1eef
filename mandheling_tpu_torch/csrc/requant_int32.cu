// K7: the NITI requantization of an int32 accumulator that no fused kernel
// takes, in two launches where the plain PyTorch chain takes 20-40.
//
// Replaces no Pallas kernel: the JAX package leaves this requant to XLA
// (mandheling_tpu/ops/numerics.py `range_estimate`, `requant_forward_from_bw`,
// `requant_grad_from_bw`, and their callers in ops/conv.py, ops/matmul.py,
// ops/depthwise.py, ops/eltwise.py and ops/allreduce.py). The port's routing
// rule allows a route past the JAX package's where the bytes are the JAX
// package's: NITI is exact, and both phases compute the chain's bytes.
//
// - phase 1 (`k7_absmax_kernel`): max|v| over the values v into a 0-d int32
//   in device memory, |INT32_MIN| kept negative as torch.abs gives it, and
//   INT32_MIN for no values (the identity of jnp.max). The reduction ends in
//   the launch (mh::block_max_ticket), with one {INT32_MIN, 0} state a stream.
// - phase 2 (`k7_requant_kernel`): reads that max from device memory and
//   computes on the device what the chain computes around it: bw (the
//   range estimate: m <= 1 -> 0, else 32 - clz(m - 1), 31 for every m above
//   2^30), the shift of the mode, the pseudo-stochastic shift, the cast and
//   optionally the relu6 cap; block 0 writes exp_out as a 0-d int32. So the
//   host never waits between the phases, and a replica group's maximum can
//   sit between them (the caller's `allreduce.maybe_pmax`).
//     forward: shift = forward_shift(bw, out_bits) (bw - out_bits, 1 -> 2,
//              <= 0 -> 0, a wrapping cast); out_bits 7 (int8, rail 127) or 15
//              (int16, rail 32767); exp_out = exp_in + shift; relu6 clamps
//              the int8 output to [0, relu6_cap(exp_out)];
//     grad:    psto by bw - margin (clamped to [0, 30]), int8; zero if bw == 0.
//
// The values v, the same in both phases:
// - an int32 accumulator a;
// - the same with a per-channel shift pc (int32 (C,), channel = index % C):
//   left, wrapping (the depthwise forward's exponent alignment), or a
//   truncating right shift (the depthwise filter grad's);
// - the exponent-aligned sum of two int8 or int16 operands (the residual
//   add): e = max(ea, eb), v = trunc(a / 2^(e - ea)) + trunc(b / 2^(e - eb)),
//   computed in registers, so the int32 sum is never written; exp_in = e.
// Shifts follow torch's int32 rules: a << s is 0 for s outside [0, 32), and
// a >> s is the sign for s >= 32.
//
// Bound: memory-bound streaming. Per element, phase 1 reads the values'
// bytes (4 for an accumulator) and phase 2 reads them again and writes the
// output (1 or 2 bytes): 9 bytes an int8 output, at 3.35 TB/s. Phase 2 also
// has a floor on the CUDA cores, psto_round's ~25 integer operations an
// output (K2's phase 2 has the same). At the main path's sizes (at most
// 37.7 M elements at batch 256) phase 2 finds much of phase 1's data in the
// 50 MB L2.
//
// Design: one persistent grid-stride launch a phase, 256 threads a block,
// the grid sized by the wrapper from n and the SM count (no occupancy query
// or attribute call per launch). A thread takes 4 consecutive elements a
// step, two steps in flight: 16-byte loads of an accumulator (8 of int16, 4
// of int8 operands), one 4- or 8-byte store of the output, scalar accesses
// where a pointer is not 16-byte aligned and for the last ragged elements.
// One fixed set of instances for every shape, compiled ahead: the operand
// types are template arguments (int32, or int8/int16 pairs), everything else
// (n, the mode, out_bits, margin, relu6, pc and its direction) is read at
// run time.
#include <type_traits>

#include "niti_epilogue.cuh"

namespace {

constexpr int kThreads = 256;

struct K7Args {
  const void* a;        // int32 accumulator, or the sum's first operand
  const void* b;        // the sum's second operand, or null
  const int* ea;        // 0-d exponents (null reads 0): the accumulator's exp_in is
  const int* eb;        //   ea + eb, the sum's max(ea, eb) and its alignment shifts
  const int* pc;        // (C,) per-channel shifts, or null
  int pc_right;         // pc is a truncating right shift (else a wrapping left one)
  int C;
  long long n;          // elements
  int vec;              // every pointer 16-byte aligned: vector loads and stores
  int* state;           // phase 1: {INT32_MIN, 0} between calls
  int* out_max;         // phase 1: the 0-d max
  const int* m;         // phase 2: the 0-d max phase 1 (and the group) gave
  void* y;              // phase 2: int8 or int16 output
  int* exp_out;         // phase 2, forward: the 0-d exponent, or null
  int grad;             // phase 2: the gradient requant (else the forward one)
  int out_bits;         // forward: 7 (int8) or 15 (int16)
  int margin;           // grad: shift = bw - margin
  int relu6;            // forward, int8: clamp to [0, relu6_cap(exp_out)]
};

using mh::sar;
using mh::shl;
using mh::trunc_div;

__device__ __forceinline__ int wrap_add(int x, int y) {
  return static_cast<int>(static_cast<unsigned>(x) + static_cast<unsigned>(y));
}

__device__ __forceinline__ int wrap_sub(int x, int y) {
  return static_cast<int>(static_cast<unsigned>(x) - static_cast<unsigned>(y));
}

__device__ __forceinline__ int ld_exp(const int* e) { return e ? *e : 0; }

// Elements i..i+3 of an operand of type T (i a multiple of 4, p 16-byte aligned).
template <typename T>
__device__ __forceinline__ void load4(const void* p, long long i, int (&v)[4]) {
  if constexpr (std::is_same_v<T, int>) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(static_cast<const int*>(p) + i));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (std::is_same_v<T, int16_t>) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(static_cast<const int16_t*>(p) + i));
    v[0] = static_cast<int16_t>(q.x & 0xffffu), v[1] = static_cast<int>(q.x) >> 16;
    v[2] = static_cast<int16_t>(q.y & 0xffffu), v[3] = static_cast<int>(q.y) >> 16;
  } else {
    const unsigned q = __ldg(reinterpret_cast<const unsigned*>(static_cast<const int8_t*>(p) + i));
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = static_cast<int8_t>((q >> (8 * k)) & 0xffu);
  }
}

template <typename T>
__device__ __forceinline__ int load1(const void* p, long long i) {
  return static_cast<int>(static_cast<const T*>(p)[i]);
}

// Per-thread constants of the values: the sum's alignment shifts.
struct Align {
  int sa, sb, e;
};

template <typename TB>
__device__ __forceinline__ Align align(const K7Args& p) {
  if constexpr (std::is_void_v<TB>) {
    return {0, 0, wrap_add(ld_exp(p.ea), ld_exp(p.eb))};
  } else {
    const int ea = ld_exp(p.ea), eb = ld_exp(p.eb), e = max(ea, eb);
    return {wrap_sub(e, ea), wrap_sub(e, eb), e};
  }
}

// The values of elements i..i+3 (those below n; `full`: all four are).
template <typename TA, typename TB>
__device__ __forceinline__ void values(const K7Args& p, const Align& al, long long i, bool full,
                                       int (&v)[4]) {
  int va[4] = {0, 0, 0, 0};
  int vb[4] = {0, 0, 0, 0};
  if (full && p.vec) {
    load4<TA>(p.a, i, va);
    if constexpr (!std::is_void_v<TB>) load4<TB>(p.b, i, vb);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (i + k < p.n) {
        va[k] = load1<TA>(p.a, i + k);
        if constexpr (!std::is_void_v<TB>) vb[k] = load1<TB>(p.b, i + k);
      }
    }
  }
  if constexpr (!std::is_void_v<TB>) {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = trunc_div(va[k], al.sa) + trunc_div(vb[k], al.sb);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = va[k];
    if (p.pc) {
      int c = static_cast<int>(i % p.C);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = __ldg(p.pc + c);
        v[k] = p.pc_right ? trunc_div(v[k], s) : shl(v[k], s);
        if (++c == p.C) c = 0;
      }
    }
  }
}

// Phase 1: max|v| over the block, then the ticketed end of the reduction.
template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads) k7_absmax_kernel(K7Args p) {
  const Align al = align<TB>(p);
  const long long chunks = (p.n + 3) >> 2;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  int local = INT_MIN;
  for (long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; j < chunks;
       j += 2 * stride) {
    const long long j1 = j + stride;
    int v0[4], v1[4];
    values<TA, TB>(p, al, 4 * j, 4 * j + 4 <= p.n, v0);
    if (j1 < chunks) values<TA, TB>(p, al, 4 * j1, 4 * j1 + 4 <= p.n, v1);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * j + k < p.n) local = max(local, mh::wrap_abs(v0[k]));
    if (j1 < chunks) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * j1 + k < p.n) local = max(local, mh::wrap_abs(v1[k]));
    }
  }
  mh::block_max_ticket(local, p.state, p.out_max);
}

// The requant of the site, fixed by the max: what each value becomes.
struct Rule {
  int shift;  // psto shift; 0 in the forward mode means a wrapping cast
  int rail;
  int cap;    // relu6 cap, or -1
  bool zero;  // grad with bw == 0
  bool psto;
};

__device__ __forceinline__ int relu6_cap(int e) {
  if (e <= 0) {
    const int s = min(max(static_cast<int>(0u - static_cast<unsigned>(e)), 0), 5);
    return min(6 << s, 127);
  }
  return 6 >> min(e, 31);
}

__device__ __forceinline__ int apply(const Rule& r, int v) {
  if (r.zero) return 0;
  int q = r.psto ? mh::psto_round(v, r.shift, r.rail) : v;
  if (r.cap >= 0) q = max(min(static_cast<int>(static_cast<int8_t>(q & 0xff)), r.cap), 0);
  return q;
}

template <typename TOut>
__device__ __forceinline__ void store(const K7Args& p, const Rule& r, long long i, bool full,
                                      const int (&v)[4]) {
  TOut* y = static_cast<TOut*>(p.y);
  int q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = apply(r, v[k]);
  if (full && p.vec) {
    if constexpr (sizeof(TOut) == 1) {
      unsigned w = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) w |= (static_cast<unsigned>(q[k]) & 0xffu) << (8 * k);
      *reinterpret_cast<unsigned*>(y + i) = w;
    } else {
      const uint2 w = {(static_cast<unsigned>(q[0]) & 0xffffu) | (static_cast<unsigned>(q[1]) << 16),
                       (static_cast<unsigned>(q[2]) & 0xffffu) | (static_cast<unsigned>(q[3]) << 16)};
      *reinterpret_cast<uint2*>(y + i) = w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i + k < p.n)
        y[i + k] = static_cast<TOut>(static_cast<std::make_unsigned_t<TOut>>(q[k]));
  }
}

// Phase 2: the requant of every value, with the shift from the max in
// device memory; block 0 writes exp_out.
template <typename TA, typename TB, typename TOut>
__global__ void __launch_bounds__(kThreads) k7_requant_kernel(K7Args p) {
  const Align al = align<TB>(p);
  const int m = *p.m;
  const int bw = m <= 1 ? 0 : 32 - __clz(m - 1);
  Rule r{0, p.grad ? 127 : (1 << p.out_bits) - 1, -1, false, true};
  if (p.grad) {
    r.shift = bw - p.margin;
    r.zero = bw == 0;
  } else {
    const int s = bw - p.out_bits;
    r.shift = s > 1 ? s : (s == 1 ? 2 : 0);
    r.psto = r.shift > 0;
    const int exp_out = wrap_add(al.e, r.shift);
    if (p.relu6) r.cap = relu6_cap(exp_out);
    if (p.exp_out && blockIdx.x == 0 && threadIdx.x == 0) *p.exp_out = exp_out;
  }
  const long long chunks = (p.n + 3) >> 2;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; j < chunks;
       j += 2 * stride) {
    const long long j1 = j + stride;
    int v0[4], v1[4];
    values<TA, TB>(p, al, 4 * j, 4 * j + 4 <= p.n, v0);
    if (j1 < chunks) values<TA, TB>(p, al, 4 * j1, 4 * j1 + 4 <= p.n, v1);
    store<TOut>(p, r, 4 * j, 4 * j + 4 <= p.n, v0);
    if (j1 < chunks) store<TOut>(p, r, 4 * j1, 4 * j1 + 4 <= p.n, v1);
  }
}

template <typename TA, typename TB>
int launch_types(int phase, const K7Args& p, int blocks, cudaStream_t st) {
  if (phase == 0)
    k7_absmax_kernel<TA, TB><<<blocks, kThreads, 0, st>>>(p);
  else if (p.grad || p.out_bits == 7)
    k7_requant_kernel<TA, TB, int8_t><<<blocks, kThreads, 0, st>>>(p);
  else
    k7_requant_kernel<TA, TB, int16_t><<<blocks, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ta, tb: the operands' element bytes (ta 4 and tb 0: an int32 accumulator;
// else 1 or 2 each: the sum of two int8 / int16 operands).
int launch(int phase, int ta, int tb, const K7Args& p, int blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ta == 4 && tb == 0) return launch_types<int, void>(phase, p, blocks, st);
  if (ta == 1 && tb == 1) return launch_types<int8_t, int8_t>(phase, p, blocks, st);
  if (ta == 1 && tb == 2) return launch_types<int8_t, int16_t>(phase, p, blocks, st);
  if (ta == 2 && tb == 1) return launch_types<int16_t, int8_t>(phase, p, blocks, st);
  if (ta == 2 && tb == 2) return launch_types<int16_t, int16_t>(phase, p, blocks, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Both return the first CUDA error of the launch.
extern "C" int mh_k7_absmax(int ta, int tb, const void* a, const void* b, const void* ea,
                            const void* eb, const void* pc, int pc_right, int C, long long n,
                            int vec, void* state, void* out_max, int blocks, void* stream) {
  K7Args p{};
  p.a = a, p.b = b, p.ea = static_cast<const int*>(ea), p.eb = static_cast<const int*>(eb);
  p.pc = static_cast<const int*>(pc), p.pc_right = pc_right, p.C = C, p.n = n, p.vec = vec;
  p.state = static_cast<int*>(state), p.out_max = static_cast<int*>(out_max);
  return launch(0, ta, tb, p, blocks, stream);
}

extern "C" int mh_k7_requant(int ta, int tb, const void* a, const void* b, const void* ea,
                             const void* eb, const void* pc, int pc_right, int C, long long n,
                             int vec, const void* m, void* y, void* exp_out, int grad,
                             int out_bits, int margin, int relu6, int blocks, void* stream) {
  K7Args p{};
  p.a = a, p.b = b, p.ea = static_cast<const int*>(ea), p.eb = static_cast<const int*>(eb);
  p.pc = static_cast<const int*>(pc), p.pc_right = pc_right, p.C = C, p.n = n, p.vec = vec;
  p.m = static_cast<const int*>(m), p.y = y, p.exp_out = static_cast<int*>(exp_out);
  p.grad = grad, p.out_bits = out_bits, p.margin = margin, p.relu6 = relu6;
  return launch(1, ta, tb, p, blocks, stream);
}
