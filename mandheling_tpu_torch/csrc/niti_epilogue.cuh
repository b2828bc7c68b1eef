// The epilogues shared by the two-phase fused kernels (K2 fused_matmul_int8,
// K3 fused_conv_int8, K4 fused_dwconv_int8):
//
// - phase 1: each thread keeps max|acc| over its outputs; `block_max_atomic`
//   reduces per warp, then per block, then one atomicMax per block into an
//   int the caller sets to INT32_MIN; `block_max_ticket` ends the reduction
//   in the kernel's own launch instead, with no value set by the caller.
// - phase 2: `requant` is the bit-exact NITI pseudo-stochastic shift of one
//   int32 accumulator to int8, with the shift read from device memory by the
//   kernel, so the host never waits between the phases.
//
// Also the int32 shifts by torch's rules that K7 and K8 share (`trunc_div`).
#pragma once

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace mh {

// Bit-exact ``numerics.psto_round`` (NITI_MNNPstoShiftInt32). Shifts of a
// negative value and any step that could overflow go through unsigned
// arithmetic, which wraps as the int32 arithmetic of XLA does; >> of a
// negative int is arithmetic.
__device__ __forceinline__ int psto_round(int acc, int shift, int rail) {
  shift = min(max(shift, 0), 30);
  const unsigned mask = (1u << shift) - 1u;
  const int bias = static_cast<int>(static_cast<unsigned>(acc >> 31) & mask);
  const int round_temp =
      static_cast<int>(static_cast<unsigned>(acc) + static_cast<unsigned>(bias)) >>
      shift;
  int prob = static_cast<int>(static_cast<unsigned>(acc) -
                              (static_cast<unsigned>(round_temp) << shift));
  if (prob < 0) prob = static_cast<int>(0u - static_cast<unsigned>(prob));
  const int h = shift >> 1;
  const int qprob = prob >> h;
  const int prand = static_cast<int>(
      (static_cast<unsigned>(prob) & ((1u << h) - 1u)) << (shift & 1));
  const int sign = (acc > 0) - (acc < 0);
  const int r = round_temp + (qprob > prand ? sign : 0);
  return min(max(r, -rail), rail);
}

// int32 shifts by torch's rules (K7's values and K8's concat): a << s is 0
// and a >> s the sign for s outside [0, 32).
__device__ __forceinline__ int shl(int v, int s) {
  return (s < 0 || s >= 32) ? 0 : static_cast<int>(static_cast<unsigned>(v) << s);
}

__device__ __forceinline__ int sar(int v, int s) { return (s < 0 || s >= 32) ? v >> 31 : v >> s; }

// numerics.trunc_shift_div: trunc(v / 2^s) with those rules.
__device__ __forceinline__ int trunc_div(int v, int s) {
  const unsigned mask = static_cast<unsigned>(shl(1, s)) - 1u;
  const unsigned bias = static_cast<unsigned>(v >> 31) & mask;
  return sar(static_cast<int>(static_cast<unsigned>(v) + bias), s);
}

// |v| with |INT32_MIN| == INT32_MIN, as jnp.abs and torch.abs give it.
__device__ __forceinline__ int wrap_abs(int v) {
  return v < 0 ? static_cast<int>(0u - static_cast<unsigned>(v)) : v;
}

// Phase 2 of one element: the gradient variant always shifts; the forward
// variant (``requant_forward_from_bw``) casts with wrap when shift <= 0.
__device__ __forceinline__ int8_t requant(int v, int shift, bool grad) {
  const int q = (grad || shift > 0) ? psto_round(v, shift, 127) : v;
  return static_cast<int8_t>(static_cast<unsigned>(q) & 0xffu);
}

// The per-warp, then per-block max of `local`, returned to every thread
// (every thread of the block must call it; the block size is a multiple of
// 32, at most 1024).
__device__ __forceinline__ int block_max(int local) {
  __shared__ int warp_max[32];
  const int tid = threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
  const int nwarps = (blockDim.x * blockDim.y * blockDim.z) >> 5;
  local = __reduce_max_sync(0xffffffffu, local);
  if ((tid & 31) == 0) warp_max[tid >> 5] = local;
  __syncthreads();
  int m = warp_max[0];
  for (int w = 1; w < nwarps; ++w) m = max(m, warp_max[w]);
  return m;
}

// Phase 1 of a block: max over every thread's `local`, then one atomicMax
// into *out (same conditions as block_max).
__device__ __forceinline__ void block_max_atomic(int local, int* out) {
  const int m = block_max(local);
  if (threadIdx.x + threadIdx.y + threadIdx.z == 0) atomicMax(out, m);
}

// Phase 1's end in one launch: each block atomicMax-es its max into state[0]
// and takes a ticket from state[1]; the block that takes the last ticket
// moves state[0] to *out and puts the state back to {INT32_MIN, 0}.
// Invariant: `state` holds {INT32_MIN, 0} before and after every call, so
// the calls on one stream (and a CUDA graph that replays them) need nothing
// set between them.
__device__ __forceinline__ void block_max_ticket(int local, int* state, int* out) {
  const int m = block_max(local);
  if (threadIdx.x + threadIdx.y + threadIdx.z == 0) {
    atomicMax(state, m);
    __threadfence();
    const unsigned blocks = gridDim.x * gridDim.y * gridDim.z;
    if (atomicAdd(reinterpret_cast<unsigned*>(state + 1), 1u) == blocks - 1) {
      __threadfence();
      *out = atomicExch(state, INT_MIN);
      atomicExch(reinterpret_cast<unsigned*>(state + 1), 0u);
    }
  }
}

}  // namespace mh
