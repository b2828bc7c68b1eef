// K6: max|A*B| with int8 operands multiplied as bf16 on the tensor cores:
// the bf16-operand instance of K2's phase-1 (max) kernel.
//
// Replaces the bf16 variant of the TPU micro-probe's kernel,
// tools/probes/dot_probe.py `make_dot.kernel` (its pallas_call in `run`):
// int8 tiles converted to bf16, a dot with float32 accumulation, the result
// converted to int32, then max|.|. Its int8 variant is K2's phase 1 itself.
//
// Every int8 is exact in bf16, wgmma sums in float32, and the epilogue
// truncates each sum to int32 (__float2int_rz) and reduces max|.| as K2
// does (niti_epilogue.cuh). A float32 sum is exact while every partial sum
// stays below 2^24, as it does for the probe's operands in [-80, 80) up to
// K = 2621; beyond, it rounds as the TPU dot does.
//
// Bound: the probe's largest shape, (49152, 256) x (256, 512), does 12.9 G
// operations on 12.7 MB: 13.0 us at the H100 SXM's dense bf16 rate (989
// TFLOP/s) against 3.8 us of bytes, so the tensor cores bound it.
//
// Design: blocks of two warpgroups run wgmma.m64n64k16 from shared memory
// on 128 x BN tiles (BN = 64, 128 or 256; N = 512 in two tiles), K in
// chunks of 64. The int8 tiles arrive by cp.async as they lie in memory (A
// row-major, B N-major) and the block converts them into bf16 tiles in the
// 128-byte swizzle, K-major: the int8 GEMMs' layout, B turned on the way, so
// that one descriptor form serves both. The conversion takes about 3
// integer and float instructions an element, none on the conversion unit.
// Where B's BN columns of all of K fit in shared memory as bf16 (K <= 256 at
// BN = 256: the probe), each block converts them once and walks many M
// tiles, one block an SM; the A chunks, (tile, chunk) in turn, stream
// through a 3-stage ring two ahead and are converted while the previous
// chunk's wgmma runs. Otherwise a block takes one tile, and each chunk's A
// and B pass through the ring and the conversion.
#include <algorithm>

#include "gemm_s8_sm90.cuh"
#include "niti_epilogue.cuh"

namespace {

constexpr int BM = 128, NT = 256, KC = 64, RAW = 3;

template <int BN>
struct Layout {
  static constexpr int A_BF = BM * 128, B_BF = BN * 128, BF = A_BF + B_BF;  // one bf16 buffer
  static constexpr int A_RAW = BM * KC, RAW_BYTES = A_RAW + KC * BN;        // one raw stage
  static constexpr int SMEM = 2 * BF + RAW * RAW_BYTES + 1024;
};

// Rows [0, ROWS) x COLS bytes of a row-major operand (row r at base + r *
// pitch; `rows` rows and `cols` bytes valid, the rest zero) into a tile of
// row pitch COLS, w bytes a copy (16, 8, 4; 1: the byte path).
template <int ROWS, int COLS>
__device__ __forceinline__ void load_raw(uint8_t* tile, const int8_t* base, long long pitch,
                                         int rows, int cols, int w) {
  const int unit = w == 1 ? 16 : w, per_row = COLS / unit;
  for (int i = threadIdx.x; i < ROWS * per_row; i += NT) {
    const int r = i / per_row, c = (i - r * per_row) * unit;
    const int bytes = r < rows ? min(max(cols - c, 0), unit) : 0;
    const int8_t* src = bytes > 0 ? base + r * pitch + c : base;
    if (w == 1)
      mh90::copy16_unaligned(tile + r * COLS + c, src, bytes);
    else
      mh90::copy_unit(tile + r * COLS + c, src, bytes, w);
  }
}

// 4 int8 (one 32-bit word) -> 4 bf16 (8 bytes), exact, without the
// conversion unit (16 results a clock per SM): byte v ^ 0x80 = v + 128 under
// the exponent of 2^23 is the float 2^23 + 128 + v; one add leaves v, exact,
// and a float that holds an int8 has its low 16 bits zero, so its bf16 is
// its high half.
__device__ __forceinline__ uint2 bf16x4(uint32_t v) {
  const uint32_t u = v ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - 8388736.0f);
  return make_uint2(__byte_perm(f[0], f[1], 0x7632), __byte_perm(f[2], f[3], 0x7632));
}

// Byte offset of bf16 element kk (< 64) of row r in a 128-byte-swizzled tile.
__device__ __forceinline__ int sw_offset(int r, int kk) {
  const int c = 2 * kk;
  return r * 128 + (((c >> 4) ^ (r & 7)) << 4) + (c & 15);
}

// A's raw chunk (BM x KC int8, row pitch KC) -> bf16 K-major rows, 128-byte
// swizzle.
__device__ __forceinline__ void convert_a(const uint8_t* raw, uint8_t* bf) {
  for (int i = threadIdx.x; i < BM * (KC / 4); i += NT) {
    const int r = i / (KC / 4), kk = 4 * (i % (KC / 4));
    *reinterpret_cast<uint2*>(bf + sw_offset(r, kk)) =
        bf16x4(*reinterpret_cast<const uint32_t*>(raw + r * KC + kk));
  }
}

// B's raw chunk (KC x BN int8, N-major, row pitch BN) -> bf16 K-major rows
// n, 128-byte swizzle. A warp takes 8 columns x 4 groups of 4 k, so that its
// 8-byte stores fall on distinct banks.
template <int BN>
__device__ __forceinline__ void convert_b(const uint8_t* raw, uint8_t* bf) {
  for (int i = threadIdx.x; i < BN * (KC / 4); i += NT) {
    const int rest = i >> 5, n = (i & 7) + 8 * (rest % (BN / 8));
    const int kb = ((i >> 3) & 3) + 4 * (rest / (BN / 8));
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) v |= static_cast<uint32_t>(raw[(4 * kb + b) * BN + n]) << (8 * b);
    *reinterpret_cast<uint2*>(bf + sw_offset(n, 4 * kb)) = bf16x4(v);
  }
}

__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <int NJ>
__device__ __forceinline__ void fence_acc(float (&acc)[NJ][32]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[j][i])::"memory");
}

struct Args {
  const int8_t* a;  // A(m, k) = a[m * sam + k]
  const int8_t* b;  // B(k, n) = b[k * sbk + n]
  int M, N, K;
  long long sam, sbk;
  int aw, bw;  // copy widths in bytes: 16, 8, 4 or 1
};

// One chunk's wgmma: this warpgroup's 64 rows of the bf16 A tile at sa
// against BN columns of the bf16 B tile at sb, nk k16 steps; committed, not
// waited for.
template <int NJ>
__device__ __forceinline__ void mma_chunk(float (&acc)[NJ][32], uint32_t sa, uint32_t sb, int nk) {
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int kk = 0; kk < nk; ++kk)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      wgmma_bf16_n64(acc[j], mh90::desc_sw128(sa + kk * 32),
                     mh90::desc_sw128(sb + j * 64 * 128 + kk * 32));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// max(local, max|int32(sum)|) over this thread's in-range sums of the tile
// at (m0, n0). Every sum is an integer-valued float, so where all of them
// lie below 2^31 in magnitude the max is taken over |sum| as floats and
// truncated once (__float2int_rz is exact there); otherwise each sum is
// truncated (saturating, as the plain version's cast on the card does) and
// reduced with the wrap of |INT32_MIN|. An n64 accumulator is two n32 ones
// in a row (the same fragment layout), so the int8 GEMMs' walk applies.
template <int BN>
__device__ __forceinline__ int tile_max(const float (&acc)[BN / 64][32], const Args& p, int m0,
                                        int n0, int local) {
  const float (&a)[BN / 32][16] = reinterpret_cast<const float (&)[BN / 32][16]>(acc);
  float fmax_abs = 0.f;
  bool any = false;
  mh90::for_each_kmajor<BN>(a, [&](int r, int q, float v) {
    if (m0 + r < p.M && n0 + q < p.N) {
      fmax_abs = fmaxf(fmax_abs, fabsf(v));
      any = true;
    }
  });
  if (fmax_abs < 2147483648.0f) return any ? max(local, __float2int_rz(fmax_abs)) : local;
  mh90::for_each_kmajor<BN>(a, [&](int r, int q, float v) {
    if (m0 + r < p.M && n0 + q < p.N) local = max(local, mh::wrap_abs(__float2int_rz(v)));
  });
  return local;
}

// One 128 x BN tile a block, K chunk by chunk: the chunk's A and B int8
// tiles through the ring, both converted in the block. For a K whose bf16 B
// does not fit in shared memory beside the ring (above 256 at BN = 256).
template <int BN>
__global__ void __launch_bounds__(NT) max_bf16_kernel(Args p, int* out_max) {
  using L = Layout<BN>;
  constexpr int NJ = BN / 64;
  uint8_t* smem = mh90::aligned_smem();
  uint8_t* raw = smem + 2 * L::BF;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int chunks = (p.K + KC - 1) / KC;
  auto load = [&](int c) {
    uint8_t* st = raw + (c % RAW) * L::RAW_BYTES;
    const int k0 = c * KC;
    load_raw<BM, KC>(st, p.a + m0 * p.sam + k0, p.sam, p.M - m0, p.K - k0, p.aw);
    load_raw<KC, BN>(st + L::A_RAW, p.b + k0 * p.sbk + n0, p.sbk, p.K - k0, p.N - n0, p.bw);
  };
  float acc[NJ][32];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
#pragma unroll
  for (int c = 0; c < RAW - 1; ++c) {
    if (c < chunks) load(c);
    mh90::cp_async_commit();
  }
  const int wg = threadIdx.x >> 7;
  for (int c = 0; c < chunks; ++c) {
    mh90::cp_async_wait<RAW - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();                 // ... every thread's; chunk c - 2's wgmma is done
    if (c + RAW - 1 < chunks) load(c + RAW - 1);
    mh90::cp_async_commit();
    uint8_t* bf = smem + (c & 1) * L::BF;
    convert_a(raw + (c % RAW) * L::RAW_BYTES, bf);
    convert_b<BN>(raw + (c % RAW) * L::RAW_BYTES + L::A_RAW, bf + L::A_BF);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    mma_chunk(acc, mh90::smem_u32(bf) + wg * 64 * 128, mh90::smem_u32(bf + L::A_BF),
              min(KC, p.K - c * KC + 15) / 16);
    // chunk c stays in flight while chunk c + 1 is converted into the other
    // buffer; chunk c - 1's, which read that buffer, is done
    wgmma_wait<1>();
    fence_acc(acc);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  mh::block_max_atomic(tile_max<BN>(acc, p, m0, n0, INT_MIN), out_max);
}

template <int BN>
struct Resident {
  static constexpr int A_BF = BM * 128, A_RAW = BM * KC;
  // the bf16 B (all of K), two bf16 A tiles, the A ring
  static int smem(int chunks) { return chunks * BN * 128 + 2 * A_BF + RAW * A_RAW + 1024; }
};

// K of at most a few chunks (the probe's): B's BN columns, all of K, are
// converted to bf16 once per block and stay in shared memory, while the
// block walks the 128-row M tiles m0 = 128 (blockIdx.y + i gridDim.y); their
// A chunks, (tile i, chunk c) in turn, stream through the ring and are
// converted while the previous chunk's wgmma runs.
template <int BN>
__global__ void __launch_bounds__(NT) max_bf16_resident_kernel(Args p, int* out_max) {
  using R = Resident<BN>;
  constexpr int NJ = BN / 64;
  const int chunks = (p.K + KC - 1) / KC;
  uint8_t* bbf = mh90::aligned_smem();
  uint8_t* abf = bbf + chunks * BN * 128;
  uint8_t* araw = abf + 2 * R::A_BF;
  const int n0 = blockIdx.x * BN;
  const int tiles = (p.M + BM - 1) / BM;
  const int mine = tiles > static_cast<int>(blockIdx.y)
                       ? (tiles - blockIdx.y + gridDim.y - 1) / gridDim.y
                       : 0;
  const int steps = mine * chunks;  // (tile, chunk) pairs
  // B, a few chunks at a time through the A tiles' space
  constexpr int PER_ROUND = 2 * R::A_BF / (KC * BN);
  for (int c0 = 0; c0 < chunks; c0 += PER_ROUND) {
    for (int c = c0; c < min(chunks, c0 + PER_ROUND); ++c)
      load_raw<KC, BN>(abf + (c - c0) * KC * BN, p.b + c * KC * p.sbk + n0, p.sbk,
                       p.K - c * KC, p.N - n0, p.bw);
    mh90::cp_async_commit();
    mh90::cp_async_wait<0>();
    __syncthreads();
    for (int c = c0; c < min(chunks, c0 + PER_ROUND); ++c)
      convert_b<BN>(abf + (c - c0) * KC * BN, bbf + c * BN * 128);
    __syncthreads();
  }
  auto load = [&](int f) {
    const int i = f / chunks, c = f - i * chunks;
    const int m0 = (blockIdx.y + i * gridDim.y) * BM;
    load_raw<BM, KC>(araw + (f % RAW) * R::A_RAW, p.a + m0 * p.sam + c * KC, p.sam, p.M - m0,
                     p.K - c * KC, p.aw);
  };
#pragma unroll
  for (int f = 0; f < RAW - 1; ++f) {
    if (f < steps) load(f);
    mh90::cp_async_commit();
  }
  float acc[NJ][32];
  int local = INT_MIN;
  const int wg = threadIdx.x >> 7;
  for (int f = 0; f < steps; ++f) {
    const int i = f / chunks, c = f - i * chunks;
    mh90::cp_async_wait<RAW - 2>();
    __syncthreads();  // step f's A has landed; step f - 2's wgmma is done
    if (f + RAW - 1 < steps) load(f + RAW - 1);
    mh90::cp_async_commit();
    uint8_t* a = abf + (f & 1) * R::A_BF;
    convert_a(araw + (f % RAW) * R::A_RAW, a);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int v = 0; v < 32; ++v) acc[j][v] = 0.f;
    }
    mma_chunk(acc, mh90::smem_u32(a) + wg * 64 * 128, mh90::smem_u32(bbf + c * BN * 128),
              min(KC, p.K - c * KC + 15) / 16);
    if (c == chunks - 1) {
      wgmma_wait<0>();
      fence_acc(acc);
      local = tile_max<BN>(acc, p, (blockIdx.y + i * gridDim.y) * BM, n0, local);
    } else {
      wgmma_wait<1>();  // step f stays in flight while step f + 1 is converted
      fence_acc(acc);
    }
  }
  mh::block_max_atomic(local, out_max);
}

template <int BN>
int launch(const Args& p, int* out, cudaStream_t st) {
  const int chunks = (p.K + KC - 1) / KC, n_tiles = (p.N + BN - 1) / BN;
  int dev = 0, limit = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = Resident<BN>::smem(chunks);
  if (chunks > 0 && smem <= limit) {  // one block an SM
    const int m_tiles = (p.M + BM - 1) / BM;
    const dim3 grid(n_tiles, std::max(1, std::min(m_tiles, sms / n_tiles)));
    return mh90::launch(max_bf16_resident_kernel<BN>, grid, NT, smem, smem, st, p, out);
  }
  const dim3 grid((p.M + BM - 1) / BM, n_tiles);
  return mh90::launch(max_bf16_kernel<BN>, grid, NT, Layout<BN>::SMEM, Layout<BN>::SMEM, st, p,
                      out);
}

}  // namespace

// Returns the first CUDA error of the launch; *out_max must hold INT32_MIN.
// A (M, K) with k contiguous, B (K, N) with n contiguous; a_width and
// b_width: the widest copy (16, 8, 4, else 1) that keeps every row aligned.
extern "C" int mh_matmul_max_bf16(const void* a, const void* b, void* out_max, int M, int N,
                                  int K, long long sam, long long sbk, int a_width, int b_width,
                                  void* stream) {
  const Args p{static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), M, N, K, sam, sbk,
               a_width, b_width};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* out = static_cast<int*>(out_max);
  if (N <= 64) return launch<64>(p, out, st);
  if (N <= 128) return launch<128>(p, out, st);
  return launch<256>(p, out, st);
}
