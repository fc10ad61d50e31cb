// Weight-only int8 matrix product (W8A16) for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces: distllm_tpu/ops/quantized_matmul.py int8_matmul_pallas (line
// 119; kernel body _kernel, line 72; pallas_call, line 147) — every
// projection of an int8-quantized Mistral or BERT forward
// (models/common.dense -> ops/quantized_matmul.int8_dense).
//
// What it computes, for x [M, K] (bf16 or fp32), q [K, N] int8 (the JAX
// [in, out] layout) and a per-output-channel fp32 scale [N]:
//   out[m, n] = T(scale[n] * sum_k x[m, k] * q[k, n])
// Every product is exact (a bf16 x int8 product fits fp32, and so does a
// bf16 x bf16 one), every sum is fp32, the scale multiplies the fp32 sum
// once and the result rounds once to T. No float copy of the weight is
// ever written to device memory. Two routes, chosen by the wrapper
// (ops/quantized_matmul.kernel_route):
//
// Route 1, tensor cores (bf16 x). What bounds it on an H100 SXM: at decode
// (M <= 16) the int8 weight bytes, K * N over 3.35 TB/s (4096 x 14336:
// 58.7 MB, 17.5 us); at prefill and embed sizes the 2 * M * K * N
// operations over 989 TFLOP/s. The codes are read as they lie ([K, N], N
// contiguous) and widened to bf16 exactly in registers
// (mma_tiles::int8_bytes_to_bf16x2: a byte permute, two logic ops and a
// bf16 subtraction per pair); no float copy of the weight reaches device
// memory. Two tile configurations:
// - Small M (decode, M <= 16): mma.sync m16n8k16, one 16-row atom, 4 warps
//   x 32 columns, K walked 64 deep through a cp.async ring of 6 stages
//   (zero-filled past M, K and N; 40 KB of codes in flight per block, up
//   to three blocks per SM), split-K over gridDim.y until the card fills.
//   The m16n8k16 B fragment wants, in lane (g, t), rows 2t, 2t + 1,
//   2t + 8, 2t + 9 of one column g; a lane reads the
//   32-bit word of 4 adjacent columns 4g..4g+3 at each of those rows and
//   hands byte j of every word to the n8 atom j. So atom j multiplies the
//   columns 4g + j of a 32-column group: a permutation of the output
//   columns, undone in the epilogue, where lane t then holds the 8
//   adjacent columns 8t..8t+7 of its rows (one 16-byte store). K is not
//   permuted. Staged q rows are padded to 144 bytes, so the lanes' 32-bit
//   reads fall in 32 distinct banks.
// - Large M (prefill, embed): wgmma m64n128k16, 128 x 128 tiles, two
//   warpgroups of 64 rows. TMA copies x and the codes (128-byte swizzle,
//   zero-filled past M, K and N) into a ring of 3 stages that complete on
//   mbarriers, one thread issuing two copies a step; x's A fragments come
//   from ldmatrix into registers; the codes are widened once per block
//   and K step into a bf16 B tile in the no-swizzle MN-major layout of
//   wgmma (two tiles alternate, so the next step's widening overlaps this
//   step's products); two blocks per SM; tiles rasterised in groups of 16
//   along M, so the blocks resident at once share their weight tiles (and
//   x tiles) in the 50 MB L2 cache. TMA rather than cp.async: two copy
//   instructions a step instead of six per thread (faster on the card:
//   PERF.md).
// - Splits write fp32 partial sums; a second kernel adds them in split
//   order, applies the scale and rounds: no atomics, the same result on
//   every run.
//
// Route 0, CUDA cores (fp32 x; a bf16 tensor core would round it). Each
// int8 code is widened to fp32 in shared memory and multiplied by fmaf.
// Design:
// - The TPU kernel holds the whole [M <= 512, 256] fp32 accumulator in VMEM
//   and walks K as a sequential grid axis. Here one block of 256 threads
//   owns a BM x 128 output tile (BM = 16 for M <= 16, else 64) and walks K
//   in 32-deep steps: the x tile and the int8 q tile are loaded from device
//   memory with 16-byte loads (q coalesced along N, 8 threads per 128-byte
//   row), widened to fp32 into shared memory, and the next step's loads are
//   issued into registers before the current step is multiplied.
// - Each thread keeps a TM x 8 fp32 micro-tile in registers (TM = BM / 16
//   rows; columns tx*4..+3 and 64+tx*4..+3, so a quarter warp reads 128
//   contiguous bytes of the staged weight tile: no bank conflict).
// - Any M >= 1: rows past M load as zeros and are never written; N and K
//   need only be multiples of 16 (one 16-byte int8 load), columns and K
//   depth past the end load as zeros.
// - Split-K for small M: when the output tiles alone cannot fill the card
//   the wrapper splits K over gridDim.z; each split writes its fp32 partial
//   sums, and a second kernel adds the splits in order, applies the scale
//   and rounds. With one split the first kernel does that epilogue itself.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <atomic>

#include "mma_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 128;                       // output columns per block
constexpr int kBK = 32;                        // K depth per staged step
constexpr int kColGroups = 16;                 // threads across N
constexpr int kRowGroups = kThreads / kColGroups;  // threads across M
constexpr int kHalf = kBN / 2;                 // a thread's two column quads

struct Params {
  const void* x;        // [M, K]
  const int8_t* q;      // [K, N]
  const float* scale;   // [N]
  void* out;            // [M, N], written when splits == 1
  float* partial;       // [splits, M, N], written when splits > 1
  int m;
  int k;
  int n;
  int k_per_split;      // a multiple of kBK
  int splits;
};

__device__ __forceinline__ float code(uint32_t word, int byte) {
  return static_cast<float>(static_cast<int8_t>((word >> (8 * byte)) & 0xFFu));
}

__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* v) {
  __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(dst);
  pairs[0] = __floats2bfloat162_rn(v[0], v[1]);
  pairs[1] = __floats2bfloat162_rn(v[2], v[3]);
}

// One K step's device-memory loads of a block, held in registers so they
// are in flight while the previous step is multiplied: one 16-byte row
// chunk of q and kXLoads 16-byte row chunks of x per thread.
template <int TM>
struct Tile {
  static constexpr int kBM = kRowGroups * TM;
  static constexpr int kVec = 4;                        // fp32 in 16 bytes
  static constexpr int kXPerRow = kBK / kVec;           // x chunks in a row
  static constexpr int kXChunks = kBM * kXPerRow;       // x chunks per step
  static constexpr int kXLoads = (kXChunks + kThreads - 1) / kThreads;
  static constexpr int kAStride = kBM + 4;  // keeps 16-byte row alignment

  uint4 q_raw;
  uint4 x_raw[kXLoads];

  __device__ __forceinline__ void load(const Params& p, int tid, int m0,
                                       int n0, int k0, int k_end) {
    const int kq = k0 + tid / (kBN / 16);
    const int nq = n0 + (tid % (kBN / 16)) * 16;
    q_raw = make_uint4(0, 0, 0, 0);
    if (kq < k_end && nq < p.n) {
      q_raw = *reinterpret_cast<const uint4*>(p.q + size_t(kq) * p.n + nq);
    }
    const float* x = static_cast<const float*>(p.x);
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int chunk = tid + i * kThreads;
      const int row = chunk / kXPerRow;
      const int kx = k0 + (chunk % kXPerRow) * kVec;
      x_raw[i] = make_uint4(0, 0, 0, 0);
      if (chunk < kXChunks && m0 + row < p.m && kx < k_end) {
        x_raw[i] = *reinterpret_cast<const uint4*>(x + size_t(m0 + row) * p.k + kx);
      }
    }
  }

  // Widen the held codes to fp32 into shared memory as s_b[k][n], and
  // store x transposed as s_a[k][m].
  __device__ __forceinline__ void stage(int tid, float (*s_a)[kAStride],
                                        float (*s_b)[kBN]) const {
    const int q_row = tid / (kBN / 16);
    const int q_col = (tid % (kBN / 16)) * 16;
    const uint32_t words[4] = {q_raw.x, q_raw.y, q_raw.z, q_raw.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float v[4] = {code(words[w], 0), code(words[w], 1),
                          code(words[w], 2), code(words[w], 3)};
      store4(&s_b[q_row][q_col + 4 * w], v);
    }
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int chunk = tid + i * kThreads;
      if (chunk < kXChunks) {
        const int row = chunk / kXPerRow;
        const int kc = (chunk % kXPerRow) * kVec;
        const float v[kVec] = {__uint_as_float(x_raw[i].x), __uint_as_float(x_raw[i].y),
                               __uint_as_float(x_raw[i].z), __uint_as_float(x_raw[i].w)};
#pragma unroll
        for (int e = 0; e < kVec; ++e) s_a[kc + e][row] = v[e];
      }
    }
  }
};

template <int TM>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const Params p) {
  using Staged = Tile<TM>;
  constexpr int kBM = Staged::kBM;

  __shared__ __align__(16) float s_a[kBK][Staged::kAStride];  // x, k-major
  __shared__ __align__(16) float s_b[kBK][kBN];               // q as fp32

  const int tid = threadIdx.x;
  const int tx = tid % kColGroups;
  const int ty = tid / kColGroups;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int k_begin = blockIdx.z * p.k_per_split;
  const int k_end = min(p.k, k_begin + p.k_per_split);
  const int steps = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  Staged tile;
  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  if (steps > 0) {
    tile.load(p, tid, m0, n0, k_begin, k_end);
    tile.stage(tid, s_a, s_b);
    __syncthreads();
  }
  for (int s = 0; s < steps; ++s) {
    const bool more = s + 1 < steps;
    // The next step's loads are in flight during this step's products.
    if (more) tile.load(p, tid, m0, n0, k_begin + (s + 1) * kBK, k_end);
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM];
      if constexpr (TM == 4) {
        const float4 av = *reinterpret_cast<const float4*>(&s_a[kk][ty * 4]);
        a[0] = av.x;
        a[1] = av.y;
        a[2] = av.z;
        a[3] = av.w;
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = s_a[kk][ty * TM + i];
      }
      const float4 b0 = *reinterpret_cast<const float4*>(&s_b[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&s_b[kk][kHalf + tx * 4]);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
    if (more) {
      tile.stage(tid, s_a, s_b);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= p.m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * kHalf + tx * 4;
      if (n >= p.n) continue;  // N % 16 == 0: a quad is all in or all out
      float v[4];
      if (p.splits == 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = acc[i][4 * h + j] * p.scale[n + j];
        store4(static_cast<float*>(p.out) + size_t(m) * p.n + n, v);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = acc[i][4 * h + j];
        store4(p.partial + (size_t(blockIdx.z) * p.m + m) * p.n + n, v);
      }
    }
  }
}

// out = T(scale * sum over splits of partial), the splits added in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_splits_kernel(const Params p) {
  const size_t plane = size_t(p.m) * p.n;
  const size_t quads = plane / 4;
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < quads;
       i += size_t(gridDim.x) * blockDim.x) {
    const size_t e = 4 * i;
    const int n = int(e % p.n);
    float4 sum = *reinterpret_cast<const float4*>(p.partial + e);
    for (int z = 1; z < p.splits; ++z) {
      const float4 part = *reinterpret_cast<const float4*>(p.partial + z * plane + e);
      sum.x += part.x;
      sum.y += part.y;
      sum.z += part.z;
      sum.w += part.w;
    }
    const float v[4] = {sum.x * p.scale[n], sum.y * p.scale[n + 1],
                        sum.z * p.scale[n + 2], sum.w * p.scale[n + 3]};
    store4(static_cast<T*>(p.out) + e, v);
  }
}

// ------------------------------------------------------------ tensor cores
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kGroupCols = 32;  // columns of a warp: four n8 atoms
constexpr int kGroupM = 16;     // M tiles rasterised together

// The output tile of this block, BM x BN: M tiles vary fastest within
// groups of kGroupM, so the blocks resident at once share weight tiles.
template <int BM, int BN>
__device__ __forceinline__ void tile_origin(const Params& p, int& m0, int& n0) {
  const int m_tiles = (p.m + BM - 1) / BM;
  const int n_tiles = (p.n + BN - 1) / BN;
  const int per_group = kGroupM * n_tiles;
  const int first_m = int(blockIdx.x) / per_group * kGroupM;
  const int group_rows = min(m_tiles - first_m, kGroupM);
  const int in_group = int(blockIdx.x) % per_group;
  m0 = (first_m + in_group % group_rows) * BM;
  n0 = in_group / group_rows * BN;
}

// Launch `kernel` over the BM x BN tiles of p (times its splits), with its
// dynamic shared memory opted in; `args` follow p.
template <class C, class... Args>
cudaError_t launch_tiles(void (*kernel)(Params, Args...), const Params& p, cudaStream_t stream,
                         Args... args) {
  static std::atomic<bool> opted_in[mma_tiles::kMaxDevices];
  cudaError_t err = mma_tiles::opt_in_shared_memory(
      reinterpret_cast<const void*>(kernel), C::kSmem, opted_in);
  if (err != cudaSuccess) return err;
  const long long m_tiles = (p.m + C::kBM - 1) / C::kBM;
  const long long n_tiles = (p.n + C::kBN - 1) / C::kBN;
  // The rasterisation indexes up to a whole last group of kGroupM tiles.
  if ((m_tiles + kGroupM) * n_tiles > INT_MAX || p.splits > 65535) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(unsigned(m_tiles * n_tiles), unsigned(p.splits));
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(p, args...);
  return cudaGetLastError();
}

// Decode: one 16-row atom by 128 columns, 4 warps of 32 columns each; K
// walked 64 deep through a ring of 6 stages; three blocks per SM (the
// fastest of the configurations tried on an H100: PERF.md).
struct Small {
  static constexpr int kThreads = 128;
  static constexpr int kMinBlocks = 3;        // resident per SM
  static constexpr int kBM = 16;
  static constexpr int kBN = kGroupCols * kThreads / 32;
  static constexpr int kBK = 64;
  static constexpr int kStages = 6;
  static constexpr int kXStride = kBK + 8;    // bf16 per staged x row
  static constexpr int kQStride = kBN + 16;   // bytes per staged q row
  static constexpr int kXBytes = kBM * kXStride * 2;
  static constexpr int kStageBytes = kXBytes + kBK * kQStride;
  static constexpr int kSmem = kStages * kStageBytes;
};

// Copy one K step of x [kBM, kBK] and q [kBK, kBN] into a stage (x rows
// kXStride bf16 apart, then q rows kQStride bytes apart); rows past M,
// depth past k_end and columns past N are zero-filled, never read.
__device__ __forceinline__ void load_stage(const Params& p, uint8_t* stage, int tid, int m0,
                                           int n0, int k0, int k_end) {
  using C = Small;
  const bf16* x = static_cast<const bf16*>(p.x);
  bf16* xs = reinterpret_cast<bf16*>(stage);
  uint8_t* qs = stage + C::kXBytes;
  constexpr int kXRow = C::kBK / 8;  // 16-byte chunks in a row of x
#pragma unroll
  for (int c = tid; c < C::kBM * kXRow; c += C::kThreads) {
    const int r = c / kXRow;
    const int kc = (c % kXRow) * 8;
    const bool live = m0 + r < p.m && k0 + kc < k_end;
    mma_tiles::cp_async16(xs + r * C::kXStride + kc,
                          live ? x + size_t(m0 + r) * p.k + k0 + kc : x, live);
  }
  constexpr int kQRow = C::kBN / 16;
#pragma unroll
  for (int c = tid; c < C::kBK * kQRow; c += C::kThreads) {
    const int r = c / kQRow;
    const int nc = (c % kQRow) * 16;
    const bool live = k0 + r < k_end && n0 + nc < p.n;
    mma_tiles::cp_async16(qs + r * C::kQStride + nc,
                          live ? p.q + size_t(k0 + r) * p.n + n0 + nc : p.q, live);
  }
}

__global__ void __launch_bounds__(Small::kThreads, Small::kMinBlocks)
int8_matmul_mma_kernel(const Params p) {
  using C = Small;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;  // owns columns warp * 32 .. + 31 of the tile
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  int m0, n0;
  tile_origin<C::kBM, C::kBN>(p, m0, n0);
  const int k_begin = blockIdx.y * p.k_per_split;
  const int k_end = min(p.k, k_begin + p.k_per_split);
  const int steps = k_end > k_begin ? (k_end - k_begin + C::kBK - 1) / C::kBK : 0;

  float acc[4][4];  // n8 atom j's accumulator fragment
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < steps) {
      load_stage(p, smem + s * C::kStageBytes, tid, m0, n0, k_begin + s * C::kBK, k_end);
    }
    mma_tiles::cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    mma_tiles::cp_async_wait<C::kStages - 2>();  // this step's tile has landed
    __syncthreads();  // ... for every thread, and the oldest stage is free
    const int next = step + C::kStages - 1;
    if (next < steps) {
      load_stage(p, smem + (next % C::kStages) * C::kStageBytes, tid, m0, n0,
                 k_begin + next * C::kBK, k_end);
    }
    mma_tiles::cp_async_commit();
    const uint8_t* stage = smem + (step % C::kStages) * C::kStageBytes;
    const bf16* xs = reinterpret_cast<const bf16*>(stage);
    const uint8_t* qs = stage + C::kXBytes + warp * kGroupCols + 4 * g;
#pragma unroll
    for (int kk = 0; kk < C::kBK / 16; ++kk) {
      uint32_t a[4];
      mma_tiles::ldmatrix_x4(a, xs + (lane & 15) * C::kXStride + 16 * kk + (lane >> 4) * 8);
      const uint8_t* rows = qs + (16 * kk + 2 * t) * C::kQStride;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(rows);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(rows + C::kQStride);
      const uint32_t w8 = *reinterpret_cast<const uint32_t*>(rows + 8 * C::kQStride);
      const uint32_t w9 = *reinterpret_cast<const uint32_t*>(rows + 9 * C::kQStride);
      uint32_t b[4][2];
      b[0][0] = mma_tiles::int8_pair_to_bf16x2<0>(w0, w1);
      b[0][1] = mma_tiles::int8_pair_to_bf16x2<0>(w8, w9);
      b[1][0] = mma_tiles::int8_pair_to_bf16x2<1>(w0, w1);
      b[1][1] = mma_tiles::int8_pair_to_bf16x2<1>(w8, w9);
      b[2][0] = mma_tiles::int8_pair_to_bf16x2<2>(w0, w1);
      b[2][1] = mma_tiles::int8_pair_to_bf16x2<2>(w8, w9);
      b[3][0] = mma_tiles::int8_pair_to_bf16x2<3>(w0, w1);
      b[3][1] = mma_tiles::int8_pair_to_bf16x2<3>(w8, w9);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tiles::mma_bf16_16816(acc[j], a, b[j][0], b[j][1]);
    }
  }
  mma_tiles::cp_async_wait<0>();

  // Atom j, accumulator column 2t (+1) is output column 8t + j (+4) of the
  // warp's columns: lane t holds the 8 adjacent columns n..n+7 of rows g
  // and g + 8.
  const int n = n0 + warp * kGroupCols + 8 * t;
  if (n >= p.n) return;  // N % 16 == 0: 8 columns are all in or all out
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + g + 8 * h;
    if (m >= p.m) continue;
    float v[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = acc[j][2 * h];
      v[4 + j] = acc[j][2 * h + 1];
    }
    if (p.partial != nullptr) {
      float* dst = p.partial + (size_t(blockIdx.y) * p.m + m) * p.n + n;
      store4(dst, v);
      store4(dst + 4, v + 4);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] *= p.scale[n + j];
      uint4 packed;
      packed.x = mma_tiles::pack_bf16(v[0], v[1]);
      packed.y = mma_tiles::pack_bf16(v[2], v[3]);
      packed.z = mma_tiles::pack_bf16(v[4], v[5]);
      packed.w = mma_tiles::pack_bf16(v[6], v[7]);
      *reinterpret_cast<uint4*>(static_cast<bf16*>(p.out) + size_t(m) * p.n + n) = packed;
    }
  }
}

}  // namespace tc

// ------------------------------------------------------------ wgmma
// The large-M tiles: two warpgroups, each an m64n128 wgmma accumulator,
// with A (x) from registers (ldmatrix, as for mma.sync) and B (the codes,
// widened to bf16 once per block and step) from shared memory. TMA copies
// x and the codes into a ring of stages, each completing on an mbarrier;
// TMA also zero-fills rows past M, depth past K and columns past N.
namespace wg {

// d += A (64 x 16 bf16: each warp's 16 rows in registers, the mma.sync A
// fragment) * B (16 x 128 bf16, MN-major in shared memory), fp32 accumulators.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(mma_tiles::smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
          mma_tiles::smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(mma_tiles::smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(mma_tiles::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(mma_tiles::smem_addr(bar))
      : "memory");
}

// Prefill and embed: two warpgroups of 64 rows by 128 columns; K walked
// 64 deep (one 128-byte swizzle row of x) through a ring of 3 TMA stages;
// two blocks per SM (the fastest of the configurations tried on an H100:
// PERF.md).
struct Large {
  static constexpr int kThreads = 256;
  static constexpr int kMinBlocks = 2;         // resident per SM
  static constexpr int kBM = 64 * kThreads / 128;
  static constexpr int kBN = 128;
  static constexpr int kBK = 64;
  static constexpr int kStages = 3;
  static constexpr int kXBytes = kBM * kBK * 2;   // 128-byte rows, 128-byte swizzle
  static constexpr int kQBytes = kBK * kBN;       // 128-byte rows, 128-byte swizzle
  static constexpr int kStageBytes = kXBytes + kQBytes;
  static constexpr int kBBytes = kBK * kBN * 2;
  // 1024 bytes to align the ring to the swizzle atom, the mbarriers last.
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kBBytes + 8 * kStages;
  // B in the no-swizzle MN-major layout of wgmma: 8 x 8 core matrices of
  // 128 contiguous bytes (8 K rows of 8 N values).
  static constexpr int kCoreN = 128;
  static constexpr int kCoreK = kBN / 8 * 128;
};

// The wgmma descriptor of a B tile at p: no swizzle, K-adjacent core
// matrices kCoreK bytes apart (LBO), N-adjacent ones kCoreN (SBO).
__device__ __forceinline__ uint64_t b_descriptor(const void* p) {
  const uint64_t addr = mma_tiles::smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(Large::kCoreK >> 4) << 16) |
         (uint64_t(Large::kCoreN >> 4) << 32);  // layout type 0: no swizzle
}

// Widen one stage's codes (kBK rows of 128 bytes as TMA left them, the
// 16-byte chunk c of row k at chunk c ^ (k & 7)) into a B tile: each
// thread takes 16-byte chunks (16 codes of one K row); the 8 lanes of a
// shared-memory phase read 8 consecutive K rows of one column chunk (the
// swizzle spreads them over all banks) and write the same row of one core
// matrix each, 128 contiguous bytes: no bank conflict.
__device__ __forceinline__ void widen_stage(const uint8_t* qs, uint8_t* bs, int tid) {
  using C = Large;
#pragma unroll
  for (int u = tid; u < C::kBK * C::kBN / 16; u += C::kThreads) {
    const int r = u & 7;
    const int c16 = (u >> 3) & (C::kBN / 16 - 1);
    const int kg = u / (8 * C::kBN / 16);
    const uint4 raw =
        *reinterpret_cast<const uint4*>(qs + (8 * kg + r) * C::kBN + 16 * (c16 ^ r));
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t v[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = mma_tiles::int8_bytes_to_bf16x2<0x1100>(w[i], w[i]);
      v[2 * i + 1] = mma_tiles::int8_bytes_to_bf16x2<0x3322>(w[i], w[i]);
    }
    uint8_t* core = bs + kg * C::kCoreK + 2 * c16 * C::kCoreN + 16 * r;
    *reinterpret_cast<uint4*>(core) = make_uint4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<uint4*>(core + C::kCoreN) = make_uint4(v[4], v[5], v[6], v[7]);
  }
}

__global__ void __launch_bounds__(Large::kThreads, Large::kMinBlocks)
int8_matmul_tma_kernel(const Params p, const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_q) {
  using C = Large;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* bs = smem + C::kStages * C::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + 2 * C::kBBytes);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = 16 * warp;

  int m0, n0;
  tc::tile_origin<C::kBM, C::kBN>(p, m0, n0);
  const int k_begin = blockIdx.y * p.k_per_split;
  const int k_end = min(p.k, k_begin + p.k_per_split);
  const int steps = k_end > k_begin ? (k_end - k_begin + C::kBK - 1) / C::kBK : 0;

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto refill = [&](int j) {
    uint8_t* stage = smem + (j % C::kStages) * C::kStageBytes;
    uint64_t* bar = &full[j % C::kStages];
    mbar_expect_tx(bar, C::kStageBytes);
    tma_load_2d(stage, &map_x, k_begin + j * C::kBK, m0, bar);
    tma_load_2d(stage + C::kXBytes, &map_q, n0, k_begin + j * C::kBK, bar);
  };
  // Steps 0..kStages-1 in flight, step 0 widened into B tile 0.
  if (tid == 0) {
    for (int j = 0; j < C::kStages && j < steps; ++j) refill(j);
  }
  float acc[64];  // this thread's share of its warpgroup's m64n128 accumulator
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  if (steps > 0) {
    mbar_wait(&full[0], 0);
    widen_stage(smem + C::kXBytes, bs, tid);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // B visible to wgmma
  __syncthreads();

  // Each step issues its wgmmas on B tile step & 1 and, while they run,
  // widens the next stage into the other B tile; the stage it frees is
  // refilled by TMA.
  for (int step = 0; step < steps; ++step) {
    // This warpgroup's last wgmmas are done: A registers and B tile
    // (step + 1) & 1 are free for it.
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    const uint8_t* xs = smem + (step % C::kStages) * C::kStageBytes;
    uint32_t a[C::kBK / 16][4];
    const int row = row0 + (lane & 15);  // x rows are 128 bytes, 128-byte swizzle
#pragma unroll
    for (int kk = 0; kk < C::kBK / 16; ++kk) {
      const int chunk = 2 * kk + (lane >> 4);
      mma_tiles::ldmatrix_x4(a[kk], xs + row * 128 + 16 * (chunk ^ (row & 7)));
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint8_t* b_tile = bs + (step & 1) * C::kBBytes;
#pragma unroll
    for (int kk = 0; kk < C::kBK / 16; ++kk) {
      wgmma_m64n128k16(acc, a[kk], b_descriptor(b_tile + 2 * kk * C::kCoreK));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    const int next = step + 1;
    if (next < steps) mbar_wait(&full[next % C::kStages], (next / C::kStages) & 1);
    // Every warpgroup is past its wait and its ldmatrix: B tile next & 1
    // and this step's stage (its codes were widened last step) are free.
    __syncthreads();
    if (tid == 0 && step + C::kStages < steps) refill(step + C::kStages);
    if (next < steps) {
      widen_stage(smem + (next % C::kStages) * C::kStageBytes + C::kXBytes,
                  bs + (next & 1) * C::kBBytes, tid);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // B visible to wgmma
    }
    __syncthreads();  // B tile next & 1 is complete
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + row0 + g + 8 * h;
    if (m >= p.m) continue;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int n = n0 + 8 * i + 2 * t;
      if (n >= p.n) continue;
      const float v0 = acc[4 * i + 2 * h];
      const float v1 = acc[4 * i + 2 * h + 1];
      if (p.partial != nullptr) {
        *reinterpret_cast<float2*>(p.partial + (size_t(blockIdx.y) * p.m + m) * p.n + n) =
            make_float2(v0, v1);
      } else {
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.out) + size_t(m) * p.n + n) =
            mma_tiles::pack_bf16(v0 * p.scale[n], v1 * p.scale[n + 1]);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// library links to no libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Encode x's and q's tensor maps (128-byte swizzle, zero fill out of
// bounds) and launch the tiles.
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult status;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &status);
    if (err != cudaSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  CUtensorMap map_x, map_q;
  const cuuint64_t x_dims[2] = {cuuint64_t(p.k), cuuint64_t(p.m)};
  const cuuint64_t x_strides[1] = {cuuint64_t(p.k) * 2};
  const cuuint32_t x_box[2] = {Large::kBK, Large::kBM};
  const cuuint64_t q_dims[2] = {cuuint64_t(p.n), cuuint64_t(p.k)};
  const cuuint64_t q_strides[1] = {cuuint64_t(p.n)};
  const cuuint32_t q_box[2] = {128, 64};
  const cuuint32_t ones[2] = {1, 1};
  if (encode(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p.x), x_dims,
             x_strides, x_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
          CUDA_SUCCESS ||
      encode(&map_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(p.q), q_dims,
             q_strides, q_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
          CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  return tc::launch_tiles<Large>(int8_matmul_tma_kernel, p, stream, map_x, map_q);
}

}  // namespace wg

template <int TM>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int kBM = kRowGroups * TM;
  const dim3 grid((p.n + kBN - 1) / kBN, (p.m + kBM - 1) / kBM, p.splits);
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidValue;
  int8_matmul_kernel<TM><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// The second pass of a split launch: add the splits in order, scale, round.
template <typename T>
cudaError_t launch_reduce(const Params& p, cudaStream_t stream) {
  const size_t quads = size_t(p.m) * p.n / 4;
  const unsigned blocks = unsigned(
      (quads + kThreads - 1) / kThreads < 4096 ? (quads + kThreads - 1) / kThreads
                                               : 4096);
  reduce_splits_kernel<T><<<blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_rows(const Params& p, int block_rows, cudaStream_t stream) {
  if (block_rows == kRowGroups) return launch<1>(p, stream);
  if (block_rows == 4 * kRowGroups) return launch<4>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out share it). q is int8 [K, N],
// scale fp32 [N]. route: 0 = CUDA cores (fp32; block_rows 16 or 64,
// k_per_split a multiple of 32), 1 = tensor cores (bf16; block_rows 16,
// mma.sync, or 128, wgmma and TMA; k_per_split a multiple of 64). With
// splits > 1, partial must hold splits * M * N floats; k_per_split *
// splits must cover K and every split must have work. On route 1 a
// partial buffer with splits == 1 receives the unscaled fp32 sums, and
// out is not written (the accumulation measurement). K and N must be
// multiples of 16 and every pointer 16-byte aligned. Returns a
// cudaError_t: 0 on a successful launch, cudaErrorInvalidValue for
// arguments the route does not take. Asynchronous on `stream`; nothing is
// allocated.
int distllm_qmm_launch(const void* x, const void* q, const void* scale,
                       void* out, void* partial, int m, int k, int n,
                       int block_rows, int splits, int k_per_split, int dtype,
                       int route, void* stream) {
  int step = 0;
  if (route == 0) step = kBK;
  if (route == 1 && block_rows == tc::Small::kBM) step = tc::Small::kBK;
  if (route == 1 && block_rows == wg::Large::kBM) step = wg::Large::kBK;
  if (step == 0 || (route == 0 && dtype != 0) || (route == 1 && dtype != 1) ||
      (route == 0 && splits == 1 && partial) ||
      m < 1 || k < 16 || n < 16 || k % 16 != 0 || n % 16 != 0 || splits < 1 ||
      k_per_split < step || k_per_split % step != 0 ||
      (long long)k_per_split * splits < k ||
      (long long)k_per_split * (splits - 1) >= k ||
      (splits > 1 && partial == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  Params p;
  p.x = x;
  p.q = static_cast<const int8_t*>(q);
  p.scale = static_cast<const float*>(scale);
  p.out = out;
  p.partial = static_cast<float*>(partial);
  p.m = m;
  p.k = k;
  p.n = n;
  p.k_per_split = k_per_split;
  p.splits = splits;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      route == 0 ? launch_rows(p, block_rows, s)
      : block_rows == tc::Small::kBM
          ? tc::launch_tiles<tc::Small>(tc::int8_matmul_mma_kernel, p, s)
          : wg::launch(p, s);
  if (err != cudaSuccess || splits == 1) return int(err);
  if (route == 0) return int(launch_reduce<float>(p, s));
  return int(launch_reduce<__nv_bfloat16>(p, s));
}

const char* distllm_qmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
