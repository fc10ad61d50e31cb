// Encoder attention for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces: distllm_tpu/ops/encoder_attention.py encoder_attention (line
// 151; kernel body _kernel, line 109) — the attention of every BERT-family
// embed forward (and later ESM-2, ESM-C and ModernBERT).
//
// What it computes: bidirectional multi-head attention with the heads packed
// in the last dimension, q, k, v and out all [B, S, N*Hd]. For each (row b,
// head h, query i):
//   s_j = (q_i . k_j) * scale + (mask[b, j] ? 0 : -1e9) + bias[i, j]
//   p_j = exp(s_j - max s) / sum exp(s - max s)     (fp32)
//   out = sum_j T(p_j) * v_j                         (fp32 sum, T = v's type)
// with the key bias a FINITE -1e9, as on the TPU: a fully masked row (a
// batch-padding row) gets equal scores and comes out as the uniform average
// of V, finite, never 0/0. The optional bias is an fp32 [S, S] term shared
// by every row and head, added to the key bias before the scores (the TPU
// kernel's order).
//
// What bounds it on an H100 SXM: 4 * S * Hd flops per (query, head) against
// 8 * Hd bytes of q/k/v/out per (token, head) in bf16 — at S = 256 that is
// about 128 flops per byte, under the ~295 flop/byte ridge, so the least
// time is set by bytes (q, k, v, out once over 3.35 TB/s). Both routes stay
// well above that. On route 1 a cycle-counter trace of its steps
// (scripts/profile_torch_kernel_phases.py) puts about a quarter in issuing
// and awaiting the tile copies and the rest in the products (Q K^T twice,
// P V once) and the exponentials (two per score), at four blocks of four
// warps per SM.
//
// Shared by both routes:
// - The TPU kernel holds one row's whole [S, S] fp32 score tile in VMEM
//   and loops the heads inside one grid step. On Hopper a block has at most
//   227 KB of shared memory (one head's tile at S = 288 is 332 KB), so here
//   one thread block per (64-query tile, head, batch row) walks the keys in
//   tiles of 64 staged in shared memory, read straight from the packed
//   [B, S, N*Hd] layout with row stride N*Hd — no transpose is ever
//   materialised.
// - Two passes over the keys. Pass 1 keeps each query's running max and
//   sum (online, fp32). Pass 2 recomputes the scores, forms the NORMALISED
//   p, rounds it to T and accumulates p @ V in fp32 — so p is rounded after
//   the division, exactly where the TPU kernel rounds it (:139-144). One
//   pass with the division at the end would round the unnormalised p
//   instead, a second, independent bf16 error per key.
// - Keys past S are excluded (-inf, never staged); every masked key is
//   present with its -1e9, as the TPU computes it. Queries past S are
//   computed from zero rows and never written.
//
// Route 0, CUDA cores (fp32, and head dims that are not a multiple of 16):
// - Each thread owns a 4-query x 8-key register tile of fp32 scores (keys
//   interleaved with stride 8 so the 8 lanes of a query read 8 banks) and a
//   4-query x Hd/8 tile of the output; a query's max and sum are reduced
//   over its 8 lanes with shuffles.
// - Head dims: any multiple of 8 up to 128; 32, 64 and 128 are compiled
//   with the head dim fixed, others with it read at run time. Any S >= 1.
//
// Route 1, tensor cores (bf16, head dims a multiple of 16 up to 128):
// - Four warps of 16 queries each. Q K^T and P V are bf16 mma.m16n8k16
//   with fp32 accumulators, operands by ldmatrix (.trans for V); Q's
//   fragments stay in registers for both passes. Scores are kept as
//   t = s * log2(e) with the key bias folded in (one fma), so each p is
//   one ex2: pass 2's normalised p is 2^(t - max) * (1 / sum).
// - K (pass 1) and K, V (pass 2) tiles are staged by cp.async into a ring
//   of two, one step ahead: the next tile is issued right after this one's
//   Q K^T products and loads while this one computes, across the seam of
//   the two passes too. Keys past S are zero-filled.
//   The row's key bias is formed in shared memory once per block.
// - The two-pass choice holds here as on route 0: pass 2 recomputes Q K^T
//   (1.5x the products of one pass) rather than keeping a 64 x S fp32
//   score tile in shared memory (80 KB at S = 288, half the blocks per
//   SM), so any S runs on one design.
// - 32, 64 and 128 are compiled with the head dim fixed, the other
//   multiples of 16 with it read at run time.

//
// Route 2, wgmma and TMA (bf16 at head dims 32, 64 and 128, long
// sequences or an [S, S] bias: ops/encoder_attention.kernel_route, from
// the H100's lines; csrc/hopper_attention.cuh holds the main loop it
// shares with K1's route 3):
// - a block is one producer warp and two consumer warpgroups of 64
//   queries (128 a block); the producer gives its registers to the
//   consumers (setmaxnreg). It loads Q, then K (pass 1) and K and V
//   (pass 2) tiles of 64 keys with TMA from the packed [B, S, N*Hd]
//   layout through a 3-D tensor map, so keys past S arrive as zeros from
//   the copy's out-of-bounds fill; each ring six deep (four at 128).
// - the two passes stay: p is rounded after normalisation, as on the TPU.
//   Q K^T and P V are wgmma (Q and K K-major, V MN-major, 128-byte
//   swizzle, 64-byte at head dim 32), P the register A operand. Pass 1
//   issues tile o + 1's Q K^T before tile o's exponentials; pass 2 issues
//   the next tile's Q K^T and the previous tile's P V together and runs
//   both under this tile's exponentials (two score buffers).
// - key tiles are walked from the block's diagonal tile round, so a row's
//   running max is set by its own key first. In pass 1 a warp whose 16
//   rows all see a tile's scores 140 or more below their running max
//   skips its exponentials: every one would be exactly 0 (ex2.approx.ftz
//   flushes below 2^-126), and the max and sum do not move. Pass 2 skips
//   the tiles every warp skipped (their p are 0 against the final max too;
//   the first two are loaded before the verdict and always computed):
//   under ModernBERT's window bias most of a long row's tiles, with the
//   output bitwise unchanged. A fully masked row sees no such tile and
//   stays the uniform average.
// - what bounds it: two ex2 per score (about 0.69 ms for ESM-2's batch at
//   the SFU's rate) beside 1.5x the products; a cycle-counter split of
//   its phases: scripts/profile_torch_kernel_phases.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_attention.cuh"
#include "mma_tiles.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;     // queries per block
constexpr int kBK = 64;     // keys per staged tile
constexpr int kRowsPT = 4;  // queries per thread
constexpr int kColsPT = 8;  // keys per thread (interleaved, stride 8)
constexpr float kNegBig = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;      // [B, S, N*Hd]
  const void* k;
  const void* v;
  const int* mask;    // [B, S], nonzero = valid key
  const float* bias;  // [S, S] or null
  void* out;          // [B, S, N*Hd]
  int seq;
  int num_heads;
  int head_dim;
  float scale;
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and widened back: the TPU kernel's p.astype(v.dtype).
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// 16 bytes of T from device memory, widened to fp32.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kElems = 4;
  __device__ __forceinline__ static void load(const float* src, float* dst) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* src,
                                              float* dst) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(pairs[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
};

// Max / sum over the 8 lanes that share a query (lane bits 0..2).
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 1; o < kColsPT; o <<= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < kColsPT; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int head_dim) {
  return sizeof(float) *
         (size_t(kBQ) * (head_dim + 1)    // query tile (padded rows)
          + size_t(kBK) * (head_dim + 1)  // staged K (padded rows)
          + size_t(kBK) * head_dim        // staged V
          + size_t(kBQ) * (kBK + 1)       // normalised p of the tile
          + size_t(kBK));                 // key-mask bias of the tile
}

// Rows [rows) of a [*, S, D] tensor, head h, starting at row r0, into
// shared memory as fp32 with row stride `stride`; rows past S are zeros.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* src, float* dst, int r0,
                                           int rows, int seq, int dim,
                                           int col0, int hd, int stride,
                                           int tid) {
  using V = Vec16<T>;
  constexpr int kVec = V::kElems;
  const int per_row = hd / kVec;
  for (int i = tid; i < rows * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i % per_row) * kVec;
    float vals[kVec];
    if (r0 + r < seq) {
      V::load(src + size_t(r0 + r) * dim + col0 + c, vals);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[r * stride + c + e] = vals[e];
  }
}

template <typename T, int HD, bool kExact>
__global__ void __launch_bounds__(kThreads)
    encoder_attention_kernel(const Params p) {
  constexpr int kMaxCols = HD / kColsPT;  // output columns per thread
  const int hd = kExact ? HD : p.head_dim;
  const int stride = hd + 1;  // q / k row stride: conflict-free dots
  const int ncols = hd / kColsPT;
  const int seq = p.seq;
  const int dim = p.num_heads * hd;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int tc = lane % kColsPT;                        // key lane
  const int tr = (tid / 32) * 4 + lane / kColsPT;       // query group 0..15

  extern __shared__ float smem[];
  float* s_q = smem;                      // [kBQ][hd + 1]
  float* s_k = s_q + kBQ * stride;        // [kBK][hd + 1]
  float* s_v = s_k + kBK * stride;        // [kBK][hd]
  float* s_p = s_v + kBK * hd;            // [kBQ][kBK + 1]
  float* s_kb = s_p + kBQ * (kBK + 1);    // [kBK]

  const T* q = static_cast<const T*>(p.q) + size_t(b) * seq * dim;
  const T* k = static_cast<const T*>(p.k) + size_t(b) * seq * dim;
  const T* v = static_cast<const T*>(p.v) + size_t(b) * seq * dim;
  const int* mask = p.mask + size_t(b) * seq;
  const int col0 = h * hd;

  stage_rows<T>(q, s_q, q0, kBQ, seq, dim, col0, hd, stride, tid);

  // Scores of this thread's 4 x 8 tile against the staged key tile at t0:
  // fp32 dot, then scale and the (key mask + [S, S]) bias, unfused and in
  // the TPU kernel's order. Keys past S are -inf (absent).
  float sc[kRowsPT][kColsPT];
  auto scores = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i) {
#pragma unroll
      for (int j = 0; j < kColsPT; ++j) sc[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qv[kRowsPT];
      float kv[kColsPT];
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i) qv[i] = s_q[(tr * kRowsPT + i) * stride + d];
#pragma unroll
      for (int j = 0; j < kColsPT; ++j) kv[j] = s_k[(tc + kColsPT * j) * stride + d];
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i) {
#pragma unroll
        for (int j = 0; j < kColsPT; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i) {
      const int qi = min(q0 + tr * kRowsPT + i, seq - 1);
#pragma unroll
      for (int j = 0; j < kColsPT; ++j) {
        const int jt = tc + kColsPT * j;
        const int key = t0 + jt;
        if (key < seq) {
          float kb = s_kb[jt];
          if (p.bias != nullptr) kb = __fadd_rn(kb, p.bias[size_t(qi) * seq + key]);
          sc[i][j] = __fadd_rn(__fmul_rn(sc[i][j], p.scale), kb);
        } else {
          sc[i][j] = -INFINITY;
        }
      }
    }
  };

  auto stage_keys = [&](int t0, bool with_v) {
    stage_rows<T>(k, s_k, t0, kBK, seq, dim, col0, hd, stride, tid);
    if (with_v) stage_rows<T>(v, s_v, t0, kBK, seq, dim, col0, hd, hd, tid);
    for (int j = tid; j < kBK; j += kThreads) {
      const int key = t0 + j;
      s_kb[j] = (key < seq && mask[key] == 0) ? kNegBig : 0.f;
    }
  };

  // Pass 1: each query's max and softmax denominator (online, fp32). Key
  // tile 0 always holds key 0, so m is finite from the first tile on.
  float m[kRowsPT];
  float l[kRowsPT];
#pragma unroll
  for (int i = 0; i < kRowsPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int t0 = 0; t0 < seq; t0 += kBK) {
    stage_keys(t0, false);
    __syncthreads();
    scores(t0);
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i) {
      float mx = sc[i][0];
#pragma unroll
      for (int j = 1; j < kColsPT; ++j) mx = fmaxf(mx, sc[i][j]);
      const float m_new = fmaxf(m[i], group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPT; ++j) sum += expf(sc[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + group_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();
  }

  // Pass 2: normalised p, rounded to T, then out += p @ V in fp32.
  float acc[kRowsPT][kMaxCols];
#pragma unroll
  for (int i = 0; i < kRowsPT; ++i) {
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[i][c] = 0.f;
  }
  for (int t0 = 0; t0 < seq; t0 += kBK) {
    stage_keys(t0, true);
    __syncthreads();
    scores(t0);
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i) {
#pragma unroll
      for (int j = 0; j < kColsPT; ++j) {
        const float prob = expf(sc[i][j] - m[i]) / l[i];
        s_p[(tr * kRowsPT + i) * (kBK + 1) + tc + kColsPT * j] = round_to<T>(prob);
      }
    }
    __syncthreads();
    const int live = min(kBK, seq - t0);
    for (int j = 0; j < live; ++j) {
      float pv[kRowsPT];
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i) pv[i] = s_p[(tr * kRowsPT + i) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        if (c < ncols) {
          const float vv = s_v[j * hd + tc + kColsPT * c];
#pragma unroll
          for (int i = 0; i < kRowsPT; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
    __syncthreads();
  }

  T* out = static_cast<T*>(p.out) + size_t(b) * seq * dim;
#pragma unroll
  for (int i = 0; i < kRowsPT; ++i) {
    const int qi = q0 + tr * kRowsPT + i;
    if (qi >= seq) continue;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c < ncols) {
        out[size_t(qi) * dim + col0 + tc + kColsPT * c] = from_float<T>(acc[i][c]);
      }
    }
  }
}

// ------------------------------------------------- route 1, tensor cores
size_t tc_smem_bytes(int head_dim, int seq) {
  // Q tile and a ring of two K and two V tiles (rows padded by 16 bytes so
  // the 8 row addresses of an ldmatrix fall in 8 distinct bank groups),
  // and the key bias of the row's keys, padded to whole tiles.
  return sizeof(__nv_bfloat16) * size_t(head_dim + 8) * (kBQ + 4 * kBK) +
         sizeof(float) * size_t((seq + kBK - 1) / kBK * kBK);
}

template <int HD, bool kExact>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 4 : 2)
    encoder_attention_mma_kernel(const Params p) {
  using namespace mma_tiles;
  using bf16 = __nv_bfloat16;
  constexpr int kStride = HD + 8;   // staged row, bf16 elements
  constexpr int kSteps = HD / 16;   // k-steps of Q K^T (at most)
  constexpr int kOut = HD / 8;      // 8-column accumulator tiles of P V
  constexpr int kKeyTiles = kBK / 8;
  const int hd = kExact ? HD : p.head_dim;
  const int steps = hd / 16;
  const int chunks = hd / 8;  // 16-byte chunks of a row
  const int seq = p.seq;
  const int dim = p.num_heads * hd;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][kStride]
  bf16* s_k = s_q + kBQ * kStride;               // [2][kBK][kStride]
  bf16* s_v = s_k + 2 * kBK * kStride;           // [2][kBK][kStride]
  float* s_kb = reinterpret_cast<float*>(s_v + 2 * kBK * kStride);  // [nt * kBK]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // accumulator rows g and g + 8 of the warp
  const int t = lane % 4;  // accumulator columns 2t, 2t + 1 of each 8
  const int col0 = h * hd;

  const bf16* q = static_cast<const bf16*>(p.q) + size_t(b) * seq * dim;
  const bf16* k = static_cast<const bf16*>(p.k) + size_t(b) * seq * dim;
  const bf16* v = static_cast<const bf16*>(p.v) + size_t(b) * seq * dim;
  const int* mask = p.mask + size_t(b) * seq;

  for (int i = tid; i < kBQ * chunks; i += kThreads) {
    const int r = i / chunks;
    const int c = (i % chunks) * 8;
    const bool live = q0 + r < seq;
    cp_async16(s_q + r * kStride + c, q + (live ? size_t(q0 + r) * dim + col0 + c : 0),
               live);
  }
  cp_async_commit();

  // Step i < nt stages key tile i for pass 1 (K); step nt + i stages it
  // again for pass 2 (K and V). With the head dim fixed, each thread copies
  // one 16-byte column c of every kKeyStride-th key of the tile from key
  // j0 on, a fixed trip count; otherwise the chunks are dealt round-robin.
  const int nt = (seq + kBK - 1) / kBK;
  constexpr int kKeyStride = kThreads / (HD / 8);
  const int j0 = tid / chunks;
  const int c = (tid % chunks) * 8;
  auto stage = [&](int step) {
    const int buf = step & 1;
    const int t0 = (step % nt) * kBK;
    const bool with_v = step >= nt;
    auto copy = [&](int j, int col) {
      const bool live = t0 + j < seq;
      const size_t off = live ? size_t(t0 + j) * dim + col0 + col : 0;
      cp_async16(s_k + (buf * kBK + j) * kStride + col, k + off, live);
      if (with_v) cp_async16(s_v + (buf * kBK + j) * kStride + col, v + off, live);
    };
    if constexpr (kExact) {
#pragma unroll
      for (int it = 0; it < kBK / kKeyStride; ++it) copy(j0 + it * kKeyStride, c);
    } else {
      for (int i = tid; i < kBK * chunks; i += kThreads) copy(i / chunks, (i % chunks) * 8);
    }
  };
  stage(0);
  cp_async_commit();

  // The key bias of the row, once, while the first tiles load: 0, the
  // finite -1e9 of a masked key, or -inf past S (absent). (Read after the
  // first step's barrier.)
  for (int key = tid; key < nt * kBK; key += kThreads) {
    s_kb[key] = key >= seq ? -INFINITY : (mask[key] == 0 ? kNegBig : 0.f);
  }

  uint32_t qf[kSteps][4];
  // This lane's two queries (clamped for the bias row: queries past S are
  // computed and never written).
  int qi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qi[i] = min(q0 + 16 * warp + g + 8 * i, seq - 1);
  const float scale_log2 = p.scale * kLog2e;

  // Scores of the warp's 16 queries against the staged key tile: fp32 dot
  // on the tensor cores, then scale and the (key mask + [S, S]) bias, kept
  // as t = s * log2(e) so that each p is one ex2.
  float s[kKeyTiles][4];
  auto products = [&](int buf) {
    const bf16* kt = s_k + buf * kBK * kStride;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      if (kk >= steps) break;
#pragma unroll
      for (int jj = 0; jj < kKeyTiles / 2; ++jj) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kt + (16 * jj + (lane & 7) + ((lane >> 4) << 3)) * kStride +
                            16 * kk + ((lane >> 3) & 1) * 8);
        mma_bf16_16816(s[2 * jj], qf[kk], kb[0], kb[1]);
        mma_bf16_16816(s[2 * jj + 1], qf[kk], kb[2], kb[3]);
      }
    }
  };
  // Plus the key bias (and the [S, S] bias), scaled by log2(e).
  auto add_bias = [&](int t0) {
    if (p.bias == nullptr) {
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        const float2 kb = *reinterpret_cast<const float2*>(s_kb + t0 + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = fmaf(s[j][e], scale_log2, ((e & 1) ? kb.y : kb.x) * kLog2e);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t0 + 8 * j + 2 * t + (e & 1);
          float bias = s_kb[key];
          if (key < seq) bias += p.bias[size_t(qi[e >> 1]) * seq + key];
          s[j][e] = fmaf(s[j][e], scale_log2, bias * kLog2e);
        }
      }
    }
  };

  float o[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // Pass 1 state: the row max (log2 domain) and this lane's share of the
  // row sum. Key tile 0 always holds key 0, so m is finite from the first
  // tile on. (m is not folded into log2(sum): at a fully masked row's
  // -1e9 * log2(e) an fp32 step is 128.)
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float inv_l[2];

  for (int step = 0; step < 2 * nt; ++step) {
    const int buf = step & 1;
    const int t0 = (step % nt) * kBK;
    cp_async_wait<0>();  // the query tile and this step's tile have landed
    __syncthreads();
    if (step == 0) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        if (kk < steps) {
          ldmatrix_x4(qf[kk], s_q + (16 * warp + (lane & 15)) * kStride + 16 * kk +
                                  (lane >> 4) * 8);
        }
      }
    }
    products(buf);
    // The next step's tile is staged while these products run: its buffer
    // was last read before the previous step's closing barrier.
    if (step + 1 < 2 * nt) stage(step + 1);
    cp_async_commit();
    add_bias(t0);
    if (step < nt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
        const float m_new = fmaxf(m[i], quad_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j) {
          sum += exp2_approx(s[j][2 * i] - m_new) + exp2_approx(s[j][2 * i + 1] - m_new);
        }
        l[i] = l[i] * exp2_approx(m[i] - m_new) + sum;
        m[i] = m_new;
        if (step == nt - 1) inv_l[i] = 1.f / quad_sum(l[i]);
      }
    } else {
      // Pass 2: the normalised p, rounded to bf16 as the A operand of P V
      // (B[key][d] = V[key][d] by ldmatrix.trans, two 8-column tiles each).
      const bf16* vt = s_v + buf * kBK * kStride;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const int j0 = 2 * kk;
        const int j1 = 2 * kk + 1;
        const uint32_t a[4] = {
            pack_bf16(exp2_approx(s[j0][0] - m[0]) * inv_l[0], exp2_approx(s[j0][1] - m[0]) * inv_l[0]),
            pack_bf16(exp2_approx(s[j0][2] - m[1]) * inv_l[1], exp2_approx(s[j0][3] - m[1]) * inv_l[1]),
            pack_bf16(exp2_approx(s[j1][0] - m[0]) * inv_l[0], exp2_approx(s[j1][1] - m[0]) * inv_l[0]),
            pack_bf16(exp2_approx(s[j1][2] - m[1]) * inv_l[1], exp2_approx(s[j1][3] - m[1]) * inv_l[1]),
        };
#pragma unroll
        for (int nn = 0; nn < kOut / 2; ++nn) {
          if (2 * nn >= hd / 8) break;
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vt + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride +
                                    16 * nn + (lane >> 4) * 8);
          mma_bf16_16816(o[2 * nn], a, vb[0], vb[1]);
          mma_bf16_16816(o[2 * nn + 1], a, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // this step's buffer is free for step + 2
  }

  bf16* out = static_cast<bf16*>(p.out) + size_t(b) * seq * dim;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 16 * warp + g + 8 * i;
    if (row >= seq) continue;
    bf16* dst = out + size_t(row) * dim + col0 + 2 * t;
#pragma unroll
    for (int n = 0; n < kOut; ++n) {
      if (n >= hd / 8) break;
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * i], o[n][2 * i + 1]);
    }
  }
}

// ------------------------------------------ route 2, wgmma + TMA (Hopper)
namespace wg {
using namespace hopper_attn;
using namespace mma_tiles;
using bf16 = __nv_bfloat16;

constexpr int kRows = 128;      // queries of a block: two consumer warpgroups of 64
constexpr int kMaskTiles = 64;  // key tiles the skip masks cover
// Pass 2's first kSpec tiles are loaded before the block's verdict and
// computed whatever it says (a dead tile adds exact zeros).
constexpr int kSpec = 2;
constexpr int kConsumerWarps = kConsumerThreads / 32;
// A score this far below its row's running max has p = 2^(t - m) below
// 2^-140: ex2.approx.ftz flushes it to exactly 0.
constexpr float kDeadGap = 140.f;

// Keys of a staged tile: 64 (two score buffers and P take 80 registers a
// thread beside O).
__host__ __device__ constexpr int tile_keys(int) { return 64; }

template <int HD>
struct Cfg {
  static constexpr int kKeys = tile_keys(HD);
  static constexpr int kCW = HD < 64 ? HD : 64;  // columns of a box, one swizzled row
  static constexpr int kSwz = 2 * kCW;           // 128-byte swizzle (64-byte at HD 32)
  static constexpr int kChunks = HD / kCW;
  static constexpr int kQBytes = kRows * HD * 2;
  static constexpr int kTileBytes = kKeys * HD * 2;
};

// Each ring (K tiles of both passes, V tiles of pass 2) is six tiles deep,
// four at head dim 128: a step is short, so the copies need several steps
// in flight to hide their latency.
__host__ __device__ constexpr int stages(int head_dim) { return head_dim <= 64 ? 6 : 4; }

size_t smem_bytes(int head_dim, int seq) {
  const int kKeys = tile_keys(head_dim);
  const size_t nt = (seq + kKeys - 1) / kKeys;
  const int kStages = stages(head_dim);
  return 1024 + size_t(kRows) * head_dim * 2 + size_t(2 * kStages) * kKeys * head_dim * 2 +
         sizeof(float) * nt * kKeys + sizeof(uint64_t) * (4 * kStages + 2) +
         sizeof(uint64_t) * (kConsumerWarps + 1);
}

template <int HD>
__global__ void __launch_bounds__(kBlockThreads, 1)
    encoder_attention_wgmma_kernel(const Params p, const __grid_constant__ CUtensorMap map_q,
                                   const __grid_constant__ CUtensorMap map_k,
                                   const __grid_constant__ CUtensorMap map_v) {
  using C = Cfg<HD>;
  constexpr int kStages = stages(HD);
  constexpr int kKeys = C::kKeys;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* s_q = align_1024(smem_raw);                // [chunk][kRows][kSwz]
  uint8_t* s_k = s_q + C::kQBytes;                    // [stage][chunk][kKeys][kSwz]
  uint8_t* s_v = s_k + kStages * C::kTileBytes;       // [stage][chunk][kKeys][kSwz]
  const int seq = p.seq;
  const int nt = (seq + kKeys - 1) / kKeys;
  float* s_kb = reinterpret_cast<float*>(s_v + kStages * C::kTileBytes);  // [nt * kKeys]
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_kb + nt * kKeys);
  const Ring k_ring{bars, bars + kStages, kStages};
  const Ring v_ring{bars + 2 * kStages, bars + 3 * kStages, kStages};
  uint64_t* q_full = bars + 4 * kStages;
  uint64_t* verdict = q_full + 1;  // the block's skip mask is written
  uint64_t* s_dead = verdict + 1;  // [kConsumerWarps] each warp's mask, then the block's

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int col = h * HD;
  // Key tiles are walked from the block's diagonal tile on, wrapping
  // round: a row's own key sets its running max first, so the tiles its
  // bias or key mask leaves dead are seen as dead.
  const int first = q0 / kKeys;
  auto tile_of = [&](int o) { return first + o < nt ? first + o : first + o - nt; };

  if (tid == 0) {
    k_ring.init();
    v_ring.init();
    mbar_init(q_full, 1);
    mbar_init(verdict, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // The producer: one thread issues every copy. Pass 1 streams K; pass
    // 2 K and V of the tiles some row of the block still needs (the first
    // kSpec before the verdict is known).
    release_registers<kProducerRegs>();
    if (tid == kConsumerThreads) {
      prefetch_tensormap(&map_q);
      prefetch_tensormap(&map_k);
      prefetch_tensormap(&map_v);
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) {
        tma_load_3d(s_q + c * kRows * C::kSwz, &map_q, col + c * C::kCW, q0, b, q_full);
      }
      PHASES_BEGIN();
      auto load = [&](const Ring& ring, uint8_t* tiles, const CUtensorMap* map, int it,
                      int tile) {
        uint64_t* bar = ring.acquire(it, C::kTileBytes);
        PHASE(11);
        uint8_t* dst = tiles + ring.stage(it) * C::kTileBytes;
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load_3d(dst + c * kKeys * C::kSwz, map, col + c * C::kCW, tile * kKeys, b, bar);
        }
      };
      int ik = 0;
      for (int o = 0; o < nt; ++o) load(k_ring, s_k, &map_k, ik++, tile_of(o));
      uint64_t dead = 0;
      int iv = 0;
      for (int o = 0; o < nt; ++o) {
        const int tile = tile_of(o);
        if (o == kSpec) {
          mbar_wait(verdict, 0);
          dead = s_dead[kConsumerWarps];
        }
        if (o >= kSpec && tile < kMaskTiles && (dead >> tile & 1)) continue;
        load(k_ring, s_k, &map_k, ik++, tile);
        load(v_ring, s_v, &map_v, iv++, tile);
      }
      PHASE(12);
      PHASES_END();
    }
  } else {
    claim_registers<kConsumerRegs>();
    PHASES_BEGIN();
    const int ct = tid;
    // Warp-uniform as the compiler sees it (a value it cannot prove
    // uniform makes every branch on it divergent, and wgmma in flight
    // across a divergent branch is serialized).
    const int warp = __shfl_sync(0xffffffffu, ct / 32, 0);  // rows 16 warp .. + 15
    const int w = warp / 4;    // consumer warpgroup: rows 64w .. 64w + 63
    const int lane = tid % 32;
    const int g = lane / 4;    // accumulator rows g and g + 8 of the warp
    const int t = lane % 4;    // accumulator columns 2t, 2t + 1 of each 8
    const int* mask = p.mask + size_t(b) * seq;
    // The row's key bias times log2(e): 0, the finite -1e9 of a masked
    // key, or -inf past S (TMA reads those keys as zeros).
    for (int key = ct; key < nt * kKeys; key += kConsumerThreads) {
      s_kb[key] = key >= seq ? -INFINITY : (mask[key] == 0 ? kNegBig * kLog2e : 0.f);
    }
    consumer_sync();
    const float* bias_rows[2] = {nullptr, nullptr};
    if (p.bias != nullptr) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        bias_rows[i] = p.bias + size_t(min(q0 + 16 * warp + g + 8 * i, seq - 1)) * seq;
      }
    }
    const bool bias_pairs = seq % 2 == 0;  // a row's bias is 8-byte aligned
    const float scale_log2 = p.scale * kLog2e;
    const uint8_t* q_rows = s_q + w * 64 * C::kSwz;

    // S = Q K^T of the warpgroup's 64 rows against the K tile of ring slot
    // `it` (its copy waited on first). Every wgmma is issued, committed and
    // waited on in straight-line code: a count of groups in flight that
    // differs between two paths makes the compiler serialize them.
    auto issue_scores = [&](float (&s)[kKeys / 2], int it) {
      wgmma_fence();
      issue_qk<HD, kKeys, C::kSwz>(s, q_rows, kRows * C::kSwz,
                                   s_k + k_ring.stage(it) * C::kTileBytes);
      wgmma_commit();
    };
    // The log2-scaled scores t = s * scale * log2(e) + key bias * log2(e)
    // [+ bias * log2(e)], so that each p is one ex2.
    auto finish_scores = [&](float (&s)[kKeys / 2], int tile) {
      const int t0 = tile * kKeys;
      if (p.bias == nullptr) {
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
          const float2 kb = *reinterpret_cast<const float2*>(s_kb + t0 + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[4 * j + e] = fmaf(s[4 * j + e], scale_log2, (e & 1) ? kb.y : kb.x);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
          const int key = t0 + 8 * j + 2 * t;
          const float2 kb = *reinterpret_cast<const float2*>(s_kb + key);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            // Keys past S read a clamped bias: their key bias is -inf.
            const float2 bias =
                bias_pairs
                    ? *reinterpret_cast<const float2*>(bias_rows[i] + min(key, seq - 2))
                    : make_float2(bias_rows[i][min(key, seq - 1)],
                                  bias_rows[i][min(key + 1, seq - 1)]);
            s[4 * j + 2 * i] =
                fmaf(s[4 * j + 2 * i], scale_log2, fmaf(bias.x, kLog2e, kb.x));
            s[4 * j + 2 * i + 1] =
                fmaf(s[4 * j + 2 * i + 1], scale_log2, fmaf(bias.y, kLog2e, kb.y));
          }
        }
      }
    };

    mbar_wait(q_full, 0);
    // Pass 1: each row's max and sum (online, fp32); tile o + 1's Q K^T runs
    // while tile o's exponentials do (two score buffers). A warp whose 16
    // rows all see a tile's scores kDeadGap or more below their running max
    // skips its exponentials (every one would be exactly 0) and marks the
    // tile dead.
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    uint64_t dead = 0;
    auto pass1 = [&](float (&s)[kKeys / 2], int o) {
      const int tile = tile_of(o);
      finish_scores(s, tile);
      float m_new[2];
      bool skip = true;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float mx = row_max<kKeys>(s, i);
        m_new[i] = fmaxf(m[i], mx);
        skip = skip && m_new[i] > -INFINITY && mx - m_new[i] < -kDeadGap;
      }
      if (__all_sync(0xffffffffu, skip)) {
        if (tile < kMaskTiles) dead |= 1ull << tile;
        return;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
          part[j % 2] += exp2_approx(s[4 * j + 2 * i] - m_new[i]);
          part[2 + j % 2] += exp2_approx(s[4 * j + 2 * i + 1] - m_new[i]);
        }
        const float sum = (part[0] + part[1]) + (part[2] + part[3]);
        const float rescale = exp2_approx(m[i] - m_new[i]);
        const float alpha = m_new[i] == m[i] ? 1.f : rescale;
        l[i] = l[i] * alpha + sum;
        m[i] = m_new[i];
      }
    };
    float sa[kKeys / 2], sb[kKeys / 2];
    // One step: tile o + 1's Q K^T issued into `next`, then tile o's
    // scores (in `cur`) awaited and used.
    auto pass1_step = [&](float (&cur)[kKeys / 2], float (&next)[kKeys / 2], int o) {
      k_ring.wait(o + 1);
      PHASE(1);
      issue_scores(next, o + 1);
      wgmma_wait<1>();
      fence_operands(cur);
      PHASE(2);
      k_ring.release(o);
      pass1(cur, o);
      PHASE(3);
    };
    PHASE(0);
    k_ring.wait(0);
    issue_scores(sa, 0);
    int o = 0;
    for (; o + 2 < nt; o += 2) {
      pass1_step(sa, sb, o);
      pass1_step(sb, sa, o + 1);
    }
    if (o + 1 < nt) {  // two tiles left: o in sa, o + 1 not issued
      pass1_step(sa, sb, o);
      wgmma_wait<0>();
      fence_operands(sb);
      k_ring.release(o + 1);
      pass1(sb, o + 1);
    } else {  // one tile left, in sa
      wgmma_wait<0>();
      fence_operands(sa);
      k_ring.release(o);
      pass1(sa, o);
    }
    PHASE(3);
    float inv_l[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) inv_l[i] = 1.f / quad_sum(l[i]);

    // The block skips in pass 2 the tiles every warp found dead: each of
    // their p is exactly 0 against the final max too. The producer learns
    // which through the verdict barrier.
    if (lane == 0) s_dead[warp] = dead;
    consumer_sync();
    uint64_t block_dead = ~0ull;
#pragma unroll
    for (int wi = 0; wi < kConsumerWarps; ++wi) block_dead &= s_dead[wi];
    block_dead = (uint64_t(__shfl_sync(0xffffffffu, uint32_t(block_dead >> 32), 0)) << 32) |
                 __shfl_sync(0xffffffffu, uint32_t(block_dead), 0);
    if (ct == 0) {
      s_dead[kConsumerWarps] = block_dead;
      mbar_arrive(verdict);
    }

    // Pass 2: the normalised p, rounded to bf16, as the A operand of P V.
    // Over the live tiles, each step issues the next tile's Q K^T and the
    // previous tile's P V together, and both run while this tile's
    // exponentials do (two score buffers).
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    uint32_t pa[kKeys / 16][4];
    int ik = nt;  // K ring slot of the next pass-2 tile
    int iv = 0;   // V ring slot of the tile whose P is in pa
    auto next_live = [&](int o) {
      for (++o; o < nt; ++o) {
        const int tile = tile_of(o);
        if (o < kSpec || tile >= kMaskTiles || !(block_dead >> tile & 1)) break;
      }
      return o;
    };
    auto probs = [&](float (&s)[kKeys / 2], int o) {
      finish_scores(s, tile_of(o));
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * j + e] = exp2_approx(s[4 * j + e] - m[e >> 1]) * inv_l[e >> 1];
        }
      }
    };
    // P V of the tile whose P is in pa, alone.
    auto lone_pv = [&]() {
      v_ring.wait(iv);
      wgmma_fence();
      issue_pv<HD, kKeys, C::kSwz>(acc, pa, s_v + v_ring.stage(iv) * C::kTileBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      v_ring.release(iv++);
    };
    // cur holds tile o's scores, the previous live tile's P waits in pa:
    // the next live tile's Q K^T and that P V in flight under tile o's
    // exponentials.
    auto step = [&](float (&cur)[kKeys / 2], float (&next)[kKeys / 2], int o) {
      k_ring.wait(ik);
      v_ring.wait(iv);
      PHASE(5);
      wgmma_fence();
      issue_qk<HD, kKeys, C::kSwz>(next, q_rows, kRows * C::kSwz,
                                   s_k + k_ring.stage(ik) * C::kTileBytes);
      wgmma_commit();
      issue_pv<HD, kKeys, C::kSwz>(acc, pa, s_v + v_ring.stage(iv) * C::kTileBytes);
      wgmma_commit();
      probs(cur, o);
      PHASE(7);
      wgmma_wait<0>();
      fence_operands(next);
      fence_operands(acc);
      PHASE(8);
      k_ring.release(ik++);
      v_ring.release(iv++);
      pack_p<kKeys>(pa, cur);
      PHASE(9);
    };
    // The last live tile (scores in cur): the previous P V under its
    // exponentials, then its own P V.
    auto last = [&](float (&cur)[kKeys / 2], int o) {
      v_ring.wait(iv);
      wgmma_fence();
      issue_pv<HD, kKeys, C::kSwz>(acc, pa, s_v + v_ring.stage(iv) * C::kTileBytes);
      wgmma_commit();
      probs(cur, o);
      wgmma_wait<0>();
      fence_operands(acc);
      v_ring.release(iv++);
      pack_p<kKeys>(pa, cur);
      lone_pv();
    };
    PHASE(4);
    // Tile 0 (always live) into sa; its exponentials under the next live
    // tile's Q K^T (into sb).
    k_ring.wait(ik);
    issue_scores(sa, ik);
    wgmma_wait<0>();
    fence_operands(sa);
    k_ring.release(ik++);
    int o_cur = next_live(0);
    if (o_cur >= nt) {
      probs(sa, 0);
      pack_p<kKeys>(pa, sa);
      lone_pv();
    } else {
      k_ring.wait(ik);
      issue_scores(sb, ik);
      probs(sa, 0);
      wgmma_wait<0>();
      fence_operands(sb);
      k_ring.release(ik++);
      pack_p<kKeys>(pa, sa);
      PHASE(10);
      while (true) {  // tile o_cur's scores in sb
        int o_next = next_live(o_cur);
        if (o_next >= nt) {
          last(sb, o_cur);
          break;
        }
        step(sb, sa, o_cur);
        o_cur = o_next;
        o_next = next_live(o_cur);  // tile o_cur's scores in sa
        if (o_next >= nt) {
          last(sa, o_cur);
          break;
        }
        step(sa, sb, o_cur);
        o_cur = o_next;
      }
    }

    const int dim = p.num_heads * HD;
    bf16* out = static_cast<bf16*>(p.out) + size_t(b) * seq * dim;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + 16 * warp + g + 8 * i;
      if (row >= seq) continue;
      bf16* dst = out + size_t(row) * dim + col + 2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
      }
    }
    PHASE(10);
    PHASES_END();
  }
}

// Q, K and V as 3-D tensor maps [B, S, N*Hd] (boxes of kCW columns by 128
// query rows or 64 keys; rows past S read as zeros), then the grid
// (query tiles, heads, batch rows).
template <int HD>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  using C = Cfg<HD>;
  const size_t smem = smem_bytes(HD, p.seq);
  auto kernel = encoder_attention_wgmma_kernel<HD>;
  static std::atomic<bool> opted_in[mma_tiles::kMaxDevices];
  cudaError_t err = mma_tiles::opt_in_shared_memory(
      reinterpret_cast<const void*>(kernel), smem, opted_in);
  if (err != cudaSuccess) return err;
  const cuuint64_t dim = cuuint64_t(p.num_heads) * HD;
  const cuuint64_t dims[3] = {dim, cuuint64_t(p.seq), cuuint64_t(batch)};
  const cuuint64_t strides[2] = {dim * 2, dim * 2 * cuuint64_t(p.seq)};
  const cuuint32_t q_box[3] = {C::kCW, kRows, 1};
  const cuuint32_t kv_box[3] = {C::kCW, C::kKeys, 1};
  CUtensorMap map_q, map_k, map_v;
  if (!encode_bf16_map(&map_q, p.q, 3, dims, strides, q_box, C::kSwz) ||
      !encode_bf16_map(&map_k, p.k, 3, dims, strides, kv_box, C::kSwz) ||
      !encode_bf16_map(&map_v, p.v, 3, dims, strides, kv_box, C::kSwz)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((p.seq + kRows - 1) / kRows, p.num_heads, batch);
  kernel<<<grid, kBlockThreads, smem, stream>>>(p, map_q, map_k, map_v);
  return cudaGetLastError();
}

}  // namespace wg

template <typename T, int HD, bool kExact>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.head_dim);
  auto kernel = encoder_attention_kernel<T, HD, kExact>;
  static std::atomic<bool> opted_in[mma_tiles::kMaxDevices];
  cudaError_t err = mma_tiles::opt_in_shared_memory(
      reinterpret_cast<const void*>(kernel), smem, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + kBQ - 1) / kBQ, p.num_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD, bool kExact>
cudaError_t launch_mma(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(HD, p.seq);
  auto kernel = encoder_attention_mma_kernel<HD, kExact>;
  static std::atomic<bool> opted_in[mma_tiles::kMaxDevices];
  cudaError_t err = mma_tiles::opt_in_shared_memory(
      reinterpret_cast<const void*>(kernel), smem, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + kBQ - 1) / kBQ, p.num_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const Params& p, int batch, cudaStream_t stream) {
  switch (p.head_dim) {
    case 32: return launch<T, 32, true>(p, batch, stream);
    case 64: return launch<T, 64, true>(p, batch, stream);
    case 128: return launch<T, 128, true>(p, batch, stream);
    default: return launch<T, 128, false>(p, batch, stream);
  }
}

cudaError_t launch_mma_head_dim(const Params& p, int batch, cudaStream_t stream) {
  switch (p.head_dim) {
    case 32: return launch_mma<32, true>(p, batch, stream);
    case 64: return launch_mma<64, true>(p, batch, stream);
    case 128: return launch_mma<128, true>(p, batch, stream);
    default: return launch_mma<128, false>(p, batch, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). route: 0 =
// CUDA cores (any dtype, head dims a multiple of 8), 1 = tensor cores (bf16,
// head dims a multiple of 16). mask is int32 [B, S]; bias is fp32 [S, S] or
// null. Returns a cudaError_t: 0 on a successful launch,
// cudaErrorInvalidValue for arguments the route does not take. The launch is asynchronous on `stream`; nothing is allocated
// and nothing synchronises.
int distllm_ea_launch(const void* q, const void* k, const void* v,
                      const void* mask, const void* bias, void* out,
                      int batch, int seq, int num_heads, int head_dim,
                      float scale, int dtype, int route, void* stream) {
  if (batch < 1 || batch > 65535 || seq < 1 || num_heads < 1 ||
      num_heads > 65535 || head_dim < 8 || head_dim > 128 ||
      head_dim % 8 != 0) {
    return int(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = static_cast<const int*>(mask);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.seq = seq;
  p.num_heads = num_heads;
  p.head_dim = head_dim;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1 || head_dim % 16 != 0) return int(cudaErrorInvalidValue);
    return int(launch_mma_head_dim(p, batch, s));
  }
  if (route == 2) {
    if (dtype != 1) return int(cudaErrorInvalidValue);
    switch (head_dim) {
      case 32: return int(wg::launch<32>(p, batch, s));
      case 64: return int(wg::launch<64>(p, batch, s));
      case 128: return int(wg::launch<128>(p, batch, s));
      default: return int(cudaErrorInvalidValue);
    }
  }
  if (route != 0) return int(cudaErrorInvalidValue);
  if (dtype == 0) return int(launch_dtype<float>(p, batch, s));
  if (dtype == 1) return int(launch_dtype<__nv_bfloat16>(p, batch, s));
  return int(cudaErrorInvalidValue);
}

#ifdef DISTLLM_PHASES
// The phase counters of the launches so far (hopper_attention.cuh), then
// zeroed when `reset` is set.
int distllm_read_phases(unsigned long long* host, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_phases, sizeof(g_phases));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[16] = {};
    err = cudaMemcpyToSymbol(g_phases, zero, sizeof(zero));
  }
  return int(err);
}
#endif

const char* distllm_ea_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
