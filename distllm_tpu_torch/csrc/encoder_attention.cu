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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  if (route != 0) return int(cudaErrorInvalidValue);
  if (dtype == 0) return int(launch_dtype<float>(p, batch, s));
  if (dtype == 1) return int(launch_dtype<__nv_bfloat16>(p, batch, s));
  return int(cudaErrorInvalidValue);
}

const char* distllm_ea_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
