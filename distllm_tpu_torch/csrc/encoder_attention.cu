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
// time is set by bytes (q, k, v, out once over 3.35 TB/s). This first
// kernel runs its products on the CUDA cores in fp32 and is bound by them,
// far above that least time; tensor-core tiles (wgmma, TMA) are later work.
//
// Design (a simple kernel that is right first):
// - The TPU kernel holds one row's whole [S, S] fp32 score tile in VMEM
//   and loops the heads inside one grid step. On Hopper a block has at most
//   227 KB of shared memory (one head's tile at S = 288 is 332 KB), so here
//   one thread block per (64-query tile, head, batch row) walks the keys in
//   tiles of 64 staged in shared memory, read straight from the packed
//   [B, S, N*Hd] layout with row stride N*Hd — no transpose is ever
//   materialised.
// - Two passes over the keys. Pass 1 keeps each query's running max and
//   sum in registers (online, fp32). Pass 2 recomputes the scores, forms the
//   NORMALISED p, rounds it to T and accumulates p @ V in fp32 — so p is
//   rounded after the division, exactly where the TPU kernel rounds it
//   (:139-144). One pass with the division at the end would round the
//   unnormalised p instead, a second, independent bf16 error per key.
// - Each thread owns a 4-query x 8-key register tile of scores (keys
//   interleaved with stride 8 so the 8 lanes of a query read 8 banks) and a
//   4-query x Hd/8 tile of the output; a query's max and sum are reduced
//   over its 8 lanes with shuffles.
// - Keys past S are excluded (-inf, never staged); every masked key is
//   present with its -1e9, as the TPU computes it. Queries past S are
//   computed from zero rows and never written.
// - Head dims: any multiple of 8 up to 128; 32, 64 and 128 are compiled
//   with the head dim fixed, others with it read at run time. Any S >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;     // queries per block
constexpr int kBK = 64;     // keys per staged tile
constexpr int kRowsPT = 4;  // queries per thread
constexpr int kColsPT = 8;  // keys per thread (interleaved, stride 8)
constexpr int kMaxDevices = 64;
constexpr float kNegBig = -1e9f;

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

template <typename T, int HD, bool kExact>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.head_dim);
  auto kernel = encoder_attention_kernel<T, HD, kExact>;
  // Above 48 KiB a block must opt in. The opt-in is set once per device
  // for this instance, at the device's own maximum, not on every launch.
  static std::atomic<bool> opted_in[kMaxDevices];
  if (smem > 48 * 1024) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!opted_in[device].load(std::memory_order_acquire)) {
      int limit = 0;
      err = cudaDeviceGetAttribute(
          &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
      if (err != cudaSuccess) return err;
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
      if (err != cudaSuccess) return err;
      opted_in[device].store(true, std::memory_order_release);
    }
  }
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). mask is
// int32 [B, S]; bias is fp32 [S, S] or null. Returns a cudaError_t: 0 on a
// successful launch, cudaErrorInvalidValue for arguments the kernel does
// not take. The launch is asynchronous on `stream`; nothing is allocated
// and nothing synchronises.
int distllm_ea_launch(const void* q, const void* k, const void* v,
                      const void* mask, const void* bias, void* out,
                      int batch, int seq, int num_heads, int head_dim,
                      float scale, int dtype, void* stream) {
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
  if (dtype == 0) return int(launch_dtype<float>(p, batch, s));
  if (dtype == 1) return int(launch_dtype<__nv_bfloat16>(p, batch, s));
  return int(cudaErrorInvalidValue);
}

const char* distllm_ea_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
