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
// Each int8 code is widened to fp32 in registers, every product is summed
// in fp32 (fmaf: a bf16 x int8 product is exact in fp32, so only the
// summation order differs from the plain version), the scale multiplies the
// fp32 sum once, and the result rounds once to T. No float copy of the
// weight is ever written to device memory.
//
// What bounds it on an H100 SXM: at decode (M <= 128) the int8 weight
// bytes, K * N, over 3.35 TB/s (a 4096 x 14336 product streams 58.7 MB:
// 17.5 us); at prefill and embed sizes (M in the thousands) the 2 * M * K *
// N operations over 989 TFLOP/s. This first kernel multiplies on the CUDA
// cores in fp32 and is far from the second bound; tensor-core tiles
// (mma.sync / wgmma on converted tiles, TMA staging) are later work.
//
// Design (a simple kernel that is right first):
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kVec = 4;  // elements in 16 bytes
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
};

// 16 raw bytes of T widened to fp32.
__device__ __forceinline__ void widen(const uint4& raw, float* dst, float) {
  dst[0] = __uint_as_float(raw.x);
  dst[1] = __uint_as_float(raw.y);
  dst[2] = __uint_as_float(raw.z);
  dst[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void widen(const uint4& raw, float* dst, __nv_bfloat16) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // bf16 is the top half of an fp32: widening is a shift.
    dst[2 * i] = __uint_as_float(words[i] << 16);
    dst[2 * i + 1] = __uint_as_float(words[i] & 0xFFFF0000u);
  }
}

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
template <typename T, int TM>
struct Tile {
  static constexpr int kBM = kRowGroups * TM;
  static constexpr int kVec = Elem<T>::kVec;
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
    const T* x = static_cast<const T*>(p.x);
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

  // Widen the held loads to fp32 into shared memory: q as s_b[k][n], x
  // transposed as s_a[k][m].
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
        float v[kVec];
        widen(x_raw[i], v, T());
#pragma unroll
        for (int e = 0; e < kVec; ++e) s_a[kc + e][row] = v[e];
      }
    }
  }
};

template <typename T, int TM>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const Params p) {
  using Staged = Tile<T, TM>;
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
        store4(static_cast<T*>(p.out) + size_t(m) * p.n + n, v);
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

template <typename T, int TM>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int kBM = kRowGroups * TM;
  const dim3 grid((p.n + kBN - 1) / kBN, (p.m + kBM - 1) / kBM, p.splits);
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidValue;
  int8_matmul_kernel<T, TM><<<grid, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const size_t quads = size_t(p.m) * p.n / 4;
  const unsigned blocks = unsigned(
      (quads + kThreads - 1) / kThreads < 4096 ? (quads + kThreads - 1) / kThreads
                                               : 4096);
  reduce_splits_kernel<T><<<blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(const Params& p, int block_rows, cudaStream_t stream) {
  if (block_rows == kRowGroups) return launch<T, 1>(p, stream);
  if (block_rows == 4 * kRowGroups) return launch<T, 4>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out share it). q is int8 [K, N],
// scale fp32 [N]. block_rows is 16 or 64 (rows of x per block). With
// splits > 1, partial must hold splits * M * N floats and k_per_split (a
// multiple of 32) * splits must cover K. K and N must be multiples of 16
// and every pointer 16-byte aligned. Returns a cudaError_t: 0 on a
// successful launch, cudaErrorInvalidValue for arguments the kernel does
// not take. Asynchronous on `stream`; nothing is allocated.
int distllm_qmm_launch(const void* x, const void* q, const void* scale,
                       void* out, void* partial, int m, int k, int n,
                       int block_rows, int splits, int k_per_split, int dtype,
                       void* stream) {
  if (m < 1 || k < 16 || n < 16 || k % 16 != 0 || n % 16 != 0 || splits < 1 ||
      k_per_split < kBK || k_per_split % kBK != 0 ||
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
  if (dtype == 0) return int(launch_rows<float>(p, block_rows, s));
  if (dtype == 1) return int(launch_rows<__nv_bfloat16>(p, block_rows, s));
  return int(cudaErrorInvalidValue);
}

const char* distllm_qmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
