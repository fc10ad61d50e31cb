// Ragged paged attention for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces: distllm_tpu/ops/paged_attention.py ragged_paged_attention_pallas
// (line 683; kernel body _ragged_paged_attn_kernel, line 372) — the one
// attention site of every serving dispatch: span-1 decode rows and
// multi-token prefill tails over a paged KV pool.
//
// What it computes: for each row b, the queries q[b, i] (i < q_lens[b]) at
// absolute positions q_start[b] + i attend causally to the row's keys
// 0 .. context_lens[b]-1, gathered page by page through block_tables[b].
// GQA (num_heads / num_kv_heads query heads per KV head), an optional
// sliding window (window <= 0 = off: a query at p sees keys in
// (p - window, p]), a custom score scale and an optional tanh logit
// softcap. Softmax is online (flash-attention recurrence) in fp32; no
// [S, T] score tensor is ever written to device memory. Pad queries
// (i >= q_lens[b]) and fully padded rows write exact zeros.
//
// What bounds it on an H100 SXM: decode rows read every live K/V byte once
// and do 4 flops per byte pair, far below the card's ~295 flop/byte ridge,
// so decode is bound by KV bytes over 3.35 TB/s. Long prefill tails do
// O(span) flops per KV byte and are bound by the tensor cores' operations.
// Route 1 stays well above that bound: a cycle-counter trace of its steps
// (scripts/profile_torch_kernel_phases.py) puts about a fifth in issuing
// the tile copies and the rest in the products, the softmax and the
// block's prologue, at two blocks of four warps per SM (shared memory and
// registers both allow two). Route 2's times against its bound: PERF.md.
//
// Four routes, chosen by the wrapper from the dtype, the pool and the
// tile's rows and launched by route number; none ever gives way to another:
//
// Route 0, CUDA cores (fp32: the fp32 models and the identity checks):
// - one thread block per (query tile, KV head, row): grid (tiles, Nkv, B).
//   The query tile holds span_tile positions x the GQA group, so each K/V
//   tile staged in shared memory serves the whole group — KV bytes are
//   read once per query tile, not once per query head.
// - the Pallas grid walked KV chunks in order and carried m/l/acc in VMEM
//   scratch; here a loop inside the block walks the row's live keys
//   [lo, hi) in tiles of 32 and carries m/l/acc in shared memory.
// - keys outside [lo, hi) are never read from the pool: their staged K/V
//   are exact zeros, so garbage in the trash block 0 (or block-table
//   padding, which is 0 too) can never reach a product — a masked key is
//   skipped, not multiplied by a zero probability (0 x NaN = NaN).
// - 16-byte vector loads from device memory, fp32 arithmetic throughout
//   (__bfloat162float on load, __float2bfloat16 on store).
//
// Route 1, tensor cores (bf16 tiles of 16..64 rows: prefill and chunk spans):
// - the same grid, the same interleaved (span, group) rows (Pallas
//   :568-575), padded to 64: four warps of 16 rows each.
// - K/V tiles of 64 keys (4 pages of 16) resolved per key through the
//   block's pages of block_tables, copied to shared memory once, and
//   staged by cp.async, 16 bytes a thread, into a ring of two:
//   tile t + 1 is issued right after tile t's Q K^T products and loads
//   while they and the rest of tile t compute. A key outside [lo, hi) is
//   zero-filled by the copy (source size 0) and never read — the trash
//   block guarantee of route 0.
// - Q K^T and P V are bf16 mma.m16n8k16 with fp32 accumulators, operands
//   by ldmatrix (.trans for V); Q's fragments stay in registers for the
//   whole key loop. Scores stay in registers: scale, tanh softcap (fp32),
//   then the causal / window / q_lens mask, which a tile wholly inside
//   every row's range skips; they are kept as s * log2(e), so each p is
//   one ex2. The online max and sum run in fp32 over the quad that shares
//   a row.
// - p is rounded to bf16 as the A operand of P V, unnormalised, where the
//   TPU kernel rounds it (probs.astype(vh.dtype), :649-653); l sums the
//   unrounded p (:638-640).
// - a warp skips the products of a key tile that lies wholly above its
//   rows' diagonal or below their window, and the block's key loop ends at
//   its last live query: a causal prefill does about half the products of
//   a dense one. The query tiles with the most keys are launched first, so
//   the short ones fill the tail of the grid.
//
// Route 2, split-KV tensor cores (bf16 tiles of fewer than 16 rows: decode
// rows, and spans of 2-3 at Mistral's group of 4). It replaced route 0 for
// these rows, which left half the card idle (a block per (row, KV head):
// 64 blocks at 8 rows x 8 KV heads on 132 SMs, the longest row setting the
// time), dotted fp32 rows served from shared memory (128 serial fmaf a
// score), loaded K/V synchronously behind four barriers a 32-key tile, and
// over an int8 pool fetched each key's scales through the block table in
// device memory. A decode row reads each live K/V byte once and does 4
// flops per byte pair, so its bound is the KV bytes over 3.35 TB/s; the
// design aims there:
// - the grid is (splits, Nkv, B): each split owns a fixed range of
//   split_keys keys (whole pages, a multiple of 64). The wrapper's plan
//   (ops/paged_attention.py split_plan) comes from shapes the host knows
//   (max_blocks x block_size, B, Nkv, the SM count) and never from
//   context_lens, so a launch syncs nothing and can be captured in a CUDA
//   graph: about two blocks per SM when every row is full, at least 128
//   keys a split. A block whose split holds none of its row's [lo, hi)
//   exits at once (a split wholly below the window or past the context).
// - the tile's rows (at most 15) are padded with zero rows to mma's m16
//   operand: Q K^T and P V run as bf16 mma.m16n8k16 with fp32
//   accumulators, as on route 1, P's A fragments straight from S's
//   accumulators. The padding wastes tensor-core work, not bytes, and the
//   route is bound by bytes: swapping the operands (keys as M) would need
//   a shuffle of P between the two products for nothing.
// - each of the block's four warps takes 16 keys of every 64-key step of
//   the split through a cp.async ring of its own, three deep, so it
//   stages, waits and computes with no block barrier in the key loop; the
//   split's pages of the block table are copied to shared memory once.
//   Keys outside [lo, hi) and the split are zero-filled by the copy,
//   never read, and masked key by key (causal, window, q_lens).
// - each warp keeps its own online m, l and acc in registers; p is
//   rounded to bf16 unnormalised, relative to the warp's running max, as
//   the TPU kernel rounds it; l sums the unrounded p. At the end of the
//   split the warps merge in warp order through shared memory (fp32).
// - a row with one live split is written by that block. Otherwise each
//   split writes its fp32 (m, l, acc[Hd]) of every row to a workspace,
//   fences, and takes an atomic ticket of its (row, KV head); the last to
//   arrive merges the partials in split order (exp2(m_s - M) rescales,
//   fp32 sums), which makes the result bitwise reproducible from launch to
//   launch, writes the rows and sets the ticket back to 0. One launch, no
//   memset, no floating-point atomics. A split with no live key for a row
//   has m = -inf and l = 0; the merge rebases on 0 when every m is -inf,
//   so rows that see no key come out as exact zeros, as on routes 0 and 1.
//
// Route 3, wgmma and TMA (bf16 q over a bf16 pool of 16-token pages,
// tiles of 64 to 128 rows: prefill and long chunks; csrc/hopper_attention.cuh
// holds the main loop it shares with K3's route 2). Route 1's mma.sync
// cannot reach the tensor cores' rate and its 169 KiB at head dim 256 left
// one 4-warp block an SM with nothing hiding the copies. Here:
// - a block is one producer warp and two consumer warpgroups of 64 rows
//   (the interleaved (span, group) rows, 128 of them: at Gemma-2's group
//   of 2 a tile covers 64 positions); the producer gives its registers to
//   the consumers (setmaxnreg).
// - the producer loads the query tile with TMA as one box per 64 columns
//   over (span positions, the group's heads) of q [B, S, Nh, Hd], which is
//   the interleaved row order; then, for each 64-key tile, one box per
//   page and 64 columns of the pool [num_blocks, 16, Nkv, Hd] into a ring
//   of K tiles and a ring of V tiles (six deep at head dim 64, four at
//   128, two at 256), each stage an mbarrier. The pages come from the
//   block table, copied to shared memory once. A page wholly outside
//   [lo, hi) is never loaded.
// - each consumer warpgroup runs Q K^T as wgmma from shared memory (128-
//   byte swizzle, K-major), scale / softcap / mask in registers as on
//   route 1 (the softcap's tanh as 1 - 2 / (e^(2|x|) + 1): one ex2, one
//   rcp), the online max and sum in fp32, then P V as wgmma with P, the
//   unnormalised p rounded to bf16, as the register A operand (l sums the
//   unrounded p: the TPU's rounding point, route 1's tolerance). Tile
//   it's Q K^T and tile it - 1's P V are issued together, and P V runs
//   under tile it's softmax; at head dim 256 (O alone 128 registers a
//   thread) the products are serial and the other warpgroup's fill in.
// - the trash-block guarantee: before a warpgroup's P V reads a V tile,
//   it zeroes that tile's rows outside [lo, hi) (the rest of the row's
//   last page, the page under the window's floor, pages never loaded),
//   fences the generic writes for the async proxy and syncs its 128
//   threads; K's such rows only meet scores masked to -inf by a select.
// - causal tile skipping per warpgroup (its rows' window and diagonal),
//   the longest query tiles launched first, pad queries exact zeros, as
//   on route 1.
//
// int8-KV mode, on routes 0-2 (kv_dtype 1; Pallas quantized=True,
// :585-602, :614-626, :638-653): the pool holds int8 codes and a
// per-page, per-KV-head fp32 scale ([num_blocks, Nkv], one layer's
// slice). The codes are widened exactly (|c| <= 127 fits bf16's
// significand and fp32) and never dequantized in memory:
// - K: score = (q . c) * scale * k_scale[page, h], before the softcap and
//   the mask;
// - V: l sums the unscaled p; then p *= v_scale[page, h] before P V (on
//   route 1 before p is rounded to bf16), so sum_j p_j v_scale_j c_j is
//   P V over the dequantized values.
// A key outside [lo, hi) reads neither its codes nor its scale: both
// stage as zeros, so a NaN in the trash block's data or scale cannot
// reach an output. Route 2 stages each warp's codes and per-key scales by
// cp.async (4 bytes a scale, zero-filled when dead) and widens the codes
// to bf16 in the warp's own tile, behind a warp barrier. Route 0 widens
// 16 codes per 16-byte load to fp32 and
// stages each tile's 32 scales per key in shared memory. Route 1 stages
// the int8 tile with cp.async into a ring of two (half the bytes of a
// bf16 tile: a 128-wide row is 8 chunks of 16 bytes, not 16), its per-key
// scales beside it (4-byte cp.async, zero-filled when dead), then widens
// the codes to bf16 in shared memory, in the layout and stride ldmatrix
// reads, behind one more barrier per tile; the bf16 tile needs no ring of
// its own, since it is written after the previous tile's last read.
//
// Mixed full-precision mode, on routes 0-2 (kv_dtype 2; Pallas :609-613,
// :641-652): the pool holds the other full-precision dtype than q — bf16
// under fp32 queries (route 0), fp32 under bf16 queries (routes 1 and 2,
// and route 0 for a GQA group above 64). The Pallas kernel casts K to q's
// dtype for Q K^T and p to V's dtype for P V:
// - route 0, fp32 q over bf16: K and V widen exactly on load; p is rounded
//   to bf16 before P V (l sums the unrounded p), the rest as in fp32. (bf16
//   q over fp32: K is rounded to bf16 on load; p and V stay fp32.)
// - routes 1 and 2, bf16 q over fp32: the fp32 rows stage by cp.async into
//   a ring of their own, as int8 codes do, and are narrowed to bf16 (round
//   to nearest even) into the tiles ldmatrix reads, behind the same barrier
//   as the widening of codes. K's narrowing is the Pallas cast. V's is not:
//   the Pallas kernel weighs fp32 V by fp32 p, while mma.sync takes bf16
//   operands. Keeping fp32 P V (CUDA-core FMA on the staged V, or a split of
//   V and p into bf16 high and low parts, three products for one) would cost
//   more than the P V product itself; this mode's tolerance carries the one
//   extra rounding of V instead (ops/paged_attention.py TOL_MIXED), held on
//   the card against the plain version and on the CPU against the Pallas
//   kernel in interpret mode. An fp32 tile is twice a bf16 one: route 1's
//   ring of two fp32 K and V tiles takes 128 KiB beside the bf16 tiles (one
//   block per SM), and route 2's rings are two deep instead of three (four
//   warps x 32 KiB).
//
// Head dim 256 (Gemma-7B, Gemma-2 2B and 9B; the Pallas kernel takes any
// multiple of 128, :735-740), on every route and KV storage. What the width
// changes:
// - registers: P V's accumulators are HD / 8 tiles of four fp32 a lane, 128
//   at 256. Q's fragments (HD / 16 x 4 registers) would add 64, past the 255
//   a thread may have, so on routes 1 and 2 they are read from the query
//   tile in shared memory at each k-step of Q K^T (ldmatrix) instead.
// - shared memory, 227 KiB a block at most (sizes with a short block
//   table): route 0 at 64 rows 201 KiB; route 1 165 KiB over a bf16 pool,
//   164 KiB over int8, and over an fp32 pool (mixed) 32-key tiles, 194 KiB
//   (64-key tiles would take 355); route 2's four rings, three deep, 206 KiB
//   over bf16 (one block an SM where two fit at 128: split_plan's blocks per
//   SM follows the head dim), 172 KiB over int8, and over fp32 one deep, 202
//   KiB: there a warp stages the next step as soon as it has narrowed this
//   step's rows into its own bf16 tile, so the copy still runs under the
//   step's products.
// - a configuration that still does not fit (route 0 with more than about
//   76 rows, a block table too long for route 1 or for route 2's split) is
//   refused at launch (kErrSharedMemory, whose error string names both
//   sizes), never served by another route.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include <algorithm>
#include <type_traits>

#include "hopper_attention.cuh"
#include "mma_tiles.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kKeyTile = 32;  // keys per staged tile (one per warp lane)
// KV storage of a launch (kv_dtype): q's dtype, int8 codes with scales, or
// the other full-precision dtype.
constexpr int kKvModel = 0;
constexpr int kKvInt8 = 1;
constexpr int kKvMixed = 2;
// A launch's return when its route needs more shared memory than a block
// of the device may have (never a cudaError_t): distllm_rpa_error_string
// then names both sizes, kept per host thread.
constexpr int kErrSharedMemory = -1;
thread_local long long smem_needed = 0, smem_allowed = 0;

// 0 when `smem` bytes fit a block of the current device (its opt-in limit,
// read once per device), kErrSharedMemory when they do not, else the
// cudaError_t of the query.
int check_shared_memory(size_t smem) {
  static std::atomic<int> limits[mma_tiles::kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return int(err);
  if (device >= mma_tiles::kMaxDevices) return int(cudaErrorInvalidDevice);
  int limit = limits[device].load(std::memory_order_relaxed);
  if (limit == 0) {
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return int(err);
    limits[device].store(limit, std::memory_order_relaxed);
  }
  if (smem <= size_t(limit)) return 0;
  smem_needed = static_cast<long long>(smem);
  smem_allowed = limit;
  return kErrSharedMemory;
}

struct Params {
  const void* q;              // [B, S, Nh, Hd]
  const void* k_cache;        // [num_blocks, block_size, Nkv, Hd]
  const void* v_cache;
  const float* k_scale;       // int8 KV: [num_blocks, Nkv]; else null
  const float* v_scale;
  const int* block_tables;    // [B, max_blocks]
  const int* context_lens;    // [B]
  const int* q_start;         // [B] absolute position of the row's query 0
  const int* q_lens;          // [B] valid queries per row; null = span each
  void* out;                  // [B, S, Nh, Hd]
  int span;
  int num_heads;
  int num_kv_heads;
  int block_size;
  int max_blocks;
  int span_tile;
  int window;
  float scale;
  float softcap;              // <= 0 = off
};

// Route 2's own arguments, a second kernel parameter. Params keeps its
// layout: with these four fields in it, routes 0 and 1 compiled otherwise
// and route 1's prefill pair took 0.150 ms against 0.109
// (scripts/profile_torch_kernels_ab.py on an H100; PERF.md).
struct SplitArgs {
  float* workspace;  // the splits' partials (acc, then m and l)
  int* tickets;      // [B * Nkv] arrivals of each (row, KV head), left at 0
  int num_splits;    // key splits per row
  int split_keys;    // keys per split (whole pages, a multiple of 64)
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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
struct Vec16<int8_t> {
  static constexpr int kElems = 16;
  __device__ __forceinline__ static void load(const int8_t* src, float* dst) {
    const int4 raw = *reinterpret_cast<const int4*>(src);
    const int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[4 * i + j] = float(int8_t(words[i] >> (8 * j)));
    }
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int rows, int head_dim) {
  return sizeof(float) *
         (size_t(2) * rows * head_dim          // q tile + accumulator
          + size_t(kKeyTile) * (head_dim + 1)  // staged K (padded rows)
          + size_t(kKeyTile) * head_dim        // staged V
          + size_t(rows) * kKeyTile            // scores / probabilities
          + size_t(3) * rows                   // m, l, correction
          + size_t(2) * kKeyTile);             // int8 KV: K and V scales
}

// KV is T (a pool in the query's dtype) or int8_t (codes with scales).
template <typename T, typename KV, int HD>
__global__ void __launch_bounds__(kThreads)
    ragged_paged_attention_kernel(const Params p) {
  using V = Vec16<T>;
  using VK = Vec16<KV>;
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  // Mixed mode: K is cast to q's dtype (a rounding only from an fp32 pool
  // to bf16 q), p to V's (a rounding only from fp32 q to a bf16 pool).
  constexpr bool kRoundK =
      std::is_same<T, __nv_bfloat16>::value && std::is_same<KV, float>::value;
  constexpr bool kRoundP =
      std::is_same<T, float>::value && std::is_same<KV, __nv_bfloat16>::value;
  constexpr int kVec = V::kElems;
  constexpr int kVecKV = VK::kElems;
  constexpr int kPad = HD + 1;  // staged-K row stride: conflict-free dots

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int group = p.num_heads / p.num_kv_heads;
  const int rows = p.span_tile * group;  // row r: span r / group, head r % group

  extern __shared__ float smem[];
  float* s_q = smem;                       // [rows][HD]
  float* s_acc = s_q + rows * HD;          // [rows][HD]
  float* s_k = s_acc + rows * HD;          // [kKeyTile][kPad]
  float* s_v = s_k + kKeyTile * kPad;      // [kKeyTile][HD]
  float* s_p = s_v + kKeyTile * HD;        // [rows][kKeyTile]
  float* s_m = s_p + rows * kKeyTile;      // [rows]
  float* s_l = s_m + rows;                 // [rows]
  float* s_alpha = s_l + rows;             // [rows]
  float* s_ks = s_alpha + rows;            // [kKeyTile] int8 KV: K's scales
  float* s_vs = s_ks + kKeyTile;           // [kKeyTile] and V's

  const T* q = static_cast<const T*>(p.q);
  const KV* k_cache = static_cast<const KV*>(p.k_cache);
  const KV* v_cache = static_cast<const KV*>(p.v_cache);
  T* out = static_cast<T*>(p.out);

  const int ctx = p.context_lens[b];
  const int q0 = p.q_start[b];
  const int q_len = p.q_lens != nullptr ? p.q_lens[b] : p.span;
  const int win = p.window;
  const int span_off = qt * p.span_tile;

  // Stage the query tile (rows past the span are zero and never written).
  for (int i = tid; i < rows * (HD / kVec); i += kThreads) {
    const int r = i / (HD / kVec);
    const int c = (i % (HD / kVec)) * kVec;
    const int si = span_off + r / group;
    const int head = h * group + r % group;
    float vals[kVec];
    if (si < p.span) {
      V::load(q + ((size_t(b) * p.span + si) * p.num_heads + head) * HD + c,
              vals);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      s_q[r * HD + c + e] = vals[e];
      s_acc[r * HD + c + e] = 0.f;
    }
  }
  for (int r = tid; r < rows; r += kThreads) {
    s_m[r] = -INFINITY;
    s_l[r] = 0.f;
  }

  // Keys this tile can ever see: [lo, hi). The tile's first query has the
  // lowest window floor; its last valid query bounds the causal ceiling.
  const int lo = win > 0 ? max(q0 + span_off - win + 1, 0) : 0;
  const int hi = min(ctx, q0 + min(q_len, span_off + p.span_tile));
  __syncthreads();

  if (q_len > span_off) {
    const int warp = tid / 32;
    const int lane = tid % 32;
    for (int t0 = lo; t0 < hi; t0 += kKeyTile) {
      // Stage K/V of keys t0 .. t0+31, page by page through the block
      // table; keys at or past hi stay exact zeros (never read), and so
      // do their int8 scales.
      for (int i = tid; i < kKeyTile * (HD / kVecKV); i += kThreads) {
        const int j = i / (HD / kVecKV);
        const int c = (i % (HD / kVecKV)) * kVecKV;
        const int key = t0 + j;
        float kv[kVecKV];
        float vv[kVecKV];
        if (key < hi) {
          const int page = key / p.block_size;
          const int blk = p.block_tables[size_t(b) * p.max_blocks + page];
          const size_t off =
              ((size_t(blk) * p.block_size + key % p.block_size) *
                   p.num_kv_heads + h) * HD + c;
          VK::load(k_cache + off, kv);
          VK::load(v_cache + off, vv);
          if (kRoundK) {
#pragma unroll
            for (int e = 0; e < kVecKV; ++e) kv[e] = __bfloat162float(__float2bfloat16(kv[e]));
          }
          if (kInt8 && c == 0) {
            s_ks[j] = p.k_scale[size_t(blk) * p.num_kv_heads + h];
            s_vs[j] = p.v_scale[size_t(blk) * p.num_kv_heads + h];
          }
        } else {
#pragma unroll
          for (int e = 0; e < kVecKV; ++e) {
            kv[e] = 0.f;
            vv[e] = 0.f;
          }
          if (kInt8 && c == 0) {
            s_ks[j] = 0.f;
            s_vs[j] = 0.f;
          }
        }
#pragma unroll
        for (int e = 0; e < kVecKV; ++e) {
          s_k[j * kPad + c + e] = kv[e];
          s_v[j * HD + c + e] = vv[e];
        }
      }
      __syncthreads();

      // Scores of every (query row, key) pair of the tile.
      for (int i = tid; i < rows * kKeyTile; i += kThreads) {
        const int r = i / kKeyTile;
        const int j = i % kKeyTile;
        const int si = span_off + r / group;
        const int qp = q0 + si;
        const int key = t0 + j;
        float s = -INFINITY;
        if (key < hi && si < q_len && key <= qp &&
            (win <= 0 || key > qp - win)) {
          const float* qr = s_q + r * HD;
          const float* kr = s_k + j * kPad;
          float dot = 0.f;
#pragma unroll 16
          for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
          s = dot * p.scale;
          if (kInt8) s *= s_ks[j];  // K's page scale, before the softcap
          if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
        }
        s_p[i] = s;
      }
      __syncthreads();

      // Online-softmax update, one warp per query row, one lane per key.
      for (int r = warp; r < rows; r += kThreads / 32) {
        const float s = s_p[r * kKeyTile + lane];
        const float m_prev = s_m[r];
        const float m_new = fmaxf(m_prev, warp_max(s));
        // A row with no live key yet rebases on 0: exp(-inf - 0) = 0, so
        // its l and acc stay exactly 0 (no -inf - -inf = NaN).
        const float base = m_new == -INFINITY ? 0.f : m_new;
        const float prob = expf(s - base);
        const float total = warp_sum(prob);
        // l sums the unscaled p; P V takes p * V's page scale (int8), or
        // p rounded to the bf16 pool's dtype (mixed, fp32 q).
        s_p[r * kKeyTile + lane] = kInt8    ? prob * s_vs[lane]
                                   : kRoundP ? __bfloat162float(__float2bfloat16(prob))
                                             : prob;
        if (lane == 0) {
          const float alpha = expf(m_prev - base);
          s_alpha[r] = alpha;
          s_l[r] = s_l[r] * alpha + total;
          s_m[r] = m_new;
        }
      }
      __syncthreads();

      // acc = acc * correction + P @ V.
      for (int i = tid; i < rows * HD; i += kThreads) {
        const int r = i / HD;
        const int d = i % HD;
        const float* pr = s_p + r * kKeyTile;
        float a = s_acc[i] * s_alpha[r];
#pragma unroll
        for (int j = 0; j < kKeyTile; ++j) a = fmaf(pr[j], s_v[j * HD + d], a);
        s_acc[i] = a;
      }
      __syncthreads();
    }
  }

  // Rows that never saw a live key have l = 0 and acc = 0: exact zeros.
  for (int i = tid; i < rows * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i % HD;
    const int si = span_off + r / group;
    if (si >= p.span) continue;
    const int head = h * group + r % group;
    out[((size_t(b) * p.span + si) * p.num_heads + head) * HD + d] =
        from_float<T>(s_acc[i] / fmaxf(s_l[r], 1e-9f));
  }
}

// ------------------------------------------------- route 1, tensor cores
constexpr int kTcRows = 64;  // query rows per block: 4 warps x 16
constexpr int kTcKeys = 64;  // keys per staged K/V tile
constexpr float kLog2e = 1.4426950408889634f;

// 16 int8 codes from shared memory as 16 bf16 values, exactly, stored as
// two 16-byte words (dst 16-byte aligned).
__device__ __forceinline__ void widen16(__nv_bfloat16* dst, const int8_t* src) {
  const int4 raw = *reinterpret_cast<const int4*>(src);
  const int words[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t pairs[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      pairs[2 * i + j] = mma_tiles::pack_bf16(float(int8_t(words[i] >> (16 * j))),
                                              float(int8_t(words[i] >> (16 * j + 8))));
    }
  }
  uint4* out = reinterpret_cast<uint4*>(dst);
  out[0] = make_uint4(pairs[0], pairs[1], pairs[2], pairs[3]);
  out[1] = make_uint4(pairs[4], pairs[5], pairs[6], pairs[7]);
}

// 8 fp32 values from shared memory as 8 bf16 values (round to nearest
// even), stored as one 16-byte word (dst and src 16-byte aligned).
__device__ __forceinline__ void narrow8(__nv_bfloat16* dst, const float* src) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(mma_tiles::pack_bf16(a.x, a.y), mma_tiles::pack_bf16(a.z, a.w),
                 mma_tiles::pack_bf16(b.x, b.y), mma_tiles::pack_bf16(b.z, b.w));
}

// Keys of route 1's staged tile: 64, but 32 for an fp32 pool at head dim
// 256, whose ring of two 64-key fp32 K and V tiles (256 KiB) would not fit
// the 227 KiB a block can have.
__host__ __device__ constexpr int tc_keys(int head_dim, int kv) {
  return head_dim >= 256 && kv == kKvMixed ? kTcKeys / 2 : kTcKeys;
}

size_t tc_smem_bytes(int head_dim, int max_blocks, int kv) {
  // Q tile and a ring of two K and two V tiles, rows padded by 16 bytes so
  // the 8 row addresses of an ldmatrix fall in 8 distinct bank groups;
  // then the row's block table. int8 KV: one bf16 K and V tile, and a ring
  // of two int8 K and V tiles with their per-key scales. Mixed (an fp32
  // pool): one bf16 K and V tile, and a ring of two fp32 K and V tiles.
  const size_t keys = tc_keys(head_dim, kv);
  const size_t bf16_tiles = kv == kKvModel ? 4 : 2;
  size_t bytes = sizeof(__nv_bfloat16) * size_t(head_dim + 8) *
                 (kTcRows + bf16_tiles * keys);
  if (kv == kKvInt8) bytes += size_t(4) * keys * (head_dim + sizeof(float));
  if (kv == kKvMixed) bytes += size_t(4) * keys * head_dim * sizeof(float);
  return bytes + sizeof(int) * size_t(max_blocks);
}

// The element a pool of KV storage kKv holds under bf16 queries.
template <int kKv>
using BfPoolElem = typename std::conditional<
    kKv == kKvInt8, int8_t,
    typename std::conditional<kKv == kKvMixed, float, __nv_bfloat16>::type>::type;

template <int HD, int kKv>
__global__ void __launch_bounds__(kThreads)
    ragged_paged_attention_mma_kernel(const Params p) {
  using namespace mma_tiles;
  using bf16 = __nv_bfloat16;
  using KV = BfPoolElem<kKv>;
  constexpr bool kInt8 = kKv == kKvInt8;
  constexpr bool kStaged = kKv != kKvModel;  // pool rows staged, then made bf16
  constexpr int kStride = HD + 8;       // staged row, bf16 elements
  constexpr int kChunks = HD / 8;       // 16-byte chunks of a row
  constexpr int kSteps = HD / 16;       // k-steps of Q K^T
  constexpr int kOut = HD / 8;          // 8-column accumulator tiles of P V
  constexpr int kKeys = tc_keys(HD, kKv);  // keys of a staged tile
  constexpr int kKeyTiles = kKeys / 8;  // 8-key accumulator tiles of S
  constexpr int kRing = kStaged ? 1 : 2;  // bf16 K/V tiles in shared memory
  // Q's fragments stay in registers up to head dim 128. At 256 they would
  // take 64 registers a lane beside P V's 128 accumulators, past the 255 a
  // thread may have: they are read from the query tile per k-step instead.
  constexpr bool kQInRegs = HD <= 128;
  static_assert(!kInt8 || 2 * kKeys == kThreads, "one thread per int8 scale");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);  // [kTcRows][kStride]
  bf16* s_k = s_q + kTcRows * kStride;           // [kRing][kKeys][kStride]
  bf16* s_v = s_k + kRing * kKeys * kStride;   // [kRing][kKeys][kStride]
  // Staged pools (int8 codes, fp32 rows): the staged rows [2][kKeys][HD]
  // of K and of V, the int8 per-key scales [2][kKeys], then the block
  // table.
  KV* s_kr = reinterpret_cast<KV*>(s_v + kRing * kKeys * kStride);
  KV* s_vr = s_kr + (kStaged ? 2 * kKeys * HD : 0);
  float* s_ks = reinterpret_cast<float*>(s_vr + (kStaged ? 2 * kKeys * HD : 0));
  float* s_vs = s_ks + (kInt8 ? 2 * kKeys : 0);
  int* s_bt = reinterpret_cast<int*>(s_vs + (kInt8 ? 2 * kKeys : 0));  // [max_blocks]

  // The last query tiles attend the most keys: they start first, so the
  // short ones fill the card's tail.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // accumulator rows g and g + 8 of the warp
  const int t = lane % 4;  // accumulator columns 2t, 2t + 1 of each 8
  const int group = p.num_heads / p.num_kv_heads;
  const int rows = p.span_tile * group;  // row r: span r / group, head r % group
  const int span_off = qt * p.span_tile;

  const bf16* q = static_cast<const bf16*>(p.q);
  const KV* k_cache = static_cast<const KV*>(p.k_cache);
  const KV* v_cache = static_cast<const KV*>(p.v_cache);
  bf16* out = static_cast<bf16*>(p.out);

  const int ctx = p.context_lens[b];
  const int q0 = p.q_start[b];
  const int q_len = p.q_lens != nullptr ? p.q_lens[b] : p.span;
  const int win = p.window;

  // Stage the query tile (rows past the tile or the span are zeros).
  for (int i = tid; i < kTcRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const int si = span_off + r / group;
    const bool live = r < rows && si < p.span;
    const size_t off =
        live ? ((size_t(b) * p.span + si) * p.num_heads + h * group + r % group) * HD + c
             : 0;
    cp_async16(s_q + r * kStride + c, q + off, live);
  }
  cp_async_commit();

  // Keys the block can ever see: [lo, hi), as on route 0. Tiles start on
  // multiples of 64 keys (4 pages of 16).
  const int lo = win > 0 ? max(q0 + span_off - win + 1, 0) : 0;
  const int hi = min(ctx, q0 + min(q_len, span_off + p.span_tile));
  const int t_begin = lo / kKeys * kKeys;
  const int n_tiles =
      (q_len > span_off && hi > lo) ? (hi - t_begin + kKeys - 1) / kKeys : 0;

  // This lane's two rows, and the keys the warp's 16 rows can see.
  int qpos[2];
  bool row_live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + g + 8 * i;
    const int si = span_off + r / group;
    row_live[i] = r < rows && si < q_len;
    qpos[i] = q0 + si;
  }
  const int w_first = 16 * warp;
  const bool warp_live = w_first < rows && span_off + w_first / group < q_len;
  const int w_last = min(w_first + 15, rows - 1);
  // All 16 rows live; the positions of the warp's first and last rows.
  const bool warp_full = w_first + 15 < rows && span_off + (w_first + 15) / group < q_len;
  const int w_qmin = q0 + span_off + w_first / group;
  const int w_qmax = q0 + span_off + w_last / group;
  // Keys at or past w_hi lie above every live row's diagonal; keys below
  // w_lo lie outside every row's window.
  const int w_hi = q0 + min(span_off + w_last / group, q_len - 1) + 1;
  const int w_lo = win > 0 ? w_qmin - win + 1 : 0;
  const float scale_log2 = p.scale * kLog2e;

  // The pages the block reads, from the row's block table into shared
  // memory once, so that staging a tile waits on no load from device
  // memory: each key's page and slot come from shared memory (by shifts
  // when the block size is a power of two).
  if (n_tiles > 0) {
    for (int page = lo / p.block_size + tid; page <= (hi - 1) / p.block_size;
         page += kThreads) {
      s_bt[page] = p.block_tables[size_t(b) * p.max_blocks + page];
    }
  }
  __syncthreads();
  const bool pow2 = (p.block_size & (p.block_size - 1)) == 0;
  const int log2_bs = __ffs(p.block_size) - 1;

  // Each thread copies one 16-byte column c of every kKeyStride-th key of
  // a tile, starting at key j0: a fixed trip count, unrolled, so the page
  // lookups of a tile are in flight together. A 16-byte chunk is 8 bf16
  // values, 16 int8 codes or 4 fp32 values.
  constexpr int kElemsPerChunk = 16 / sizeof(KV);
  constexpr int kKvChunks = HD / kElemsPerChunk;  // 16-byte chunks of a KV row
  constexpr int kKeyStride = kThreads / kKvChunks;
  constexpr int kPerThread = kKeys / kKeyStride;
  const int j0 = tid / kKvChunks;
  const int c = (tid % kKvChunks) * kElemsPerChunk;
  const size_t page_elems = size_t(p.block_size) * p.num_kv_heads * HD;
  const int slot_elems = p.num_kv_heads * HD;
  const int head_col = h * HD + c;
  auto page_of = [&](int key) { return pow2 ? key >> log2_bs : key / p.block_size; };
  auto stage = [&](int buf, int t0) {
#pragma unroll
    for (int it = 0; it < kPerThread; ++it) {
      const int j = j0 + it * kKeyStride;
      const int key = t0 + j;
      const bool live = key >= lo && key < hi;
      size_t off = 0;
      if (live) {
        const int page = page_of(key);
        off = size_t(s_bt[page]) * page_elems + (key - page * p.block_size) * slot_elems +
              head_col;
      }
      if constexpr (kStaged) {
        cp_async16(s_kr + (buf * kKeys + j) * HD + c, k_cache + off, live);
        cp_async16(s_vr + (buf * kKeys + j) * HD + c, v_cache + off, live);
      } else {
        cp_async16(s_k + (buf * kKeys + j) * kStride + c, k_cache + off, live);
        cp_async16(s_v + (buf * kKeys + j) * kStride + c, v_cache + off, live);
      }
    }
    if constexpr (kInt8) {
      // Thread j < 64 copies key j's K scale, thread 64 + j its V scale;
      // a dead key's scale is zero-filled, never read.
      const int j = tid % kKeys;
      const int key = t0 + j;
      const bool live = key >= lo && key < hi;
      const float* src = tid < kKeys ? p.k_scale : p.v_scale;
      size_t idx = 0;
      if (live) idx = size_t(s_bt[page_of(key)]) * p.num_kv_heads + h;
      cp_async4((tid < kKeys ? s_ks : s_vs) + buf * kKeys + j, src + idx, live);
    }
  };

  uint32_t qf[kQInRegs ? kSteps : 1][4];
  float o[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of each row's sum
  const bf16* q_frag = s_q + (16 * warp + (lane & 15)) * kStride + (lane >> 4) * 8;

  if (n_tiles > 0) stage(0, t_begin);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * kKeys;
    const int buf = it & 1;
    cp_async_wait<0>();  // the query tile and tile it have landed
    __syncthreads();
    if constexpr (kStaged) {
      // Make tile it bf16 in the tile ldmatrix reads (its previous tile's
      // last read was before the closing barrier of the previous step):
      // int8 codes widen exactly, fp32 rows narrow (nearest even).
      const KV* src_k = s_kr + buf * kKeys * HD;
      const KV* src_v = s_vr + buf * kKeys * HD;
      if constexpr (kInt8) {
        for (int i = tid; i < kKeys * HD / 16; i += kThreads) {
          const int j = i / (HD / 16);
          const int col = (i % (HD / 16)) * 16;
          widen16(s_k + j * kStride + col, src_k + j * HD + col);
          widen16(s_v + j * kStride + col, src_v + j * HD + col);
        }
      } else {
        for (int i = tid; i < kKeys * HD / 8; i += kThreads) {
          const int j = i / (HD / 8);
          const int col = (i % (HD / 8)) * 8;
          narrow8(s_k + j * kStride + col, src_k + j * HD + col);
          narrow8(s_v + j * kStride + col, src_v + j * HD + col);
        }
      }
      __syncthreads();
    }
    if constexpr (kQInRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) ldmatrix_x4(qf[kk], q_frag + 16 * kk);
      }
    }
    const bool compute = warp_live && t0 < w_hi && t0 + kKeys > w_lo;
    const bf16* kt = s_k + (kStaged ? 0 : buf) * kKeys * kStride;
    const bf16* vt = s_v + (kStaged ? 0 : buf) * kKeys * kStride;
    float s[kKeyTiles][4];
    if (compute) {
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      // S = Q K^T: B[d][key] = K[key][d], two 8-key tiles per ldmatrix.
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t qa[4];
        if constexpr (kQInRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
        } else {
          ldmatrix_x4(qa, q_frag + 16 * kk);
        }
#pragma unroll
        for (int jj = 0; jj < kKeyTiles / 2; ++jj) {
          uint32_t kb[4];
          ldmatrix_x4(kb, kt + (16 * jj + (lane & 7) + ((lane >> 4) << 3)) * kStride +
                              16 * kk + ((lane >> 3) & 1) * 8);
          mma_bf16_16816(s[2 * jj], qa, kb[0], kb[1]);
          mma_bf16_16816(s[2 * jj + 1], qa, kb[2], kb[3]);
        }
      }
    }
    // Tile it + 1 is staged while the products of tile it run: its buffer
    // was last read before the previous step's closing barrier.
    if (it + 1 < n_tiles) stage(buf ^ 1, t0 + kKeys);
    cp_async_commit();
    if (compute) {
      // Scale, softcap, mask — in fp32 registers, as log2-scaled scores
      // t = s * log2(e), so p = 2^(t - m) = e^(s - m) costs one ex2. A
      // tile that lies wholly inside every row's causal and window range
      // (the bulk of a long prefill) needs no mask.
      const bool inside = warp_full && t0 + kKeys - 1 <= w_qmin && t0 + kKeys <= ctx &&
                          (win <= 0 || t0 > w_qmax - win);
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int key = t0 + 8 * j + 2 * t + (e & 1);
          float x;
          // int8 KV: the score takes K's scale of the key's page, before
          // the softcap: (q . c) * scale * k_scale.
          const float raw =
              kInt8 ? s[j][e] * p.scale * s_ks[buf * kKeys + 8 * j + 2 * t + (e & 1)]
                    : s[j][e];
          if (p.softcap > 0.f) {
            x = tanhf((kInt8 ? raw : raw * p.scale) / p.softcap) * (p.softcap * kLog2e);
          } else {
            x = kInt8 ? raw * kLog2e : raw * scale_log2;
          }
          const bool valid = inside || (row_live[i] && key < ctx && key <= qpos[i] &&
                                        (win <= 0 || key > qpos[i] - win));
          s[j][e] = valid ? x : -INFINITY;
        }
      }
      // Online softmax. A row with no live key yet rebases on 0, as on
      // route 0: 2^(-inf - 0) = 0 keeps its l and acc exactly 0.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
        const float m_new = fmaxf(m[i], quad_max(mx));
        const float base = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2_approx(m[i] - base);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j) {
          s[j][2 * i] = exp2_approx(s[j][2 * i] - base);
          s[j][2 * i + 1] = exp2_approx(s[j][2 * i + 1] - base);
          sum += s[j][2 * i] + s[j][2 * i + 1];
        }
        l[i] = l[i] * alpha + sum;
        m[i] = m_new;
#pragma unroll
        for (int n = 0; n < kOut; ++n) {
          o[n][2 * i] *= alpha;
          o[n][2 * i + 1] *= alpha;
        }
      }
      // int8 KV: l summed the unscaled p above; P V takes p * V's scale
      // of the key's page, before p is rounded to bf16.
      if constexpr (kInt8) {
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= s_vs[buf * kKeys + 8 * j + 2 * t + (e & 1)];
        }
      }
      // O += P V: the S accumulators, rounded to bf16, are P's A fragments;
      // B[key][d] = V[key][d] by ldmatrix.trans, two 8-column tiles each.
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const uint32_t a[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
        };
#pragma unroll
        for (int nn = 0; nn < kOut / 2; ++nn) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vt + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride +
                                    16 * nn + (lane >> 4) * 8);
          mma_bf16_16816(o[2 * nn], a, vb[0], vb[1]);
          mma_bf16_16816(o[2 * nn + 1], a, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // tile it's buffer is free for tile it + 2
  }
  cp_async_wait<0>();  // the query tile, when no key tile ran

  // Rows that never saw a live key have l = 0 and acc = 0: exact zeros.
  // The tile goes out through shared memory (free now), so that each
  // output row of HD values is written with 16-byte stores.
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = 1.f / fmaxf(quad_sum(l[i]), 1e-9f);
    bf16* dst = s_q + (16 * warp + g + 8 * i) * kStride + 2 * t;
#pragma unroll
    for (int n = 0; n < kOut; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    }
  }
  __syncthreads();
  for (int i = tid; i < kTcRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int col = (i % kChunks) * 8;
    const int si = span_off + r / group;
    if (r >= rows || si >= p.span) continue;
    *reinterpret_cast<uint4*>(
        out + ((size_t(b) * p.span + si) * p.num_heads + h * group + r % group) * HD + col) =
        *reinterpret_cast<const uint4*>(s_q + r * kStride + col);
  }
}

// ------------------------------------------ route 2, split-KV decode rows
constexpr int kSplitWarps = kThreads / 32;
constexpr int kWarpKeys = 16;                          // keys a warp takes of a step
constexpr int kStepKeys = kSplitWarps * kWarpKeys;     // keys a block takes a step
constexpr int kSplitStages = 3;                        // each warp's cp.async ring
constexpr int kMmaRows = 16;                           // the m16 operand's rows

// Shared memory of route 2: the query tile, the split's pages of the block
// table, then one region that holds each warp's ring during the key loop
// and the merge's scratch after it.
__host__ __device__ constexpr size_t split_q_bytes(int head_dim) {
  return sizeof(__nv_bfloat16) * kMmaRows * size_t(head_dim + 8);
}

__host__ __device__ constexpr size_t split_region_offset(int head_dim, int split_keys,
                                                         int block_size) {
  return (split_q_bytes(head_dim) + sizeof(int) * size_t(split_keys / block_size + 1) + 15) /
         16 * 16;
}

// The depth of each warp's ring: an fp32 pool's rows take twice a bf16
// ring's bytes, so its ring is two deep, and one deep at head dim 256
// (four warps' rings of two would take 256 KiB): the warp then stages the
// next step once it has made this step's rows bf16 in its own tile, so
// the copy still runs under the step's products.
__host__ __device__ constexpr int split_stages(int kv, int head_dim) {
  return kv == kKvMixed ? (head_dim >= 256 ? 1 : 2) : kSplitStages;
}

// One warp's share of the region during the key loop. bf16 pool: a ring of
// K and V rows (padded by 16 bytes for ldmatrix). int8 pool: a ring of K
// and V codes with their per-key scales, and one bf16 K and V tile the
// codes are widened into. fp32 pool (mixed): a ring of K and V rows and
// one bf16 K and V tile they are narrowed into.
__host__ __device__ constexpr size_t split_warp_bytes(int head_dim, int kv) {
  return kv == kKvModel
             ? kSplitStages * kWarpKeys * 2 * sizeof(__nv_bfloat16) * size_t(head_dim + 8)
             : split_stages(kv, head_dim) * kWarpKeys * 2 *
                       (kv == kKvInt8 ? head_dim + sizeof(float)
                                      : sizeof(float) * size_t(head_dim)) +
                   kWarpKeys * 2 * sizeof(__nv_bfloat16) * size_t(head_dim + 8);
}

size_t split_smem_bytes(int head_dim, int split_keys, int block_size, int num_splits,
                        int kv) {
  const size_t rings = kSplitWarps * split_warp_bytes(head_dim, kv);
  // After the key loop: each warp's (m, l, acc) of its 16 rows; then the
  // cross-split merge's m (then weights) and l of each (row, split).
  const size_t warps = sizeof(float) * kSplitWarps * kMmaRows * size_t(head_dim + 2);
  const size_t splits = sizeof(float) * kMmaRows * (2 * size_t(num_splits) + 1);
  return split_region_offset(head_dim, split_keys, block_size) +
         std::max(rings, std::max(warps, splits));
}

template <int HD, int kKv>
__global__ void __launch_bounds__(kThreads)
    ragged_paged_attention_split_kernel(const Params p, const SplitArgs sa) {
  using namespace mma_tiles;
  using bf16 = __nv_bfloat16;
  using KV = BfPoolElem<kKv>;
  constexpr bool kInt8 = kKv == kKvInt8;
  constexpr bool kStaged = kKv != kKvModel;            // pool rows staged, then made bf16
  constexpr int kStages = split_stages(kKv, HD);       // each warp's ring depth
  constexpr int kStride = HD + 8;                      // staged bf16 row, elements
  constexpr int kSteps = HD / 16;                      // k-steps of Q K^T
  constexpr int kOut = HD / 8;                         // 8-column tiles of P V
  constexpr int kRingRow = kStaged ? HD : kStride;     // staged pool row, elements
  constexpr int kRing = kStages * kWarpKeys * kRingRow;  // one pool's ring
  constexpr int kElemsPerChunk = 16 / sizeof(KV);
  constexpr int kKvChunks = HD / kElemsPerChunk;       // 16-byte chunks of a pool row
  constexpr int kPerLane = kWarpKeys * kKvChunks / 32;  // 16-byte copies a lane makes a step
  // Q's fragments in registers up to head dim 128; at 256 from the query
  // tile per k-step, as on route 1.
  constexpr bool kQInRegs = HD <= 128;
  static_assert(kStages > 1 || kStaged, "a one-deep ring needs the warp's own tile");

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // accumulator rows g and g + 8
  const int t = lane % 4;  // accumulator columns 2t, 2t + 1 of each 8
  const int group = p.num_heads / p.num_kv_heads;
  const int rows = p.span * group;  // row r: span r / group, head r % group

  const bf16* q = static_cast<const bf16*>(p.q);
  const KV* k_cache = static_cast<const KV*>(p.k_cache);
  const KV* v_cache = static_cast<const KV*>(p.v_cache);
  bf16* out = static_cast<bf16*>(p.out);
  auto row_offset = [&](int r) {
    return ((size_t(b) * p.span + r / group) * p.num_heads + h * group + r % group) * HD;
  };

  const int ctx = p.context_lens[b];
  const int q0 = p.q_start[b];
  const int q_len = p.q_lens != nullptr ? p.q_lens[b] : p.span;
  const int win = p.window;
  // The row's live keys [lo, hi), as on the other routes: the window floor
  // of its first query, the causal ceiling of its last valid one.
  const int lo = win > 0 ? max(q0 - win + 1, 0) : 0;
  const int hi = min(min(ctx, q0 + min(q_len, p.span)), p.max_blocks * p.block_size);
  if (q_len <= 0 || hi <= lo) {
    // No live key: split 0 writes the rows' exact zeros.
    if (split == 0) {
      for (int i = tid; i < rows * (HD / 8); i += kThreads) {
        *reinterpret_cast<uint4*>(out + row_offset(i / (HD / 8)) + (i % (HD / 8)) * 8) =
            make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }
  // The splits that hold live keys; the others have nothing to do.
  const int first = lo / sa.split_keys;
  const int last = (hi - 1) / sa.split_keys;
  if (split < first || split > last) return;
  const int k_begin = max(lo, split * sa.split_keys);
  const int k_end = min(hi, (split + 1) * sa.split_keys);
  const int base = k_begin / kStepKeys * kStepKeys;  // steps start on 64-key lines
  const int n_steps = (k_end - base + kStepKeys - 1) / kStepKeys;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);  // [kMmaRows][kStride]
  int* s_bt = reinterpret_cast<int*>(smem_raw + split_q_bytes(HD));
  unsigned char* region = smem_raw + split_region_offset(HD, sa.split_keys, p.block_size);
  unsigned char* mine = region + warp * split_warp_bytes(HD, kKv);
  KV* r_k = reinterpret_cast<KV*>(mine);  // [kStages][kWarpKeys][kRingRow]
  KV* r_v = r_k + kRing;
  float* r_ks = reinterpret_cast<float*>(r_v + kRing);  // int8: [kStages][kWarpKeys]
  float* r_vs = r_ks + (kInt8 ? kStages * kWarpKeys : 0);
  bf16* w_k = reinterpret_cast<bf16*>(r_vs + (kInt8 ? kStages * kWarpKeys : 0));  // [kWarpKeys][kStride]
  bf16* w_v = w_k + kWarpKeys * kStride;

  // The query tile, padded with zero rows to the m16 operand, and the pages
  // of the block's keys from the row's block table, so that staging a key
  // waits on no load from device memory.
  for (int i = tid; i < kMmaRows * (HD / 8); i += kThreads) {
    const int r = i / (HD / 8);
    const int c = (i % (HD / 8)) * 8;
    const bool live = r < rows;
    cp_async16(s_q + r * kStride + c, q + (live ? row_offset(r) + c : 0), live);
  }
  cp_async_commit();
  const int page0 = base / p.block_size;
  for (int page = page0 + tid; page <= (k_end - 1) / p.block_size; page += kThreads) {
    s_bt[page - page0] = p.block_tables[size_t(b) * p.max_blocks + page];
  }
  cp_async_wait<0>();
  __syncthreads();
  const bf16* q_frag = s_q + (lane & 15) * kStride + (lane >> 4) * 8;
  uint32_t qf[kQInRegs ? kSteps : 1][4];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) ldmatrix_x4(qf[kk], q_frag + 16 * kk);
  }

  // Warp w takes keys 16w .. 16w + 15 of every 64-key step, through a ring
  // of its own: it stages, waits and computes with no block barrier. The
  // warp's 16 keys x kKvChunks 16-byte chunks are copied by its lanes in
  // turn, chunk i = lane + 32 * it being key i / kKvChunks, column i %
  // kKvChunks (below 32 chunks a row, each lane keeps one column). A key
  // outside [k_begin, k_end) reads nothing: the copy zero-fills it (and its
  // int8 scales), and the mask drops it.
  const bool pow2 = (p.block_size & (p.block_size - 1)) == 0;
  const int log2_bs = __ffs(p.block_size) - 1;
  auto page_of = [&](int key) { return pow2 ? key >> log2_bs : key / p.block_size; };
  const size_t page_elems = size_t(p.block_size) * p.num_kv_heads * HD;
  const int slot_elems = p.num_kv_heads * HD;
  auto slice_key0 = [&](int step) { return base + step * kStepKeys + warp * kWarpKeys; };
  auto slice_live = [&](int key0) { return key0 < k_end && key0 + kWarpKeys > k_begin; };
  auto stage = [&](int step) {
    const int key0 = slice_key0(step);
    if (!slice_live(key0)) return;
    const int buf = step % kStages;
#pragma unroll
    for (int it = 0; it < kPerLane; ++it) {
      const int j = (lane + 32 * it) / kKvChunks;
      const int c = (lane + 32 * it) % kKvChunks * kElemsPerChunk;
      const int key = key0 + j;
      const bool live = key >= k_begin && key < k_end;
      size_t off = 0;
      if (live) {
        const int page = page_of(key);
        off = size_t(s_bt[page - page0]) * page_elems + (key - page * p.block_size) * slot_elems +
              h * HD + c;
      }
      cp_async16(r_k + (buf * kWarpKeys + j) * kRingRow + c, k_cache + off, live);
      cp_async16(r_v + (buf * kWarpKeys + j) * kRingRow + c, v_cache + off, live);
    }
    if constexpr (kInt8) {
      // Lane j < 16 copies key j's K scale, lane 16 + j its V scale.
      const int j = lane % kWarpKeys;
      const int key = key0 + j;
      const bool live = key >= k_begin && key < k_end;
      const size_t idx = live ? size_t(s_bt[page_of(key) - page0]) * p.num_kv_heads + h : 0;
      cp_async4((lane < kWarpKeys ? r_ks : r_vs) + buf * kWarpKeys + j,
                (lane < kWarpKeys ? p.k_scale : p.v_scale) + idx, live);
    }
  };

  // This lane's two rows of the padded tile: g and g + 8.
  int qpos[2];
  bool row_live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;
    row_live[i] = r < rows && r / group < q_len;
    qpos[i] = q0 + r / group;
  }
  const float scale_log2 = p.scale * kLog2e;
  float o[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of each row's sum

  if constexpr (kStages == 1) {
    if (n_steps > 0) stage(0);
    cp_async_commit();
  } else {
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < n_steps) stage(st);
      cp_async_commit();
    }
  }
  for (int step = 0; step < n_steps; ++step) {
    // This lane's copies of the step have landed; after the warp's barrier
    // every lane's have, and the buffer staged next was last read a step
    // ago (a one-deep ring stages the next step further down).
    if constexpr (kStages == 1) {
      cp_async_wait<0>();
      __syncwarp();
    } else {
      cp_async_wait<kStages - 2>();
      __syncwarp();
      if (step + kStages - 1 < n_steps) stage(step + kStages - 1);
      cp_async_commit();
    }
    const int key0 = slice_key0(step);
    const bool live_slice = slice_live(key0);
    const int buf = step % kStages;
    const bf16* kt;
    const bf16* vt;
    if constexpr (kStaged) {
      // Make the step's rows bf16 in the warp's tile: int8 codes widen
      // exactly, fp32 rows narrow (nearest even). (The tile's previous
      // read, a step ago, came before this step's warp barrier.)
      if (live_slice) {
        if constexpr (kInt8) {
          for (int i = lane; i < kWarpKeys * (HD / 16); i += 32) {
            const int j = i / (HD / 16);
            const int col = (i % (HD / 16)) * 16;
            widen16(w_k + j * kStride + col, r_k + (buf * kWarpKeys + j) * HD + col);
            widen16(w_v + j * kStride + col, r_v + (buf * kWarpKeys + j) * HD + col);
          }
        } else {
          for (int i = lane; i < kWarpKeys * (HD / 8); i += 32) {
            const int j = i / (HD / 8);
            const int col = (i % (HD / 8)) * 8;
            narrow8(w_k + j * kStride + col, r_k + (buf * kWarpKeys + j) * HD + col);
            narrow8(w_v + j * kStride + col, r_v + (buf * kWarpKeys + j) * HD + col);
          }
        }
      }
      __syncwarp();
      if constexpr (kStages == 1) {
        // Every lane has read the ring: the next step's copies go in now.
        if (step + 1 < n_steps) stage(step + 1);
        cp_async_commit();
      }
      kt = w_k;
      vt = w_v;
    } else {
      kt = r_k + buf * kWarpKeys * kStride;
      vt = r_v + buf * kWarpKeys * kStride;
    }
    if (!live_slice) continue;
    // S = Q K^T over the warp's 16 keys: two 8-key accumulator tiles.
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t qa[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        ldmatrix_x4(qa, q_frag + 16 * kk);
      }
      uint32_t kb[4];
      ldmatrix_x4(kb, kt + ((lane & 7) + ((lane >> 4) << 3)) * kStride + 16 * kk +
                          ((lane >> 3) & 1) * 8);
      mma_bf16_16816(s[0], qa, kb[0], kb[1]);
      mma_bf16_16816(s[1], qa, kb[2], kb[3]);
    }
    // Scale, softcap and mask in fp32, as log2-scaled scores, in route 1's
    // order (int8: K's scale of the key's page on the score, before the
    // softcap).
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int jj = 8 * j + 2 * t + (e & 1);
        const int key = key0 + jj;
        const float raw = kInt8 ? s[j][e] * p.scale * r_ks[buf * kWarpKeys + jj] : s[j][e];
        float x;
        if (p.softcap > 0.f) {
          x = tanhf((kInt8 ? raw : raw * p.scale) / p.softcap) * (p.softcap * kLog2e);
        } else {
          x = kInt8 ? raw * kLog2e : raw * scale_log2;
        }
        const bool valid = row_live[i] && key >= k_begin && key < k_end && key <= qpos[i] &&
                           (win <= 0 || key > qpos[i] - win);
        s[j][e] = valid ? x : -INFINITY;
      }
    }
    // Online softmax over the warp's keys. A row with no live key yet
    // rebases on 0, so its l and acc stay exactly 0.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mx = fmaxf(fmaxf(s[0][2 * i], s[0][2 * i + 1]),
                             fmaxf(s[1][2 * i], s[1][2 * i + 1]));
      const float m_new = fmaxf(m[i], quad_max(mx));
      const float rebase = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2_approx(m[i] - rebase);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[j][2 * i] = exp2_approx(s[j][2 * i] - rebase);
        s[j][2 * i + 1] = exp2_approx(s[j][2 * i + 1] - rebase);
        sum += s[j][2 * i] + s[j][2 * i + 1];
      }
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < kOut; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
    }
    // int8: l summed the unscaled p; P V takes p * V's page scale, before
    // p is rounded to bf16.
    if constexpr (kInt8) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= r_vs[buf * kWarpKeys + 8 * j + 2 * t + (e & 1)];
      }
    }
    // O += P V: the unnormalised p, rounded to bf16, is the A fragment of
    // one 16-key k-step; V by ldmatrix.trans, two 8-column tiles each.
    const uint32_t a[4] = {
        pack_bf16(s[0][0], s[0][1]),
        pack_bf16(s[0][2], s[0][3]),
        pack_bf16(s[1][0], s[1][1]),
        pack_bf16(s[1][2], s[1][3]),
    };
#pragma unroll
    for (int nn = 0; nn < kOut / 2; ++nn) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * kStride + 16 * nn +
                                (lane >> 4) * 8);
      mma_bf16_16816(o[2 * nn], a, vb[0], vb[1]);
      mma_bf16_16816(o[2 * nn + 1], a, vb[2], vb[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every ring is drained: the region is the merge's now

  // The block's warps merge in warp order, through shared memory.
  float* w_o = reinterpret_cast<float*>(region);  // [kSplitWarps][kMmaRows][HD]
  float* w_m = w_o + kSplitWarps * kMmaRows * HD;  // [kSplitWarps][kMmaRows]
  float* w_l = w_m + kSplitWarps * kMmaRows;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;
    const float total = quad_sum(l[i]);
    if (t == 0) {
      w_m[warp * kMmaRows + r] = m[i];
      w_l[warp * kMmaRows + r] = total;
    }
#pragma unroll
    for (int n = 0; n < kOut; ++n) {
      *reinterpret_cast<float2*>(w_o + (warp * kMmaRows + r) * HD + 8 * n + 2 * t) =
          make_float2(o[n][2 * i], o[n][2 * i + 1]);
    }
  }
  __syncthreads();
  // With one live split the block writes the rows; else its partial (each
  // row's m, l and acc, fp32) goes to the workspace.
  const bool alone = first == last;
  const size_t part0 = (size_t(b) * p.num_kv_heads + h) * sa.num_splits;  // (row, head)'s split 0
  float* ws_acc = sa.workspace;  // [B][Nkv][num_splits][rows][HD]
  float2* ws_ml = reinterpret_cast<float2*>(  // [B][Nkv][num_splits][rows]
      sa.workspace + size_t(gridDim.z) * p.num_kv_heads * sa.num_splits * rows * HD);
  for (int i = tid; i < rows * (HD / 2); i += kThreads) {
    const int r = i / (HD / 2);
    const int d = (i % (HD / 2)) * 2;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) mx = fmaxf(mx, w_m[w * kMmaRows + r]);
    const float rebase = mx == -INFINITY ? 0.f : mx;
    float total = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float wt = exp2_approx(w_m[w * kMmaRows + r] - rebase);
      const float2 acc = *reinterpret_cast<const float2*>(w_o + (w * kMmaRows + r) * HD + d);
      total += wt * w_l[w * kMmaRows + r];
      a0 += wt * acc.x;
      a1 += wt * acc.y;
    }
    if (alone) {
      const float inv = 1.f / fmaxf(total, 1e-9f);
      *reinterpret_cast<__nv_bfloat162*>(out + row_offset(r) + d) =
          __floats2bfloat162_rn(a0 * inv, a1 * inv);
    } else {
      const size_t rec = (part0 + split) * rows + r;
      *reinterpret_cast<float2*>(ws_acc + rec * HD + d) = make_float2(a0, a1);
      if (d == 0) ws_ml[rec] = make_float2(mx, total);
    }
  }
  if (alone) return;

  // The last of the row's live splits to finish (an atomic ticket, taken
  // after each block's writes are fenced) merges the partials in split
  // order, the same order every launch, so the result is bitwise
  // reproducible; it puts the ticket back to 0 for the next launch.
  // (The flag lives in the query tile, read last before the key loop: a
  // static __shared__ would not fit beside a launch that opts in to the
  // whole dynamic limit.)
  int* s_merges = reinterpret_cast<int*>(s_q);
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(sa.tickets + size_t(b) * p.num_kv_heads + h, 1);
    *s_merges = ticket == last - first;
  }
  __syncthreads();
  if (!*s_merges) return;
  __threadfence();
  const int n_live = last - first + 1;
  float* x_m = reinterpret_cast<float*>(region);  // [rows][n_live]: m, then weights
  float* x_l = x_m + rows * n_live;               // [rows][n_live]
  float* x_inv = x_l + rows * n_live;             // [rows]
  for (int i = tid; i < rows * n_live; i += kThreads) {
    const int r = i / n_live;
    const float2 ml = __ldcg(ws_ml + (part0 + first + i % n_live) * rows + r);
    x_m[i] = ml.x;
    x_l[i] = ml.y;
  }
  __syncthreads();
  for (int r = tid; r < rows; r += kThreads) {
    float mx = -INFINITY;
    for (int sp = 0; sp < n_live; ++sp) mx = fmaxf(mx, x_m[r * n_live + sp]);
    const float rebase = mx == -INFINITY ? 0.f : mx;
    float total = 0.f;
    for (int sp = 0; sp < n_live; ++sp) {
      const float wt = exp2_approx(x_m[r * n_live + sp] - rebase);
      x_m[r * n_live + sp] = wt;
      total += wt * x_l[r * n_live + sp];
    }
    x_inv[r] = 1.f / fmaxf(total, 1e-9f);
  }
  __syncthreads();
  for (int i = tid; i < rows * (HD / 2); i += kThreads) {
    const int r = i / (HD / 2);
    const int d = (i % (HD / 2)) * 2;
    float a0 = 0.f, a1 = 0.f;
    for (int sp = 0; sp < n_live; ++sp) {
      const float wt = x_m[r * n_live + sp];
      const float2 acc = __ldcg(
          reinterpret_cast<const float2*>(ws_acc + ((part0 + first + sp) * rows + r) * HD + d));
      a0 += wt * acc.x;
      a1 += wt * acc.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(out + row_offset(r) + d) =
        __floats2bfloat162_rn(a0 * x_inv[r], a1 * x_inv[r]);
  }
  if (tid == 0) sa.tickets[size_t(b) * p.num_kv_heads + h] = 0;
}

template <int HD, int kKv>
int launch_split(const Params& p, const SplitArgs& sa, int batch, cudaStream_t stream) {
  const size_t smem = split_smem_bytes(HD, sa.split_keys, p.block_size, sa.num_splits, kKv);
  auto kernel = ragged_paged_attention_split_kernel<HD, kKv>;
  if (const int fits = check_shared_memory(smem)) return fits;
  static std::atomic<bool> opted_in[mma_tiles::kMaxDevices];
  const cudaError_t err = mma_tiles::opt_in_shared_memory(
      reinterpret_cast<const void*>(kernel), smem, opted_in);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(sa.num_splits, p.num_kv_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(p, sa);
  return int(cudaGetLastError());
}

template <typename T, typename KV, int HD>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const int group = p.num_heads / p.num_kv_heads;
  const int rows = p.span_tile * group;
  const size_t smem = smem_bytes(rows, HD);
  auto kernel = ragged_paged_attention_kernel<T, KV, HD>;
  if (const int fits = check_shared_memory(smem)) return fits;
  static std::atomic<bool> opted_in[mma_tiles::kMaxDevices];
  const cudaError_t err = mma_tiles::opt_in_shared_memory(
      reinterpret_cast<const void*>(kernel), smem, opted_in);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((p.span + p.span_tile - 1) / p.span_tile, p.num_kv_heads,
                  batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <int HD, int kKv>
int launch_mma(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(HD, p.max_blocks, kKv);
  auto kernel = ragged_paged_attention_mma_kernel<HD, kKv>;
  if (const int fits = check_shared_memory(smem)) return fits;
  static std::atomic<bool> opted_in[mma_tiles::kMaxDevices];
  const cudaError_t err = mma_tiles::opt_in_shared_memory(
      reinterpret_cast<const void*>(kernel), smem, opted_in);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((p.span + p.span_tile - 1) / p.span_tile, p.num_kv_heads,
                  batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

// ------------------------------------------ route 3, wgmma + TMA (Hopper)
namespace wg {
using namespace hopper_attn;
using namespace mma_tiles;
using bf16 = __nv_bfloat16;

constexpr int kRows = 128;  // query rows of a block: two consumer warpgroups of 64
constexpr int kPage = 16;   // the block size the route takes
constexpr int kCW = 64;     // columns of a TMA box: one 128-byte swizzled row
constexpr int kSwz = 128;
constexpr int kBoxBytes = kPage * kSwz;  // one page of one 64-column chunk

// Keys of a staged tile: 64, four pages (the scores and P take 48
// registers a thread beside O); 32 at head dim 256, where O alone takes
// 128 registers a thread (64-key tiles spill 732 bytes there, 32-key
// ones 284).
__host__ __device__ constexpr int tile_keys(int head_dim) { return head_dim >= 256 ? 32 : 64; }

// Each ring (K tiles, V tiles) is six tiles deep at head dim 64 and four
// at 128 and 256 (the Q tile and eight 16 KiB tiles take 192 KiB there).
__host__ __device__ constexpr int stages(int head_dim) { return head_dim >= 128 ? 4 : 6; }

size_t smem_bytes(int head_dim, int max_blocks) {
  return 1024 + size_t(kRows) * head_dim * 2 +
         size_t(2 * stages(head_dim)) * tile_keys(head_dim) * head_dim * 2 +
         sizeof(uint64_t) * (4 * stages(head_dim) + 1) + sizeof(int) * size_t(max_blocks);
}

// tanh(x) = sign(x) (1 - 2 / (e^(2|x|) + 1)): one ex2 and one rcp on the
// special-function unit, within ~2^-22 of tanh (libm's tanhf is a long
// instruction sequence per score).
__device__ __forceinline__ float tanh_fast(float x) {
  const float e = exp2_approx(2.f * kLog2e * fabsf(x));
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(e + 1.f));
  return copysignf(1.f - 2.f * r, x);
}

template <int HD>
__global__ void __launch_bounds__(kBlockThreads, 1)
    ragged_paged_attention_wgmma_kernel(const Params p, const __grid_constant__ CUtensorMap map_q,
                                        const __grid_constant__ CUtensorMap map_k,
                                        const __grid_constant__ CUtensorMap map_v) {
  constexpr int kStages = stages(HD);
  constexpr int kKeys = tile_keys(HD);
  constexpr int kChunks = HD / kCW;
  constexpr int kTileBytes = kKeys * HD * 2;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* s_q = align_1024(smem_raw);         // [chunk][kRows][kSwz], rows (span, group)
  uint8_t* s_k = s_q + kRows * HD * 2;         // [stage][chunk][kKeys][kSwz]
  uint8_t* s_v = s_k + kStages * kTileBytes;   // [stage][chunk][kKeys][kSwz]
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_v + kStages * kTileBytes);
  const Ring k_ring{bars, bars + kStages, kStages};
  const Ring v_ring{bars + 2 * kStages, bars + 3 * kStages, kStages};
  uint64_t* q_full = bars + 4 * kStages;
  int* s_bt = reinterpret_cast<int*>(q_full + 1);  // [max_blocks]

  // The last query tiles attend the most keys: they start first.
  const int qt = int(gridDim.x - blockIdx.x) - 1;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int group = p.num_heads / p.num_kv_heads;
  const int rows = p.span_tile * group;  // row r: span r / group, head r % group
  const int span_off = qt * p.span_tile;
  // The row's lengths, warp-uniform as the compiler sees it (every branch
  // on a value it cannot prove uniform is divergent, and wgmma in flight
  // across a divergent branch is serialized).
  const int ctx = __shfl_sync(0xffffffffu, p.context_lens[b], 0);
  const int q0 = __shfl_sync(0xffffffffu, p.q_start[b], 0);
  const int q_len = __shfl_sync(0xffffffffu, p.q_lens != nullptr ? p.q_lens[b] : p.span, 0);
  const int win = p.window;
  // Keys the block can ever see: [lo, hi), as on routes 0 and 1.
  const int lo = win > 0 ? max(q0 + span_off - win + 1, 0) : 0;
  const int hi = min(ctx, q0 + min(q_len, span_off + p.span_tile));
  const int t_begin = lo / kKeys * kKeys;
  const int n_tiles =
      (q_len > span_off && hi > lo) ? (hi - t_begin + kKeys - 1) / kKeys : 0;

  if (tid == 0) {
    k_ring.init();
    v_ring.init();
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  if (n_tiles > 0) {
    for (int page = lo / kPage + tid; page <= (hi - 1) / kPage; page += kBlockThreads) {
      s_bt[page] = p.block_tables[size_t(b) * p.max_blocks + page];
    }
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // The producer: the query tile as one box per 64 columns over (span
    // positions, the group's heads), which is the interleaved row order;
    // then each tile's pages that hold a key of [lo, hi), one box a page
    // and 64 columns, of K and of V. A page wholly outside is not loaded.
    release_registers<kProducerRegs>();
    if (tid == kConsumerThreads) {
      PHASES_BEGIN();
      prefetch_tensormap(&map_q);
      prefetch_tensormap(&map_k);
      prefetch_tensormap(&map_v);
      mbar_expect_tx(q_full, kChunks * rows * kSwz);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        tma_load_4d(s_q + c * kRows * kSwz, &map_q, c * kCW, h * group, span_off, b, q_full);
      }
      // One ring slot: the tile's live pages (page0..page1), one box a page
      // and 64 columns.
      auto load = [&](const Ring& ring, uint8_t* tiles, const CUtensorMap* map, int it, int t0,
                      int page0, int page1) {
        uint64_t* bar = ring.acquire(it, (page1 - page0 + 1) * kChunks * kBoxBytes);
        PHASE(11);
        uint8_t* tile = tiles + ring.stage(it) * kTileBytes + (page0 * kPage - t0) * kSwz;
        for (int page = page0; page <= page1; ++page, tile += kBoxBytes) {
          const int blk = s_bt[page];
#pragma unroll 1
          for (int c = 0; c < kChunks; ++c) {
            tma_load_4d(tile + c * kKeys * kSwz, map, c * kCW, h, 0, blk, bar);
          }
        }
        PHASE(12);
      };
      for (int it = 0; it < n_tiles; ++it) {
        const int t0 = t_begin + it * kKeys;
        const int page0 = max(t0, lo) / kPage;
        const int page1 = (min(t0 + kKeys, hi) - 1) / kPage;
        load(k_ring, s_k, &map_k, it, t0, page0, page1);
        load(v_ring, s_v, &map_v, it, t0, page0, page1);
      }
      PHASES_END();
    }
  } else {
    claim_registers<kConsumerRegs>();
    PHASES_BEGIN();
    const int ct = tid;
    const int warp = __shfl_sync(0xffffffffu, ct / 32, 0);  // rows 16 warp .. + 15
    const int w = warp / 4;    // consumer warpgroup: rows 64w .. 64w + 63
    const int lane = tid % 32;
    const int g = lane / 4;    // accumulator rows g and g + 8 of the warp
    const int t = lane % 4;    // accumulator columns 2t, 2t + 1 of each 8
    const int wt = ct % 128;   // thread of the warpgroup

    int qpos[2];
    bool row_live[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * warp + g + 8 * i;
      const int si = span_off + r / group;
      row_live[i] = r < rows && si < q_len;
      qpos[i] = q0 + si;
    }
    // The warpgroup's tiles: keys at or past g_hi lie above every live
    // row's diagonal, below g_lo outside every row's window.
    const int g_first = 64 * w;
    const int g_last = min(g_first + 63, rows - 1);
    const bool group_live = g_first < rows && span_off + g_first / group < q_len;
    const int g_hi = q0 + min(span_off + g_last / group, q_len - 1) + 1;
    const int g_lo = win > 0 ? q0 + span_off + g_first / group - win + 1 : 0;
    // The warp's 16 rows, for tiles that need no mask (route 1's test).
    const int w_first = 16 * warp;
    const int w_last = min(w_first + 15, rows - 1);
    const bool warp_full = w_first + 15 < rows && span_off + (w_first + 15) / group < q_len;
    const int w_qmin = q0 + span_off + w_first / group;
    const int w_qmax = q0 + span_off + w_last / group;
    const bool capped = p.softcap > 0.f;
    const float scale_log2 = p.scale * kLog2e;
    const float scale_over_cap = capped ? p.scale / p.softcap : 0.f;
    const float cap_log2 = p.softcap * kLog2e;
    const uint8_t* q_rows = s_q + w * 64 * kSwz;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};      // this lane's share of each row's sum
    float alpha[2] = {1.f, 1.f};  // O's rescale before the next P V
    float s[kKeys / 2];
    uint32_t pa[kKeys / 16][4];

    // The tiles the warpgroup computes, [c0, c1): keys at or past g_hi lie
    // above every live row's diagonal, keys below g_lo outside every row's
    // window. The others are only let go.
    int c0 = n_tiles, c1 = n_tiles;
    if (group_live) {
      c0 = 0;
      while (c0 < n_tiles && t_begin + (c0 + 1) * kKeys <= g_lo) ++c0;
      c1 = c0;
      while (c1 < n_tiles && t_begin + c1 * kKeys < g_hi) ++c1;
    }
    auto let_go = [&](int it) {
      k_ring.wait(it);
      k_ring.release(it);
      v_ring.wait(it);
      v_ring.release(it);
    };
    // V of tile `it` landed, with its rows outside [lo, hi) (never loaded,
    // or past the context or below the window on a live page) zeroed by
    // this warpgroup, so that 0 x NaN never reaches O; then O rescaled.
    auto ready_v = [&](int it) {
      v_ring.wait(it);
      const int t0 = t_begin + it * kKeys;
      if (t0 < lo || t0 + kKeys > hi) {
        uint8_t* vt = s_v + v_ring.stage(it) * kTileBytes;
#pragma unroll
        for (int k = 0; k < kKeys * kChunks * (kSwz / 16) / 128; ++k) {
          const int i = wt + 128 * k;
          const int j = i / (kChunks * (kSwz / 16));
          const int rem = i % (kChunks * (kSwz / 16));
          if (t0 + j < lo || t0 + j >= hi) {
            *reinterpret_cast<uint4*>(vt + (rem / (kSwz / 16)) * kKeys * kSwz + j * kSwz +
                                      16 * (rem % (kSwz / 16))) = make_uint4(0, 0, 0, 0);
          }
        }
        fence_proxy_async();
        warpgroup_sync(w);
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }
    };
    // Scale, softcap, mask (as on route 1, log2-scaled scores; a tile wholly
    // inside every row's causal and window range needs no mask), then the
    // online softmax: a row with no live key yet rebases on 0; p stays
    // unnormalised and l sums it before it is rounded. Leaves P in pa and
    // O's rescale in alpha.
    auto softmax = [&](int it) {
      const int t0 = t_begin + it * kKeys;
      const bool inside = warp_full && t0 + kKeys - 1 <= w_qmin && t0 + kKeys <= ctx &&
                          (win <= 0 || t0 > w_qmax - win);
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int key = t0 + 8 * j + 2 * t + (e & 1);
          const float x = capped ? tanh_fast(s[4 * j + e] * scale_over_cap) * cap_log2
                                 : s[4 * j + e] * scale_log2;
          const bool valid = inside || (row_live[i] && key < ctx && key <= qpos[i] &&
                                        (win <= 0 || key > qpos[i] - win));
          s[4 * j + e] = valid ? x : -INFINITY;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], row_max<kKeys>(s, i));
        const float base = m_new == -INFINITY ? 0.f : m_new;
        alpha[i] = exp2_approx(m[i] - base);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
          s[4 * j + 2 * i] = exp2_approx(s[4 * j + 2 * i] - base);
          s[4 * j + 2 * i + 1] = exp2_approx(s[4 * j + 2 * i + 1] - base);
          sum += s[4 * j + 2 * i] + s[4 * j + 2 * i + 1];
        }
        l[i] = l[i] * alpha[i] + sum;
        m[i] = m_new;
      }
    };

    mbar_wait(q_full, 0);
    PHASE(0);
    for (int it = 0; it < c0; ++it) let_go(it);
    PHASE(7);
    if constexpr (HD >= 256) {
      // O takes 128 registers a thread: the scores and P of one tile at a
      // time, its products serial (the other warpgroup's run meanwhile).
      for (int it = c0; it < c1; ++it) {
        k_ring.wait(it);
        PHASE(1);
        wgmma_fence();
        issue_qk<HD, kKeys, kSwz>(s, q_rows, kRows * kSwz, s_k + k_ring.stage(it) * kTileBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(s);
        PHASE(3);
        k_ring.release(it);
        softmax(it);
        PHASE(4);
        ready_v(it);
        pack_p<kKeys>(pa, s);
        PHASE(2);
        wgmma_fence();
        issue_pv<HD, kKeys, kSwz>(o, pa, s_v + v_ring.stage(it) * kTileBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(o);
        PHASE(5);
        v_ring.release(it);
      }
    } else if (c0 < c1) {
      // Tile c0 alone; then each step issues tile it's Q K^T and tile
      // it - 1's P V together, and P V runs while tile it's softmax does.
      k_ring.wait(c0);
      wgmma_fence();
      issue_qk<HD, kKeys, kSwz>(s, q_rows, kRows * kSwz, s_k + k_ring.stage(c0) * kTileBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(s);
      k_ring.release(c0);
      softmax(c0);
      pack_p<kKeys>(pa, s);
      PHASE(8);
      for (int it = c0 + 1; it < c1; ++it) {
        k_ring.wait(it);
        PHASE(1);
        ready_v(it - 1);
        PHASE(2);
        wgmma_fence();
        issue_qk<HD, kKeys, kSwz>(s, q_rows, kRows * kSwz, s_k + k_ring.stage(it) * kTileBytes);
        wgmma_commit();
        issue_pv<HD, kKeys, kSwz>(o, pa, s_v + v_ring.stage(it - 1) * kTileBytes);
        wgmma_commit();
        wgmma_wait<1>();
        fence_operands(s);
        PHASE(3);
        k_ring.release(it);
        softmax(it);
        PHASE(4);
        wgmma_wait<0>();
        fence_operands(o);
        PHASE(5);
        v_ring.release(it - 1);
        pack_p<kKeys>(pa, s);
        PHASE(6);
      }
      ready_v(c1 - 1);
      wgmma_fence();
      issue_pv<HD, kKeys, kSwz>(o, pa, s_v + v_ring.stage(c1 - 1) * kTileBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(o);
      v_ring.release(c1 - 1);
    }
    for (int it = c1; it < n_tiles; ++it) let_go(it);
    PHASE(7);

    // Rows that never saw a live key have l = 0 and o = 0: exact zeros.
    bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float inv = 1.f / fmaxf(quad_sum(l[i]), 1e-9f);
      const int r = 16 * warp + g + 8 * i;
      const int si = span_off + r / group;
      if (r >= rows || si >= p.span) continue;
      bf16* dst = out + ((size_t(b) * p.span + si) * p.num_heads + h * group + r % group) * HD +
                  2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
      }
    }
    PHASE(8);
    PHASES_END();
  }
}

// q as a 4-D tensor map [B, S, Nh, Hd] (boxes of 64 columns x the group's
// heads x span_tile positions), the pools as [num_blocks, 16, Nkv, Hd]
// (boxes of one page of one KV head); out-of-bounds positions read as
// zeros. Then the grid (query tiles, KV heads, rows).
template <int HD>
int launch(const Params& p, int num_blocks, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(HD, p.max_blocks);
  auto kernel = ragged_paged_attention_wgmma_kernel<HD>;
  if (const int fits = check_shared_memory(smem)) return fits;
  static std::atomic<bool> opted_in[mma_tiles::kMaxDevices];
  const cudaError_t err = mma_tiles::opt_in_shared_memory(
      reinterpret_cast<const void*>(kernel), smem, opted_in);
  if (err != cudaSuccess) return int(err);
  const int group = p.num_heads / p.num_kv_heads;
  const cuuint64_t q_dims[4] = {HD, cuuint64_t(p.num_heads), cuuint64_t(p.span),
                                cuuint64_t(batch)};
  const cuuint64_t q_strides[3] = {cuuint64_t(HD) * 2, cuuint64_t(p.num_heads) * HD * 2,
                                   cuuint64_t(p.span) * p.num_heads * HD * 2};
  const cuuint32_t q_box[4] = {kCW, cuuint32_t(group), cuuint32_t(p.span_tile), 1};
  const cuuint64_t kv_dims[4] = {HD, cuuint64_t(p.num_kv_heads), kPage, cuuint64_t(num_blocks)};
  const cuuint64_t kv_strides[3] = {cuuint64_t(HD) * 2, cuuint64_t(p.num_kv_heads) * HD * 2,
                                    cuuint64_t(kPage) * p.num_kv_heads * HD * 2};
  const cuuint32_t kv_box[4] = {kCW, 1, kPage, 1};
  CUtensorMap map_q, map_k, map_v;
  if (!encode_bf16_map(&map_q, p.q, 4, q_dims, q_strides, q_box, kSwz) ||
      !encode_bf16_map(&map_k, p.k_cache, 4, kv_dims, kv_strides, kv_box, kSwz) ||
      !encode_bf16_map(&map_v, p.v_cache, 4, kv_dims, kv_strides, kv_box, kSwz)) {
    return int(cudaErrorInvalidValue);
  }
  const dim3 grid((p.span + p.span_tile - 1) / p.span_tile, p.num_kv_heads, batch);
  kernel<<<grid, kBlockThreads, smem, stream>>>(p, map_q, map_k, map_v);
  return int(cudaGetLastError());
}

}  // namespace wg

// Routes 1 and 2 (bf16 q) and route 0 at one head dim, by KV storage.
template <int HD>
int launch_route(int route, int dtype, int kv, const Params& p, const SplitArgs& sa,
                         int batch, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (route == 2) {
    return kv == kKvInt8    ? launch_split<HD, kKvInt8>(p, sa, batch, s)
           : kv == kKvMixed ? launch_split<HD, kKvMixed>(p, sa, batch, s)
                            : launch_split<HD, kKvModel>(p, sa, batch, s);
  }
  if (route == 1) {
    return kv == kKvInt8    ? launch_mma<HD, kKvInt8>(p, batch, s)
           : kv == kKvMixed ? launch_mma<HD, kKvMixed>(p, batch, s)
                            : launch_mma<HD, kKvModel>(p, batch, s);
  }
  if (dtype == 0) {
    return kv == kKvInt8    ? launch<float, int8_t, HD>(p, batch, s)
           : kv == kKvMixed ? launch<float, bf16, HD>(p, batch, s)
                            : launch<float, float, HD>(p, batch, s);
  }
  return kv == kKvInt8    ? launch<bf16, int8_t, HD>(p, batch, s)
         : kv == kKvMixed ? launch<bf16, float, HD>(p, batch, s)
                          : launch<bf16, bf16, HD>(p, batch, s);
}

}  // namespace

extern "C" {

// Head dims 64, 128 and 256 on every route and KV storage.
// dtype: 0 = float32, 1 = bfloat16 (queries and output share it). kv_dtype:
// 0 = the pool holds q's dtype (k_scale / v_scale unused), 1 = int8 codes
// with fp32 scales k_scale / v_scale [num_blocks, Nkv], 2 = the pool holds
// the other full-precision dtype (bf16 under fp32 q, fp32 under bf16 q;
// scales unused). q_lens may be null:
// every row then has `span` queries. route: 0 = CUDA cores (any dtype and
// tile), 1 = tensor cores (bf16, span_tile x group of 16..64 rows), 2 =
// split-KV tensor cores (bf16, one query tile of span x group < 16 rows;
// `num_splits` splits of `split_keys` keys, a multiple
// of 64 and of the block size, covering max_blocks x block_size keys;
// `workspace` holds batch x Nkv x num_splits x rows x (head_dim + 2) fp32,
// `tickets` batch x Nkv int32 zeros, which the launch leaves at zero;
// launches that share the tickets must run in stream order). Routes 0 and
// 1 ignore the last four. 3 = wgmma and TMA (bf16 q over a bf16 pool of
// 16-token pages, span_tile x group of up to 128 rows; `num_blocks`, the
// pool's first dim, bounds its tensor map; routes 0-2 ignore it). Returns
// 0 on a successful launch, kErrSharedMemory
// (-1) when the route needs more shared memory than a block may have, else a
// cudaError_t: cudaErrorInvalidValue for arguments the route does not take. The launch
// is asynchronous on `stream`; nothing is allocated and nothing
// synchronises.
int distllm_rpa_launch(const void* q, const void* k_cache, const void* v_cache,
                       const void* k_scale, const void* v_scale,
                       const void* block_tables, const void* context_lens,
                       const void* q_start, const void* q_lens, void* out,
                       int batch, int span, int num_heads, int num_kv_heads,
                       int head_dim, int block_size, int max_blocks,
                       int span_tile, int window, float scale, float softcap,
                       int dtype, int kv_dtype, int route, void* workspace,
                       void* tickets, int num_splits, int split_keys, int num_blocks,
                       void* stream) {
  if (batch < 1 || batch > 65535 || span < 1 || num_kv_heads < 1 ||
      num_kv_heads > 65535 || num_heads % num_kv_heads != 0 ||
      block_size < 1 || max_blocks < 1 || span_tile < 1 ||
      kv_dtype < kKvModel || kv_dtype > kKvMixed || (dtype != 0 && dtype != 1) ||
      (kv_dtype == kKvInt8 && (k_scale == nullptr || v_scale == nullptr))) {
    return int(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k_cache = k_cache;
  p.v_cache = v_cache;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.block_tables = static_cast<const int*>(block_tables);
  p.context_lens = static_cast<const int*>(context_lens);
  p.q_start = static_cast<const int*>(q_start);
  p.q_lens = static_cast<const int*>(q_lens);
  p.out = out;
  p.span = span;
  p.num_heads = num_heads;
  p.num_kv_heads = num_kv_heads;
  p.block_size = block_size;
  p.max_blocks = max_blocks;
  p.span_tile = span_tile;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaErrorInvalidValue;
  const int rows = span_tile * (num_heads / num_kv_heads);
  SplitArgs sa{nullptr, nullptr, 0, 0};
  if (route == 2) {
    if (dtype != 1 || rows >= kMmaRows || span_tile != span || workspace == nullptr ||
        tickets == nullptr || num_splits < 1 || split_keys < kStepKeys ||
        split_keys % kStepKeys != 0 || split_keys % block_size != 0 ||
        int64_t(num_splits) * split_keys < int64_t(max_blocks) * block_size) {
      return int(err);
    }
    sa = SplitArgs{static_cast<float*>(workspace), static_cast<int*>(tickets), num_splits,
                   split_keys};
  } else if (route == 1) {
    if (dtype != 1 || rows < 16 || rows > kTcRows) return int(err);
  } else if (route == 3) {
    if (dtype != 1 || kv_dtype != kKvModel || block_size != wg::kPage || rows > wg::kRows ||
        num_blocks < 1) {
      return int(err);
    }
    if (head_dim == 64) return wg::launch<64>(p, num_blocks, batch, s);
    if (head_dim == 128) return wg::launch<128>(p, num_blocks, batch, s);
    if (head_dim == 256) return wg::launch<256>(p, num_blocks, batch, s);
    return int(err);
  } else if (route != 0) {
    return int(err);
  }
  if (head_dim == 64) return launch_route<64>(route, dtype, kv_dtype, p, sa, batch, s);
  if (head_dim == 128) return launch_route<128>(route, dtype, kv_dtype, p, sa, batch, s);
  if (head_dim == 256) return launch_route<256>(route, dtype, kv_dtype, p, sa, batch, s);
  return int(err);
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

// The message of a launch's return: for kErrSharedMemory both sizes of
// this thread's last refused launch.
const char* distllm_rpa_error_string(int err) {
  if (err == kErrSharedMemory) {
    static thread_local char message[128];
    snprintf(message, sizeof message,
             "needs %lld bytes of shared memory a block; the device allows %lld",
             smem_needed, smem_allowed);
    return message;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
