// The Hopper attention main loop shared by K1's and K3's 'wgmma' routes
// (sm_90a): the pieces both kernels are built from, in raw PTX.
//
// The block shape both use:
// - one producer warp (the first of the warpgroup after the consumers,
//   which gives its registers back with setmaxnreg) issues every TMA copy
//   (cp.async.bulk.tensor) into a ring of stages in shared memory; a stage
//   is "full" when its mbarrier has seen the copies' bytes land and
//   "empty" when each of the 8 consumer warps has arrived on its other
//   mbarrier (Ring);
// - two consumer warpgroups (setmaxnreg raises them to 232 registers)
//   each own 64 query rows: Q K^T as wgmma from shared memory (Q and K
//   K-major), fp32 accumulators in registers, the softmax in registers,
//   then P V as wgmma with P as the register A operand (the accumulator
//   of Q K^T rounded to bf16 is, register for register, the A fragment of
//   mma.m16n8k16 that wgmma takes) and V MN-major from shared memory.
//
// Shared-memory tiles are what TMA writes with a 128-byte swizzle (64-byte
// for rows of 32 bf16): a tile of R rows by D columns is D / W chunks of
// R rows by W columns (W = swizzle bytes / 2), each chunk R rows of W
// values, 1024-byte (512-byte) aligned. The wgmma descriptors below read
// those chunks in wgmma's canonical swizzled layouts:
// - K-major (A = Q, B = K for Q K^T): 8-row groups SBO = 8 rows apart;
//   a 16-deep k-step is 32 bytes into the swizzled row (the start address
//   moves, the swizzle pattern stays with the 1024-byte atom);
// - MN-major (B = V for P V, transposed): the k-step is 16 rows; 8-row
//   groups SBO = 8 rows apart along K; the next W columns of N (the next
//   chunk) LBO bytes on.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

// Cycle counters of the consumer warpgroups' phases, compiled in only with
// -DDISTLLM_PHASES (scripts/profile_torch_kernel_phases.py): thread 0 of
// each consumer warpgroup adds the cycles since its previous mark to
// counter i; the sums reach g_phases once, at the end of the block.
#ifdef DISTLLM_PHASES
__device__ unsigned long long g_phases[16];
#define PHASES_BEGIN()           \
  long long phase_sum[16] = {}; \
  long long phase_t = clock64()
#define PHASE(i)                              \
  do {                                        \
    const long long phase_now = clock64();    \
    phase_sum[i] += phase_now - phase_t;      \
    phase_t = phase_now;                      \
  } while (0)
#define PHASES_END()                                                         \
  do {                                                                       \
    if (threadIdx.x % 128 == 0) {                                            \
      _Pragma("unroll") for (int i = 0; i < 16; ++i)                        \
          atomicAdd(&g_phases[i], (unsigned long long)phase_sum[i]);         \
    }                                                                        \
  } while (0)
#else
#define PHASES_BEGIN()
#define PHASE(i)
#define PHASES_END()
#endif

namespace hopper_attn {

constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kConsumerThreads = 256;  // two warpgroups: threads 0..255
// The producer warpgroup after them (its first thread issues the copies).
constexpr int kBlockThreads = kConsumerThreads + 128;
constexpr int kConsumerBarrier = 1;    // named barrier of the 256 consumer threads

// ------------------------------------------------------------ barriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(mma_tiles::smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer's arrival on a full barrier, announcing the bytes its copies
// will bring.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
          mma_tiles::smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
                   mma_tiles::smem_addr(bar))
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed. A
// wait that lasts past kWaitCycles (seconds: a copy that never lands, a
// protocol out of step) traps, so the launch fails instead of hanging.
constexpr long long kWaitCycles = 20000000000ll;

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(mma_tiles::smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > kWaitCycles) __trap();
  }
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (TMA, wgmma's operand reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kConsumerBarrier), "n"(kConsumerThreads) : "memory");
}

// The 128 threads of consumer warpgroup w (named barriers 2 and 3).
__device__ __forceinline__ void warpgroup_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(kConsumerBarrier + 1 + w) : "memory");
}

// A ring of `stages` stages: full[s] (one arrival + the copies' bytes) and
// empty[s] (one arrival from each consumer warp). Iteration `it` uses stage it % stages
// in round it / stages; the producer's first round finds every stage empty.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  int stages;

  __device__ __forceinline__ void init() const {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads / 32);
    }
  }
  __device__ __forceinline__ int stage(int it) const { return it % stages; }
  __device__ __forceinline__ int parity(int it) const { return (it / stages) & 1; }
  // Producer: wait for stage it % stages to be free, announce `bytes`.
  __device__ __forceinline__ uint64_t* acquire(int it, uint32_t bytes) const {
    mbar_wait(&empty[stage(it)], parity(it) ^ 1);
    mbar_expect_tx(&full[stage(it)], bytes);
    return &full[stage(it)];
  }
  // Consumer: wait for stage it % stages to land; release it when done.
  __device__ __forceinline__ void wait(int it) const { mbar_wait(&full[stage(it)], parity(it)); }
  __device__ __forceinline__ void release(int it) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[stage(it)]);
  }
};

// ------------------------------------------------------------ TMA
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(mma_tiles::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(mma_tiles::smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(mma_tiles::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(mma_tiles::smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ------------------------------------------------------------ registers
template <int kRegs>
__device__ __forceinline__ void release_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void claim_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ------------------------------------------------------------ wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The accumulators are written by the tensor cores after the issuing asm
// returns: pin every register at the wait, so that no read of an
// accumulator is scheduled above it and no write below the issue.
template <int N>
__device__ __forceinline__ void fence_operands(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// A fragments are read by the tensor cores after the issuing asm returns:
// keep them live (and unmoved) until the wait.
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(x[i][e])::"memory");
  }
}

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets, swizzle (128 bytes: layout type 1; 64 bytes: 2). Chunks are
// atom-aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t smem_desc(const void* p, int swizzle_bytes, uint32_t lbo,
                                              uint32_t sbo) {
  const uint64_t addr = mma_tiles::smem_addr(p);
  const uint64_t layout = swizzle_bytes == 128 ? 1 : 2;
  return ((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// m64nNk16, bf16 operands, fp32 accumulators (N / 2 a thread): thread
// (warp w, lane 4g + t) holds rows 16w + g and 16w + g + 8, columns
// 8j + 2t and 8j + 2t + 1 of each 8-column tile j, in registers 4j..4j+3
// (the first row's two, then the second's).
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static constexpr int kRegs = 16;
  // d (+)= A (64 x 16, K-major, shared memory) * B (16 x 32, K-major, shared memory).
  __device__ __forceinline__ static void ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  }
  // d += A (64 x 16 bf16 in registers, the mma.m16n8k16 A fragment of each
  // warp's 16 rows) * B (16 x 32, MN-major in shared memory).
  __device__ __forceinline__ static void rs(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static constexpr int kRegs = 32;
  // d (+)= A (64 x 16, K-major, shared memory) * B (16 x 64, K-major, shared memory).
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  }
  // d += A (64 x 16 bf16 in registers, the mma.m16n8k16 A fragment of each
  // warp's 16 rows) * B (16 x 64, MN-major in shared memory).
  __device__ __forceinline__ static void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static constexpr int kRegs = 64;
  // d (+)= A (64 x 16, K-major, shared memory) * B (16 x 128, K-major, shared memory).
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  }
  // d += A (64 x 16 bf16 in registers, the mma.m16n8k16 A fragment of each
  // warp's 16 rows) * B (16 x 128, MN-major in shared memory).
  __device__ __forceinline__ static void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};



// The shared main loop's two products, one warpgroup's 64 rows.
//
// S (64 x KEYS) = Q (64 x HD) K^T: q_rows is the warpgroup's first row in
// chunk 0 of the Q tile (chunks q_chunk_bytes apart), k_tile chunk 0 of a
// K tile of KEYS rows (chunks KEYS * SWZ bytes apart). Issues HD / 16
// wgmmas; the first overwrites S.
template <int HD, int KEYS, int SWZ>
__device__ __forceinline__ void issue_qk(float (&s)[KEYS / 2], const uint8_t* q_rows,
                                         int q_chunk_bytes, const uint8_t* k_tile) {
  constexpr int kStepsPerChunk = SWZ / 32;  // 16-deep k-steps in a swizzled row
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int chunk = kk / kStepsPerChunk;
    const int within = 32 * (kk % kStepsPerChunk);
    const uint64_t da = smem_desc(q_rows + chunk * q_chunk_bytes + within, SWZ, 16, 8 * SWZ);
    const uint64_t db = smem_desc(k_tile + chunk * KEYS * SWZ + within, SWZ, 16, 8 * SWZ);
    Wgmma<KEYS>::ss(s, da, db, kk > 0);
  }
}

// O (64 x HD) += P (64 x KEYS, registers: k-step kk's A fragment in
// p[kk]) V, V a tile of KEYS rows by HD (chunks KEYS * SWZ bytes apart).
// Every row of V must be finite: a key whose p is 0 still meets its row.
// Above 128 columns O is two m64n128 accumulators (64 registers each, no
// 128-register block to find).
template <int HD, int KEYS, int SWZ>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&p)[KEYS / 16][4],
                                         const uint8_t* v_tile) {
  constexpr int kN = HD > 128 ? 128 : HD;
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
#pragma unroll
    for (int half = 0; half < HD / kN; ++half) {
      // Columns [kN half, kN (half + 1)): chunks (kN / (SWZ / 2)) half on.
      Wgmma<kN>::rs(*reinterpret_cast<float(*)[kN / 2]>(o + kN / 2 * half), p[kk],
                    smem_desc(v_tile + kk * 16 * SWZ + half * (2 * kN / SWZ) * KEYS * SWZ, SWZ,
                              KEYS * SWZ, 8 * SWZ));
    }
  }
}

// S's accumulators rounded to bf16 as P V's A fragments: k-step kk takes
// the 8-key tiles 2kk and 2kk + 1.
template <int KEYS>
__device__ __forceinline__ void pack_p(uint32_t (&p)[KEYS / 16][4], const float (&s)[KEYS / 2]) {
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
    p[kk][0] = mma_tiles::pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = mma_tiles::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = mma_tiles::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = mma_tiles::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// The max of row i (0: the thread's first row, 1: its second) of an
// m64nKEYSk16 accumulator over the quad that shares the row, as a tree.
template <int KEYS>
__device__ __forceinline__ float row_max(const float (&s)[KEYS / 2], int i) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
    mx[j % 2] = fmaxf(mx[j % 2], fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
  }
  return mma_tiles::quad_max(fmaxf(mx[0], mx[1]));
}

// Shared memory above the 1024-byte alignment of a swizzle atom.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ------------------------------------------------------------ host
// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// library links to no libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &status) !=
            cudaSuccess ||
        fn == nullptr) {
      return nullptr;
    }
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  return encode;
}

// A bf16 tensor map of `rank` dims (innermost first; strides in bytes of
// dims 1..rank-1), boxes of `box`, out-of-bounds elements read as zeros.
inline bool encode_bf16_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                            const cuuint64_t* strides, const cuuint32_t* box,
                            int swizzle_bytes) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cuuint32_t(rank), const_cast<void*>(base),
                dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper_attn
