// Tensor-core tile helpers shared by the attention kernels and the int8
// matmul (sm_90a).
//
// - cp_async16: a 16-byte copy from device to shared memory that does not
//   occupy registers, with a zero-filling form: `live == false` reads no
//   byte from `src` and writes 16 zero bytes, so a key outside a row's
//   range is never read from the pool and stages as exact zeros;
//   cp_async4 the same for 4 bytes (one fp32 scale).
// - ldmatrix_x4 / ldmatrix_x4_trans: four 8x8 bf16 matrices from shared
//   memory into the fragment layout of mma.m16n8k16.
// - mma_bf16_16816: D = A (16x16 bf16, row) * B (16x8 bf16, col) + D, fp32
//   accumulators, the warp-wide tensor-core product.
// - int8_bytes_to_bf16x2 / int8_pair_to_bf16x2: two int8 codes widened to
//   a bf16 pair in registers, exactly (the B operand of the int8 matmul).
//
// Fragment layout of mma.m16n8k16 (lane = 4 * g + t): A holds rows g and
// g + 8, columns 2t, 2t + 1 (+ 8); B holds rows 2t, 2t + 1 (+ 8) of column
// g; the fp32 accumulator c[0..1] is row g, columns 2t, 2t + 1 and c[2..3]
// is row g + 8. An accumulator tile of S = Q K^T therefore is, register for
// register, the A operand of the next product P V once rounded to bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace mma_tiles {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  const int bytes = live ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  const int bytes = live ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 (nearest even), `lo` in the low half:
// the register form of an A fragment pair.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two int8 codes as a bf16 pair, exactly: SEL is a __byte_perm selector
// over (lo, hi) that puts the low half's code in byte 0 and the high half's
// in byte 2 (bytes 1 and 3 are ignored). Then, as bf16, 128 + (code &
// 0x7F) (the low 7 bits as the mantissa of 2^7) minus 128 (code >= 0) or
// 256 (code < 0: bit 7 of the byte lands on the exponent's lowest bit) is
// the code: both operands and the difference are exact in bf16. Four
// instructions per pair, no conversion instruction and no shared memory.
template <uint32_t SEL>
__device__ __forceinline__ uint32_t int8_bytes_to_bf16x2(uint32_t lo, uint32_t hi) {
  const uint32_t pair = __byte_perm(lo, hi, SEL);
  const uint32_t low = (pair & 0x007F007Fu) | 0x43004300u;
  const uint32_t base = (pair & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&low),
                                   *reinterpret_cast<const __nv_bfloat162*>(&base));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte J of `lo` (low half) and of `hi` (high half) as a bf16 pair.
template <int J>
__device__ __forceinline__ uint32_t int8_pair_to_bf16x2(uint32_t lo, uint32_t hi) {
  return int8_bytes_to_bf16x2<J | (J << 4) | ((4 + J) << 8) | ((4 + J) << 12)>(lo, hi);
}

// 2^x on the special-function unit (relative error ~2^-22; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Max / sum over the four lanes of a quad (the lanes that share a row of
// an mma accumulator).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

constexpr int kMaxDevices = 64;

// Above 48 KiB of dynamic shared memory a kernel must opt in. The opt-in
// is set once per device for each kernel instance (`opted_in` is that
// instance's own static array), at the device's own maximum, not on every
// launch.
inline cudaError_t opt_in_shared_memory(const void* kernel, size_t bytes,
                                        std::atomic<bool> (&opted_in)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (opted_in[device].load(std::memory_order_acquire)) return cudaSuccess;
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (err != cudaSuccess) return err;
  opted_in[device].store(true, std::memory_order_release);
  return cudaSuccess;
}

}  // namespace mma_tiles
