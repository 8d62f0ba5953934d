// Warp-level bf16 tensor-core helpers of the `mma.sync` kernels (B7, B12).
//
// `mma.sync.m16n8k16` with bf16 operands and fp32 accumulators. Fragment
// layout (g = lane / 4, t = lane % 4):
//   A (16×16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                         a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16×8, column-major, stored as Bt[n][k]): b0 = Bt[g][2t..2t+1],
//                                               b1 = Bt[g][2t+8..2t+9]
//   C (16×8): c0, c1 = C[g][2t..2t+1]; c2, c3 = C[g+8][2t..2t+1]
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_bf16 {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a · b
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows r0..r0+15, columns k0..k0+15 of a row-major
// shared-memory matrix with row pitch `ld` (elements).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* m, int ld,
                                       int r0, int k0, int g, int t) {
  a[0] = ld32(m + (r0 + g) * ld + k0 + 2 * t);
  a[1] = ld32(m + (r0 + g + 8) * ld + k0 + 2 * t);
  a[2] = ld32(m + (r0 + g) * ld + k0 + 8 + 2 * t);
  a[3] = ld32(m + (r0 + g + 8) * ld + k0 + 8 + 2 * t);
}

// The B fragment of output columns n0..n0+7, depth k0..k0+15, from Bt[n][k]
// in shared memory with row pitch `ld`.
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* bt,
                                       int ld, int n0, int k0, int g, int t) {
  b0 = ld32(bt + (n0 + g) * ld + k0 + 2 * t);
  b1 = ld32(bt + (n0 + g) * ld + k0 + 8 + 2 * t);
}

// Max and sum over the four lanes of a quad (the lanes that share a row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Set the kernel's dynamic shared memory cap once it exceeds the 48 KB default.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace mma_bf16
