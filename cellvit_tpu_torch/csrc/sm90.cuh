// Hopper (sm_90a) building blocks shared by the kernels written for wgmma and
// TMA: mbarriers, TMA tensor maps and loads, wgmma shared-memory descriptors,
// fences, commit/wait and the bf16 products with fp32 accumulators.
//
// Shared-memory operands are tiles of 64 bf16 columns (128-byte rows) as a
// TMA box with 128-byte swizzle lays them out: row r's 16-byte chunk c sits at
// chunk c ^ (r % 8). Each tile starts on a 1024-byte boundary, so the swizzle
// phase is the row's own. wgmma reads such a tile in either major order:
//   K-major (the reduced dimension contiguous in a row): 8-row groups 1024
//     bytes apart; a 16-deep step along K adds 32 bytes to the start;
//   MN-major (the output rows or columns contiguous in a row, `trans` = 1):
//     each row is one K index; a 16-deep step adds 16 rows (2048 bytes), and
//     at most 64 output rows or columns are read from one tile.
//
// Accumulator layout of an m64nNk16 product (g = lane / 4, t = lane % 4, warp
// w of the warpgroup): d[4j + 2h + e] holds row 16w + g + 8h, column
// 8j + 2t + e. A register A operand (m64k16) holds a0 = A[g][2t..2t+1],
// a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..] of the warp's
// 16 rows, so two accumulator column chunks (2kk, 2kk+1) repack into the A
// operand of depth step kk.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive once and add `bytes` to the transactions the current phase awaits.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Spin until the phase of parity `parity` has completed. A wait that outlasts
// 2^26 tries (seconds) traps, so a broken protocol fails the launch instead
// of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 26)) __trap();
}

// Synchronise `count` threads (whole warps) on hardware barrier `id` (1-15;
// 0 is __syncthreads).
__device__ __forceinline__ void named_barrier(uint32_t id, uint32_t count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Order this thread's generic-proxy shared-memory writes before later
// async-proxy reads (wgmma, TMA) of the same bytes.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------------ registers

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------------------ TMA

// Coordinates are (column, row, head, batch) of a 4-D (D, N, H, B) map.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// libcuda's tensor-map encoder (`cuTensorMapEncodeTiled`), fetched through
// the runtime so that a library built by a plain `nvcc -shared` needs no
// `-lcuda`.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &status) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) !=
        cudaSuccess)
      return nullptr;
#endif
    if (status != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 (D, N, H, B) map with element strides (s_n, s_h, s_b) and unit
// stride over D, cut into boxes of 64 columns × `rows` rows of one head,
// 128-byte swizzle; reads past D or N fill zeros. False if refused.
inline bool bf16_map_4d(CUtensorMap* map, const void* base, int D, int N, int H, int B,
                        long long s_n, long long s_h, long long s_b, int rows) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s_n * 2, (cuuint64_t)s_h * 2, (cuuint64_t)s_b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ------------------------------------------------------------------ wgmma

// Descriptor of a 128-byte-swizzled tile at `p` (1024-byte aligned tile,
// `p` itself offset within it by whole 16-byte chunks). Both byte offsets are
// 1024: the 8-row group stride of either major order (the MN-major
// leading offset, the stride between 64-column tiles, is never crossed).
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (64ull << 16) | (64ull << 32) | (1ull << 62);
}

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

// Keep the compiler from moving accumulator registers while a wgmma that
// writes them is in flight.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

#define SM90_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                   "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64×N) = A·B (+ d if `acc`), both operands from shared memory;
// TA/TB = 1 reads A/B MN-major.
template <int N, int TA, int TB>
struct SS;

template <int TA, int TB>
struct SS<64, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : SM90_D8(0), SM90_D8(8), SM90_D8(16), SM90_D8(24)
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct SS<32, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, %19, %20;\n}\n"
        : SM90_D8(0), SM90_D8(8)
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  }
};

// d (64×N) += A·B with A (64×16) in registers; TB = 1 reads B MN-major.
// (scale-d is a predicate operand: set to 1, the product accumulates.)
template <int N, int TB>
struct RS;

template <int TB>
struct RS<64, TB> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : SM90_D8(0), SM90_D8(8), SM90_D8(16), SM90_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
  }
};

template <int TB>
struct RS<16, TB> {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : SM90_D8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
  }
};

#undef SM90_D8

}  // namespace sm90
