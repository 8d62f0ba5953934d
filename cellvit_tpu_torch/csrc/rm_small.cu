// Small-object removal: the windowed same-label count, and the radix
// histogram with its per-pixel keep lookup.
//
// Replaces (cellvit_tpu/ops/cc_pallas.py):
//   `_rm_small_kernel` :284    (pallas_call :328, `remove_small_objects_pallas`)
//   `_hist_kernel` :345        (pallas_call :431, `remove_small_objects_bincount_pallas`)
//   `_rm_mapback_kernel` :377  (pallas_call :446, the same op's second half)
//
// B10, the window filter: a pixel keeps its label iff the label is > 0 and
// its (2·min_size − 1)² window holds ≥ min_size pixels of that label; pixels
// off the image hold the −1 sentinel, as in the Pallas kernel. A block
// stages a 32 × 32 tile of labels with a halo of r = min_size − 1 in shared
// memory ((32 + 2r)² int32: 10 KB at min_size 10) and each thread counts
// four pixels' windows there, stopping a window as soon as the count
// reaches min_size (the answer is then known). Bound on the H100 at
// (8, 1024, 1024): one int32 read and one int32 write per pixel, 64 MB
// (≈19 µs at 3.35 TB/s); the window compares, up to (2r + 1)² shared-memory
// reads per labelled pixel, are what this design spends instead.
//
// B11a, the radix histogram: the Pallas kernel counts with one-hot matmuls
// on the TPU's matrix unit; here each block counts its share of one image
// into a shared-memory table of hi_bins·lo_bins int32 (32 KB at 64 × 128)
// with shared atomics, background (bin 0) in a register, and adds the table
// into the image's fp32 counts with global atomics. Every count is an
// integer below 2²⁴, so the fp32 sums are exact in any order and equal the
// matmul's. Bound: one int32 read per pixel, 32 MB (≈10 µs).
//
// B11b, the keep lookup: each block turns its image's counts into a byte
// table small = count < min_size in shared memory and maps its pixels
// through it; ids ≥ hi_bins·lo_bins are always kept, label 0 never. Bound:
// one int32 read and one int32 write per pixel, 64 MB (≈19 µs).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RT = 32;         // B10 output tile side
constexpr int RM_THREADS = 256;
constexpr int HIST_THREADS = 512;
constexpr int HIST_BLOCKS = 32;  // per image
constexpr int MAP_THREADS = 512;
constexpr int MAP_BLOCKS = 64;   // per image

__global__ void __launch_bounds__(RM_THREADS)
rm_small_kernel(const int32_t* __restrict__ lab, int32_t* __restrict__ out, int H, int W, int r,
                int min_size) {
  extern __shared__ int32_t tile[];
  const int S = RT + 2 * r;
  const int y0 = blockIdx.y * RT, x0 = blockIdx.x * RT;
  const long long base = (long long)blockIdx.z * H * W;
  for (int i = threadIdx.x; i < S * S; i += RM_THREADS) {
    const int y = y0 - r + i / S, x = x0 - r + i % S;
    tile[i] = (y >= 0 && y < H && x >= 0 && x < W) ? lab[base + (long long)y * W + x] : -1;
  }
  __syncthreads();
  const int tx = threadIdx.x % RT;
  for (int ty = threadIdx.x / RT; ty < RT; ty += RM_THREADS / RT) {
    const int y = y0 + ty, x = x0 + tx;
    if (y >= H || x >= W) continue;
    const int32_t v = tile[(ty + r) * S + tx + r];
    int cnt = 0;
    if (v > 0) {
      for (int dy = 0; dy <= 2 * r && cnt < min_size; ++dy) {
        const int32_t* row = tile + (ty + dy) * S + tx;
        for (int dx = 0; dx <= 2 * r; ++dx) cnt += row[dx] == v;
      }
    }
    out[base + (long long)y * W + x] = cnt >= min_size ? v : 0;
  }
}

__device__ __forceinline__ int radix_bin(int32_t v, int hi_bins, int lo_bins) {
  // hi = clip(v ÷ lo_bins, 0, hi_bins − 1); truncating and flooring
  // division agree once a negative quotient is clipped to 0
  const int hi = min(max(v / lo_bins, 0), hi_bins - 1);
  const int lo = min(max(v - hi * lo_bins, 0), lo_bins - 1);
  return hi * lo_bins + lo;
}

__global__ void __launch_bounds__(HIST_THREADS)
radix_hist_kernel(const int32_t* __restrict__ lab, float* __restrict__ hist, int HW, int hi_bins,
                  int lo_bins) {
  extern __shared__ int32_t counts[];
  const int nb = hi_bins * lo_bins;
  for (int i = threadIdx.x; i < nb; i += HIST_THREADS) counts[i] = 0;
  __syncthreads();
  const int32_t* img = lab + (long long)blockIdx.y * HW;
  int zeros = 0;
  for (int i = blockIdx.x * HIST_THREADS + threadIdx.x; i < HW; i += gridDim.x * HIST_THREADS) {
    const int bin = radix_bin(img[i], hi_bins, lo_bins);
    if (bin == 0) ++zeros;
    else atomicAdd(&counts[bin], 1);
  }
  atomicAdd(&counts[0], zeros);
  __syncthreads();
  float* h = hist + (long long)blockIdx.y * nb;
  for (int i = threadIdx.x; i < nb; i += HIST_THREADS)
    if (counts[i]) atomicAdd(&h[i], (float)counts[i]);
}

__global__ void __launch_bounds__(MAP_THREADS)
rm_mapback_kernel(const int32_t* __restrict__ lab, const float* __restrict__ hist,
                  int32_t* __restrict__ out, int HW, int hi_bins, int lo_bins, int min_size) {
  extern __shared__ uint8_t small[];
  const int nb = hi_bins * lo_bins;
  const float* h = hist + (long long)blockIdx.y * nb;
  const float limit = (float)min_size;
  for (int i = threadIdx.x; i < nb; i += MAP_THREADS) small[i] = h[i] < limit;
  __syncthreads();
  const long long base = (long long)blockIdx.y * HW;
  for (int i = blockIdx.x * MAP_THREADS + threadIdx.x; i < HW; i += gridDim.x * MAP_THREADS) {
    const int32_t v = lab[base + i];
    const bool keep = v > 0 && (!small[radix_bin(v, hi_bins, lo_bins)] || v >= nb);
    out[base + i] = keep ? v : 0;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// (B, H, W) int32 labels → labels of components with ≥ min_size pixels
// (min_size ≥ 2), others 0.
extern "C" int remove_small_objects(const void* lab, void* out, int B, int H, int W, int min_size,
                                    void* stream) {
  const int r = min_size - 1;
  const size_t smem = (size_t)(RT + 2 * r) * (RT + 2 * r) * sizeof(int32_t);
  cudaError_t e = allow_smem(rm_small_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + RT - 1) / RT, (H + RT - 1) / RT, B);
  rm_small_kernel<<<grid, RM_THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)lab, (int32_t*)out, H, W, r, min_size);
  return (int)cudaGetLastError();
}

// (B, H·W) int32 ids → (B, hi_bins, lo_bins) fp32 counts per radix bin.
extern "C" int radix_hist(const void* lab, void* hist, int B, int HW, int hi_bins, int lo_bins,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t nb = (size_t)hi_bins * lo_bins;
  cudaError_t e = cudaMemsetAsync(hist, 0, (size_t)B * nb * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(radix_hist_kernel, nb * sizeof(int32_t));
  if (e != cudaSuccess) return (int)e;
  radix_hist_kernel<<<dim3(HIST_BLOCKS, B), HIST_THREADS, nb * sizeof(int32_t), s>>>(
      (const int32_t*)lab, (float*)hist, HW, hi_bins, lo_bins);
  return (int)cudaGetLastError();
}

// (B, H·W) int32 ids and their (B, hi_bins, lo_bins) fp32 counts → ids kept
// where > 0 and (count ≥ min_size or id ≥ hi_bins·lo_bins), else 0.
extern "C" int rm_mapback(const void* lab, const void* hist, void* out, int B, int HW, int hi_bins,
                          int lo_bins, int min_size, void* stream) {
  const size_t nb = (size_t)hi_bins * lo_bins;
  cudaError_t e = allow_smem(rm_mapback_kernel, nb);
  if (e != cudaSuccess) return (int)e;
  rm_mapback_kernel<<<dim3(MAP_BLOCKS, B), MAP_THREADS, nb, (cudaStream_t)stream>>>(
      (const int32_t*)lab, (const float*)hist, (int32_t*)out, HW, hi_bins, lo_bins, min_size);
  return (int)cudaGetLastError();
}
