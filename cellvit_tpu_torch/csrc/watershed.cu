// Quantized level-sweep watershed: `levels` × `inner_iters` adoption passes,
// pass p admitting in-mask pixels of quantized height ≤ p ÷ inner_iters,
// then stabilization passes over the whole mask until a pass changes nothing
// or `max_final` passes have run, per image.
//
// Replaces (cellvit_tpu/ops/cc_pallas.py): `_watershed_kernel` :493 with
// `_ws_adopt` :468 (pallas_call :554, `watershed_pallas`).
//
// Every pass is Jacobi: an unlabelled admitted pixel takes the label of its
// labelled 4-neighbour of lowest quantized height in the labels before the
// pass (ties N, S, W, E by strict <); neighbours off the image carry label 0
// and height 2³⁰. The Pallas kernel keeps an image in VMEM for all passes.
// Here a launch runs up to KMAX passes by temporal blocking: a block stages
// its T × T tile with a halo of KMAX (labels, heights, mask) in shared
// memory and runs the passes there between two label buffers, the valid
// region shrinking by one pixel a pass, so its T × T pixels come out exact
// after KMAX passes; launches alternate two label buffers in device memory.
//
// Stabilization needs no host synchronisation. A block records, per pass,
// whether any of its own pixels changed (flags[b, p] = 1). A pass that
// changes nothing leaves a fixed point, so an image's flags are a prefix of
// ones: its pass count is min(#ones + 1, max_final) and a launch whose
// image did not change in the pass before it skips the image. A last kernel
// copies each image's final labels into buffer 0, where the launches that
// ran for it left them in buffer 1.
//
// Bound on the H100 at (8, 1024, 1024): q (int32), mask (int8) and markers
// (int32) read once and the labels written once, 104 MB (≈31 µs at 3.35
// TB/s). This design reads the tiles with their halos, 2.25 × 9 bytes a
// pixel, and writes 4 bytes a pixel once per KMAX passes: 32 launches for
// the 256 passes of the level sweep, and one per 8 stabilization passes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int T = 32;              // owned tile side
constexpr int KMAX = 8;            // passes per launch = halo width
constexpr int S = T + 2 * KMAX;    // staged side
constexpr int THREADS = 256;
constexpr int32_t BIG = 1 << 30;

// `n` ≤ KMAX passes from `src` into `dst`. flags == nullptr: level-sweep
// passes p0 … p0+n−1. Otherwise stabilization passes p0 … p0+n−1, recorded
// in flags[b·max_final + p].
__global__ void __launch_bounds__(THREADS)
ws_passes_kernel(const int32_t* __restrict__ src, int32_t* __restrict__ dst,
                 const int32_t* __restrict__ q, const int8_t* __restrict__ mask, int H, int W,
                 int p0, int n, int inner, int32_t* __restrict__ flags, int max_final) {
  __shared__ int32_t lab[2][S * S];
  __shared__ int32_t qs[S * S];
  __shared__ int8_t ms[S * S];
  __shared__ int changed[KMAX];
  const int b = blockIdx.z;
  int32_t* img_flags = flags ? flags + (long long)b * max_final : nullptr;
  if (img_flags && p0 > 0 && img_flags[p0 - 1] == 0) return;  // a fixed point already
  const int ty0 = blockIdx.y * T - KMAX, tx0 = blockIdx.x * T - KMAX;
  const long long base = (long long)b * H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < S; r += THREADS / 32) {
    for (int c = lane; c < S; c += 32) {
      const int y = ty0 + r, x = tx0 + c;
      const bool in = y >= 0 && y < H && x >= 0 && x < W;
      const long long o = base + (long long)y * W + x;
      lab[0][r * S + c] = in ? src[o] : 0;
      qs[r * S + c] = in ? q[o] : BIG;
      ms[r * S + c] = in ? mask[o] : 0;
    }
  }
  if (threadIdx.x < KMAX) changed[threadIdx.x] = 0;
  __syncthreads();

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int j = 0; j < n; ++j) {
    const int32_t* cur = lab[j & 1];
    int32_t* nxt = lab[(j + 1) & 1];
    const int lvl = img_flags ? INT_MAX : (p0 + j) / inner;
    const int lo = j + 1, hi = S - j - 1;  // the cells this pass recomputes
    bool any = false;
    for (int r = lo + ty; r < hi; r += 16) {
      for (int c = lo + tx; c < hi; c += 16) {
        const int i = r * S + c;
        const int32_t v = cur[i];
        int32_t nv = v;
        if (v == 0 && ms[i] && qs[i] <= lvl) {
          int32_t bl = 0, bq = BIG;
          const int nb[4] = {i - S, i + S, i - 1, i + 1};  // N, S, W, E
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int32_t l = cur[nb[k]], h = qs[nb[k]];
            if (l > 0 && h < bq) { bl = l; bq = h; }
          }
          nv = bl;
        }
        nxt[i] = nv;
        any |= nv != v && r >= KMAX && r < KMAX + T && c >= KMAX && c < KMAX + T;
      }
    }
    if (any) changed[j] = 1;
    __syncthreads();
  }

  const int32_t* fin = lab[n & 1];
  for (int r = KMAX + warp; r < KMAX + T; r += THREADS / 32) {
    const int y = ty0 + r, x = tx0 + KMAX + lane;
    if (y < H && x < W) dst[base + (long long)y * W + x] = fin[r * S + KMAX + lane];
  }
  if (img_flags && threadIdx.x < n && changed[threadIdx.x]) img_flags[p0 + threadIdx.x] = 1;
}

__global__ void ws_init_kernel(const int32_t* __restrict__ markers, const int8_t* __restrict__ mask,
                               int32_t* __restrict__ lab, long long total) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < total) lab[i] = mask[i] ? markers[i] : 0;
}

// Per image: its pass count, and where the stabilization launches that ran
// for it left its labels (sel[b] = 1: buffer 1).
__global__ void ws_count_kernel(const int32_t* __restrict__ flags, int32_t* __restrict__ passes,
                                int32_t* __restrict__ sel, int max_final, int n_launch, int parity0) {
  __shared__ int total;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  int part = 0;
  for (int p = threadIdx.x; p < max_final; p += blockDim.x) part += flags[(long long)blockIdx.x * max_final + p];
  atomicAdd(&total, part);
  __syncthreads();
  if (threadIdx.x == 0) {
    passes[blockIdx.x] = min(total + 1, max_final);
    // launch i ≥ 1 ran iff the image changed in pass i·KMAX − 1, i.e. iff i·KMAX ≤ total
    const int ran = min(n_launch, total / KMAX + 1);
    sel[blockIdx.x] = (parity0 + ran) & 1;
  }
}

__global__ void ws_select_kernel(const int32_t* __restrict__ sel, const int32_t* __restrict__ buf1,
                                 int32_t* __restrict__ buf0, long long HW) {
  if (!sel[blockIdx.y]) return;
  const long long base = blockIdx.y * HW;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < HW;
       i += (long long)gridDim.x * blockDim.x)
    buf0[base + i] = buf1[base + i];
}

}  // namespace

// q (B, H, W) int32 quantized heights, mask int8, markers int32 → labels in
// buf0 (buf1: scratch of the same size), stabilization pass counts in
// passes (B,) int32. flags: B·max_final + B int32 of scratch.
extern "C" int watershed_sweep(const void* q, const void* mask, const void* markers, void* buf0,
                               void* buf1, void* flags, void* passes, int B, int H, int W,
                               int levels, int inner_iters, int max_final, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = (long long)B * H * W;
  int32_t* bufs[2] = {(int32_t*)buf0, (int32_t*)buf1};
  int32_t* fl = (int32_t*)flags;
  cudaError_t e = cudaMemsetAsync(fl, 0, (size_t)B * max_final * sizeof(int32_t), s);
  if (e != cudaSuccess) return (int)e;
  ws_init_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      (const int32_t*)markers, (const int8_t*)mask, bufs[0], total);
  const dim3 grid((W + T - 1) / T, (H + T - 1) / T, B);
  int cur = 0;
  const int sweep = levels * inner_iters;
  for (int p0 = 0; p0 < sweep; p0 += KMAX, cur ^= 1)
    ws_passes_kernel<<<grid, THREADS, 0, s>>>(bufs[cur], bufs[cur ^ 1], (const int32_t*)q,
                                              (const int8_t*)mask, H, W, p0, std::min(KMAX, sweep - p0),
                                              inner_iters, nullptr, max_final);
  const int parity0 = cur;
  int n_launch = 0;
  for (int p0 = 0; p0 < max_final; p0 += KMAX, cur ^= 1, ++n_launch)
    ws_passes_kernel<<<grid, THREADS, 0, s>>>(bufs[cur], bufs[cur ^ 1], (const int32_t*)q,
                                              (const int8_t*)mask, H, W, p0,
                                              std::min(KMAX, max_final - p0), inner_iters, fl, max_final);
  int32_t* sel = fl + (long long)B * max_final;
  ws_count_kernel<<<B, 256, 0, s>>>(fl, (int32_t*)passes, sel, max_final, n_launch, parity0);
  ws_select_kernel<<<dim3(256, B), 256, 0, s>>>(sel, bufs[1], bufs[0], (long long)H * W);
  return (int)cudaGetLastError();
}
