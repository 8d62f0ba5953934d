// SAME 3×3 convolution on a channel-major (B, C, H, W) tensor with a fused
// epilogue: + bias, + channels [res_block·F, (res_block+1)·F) of `res`, an
// optional ReLU, the cast to the input's type. fp32 accumulation.
//
// Replaces (cellvit_tpu/ops/conv_cm.py): `_conv3x3_kernel` :80 (pallas_call
// :201, `conv3x3_cm`).
//
// Bound on the H100 at (8, 64, 1024, 1024) → 64, bf16: x read and out
// written once, 2 × 1.07 GB (≈0.64 ms at 3.35 TB/s), beside the
// 2·B·H·W·F·9C = 618 GFLOP (≈0.63 ms at 989 TFLOP/s): at the card's ridge,
// so it needs the tensor cores and the memory near their peaks at once.
//
// bf16 design (Hopper): an implicit GEMM on wgmma with the output channels
// as M (64 a warpgroup), pixels as N and K = 9 taps × channels.
// * A channel-major tile is pixel-contiguous, so B (x) is read MN-major:
//   one 128-byte-swizzled 64-channel × 64-pixel tile per image row. A work
//   item is 4 output rows × 64 pixels × 64 output channels; its operand is,
//   per chunk of 64 input channels and per column tap dx, a box of the 6
//   input rows y0 − 1 … y0 + 4 at columns x0 + dx − 1 …, zero past the
//   image (the SAME padding) and past C. A row tap dy is then only the
//   descriptor's start row (the rows of a box lie 8 KB apart, the
//   descriptor's leading offset), so the three dy taps share the box. The
//   column shift of a tap can be neither a descriptor offset (one element
//   breaks the swizzle) nor a TMA coordinate (the innermost one must be a
//   multiple of 8 elements; x0 − 1 faults). So the dx = 1 box comes by TMA
//   (one load, zero fill past the image), and the producer warpgroup
//   builds the dx = 0 and dx = 2 boxes from aligned 16-byte chunks of the
//   same rows (L2 hits), one funnel shift a chunk: 2.6× faster than
//   building them element by element (`scripts/conv3x3_variants.py`). The
//   kernel is bound by these loads (about 1.9 of its 2.2 ms at the smoke's
//   shape), not by the products (1.4 ms without the loads).
// * A persistent grid, one block an SM: a producer warpgroup feeds a
//   2-stage ring of such boxes (a stage completes on one arrival of each
//   producer warp and, for TMA, its bytes); two consumer
//   warpgroups take 2 of the 4 rows each (m64n128k16, A K-major from the
//   weights, B MN-major from the box), and release a stage as soon as its
//   products are done.
// * Weights, packed by the wrapper as (F/64, 9, ⌈C/64⌉, 64, 64): resident
//   in shared memory for the block's life where C ≤ 64 and F ≤ 64 (72 KB),
//   else streamed through the ring with each box (its 3 taps).
// * Epilogue from the accumulators: + bias, + the residual (a TMA box loaded
//   into the warpgroup's output tile when the item starts), ReLU, bf16,
//   written into the swizzled output tile and stored by one TMA store.
// * TMA needs 16-byte strides: where W is not a multiple of 8 (or a base is
//   not 16-byte aligned) the same kernel (kTMA = false) has the producer
//   warpgroup fill the boxes element by element, with the zero padding,
//   and the consumers read the residual and write the output directly.
// fp32 runs a plain FFMA loop, one pixel and 32 output channels a thread,
// on 4 × 64 pixel tiles with the weights packed as (⌈C/16⌉, 9, F_pad, 16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BN = 64;                 // pixels of a row tile: one 128-byte row
constexpr int ROWS = 4;                // output rows of a work item, 2 a consumer warpgroup
constexpr int XR = ROWS + 2;           // input rows of a box
constexpr int KCH = 64;                // input channels of a chunk
constexpr int TILE = 64 * 128;         // one 64 × 64 bf16 swizzled tile
constexpr int STAGES = 2;               // ring slots: 200 KB with the resident weights
constexpr int THREADS = 384;           // producer warpgroup + 2 consumer warpgroups
static_assert(XR * KCH % 128 == 0, "a producer thread's rows of chunks");

struct Epilogue {
  const float* bias;
  const void* res;
  int res_c, res_block, relu;
};

struct Params {
  const __nv_bfloat16* x;
  const __nv_bfloat16* res;
  __nv_bfloat16* out;
  const float* bias;
  int B, C, H, W, F, n_f, n_ch, n_x, n_y, items, res_c, res_block, relu;
};

// Shared memory: resident weights (9 tiles) or none, the ring (a box of XR
// row tiles, and when streamed the box's 3 weight tiles), the two output
// tiles, the barriers.
template <bool kResident>
struct Layout {
  static constexpr int W_RES = kResident ? 9 * TILE : 0;
  static constexpr int STAGE_X = XR * TILE;
  static constexpr int STAGE_W = kResident ? 0 : 3 * TILE;
  static constexpr int STAGE = STAGE_X + STAGE_W;
  static constexpr int OUT = W_RES + STAGES * STAGE;
  static constexpr int BAR = OUT + 2 * 2 * TILE;
  static constexpr int BYTES = BAR + 64 + 1024;  // + barriers, + alignment slack
};

__device__ __forceinline__ uint32_t swz(int row, int px) {  // byte offset in a swizzled tile
  return row * 128 + ((((px >> 3) ^ (row & 7)) << 4) | ((px & 7) << 1));
}

template <bool kTMA, bool kResident>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_sm90_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                    const __grid_constant__ CUtensorMap tout, const __grid_constant__ CUtensorMap tres,
                    const Params p) {
  using L = Layout<kResident>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* wbar = empty + STAGES;
  uint64_t* rbar = wbar + 1;  // one a consumer warpgroup
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  constexpr int FULL_ARRIVALS = 4;  // one lane of each producer warp, TMA bytes by expect_tx

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], FULL_ARRIVALS);
      mbar_init(&empty[s], 8);  // one lane of each consumer warp
    }
    mbar_init(wbar, 1);
    mbar_init(&rbar[0], 1);
    mbar_init(&rbar[1], 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int k_total = (p.C + 15) / 16;  // 16-deep steps over the real channels
  auto item_coords = [&](int item, int& b, int& y0, int& x0, int& f0) {
    const int fi = item % p.n_f;
    int rest = item / p.n_f;
    x0 = (rest % p.n_x) * BN;
    rest /= p.n_x;
    y0 = (rest % p.n_y) * ROWS;
    b = rest / p.n_y;
    f0 = fi * 64;
  };

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    if (kResident && tid == 0) {
      mbar_arrive_expect_tx(wbar, 9 * TILE);
      for (int tap = 0; tap < 9; ++tap) tma_load_2d(sm + tap * TILE, &tw, wbar, 0, tap * 64);
    }
    const size_t hw = (size_t)p.H * p.W;
    constexpr int SEGS = XR * KCH / 128;  // rows of chunks a producer thread
    int it = 0;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      int b, y0, x0, f0;
      item_coords(item, b, y0, x0, f0);
      for (int ch = 0; ch < p.n_ch; ++ch) {
        for (int dx = 0; dx < 3; ++dx, ++it) {
          const int s = it % STAGES;
          unsigned char* xs = sm + L::W_RES + s * L::STAGE;
          // TMA takes the box at x0 (its innermost coordinate must be a
          // multiple of 8 elements); the boxes at x0 ∓ 1 are built from the
          // 9 aligned 8-pixel chunks around each row and channel of them
          // (zeros past the image or C), one funnel shift a chunk: a thread's
          // 3 rows of chunks are loaded before it waits for the slot
          const bool tma_box = kTMA && dx == 1;
          const bool shift_box = kTMA && !tma_box;
          uint4 v[SEGS][9];
          if (shift_box) {
#pragma unroll
            for (int u = 0; u < SEGS; ++u) {
              const int seg = tid + 128 * u, r = seg / KCH, k = seg % KCH, c = ch * KCH + k, y = y0 - 1 + r;
              const bool row_in = c < p.C && y >= 0 && y < p.H;
              const uint4* src = reinterpret_cast<const uint4*>(p.x + ((size_t)b * p.C + c) * hw + (size_t)y * p.W);
#pragma unroll
              for (int i = 0; i < 9; ++i) {
                const int gx = x0 + 8 * (dx == 0 ? i - 1 : i);  // the chunk's first pixel
                v[u][i] = row_in && gx >= 0 && gx + 8 <= p.W ? __ldg(src + gx / 8) : make_uint4(0, 0, 0, 0);
              }
            }
          }
          if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
          if (tid == 0) {
            const uint32_t bytes = (tma_box ? L::STAGE_X : 0) + L::STAGE_W;
            if (bytes) mbar_expect_tx(&full[s], bytes);
            if (tma_box) tma_load_4d(xs, &tx, &full[s], x0, ch * KCH, y0 - 1, b);
            if (!kResident)
              for (int dy = 0; dy < 3; ++dy)
                tma_load_2d(xs + L::STAGE_X + dy * TILE, &tw, &full[s], 0,
                            (((f0 / 64) * 9 + 3 * dy + dx) * p.n_ch + ch) * 64);
          }
          if (shift_box) {
#pragma unroll
            for (int u = 0; u < SEGS; ++u) {
              const int seg = tid + 128 * u, r = seg / KCH, k = seg % KCH;
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const uint4 a = v[u][j], n = v[u][j + 1];
                uint4 o;
                if (dx == 0) {  // pixel n of the box is x0 − 1 + n: one element later
                  o.x = (n.x << 16) | (a.w >> 16);
                  o.y = (n.y << 16) | (n.x >> 16);
                  o.z = (n.z << 16) | (n.y >> 16);
                  o.w = (n.w << 16) | (n.z >> 16);
                } else {        // pixel n of the box is x0 + 1 + n: one element earlier
                  o.x = (a.x >> 16) | (a.y << 16);
                  o.y = (a.y >> 16) | (a.z << 16);
                  o.z = (a.z >> 16) | (a.w << 16);
                  o.w = (a.w >> 16) | (n.x << 16);
                }
                *reinterpret_cast<uint4*>(xs + r * TILE + swz(k, 8 * j)) = o;
              }
            }
          }
          if (!tma_box && !shift_box) {
            // the box element by element: row r, channel k, 8 pixels a task
            for (int task = tid; task < XR * KCH * (BN / 8); task += 128) {
              const int r = task / (KCH * (BN / 8)), k = (task / (BN / 8)) % KCH, j = task % (BN / 8);
              const int c = ch * KCH + k, y = y0 - 1 + r, xs0 = x0 + dx - 1 + 8 * j;
              uint16_t e[8];
              const bool row_in = c < p.C && y >= 0 && y < p.H;
              const uint16_t* src = reinterpret_cast<const uint16_t*>(p.x) + ((size_t)b * p.C + c) * hw +
                                    (size_t)y * p.W;
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const int xx = xs0 + i;
                e[i] = row_in && xx >= 0 && xx < p.W ? src[xx] : 0;
              }
              uint4 o;
              o.x = e[0] | (uint32_t)e[1] << 16;
              o.y = e[2] | (uint32_t)e[3] << 16;
              o.z = e[4] | (uint32_t)e[5] << 16;
              o.w = e[6] | (uint32_t)e[7] << 16;
              *reinterpret_cast<uint4*>(xs + r * TILE + swz(k, 8 * j)) = o;
            }
          }
          fence_async_smem();
          __syncwarp();
          if (lane == 0) mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int cw = wg - 1, warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const bool leader = (tid & 127) == 0;
  unsigned char* ot = sm + L::OUT + cw * 2 * TILE;  // this warpgroup's 2 output rows
  if (kResident) mbar_wait(wbar, 0);
  int it = 0, n_items = 0;
  float acc[64];
  for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++n_items) {
    int b, y0, x0, f0;
    item_coords(item, b, y0, x0, f0);
    const int yw = y0 + 2 * cw;  // this warpgroup's first output row
    if (kTMA && leader) {
      bulk_wait<0, true>();  // the previous item's store has read the output tile
      if (p.res) {
        mbar_arrive_expect_tx(&rbar[cw], 2 * TILE);
        tma_load_4d(ot, &tres, &rbar[cw], x0, p.res_block * p.F + f0, yw, b);
      }
    }
    bool first = true;
    for (int ch = 0; ch < p.n_ch; ++ch) {
      const int ksteps = min(4, k_total - ch * 4);
      for (int dx = 0; dx < 3; ++dx, ++it) {
        const int s = it % STAGES;
        const unsigned char* xs = sm + L::W_RES + s * L::STAGE;
        mbar_wait(&full[s], (it / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const unsigned char* wt = kResident ? sm + (3 * dy + dx) * TILE : xs + L::STAGE_X + dy * TILE;
          for (int ks = 0; ks < ksteps; ++ks) {
            SS<128, 0, 1>::run(acc, desc_sw128(wt + ks * 32),
                               desc_sw128_mn(xs + (2 * cw + dy) * TILE + ks * 2048, TILE), first ? 0 : 1);
            first = false;
          }
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (it > 0 && lane == 0 && !(ch == 0 && dx == 0)) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);

    // epilogue: d[4j + 2h + e] is output channel f0 + 16·warp + g + 8h,
    // pixel 8j + 2t + e of the warpgroup's two rows (j < 8: the first)
    if (kTMA) {
      if (p.res) mbar_wait(&rbar[cw], n_items & 1);
      else named_barrier(1 + cw, 128);  // the leader's wait for the previous store
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int fl = 16 * warp + g + 8 * hh, f = f0 + fl;
      const float bias = p.bias && f < p.F ? p.bias[f] : 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int rl = j >> 3, px = 8 * (j & 7) + 2 * t;
        float v0 = acc[4 * j + 2 * hh] + bias, v1 = acc[4 * j + 2 * hh + 1] + bias;
        if (kTMA) {
          uint32_t* cell = reinterpret_cast<uint32_t*>(ot + rl * TILE + swz(fl, px));
          if (p.res) {
            const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(cell);
            v0 += __low2float(r2);
            v1 += __high2float(r2);
          }
          if (p.relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          *cell = pack_bf16(v0, v1);
        } else {
          const int y = yw + rl, x = x0 + px;
          if (f >= p.F || y >= p.H) continue;
          const size_t hw = (size_t)p.H * p.W, o = (size_t)y * p.W + x;
          const float vv[2] = {v0, v1};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (x + e >= p.W) continue;
            float v = vv[e];
            if (p.res) v += __bfloat162float(p.res[((size_t)b * p.res_c + p.res_block * p.F + f) * hw + o + e]);
            if (p.relu) v = fmaxf(v, 0.f);
            p.out[((size_t)b * p.F + f) * hw + o + e] = __float2bfloat16(v);
          }
        }
      }
    }
    if (kTMA) {
      fence_async_smem();
      named_barrier(1 + cw, 128);
      if (leader) {
        tma_store_4d(&tout, ot, x0, f0, yw, b);
        bulk_commit();
      }
    }
  }
  if (kTMA && leader) bulk_wait<0, false>();
}

struct Maps {
  CUtensorMap x, w, out, res;
};

template <bool kTMA, bool kResident>
int launch(const Maps& m, const Params& p, cudaStream_t stream) {
  using L = Layout<kResident>;
  auto kernel = conv3x3_sm90_kernel<kTMA, kResident>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = p.items < sms ? p.items : sms;
  kernel<<<grid, THREADS, L::BYTES, stream>>>(m.x, m.w, m.out, m.res, p);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ fp32

constexpr int TH = 4, TW = 64;             // output pixel tile
constexpr int HP = TH + 2, WP = TW + 2;    // staged halo
constexpr int KC = 16;                     // input channels per chunk
constexpr int THREADS32 = 256;
constexpr int FT32 = 32;                   // output channels per block

__device__ __forceinline__ float epilogue(float acc, const Epilogue& ep, float resv, int f) {
  if (ep.bias) acc += ep.bias[f];
  acc += resv;
  return ep.relu ? fmaxf(acc, 0.f) : acc;
}

__global__ void __launch_bounds__(THREADS32)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ wk,
                   float* __restrict__ out, int C, int H, int W, int F, int f_pad, Epilogue ep) {
  __shared__ float xs[KC * HP * WP];
  __shared__ float ws[9 * FT32 * KC];
  const int n_ft = f_pad / FT32;
  const int b = blockIdx.z / n_ft, f0 = (blockIdx.z % n_ft) * FT32;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int orow = threadIdx.x / TW, ocol = threadIdx.x % TW;
  const long long HW = (long long)H * W;
  const float* xb = x + (long long)b * C * HW;

  float acc[FT32] = {};
  const int n_chunks = (C + KC - 1) / KC;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * KC;
    __syncthreads();
    for (int task = threadIdx.x; task < KC * HP * WP; task += THREADS32) {
      const int k = task / (HP * WP), pix = task % (HP * WP);
      const int y = y0 - 1 + pix / WP, xc = x0 - 1 + pix % WP;
      const bool in = y >= 0 && y < H && xc >= 0 && xc < W && c0 + k < C;
      xs[task] = in ? xb[(c0 + k) * HW + (long long)y * W + xc] : 0.f;
    }
    for (int task = threadIdx.x; task < 9 * FT32 * KC; task += THREADS32) {
      const int tap = task / (FT32 * KC), n = (task / KC) % FT32, k = task % KC;
      ws[task] = wk[(((long long)ch * 9 + tap) * f_pad + f0 + n) * KC + k];
    }
    __syncthreads();
    for (int k = 0; k < KC; ++k) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float xv = xs[(k * HP + orow + tap / 3) * WP + ocol + tap % 3];
        const float* wrow = ws + tap * FT32 * KC + k;
#pragma unroll
        for (int n = 0; n < FT32; ++n) acc[n] = fmaf(xv, wrow[n * KC], acc[n]);
      }
    }
  }

  const int y = y0 + orow, xc = x0 + ocol;
  if (y >= H || xc >= W) return;
  const float* res = static_cast<const float*>(ep.res);
  const long long o = (long long)y * W + xc;
#pragma unroll
  for (int n = 0; n < FT32; ++n) {
    const int f = f0 + n;
    if (f >= F) break;
    const float rv = res ? res[((long long)b * ep.res_c + ep.res_block * F + f) * HW + o] : 0.f;
    out[((long long)b * F + f) * HW + o] = epilogue(acc[n], ep, rv, f);
  }
}

}  // namespace

// x (B, C, H, W) bf16, wk (f_pad/64, 9, ⌈C/64⌉, 64, 64) bf16 packed weights
// ([f-tile, tap, channel chunk, output channel, input channel]), bias (F,)
// fp32 or null, res (B, res_c, H, W) bf16 or null → out (B, F, H, W) bf16.
// f_pad: F rounded up to 64.
extern "C" int conv3x3_cm_bf16(const void* x, const void* wk, const void* bias, const void* res,
                               void* out, int B, int C, int H, int W, int F, int f_pad, int res_c,
                               int res_block, int relu, void* stream) {
  if (f_pad % 64 != 0 || f_pad < F || C < 1 || F < 1) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  Params p;
  p.x = (const __nv_bfloat16*)x;
  p.res = (const __nv_bfloat16*)res;
  p.out = (__nv_bfloat16*)out;
  p.bias = (const float*)bias;
  p.B = B, p.C = C, p.H = H, p.W = W, p.F = F;
  p.n_f = f_pad / 64;
  p.n_ch = (C + KCH - 1) / KCH;
  p.n_x = (W + BN - 1) / BN;
  p.n_y = (H + ROWS - 1) / ROWS;
  const long long items = (long long)B * p.n_y * p.n_x * p.n_f;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  p.items = (int)items;
  p.res_c = res_c, p.res_block = res_block, p.relu = relu;
  const bool resident = p.n_ch == 1 && p.n_f == 1;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                          reinterpret_cast<uintptr_t>(res);
  Maps m = {};
  const long long wdims[2] = {64, (long long)p.n_f * 9 * p.n_ch * 64}, wstr[1] = {64};
  const int wbox[2] = {64, 64};
  if (!bf16_map(&m.w, wk, 2, wdims, wstr, wbox)) return (int)cudaErrorInvalidValue;
  bool tma = W % 8 == 0 && bases % 16 == 0;
  if (tma) {
    // (W, C, H, B) maps: a box is 64 pixels × 64 channels × rows, the
    // channel rows of one image row 128 bytes apart
    const long long hw = (long long)H * W;
    const long long xd[4] = {W, C, H, B}, xs[3] = {hw, W, (long long)C * hw};
    const long long od[4] = {W, F, H, B}, os[3] = {hw, W, (long long)F * hw};
    const long long rd[4] = {W, res_c, H, B}, rs[3] = {hw, W, (long long)res_c * hw};
    const int xb[4] = {BN, KCH, XR, 1}, ob[4] = {BN, 64, 2, 1};
    tma = bf16_map(&m.x, x, 4, xd, xs, xb) && bf16_map(&m.out, out, 4, od, os, ob) &&
          (!res || bf16_map(&m.res, res, 4, rd, rs, ob));
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (tma) return resident ? launch<true, true>(m, p, s) : launch<true, false>(m, p, s);
  return resident ? launch<false, true>(m, p, s) : launch<false, false>(m, p, s);
}

// The same in fp32: x, wk, res and out fp32, wk packed as (⌈C/16⌉, 9, f_pad,
// 16); f_pad: F rounded up to 32.
extern "C" int conv3x3_cm_f32(const void* x, const void* wk, const void* bias, const void* res,
                              void* out, int B, int C, int H, int W, int F, int f_pad, int res_c,
                              int res_block, int relu, void* stream) {
  if (f_pad % FT32 != 0 || f_pad < F) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * (f_pad / FT32));
  const Epilogue ep{static_cast<const float*>(bias), res, res_c, res_block, relu};
  conv3x3_f32_kernel<<<grid, THREADS32, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)wk, (float*)out, C, H, W, F, f_pad, ep);
  return (int)cudaGetLastError();
}
