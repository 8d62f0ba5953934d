// SAME 3×3 convolution on a channel-major (B, C, H, W) tensor with a fused
// epilogue: + bias, + channels [res_block·F, (res_block+1)·F) of `res`, an
// optional ReLU, the cast to the input's type. fp32 accumulation.
//
// Replaces (cellvit_tpu/ops/conv_cm.py): `_conv3x3_kernel` :80 (pallas_call
// :201, `conv3x3_cm`).
//
// The Pallas kernel builds a 9C-deep im2col panel of each row block in VMEM
// and multiplies it on the matrix unit. Here bf16 runs as an implicit GEMM
// on the tensor cores (`mma.sync` m16n8k16): M = pixels, N = F, K = 9·C.
// A block owns a 4 × 64 pixel tile and 64 output channels; for each chunk of
// 16 input channels it stages the tile's 6 × 66 halo pixel-major (16
// channels of a pixel contiguous, rows padded to 24 so that the fragment
// loads of eight consecutive pixels hit distinct banks; the transposition
// from channel-major happens in the staging loads) and the chunk's 9 taps of
// weights, pre-packed by the wrapper as (C/16, 9, F_pad, 16). A tap's shift
// is then only a shift of the A fragment's pixel rows. Zero padding at the
// image edges, channels past C and outputs past F are zeros in shared
// memory. fp32 runs the same tiling as a plain FFMA loop, one pixel and 32
// output channels a thread.
//
// Bound on the H100 at (8, 64, 1024, 1024) → 64, bf16: x read and out
// written once, 2 × 1.07 GB (≈0.64 ms at 3.35 TB/s), above the 2·B·H·W·F·9C
// = 618 GFLOP (≈0.63 ms at 989 TFLOP/s). This first version stages
// synchronously (no cp.async ring) and re-reads the weights from L2 in every
// block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int TH = 4, TW = 64;             // output pixel tile
constexpr int HP = TH + 2, WP = TW + 2;    // staged halo
constexpr int KC = 16;                     // input channels per chunk
constexpr int THREADS = 256;
constexpr int FT = 64;                     // bf16: output channels per block
constexpr int XP = 24;                     // bf16: padded pixel / weight row (elements)
constexpr int FT32 = 32;                   // fp32: output channels per block

struct Epilogue {
  const float* bias;
  const void* res;
  int res_c, res_block, relu;
};

__device__ __forceinline__ float epilogue(float acc, const Epilogue& ep, float resv, int f) {
  if (ep.bias) acc += ep.bias[f];
  acc += resv;
  return ep.relu ? fmaxf(acc, 0.f) : acc;
}

__global__ void __launch_bounds__(THREADS)
conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wk,
                    __nv_bfloat16* __restrict__ out, int C, int H, int W, int F, int f_pad,
                    Epilogue ep) {
  __shared__ __align__(16) __nv_bfloat16 xs[HP * WP * XP];
  __shared__ __align__(16) __nv_bfloat16 ws[9 * FT * XP];
  const int n_ft = f_pad / FT;
  const int b = blockIdx.z / n_ft, f0 = (blockIdx.z % n_ft) * FT;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int orow = warp >> 1, ocol = (warp & 1) * 32;  // this warp's 32 pixels
  const long long HW = (long long)H * W;
  const __nv_bfloat16* xb = x + (long long)b * C * HW;

  float acc[2][FT / 8][4] = {};
  const int n_chunks = (C + KC - 1) / KC;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * KC;
    __syncthreads();
    // halo pixels, two channels a task: consecutive tasks are consecutive
    // columns, so the global reads of a warp are contiguous
    for (int task = threadIdx.x; task < (KC / 2) * HP * WP; task += THREADS) {
      const int pair = task / (HP * WP), pix = task % (HP * WP);
      const int y = y0 - 1 + pix / WP, xc = x0 - 1 + pix % WP;
      const int c = c0 + 2 * pair;
      const bool in = y >= 0 && y < H && xc >= 0 && xc < W;
      const long long o = (long long)y * W + xc;
      __nv_bfloat162 v;
      v.x = (in && c < C) ? xb[c * HW + o] : __float2bfloat16(0.f);
      v.y = (in && c + 1 < C) ? xb[(c + 1) * HW + o] : __float2bfloat16(0.f);
      *reinterpret_cast<__nv_bfloat162*>(&xs[pix * XP + 2 * pair]) = v;
    }
    // the chunk's weights: 9 taps × FT rows of 16, two 16-byte halves a row
    for (int task = threadIdx.x; task < 9 * FT * 2; task += THREADS) {
      const int row = task >> 1, half = task & 1;
      const int tap = row / FT, n = row % FT;
      const uint4* src = reinterpret_cast<const uint4*>(
          wk + (((long long)ch * 9 + tap) * f_pad + f0 + n) * KC + half * 8);
      *reinterpret_cast<uint4*>(&ws[row * XP + half * 8]) = *src;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int p = (orow + dy) * WP + ocol + mt * 16 + dx;  // halo pixel of row g
        a[mt][0] = mma_bf16::ld32(xs + (p + g) * XP + 2 * t);
        a[mt][1] = mma_bf16::ld32(xs + (p + g + 8) * XP + 2 * t);
        a[mt][2] = mma_bf16::ld32(xs + (p + g) * XP + 8 + 2 * t);
        a[mt][3] = mma_bf16::ld32(xs + (p + g + 8) * XP + 8 + 2 * t);
      }
#pragma unroll
      for (int nt = 0; nt < FT / 8; ++nt) {
        uint32_t b0, b1;
        mma_bf16::load_b(b0, b1, ws + tap * FT * XP, XP, nt * 8, 0, g, t);
        mma_bf16::mma(acc[0][nt], a[0], b0, b1);
        mma_bf16::mma(acc[1][nt], a[1], b0, b1);
      }
    }
  }

  const int y = y0 + orow;
  if (y >= H) return;
  const __nv_bfloat16* res = static_cast<const __nv_bfloat16*>(ep.res);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int xc = x0 + ocol + mt * 16 + g + 8 * half;
      if (xc >= W) continue;
#pragma unroll
      for (int nt = 0; nt < FT / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = f0 + nt * 8 + 2 * t + e;
          if (f >= F) continue;
          const long long o = (long long)y * W + xc;
          const float rv = res ? __bfloat162float(
              res[((long long)b * ep.res_c + ep.res_block * F + f) * HW + o]) : 0.f;
          const float v = epilogue(acc[mt][nt][2 * half + e], ep, rv, f);
          out[((long long)b * F + f) * HW + o] = __float2bfloat16(v);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
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
    for (int task = threadIdx.x; task < KC * HP * WP; task += THREADS) {
      const int k = task / (HP * WP), pix = task % (HP * WP);
      const int y = y0 - 1 + pix / WP, xc = x0 - 1 + pix % WP;
      const bool in = y >= 0 && y < H && xc >= 0 && xc < W && c0 + k < C;
      xs[task] = in ? xb[(c0 + k) * HW + (long long)y * W + xc] : 0.f;
    }
    for (int task = threadIdx.x; task < 9 * FT32 * KC; task += THREADS) {
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

// x (B, C, H, W) bf16, wk (ceil(C/16), 9, f_pad, 16) bf16 packed weights,
// bias (F,) fp32 or null, res (B, res_c, H, W) bf16 or null → out (B, F, H,
// W) bf16. f_pad: F rounded up to 64.
extern "C" int conv3x3_cm_bf16(const void* x, const void* wk, const void* bias, const void* res,
                               void* out, int B, int C, int H, int W, int F, int f_pad, int res_c,
                               int res_block, int relu, void* stream) {
  if (f_pad % FT != 0 || f_pad < F) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * (f_pad / FT));
  const Epilogue ep{static_cast<const float*>(bias), res, res_c, res_block, relu};
  conv3x3_bf16_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)wk, (__nv_bfloat16*)out, C, H, W, F, f_pad,
      ep);
  return (int)cudaGetLastError();
}

// The same in fp32: x, wk, res and out fp32; f_pad: F rounded up to 32.
extern "C" int conv3x3_cm_f32(const void* x, const void* wk, const void* bias, const void* res,
                              void* out, int B, int C, int H, int W, int F, int f_pad, int res_c,
                              int res_block, int relu, void* stream) {
  if (f_pad % FT32 != 0 || f_pad < F) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * (f_pad / FT32));
  const Epilogue ep{static_cast<const float*>(bias), res, res_c, res_block, relu};
  conv3x3_f32_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)wk, (float*)out, C, H, W, F, f_pad, ep);
  return (int)cudaGetLastError();
}
