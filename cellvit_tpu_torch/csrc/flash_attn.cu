// Flash attention forward (bf16 in, fp32 accumulation, bf16 out + fp32 LSE).
//
// Replaces: cellvit_tpu/ops/attention.py:32 `_flash_kernel` (pallas_call at
// :441 in `_flash_fwd_call`, reached through `flash_attention` :567).
//
// Computes o = softmax(q·kᵀ·scale)·v per (batch, head) over (B, N, H, D)
// tensors without materialising the N×N logits, and the natural-log
// log-sum-exp of the scaled logits per query row.
//
// Bound on the H100: 4·B·H·N²·D matrix FLOPs (≈206 GFLOP at the main path's
// (8, 4097, 6, 64), ≈0.21 ms at 989 TFLOP/s bf16) plus B·H·N² exponentials on
// the SFUs; the bytes (q, k, v, o ≈ 50 MB) take ≈0.015 ms, so the kernel is
// bound by operations. This first version keeps the whole online-softmax
// state in registers and runs both products on the tensor cores with
// `mma.sync.m16n8k16` bf16 fragments (the S accumulator is re-packed in
// registers into the A operand of P·V, as in FlashAttention-2), but stages
// k/v synchronously through shared memory with no load/compute overlap and
// uses no wgmma/TMA: those are the next steps toward the bound.
//
// Layout: one block of 4 warps per (64-query tile, batch·head); each warp owns
// 16 query rows. Key/value tiles of 64 rows are staged in shared memory (v
// transposed so the B operand of P·V is a contiguous pair). Keys at or beyond
// N are zero-filled and masked to -inf, so a ragged N (4097) needs no padding
// in memory. Head dim D = 64 only; the wrapper raises on anything else.

#include <math.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr int D = 64;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int LD = D + 8;   // padded smem row (bf16 elements): conflict-free fragment loads
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int N, int H, long long sq_b, long long sq_n, long long sk_b,
                 long long sk_n, long long sv_b, long long sv_n, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 Qs[BQ * LD];
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 Vt[D * LD];  // [d][key]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const __nv_bfloat16* qb = q + b * sq_b + (long long)h * D;
  const __nv_bfloat16* kb = k + b * sk_b + (long long)h * D;
  const __nv_bfloat16* vb = v + b * sv_b + (long long)h * D;

  // stage the q tile: 64 rows × 8 chunks of 16 bytes
  for (int i = tid; i < BQ * (D / 8); i += THREADS) {
    int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < N) val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * sq_n + c);
    *reinterpret_cast<uint4*>(&Qs[r * LD + c]) = val;
  }
  __syncthreads();
  uint32_t qa[D / 16][4];
  const int qr = warp * 16 + g;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    qa[kc][0] = *reinterpret_cast<const uint32_t*>(&Qs[qr * LD + kc * 16 + 2 * t]);
    qa[kc][1] = *reinterpret_cast<const uint32_t*>(&Qs[(qr + 8) * LD + kc * 16 + 2 * t]);
    qa[kc][2] = *reinterpret_cast<const uint32_t*>(&Qs[qr * LD + kc * 16 + 8 + 2 * t]);
    qa[kc][3] = *reinterpret_cast<const uint32_t*>(&Qs[(qr + 8) * LD + kc * 16 + 8 + 2 * t]);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int n_tiles = (N + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < BK * (D / 8); i += THREADS) {
      int r = i / (D / 8), c = (i % (D / 8)) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < N) {
        kv = *reinterpret_cast<const uint4*>(kb + (k0 + r) * sk_n + c);
        vv = *reinterpret_cast<const uint4*>(vb + (k0 + r) * sv_n + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r * LD + c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(c + e) * LD + r] = ve[e];
    }
    __syncthreads();

    // S = q·kᵀ for this warp's 16 rows × 64 keys: 8 n8 tiles
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(&Ks[(j * 8 + g) * LD + kc * 16 + 2 * t]);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(&Ks[(j * 8 + g) * LD + kc * 16 + 8 + 2 * t]);
        mma(s[j], qa[kc], b0, b1);
      }
    }
    // scale into base-2 space, mask keys >= N, row max over the quad
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      int key = k0 + j * 8 + 2 * t;
      bool ok0 = key < N, ok1 = key + 1 < N;
      s[j][0] = ok0 ? s[j][0] * scale_log2 : -INFINITY;
      s[j][1] = ok1 ? s[j][1] * scale_log2 : -INFINITY;
      s[j][2] = ok0 ? s[j][2] * scale_log2 : -INFINITY;
      s[j][3] = ok1 ? s[j][3] * scale_log2 : -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // key 0 lies in tile 0, so the running max is finite from the first tile on
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l0 = l0 * al0 + rs0;  // per-thread partial; reduced over the quad at the end
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= al0;
      acc[j][1] *= al0;
      acc[j][2] *= al1;
      acc[j][3] *= al1;
    }
    // o += P·v: the S accumulators of key tiles (2kk, 2kk+1) form the A operand
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd) {
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(&Vt[(jd * 8 + g) * LD + kk * 16 + 2 * t]);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(&Vt[(jd * 8 + g) * LD + kk * 16 + 8 + 2 * t]);
        mma(acc[jd], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  // o is contiguous (B, N, H, D)
  __nv_bfloat16* ob = o + (long long)b * N * H * D + (long long)h * D;
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) {
    int c = jd * 8 + 2 * t;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * H * D + c) = pack(acc[jd][0] * inv0, acc[jd][1] * inv0);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * H * D + c) = pack(acc[jd][2] * inv1, acc[jd][3] * inv1);
  }
  if (t == 0) {
    const float ln2 = 0.6931471805599453f;
    float* lb = lse + (long long)bh * N;
    if (r0 < N) lb[r0] = m0 * ln2 + logf(fmaxf(l0, 1e-30f));
    if (r1 < N) lb[r1] = m1 * ln2 + logf(fmaxf(l1, 1e-30f));
  }
}

}  // namespace

// q/k/v: (B, N, H, 64) bf16 with unit stride over D and stride 64 over H;
// the batch and token strides (in elements) are passed per tensor. o: a
// contiguous (B, N, H, 64) bf16 output; lse: a contiguous (B, H, N) fp32 output.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                              void* lse, int B, int N, int H, int D_, int sq_b,
                              int sq_n, int sk_b, int sk_n, int sv_b, int sv_n,
                              float scale, void* stream) {
  if (D_ != D) return (int)cudaErrorInvalidValue;
  dim3 grid((N + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, (float*)lse, N, H, sq_b, sq_n, sk_b, sk_n, sv_b, sv_n,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
