// Whole-window attention forward on lane-augmented q′/k′ (bf16 in, fp32
// accumulation, bf16 out).
//
// Replaces: cellvit_tpu/ops/attention.py:257 `_win_attn_kernel` (pallas_call
// at :332 in `_win_fwd`, reached through `window_attention` :404 from
// `flash_attention_relpos` for grids of N ≤ 256 tokens).
//
// Computes o = softmax(q′·k′ᵀ)·v per (batch, head) for N ≤ 256 tokens with no
// scale: the caller folded the scale and the rel-pos bias into the lanes,
// q′ = [q·scale | Bh | Bw] and k′ = [k | 1{row} | 1{col}] (`relpos_aug`), so
// q′ and k′ are DQK = D + gh + gw wide (110 for SAM-H's 14×16 grid) and v is
// D wide.
//
// Bound on the H100: 2·B·H·N²·(DQK + D) matrix FLOPs, ≈0.3 GFLOP at a
// 224×256 tile (16 heads, N = 224) — ≈0.3 µs at 989 TFLOP/s — against
// ≈2.7 MB of q′/k′/v/o, ≈0.8 µs at 3.35 TB/s: bound by bytes, and at this
// size by launch latency. The whole logits row of a query tile fits in
// registers (N ≤ 256 keys: 16 rows × 256 keys per warp is 128 fp32 per
// thread), so there is no online softmax: pass 1 computes every logit of the
// row and its max, the exponentials and their sum stay in registers, and
// pass 2 runs P·V on the tensor cores (`mma.sync.m16n8k16`).
//
// Layout: one block of 4 warps per (64-query tile, batch·head); each warp
// owns 16 query rows. q′ and k′ are staged 64 rows at a time into shared
// memory with their width zero-padded to a multiple of 16 in the kernel
// (no padded copy in memory); keys at or beyond N are masked to -inf and v
// rows beyond N are zero. v's head dim D = 64 or 80; DQK ≤ 288.

#include <math.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int LDV = BK + 8;
constexpr int THREADS = 128;

template <int D, int NT>
__global__ void __launch_bounds__(THREADS)
win_attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int N,
                int H, int DQK, int DQKP, long long sq_b, long long sq_n, long long sq_h,
                long long sk_b, long long sk_n, long long sk_h, long long sv_b, long long sv_n,
                long long sv_h) {
  const int LDQ = DQKP + 8;  // padded q′/k′ row (bf16 elements)
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ][LDQ]
  __nv_bfloat16* Ks = Qs + BQ * LDQ;                            // [BK][LDQ]
  __nv_bfloat16* Vt = Ks + BK * LDQ;                            // [D][LDV], v transposed

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int bhi = blockIdx.y, b = bhi / H, h = bhi % H;
  const __nv_bfloat16* qb = q + b * sq_b + h * sq_h;
  const __nv_bfloat16* kb = k + b * sk_b + h * sk_h;
  const __nv_bfloat16* vb = v + b * sv_b + h * sv_h;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  for (int i = tid; i < BQ * DQKP; i += THREADS) {
    int r = i / DQKP, c = i - r * DQKP;
    Qs[r * LDQ + c] = (q0 + r < N && c < DQK) ? qb[(q0 + r) * sq_n + c] : zero;
  }

  // pass 1: every logit of this warp's 16 rows, key tile by key tile
  float s[NT][BK / 8][4];
  const int KS = DQKP / 16;
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // q′ staged / previous k′ tile consumed
    for (int i = tid; i < BK * DQKP; i += THREADS) {
      int r = i / DQKP, c = i - r * DQKP;
      Ks[r * LDQ + c] = (k0 + r < N && c < DQK) ? kb[(k0 + r) * sk_n + c] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[kt][j][0] = s[kt][j][1] = s[kt][j][2] = s[kt][j][3] = 0.f;
    for (int kc = 0; kc < KS; ++kc) {
      uint32_t a[4];
      load_a(a, Qs, LDQ, warp * 16, kc * 16, g, t);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        uint32_t b0, b1;
        load_b(b0, b1, Ks, LDQ, j * 8, kc * 16, g, t);
        mma(s[kt][j], a, b0, b1);
      }
    }
  }

  // mask keys >= N, row max, exponentials and row sum (base 2)
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (kt * BK + j * 8 + 2 * t + e >= N) s[kt][j][e] = s[kt][j][2 + e] = -INFINITY;
        mx0 = fmaxf(mx0, s[kt][j][e]);
        mx1 = fmaxf(mx1, s[kt][j][2 + e]);
      }
    }
  }
  mx0 = quad_max(mx0) * LOG2E;  // key 0 < N: finite
  mx1 = quad_max(mx1) * LOG2E;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[kt][j][0] = exp2f(s[kt][j][0] * LOG2E - mx0);
      s[kt][j][1] = exp2f(s[kt][j][1] * LOG2E - mx0);
      s[kt][j][2] = exp2f(s[kt][j][2] * LOG2E - mx1);
      s[kt][j][3] = exp2f(s[kt][j][3] * LOG2E - mx1);
      l0 += s[kt][j][0] + s[kt][j][1];
      l1 += s[kt][j][2] + s[kt][j][3];
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // pass 2: o = P·v, v tile by tile
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // k′ / previous v tile consumed
    for (int i = tid; i < BK * (D / 8); i += THREADS) {
      int r = i / (D / 8), c = (i % (D / 8)) * 8;
      uint4 vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < N) vv = *reinterpret_cast<const uint4*>(vb + (k0 + r) * sv_n + c);
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(c + e) * LDV + r] = ve[e];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack(s[kt][2 * kk][0], s[kt][2 * kk][1]);
      pa[1] = pack(s[kt][2 * kk][2], s[kt][2 * kk][3]);
      pa[2] = pack(s[kt][2 * kk + 1][0], s[kt][2 * kk + 1][1]);
      pa[3] = pack(s[kt][2 * kk + 1][2], s[kt][2 * kk + 1][3]);
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd) {
        uint32_t b0, b1;
        load_b(b0, b1, Vt, LDV, jd * 8, kk * 16, g, t);
        mma(acc[jd], pa, b0, b1);
      }
    }
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
}

template <int D, int NT>
int launch(const void* q, const void* k, const void* v, void* o, int B, int N, int H, int DQK,
           const int* st, cudaStream_t stream) {
  const int DQKP = (DQK + 15) / 16 * 16;
  const size_t smem = (size_t)(BQ + BK) * (DQKP + 8) * 2 + (size_t)D * LDV * 2;
  cudaError_t err = allow_smem(win_attn_kernel<D, NT>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BQ - 1) / BQ, B * H);
  win_attn_kernel<D, NT><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, N, H, DQK, DQKP, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8]);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B, int N, int H,
             int DQK, const int* st, cudaStream_t s) {
  switch ((N + BK - 1) / BK) {
    case 1: return launch<D, 1>(q, k, v, o, B, N, H, DQK, st, s);
    case 2: return launch<D, 2>(q, k, v, o, B, N, H, DQK, st, s);
    case 3: return launch<D, 3>(q, k, v, o, B, N, H, DQK, st, s);
    case 4: return launch<D, 4>(q, k, v, o, B, N, H, DQK, st, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q′/k′: (B, N, H, DQK) bf16 with unit stride over DQK; v: (B, N, H, D) bf16
// with unit stride over D and 16-byte rows; the batch, token and head strides
// (elements) are passed per tensor. o: a contiguous (B, N, H, D) bf16 output.
// N ≤ 256, D = 64 or 80, DQK ≤ 288.
extern "C" int win_attn_fwd(const void* q, const void* k, const void* v, void* o, int B, int N,
                            int H, int DQK, int D, int sq_b, int sq_n, int sq_h, int sk_b,
                            int sk_n, int sk_h, int sv_b, int sv_n, int sv_h, void* stream) {
  if (N < 1 || N > 4 * BK || DQK < 1 || DQK > 288) return (int)cudaErrorInvalidValue;
  const int st[9] = {sq_b, sq_n, sq_h, sk_b, sk_n, sk_h, sv_b, sv_n, sv_h};
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64) return launch_d<64>(q, k, v, o, B, N, H, DQK, st, s);
  if (D == 80) return launch_d<80>(q, k, v, o, B, N, H, DQK, st, s);
  return (int)cudaErrorInvalidValue;
}
