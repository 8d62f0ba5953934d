// Flash attention forward (bf16 in, fp32 accumulation, bf16 out + fp32 LSE).
//
// Replaces: cellvit_tpu/ops/attention.py:32 `_flash_kernel` (pallas_call at
// :441 in `_flash_fwd_call`, reached through `flash_attention` :567).
//
// Computes o = softmax(q·kᵀ·scale)·v per (batch, head) over (B, N, H, ·)
// tensors without materialising the N×N logits, and the natural-log
// log-sum-exp of the scaled logits per query row. q and k may be wider than
// v (DQK ≥ DV): the rel-pos fallback and the rel-pos backward pass the
// lane-augmented q′ = [q·scale | Bh | Bw] and k′ = [k | 1{row} | 1{col}] with
// scale 1, DQK = D + gh + gw.
//
// Bound on the H100: 2·B·H·N²·(DQK + DV) matrix FLOPs (≈206 GFLOP at the
// ViT-256 path's (8, 4097, 6, 64), ≈0.21 ms at 989 TFLOP/s bf16) plus B·H·N²
// exponentials on the SFUs; the bytes (q, k, v, o ≈ 50 MB) take ≈0.015 ms,
// so the kernel is bound by operations. The online-softmax state stays in
// registers and both products run on the tensor cores with
// `mma.sync.m16n8k16` bf16 fragments (the S accumulator is re-packed in
// registers into the A operand of P·V, as in FlashAttention-2). k/v tiles
// arrive by `cp.async` into a 2-stage ring (the next tile's copies in
// flight while this one computes) and v is read back row-major with
// `ldmatrix.trans`. No wgmma/TMA yet.
//
// Layout: one block of 4 warps per (64-query tile, batch·head); each warp owns
// 16 query rows. q/k rows are staged with their width zero-padded to a
// multiple of 16 (no padded copy in memory); the kernel is instantiated for
// width buckets of 64, 128, 192 and 256 columns and skips the 16-column
// chunks past the real width. Keys at or beyond N are zero-filled and masked
// to -inf, so a ragged N (4097) needs no padding in memory. v's width DV is
// 64 or 80; DQK ≤ 256 and a multiple of 8 (16-byte rows).

#include <math.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;

template <int KCM, int DV>
size_t smem_bytes() {
  // q tile and two (k, v) tile stages
  return (size_t)(BQ + 2 * BK) * (KCM * 16 + 8) * 2 + (size_t)2 * BK * (DV + 8) * 2;
}

// KCM: the q/k width bucket in 16-column chunks (4, 8, 12 or 16); the first
// ceil(DQK / 16) chunks are live. DV: v's width.
template <int KCM, int DV>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int N, int H, int DQK, long long sq_b, long long sq_n,
                 long long sq_h, long long sk_b, long long sk_n, long long sk_h, long long sv_b,
                 long long sv_n, long long sv_h, float scale_log2) {
  constexpr int LDQ = KCM * 16 + 8;  // padded q/k row (bf16 elements): conflict-free fragment loads
  constexpr int LDV = DV + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ][LDQ]
  __nv_bfloat16* Ks = Qs + BQ * LDQ;                            // [2][BK][LDQ]
  __nv_bfloat16* Vs = Ks + 2 * BK * LDQ;                        // [2][BK][LDV], row-major

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int bhi = blockIdx.y, b = bhi / H, h = bhi % H;
  const __nv_bfloat16* qb = q + b * sq_b + h * sq_h;
  const __nv_bfloat16* kb = k + b * sk_b + h * sk_h;
  const __nv_bfloat16* vb = v + b * sv_b + h * sv_h;
  const int KC = (DQK + 15) / 16;  // live 16-column chunks
  const int QCH = KC * 2;          // 8-column (16-byte) chunks staged per q/k row

  // 64 rows from row r0 of `src` into `dst`, `nch` 16-byte chunks a row;
  // chunks past `width` columns and rows past N are zero-filled
  auto stage = [&](__nv_bfloat16* dst, int ld, const __nv_bfloat16* src, long long s_n, int r0,
                   int nch, int width) {
    for (int i = tid; i < 64 * nch; i += THREADS) {
      const int r = i / nch, c = (i - r * nch) * 8;
      const bool ok = r0 + r < N && c < width;
      cp_async16(&dst[r * ld + c], src + (ok ? (long long)(r0 + r) * s_n + c : 0), ok);
    }
  };
  auto load_kv = [&](int kt, int st) {
    stage(Ks + st * BK * LDQ, LDQ, kb, sk_n, kt * BK, QCH, DQK);
    stage(Vs + st * BK * LDV, LDV, vb, sv_n, kt * BK, DV / 8, DV);
  };
  stage(Qs, LDQ, qb, sq_n, q0, QCH, DQK);
  load_kv(0, 0);
  cp_async_commit();

  uint32_t qa[KCM][4];
  float acc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int n_tiles = (N + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_tiles) {  // prefetch the next tile into the other stage
      load_kv(kt + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and at kt = 0 the q tile) visible
    if (kt == 0) {
#pragma unroll
      for (int kc = 0; kc < KCM; ++kc)
        if (kc < KC) load_a(qa[kc], Qs, LDQ, warp * 16, kc * 16, g, t);
    }
    const __nv_bfloat16* Kt = Ks + st * BK * LDQ;
    const __nv_bfloat16* Vt = Vs + st * BK * LDV;

    // S = q·kᵀ for this warp's 16 rows × 64 keys: 8 n8 tiles
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KCM; ++kc) {
        if (kc < KC) {
          uint32_t b0, b1;
          load_b(b0, b1, Kt, LDQ, j * 8, kc * 16, g, t);
          mma(s[j], qa[kc], b0, b1);
        }
      }
    }
    // scale into base-2 space, mask keys >= N, row max over the quad
    const int k0 = kt * BK;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int key = k0 + j * 8 + 2 * t;
      const bool ok0 = key < N, ok1 = key + 1 < N;
      s[j][0] = ok0 ? s[j][0] * scale_log2 : -INFINITY;
      s[j][1] = ok1 ? s[j][1] * scale_log2 : -INFINITY;
      s[j][2] = ok0 ? s[j][2] * scale_log2 : -INFINITY;
      s[j][3] = ok1 ? s[j][3] * scale_log2 : -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
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
    for (int j = 0; j < DV / 8; ++j) {
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
      for (int jd = 0; jd < DV / 8; ++jd) {
        uint32_t b0, b1;
        load_b_trans(b0, b1, Vt, LDV, jd * 8, kk * 16, lane);
        mma(acc[jd], pa, b0, b1);
      }
    }
    __syncthreads();  // stage st consumed before the next prefetch overwrites it
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  // o is contiguous (B, N, H, DV)
  __nv_bfloat16* ob = o + (long long)b * N * H * DV + (long long)h * DV;
#pragma unroll
  for (int jd = 0; jd < DV / 8; ++jd) {
    int c = jd * 8 + 2 * t;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * H * DV + c) = pack(acc[jd][0] * inv0, acc[jd][1] * inv0);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * H * DV + c) = pack(acc[jd][2] * inv1, acc[jd][3] * inv1);
  }
  if (t == 0) {
    const float ln2 = 0.6931471805599453f;
    float* lb = lse + (long long)bhi * N;
    if (r0 < N) lb[r0] = m0 * ln2 + logf(fmaxf(l0, 1e-30f));
    if (r1 < N) lb[r1] = m1 * ln2 + logf(fmaxf(l1, 1e-30f));
  }
}

template <int KCM, int DV>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int N, int H,
           int DQK, const int* st, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<KCM, DV>();
  cudaError_t err = allow_smem(flash_fwd_kernel<KCM, DV>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<KCM, DV><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, (float*)lse, N, H, DQK, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int DV>
int launch_dv(const void* q, const void* k, const void* v, void* o, void* lse, int B, int N,
              int H, int DQK, const int* st, float scale, cudaStream_t s) {
  switch ((DQK + 63) / 64) {  // width bucket: 64, 128, 192 or 256 columns
    case 1: return launch<4, DV>(q, k, v, o, lse, B, N, H, DQK, st, scale, s);
    case 2: return launch<8, DV>(q, k, v, o, lse, B, N, H, DQK, st, scale, s);
    case 3: return launch<12, DV>(q, k, v, o, lse, B, N, H, DQK, st, scale, s);
    case 4: return launch<16, DV>(q, k, v, o, lse, B, N, H, DQK, st, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/k: (B, N, H, DQK) bf16, v: (B, N, H, DV) bf16, each with unit stride over
// its last dim and 16-byte rows; the batch, token and head strides
// (elements) are passed per tensor. o: a contiguous (B, N, H, DV) bf16
// output; lse: a contiguous (B, H, N) fp32 output. DV = 64 or 80; DQK ≤ 256,
// a multiple of 8.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int B, int N, int H, int DQK, int DV, int sq_b, int sq_n, int sq_h,
                              int sk_b, int sk_n, int sk_h, int sv_b, int sv_n, int sv_h,
                              float scale, void* stream) {
  if (N < 1 || DQK < 8 || DQK > 256 || DQK % 8) return (int)cudaErrorInvalidValue;
  const int st[9] = {sq_b, sq_n, sq_h, sk_b, sk_n, sk_h, sv_b, sv_n, sv_h};
  cudaStream_t s = (cudaStream_t)stream;
  if (DV == 64) return launch_dv<64>(q, k, v, o, lse, B, N, H, DQK, st, scale, s);
  if (DV == 80) return launch_dv<80>(q, k, v, o, lse, B, N, H, DQK, st, scale, s);
  return (int)cudaErrorInvalidValue;
}
