// Flash attention backward (bf16 in, fp32 accumulation, bf16 gradients).
//
// Replaces: cellvit_tpu/ops/attention.py:106 `_flash_bwd_dq_kernel` (B8a,
// pallas_call at :495) and :143 `_flash_bwd_dkv_kernel` (B8b, pallas_call at
// :514), both in `_flash_core_bwd`, the custom VJP of `flash_attention`.
//
// With p = exp(q·kᵀ·scale − lse) recomputed per tile from the forward's
// natural-log lse, Δ = rowsum(do ∘ o) (a torch op outside), dp = do·vᵀ and
// ds = p ∘ (dp − Δ)·scale:
//   B8a, one block per (64-query tile, batch·head), loops over key tiles:
//       dq = Σ_keys ds·k;
//   B8b, one block per (64-key tile, batch·head), loops over query tiles:
//       dv = Σ_queries pᵀ·do,  dk = Σ_queries dsᵀ·q.
// q and k may be wider than v (DQK ≥ DV), as in the forward.
//
// Bound on the H100: B8a runs 2·N²·(2·DQK + DV) and B8b 2·N²·(2·DQK + 2·DV)
// matrix FLOPs per (batch, head) — ≈155 and ≈206 GFLOP at the CellViT-256
// training step's (4, 4097, 6, 64), ≈0.16 and ≈0.21 ms at 989 TFLOP/s — plus
// N² exponentials each; their bytes (q, k, v, do, o and the gradients,
// ≈40 MB) take ≈0.012 ms. Both are bound by operations. Every product runs on
// the tensor cores with `mma.sync.m16n8k16` bf16 fragments: p and ds are
// re-packed in registers from the fp32 accumulators into the A operand of
// the next product, and the operands read as B transposed (k for dq, do and
// q for dv and dk) come out of row-major shared memory with `ldmatrix.trans`.
// The streamed tiles arrive by `cp.async` into a 2-stage ring. No
// wgmma/TMA yet.
//
// Ragged N needs no padding in memory: rows at or beyond N are zero-filled as
// they are staged, p is set to 0 for keys ≥ N in both kernels, and B8b also
// sets p (and so ds) to 0 for queries ≥ N, whose lse and Δ it never reads. q/k
// rows are staged with their width zero-padded to a multiple of 16; the
// kernels are instantiated for width buckets of 64, 128, 192 and 256 columns
// and skip the 16-column chunks past the real width. DV = 64 or 80.

#include <math.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;

struct Strides {
  long long q_b, q_n, q_h, k_b, k_n, k_h, v_b, v_n, v_h;
};

// 64 rows from row r0 of `src` into `dst`, `nch` 16-byte chunks a row; chunks
// past `width` columns and rows past N are zero-filled
__device__ __forceinline__ void stage(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                      long long s_n, int r0, int nch, int width, int N, int tid) {
  for (int i = tid; i < 64 * nch; i += THREADS) {
    const int r = i / nch, c = (i - r * nch) * 8;
    const bool ok = r0 + r < N && c < width;
    cp_async16(&dst[r * ld + c], src + (ok ? (long long)(r0 + r) * s_n + c : 0), ok);
  }
}

template <int KCM, int DV>
size_t dq_smem_bytes() {
  // q and do tiles, two (k, v) tile stages
  return (size_t)(BQ + 2 * BK) * (KCM * 16 + 8) * 2 + (size_t)(BQ + 2 * BK) * (DV + 8) * 2;
}

template <int KCM, int DV>
size_t dkv_smem_bytes() {
  // k and v tiles, two (q, do, lse, Δ) tile stages
  return (size_t)(BK + 2 * BQ) * (KCM * 16 + 8) * 2 + (size_t)(BK + 2 * BQ) * (DV + 8) * 2 +
         (size_t)2 * 2 * BQ * 4;
}

// B8a: dq for one 64-query tile. do is contiguous (B, N, H, DV); lse and Δ
// contiguous (B, H, N); dq a contiguous (B, N, H, DQK) output.
template <int KCM, int DV>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int N, int H, int DQK, Strides sd,
                    float scale) {
  constexpr int LDQ = KCM * 16 + 8;
  constexpr int LDV = DV + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ][LDQ]
  __nv_bfloat16* Ks = Qs + BQ * LDQ;                            // [2][BK][LDQ]
  __nv_bfloat16* Os = Ks + 2 * BK * LDQ;                        // [BQ][LDV]: do
  __nv_bfloat16* Vs = Os + BQ * LDV;                            // [2][BK][LDV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int bhi = blockIdx.y, b = bhi / H, h = bhi % H;
  const __nv_bfloat16* qb = q + b * sd.q_b + h * sd.q_h;
  const __nv_bfloat16* kb = k + b * sd.k_b + h * sd.k_h;
  const __nv_bfloat16* vb = v + b * sd.v_b + h * sd.v_h;
  const __nv_bfloat16* ob = dout + ((long long)b * N * H + h) * DV;
  const int KC = (DQK + 15) / 16;
  const float slog2 = scale * LOG2E;

  auto load_kv = [&](int kt, int st) {
    stage(Ks + st * BK * LDQ, LDQ, kb, sd.k_n, kt * BK, KC * 2, DQK, N, tid);
    stage(Vs + st * BK * LDV, LDV, vb, sd.v_n, kt * BK, DV / 8, DV, N, tid);
  };
  stage(Qs, LDQ, qb, sd.q_n, q0, KC * 2, DQK, N, tid);
  stage(Os, LDV, ob, (long long)H * DV, q0, DV / 8, DV, N, tid);
  load_kv(0, 0);
  cp_async_commit();

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two query rows
  const float* lb = lse + (long long)bhi * N;
  const float* db = delta + (long long)bhi * N;
  const float lse0 = r0 < N ? lb[r0] * LOG2E : 0.f, lse1 = r1 < N ? lb[r1] * LOG2E : 0.f;
  const float dl0 = r0 < N ? db[r0] : 0.f, dl1 = r1 < N ? db[r1] : 0.f;

  uint32_t da[DV / 16][4];
  float acc[KCM * 2][4];
#pragma unroll
  for (int j = 0; j < KCM * 2; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int n_tiles = (N + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_tiles) {
      load_kv(kt + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kc = 0; kc < DV / 16; ++kc) load_a(da[kc], Os, LDV, warp * 16, kc * 16, g, t);
    }
    const __nv_bfloat16* Kt = Ks + st * BK * LDQ;
    const __nv_bfloat16* Vt = Vs + st * BK * LDV;

    // S = q·kᵀ, 16 rows × 64 keys
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KCM; ++kc) {
      if (kc < KC) {
        uint32_t a[4];
        load_a(a, Qs, LDQ, warp * 16, kc * 16, g, t);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          uint32_t b0, b1;
          load_b(b0, b1, Kt, LDQ, j * 8, kc * 16, g, t);
          mma(s[j], a, b0, b1);
        }
      }
    }
    // p = exp(s·scale − lse); keys >= N give 0
    const int k0 = kt * BK;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = k0 + j * 8 + 2 * t + e < N;
        s[j][e] = ok ? exp2f(s[j][e] * slog2 - lse0) : 0.f;
        s[j][2 + e] = ok ? exp2f(s[j][2 + e] * slog2 - lse1) : 0.f;
      }
    }
    // dp = do·vᵀ
    float dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < DV / 16; ++kc) {
        uint32_t b0, b1;
        load_b(b0, b1, Vt, LDV, j * 8, kc * 16, g, t);
        mma(dp[j], da[kc], b0, b1);
      }
    }
    // ds = p ∘ (dp − Δ)·scale, into s
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] *= (dp[j][0] - dl0) * scale;
      s[j][1] *= (dp[j][1] - dl0) * scale;
      s[j][2] *= (dp[j][2] - dl1) * scale;
      s[j][3] *= (dp[j][3] - dl1) * scale;
    }
    // dq += ds·k: ds of key tiles (2kk, 2kk+1) is the A operand, k read transposed
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int jn = 0; jn < KCM * 2; ++jn) {
        if (jn < KC * 2) {
          uint32_t b0, b1;
          load_b_trans(b0, b1, Kt, LDQ, jn * 8, kk * 16, lane);
          mma(acc[jn], pa, b0, b1);
        }
      }
    }
    __syncthreads();  // stage st consumed before the next prefetch overwrites it
  }

  __nv_bfloat16* qo = dq + ((long long)b * N * H + h) * DQK;
#pragma unroll
  for (int jn = 0; jn < KCM * 2; ++jn) {
    const int c = jn * 8 + 2 * t;
    if (c >= DQK) continue;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(qo + (long long)r0 * H * DQK + c) = pack(acc[jn][0], acc[jn][1]);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(qo + (long long)r1 * H * DQK + c) = pack(acc[jn][2], acc[jn][3]);
  }
}

// B8b: dk and dv for one 64-key tile. do is contiguous (B, N, H, DV); lse and
// Δ contiguous (B, H, N); dk and dv contiguous (B, N, H, DQK) and
// (B, N, H, DV) outputs.
template <int KCM, int DV>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int N,
                     int H, int DQK, Strides sd, float scale) {
  constexpr int LDQ = KCM * 16 + 8;
  constexpr int LDV = DV + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [BK][LDQ]
  __nv_bfloat16* Qs = Ks + BK * LDQ;                            // [2][BQ][LDQ]
  __nv_bfloat16* Vs = Qs + 2 * BQ * LDQ;                        // [BK][LDV]
  __nv_bfloat16* Os = Vs + BK * LDV;                            // [2][BQ][LDV]: do
  float* Ls = reinterpret_cast<float*>(Os + 2 * BQ * LDV);      // [2][BQ]: lse·log2(e)
  float* Ds = Ls + 2 * BQ;                                      // [2][BQ]: Δ

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK;
  const int bhi = blockIdx.y, b = bhi / H, h = bhi % H;
  const __nv_bfloat16* qb = q + b * sd.q_b + h * sd.q_h;
  const __nv_bfloat16* kb = k + b * sd.k_b + h * sd.k_h;
  const __nv_bfloat16* vb = v + b * sd.v_b + h * sd.v_h;
  const __nv_bfloat16* ob = dout + ((long long)b * N * H + h) * DV;
  const float* lb = lse + (long long)bhi * N;
  const float* db = delta + (long long)bhi * N;
  const int KC = (DQK + 15) / 16;
  const float slog2 = scale * LOG2E;

  // one query tile into stage `st`; lse and Δ of queries >= N are never read
  auto load_q = [&](int qt, int st) {
    const int q0 = qt * BQ;
    stage(Qs + st * BQ * LDQ, LDQ, qb, sd.q_n, q0, KC * 2, DQK, N, tid);
    stage(Os + st * BQ * LDV, LDV, ob, (long long)H * DV, q0, DV / 8, DV, N, tid);
    if (tid < BQ) {
      const bool ok = q0 + tid < N;
      Ls[st * BQ + tid] = ok ? lb[q0 + tid] * LOG2E : 0.f;
      Ds[st * BQ + tid] = ok ? db[q0 + tid] : 0.f;
    }
  };
  stage(Ks, LDQ, kb, sd.k_n, k0, KC * 2, DQK, N, tid);
  stage(Vs, LDV, vb, sd.v_n, k0, DV / 8, DV, N, tid);
  load_q(0, 0);
  cp_async_commit();

  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;  // this thread's two keys
  float dka[KCM * 2][4], dva[DV / 8][4];
#pragma unroll
  for (int j = 0; j < KCM * 2; ++j) dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;

  const int n_tiles = (N + BQ - 1) / BQ;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int st = qt & 1;
    if (qt + 1 < n_tiles) {
      load_q(qt + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Qt = Qs + st * BQ * LDQ;
    const __nv_bfloat16* Ot = Os + st * BQ * LDV;
    const float* Lt = Ls + st * BQ;
    const float* Dt = Ds + st * BQ;
    const int q0 = qt * BQ;

    // Sᵀ = k·qᵀ, 16 keys × 64 queries
    float s[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KCM; ++kc) {
      if (kc < KC) {
        uint32_t a[4];
        load_a(a, Ks, LDQ, warp * 16, kc * 16, g, t);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          uint32_t b0, b1;
          load_b(b0, b1, Qt, LDQ, j * 8, kc * 16, g, t);
          mma(s[j], a, b0, b1);
        }
      }
    }
    // pᵀ = exp(sᵀ·scale − lse[query]); keys >= N and queries >= N give 0
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = j * 8 + 2 * t + e;
        const bool okq = q0 + qi < N;
        const float l = Lt[qi];
        s[j][e] = okq && key0 < N ? exp2f(s[j][e] * slog2 - l) : 0.f;
        s[j][2 + e] = okq && key1 < N ? exp2f(s[j][2 + e] * slog2 - l) : 0.f;
      }
    }
    // dv += pᵀ·do: pᵀ of query tiles (2kk, 2kk+1) is the A operand, do read transposed
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int jd = 0; jd < DV / 8; ++jd) {
        uint32_t b0, b1;
        load_b_trans(b0, b1, Ot, LDV, jd * 8, kk * 16, lane);
        mma(dva[jd], pa, b0, b1);
      }
    }
    // dpᵀ = v·doᵀ, 16 keys × 64 queries
    float dp[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DV / 16; ++kc) {
      uint32_t a[4];
      load_a(a, Vs, LDV, warp * 16, kc * 16, g, t);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        uint32_t b0, b1;
        load_b(b0, b1, Ot, LDV, j * 8, kc * 16, g, t);
        mma(dp[j], a, b0, b1);
      }
    }
    // dsᵀ = pᵀ ∘ (dpᵀ − Δ[query])·scale, into s
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = Dt[j * 8 + 2 * t + e];
        s[j][e] *= (dp[j][e] - dl) * scale;
        s[j][2 + e] *= (dp[j][2 + e] - dl) * scale;
      }
    }
    // dk += dsᵀ·q, q read transposed
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int jn = 0; jn < KCM * 2; ++jn) {
        if (jn < KC * 2) {
          uint32_t b0, b1;
          load_b_trans(b0, b1, Qt, LDQ, jn * 8, kk * 16, lane);
          mma(dka[jn], pa, b0, b1);
        }
      }
    }
    __syncthreads();  // stage st consumed before the next prefetch overwrites it
  }

  __nv_bfloat16* ko = dk + ((long long)b * N * H + h) * DQK;
  __nv_bfloat16* vo = dv + ((long long)b * N * H + h) * DV;
#pragma unroll
  for (int jn = 0; jn < KCM * 2; ++jn) {
    const int c = jn * 8 + 2 * t;
    if (c >= DQK) continue;
    if (key0 < N)
      *reinterpret_cast<uint32_t*>(ko + (long long)key0 * H * DQK + c) = pack(dka[jn][0], dka[jn][1]);
    if (key1 < N)
      *reinterpret_cast<uint32_t*>(ko + (long long)key1 * H * DQK + c) = pack(dka[jn][2], dka[jn][3]);
  }
#pragma unroll
  for (int jd = 0; jd < DV / 8; ++jd) {
    const int c = jd * 8 + 2 * t;
    if (key0 < N)
      *reinterpret_cast<uint32_t*>(vo + (long long)key0 * H * DV + c) = pack(dva[jd][0], dva[jd][1]);
    if (key1 < N)
      *reinterpret_cast<uint32_t*>(vo + (long long)key1 * H * DV + c) = pack(dva[jd][2], dva[jd][3]);
  }
}

template <int KCM, int DV>
int launch_dq(const void* const* p, int B, int N, int H, int DQK, const Strides& sd, float scale,
              cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<KCM, DV>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<KCM, DV>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<KCM, DV><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)p[0], (const __nv_bfloat16*)p[1], (const __nv_bfloat16*)p[2],
      (const __nv_bfloat16*)p[3], (const float*)p[4], (const float*)p[5], (__nv_bfloat16*)p[6],
      N, H, DQK, sd, scale);
  return (int)cudaGetLastError();
}

template <int KCM, int DV>
int launch_dkv(const void* const* p, int B, int N, int H, int DQK, const Strides& sd, float scale,
               cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<KCM, DV>();
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<KCM, DV>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BK - 1) / BK, B * H);
  flash_bwd_dkv_kernel<KCM, DV><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)p[0], (const __nv_bfloat16*)p[1], (const __nv_bfloat16*)p[2],
      (const __nv_bfloat16*)p[3], (const float*)p[4], (const float*)p[5], (__nv_bfloat16*)p[6],
      (__nv_bfloat16*)p[7], N, H, DQK, sd, scale);
  return (int)cudaGetLastError();
}

// Dispatch on (which kernel, width bucket, DV).
template <int DV>
int launch_dv(bool dkv, const void* const* p, int B, int N, int H, int DQK, const Strides& sd,
              float scale, cudaStream_t s) {
  switch ((DQK + 63) / 64) {
    case 1: return dkv ? launch_dkv<4, DV>(p, B, N, H, DQK, sd, scale, s)
                       : launch_dq<4, DV>(p, B, N, H, DQK, sd, scale, s);
    case 2: return dkv ? launch_dkv<8, DV>(p, B, N, H, DQK, sd, scale, s)
                       : launch_dq<8, DV>(p, B, N, H, DQK, sd, scale, s);
    case 3: return dkv ? launch_dkv<12, DV>(p, B, N, H, DQK, sd, scale, s)
                       : launch_dq<12, DV>(p, B, N, H, DQK, sd, scale, s);
    case 4: return dkv ? launch_dkv<16, DV>(p, B, N, H, DQK, sd, scale, s)
                       : launch_dq<16, DV>(p, B, N, H, DQK, sd, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_any(bool dkv, const void* const* p, int B, int N, int H, int DQK, int DV, const int* st,
               float scale, void* stream) {
  if (N < 1 || DQK < 8 || DQK > 256 || DQK % 8) return (int)cudaErrorInvalidValue;
  const Strides sd = {st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]};
  cudaStream_t s = (cudaStream_t)stream;
  if (DV == 64) return launch_dv<64>(dkv, p, B, N, H, DQK, sd, scale, s);
  if (DV == 80) return launch_dv<80>(dkv, p, B, N, H, DQK, sd, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/k: (B, N, H, DQK) bf16, v: (B, N, H, DV) bf16, each with unit stride over
// its last dim and 16-byte rows; the batch, token and head strides
// (elements) are passed per tensor. dout: contiguous (B, N, H, DV) bf16;
// lse (natural log) and delta = rowsum(dout ∘ o): contiguous (B, H, N) fp32.
// dq: a contiguous (B, N, H, DQK) bf16 output. DV = 64 or 80; DQK ≤ 256, a
// multiple of 8.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int B, int N,
                                 int H, int DQK, int DV, int sq_b, int sq_n, int sq_h, int sk_b,
                                 int sk_n, int sk_h, int sv_b, int sv_n, int sv_h, float scale,
                                 void* stream) {
  const void* p[7] = {q, k, v, dout, lse, delta, dq};
  const int st[9] = {sq_b, sq_n, sq_h, sk_b, sk_n, sk_h, sv_b, sv_n, sv_h};
  return launch_any(false, p, B, N, H, DQK, DV, st, scale, stream);
}

// As `flash_attn_bwd_dq`; dk and dv: contiguous (B, N, H, DQK) and
// (B, N, H, DV) bf16 outputs.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv, int B,
                                  int N, int H, int DQK, int DV, int sq_b, int sq_n, int sq_h,
                                  int sk_b, int sk_n, int sk_h, int sv_b, int sv_n, int sv_h,
                                  float scale, void* stream) {
  const void* p[8] = {q, k, v, dout, lse, delta, dk, dv};
  const int st[9] = {sq_b, sq_n, sq_h, sk_b, sk_n, sk_h, sv_b, sv_n, sv_h};
  return launch_any(true, p, B, N, H, DQK, DV, st, scale, stream);
}
