// Direct-bias rel-pos flash attention forward (bf16 in, fp32 accumulation,
// bf16 out).
//
// Replaces: cellvit_tpu/ops/attention.py:190 `_flash_relpos_kernel`
// (pallas_call at :676 in `_relpos_fwd_only`, reached through
// `flash_attention_relpos` :740), SAM's global-attention blocks.
//
// Computes o = softmax(q·kᵀ·scale + bias)·v per (batch, head) over a
// (gh, gw) token grid, N = gh·gw, with the decomposed rel-pos bias
//   bias[q, key] = Bh[q, key / gw] + Bw[q, key % gw]
// built on each logits tile from the (B, N, H, gh) and (B, N, H, gw) terms
// (`rel_pos_bias`, plain torch einsums). The q·kᵀ product stays D wide and
// no N×N bias ever exists.
//
// Bound on the H100: 4·B·H·N²·D matrix FLOPs (≈0.69 TFLOP at SAM-H's
// (8, 4096, 16, 80), ≈0.70 ms at 989 TFLOP/s bf16) plus B·H·N² exponentials;
// the bytes (q, k, v, o, Bh, Bw ≈ 0.3 GB) take ≈0.09 ms, so the kernel is
// bound by operations. The online-softmax state stays in registers and both
// products run on the tensor cores with `mma.sync.m16n8k16` bf16 fragments;
// the S accumulator is re-packed in registers into the A operand of P·V.
// k/v tiles arrive by `cp.async` into a 2-stage ring (the next tile's copies
// in flight while this one computes), and v is read back row-major with
// `ldmatrix.trans`. No wgmma/TMA yet.
//
// Layout: one block of 4 warps per (64-query tile, batch·head); each warp
// owns 16 query rows. The block's 64 rows of Bh and Bw are staged once in
// shared memory at a pitch of g* + 2 (an odd number of 32-bit words for the
// 32- and 64-wide grids, so neighbouring rows fall on distinct banks); each
// thread steps its keys' grid (row, col) along the tile, so any gw works,
// ragged or not. Keys at or beyond N are zero-filled and masked to -inf.
// Head dim D = 64 or 80 (SAM-B/L and SAM-H).

#include <math.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;

template <int D>
size_t smem_bytes(int gh, int gw) {
  // q tile, two (k, v) tile stages, and the padded Bh/Bw rows
  return (size_t)(BQ + 4 * BK) * (D + 8) * 2 + (size_t)BQ * (gh + 2 + gw + 2) * 2;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
relpos_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ bh,
                  const __nv_bfloat16* __restrict__ bw, __nv_bfloat16* __restrict__ o, int N,
                  int H, int gh, int gw, long long sq_b, long long sq_n, long long sk_b,
                  long long sk_n, long long sv_b, long long sv_n, float scale) {
  constexpr int LD = D + 8;  // padded q/k/v row (bf16 elements): conflict-free fragment loads
  const int LDH = gh + 2, LDW = gw + 2;  // padded bias rows: see the layout note above
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ][LD]
  __nv_bfloat16* Ks = Qs + BQ * LD;                             // [2][BK][LD]
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;                         // [2][BK][LD], row-major
  __nv_bfloat16* Bhs = Vs + 2 * BK * LD;                        // [BQ][LDH]
  __nv_bfloat16* Bws = Bhs + BQ * LDH;                          // [BQ][LDW]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int bhi = blockIdx.y, b = bhi / H, h = bhi % H;
  const __nv_bfloat16* qb = q + b * sq_b + (long long)h * D;
  const __nv_bfloat16* kb = k + b * sk_b + (long long)h * D;
  const __nv_bfloat16* vb = v + b * sv_b + (long long)h * D;

  // one key/value tile into stage `st`: rows past N are zero-filled
  auto load_kv = [&](int kt, int st) {
    const int k0 = kt * BK;
    for (int i = tid; i < BK * (D / 8); i += THREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool ok = k0 + r < N;
      const long long row = ok ? k0 + r : 0;
      cp_async16(&Ks[(st * BK + r) * LD + c], kb + row * sk_n + c, ok);
      cp_async16(&Vs[(st * BK + r) * LD + c], vb + row * sv_n + c, ok);
    }
  };
  for (int i = tid; i < BQ * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const bool ok = q0 + r < N;
    cp_async16(&Qs[r * LD + c], qb + (long long)(ok ? q0 + r : 0) * sq_n + c, ok);
  }
  load_kv(0, 0);
  cp_async_commit();
  // Bh/Bw are contiguous (B, N, H, g*): the rows of this tile's queries
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < BQ * gh; i += THREADS) {
    int r = i / gh, c = i - r * gh;
    Bhs[r * LDH + c] = q0 + r < N ? bh[(((long long)b * N + q0 + r) * H + h) * gh + c] : zero;
  }
  for (int i = tid; i < BQ * gw; i += THREADS) {
    int r = i / gw, c = i - r * gw;
    Bws[r * LDW + c] = q0 + r < N ? bw[(((long long)b * N + q0 + r) * H + h) * gw + c] : zero;
  }

  const int rl0 = warp * 16 + g, rl1 = rl0 + 8;  // this thread's two query rows in the tile
  const __nv_bfloat16 *bh0 = Bhs + rl0 * LDH, *bh1 = Bhs + rl1 * LDH;
  const __nv_bfloat16 *bw0 = Bws + rl0 * LDW, *bw1 = Bws + rl1 * LDW;

  uint32_t qa[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
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
    __syncthreads();  // tile kt (and at kt = 0 the q tile and the bias rows) visible
    if (kt == 0) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) load_a(qa[kc], Qs, LD, warp * 16, kc * 16, g, t);
    }
    const __nv_bfloat16* Kt = Ks + st * BK * LD;
    const __nv_bfloat16* Vt = Vs + st * BK * LD;

    // S = q·kᵀ for this warp's 16 rows × 64 keys: 8 n8 tiles
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t b0, b1;
        load_b(b0, b1, Kt, LD, j * 8, kc * 16, g, t);
        mma(s[j], qa[kc], b0, b1);
      }
    }
    // logits·scale + Bh[q, row(key)] + Bw[q, col(key)], in base-2 units;
    // keys >= N masked; row max over the quad. This thread's keys are
    // k0 + 8j + 2t + e: their grid (row, col) steps along without division.
    const int k0 = kt * BK;
    int kr = (k0 + 2 * t) / gw, kc0 = k0 + 2 * t - kr * gw;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      int r = kr, c = kc0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (k0 + j * 8 + 2 * t + e < N) {
          const float bh_r0 = __bfloat162float(bh0[r]), bh_r1 = __bfloat162float(bh1[r]);
          s[j][e] = (s[j][e] * scale + bh_r0 + __bfloat162float(bw0[c])) * LOG2E;
          s[j][2 + e] = (s[j][2 + e] * scale + bh_r1 + __bfloat162float(bw1[c])) * LOG2E;
        } else {
          s[j][e] = s[j][2 + e] = -INFINITY;
        }
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
        if (++c == gw) {
          c = 0;
          ++r;
        }
      }
      kc0 += 8;
      while (kc0 >= gw) {
        kc0 -= gw;
        ++kr;
      }
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
        uint32_t b0, b1;
        load_b_trans(b0, b1, Vt, LD, jd * 8, kk * 16, lane);
        mma(acc[jd], pa, b0, b1);
      }
    }
    __syncthreads();  // stage st consumed before the next prefetch overwrites it
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int r0 = q0 + rl0, r1 = q0 + rl1;
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

template <int D>
int launch(const void* q, const void* k, const void* v, const void* bh, const void* bw, void* o,
           int B, int N, int H, int gh, int gw, int sq_b, int sq_n, int sk_b, int sk_n,
           int sv_b, int sv_n, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(gh, gw);
  cudaError_t err = allow_smem(relpos_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BQ - 1) / BQ, B * H);
  relpos_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)bh, (const __nv_bfloat16*)bw, (__nv_bfloat16*)o, N, H, gh, gw,
      sq_b, sq_n, sk_b, sk_n, sv_b, sv_n, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v: (B, N, H, D) bf16 with unit stride over D and stride D over H; the
// batch and token strides (elements) are passed per tensor. bh/bw: contiguous
// (B, N, H, gh) and (B, N, H, gw) bf16 with N = gh·gw. o: a contiguous
// (B, N, H, D) bf16 output. D = 64 or 80.
extern "C" int relpos_attn_fwd(const void* q, const void* k, const void* v, const void* bh,
                               const void* bw, void* o, int B, int N, int H, int D, int gh,
                               int gw, int sq_b, int sq_n, int sk_b, int sk_n, int sv_b,
                               int sv_n, float scale, void* stream) {
  if (gh * gw != N) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return launch<64>(q, k, v, bh, bw, o, B, N, H, gh, gw, sq_b, sq_n, sk_b, sk_n, sv_b, sv_n, scale, s);
  if (D == 80)
    return launch<80>(q, k, v, bh, bw, o, B, N, H, gh, gw, sq_b, sq_n, sk_b, sk_n, sv_b, sv_n, scale, s);
  return (int)cudaErrorInvalidValue;
}
