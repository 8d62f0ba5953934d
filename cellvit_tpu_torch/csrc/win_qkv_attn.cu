// Fused window qkv projection + decomposed rel-pos attention forward (bf16
// in, fp32 accumulation, bf16 out).
//
// Replaces: cellvit_tpu/ops/attention.py:862 `_win_qkv_kernel` (pallas_call
// at :1018 in `_win_qkv_fwd_only`, reached through `window_qkv_attention`
// :1079), SAM's windowed blocks.
//
// Per window w and head h, on the window's N = side² LN'd tokens x_w (the
// zero-padded tokens of edge windows included, as in the reference):
//   [q | k | v] = x_w · W_hᵀ + b_h                      (the qkv projection)
//   Bh[t, r] = q_t · Rh[row(t), r],  Bw[t, c] = q_t · Rw[col(t), c]
//   o_h = softmax(q·kᵀ·scale + Bh[·, row(key)] + Bw[·, col(key)]) · v
// with the bias from the UNSCALED q; heads are written side by side into
// (NW, N, C), the layout the output projection reads.
//
// Bound on the H100: the projection is the bulk, 2·NW·N·C·3C FLOPs (≈385
// GFLOP at SAM-H's 200 windows of 196 tokens, C = 1280) plus 4·NW·H·N²·D for
// the attention (≈20 GFLOP): ≈0.41 ms at 989 TFLOP/s bf16, against ≈0.11 GB
// of x, W and o (≈0.03 ms at 3.35 TB/s), so it is bound by operations.
// Every product runs on the tensor cores (`mma.sync.m16n8k16` bf16). x_w
// and W_h stream through shared memory in 32-wide chunks of C by `cp.async`
// into a 3-stage ring, so two chunks' copies are in flight while one
// computes; x_w is re-read once for each of q, k and v (from L2: the 16
// heads of a window are neighbouring blocks). No wgmma/TMA yet.
//
// Layout: one block per (head, window) with ceil(N/16)/2 warps, each owning
// two 16-row tiles of the window. A head's weight slice (C × 3D, 600 KB at
// SAM-H) does not fit in shared memory, and the 196 × 3D fp32 accumulators
// of q, k and v at once would need ≈180 registers a thread, so q, k and v are
// projected one after another (80 accumulators a thread), each rounded to
// bf16 into shared memory (v transposed). Then Bh/Bw (fp32, N × side each)
// are dot products of q rows with the gathered tables, and each warp runs an
// online-softmax pass over its rows against all keys in shared memory.
// Rows past N are zero-filled before the projection and masked as keys.
// Head dim D = 64 or 80; C a multiple of 32; N ≤ 256.

#include <math.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr int KC = 32;        // projection depth per shared-memory chunk
constexpr int LDX = KC + 8;   // padded chunk row (bf16 elements): conflict-free fragment loads
constexpr int STAGES = 3;     // chunks in the cp.async ring
constexpr int BK = 64;        // attention key tile

struct Dims {
  int N, MT, NP, NK, LDV, side;
};

__host__ __device__ inline Dims dims(int N, int side) {
  Dims d;
  d.N = N;
  d.MT = (N + 15) / 16;            // 16-row tiles
  d.NP = d.MT * 16;                // rows padded to whole tiles
  d.NK = (N + BK - 1) / BK * BK;   // keys padded to whole key tiles
  d.LDV = d.NK + 8;
  d.side = side;
  return d;
}

// The chunk ring of the projection; the rel-pos terms reuse its space after it.
template <int D>
__host__ __device__ inline size_t ring_bytes(const Dims& s) {
  const size_t ring = (size_t)STAGES * (s.NP + D) * LDX * 2;
  const size_t bias = (size_t)2 * s.NP * s.side * 4;
  return ring > bias ? ring : bias;
}

template <int D>
size_t smem_bytes(const Dims& s) {
  constexpr int LD = D + 8;
  return ring_bytes<D>(s) + (size_t)2 * s.NK * 4 +
         (size_t)(s.NP * LD + s.NK * LD + D * s.LDV) * 2;
}

template <int D>
__global__ void __launch_bounds__(256)
win_qkv_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
               const float* __restrict__ bias, const __nv_bfloat16* __restrict__ rh,
               const __nv_bfloat16* __restrict__ rw, __nv_bfloat16* __restrict__ o, int N,
               int C, int side, float scale) {
  constexpr int LD = D + 8;  // padded q/k row
  const Dims s = dims(N, side);
  const int MT = s.MT, NP = s.NP, NK = s.NK, LDV = s.LDV;
  extern __shared__ __align__(16) unsigned char smem[];
  // [STAGES][NP + D][LDX]: each stage an x chunk (NP rows) then a W chunk (D rows)
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  float* Bhs = reinterpret_cast<float*>(smem);  // [NP][side], after the projection
  float* Bws = Bhs + NP * side;                 // [NP][side]
  int* krow = reinterpret_cast<int*>(smem + ring_bytes<D>(s));  // [NK] grid row of each key
  int* kcol = krow + NK;                                          // [NK] grid column
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(kcol + NK);  // [NP][LD]
  __nv_bfloat16* Ks = Qs + NP * LD;                                  // [NK][LD]
  __nv_bfloat16* Vt = Ks + NK * LD;                                  // [D][LDV], v transposed

  const int tid = threadIdx.x, nthreads = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, win = blockIdx.y;
  const __nv_bfloat16* xw = x + (long long)win * N * C;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // key tiles past the padded rows: finite zeros (masked as keys below)
  for (int i = tid; i < (NK - NP) * D; i += nthreads) {
    int r = NP + i / D, c = i % D;
    Ks[r * LD + c] = zero;
    Vt[c * LDV + r] = zero;
  }
  for (int i = tid; i < NK; i += nthreads) {
    krow[i] = i / side;
    kcol[i] = i % side;
  }

  // ---- the projection: q, then k, then v, each (NP × D) = x_w · W_hᵀ slice,
  // as one sequence of 3·C/KC chunks through a ring of STAGES chunks: while
  // chunk c computes, the copies of chunks c+1 .. c+STAGES-1 are in flight
  const int nk = C / KC, total = 3 * nk;
  auto issue = [&](int c) {
    if (c < total) {
      const int which = c / nk, k0 = (c - which * nk) * KC;
      __nv_bfloat16* xs = ring + (c % STAGES) * (NP + D) * LDX;
      __nv_bfloat16* ws = xs + NP * LDX;
      const __nv_bfloat16* wsrc = wt + ((long long)which * C + (long long)h * D) * C + k0;
      for (int i = tid; i < NP * (KC / 8); i += nthreads) {
        const int r = i / (KC / 8), cc = (i % (KC / 8)) * 8;
        cp_async16(&xs[r * LDX + cc], xw + (long long)(r < N ? r : 0) * C + k0 + cc, r < N);
      }
      for (int i = tid; i < D * (KC / 8); i += nthreads) {
        const int r = i / (KC / 8), cc = (i % (KC / 8)) * 8;
        cp_async16(&ws[r * LDX + cc], wsrc + (long long)r * C + cc, true);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the wait counts uniform
  };
  const int ma = 2 * warp, mb = ma + 1;  // this warp's two row tiles
  const bool has_a = ma < MT, has_b = mb < MT;
  float acc[2][D / 8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;

  for (int c = 0; c < STAGES - 1; ++c) issue(c);
  for (int c = 0; c < total; ++c) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk c have landed
    __syncthreads();              // everyone's have; chunk c-1's stage is free
    issue(c + STAGES - 1);
    const __nv_bfloat16* xs = ring + (c % STAGES) * (NP + D) * LDX;
    const __nv_bfloat16* ws = xs + NP * LDX;
#pragma unroll
    for (int kc = 0; kc < KC / 16; ++kc) {
      uint32_t a0[4] = {0, 0, 0, 0}, a1[4] = {0, 0, 0, 0};
      if (has_a) load_a(a0, xs, LDX, ma * 16, kc * 16, g, t);
      if (has_b) load_a(a1, xs, LDX, mb * 16, kc * 16, g, t);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t b0, b1;
        load_b(b0, b1, ws, LDX, j * 8, kc * 16, g, t);
        if (has_a) mma(acc[0][j], a0, b0, b1);
        if (has_b) mma(acc[1][j], a1, b0, b1);
      }
    }
    if ((c + 1) % nk) continue;
    // the last chunk of q, k or v: + b_h, round to bf16 (v transposed)
    const int which = c / nk;
    const long long col0 = (long long)which * C + (long long)h * D;  // first output column
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (m ? has_b : has_a) {
        const int r0 = (ma + m) * 16 + g, r1 = r0 + 8;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int cc = j * 8 + 2 * t;
          const float bc0 = bias ? bias[col0 + cc] : 0.f, bc1 = bias ? bias[col0 + cc + 1] : 0.f;
          const float v00 = acc[m][j][0] + bc0, v01 = acc[m][j][1] + bc1;
          const float v10 = acc[m][j][2] + bc0, v11 = acc[m][j][3] + bc1;
          if (which == 2) {
            Vt[cc * LDV + r0] = __float2bfloat16(v00);
            Vt[(cc + 1) * LDV + r0] = __float2bfloat16(v01);
            Vt[cc * LDV + r1] = __float2bfloat16(v10);
            Vt[(cc + 1) * LDV + r1] = __float2bfloat16(v11);
          } else {
            __nv_bfloat16* dst = which == 0 ? Qs : Ks;
            *reinterpret_cast<uint32_t*>(&dst[r0 * LD + cc]) = pack(v00, v01);
            *reinterpret_cast<uint32_t*>(&dst[r1 * LD + cc]) = pack(v10, v11);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // q, k, v complete; the ring is free for Bh/Bw

  // ---- rel-pos terms from the unscaled q: Bh[t, r] = q_t · Rh[row(t), r, :],
  // Bw[t, c] = q_t · Rw[col(t), c, :] (tables (side, side, D), bf16)
  const int nb = N * side;
  for (int i = tid; i < 2 * nb; i += nthreads) {
    const int which = i >= nb;
    const int rem = i - which * nb;
    const int tq = rem / side, j = rem - tq * side;
    const int grid_idx = which ? tq % side : tq / side;
    const __nv_bfloat16* tab = (which ? rw : rh) + ((long long)grid_idx * side + j) * D;
    const __nv_bfloat16* qrow = Qs + tq * LD;
    float sum = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; d += 2) {
      const float2 qv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qrow + d));
      const float2 rv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tab + d));
      sum += qv.x * rv.x + qv.y * rv.y;
    }
    (which ? Bws : Bhs)[tq * side + j] = sum;
  }
  __syncthreads();

  // ---- attention: each warp, one 16-row tile at a time, online softmax
  // over 64-key tiles (all of k and v are in shared memory)
  for (int m = 0; m < 2; ++m) {
    const int mt = ma + m;
    if (mt >= MT) break;
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) load_a(qa[kc], Qs, LD, mt * 16, kc * 16, g, t);
    const int rl0 = mt * 16 + g, rl1 = rl0 + 8;
    const float *bh0 = Bhs + rl0 * side, *bh1 = Bhs + rl1 * side;
    const float *bw0 = Bws + rl0 * side, *bw1 = Bws + rl1 * side;

    float acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    for (int k0 = 0; k0 < NK; k0 += BK) {
      float sc[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc) {
          uint32_t b0, b1;
          load_b(b0, b1, Ks, LD, k0 + j * 8, kc * 16, g, t);
          mma(sc[j], qa[kc], b0, b1);
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = k0 + j * 8 + 2 * t + e;
          if (c < N) {
            const int r = krow[c], cc = kcol[c];
            sc[j][e] = (sc[j][e] * scale + bh0[r] + bw0[cc]) * LOG2E;
            sc[j][2 + e] = (sc[j][2 + e] * scale + bh1[r] + bw1[cc]) * LOG2E;
          } else {
            sc[j][e] = sc[j][2 + e] = -INFINITY;
          }
          mx0 = fmaxf(mx0, sc[j][e]);
          mx1 = fmaxf(mx1, sc[j][2 + e]);
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
        sc[j][0] = exp2f(sc[j][0] - mn0);
        sc[j][1] = exp2f(sc[j][1] - mn0);
        sc[j][2] = exp2f(sc[j][2] - mn1);
        sc[j][3] = exp2f(sc[j][3] - mn1);
        rs0 += sc[j][0] + sc[j][1];
        rs1 += sc[j][2] + sc[j][3];
      }
      l0 = l0 * al0 + rs0;
      l1 = l1 * al1 + rs1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][0] *= al0;
        acc[j][1] *= al0;
        acc[j][2] *= al1;
        acc[j][3] *= al1;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack(sc[2 * kk][0], sc[2 * kk][1]);
        pa[1] = pack(sc[2 * kk][2], sc[2 * kk][3]);
        pa[2] = pack(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        pa[3] = pack(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
        for (int jd = 0; jd < D / 8; ++jd) {
          uint32_t b0, b1;
          load_b(b0, b1, Vt, LDV, jd * 8, k0 + kk * 16, g, t);
          mma(acc[jd], pa, b0, b1);
        }
      }
    }

    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    // o is contiguous (NW, N, C); head h owns columns h·D .. h·D + D - 1
    __nv_bfloat16* ob = o + (long long)win * N * C + (long long)h * D;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      const int c = jd * 8 + 2 * t;
      if (rl0 < N)
        *reinterpret_cast<uint32_t*>(ob + (long long)rl0 * C + c) = pack(acc[jd][0] * inv0, acc[jd][1] * inv0);
      if (rl1 < N)
        *reinterpret_cast<uint32_t*>(ob + (long long)rl1 * C + c) = pack(acc[jd][2] * inv1, acc[jd][3] * inv1);
    }
  }
}

template <int D>
int launch(const void* x, const void* wt, const void* bias, const void* rh, const void* rw,
           void* o, int NW, int N, int C, int H, int side, float scale, cudaStream_t stream) {
  const Dims s = dims(N, side);
  const size_t smem = smem_bytes<D>(s);
  cudaError_t err = allow_smem(win_qkv_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = 32 * ((s.MT + 1) / 2);
  win_qkv_kernel<D><<<dim3(H, NW), threads, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)wt, (const float*)bias,
      (const __nv_bfloat16*)rh, (const __nv_bfloat16*)rw, (__nv_bfloat16*)o, N, C, side, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// x: contiguous (NW, N, C) bf16 window tokens, N = side² ≤ 256; wt: the qkv
// weight as a contiguous (3C, C) bf16 matrix (torch Linear layout: rows are
// output columns [q | k | v], head-major within each); bias: (3C,) fp32 or
// null; rh/rw: contiguous (side, side, C/H) bf16 gathered tables; o: a
// contiguous (NW, N, C) bf16 output. C a multiple of 32, C/H = 64 or 80.
extern "C" int win_qkv_attn_fwd(const void* x, const void* wt, const void* bias, const void* rh,
                                const void* rw, void* o, int NW, int N, int C, int H, int side,
                                float scale, void* stream) {
  if (N < 1 || N > 256 || side * side != N || C % KC || H < 1 || C % H)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (C / H == 64) return launch<64>(x, wt, bias, rh, rw, o, NW, N, C, H, side, scale, s);
  if (C / H == 80) return launch<80>(x, wt, bias, rh, rw, o, NW, N, C, H, side, scale, s);
  return (int)cudaErrorInvalidValue;
}
