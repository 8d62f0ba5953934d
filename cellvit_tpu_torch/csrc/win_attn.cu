// Whole-window attention forward on lane-augmented q′/k′ for Hopper
// (sm_90a): bf16 in, fp32 accumulation, bf16 out.
//
// Replaces: cellvit_tpu/ops/attention.py:257 `_win_attn_kernel` (pallas_call
// at :332 in `_win_fwd`, reached through `window_attention` :404 from
// `flash_attention_relpos` for grids of N ≤ 256 tokens).
//
// Computes o = softmax(q′·k′ᵀ)·v per (batch, head) for N ≤ 256 tokens with no
// scale: the caller folded the scale and the rel-pos bias into the lanes,
// q′ = [q·scale | Bh | Bw] and k′ = [k | 1{row} | 1{col}] (`relpos_aug`), so
// q′ and k′ are DQK = D + gh + gw wide (110 for SAM-H's 14×16 grid, 112 for
// 16×16) and v is D = 64 or 80 wide.
//
// Bound on the H100: 2·B·H·N²·(DQK + D) matrix FLOPs, ≈0.3 GFLOP at a
// 224×256 tile (16 heads, N = 224), ≈0.3 µs at 989 TFLOP/s, against ≈2.7 MB
// of q′/k′/v/o, ≈0.8 µs at 3.35 TB/s: bound by bytes, and at this size by
// launch latency and one round trip of loads.
//
// Design. A block takes 64 queries of one (batch, head) on one consumer
// warpgroup. One thread issues the TMA loads: the block's q′ rows and k′ as
// one or two 128-key tiles (each with its own barrier, so the products on
// the first start while the second arrives), all of the head's keys in
// shared memory together; rows past N and columns past DQK arrive as
// zeros, so q′/k′ need 16-byte rows but no padding in memory (`relpos_aug`
// gives them a row stride padded to 8 elements). S = q′·k′ᵀ runs on wgmma
// (SS, both operands K-major, one 16-deep step per 16 columns of q′/k′)
// into one m64n128 accumulator a key tile: the whole logits row of ≤ 256
// keys stays in registers, so the softmax is single-pass as in the Pallas
// kernel, with no running max and no rescale: keys past N are masked, the
// row max and sum taken over the lane quad, p = 2^(s·log2 e − max·log2 e)
// rounded once to bf16 into the A operand of P·V, an RS wgmma that reads v
// MN-major from its TMA tiles (no transpose); v is loaded into k′'s tiles
// once S is done, while the softmax runs. o = P·V / l is rounded once to
// bf16. A block then needs ≈81 KB of shared memory at DQK ≤ 128, so two
// share an SM and one's loads overlap the other's products. One warpgroup a
// block with v after S was the fastest at the 224×256 tile's shape (two
// warpgroups 1.4× slower) and, at a batch of 8 256² tiles, within the
// spread of two warpgroups and faster than v loaded beside k′
// (`scripts/win_attn_variants.py`, which flips the two constants below).

#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BK = 128;              // keys a tile
constexpr int MAX_DQK = 288;
constexpr int MAX_SMEM = 232448;     // a block's shared memory on the H100
constexpr int NWG = 1;               // 64-query consumer warpgroups a block
constexpr bool V_AFTER_S = true;     // v loaded into k′'s tiles once S is done
constexpr int BQ = 64 * NWG;         // queries a block

struct Params {
  __nv_bfloat16* o;  // (B, N, H, DV) contiguous
  int N, H;
  int KB;            // 64-column tiles of q′/k′
  int KS;            // 16-deep steps of q′·k′ᵀ: ⌈DQK / 16⌉
};

// Byte offsets of the shared-memory layout from a 1024-byte aligned base:
// q′ [KB][BQ rows], k′ [KB][NT·128 rows], v [DVB][NT·128 rows] (at k′'s
// offset with V_AFTER_S), then the barriers q_full, k_full[NT], v_full.
struct Layout {
  int tq, tk, k, v, bar, bytes;
  __host__ __device__ Layout(int kb, int dvb, int nt) {
    tq = BQ * 128;
    tk = nt * BK * 128;
    k = kb * tq;
    v = V_AFTER_S ? k : k + kb * tk;
    bar = V_AFTER_S ? k + (kb > dvb ? kb : dvb) * tk : v + dvb * tk;
    bytes = bar + (2 + nt) * 8 + 1024;
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Block (query tile, batch·head); NT key tiles.
template <int DV, int NT>
__global__ void __launch_bounds__(128 * NWG, 1)
win_attn_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int DVB = (DV + 63) / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const Layout L(p.KB, DVB, NT);
  unsigned char* Qs = sm;
  unsigned char* Ks = sm + L.k;
  unsigned char* Vs = sm + L.v;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L.bar);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + NT;

  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int N = p.N, q0 = blockIdx.x * BQ, bhi = blockIdx.y, b = bhi / p.H, h = bhi % p.H;

  auto load_v = [&]() {
    mbar_arrive_expect_tx(v_full, NT * DVB * BK * 128);
#pragma unroll
    for (int it = 0; it < NT; ++it)
#pragma unroll
      for (int j = 0; j < DVB; ++j) tma_load_4d(Vs + j * L.tk + it * BK * 128, &tv, v_full, j * 64, it * BK, h, b);
  };
  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int it = 0; it < NT; ++it) mbar_init(&k_full[it], 1);
    mbar_init(v_full, 1);
    mbar_fence_init();
    mbar_arrive_expect_tx(q_full, p.KB * L.tq);
    for (int j = 0; j < p.KB; ++j) tma_load_4d(Qs + j * L.tq, &tq, q_full, j * 64, q0, h, b);
#pragma unroll
    for (int it = 0; it < NT; ++it) {
      mbar_arrive_expect_tx(&k_full[it], p.KB * BK * 128);
      for (int j = 0; j < p.KB; ++j)
        tma_load_4d(Ks + j * L.tk + it * BK * 128, &tk, &k_full[it], j * 64, it * BK, h, b);
    }
    if (!V_AFTER_S) load_v();
  }
  __syncthreads();  // the barriers are initialised before anyone waits on them

  // S = q′·k′ᵀ: this warpgroup's 64 rows against every key, a 128-key tile
  // an accumulator (d[4j + 2hh + e]: row 16·warp + g + 8·hh, key 8j + 2t + e)
  float s[NT][BK / 2];
  const unsigned char* Qw = Qs + wg * 64 * 128;
  mbar_wait(q_full, 0);
#pragma unroll
  for (int it = 0; it < NT; ++it) {
    mbar_wait(&k_full[it], 0);
    wgmma_fence();
    for (int ks = 0; ks < p.KS; ++ks)
      SS<BK, 0, 0>::run(s[it], desc_sw128(Qw + (ks / 4) * L.tq + (ks % 4) * 32),
                        desc_sw128(Ks + (ks / 4) * L.tk + it * BK * 128 + (ks % 4) * 32), ks > 0);
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int it = 0; it < NT; ++it) fence_regs(s[it]);
  if (V_AFTER_S) {  // every warpgroup's products have read k′: v may overwrite it
    __syncthreads();
    if (tid == 0) load_v();
  }

  // single-pass softmax over the whole row (keys past N masked), base 2
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int it = 0; it < NT; ++it) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (it * BK + 8 * j + 2 * t + e >= N) s[it][4 * j + e] = s[it][4 * j + 2 + e] = -INFINITY;
        mx[0] = fmaxf(mx[0], s[it][4 * j + e]);
        mx[1] = fmaxf(mx[1], s[it][4 * j + 2 + e]);
      }
    }
  }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) mx[hh] = quad_max(mx[hh]) * LOG2E;  // key 0 < N: finite
  uint32_t pa[NT * BK / 16][4];
#pragma unroll
  for (int it = 0; it < NT; ++it) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[it][4 * j + 2 * hh + e];
          x = ex2(fmaf(x, LOG2E, -mx[hh]));
          l[hh] += x;
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[it * (BK / 16) + kk][i] = pack_bf16(s[it][8 * kk + 2 * i], s[it][8 * kk + 2 * i + 1]);
    }
  }

  // O = P·V, v read MN-major (v 80 wide: one m64n80 product over two tiles)
  float o[32], ox[8];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) ox[i] = 0.f;
  mbar_wait(v_full, 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NT * BK / 16; ++kk) {
    if constexpr (DV == 80)
      RS80::run(o, ox, pa[kk], desc_sw128_mn(Vs + kk * 2048, L.tk));
    else
      RS<64, 1>::run(o, pa[kk], desc_sw128(Vs + kk * 2048));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(ox);

  const int row0 = q0 + wg * 64 + warp * 16 + g;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float sum = quad_sum(l[hh]);
    const int row = row0 + 8 * hh;
    if (row >= N) continue;
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    __nv_bfloat16* orow = p.o + ((b * (long long)N + row) * p.H + h) * DV;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
          pack_bf16(o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
    if constexpr (DV == 80) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        *reinterpret_cast<uint32_t*>(orow + 64 + 8 * j + 2 * t) =
            pack_bf16(ox[4 * j + 2 * hh] * inv, ox[4 * j + 2 * hh + 1] * inv);
    }
  }
}

struct Maps {
  CUtensorMap q, k, v;
};

template <int DV, int NT>
int launch(const Maps& m, const Params& p, int B, cudaStream_t stream) {
  const Layout L(p.KB, (DV + 63) / 64, NT);
  if (L.bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(win_attn_kernel<DV, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.N + BQ - 1) / BQ, B * p.H);
  win_attn_kernel<DV, NT><<<grid, 128 * NWG, L.bytes, stream>>>(m.q, m.k, m.v, p);
  return (int)cudaGetLastError();
}

template <int DV>
int launch_nt(const Maps& m, const Params& p, int B, cudaStream_t s) {
  return p.N > BK ? launch<DV, 2>(m, p, B, s) : launch<DV, 1>(m, p, B, s);
}

}  // namespace

// q′/k′: (B, N, H, DQK) bf16 with unit stride over DQK; v: (B, N, H, D) bf16
// with unit stride over D; every other stride (elements) a multiple of 8 and
// every base 16-byte aligned. o: a contiguous (B, N, H, D) bf16 output.
// N ≤ 256, D = 64 or 80, DQK ≤ 288.
extern "C" int win_attn_fwd(const void* q, const void* k, const void* v, void* o, int B, int N,
                            int H, int DQK, int D, int sq_b, int sq_n, int sq_h, int sk_b,
                            int sk_n, int sk_h, int sv_b, int sv_n, int sv_h, void* stream) {
  if (B < 1 || H < 1) return 0;
  if (N < 1 || N > 2 * BK || DQK < 1 || DQK > MAX_DQK || (D != 64 && D != 80))
    return (int)cudaErrorInvalidValue;
  const int strides[9] = {sq_b, sq_n, sq_h, sk_b, sk_n, sk_h, sv_b, sv_n, sv_h};
  for (int st : strides)
    if (st % 8) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
       reinterpret_cast<uintptr_t>(o)) % 16 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.N = N;
  p.H = H;
  p.KB = (DQK + 63) / 64;
  p.KS = (DQK + 15) / 16;
  Maps m;
  if (!bf16_map_4d(&m.q, q, DQK, N, H, B, sq_n, sq_h, sq_b, BQ) ||
      !bf16_map_4d(&m.k, k, DQK, N, H, B, sk_n, sk_h, sk_b, BK) ||
      !bf16_map_4d(&m.v, v, D, N, H, B, sv_n, sv_h, sv_b, BK))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return D == 64 ? launch_nt<64>(m, p, B, s) : launch_nt<80>(m, p, B, s);
}
