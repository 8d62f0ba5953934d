// Flash attention backward, fused for Hopper: dq, dk and dv in one launch
// (bf16 in, fp32 accumulation, bf16 dk/dv, fp32 dq partials summed in a
// workspace).
//
// Replaces: cellvit_tpu/ops/attention.py:106 `_flash_bwd_dq_kernel` (B8a,
// pallas_call at :495) and :143 `_flash_bwd_dkv_kernel` (B8b, pallas_call at
// :514), both in `_flash_core_bwd`, the custom VJP of `flash_attention`.
//
// With p = exp(q·kᵀ·scale − lse) recomputed per tile from the forward's
// natural-log lse, Δ = rowsum(do ∘ o) (a torch op outside), dp = do·vᵀ and
// ds = p ∘ (dp − Δ)·scale: dv = pᵀ·do, dk = dsᵀ·q, dq = ds·k. p is rounded to
// bf16 before the dv product and ds before the dk and dq products, as the JAX
// kernels round them; dk and dv are rounded once at the end, dq by the
// wrapper's cast of the workspace.
//
// Bound on the H100: 5 products of N²·D per (batch, head),
// 2·N²·(3·DQK + 2·DV)·B·H = 258 GFLOP at the CellViT-256 training step's
// (4, 4097, 6, 64), 0.261 ms at 989 TFLOP/s, plus N² exponentials; its bytes
// (q, k, v, do, lse, Δ read once, dq, dk, dv written once, ≈38 MB) take
// ≈0.011 ms. Bound by operations.
//
// Design, against what held back the pair of mma.sync kernels it replaces:
// 1. One block per (128-key tile, batch·head) loops over every 64-query
//    tile and computes Sᵀ, pᵀ and dpᵀ once for all three gradients: 5
//    products and one exponential per (query, key) pair, where the pair
//    computed 7 and 2. dq is the product that crosses key tiles: each block
//    adds its fp32 partial ds·k into a zeroed (B, N, H, DQK) workspace with
//    vectorised global atomics (float4 `atomicAdd`, a RED on sm_90, after
//    a lane-pair shuffle gathers 4 adjacent columns of one row). The
//    128-key tile halves that traffic against a 64-key one (≈0.83 GB per
//    call through L2 at the main shape). The order of those sums changes
//    from run to run, so dq may differ by rounding between two calls.
// 2. Every product is a `wgmma` (m64nNk16, bf16 in, fp32 accumulators), two
//    consumer warpgroups of 64 keys each: Sᵀ = k·qᵀ and dpᵀ = v·doᵀ with both
//    operands in shared memory; dv += pᵀ·do and dk += dsᵀ·q with pᵀ/dsᵀ
//    repacked in registers as the A operand and do/q read transposed through
//    the descriptor; dq = ds·k with dsᵀ staged in shared memory (key-major
//    rows) and both operands read transposed, each warpgroup taking 32 of
//    every 64 dq columns over all 128 keys.
// 3. Operands reach the tensor cores through descriptors of 128-byte
//    swizzled tiles that TMA wrote: no per-thread fragment loads, no
//    ldmatrix, no bank conflicts; ds is stored into the same swizzle.
// 4. One producer warp issues the TMA loads of q and do for each query tile
//    into a 3-stage ring (2 in the widest buckets; plus that tile's
//    lse·log2(e) and Δ), each stage
//    guarded by a full and an empty mbarrier; k and v arrive once by TMA.
//    The consumers sync only on those barriers and on one named barrier
//    per tile (both warpgroups' ds in place before the dq product).
//    `setmaxnreg` gives the consumers 232 registers, the producer 40.
//
// Ragged N needs no padding: the tensor maps span exactly N rows (and D
// columns), so TMA fills rows past N and columns past D with zeros; p is set
// to 0 for keys ≥ N and queries ≥ N, whose lse and Δ are never read; dq, dk
// and dv rows past N are not written. q/k/v are 4-D (D, N, H, B) maps over
// the strides the wrapper passes (strided views of one qkv tensor, or
// separate tensors). Widths: DQK ≤ 256, a multiple of 8, instantiated per
// 64-column bucket (a bucket's zero columns cost their products); DV 64 or
// 80 (80 as a 64-column tile and a 16-column product on a second tile).

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64;               // queries per streamed tile
constexpr int BK = 128;              // keys per block: two warpgroups of 64
constexpr int CONSUMERS = 256;       // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // + one producer warpgroup
constexpr int TILE = 64 * 128;       // bytes of a 64-row, 64-column bf16 tile

// Shared-memory layout, byte offsets from a 1024-byte aligned base. KB and
// DVB count 64-column tiles of q/k and of v/do; the q/do ring has 3 stages
// where they fit in the 227 KB a block may use, else 2.
template <int KB, int DVB>
struct Smem {
  static constexpr int STAGES = KB + DVB <= 4 ? 3 : 2;
  static constexpr int K = 0;                            // [KB][BK rows]
  static constexpr int V = K + KB * 2 * TILE;            // [DVB][BK rows]
  static constexpr int Q = V + DVB * 2 * TILE;           // [STAGES][KB][BQ rows]
  static constexpr int DO = Q + STAGES * KB * TILE;      // [STAGES][DVB][BQ rows]
  static constexpr int DS = DO + STAGES * DVB * TILE;    // [2][BK rows of BQ]: dsᵀ
  static constexpr int L = DS + 2 * 2 * TILE;            // [STAGES][BQ]: lse·log2(e)
  static constexpr int DL = L + STAGES * BQ * 4;         // [STAGES][BQ]: Δ
  static constexpr int BAR = DL + STAGES * BQ * 4;       // full[S], empty[S], kv
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
};

struct Params {
  const float* lse;    // (B, H, N) natural log
  const float* delta;  // (B, H, N)
  float* dq;           // (B, N, H, DQK) fp32 workspace, zeroed
  __nv_bfloat16* dk;   // (B, N, H, DQK)
  __nv_bfloat16* dv;   // (B, N, H, DV)
  int N, H, DQK;
  float scale;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The A operands of four 16-deep steps from a 64×64 accumulator.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
  }
}

template <int KB, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const Params p) {
  constexpr int DVB = (DV + 63) / 64;
  using S = Smem<KB, DVB>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_bar = empty + STAGES;
  float* Ls = reinterpret_cast<float*>(sm + S::L);
  float* Ds = reinterpret_cast<float*>(sm + S::DL);

  const int tid = threadIdx.x, lane = tid & 31;
  const int k0 = blockIdx.x * BK;
  const int bhi = blockIdx.y, b = bhi / p.H, h = bhi % p.H;
  const int N = p.N;
  const int n_qt = (N + BQ - 1) / BQ;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);  // every producer lane, one with the TMA bytes
      mbar_init(&empty[s], 8);  // one lane of each consumer warp
    }
    mbar_init(kv_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<40>();
    if (tid >= CONSUMERS + 32) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_bar, (KB + DVB) * 2 * TILE);
      for (int j = 0; j < KB; ++j) tma_load_4d(sm + S::K + j * 2 * TILE, &tk, kv_bar, j * 64, k0, h, b);
      for (int j = 0; j < DVB; ++j) tma_load_4d(sm + S::V + j * 2 * TILE, &tv, kv_bar, j * 64, k0, h, b);
    }
    const float* lb = p.lse + (long long)bhi * N;
    const float* db = p.delta + (long long)bhi * N;
    for (int it = 0; it < n_qt; ++it) {
      const int st = it % STAGES;
      mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
      const int q0 = it * BQ;
      for (int i = lane; i < BQ; i += 32) {
        const bool ok = q0 + i < N;
        Ls[st * BQ + i] = ok ? lb[q0 + i] * LOG2E : 0.f;
        Ds[st * BQ + i] = ok ? db[q0 + i] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[st], (KB + DVB) * TILE);
        for (int j = 0; j < KB; ++j)
          tma_load_4d(sm + S::Q + (st * KB + j) * TILE, &tq, &full[st], j * 64, q0, h, b);
        for (int j = 0; j < DVB; ++j)
          tma_load_4d(sm + S::DO + (st * DVB + j) * TILE, &tdo, &full[st], j * 64, q0, h, b);
      } else {
        mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  setmaxnreg_inc<232>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int key0 = k0 + wg * 64 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const bool kok0 = key0 < N, kok1 = key0 + 8 < N;
  const float slog2 = p.scale * LOG2E;
  unsigned char* Ks = sm + S::K;
  unsigned char* Vs = sm + S::V;

  float dk[KB][32], dv[32], dvx[8];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int j = 0; j < KB; ++j) dk[j][i] = 0.f;
    dv[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) dvx[i] = 0.f;

  mbar_wait(kv_bar, 0);
  for (int it = 0; it < n_qt; ++it) {
    const int st = it % STAGES;
    const int q0 = it * BQ;
    mbar_wait(&full[st], (it / STAGES) & 1);
    unsigned char* Qt = sm + S::Q + st * KB * TILE;
    unsigned char* Ot = sm + S::DO + st * DVB * TILE;
    const float* Lt = Ls + st * BQ;
    const float* Dt = Ds + st * BQ;

    // Sᵀ = k·qᵀ and dpᵀ = v·doᵀ, 64 keys × 64 queries each, K-major operands
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KB * 4; ++ks)
      SS<64, 0, 0>::run(s, desc_sw128(Ks + (ks / 4) * 2 * TILE + wg * 64 * 128 + (ks % 4) * 32),
                        desc_sw128(Qt + (ks / 4) * TILE + (ks % 4) * 32), ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < DV / 16; ++ks)
      SS<64, 0, 0>::run(dp, desc_sw128(Vs + (ks / 4) * 2 * TILE + wg * 64 * 128 + (ks % 4) * 32),
                        desc_sw128(Ot + (ks / 4) * TILE + (ks % 4) * 32), ks > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // pᵀ = exp2(sᵀ·scale·log2(e) − lse·log2(e)); keys ≥ N and queries ≥ N give 0
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = 8 * j + 2 * t + e;
        const bool qok = q0 + qc < N;
        const float l = Lt[qc];
        s[4 * j + e] = qok && kok0 ? ex2(fmaf(s[4 * j + e], slog2, -l)) : 0.f;
        s[4 * j + 2 + e] = qok && kok1 ? ex2(fmaf(s[4 * j + 2 + e], slog2, -l)) : 0.f;
      }
    }
    // dv += bf16(pᵀ)·do, do read MN-major (depth = queries)
    uint32_t pa[4][4];
    pack_a(pa, s);
    fence_regs(dv);
    if constexpr (DV == 80) fence_regs(dvx);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      RS<64, 1>::run(dv, pa[kk], desc_sw128(Ot + kk * 2048));
      if constexpr (DV == 80) RS<16, 1>::run(dvx, pa[kk], desc_sw128(Ot + TILE + kk * 2048));
    }
    wgmma_commit();
    wgmma_wait<1>();  // dpᵀ done; dv may still run
    fence_regs(dp);

    // dsᵀ = pᵀ ∘ (dpᵀ − Δ)·scale
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = Dt[8 * j + 2 * t + e];
        s[4 * j + e] *= (dp[4 * j + e] - dl) * p.scale;
        s[4 * j + 2 + e] *= (dp[4 * j + 2 + e] - dl) * p.scale;
      }
    }
    // dk += bf16(dsᵀ)·q, q read MN-major
    uint32_t da[4][4];
    pack_a(da, s);
#pragma unroll
    for (int j = 0; j < KB; ++j) fence_regs(dk[j]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KB; ++j) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) RS<64, 1>::run(dk[j], da[kk], desc_sw128(Qt + j * TILE + kk * 2048));
    }
    wgmma_commit();
    wgmma_wait<1>();  // dv done: pᵀ's registers are free
    fence_regs(dv);
    if constexpr (DV == 80) fence_regs(dvx);
    fence_regs(pa[0]);
    fence_regs(pa[1]);
    fence_regs(pa[2]);
    fence_regs(pa[3]);

    // bf16(dsᵀ) into this tile's buffer: key rows of 64 queries, swizzled
    unsigned char* dsb = sm + S::DS + (it & 1) * 2 * TILE;
    const int r0 = wg * 64 + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r1 = r0 + 8;
      *reinterpret_cast<uint32_t*>(dsb + r0 * 128 + ((j ^ (r0 & 7)) << 4) + 4 * t) = da[j / 2][(j & 1) * 2];
      *reinterpret_cast<uint32_t*>(dsb + r1 * 128 + ((j ^ (r1 & 7)) << 4) + 4 * t) = da[j / 2][(j & 1) * 2 + 1];
    }
    fence_async_smem();
    named_barrier(1, CONSUMERS);  // both warpgroups' dsᵀ in place

    // dq partial = ds·k over the 128 keys, 64 queries × 32 columns per
    // 64-column tile: dsᵀ read MN-major as A, k read MN-major as B
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      float dq[16];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        SS<32, 1, 1>::run(dq, desc_sw128(dsb + kk * 2048),
                          desc_sw128(Ks + j * 2 * TILE + kk * 2048 + wg * 64), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      // lanes t and t ^ 1 swap halves so that each adds 4 adjacent columns
      // of one row: row g (even t) or g + 8 (odd t)
      const bool odd = t & 1;
      const int q = q0 + warp * 16 + g + (odd ? 8 : 0);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = j * 64 + wg * 32 + 8 * c;
        if (col >= p.DQK) continue;  // the same for the whole warp
        const float x = __shfl_xor_sync(0xffffffffu, odd ? dq[4 * c] : dq[4 * c + 2], 1);
        const float y = __shfl_xor_sync(0xffffffffu, odd ? dq[4 * c + 1] : dq[4 * c + 3], 1);
        const float4 v4 = odd ? make_float4(x, y, dq[4 * c + 2], dq[4 * c + 3])
                              : make_float4(dq[4 * c], dq[4 * c + 1], x, y);
        if (q < N)
          atomicAdd(reinterpret_cast<float4*>(p.dq + ((long long)(b * N + q) * p.H + h) * p.DQK +
                                              col + 4 * (t >> 1)),
                    v4);
      }
    }
    fence_regs(da[0]);
    fence_regs(da[1]);
    fence_regs(da[2]);
    fence_regs(da[3]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // every product reading q/do is done
  }

  // dk and dv, rounded once to bf16
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = key0 + 8 * hh;
    if (key >= N) continue;
    __nv_bfloat16* ko = p.dk + ((long long)(b * N + key) * p.H + h) * p.DQK;
    __nv_bfloat16* vo = p.dv + ((long long)(b * N + key) * p.H + h) * DV;
#pragma unroll
    for (int j = 0; j < KB; ++j) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = j * 64 + 8 * c + 2 * t;
        if (col < p.DQK)
          *reinterpret_cast<uint32_t*>(ko + col) = pack_bf16(dk[j][4 * c + 2 * hh], dk[j][4 * c + 2 * hh + 1]);
      }
    }
#pragma unroll
    for (int c = 0; c < 8; ++c)
      *reinterpret_cast<uint32_t*>(vo + 8 * c + 2 * t) = pack_bf16(dv[4 * c + 2 * hh], dv[4 * c + 2 * hh + 1]);
    if constexpr (DV == 80) {
#pragma unroll
      for (int c = 0; c < 2; ++c)
        *reinterpret_cast<uint32_t*>(vo + 64 + 8 * c + 2 * t) = pack_bf16(dvx[4 * c + 2 * hh], dvx[4 * c + 2 * hh + 1]);
    }
  }
}

template <int KB, int DV>
int launch(const void* const* ptr, int B, int N, int H, int DQK, const int* st, float scale,
           cudaStream_t stream) {
  using S = Smem<KB, (DV + 63) / 64>;
  CUtensorMap tq, tk, tv, tdo;
  if (!bf16_map_4d(&tq, ptr[0], DQK, N, H, B, st[1], st[2], st[0], BQ) ||
      !bf16_map_4d(&tk, ptr[1], DQK, N, H, B, st[4], st[5], st[3], BK) ||
      !bf16_map_4d(&tv, ptr[2], DV, N, H, B, st[7], st[8], st[6], BK) ||
      !bf16_map_4d(&tdo, ptr[3], DV, N, H, B, (long long)H * DV, DV, (long long)N * H * DV, BQ))
    return (int)cudaErrorInvalidValue;
  const Params prm = {(const float*)ptr[4], (const float*)ptr[5], (float*)ptr[6],
                      (__nv_bfloat16*)ptr[7], (__nv_bfloat16*)ptr[8], N, H, DQK, scale};
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel<KB, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BK - 1) / BK, B * H);
  flash_bwd_kernel<KB, DV><<<grid, THREADS, S::BYTES, stream>>>(tq, tk, tv, tdo, prm);
  return (int)cudaGetLastError();
}

template <int DV>
int launch_dv(const void* const* p, int B, int N, int H, int DQK, const int* st, float scale,
              cudaStream_t s) {
  switch ((DQK + 63) / 64) {
    case 1: return launch<1, DV>(p, B, N, H, DQK, st, scale, s);
    case 2: return launch<2, DV>(p, B, N, H, DQK, st, scale, s);
    case 3: return launch<3, DV>(p, B, N, H, DQK, st, scale, s);
    case 4: return launch<4, DV>(p, B, N, H, DQK, st, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/k: (B, N, H, DQK) bf16, v: (B, N, H, DV) bf16, each with unit stride over
// its last dim and 16-byte aligned rows; the batch, token and head strides
// (elements, multiples of 8) are passed per tensor. dout: contiguous
// (B, N, H, DV) bf16; lse (natural log) and delta = rowsum(dout ∘ o):
// contiguous (B, H, N) fp32. dq_acc: a zeroed contiguous (B, N, H, DQK) fp32
// workspace that receives dq; dk and dv: contiguous (B, N, H, DQK) and
// (B, N, H, DV) bf16 outputs. DV = 64 or 80; DQK ≤ 256, a multiple of 8.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* dq_acc, void* dk,
                              void* dv, int B, int N, int H, int DQK, int DV, int sq_b, int sq_n,
                              int sq_h, int sk_b, int sk_n, int sk_h, int sv_b, int sv_n,
                              int sv_h, float scale, void* stream) {
  if (N < 1 || DQK < 8 || DQK > 256 || DQK % 8) return (int)cudaErrorInvalidValue;
  const void* p[9] = {q, k, v, dout, lse, delta, dq_acc, dk, dv};
  const int st[9] = {sq_b, sq_n, sq_h, sk_b, sk_n, sk_h, sv_b, sv_n, sv_h};
  cudaStream_t s = (cudaStream_t)stream;
  if (DV == 64) return launch_dv<64>(p, B, N, H, DQK, st, scale, s);
  if (DV == 80) return launch_dv<80>(p, B, N, H, DQK, st, scale, s);
  return (int)cudaErrorInvalidValue;
}
