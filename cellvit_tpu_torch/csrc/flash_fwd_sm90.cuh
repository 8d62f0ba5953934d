// Flash attention forward for Hopper (sm_90a), shared by B1 (`flash_attn.cu`),
// B6 (`relpos_attn.cu`) and B5's attention (`win_qkv_attn.cu`):
// o = softmax(q·kᵀ·scale [+ bias])·v per (batch, head) over (B, N, H, ·)
// bf16 tensors, fp32 accumulation, bf16 o and, for B1, the natural-log
// log-sum-exp per query row.
//
// Structure (FlashAttention-3's): one block per (query tile, batch·head);
// for B5 one block an SM that walks such items.
// - A producer warpgroup (`setmaxnreg` 40 or 32) of which one thread
//   issues TMA loads: the q tile once, then 128-key k and v tiles (64 keys
//   for the 256-column bucket, whose 128-key stages do not fit) into a
//   2-stage ring, each stage with a full barrier for k, one for v and an
//   empty barrier.
// - Two or three consumer warpgroups (`Team`: `setmaxnreg` 232 or 160), 64
//   query rows each: S = q·kᵀ by an SS wgmma with both operands K-major from the swizzled
//   tiles (m64nBKk16, one step per 16 columns of q/k: a wider q/k costs
//   depth, not accumulator registers); the online softmax in base 2 on the
//   accumulator (scale·log2(e) folded into one FMA, row max and sum over the
//   lane quad, keys past N masked only in the ragged last tile); O += P·V by
//   an RS wgmma, P repacked from the S accumulator into the A operand, v read
//   MN-major (v 80 wide is one m64n80 product over two 64-column tiles).
// - TMA fills rows past N and columns past the real width with zeros, so no
//   operand is padded in memory; rows past N are not written.
//
// The rel-pos bias (B6) is added on the accumulator: bias[q, key] =
// Bh[q, key / gw] + Bw[q, key % gw] from (B, N, H, gh) and (B, N, H, gw) bf16
// terms. Where gw is 8, 16, 32 or 64 (it divides the tile), a thread's
// accumulator column 8j + 2t + e falls on grid column 8·(j mod gw/8) + 2t + e
// in every key tile: the thread keeps those Bw values in registers for the
// whole key loop, and loads Bh of the tile's 128/gw grid rows while S is in
// flight. Other gw gather Bh and Bw per logit.
//
// B5's windows (EXPAND, N ≤ 256, side ≤ 16) follow the Pallas kernel's
// arithmetic: each consumer warpgroup rescales its q rows in shared memory
// once to bf16(q·scale·log2(e)), and the bias joins S on the tensor cores as
// one more K = 32 product, [Bh | Bw] (64 × 32, the terms in base 2, bf16, from
// registers) times a one-hot [E_row; E_col] (32 × 128 keys per key tile,
// built once per block in shared memory): S arrives as base-2 logits.
//
// Overlap: with TURNS, two consumer warpgroups issue their S products in
// turns on two named barriers, so one's softmax runs while the other's
// products do; otherwise each warpgroup runs its products and softmax back
// to back. The launching file picks warpgroups and turns per instantiation.

#pragma once

#include <math.h>

#include "sm90.cuh"

namespace flash_fwd {

using namespace sm90;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// A block of NWG consumer warpgroups (64 queries each) and one producer
// warpgroup; `setmaxnreg` moves the producer's registers to the consumers.
template <int NWG>
struct Team {
  static constexpr int BQ = 64 * NWG;                 // queries per block
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int THREADS = CONSUMERS + 128;
  static constexpr int PRODUCER_REGS = NWG == 2 ? 40 : 32;
  static constexpr int CONSUMER_REGS = NWG == 2 ? 232 : 160;  // 64K registers in all
};
constexpr int STAGES = 2;

// The kernel's BIAS argument: none (B1); the rel-pos bias gathered per
// logit; expanded by a one-hot product (B5); or a grid width gw of 8, 16, 32
// or 64, whose bias terms the threads hold in registers.
constexpr int NONE = 0, GATHER = 1, EXPAND = -1;
constexpr int EXPAND_W = 16;  // EXPAND's Bh/Bw row stride: side ≤ 16 terms, zero-padded

// B5's items (the two query tiles of a ≤ 256-token window and head) are too
// short for a block's set-up and first loads: under EXPAND the grid is
// persistent, one block an SM, and the producer loads the next item's q
// into a second buffer while the consumers finish this one. B1's and B6's
// blocks take one item each.
template <int BIAS>
constexpr int Q_BUFFERS = BIAS == EXPAND ? 2 : 1;

// Shared-memory layout, byte offsets from a 1024-byte aligned base; KB and
// DVB count 64-column tiles of q/k and of v, NE the one-hot tiles (EXPAND),
// QB the q buffers.
template <int KB, int DVB, int BK, int BQ, int NE = 0, int QB = 1>
struct Smem {
  static constexpr int TQ = BQ * 128;                 // one 64-column q tile
  static constexpr int TK = BK * 128;                 // one 64-column k or v tile
  static constexpr int Q = 0;                         // [QB][KB][BQ rows]
  static constexpr int K = Q + QB * KB * TQ;          // [STAGES][KB][BK rows]
  static constexpr int V = K + STAGES * KB * TK;      // [STAGES][DVB][BK rows]
  static constexpr int E = V + STAGES * DVB * TK;     // [NE][BK rows]
  static constexpr int BAR = E + NE * TK;  // q_full[QB], q_empty[QB], full_k[S], full_v[S], empty[S]
  static constexpr int BYTES = BAR + (2 * QB + 3 * STAGES) * 8 + 1024;  // + alignment slack
};

struct Params {
  __nv_bfloat16* o;         // (B, N, H, DV) contiguous
  float* lse;               // (B, H, N) contiguous, natural log; null: not written
  const __nv_bfloat16* bh;  // (B, N, H, gh) contiguous (B6); (B, N, H, EXPAND_W) (B5)
  const __nv_bfloat16* bw;  // (B, N, H, gw) contiguous (B6); (B, N, H, EXPAND_W) (B5)
  int N, H, gh, gw;  // B5: gh = gw = the window's side
  float scale_log2;  // scale · log2(e), > 0
  int B;             // batch; set by `launch`
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

__device__ __forceinline__ float ldbf(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }

// KB: 64-column q/k tiles; KS: 16-deep steps of q·kᵀ (4·KB, or D/16 for
// B6); DV: v's width, 64 or 80; BK: keys per tile; BIAS: NONE, GATHER or
// gw; NWG: consumer warpgroups; TURNS: the two consumer warpgroups issue S
// in turns (NWG = 2 only).
template <int KB, int KS, int DV, int BK, int BIAS, int NWG, bool TURNS>
__global__ void __launch_bounds__(Team<NWG>::THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Params p) {
  using T = Team<NWG>;
  constexpr int BQ = T::BQ, CONSUMERS = T::CONSUMERS;
  static_assert(!TURNS || NWG == 2, "turns take two consumer warpgroups");
  constexpr int DVB = (DV + 63) / 64;
  constexpr int NS = BK / 2;  // S accumulator values a thread holds
  constexpr bool EXP = BIAS == EXPAND;
  static_assert(!EXP || BK == 128, "the one-hot tiles cover 128 keys");
  constexpr int QB = Q_BUFFERS<BIAS>;
  using S = Smem<KB, DVB, BK, BQ, EXP ? STAGES : 0, QB>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + S::BAR);
  uint64_t* q_empty = q_full + QB;
  uint64_t* full_k = q_empty + QB;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty = full_v + STAGES;

  const int tid = threadIdx.x, lane = tid & 31;
  const int N = p.N;
  const int n_kt = (N + BK - 1) / BK;
  // B5's work items (query tile, batch·head), query tile fastest: a block
  // takes items blockIdx.x, blockIdx.x + gridDim.x, ...; B1's and B6's
  // block is query tile blockIdx.x of batch·head blockIdx.y
  const int n_qt = (N + BQ - 1) / BQ, n_items = n_qt * p.B * p.H;

  if (tid == 0) {
    for (int i = 0; i < QB; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 4 * NWG);  // one lane of each consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 4 * NWG);  // one lane of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<T::PRODUCER_REGS>();
    if (tid == CONSUMERS) {
      auto load_item = [&](int ji, int q0, int bhi) {
        const int b = bhi / p.H, h = bhi % p.H;
        const int qb = ji % QB;
        if constexpr (EXP) mbar_wait(&q_empty[qb], ((ji / QB) & 1) ^ 1);
        mbar_arrive_expect_tx(&q_full[qb], KB * S::TQ);
        for (int j = 0; j < KB; ++j)
          tma_load_4d(sm + S::Q + (qb * KB + j) * S::TQ, &tq, &q_full[qb], j * 64, q0, h, b);
        for (int it = 0; it < n_kt; ++it) {
          const int kt = ji * n_kt + it;  // the ring's position: every item has n_kt tiles
          const int st = kt % STAGES;
          mbar_wait(&empty[st], ((kt / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&full_k[st], KB * S::TK);
          for (int j = 0; j < KB; ++j)
            tma_load_4d(sm + S::K + (st * KB + j) * S::TK, &tk, &full_k[st], j * 64, it * BK, h, b);
          mbar_arrive_expect_tx(&full_v[st], DVB * S::TK);
          for (int j = 0; j < DVB; ++j)
            tma_load_4d(sm + S::V + (st * DVB + j) * S::TK, &tv, &full_v[st], j * 64, it * BK, h, b);
        }
      };
      if constexpr (EXP) {
        for (int ji = 0, item = blockIdx.x; item < n_items; ++ji, item += gridDim.x)
          load_item(ji, item % n_qt * BQ, item / n_qt);
      } else {
        load_item(0, blockIdx.x * BQ, blockIdx.y);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    setmaxnreg_inc<T::CONSUMER_REGS>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
    unsigned char* Ks = sm + S::K;
    unsigned char* Vs = sm + S::V;
    if constexpr (EXP) {
      // the one-hot tiles, K-major and swizzled as TMA lays out a k tile:
      // row = key of tile `it`, column r < 16 is 1 where key / side == r and
      // column 16 + c where key % side == c (keys past N: zero)
      for (int i = tid; i < n_kt * BK * 8; i += CONSUMERS) {
        const int it = i / (BK * 8), row = (i / 8) % BK, ch = i % 8;
        const int key = it * BK + row;
        const int kr = key / p.gw, kc = key - kr * p.gw;
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (key < N && ch < 4) {
          const int col = ch < 2 ? kr - 8 * ch : kc - 8 * (ch - 2);  // position in this chunk
          if (col >= 0 && col < 8) w[col / 2] = (col & 1) ? 0x3F800000u : 0x3F80u;  // bf16 1.0
        }
        *reinterpret_cast<uint4*>(sm + S::E + it * S::TK + row * 128 + ((ch ^ (row & 7)) * 16)) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
      fence_async_smem();
      named_barrier(8, CONSUMERS);
    }

    auto run_item = [&](int ji, int q0, int bhi) {
      const int b = bhi / p.H, h = bhi % p.H;
      const int qb = ji % QB;
      const int row0 = q0 + wg * 64 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
      unsigned char* Qs = sm + S::Q + qb * KB * S::TQ + wg * 64 * 128;

      // B6: this thread's rows of Bh and Bw (the last row stands in for rows
      // past N, whose outputs are not written). With gw in registers
      // (BIAS = gw), accumulator column 8j + 2t + e of every key tile falls on
      // grid column 8·(j mod gw/8) + 2t + e: the thread keeps those gw/4
      // values of Bw·log2(e) per row, and Bh·log2(e) of the tile's 128/gw grid
      // rows, loaded while S is in flight.
      constexpr bool REG = BIAS > GATHER;
      constexpr int GW = REG ? BIAS : 8, NR = BK / GW;
      const __nv_bfloat16* bh_row[2] = {nullptr, nullptr};
      const __nv_bfloat16* bw_row[2] = {nullptr, nullptr};
      float bwl[2][GW / 4], bhv[2][NR];
      // B5: the A operand of the one-hot product, [Bh | Bw] of this thread's
      // rows as two 16-deep steps (accumulator order: a0 = row g, terms 2t and
      // 2t + 1; a1 = row g + 8; a2, a3 = terms 2t + 8 and 2t + 9)
      uint32_t ba[2][4];
      if constexpr (EXP) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long long r = min(row0 + 8 * hh, N - 1);
          const long long off = ((b * (long long)N + r) * p.H + h) * EXPAND_W + 2 * t;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const __nv_bfloat16* src = i ? p.bw : p.bh;
            ba[i][hh] = __ldg(reinterpret_cast<const unsigned int*>(src + off));
            ba[i][2 + hh] = __ldg(reinterpret_cast<const unsigned int*>(src + off + 8));
          }
        }
      }
      if constexpr (BIAS == GATHER || REG) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long long r = min(row0 + 8 * hh, N - 1);
          bh_row[hh] = p.bh + ((b * (long long)N + r) * p.H + h) * p.gh;
          bw_row[hh] = p.bw + ((b * (long long)N + r) * p.H + h) * p.gw;
        }
      }
      if constexpr (REG) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int c = 0; c < GW / 4; ++c) bwl[hh][c] = ldbf(bw_row[hh] + 8 * (c / 2) + 2 * t + c % 2) * LOG2E;
        }
      }
      auto load_bh = [&](int it) {
        if constexpr (REG) {
#pragma unroll
          for (int jr = 0; jr < NR; ++jr) {
            const int r = it * NR + jr;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) bhv[hh][jr] = r < p.gh ? ldbf(bh_row[hh] + r) * LOG2E : 0.f;
          }
        }
      };

      float o[32], ox[8];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) ox[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2] = {0.f, 0.f};
      float s[NS];
      uint32_t pa[BK / 16][4];

      auto issue_s = [&](int st, int it) {
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          SS<BK, 0, 0>::run(s, desc_sw128(Qs + (ks / 4) * S::TQ + (ks % 4) * 32),
                            desc_sw128(Ks + (st * KB + ks / 4) * S::TK + (ks % 4) * 32), ks > 0);
        if constexpr (EXP) {
#pragma unroll
          for (int i = 0; i < 2; ++i) RS<BK, 0>::run(s, ba[i], desc_sw128(sm + S::E + it * S::TK + i * 32));
        }
        wgmma_commit();
      };
      auto issue_pv = [&](int st) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          if constexpr (DV == 80)
            RS80::run(o, ox, pa[kk], desc_sw128_mn(Vs + st * DVB * S::TK + kk * 2048, S::TK));
          else
            RS<64, 1>::run(o, pa[kk], desc_sw128(Vs + st * DVB * S::TK + kk * 2048));
        }
        wgmma_commit();
      };
      auto fence_pv = [&]() {
        fence_regs(o);
        if constexpr (DV == 80) fence_regs(ox);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
      };
      auto rescale = [&]() {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
        if constexpr (DV == 80) {
#pragma unroll
          for (int i = 0; i < 8; ++i) ox[i] *= alpha[(i >> 1) & 1];
        }
      };
      auto pack_p = [&]() {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
          for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
        }
      };
      // The consumers take turns issuing products, in order: warpgroup w
      // waits on barrier 1 + w (256 threads: its own and the one handing
      // over) and then lets the next go. The last warpgroup opens the first
      // turn of warpgroup 0 and skips its own last hand-over, so every
      // barrier ends balanced.
      auto turn_begin = [&]() {
        if constexpr (TURNS) named_barrier(1 + wg, 256);
      };
      auto turn_end = [&](bool last) {
        if constexpr (TURNS) {
          if (!(last && wg == NWG - 1)) named_barrier_arrive(1 + (wg + 1) % NWG, 256);
        }
      };
      auto release = [&](int st) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
      };

      // softmax of key tile `it` in place: s becomes p = 2^(x − m) with x the
      // base-2 logit; m, l and alpha (the factor of the previous O) move on
      auto softmax = [&](int it) {
        const int k0 = it * BK;
        const bool ragged = k0 + BK > N;
        float mx[2] = {-INFINITY, -INFINITY};
        if constexpr (BIAS != GATHER) {
          if constexpr (REG) {  // base-2 logits with the bias
#pragma unroll
            for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  float& x = s[4 * j + 2 * hh + e];
                  x = fmaf(x, p.scale_log2, bhv[hh][8 * j / GW] + bwl[hh][2 * (j % (GW / 8)) + e]);
                }
              }
            }
          }
          if (ragged) {
#pragma unroll
            for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                if (k0 + 8 * j + 2 * t + e >= N) s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
              }
            }
          }
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              mx[hh] = fmaxf(mx[hh], fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
          }
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) mx[hh] = quad_max(mx[hh]) * (BIAS == NONE ? p.scale_log2 : 1.f);
        } else {
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = k0 + 8 * j + 2 * t + e;
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int r = min(key / p.gw, p.gh - 1), c = min(key - r * p.gw, p.gw - 1);
                const float bias = (ldbf(bh_row[hh] + r) + ldbf(bw_row[hh] + c)) * LOG2E;
                float& x = s[4 * j + 2 * hh + e];
                x = ragged && key >= N ? -INFINITY : fmaf(x, p.scale_log2, bias);
                mx[hh] = fmaxf(mx[hh], x);
              }
            }
          }
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) mx[hh] = quad_max(mx[hh]);
        }
        // key 0 lies in tile 0, so the running max is finite from tile 0 on
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float mn = fmaxf(m[hh], mx[hh]);
          alpha[hh] = ex2(m[hh] - mn);
          m[hh] = mn;
        }
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s[4 * j + 2 * hh + e];
              x = BIAS == NONE ? ex2(fmaf(x, p.scale_log2, -m[hh])) : ex2(x - m[hh]);
              rs[hh] += x;
            }
          }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + rs[hh];  // per-thread partial
      };

      mbar_wait(&q_full[qb], (ji / QB) & 1);
      if constexpr (EXP) {
        // q → bf16(q·scale·log2(e)) in place, this warpgroup's 64 rows (an
        // elementwise pass: the swizzle does not matter)
        const float f = p.scale_log2;
#pragma unroll
        for (int j = 0; j < KB; ++j) {
          uint4* qv = reinterpret_cast<uint4*>(Qs + j * S::TQ);
#pragma unroll
          for (int i = tid & 127; i < 64 * 128 / 16; i += 128) {
            uint4 u = qv[i];
            __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float2 x = __bfloat1622float2(e[c]);
              e[c] = __floats2bfloat162_rn(x.x * f, x.y * f);
            }
            qv[i] = u;
          }
        }
        fence_async_smem();
        named_barrier(4 + wg, 128);  // this warpgroup's rows, before its products read them
      }
      if (TURNS && wg == NWG - 1) named_barrier_arrive(1, 256);
      for (int it = 0; it < n_kt; ++it) {
        const int kt = ji * n_kt + it;  // the ring's position
        const int st = kt % STAGES;
        const uint32_t par = (kt / STAGES) & 1;
        mbar_wait(&full_k[st], par);
        turn_begin();
        issue_s(st, it);
        turn_end(it == n_kt - 1);
        load_bh(it);
        wgmma_wait<0>();
        fence_regs(s);
        if (EXP && it == n_kt - 1) {  // this item's q·kᵀ products are done: free its q buffer
          __syncwarp();
          if (lane == 0) mbar_arrive(&q_empty[qb]);
        }
        softmax(it);
        rescale();
        pack_p();
        mbar_wait(&full_v[st], par);
        issue_pv(st);
        wgmma_wait<0>();
        fence_pv();
        release(st);
      }

      // o = O / l, rounded once to bf16; lse = (m + log2 l)·ln 2
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
        if (p.lse != nullptr && t == 0) p.lse[(long long)bhi * N + row] = (m[hh] + log2f(fmaxf(sum, 1e-30f))) * LN2;
      }
    };
    if constexpr (EXP) {
      for (int ji = 0, item = blockIdx.x; item < n_items; ++ji, item += gridDim.x)
        run_item(ji, item % n_qt * BQ, item / n_qt);
    } else {
      run_item(0, blockIdx.x * BQ, blockIdx.y);
    }
  }
}

// One launch on encoded maps; raises nothing itself: returns the CUDA error.
template <int KB, int KS, int DV, int BK, int BIAS, int NWG, bool TURNS>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const Params& prm,
           int B, cudaStream_t stream) {
  using T = Team<NWG>;
  using S = Smem<KB, (DV + 63) / 64, BK, T::BQ, BIAS == EXPAND ? STAGES : 0, Q_BUFFERS<BIAS>>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<KB, KS, DV, BK, BIAS, NWG, TURNS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return (int)err;
  Params p = prm;
  p.B = B;
  dim3 grid((prm.N + T::BQ - 1) / T::BQ, B * prm.H);
  if (BIAS == EXPAND) {  // persistent: one block an SM
    const int sms = sm_count();
    if (sms == 0) return (int)cudaErrorInvalidDevice;
    const long long items = (long long)grid.x * grid.y;
    grid = dim3(items < sms ? (int)items : sms);
  }
  flash_fwd_kernel<KB, KS, DV, BK, BIAS, NWG, TURNS><<<grid, T::THREADS, S::BYTES, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace flash_fwd
