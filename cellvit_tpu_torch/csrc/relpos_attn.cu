// Direct-bias rel-pos flash attention forward (bf16 in, fp32 accumulation,
// bf16 out), on wgmma and TMA for Hopper.
//
// Replaces: cellvit_tpu/ops/attention.py:190 `_flash_relpos_kernel`
// (pallas_call at :676 in `_relpos_fwd_only`, reached through
// `flash_attention_relpos` :740), SAM's global-attention blocks.
//
// Computes o = softmax(q·kᵀ·scale + bias)·v per (batch, head) over a
// (gh, gw) token grid, N = gh·gw, with the decomposed rel-pos bias
//   bias[q, key] = Bh[q, key / gw] + Bw[q, key % gw]
// from the (B, N, H, gh) and (B, N, H, gw) terms (`rel_pos_bias`, plain
// torch einsums). The q·kᵀ product stays D wide and no N×N bias ever exists.
//
// Bound on the H100: 4·B·H·N²·D matrix FLOPs (≈0.69 TFLOP at SAM-H's
// (8, 4096, 16, 80), ≈0.70 ms at 989 TFLOP/s bf16) and B·H·N² exponentials
// (≈2.15 G, ≈0.51 ms at 132 SMs × 16 a clock and 1.98 GHz); the bytes (q, k,
// v, o, Bh, Bw ≈ 0.3 GB) take ≈0.09 ms. Bound by operations, with the
// exponentials at ≈75% of the products; the two consumer warpgroups
// overlap one's softmax with the other's products as their own schedules
// fall.
//
// The kernel is `flash_fwd_sm90.cuh`'s (shared with B1): 128-query blocks of
// two consumer warpgroups and a TMA producer, 128-key k/v tiles in a 2-stage
// mbarrier ring, S = q·kᵀ (depth D = 64, or 80 = 64 + 16) and O += P·V on
// wgmma, each warpgroup's products and softmax back to back. The bias goes
// onto the S accumulator in registers: for every grid that `direct_bias_fits`
// routes here at a realistic size (64×64, 32×32, 16×32), gw divides the
// 128-key tile, so each thread's accumulator columns fall on fixed grid
// columns in every tile and its Bw values stay in registers for the whole key
// loop (one instantiation per gw of 8, 16, 32 and 64); Bh of a tile's grid
// rows is loaded while its S is in flight. Other gw (grids such as 160×48,
// which the routing also accepts) gather both terms per logit. Head dim D =
// 64 or 80 (SAM-B/L and SAM-H).

#include "flash_fwd_sm90.cuh"

namespace {

using namespace flash_fwd;

template <int D, int BIAS>
int launch_d(const void* q, const void* k, const void* v, const void* bh, const void* bw, void* o,
             int B, int N, int H, int gh, int gw, int sq_b, int sq_n, int sk_b, int sk_n,
             int sv_b, int sv_n, float scale, cudaStream_t stream) {
  constexpr int BK = 128;
  CUtensorMap tq, tk, tv;
  if (!bf16_map_4d(&tq, q, D, N, H, B, sq_n, D, sq_b, Team<2>::BQ) ||
      !bf16_map_4d(&tk, k, D, N, H, B, sk_n, D, sk_b, BK) ||
      !bf16_map_4d(&tv, v, D, N, H, B, sv_n, D, sv_b, BK))
    return (int)cudaErrorInvalidValue;
  const Params prm = {(__nv_bfloat16*)o, nullptr, (const __nv_bfloat16*)bh,
                      (const __nv_bfloat16*)bw, N, H, gh, gw, scale * LOG2E};
  return launch<(D + 63) / 64, D / 16, D, BK, BIAS, 2, false>(tq, tk, tv, prm, B, stream);
}

template <int D>
int launch_grid(const void* q, const void* k, const void* v, const void* bh, const void* bw,
                void* o, int B, int N, int H, int gh, int gw, int sq_b, int sq_n, int sk_b,
                int sk_n, int sv_b, int sv_n, float scale, cudaStream_t s) {
#define RELPOS_LAUNCH(BIAS) \
  launch_d<D, BIAS>(q, k, v, bh, bw, o, B, N, H, gh, gw, sq_b, sq_n, sk_b, sk_n, sv_b, sv_n, scale, s)
  switch (gw) {  // grid widths whose bias the threads hold in registers
    case 8: return RELPOS_LAUNCH(8);
    case 16: return RELPOS_LAUNCH(16);
    case 32: return RELPOS_LAUNCH(32);
    case 64: return RELPOS_LAUNCH(64);
  }
  return RELPOS_LAUNCH(GATHER);
#undef RELPOS_LAUNCH
}

}  // namespace

// q/k/v: (B, N, H, D) bf16 with unit stride over D and stride D over H; the
// batch and token strides (elements, multiples of 8) are passed per tensor.
// bh/bw: contiguous (B, N, H, gh) and (B, N, H, gw) bf16 with N = gh·gw. o: a
// contiguous (B, N, H, D) bf16 output. D = 64 or 80; scale > 0.
extern "C" int relpos_attn_fwd(const void* q, const void* k, const void* v, const void* bh,
                               const void* bw, void* o, int B, int N, int H, int D, int gh,
                               int gw, int sq_b, int sq_n, int sk_b, int sk_n, int sv_b,
                               int sv_n, float scale, void* stream) {
  if (N < 1 || gh * gw != N || !(scale > 0.f)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return launch_grid<64>(q, k, v, bh, bw, o, B, N, H, gh, gw, sq_b, sq_n, sk_b, sk_n, sv_b, sv_n, scale, s);
  if (D == 80)
    return launch_grid<80>(q, k, v, bh, bw, o, B, N, H, gh, gw, sq_b, sq_n, sk_b, sk_n, sv_b, sv_n, scale, s);
  return (int)cudaErrorInvalidValue;
}
