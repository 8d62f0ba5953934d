// Flash attention forward (bf16 in, fp32 accumulation, bf16 out + fp32 LSE),
// on wgmma and TMA for Hopper.
//
// Replaces: cellvit_tpu/ops/attention.py:32 `_flash_kernel` (pallas_call at
// :441 in `_flash_fwd_call`, reached through `flash_attention` :567).
//
// Computes o = softmax(q·kᵀ·scale)·v per (batch, head) over (B, N, H, ·)
// tensors without materialising the N×N logits, and the natural-log
// log-sum-exp of the scaled logits per query row (the residual of the
// backward, B8). q and k may be wider than v (DQK ≥ DV): the rel-pos
// fallback and the rel-pos backward pass the lane-augmented
// q′ = [q·scale | Bh | Bw] and k′ = [k | 1{row} | 1{col}] with scale 1,
// DQK = D + gh + gw.
//
// Bound on the H100: 2·B·H·N²·(DQK + DV) matrix FLOPs (≈206 GFLOP at the
// ViT-256 path's (8, 4097, 6, 64), ≈0.21 ms at 989 TFLOP/s bf16) and B·H·N²
// exponentials on the SFUs (≈0.81 G, ≈0.19 ms at 132 SMs × 16 a clock and
// 1.98 GHz); the bytes (q, k, v, o ≈ 50 MB) take ≈0.015 ms. Bound by
// operations, with the exponentials as large as the products: the design
// counts on one consumer warpgroup's exponentials overlapping another's
// products.
//
// The kernel is `flash_fwd_sm90.cuh`'s (shared with B6): a TMA producer
// and consumer warpgroups of 64 queries, 128-key k/v tiles in a 2-stage
// mbarrier ring, S = q·kᵀ and O += P·V on wgmma. q/k are instantiated per
// 64-column width bucket (64, 128, 192, 256 columns; a bucket's zero columns
// cost their products, and the 256 bucket takes 64-key tiles to fit shared
// memory); v is 64 or 80 wide; DQK ≤ 256 and a multiple of 8 (16-byte
// rows). The tensor maps span exactly N rows and DQK or DV columns: N needs
// no padding (4097 = CLS + 64²).
//
// Warpgroups and overlap per instantiation: with v 64 wide (the encoder's
// heads) three consumer warpgroups, 192 queries a block, each running its
// products and softmax back to back, measured fastest at the main path's
// shape; with v 80 wide (the rel-pos routes' q′/k′), where three
// warpgroups spill, and in the 192-column bucket, whose 192-row q tiles do
// not fit shared memory, two in turns.

#include "flash_fwd_sm90.cuh"

namespace {

using namespace flash_fwd;

template <int KB, int DV>
int launch_bucket(const void* q, const void* k, const void* v, void* o, void* lse, int B, int N,
                  int H, int DQK, const int* st, float scale, cudaStream_t stream) {
  constexpr int BK = KB == 4 ? 64 : 128;
  constexpr int NWG = DV == 64 && KB != 3 ? 3 : 2;
  CUtensorMap tq, tk, tv;
  if (!bf16_map_4d(&tq, q, DQK, N, H, B, st[1], st[2], st[0], Team<NWG>::BQ) ||
      !bf16_map_4d(&tk, k, DQK, N, H, B, st[4], st[5], st[3], BK) ||
      !bf16_map_4d(&tv, v, DV, N, H, B, st[7], st[8], st[6], BK))
    return (int)cudaErrorInvalidValue;
  const Params prm = {(__nv_bfloat16*)o, (float*)lse, nullptr, nullptr, N, H, 0, 0, scale * LOG2E};
  return launch<KB, 4 * KB, DV, BK, NONE, NWG, NWG == 2>(tq, tk, tv, prm, B, stream);
}

template <int DV>
int launch_dv(const void* q, const void* k, const void* v, void* o, void* lse, int B, int N,
              int H, int DQK, const int* st, float scale, cudaStream_t s) {
  switch ((DQK + 63) / 64) {  // width bucket: 64, 128, 192 or 256 columns
    case 1: return launch_bucket<1, DV>(q, k, v, o, lse, B, N, H, DQK, st, scale, s);
    case 2: return launch_bucket<2, DV>(q, k, v, o, lse, B, N, H, DQK, st, scale, s);
    case 3: return launch_bucket<3, DV>(q, k, v, o, lse, B, N, H, DQK, st, scale, s);
    case 4: return launch_bucket<4, DV>(q, k, v, o, lse, B, N, H, DQK, st, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/k: (B, N, H, DQK) bf16, v: (B, N, H, DV) bf16, each with unit stride over
// its last dim and 16-byte aligned rows; the batch, token and head strides
// (elements, multiples of 8) are passed per tensor. o: a contiguous
// (B, N, H, DV) bf16 output; lse: a contiguous (B, H, N) fp32 output. DV = 64
// or 80; DQK ≤ 256, a multiple of 8; scale > 0.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int B, int N, int H, int DQK, int DV, int sq_b, int sq_n, int sq_h,
                              int sk_b, int sk_n, int sk_h, int sv_b, int sv_n, int sv_h,
                              float scale, void* stream) {
  if (N < 1 || DQK < 8 || DQK > 256 || DQK % 8 || !(scale > 0.f)) return (int)cudaErrorInvalidValue;
  const int st[9] = {sq_b, sq_n, sq_h, sk_b, sk_n, sk_h, sv_b, sv_n, sv_h};
  cudaStream_t s = (cudaStream_t)stream;
  if (DV == 64) return launch_dv<64>(q, k, v, o, lse, B, N, H, DQK, st, scale, s);
  if (DV == 80) return launch_dv<80>(q, k, v, o, lse, B, N, H, DQK, st, scale, s);
  return (int)cudaErrorInvalidValue;
}
