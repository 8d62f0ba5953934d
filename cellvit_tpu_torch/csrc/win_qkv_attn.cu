// Window qkv projection + decomposed rel-pos attention forward (bf16 in, fp32
// accumulation, bf16 out), on wgmma and TMA for Hopper.
//
// Replaces: cellvit_tpu/ops/attention.py:862 `_win_qkv_kernel` (pallas_call
// at :1018 in `_win_qkv_fwd_only`, reached through `window_qkv_attention`
// :1079), SAM's windowed blocks.
//
// Per window w and head h, on the window's N = side² LN'd tokens x_w (the
// zero-padded tokens of edge windows included, as in the reference):
//   [q | k | v] = x_w · Wᵀ + b                          (the qkv projection)
//   Bh[t, r] = q_t · Rh[row(t), r],  Bw[t, c] = q_t · Rw[col(t), c]
//   o_h = softmax(q·kᵀ·scale + Bh[·, row(key)] + Bw[·, col(key)]) · v
// with the bias from the UNSCALED q; heads are written side by side into
// (NW, N, C), the layout the output projection reads.
//
// Bound on the H100: the projection is the bulk, 2·NW·N·C·3C FLOPs (385
// GFLOP at SAM-H's 200 windows of 196 tokens, C = 1280), against 4·NW·H·N²·D
// = 39.3 GFLOP for the attention and 2.8 for Bh/Bw: 0.43 ms at 989 TFLOP/s
// bf16, against ≈0.11 GB of x, W and o (≈0.03 ms at 3.35 TB/s). Bound by
// operations, and by the projection's.
//
// The Pallas kernel keeps a window's qkv in VMEM. Here a block's per-window
// projection (196 × 3D × C per head) is too small to feed the tensor cores,
// so the op is three kernels, each with every product on wgmma from
// TMA-loaded, 128-byte-swizzled operands:
// 1. `qkv_proj_kernel`: qkv = x·Wᵀ + b over all NW·N rows at once, one GEMM
//    (39,200 × 1280 × 3840 at SAM-H). A persistent grid (one block per SM)
//    walks 128 × 256 output tiles in row-major order (W, 9.8 MB, stays in
//    L2); a producer warp keeps a 3-stage ring of 64-deep x and W tiles in
//    flight, two consumer warpgroups each run 64 × 256 m64n256k16 products
//    with one k-step in flight. The epilogue adds the fp32 bias (staged in
//    shared memory), rounds to bf16 into swizzled shared-memory tiles and
//    stores them by TMA while the next tile's products run: stores from
//    the accumulator layout (16 bytes of a row per four threads) took 0.27
//    of 0.86 ms at SAM-H's shape on an H100 (700 W). TMA fills rows past NW·N with zeros and clips
//    them on the way out. The weight's columns are [q | k | v], head-major
//    within each, so the (NW·N, 3C) result already is (NW, N, 3, H, D): the
//    next kernels read q, k and v by strides. It costs 0.3 GB written and
//    read back (≈0.18 ms at 3.35 TB/s), against ≈0.4 ms of products that it
//    lets run at the tensor cores' rate.
// 2. `relpos_terms_kernel`: Bh and Bw in base 2, bf16, from the bf16 q. The
//    tokens of one grid row i share Rh[i], so one block takes grid row (or
//    column) i in four windows as a 64-row A operand, a 5-D TMA box (D, 16
//    positions along the row, 1, 1, 4 windows; positions past the side
//    zero), and Rh[i] (or Rw[i]) as a 16-row B: one m64n16 product over D a
//    head, the heads' A boxes streaming through a 4-stage ring.
// 3. The attention: `flash_fwd_sm90.cuh`'s kernel (B1's and B6's) with
//    batch = NW, q/k/v read from the qkv buffer by strides, in its EXPAND
//    mode: q rescaled once in shared memory to bf16(q·scale·log2 e), and the
//    bias added to S on the tensor cores as [Bh | Bw] times a one-hot
//    expansion, as the Pallas kernel does on the MXU; the second 128-key
//    tile's keys past N are masked. Its items (two query tiles of a window
//    and head) are short, so its grid is persistent and the next item's q
//    loads while a block finishes the current one.
// Head dim D = 64 or 80; side ≤ 16 (N ≤ 256); C a multiple of 32, 3C ≤ 4096.

#include "flash_fwd_sm90.cuh"

namespace {

using namespace sm90;
using flash_fwd::LOG2E;
using Team2 = flash_fwd::Team<2>;

// ---------------------------------------------------------------- projection

constexpr int BM = 128, BN = 256, BKD = 64, PSTAGES = 3;
constexpr int TILE_X = BM * 128, TILE_W = BN * 128;  // bytes of one stage's x and W tiles
constexpr int OUT_WG = 64 * BN * 2;                  // one consumer warpgroup's output rows
constexpr int MAX_NC = 4096;                         // the bias staged in shared memory
constexpr int PROJ_SMEM =
    PSTAGES * (TILE_X + TILE_W) + 2 * OUT_WG + MAX_NC * 4 + 2 * PSTAGES * 8 + 1024;

// bias: (NC,) fp32 or null, NC ≤ MAX_NC. out is written through the map
// `to` (64 × 64 boxes, rows past M clipped).
__global__ void __launch_bounds__(Team2::THREADS, 1)
qkv_proj_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                const __grid_constant__ CUtensorMap to, const float* __restrict__ bias, int M,
                int NC, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* xs = sm;                      // [PSTAGES][BM rows]
  unsigned char* ws = sm + PSTAGES * TILE_X;   // [PSTAGES][BN rows]
  unsigned char* os = ws + PSTAGES * TILE_W;   // [2 warpgroups][4 × 64 columns][64 rows]
  float* bs = reinterpret_cast<float*>(os + 2 * OUT_WG);  // [n_n · BN] the padded bias
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + MAX_NC);
  uint64_t* empty = full + PSTAGES;

  const int tid = threadIdx.x, lane = tid & 31;
  const int n_n = (NC + BN - 1) / BN, n_tiles = (M + BM - 1) / BM * n_n;
  const int n_k = (K + BKD - 1) / BKD;

  if (tid == 0) {
    for (int s = 0; s < PSTAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one lane of each consumer warp
    }
    mbar_fence_init();
  }
  // the epilogue reads the bias from here, zeros past NC: 32 global loads a
  // tile, which the compiler hoists, spilled 68 bytes and cost 8% of the
  // kernel on an H100
  for (int i = tid; i < n_n * BN; i += blockDim.x) bs[i] = bias != nullptr && i < NC ? bias[i] : 0.f;
  __syncthreads();

  if (tid >= Team2::CONSUMERS) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<Team2::PRODUCER_REGS>();
    if (tid == Team2::CONSUMERS) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = tile / n_n * BM, n0 = tile % n_n * BN;
        for (int kb = 0; kb < n_k; ++kb, ++it) {
          const int st = it % PSTAGES;
          mbar_wait(&empty[st], ((it / PSTAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[st], TILE_X + TILE_W);
          tma_load_2d(xs + st * TILE_X, &tx, &full[st], kb * BKD, m0);
          tma_load_2d(ws + st * TILE_W, &tw, &full[st], kb * BKD, n0);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    setmaxnreg_inc<Team2::CONSUMER_REGS>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
    const bool leader = (tid & 127) == 0;
    unsigned char* my_os = os + wg * OUT_WG;
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    };
    float d[128];
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = tile / n_n * BM, n0 = tile % n_n * BN;
      int prev = -1;
      for (int kb = 0; kb < n_k; ++kb, ++it) {
        const int st = it % PSTAGES;
        mbar_wait(&full[st], (it / PSTAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BKD / 16; ++ks)
          SS<BN, 0, 0>::run(d, desc_sw128(xs + st * TILE_X + wg * 64 * 128 + ks * 32),
                            desc_sw128(ws + st * TILE_W + ks * 32), kb > 0 || ks > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous k-step's products are done: free its stage
        fence_regs(d);
        if (prev >= 0) release(prev);
        prev = st;
      }
      wgmma_wait<0>();
      fence_regs(d);
      release(prev);

      // + bias, rounded once to bf16 into this warpgroup's output tiles
      // (swizzled as the map reads them: conflict-free), then one thread
      // stores them by TMA while the next tile's products run; its previous
      // store must have read the tiles first
      if (leader) bulk_wait<0, true>();
      named_barrier(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(bs + n0 + 8 * j + 2 * t);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = warp * 16 + g + 8 * hh;
          *reinterpret_cast<uint32_t*>(my_os + (j / 8) * (OUT_WG / 4) + row * 128 +
                                       (((j % 8) ^ (row & 7)) * 16) + 4 * t) =
              pack_bf16(d[4 * j + 2 * hh] + bb.x, d[4 * j + 2 * hh + 1] + bb.y);
        }
      }
      fence_async_smem();
      named_barrier(1 + wg, 128);
      if (leader) {
        for (int c = 0; c < BN / 64; ++c)
          tma_store_2d(&to, my_os + c * (OUT_WG / 4), n0 + 64 * c, m0 + 64 * wg);
        bulk_commit();
      }
    }
    if (leader) bulk_wait<0, false>();
  }
}

int launch_proj(const void* x, const void* wt, const void* bias, void* out, int M, int C,
                int NC, cudaStream_t stream) {
  CUtensorMap tx, tw, to;
  const long long xd[2] = {C, M}, wd[2] = {C, NC}, od[2] = {NC, M}, stride[1] = {C}, ostride[1] = {NC};
  const int xb[2] = {BKD, BM}, wb[2] = {BKD, BN}, ob[2] = {64, 64};
  if (!bf16_map(&tx, x, 2, xd, stride, xb) || !bf16_map(&tw, wt, 2, wd, stride, wb) ||
      !bf16_map(&to, out, 2, od, ostride, ob))
    return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  cudaError_t err = cudaFuncSetAttribute(qkv_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         PROJ_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (M + BM - 1) / BM * ((NC + BN - 1) / BN);
  qkv_proj_kernel<<<n_tiles < sms ? n_tiles : sms, Team2::THREADS, PROJ_SMEM, stream>>>(
      tx, tw, to, (const float*)bias, M, NC, C);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ rel-pos terms

constexpr int WG_WINDOWS = 4;  // windows per block: 4 × 16 positions = 64 rows
constexpr int TERMS_A = 64 * 128, TERMS_B = 16 * 128, TERMS_STAGES = 4;

template <int D>
constexpr int terms_smem() {
  return (D + 63) / 64 * (TERMS_B + TERMS_STAGES * TERMS_A) + (1 + TERMS_STAGES) * 8 + 1024;
}

// Block (2 · window group + table, i): table 0 writes Bh of the tokens in
// grid row i, table 1 Bw of the tokens in grid column i, for every head in
// turn: the table's line i is loaded once and the heads' q tiles stream
// through a 4-stage ring. The two tables of a window group are neighbouring
// blocks, so the second read of their q tokens comes from L2.
template <int D>
__global__ void __launch_bounds__(128)
relpos_terms_kernel(const __grid_constant__ CUtensorMap tq_row, const __grid_constant__ CUtensorMap tq_col,
                    const __grid_constant__ CUtensorMap trh, const __grid_constant__ CUtensorMap trw,
                    __nv_bfloat16* __restrict__ bh, __nv_bfloat16* __restrict__ bw, int NW, int N,
                    int H, int side) {
  constexpr int KB = (D + 63) / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* bs = sm;                   // [KB][16 rows]: the table's 16 (≥ side) rows
  unsigned char* as = sm + KB * TERMS_B;    // [TERMS_STAGES][KB][64 rows]: 16 positions × 4 windows
  uint64_t* b_bar = reinterpret_cast<uint64_t*>(as + TERMS_STAGES * KB * TERMS_A);
  uint64_t* a_bar = b_bar + 1;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int table = blockIdx.x & 1, i = blockIdx.y;
  const int w0 = (blockIdx.x >> 1) * WG_WINDOWS;
  const CUtensorMap* tq = table ? &tq_col : &tq_row;
  auto load_a = [&](int h) {
    const int st = h % TERMS_STAGES;
    mbar_arrive_expect_tx(&a_bar[st], KB * TERMS_A);
    for (int j = 0; j < KB; ++j)
      tma_load_5d(as + (st * KB + j) * TERMS_A, tq, &a_bar[st], j * 64, 0, i, h, w0);
  };
  if (tid == 0) {
    mbar_init(b_bar, 1);
    for (int s = 0; s < TERMS_STAGES; ++s) mbar_init(&a_bar[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(b_bar, KB * TERMS_B);
    for (int j = 0; j < KB; ++j) tma_load_3d(bs + j * TERMS_B, table ? &trw : &trh, b_bar, j * 64, 0, i);
    for (int h = 0; h < TERMS_STAGES && h < H; ++h) load_a(h);
  }
  mbar_wait(b_bar, 0);

  // warp w holds window w0 + w; its rows g and g + 8 are positions along the
  // grid row (or column); columns 8j + 2t + e are the table's rows
  const int win = w0 + warp;
  for (int h = 0; h < H; ++h) {
    const int st = h % TERMS_STAGES;
    mbar_wait(&a_bar[st], (h / TERMS_STAGES) & 1);
    float d[8];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      SS<16, 0, 0>::run(d, desc_sw128(as + (st * KB + ks / 4) * TERMS_A + (ks % 4) * 32),
                        desc_sw128(bs + (ks / 4) * TERMS_B + (ks % 4) * 32), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
    __syncthreads();  // every warp's products have read stage st
    if (tid == 0 && h + TERMS_STAGES < H) load_a(h + TERMS_STAGES);
    if (win >= NW) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int pos = g + 8 * hh;
      if (pos >= side) continue;
      const int tok = table ? pos * side + i : i * side + pos;
      __nv_bfloat16* dst = (table ? bw : bh) + (((long long)win * N + tok) * H + h) * flash_fwd::EXPAND_W;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t) =
            pack_bf16(d[4 * j + 2 * hh] * LOG2E, d[4 * j + 2 * hh + 1] * LOG2E);
    }
  }
}

template <int D>
int launch_terms(const void* qkv, const void* rh, const void* rw, void* bh, void* bw, int NW,
                 int N, int C, int H, int side, cudaStream_t stream) {
  CUtensorMap tq_row, tq_col, trh, trw;
  const long long s3 = 3LL * C;
  // q of head h as (D, position, line, H, NW): along a grid row, then rows;
  // or along a grid column, then columns
  const long long qd[5] = {D, side, side, H, NW};
  const long long row_major[4] = {s3, side * s3, D, N * s3}, col_major[4] = {side * s3, s3, D, N * s3};
  const int qb[5] = {64, 16, 1, 1, WG_WINDOWS};
  const long long rd[3] = {D, side, side}, rs[2] = {D, (long long)side * D};
  const int rb[3] = {64, 16, 1};
  if (!bf16_map(&tq_row, qkv, 5, qd, row_major, qb) || !bf16_map(&tq_col, qkv, 5, qd, col_major, qb) ||
      !bf16_map(&trh, rh, 3, rd, rs, rb) || !bf16_map(&trw, rw, 3, rd, rs, rb))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(relpos_terms_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         terms_smem<D>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(2 * ((NW + WG_WINDOWS - 1) / WG_WINDOWS), side);
  relpos_terms_kernel<D><<<grid, 128, terms_smem<D>(), stream>>>(tq_row, tq_col, trh, trw,
                                                                 (__nv_bfloat16*)bh, (__nv_bfloat16*)bw,
                                                                 NW, N, H, side);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- attention

template <int D>
int launch_attn(const void* qkv, const void* bh, const void* bw, void* o, int NW, int N, int C,
                int H, int side, float scale, cudaStream_t stream) {
  constexpr int BK = 128;
  const auto* base = (const __nv_bfloat16*)qkv;
  const long long s3 = 3LL * C;
  CUtensorMap tq, tk, tv;
  if (!bf16_map_4d(&tq, base, D, N, H, NW, s3, D, N * s3, Team2::BQ) ||
      !bf16_map_4d(&tk, base + C, D, N, H, NW, s3, D, N * s3, BK) ||
      !bf16_map_4d(&tv, base + 2 * C, D, N, H, NW, s3, D, N * s3, BK))
    return (int)cudaErrorInvalidValue;
  const flash_fwd::Params prm = {(__nv_bfloat16*)o, nullptr, (const __nv_bfloat16*)bh,
                                 (const __nv_bfloat16*)bw, N, H, side, side, scale * LOG2E};
  return flash_fwd::launch<(D + 63) / 64, D / 16, D, BK, flash_fwd::EXPAND, 2, false>(
      tq, tk, tv, prm, NW, stream);
}

template <int D>
int launch_all(const void* x, const void* wt, const void* bias, const void* rh, const void* rw,
               void* qkv, void* bh, void* bw, void* o, int NW, int N, int C, int H, int side,
               float scale, cudaStream_t s) {
  int err = launch_proj(x, wt, bias, qkv, NW * N, C, 3 * C, s);
  if (err == 0) err = launch_terms<D>(qkv, rh, rw, bh, bw, NW, N, C, H, side, s);
  if (err == 0) err = launch_attn<D>(qkv, bh, bw, o, NW, N, C, H, side, scale, s);
  return err;
}

}  // namespace

// The projection alone: out (M, NC) = x (M, C) · wtᵀ + bias, wt (NC, C); all
// contiguous bf16 but the (NC,) fp32 bias, which may be null. C and NC
// multiples of 8, NC ≤ 4096.
extern "C" int win_qkv_proj(const void* x, const void* wt, const void* bias, void* out, int M,
                            int C, int NC, void* stream) {
  if (M < 1 || C < 8 || C % 8 || NC < 2 || NC % 8 || NC > MAX_NC) return (int)cudaErrorInvalidValue;
  return launch_proj(x, wt, bias, out, M, C, NC, (cudaStream_t)stream);
}

// x: contiguous (NW, N, C) bf16 window tokens, N = side² ≤ 256; wt: the qkv
// weight as a contiguous (3C, C) bf16 matrix (torch Linear layout: rows are
// output columns [q | k | v], head-major within each); bias: (3C,) fp32 or
// null; rh/rw:
// contiguous (side, side, C/H) bf16 gathered tables; scratch:
// qkv (NW·N, 3C) bf16, bh/bw (NW, N, H, 16) bf16; o: a contiguous (NW, N, C)
// bf16 output. C a multiple of 32 and at most 1365, C/H = 64 or 80.
extern "C" int win_qkv_attn_fwd(const void* x, const void* wt, const void* bias, const void* rh,
                                const void* rw, void* qkv, void* bh, void* bw, void* o, int NW,
                                int N, int C, int H, int side, float scale, void* stream) {
  if (NW < 1 || side < 1 || side > 16 || side * side != N || C % 32 || 3 * C > MAX_NC || H < 1 ||
      C % H || !(scale > 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (C / H == 64) return launch_all<64>(x, wt, bias, rh, rw, qkv, bh, bw, o, NW, N, C, H, side, scale, s);
  if (C / H == 80) return launch_all<80>(x, wt, bias, rh, rw, qkv, bh, bw, o, NW, N, C, H, side, scale, s);
  return (int)cudaErrorInvalidValue;
}
