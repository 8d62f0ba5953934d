// Border flood (B3) and hole filling: every pass of one call in one launch,
// each image's state packed one bit a pixel and resident in the shared
// memory and registers of one thread-block cluster.
//
// Replaces (cellvit_tpu/ops/cc_pallas.py):
//   `_flood_kernel` :225   (pallas_call :250, `flood_pallas`; `fill_holes_pallas` :271)
//
// What it computes: reachability of `seed` through `open` under
// 4-connectivity after `n_outer` passes, each of four directional inclusive
// segmented OR-scans (axis 0 forward and reverse, axis 1 forward and
// reverse) with closed pixels reset to 0 after each. OR is idempotent and
// associative, so a forward scan, the re-mask and a reverse scan give every
// open pixel the OR of its whole run (`tests/test_torch_cc.py::
// test_run_broadcast_equals_scan_pair`): a pass is a run-OR broadcast down
// the columns, then one along the rows, bit for bit the Pallas schedule; the
// pass order and `n_outer` are kept. `fill_holes` takes the mask alone: open
// is its complement, the seed the open pixels of the image border, and the
// output mask | (open & ~reach), which is ~reach.
//
// Bound on the H100 at (8, 1024, 1024): one read of the int8 inputs and one
// write of the bool output, 24 MB for the flood (≈7.5 µs at 3.35 TB/s) and
// 16 MB for fill_holes; bound by bytes.
//
// Design. The state is 0/1, so it and the open mask are kept one bit a
// pixel in 32-bit words along the rows (bit i of word j of a row: column
// 32j + i): 128 KB each at 1024². A cluster of K blocks (`FLOOD_CLUSTER` in
// `ops/cc_cuda.py`: 8, faster than 2 or 4) holds one image, block
// k the band of rows [k·32·RC, (k + 1)·32·RC): warp w the RC rows w·RC …
// w·RC + RC − 1 of the band, lane l the words l and l + 32 (NWL ≤ 2) of each
// of them, in registers for the whole call. So device memory sees the inputs
// once and the output once, packed from and unpacked to bytes in registers;
// where W is a multiple of 16, each warp instruction moves 512 contiguous
// bytes of a row and the 16-pixel halves of the words travel by shuffles.
// - Columns (bit-parallel over 32 columns a word): each thread walks its
//   words down and up (g ← g | (o & g_prev)) for the run value leaving its
//   chunk at either end and whether the chunk is all open; a warp per word
//   column folds the 32 chunks by shuffle scans into each chunk's carries
//   from the band's top and bottom and the band's own summary, which it
//   stores into the shared memory of every block of the cluster
//   (`mapa`, `st.shared::cluster`). After a hardware cluster barrier
//   (release/acquire) each thread folds the bands above and below its
//   columns from its own shared memory into its carries and walks its chunk
//   with them. The summaries alternate between two buffers by pass, so one
//   cluster barrier a pass suffices.
// - Rows (warp-local): within a word a run is filled towards higher columns
//   by one addition, (o & ((o + g) ^ o)) | g; the word carries chain along
//   each 32-word stretch of the row by two ballots and the same fill on the
//   32 lane bits, and from one stretch to the next through lane 31. The
//   reverse direction is the same on bit-reversed words (`__brev`).
// Padding columns (past W in the last word) and rows past H are closed.
// Barriers: one block barrier and one cluster barrier a pass, and the
// arrival of a relaxed cluster barrier at the start, waited for before the
// first store into another block (every block has started by then). No block
// touches another's shared memory after the last pass's barrier, so none
// waits at exit. Nothing spins in software. The choices against their
// alternatives: `scripts/flood_bits_variants.py`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;  // chunks of a band: one a warp
constexpr int MAX_WORDS = 64;        // words a row: W ≤ 2048
constexpr int WP = MAX_WORDS + 1;    // padded line of the chunk summaries
constexpr int MAX_CLUSTER = 8;       // the portable cluster size
constexpr int MAX_STATE = 16;        // RC · NWL words a thread holds
constexpr uint32_t ALL = 0xffffffffu;

enum Mode { FLOOD = 0, FILL_HOLES = 1 };

struct Smem {
  // per chunk (warp) and word column: the run value leaving the chunk at its
  // bottom (t) and at its top (h) with no carries, and its all-open word (f);
  // once folded, t and f hold the carry and the all-open word from the band's
  // top down to the chunk, h and g the same from the band's bottom up
  uint32_t t[WARPS][WP], h[WARPS][WP], f[WARPS][WP], g[WARPS][WP];
  // every band's T, H and F a word column, by pass parity, written by the
  // band's own block
  uint32_t band[2][MAX_CLUSTER][3][MAX_WORDS];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

// All threads of all blocks of the cluster: the arrival releases this
// block's shared-memory writes (its stores to other blocks' included), the
// wait acquires the others'.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The halves of a barrier that orders nothing: every block of the cluster
// has started (its shared memory may be written) once the wait returns.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Store a word at this block's address `p` in block `rank`'s shared memory.
__device__ __forceinline__ void st_cluster(uint32_t* p, uint32_t rank, uint32_t v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(remote), "r"(v) : "memory");
}

// Bits of `o` reached from `g` (g ⊆ o) towards higher bit index through
// runs of `o`: the lowest seed of a run carries through the rest of it.
__device__ __forceinline__ uint32_t fill_up(uint32_t g, uint32_t o) {
  return (o & ((o + g) ^ o)) | g;
}

// 4 bytes → 4 bits (a nonzero byte is 1), byte i to bit i.
__device__ __forceinline__ uint32_t pack4(uint32_t y) {
  y = __vcmpne4(y, 0u) & 0x01010101u;
  return (y * 0x00204081u) >> 21 & 0xfu;
}

// 4 bits → 4 bytes of 0 or 1, bit i to byte i.
__device__ __forceinline__ uint32_t unpack4(uint32_t x) {
  return ((x & 0xfu) * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ uint32_t pack16(uint4 a) {
  return pack4(a.x) | pack4(a.y) << 4 | pack4(a.z) << 8 | pack4(a.w) << 12;
}

// Word 32q + lane of row `row` (pixels [32c, 32c + 32) ∩ [0, W) of it, c
// the word), for a whole warp. `vec` (W a multiple of 16, rows 16-byte
// aligned): each lane loads 16 bytes at 16·lane and 512 + 16·lane of the
// stretch, and the halves reach their words' lanes by shuffles; otherwise
// each lane loads its own word's bytes.
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ row, int q, uint32_t lane, int W,
                                              bool vec) {
  const int c = 32 * q + (int)lane;
  if (vec) {
    const int b0 = 1024 * q + 16 * (int)lane, b1 = b0 + 512;
    const uint32_t ha = b0 < W ? pack16(__ldg(reinterpret_cast<const uint4*>(row + b0))) : 0u;
    const uint32_t hb = b1 < W ? pack16(__ldg(reinterpret_cast<const uint4*>(row + b1))) : 0u;
    const uint32_t src = (2 * lane) & 31;
    const uint32_t la = __shfl_sync(ALL, ha, src), ua = __shfl_sync(ALL, ha, src + 1);
    const uint32_t lb = __shfl_sync(ALL, hb, src), ub = __shfl_sync(ALL, hb, src + 1);
    return lane < 16 ? la | ua << 16 : lb | ub << 16;
  }
  uint32_t w = 0;
  const int n = min(32, W - 32 * c);
  for (int i = 0; i < n; ++i) w |= (uint32_t)(__ldg(row + 32 * c + i) != 0) << i;
  return w;
}

// Store word 32q + lane of row `row` as bytes of 0 or 1, the same way.
__device__ __forceinline__ void store_word(uint8_t* __restrict__ row, int q, uint32_t lane, int W, bool vec,
                                           uint32_t w) {
  if (vec) {
    const int b0 = 1024 * q + 16 * (int)lane, b1 = b0 + 512;
    const uint32_t wa = __shfl_sync(ALL, w, lane >> 1) >> (16 * (lane & 1));
    const uint32_t wb = __shfl_sync(ALL, w, 16 + (lane >> 1)) >> (16 * (lane & 1));
    if (b0 < W)
      *reinterpret_cast<uint4*>(row + b0) = make_uint4(unpack4(wa), unpack4(wa >> 4), unpack4(wa >> 8),
                                                       unpack4(wa >> 12));
    if (b1 < W)
      *reinterpret_cast<uint4*>(row + b1) = make_uint4(unpack4(wb), unpack4(wb >> 4), unpack4(wb >> 8),
                                                       unpack4(wb >> 12));
    return;
  }
  const int c = 32 * q + (int)lane;
  const int n = min(32, W - 32 * c);
  for (int i = 0; i < n; ++i) row[32 * c + i] = (w >> i) & 1u;
}

// Run-OR broadcast along one row held by a warp: lane l holds words l + 32q
// (x the state, o the open bits) for q < NWL.
template <int NWL>
__device__ __forceinline__ void row_broadcast(uint32_t (&x)[NWL], const uint32_t (&o)[NWL], uint32_t lane) {
  // towards higher columns, one stretch of 32 words after the other: the
  // carry leaving each word with none entering, whether it is all open, and
  // the carry entering the stretch at lane 0 give each word's carry in
  uint32_t seg = 0;
#pragma unroll
  for (int q = 0; q < NWL; ++q) {
    const uint32_t tm = __ballot_sync(ALL, fill_up(x[q], o[q]) >> 31), fm = __ballot_sync(ALL, o[q] == ALL);
    const uint32_t out = fill_up(tm | (seg & fm & 1u), fm | tm);  // bit l: a carry leaves word l
    const uint32_t c = lane ? (out >> (lane - 1)) & 1u : seg;
    x[q] = fill_up(x[q] | (c & o[q] & 1u), o[q]);
    seg = out >> 31;
  }
  // towards lower columns: the same on bit-reversed words and lanes
  seg = 0;
#pragma unroll
  for (int q = NWL - 1; q >= 0; --q) {
    const uint32_t ob = __brev(o[q]), xb = __brev(x[q]);
    const uint32_t tm = __brev(__ballot_sync(ALL, fill_up(xb, ob) >> 31));
    const uint32_t fm = __brev(__ballot_sync(ALL, o[q] == ALL));
    const uint32_t out = fill_up(tm | (seg & fm & 1u), fm | tm);  // bit 31 − l: a carry leaves word l leftwards
    const uint32_t rl = 31 - lane;
    const uint32_t c = rl ? (out >> (rl - 1)) & 1u : seg;
    x[q] = __brev(fill_up(xb | (c & ob & 1u), ob));
    seg = out >> 31;
  }
}

// Cluster k of the grid holds image k; its block of rank r the band of RC
// rows a warp. `vec`: W a multiple of 16 and every pointer 16-byte aligned.
template <int RC, int NWL, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
flood_bits_kernel(const uint8_t* __restrict__ in0, const uint8_t* __restrict__ in1,
                  uint8_t* __restrict__ out, int H, int W, int n_outer, int vec) {
  static_assert(RC * NWL <= MAX_STATE, "state words a thread");
  __shared__ Smem s;
  const uint32_t lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t K = cluster_blocks(), rank = cluster_rank();
  const int b = blockIdx.x / K;
  const int WW = (W + 31) / 32;
  const int row0 = (int)(rank * WARPS + warp) * RC;  // this warp's first row
  const size_t image = (size_t)b * H * W;

  uint32_t x[RC][NWL], o[RC][NWL];
#pragma unroll
  for (int i = 0; i < RC; ++i) {
    const int r = row0 + i;  // the same for the whole warp
#pragma unroll
    for (int q = 0; q < NWL; ++q) {
      const int c = 32 * q + (int)lane;
      const uint8_t* row = in0 + image + (size_t)r * W;
      uint32_t m = 0;
      if (r < H) m = load_word(row, q, lane, W, vec);
      const int tail = W - 32 * c;  // columns of the image in this word
      const uint32_t valid = r >= H || tail <= 0 ? 0u : tail >= 32 ? ALL : (1u << tail) - 1u;
      if (MODE == FLOOD) {
        o[i][q] = r < H ? load_word(in1 + image + (size_t)r * W, q, lane, W, vec) & valid : 0u;
        x[i][q] = m & o[i][q];
      } else {
        o[i][q] = ~m & valid;
        uint32_t border = (r == 0 || r == H - 1) ? valid : 0u;
        if (c == 0) border |= 1u;
        if (c == WW - 1) border |= 1u << ((W - 1) & 31);
        x[i][q] = border & o[i][q];
      }
    }
  }

  if (n_outer > 0) cluster_arrive_relaxed();  // waited for before the first store to another block
  for (int it = 0; it < n_outer; ++it) {
    const int par = it & 1;
    // ---- columns. 1: each chunk's summary a word column
#pragma unroll
    for (int q = 0; q < NWL; ++q) {
      uint32_t t = 0, h = 0, f = ALL;
#pragma unroll
      for (int i = 0; i < RC; ++i) {
        t = x[i][q] | (o[i][q] & t);
        f &= o[i][q];
      }
#pragma unroll
      for (int i = RC - 1; i >= 0; --i) h = x[i][q] | (o[i][q] & h);
      const int c = 32 * q + lane;
      s.t[warp][c] = t;
      s.h[warp][c] = h;
      s.f[warp][c] = f;
    }
    __syncthreads();
    // 2: a warp per word column folds its 32 chunks (lane = chunk) by two
    // shuffle scans into each chunk's carries within the band, and stores
    // the band's summary into every block of the cluster
    if (it == 0) cluster_wait();  // every block has started
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int c = warp + 32 * k;
      if (c >= WW) break;
      uint32_t f = s.f[lane][c], t = s.t[lane][c], h = s.h[lane][c];
      uint32_t a = f, bl = f;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t ua = __shfl_up_sync(ALL, a, d), ut = __shfl_up_sync(ALL, t, d);
        const uint32_t db = __shfl_down_sync(ALL, bl, d), dh = __shfl_down_sync(ALL, h, d);
        if (lane >= (uint32_t)d) {
          t |= a & ut;
          a &= ua;
        }
        if (lane + d < 32) {
          h |= bl & dh;
          bl &= db;
        }
      }
      const uint32_t pt = __shfl_up_sync(ALL, t, 1), pa = __shfl_up_sync(ALL, a, 1);
      const uint32_t qh = __shfl_down_sync(ALL, h, 1), qb = __shfl_down_sync(ALL, bl, 1);
      s.t[lane][c] = lane ? pt : 0u;
      s.f[lane][c] = lane ? pa : ALL;
      s.h[lane][c] = lane < 31 ? qh : 0u;
      s.g[lane][c] = lane < 31 ? qb : ALL;
      const uint32_t bt = __shfl_sync(ALL, t, 31), bf = __shfl_sync(ALL, a, 31), bh = __shfl_sync(ALL, h, 0);
      if (lane < K) {
        st_cluster(&s.band[par][rank][0][c], lane, bt);
        st_cluster(&s.band[par][rank][1][c], lane, bh);
        st_cluster(&s.band[par][rank][2][c], lane, bf);
      }
    }
    cluster_barrier();
    // 3: each thread folds the bands above and below its columns into its
    // chunk's carries, then walks the chunk down and up with them
#pragma unroll
    for (int q = 0; q < NWL; ++q) {
      const int c = 32 * q + lane;
      uint32_t cin = 0, cout = 0;
      for (uint32_t j = 0; j < rank; ++j) cin = s.band[par][j][0][c] | (s.band[par][j][2][c] & cin);
      for (uint32_t j = K - 1; j > rank; --j) cout = s.band[par][j][1][c] | (s.band[par][j][2][c] & cout);
      uint32_t run = s.t[warp][c] | (s.f[warp][c] & cin);
#pragma unroll
      for (int i = 0; i < RC; ++i) run = x[i][q] = x[i][q] | (o[i][q] & run);
      run = s.h[warp][c] | (s.g[warp][c] & cout);
#pragma unroll
      for (int i = RC - 1; i >= 0; --i) run = x[i][q] = x[i][q] | (o[i][q] & run);
    }
    // ---- rows: each warp its own rows
#pragma unroll
    for (int i = 0; i < RC; ++i) row_broadcast<NWL>(x[i], o[i], lane);
  }

#pragma unroll
  for (int i = 0; i < RC; ++i) {
    const int r = row0 + i;
    if (r >= H) break;
#pragma unroll
    for (int q = 0; q < NWL; ++q) {
      if (!vec && 32 * q + (int)lane >= WW) continue;
      store_word(out + image + (size_t)r * W, q, lane, W, vec, MODE == FLOOD ? x[i][q] : ~x[i][q]);
    }
  }
  // no block touches another's shared memory after the last pass's barrier
}

template <int RC, int NWL, int MODE>
cudaError_t launch_rc(const uint8_t* in0, const uint8_t* in1, uint8_t* out, int B, int H, int W,
                      int n_outer, int K, int vec, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K * B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, flood_bits_kernel<RC, NWL, MODE>, in0, in1, out, H, W,
                                     n_outer, vec);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// RC, the rows a warp holds: the least power of two with 32 · RC · K ≥ H.
template <int NWL, int MODE>
cudaError_t launch_nwl(const uint8_t* in0, const uint8_t* in1, uint8_t* out, int B, int H, int W,
                       int n_outer, int K, int vec, cudaStream_t s) {
  int rc = 1;
  while (32 * rc * K < H) rc *= 2;
  switch (rc) {
    case 1: return launch_rc<1, NWL, MODE>(in0, in1, out, B, H, W, n_outer, K, vec, s);
    case 2: return launch_rc<2, NWL, MODE>(in0, in1, out, B, H, W, n_outer, K, vec, s);
    case 4: return launch_rc<4, NWL, MODE>(in0, in1, out, B, H, W, n_outer, K, vec, s);
    case 8: return launch_rc<8, NWL, MODE>(in0, in1, out, B, H, W, n_outer, K, vec, s);
  }
  if constexpr (NWL == 1) {
    if (rc == 16) return launch_rc<16, 1, MODE>(in0, in1, out, B, H, W, n_outer, K, vec, s);
  }
  return cudaErrorInvalidValue;
}

template <int MODE>
cudaError_t launch(const uint8_t* in0, const uint8_t* in1, uint8_t* out, int B, int H, int W,
                   int n_outer, int K, cudaStream_t s) {
  if (B <= 0 || H <= 0 || W <= 0) return cudaSuccess;
  if (W > 32 * MAX_WORDS || n_outer < 0 || K < 1 || K > MAX_CLUSTER || (K & (K - 1)))
    return cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec = W % 16 == 0 && aligned(in0) && aligned(in1) && aligned(out);
  if ((W + 31) / 32 <= 32) return launch_nwl<1, MODE>(in0, in1, out, B, H, W, n_outer, K, vec, s);
  return launch_nwl<2, MODE>(in0, in1, out, B, H, W, n_outer, K, vec, s);
}

}  // namespace

// (B, H, W) int8 seed and open mask → (B, H, W) bool reachability of the
// seed through open pixels after `n_outer` passes, on clusters of
// `cluster` blocks an image (1, 2, 4 or 8; 32 · RC · cluster ≥ H with
// RC · ⌈⌈W/32⌉/32⌉ ≤ 16). W ≤ 2048.
extern "C" int flood_bits(const void* seed, const void* open, void* out, int B, int H, int W, int n_outer,
                          int cluster, void* stream) {
  return (int)launch<FLOOD>((const uint8_t*)seed, (const uint8_t*)open, (uint8_t*)out, B, H, W, n_outer,
                            cluster, (cudaStream_t)stream);
}

// (B, H, W) int8 mask → (B, H, W) bool binary_fill_holes by the flood of the
// border background through the background (`fill_holes_pallas`).
extern "C" int fill_holes_bits(const void* mask, void* out, int B, int H, int W, int n_outer, int cluster,
                               void* stream) {
  return (int)launch<FILL_HOLES>((const uint8_t*)mask, nullptr, (uint8_t*)out, B, H, W, n_outer, cluster,
                                 (cudaStream_t)stream);
}
