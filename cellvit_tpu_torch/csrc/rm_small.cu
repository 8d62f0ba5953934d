// Small-object removal: the windowed same-label count (B10), and the radix
// size filter (B11) as one thread-block-cluster launch a call.
//
// Replaces (cellvit_tpu/ops/cc_pallas.py):
//   `_rm_small_kernel` :284    (pallas_call :328, `remove_small_objects_pallas`)
//   `_hist_kernel` :345        (pallas_call :431, `remove_small_objects_bincount_pallas`)
//   `_rm_mapback_kernel` :377  (pallas_call :446, the same op's second half)
//
// B10, the window filter: a pixel keeps its label iff the label is > 0 and
// its (2·min_size − 1)² window holds ≥ min_size pixels of that label; pixels
// off the image never match. Bound on the H100 at (8, 1024, 1024): one int32
// read and one int32 write a pixel, 64 MB (≈20 µs at 3.35 TB/s). What costs
// is the count, up to (2r + 1)² shared-memory compares a labelled pixel
// (r = min_size − 1), and how well the SM hides their latency. A persistent
// grid (as many blocks as the SMs hold: eight an SM at min_size 10, 64
// warps) walks over output tiles of up to 32 × 64 pixels. Each tile arrives
// with its halo — r rows above and below, R = r rounded up to a multiple of
// 4 columns on each side — as one TMA box: (32 + 18) × (64 + 24) int32 at
// min_size 10. The other blocks of the SM count while one block's box loads
// (one slot a block measured faster than a ring of two at fewer blocks an
// SM, and small tiles at many blocks faster than large ones,
// `scripts/rm_small_variants.py`).
//   - A TMA box's innermost start must be a multiple of 16 bytes (an
//     unaligned start faults, `scripts/tma_probe.py`), hence the column
//     halo R: the tile's x0 and R are multiples of 4 int32.
//   - TMA fills the box's elements off the image with 0. Only labels > 0
//     are counted, so a 0 never matches and the fill is as exact as the
//     Pallas kernel's −1 sentinel.
//   - Widths that are no multiple of 4, or unaligned tensors, cannot be a
//     TMA map; the same kernel then stages each box with element loads
//     (0 off the image).
// Pass 1 writes every pixel of the tile, four a thread (16-byte loads from
// the box and stores to the output), labelled ones with their label for now,
// and lists the labelled pixels in shared memory. Pass 2 gives each listed
// pixel a thread, so a warp's 32 lanes all count (the background, most of a
// tile, takes no lane), and counts its window centre-out — its own row, then
// rows −1, +1, −2, +2, … — stopping as soon as the count reaches min_size:
// a pixel inside a nucleus wider than min_size stops after its own row of
// 2r + 1 compares. A pixel whose count ends below min_size is written 0.
// Consecutive list entries are mostly neighbours in a row, so a warp's
// shared-memory reads are mostly conflict-free.
//
// B11, the radix size filter: hist[b, hi, lo] counts the pixels whose id v
// falls in bin (hi, lo), hi = clip(v ÷ lo_bins, 0, hi_bins − 1) and
// lo = clip(v − hi·lo_bins, 0, lo_bins − 1), which is the flat bin
// clamp(v, 0, nb − 1) with nb = hi_bins·lo_bins (for 0 < v < nb the pair is
// v's own digits; v ≤ 0 gives (0, 0) and v ≥ nb (hi_bins − 1, lo_bins − 1)).
// A pixel keeps v iff v > 0 and (its bin holds ≥ min_size pixels or v ≥ nb).
// The Pallas kernels count with one-hot matmuls on the TPU's matrix unit, in
// two calls split by the per-image barrier between the count and the lookup.
// Here one launch runs a cluster of RX_CLUSTER blocks an image, in three
// phases:
//   1. each block counts its share of the image (16-byte loads) into its
//      own shared-memory table of nb int32 with shared atomics, one atomic
//      a run of equal bins among 4 neighbouring pixels, the background in a
//      register;
//   2. after a hardware cluster barrier, each block sums its slice of S bins
//      (S a power of two) across the cluster's tables through distributed
//      shared memory, writes that slice of `hist` as fp32 when asked, and
//      turns it into bits, small = count < min_size; it stores the slice's
//      words into every block's table at the slice's own start, a region of
//      that table which only this block reads, and has read;
//   3. after a second cluster barrier every block holds the whole bit table
//      and maps its share of pixels (16-byte loads and stores; the share is
//      in L2 from phase 1).
// No memset, no global atomics, no grid barrier: clusters are co-scheduled
// by the hardware, so any batch runs. Every count is an integer below 2²⁴,
// so the fp32 counts are exact and equal the matmul's. The same kernel has
// two more entries: the histogram alone (phases 1-2), and the lookup from a
// given histogram (phases 2-3, each block reading its slice of `hist`).
// Bound: one int32 read and one int32 write a pixel, 64 MB (≈20 µs); the
// histogram alone one read, 32 MB (≈10 µs).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

// ------------------------------------------------------------------ B10

constexpr int WIN_THREADS = 256;
constexpr int WIN_TH = 32, WIN_TW = 64;  // the largest output tile (rows, columns)
constexpr int WIN_SLOTS = 1;             // tiles in flight a block
constexpr int WIN_PER_SM = 8;            // blocks an SM
constexpr int BOX_MAX = 256;             // elements along each dimension of a TMA box
constexpr int SMEM_MAX = 232448;         // shared memory a block can use (H100)
constexpr int SMEM_SM = 233472;          // an SM's, 1 KB of it reserved for each block
constexpr int MAX_DEVICES = 64;

// A tile's geometry at one min_size: halo rows r and columns R (r rounded
// up to a multiple of 4), the output tile TH × TW, the box BH × BW it loads,
// the slots of the ring and their size.
struct WinGeom {
  int r, R, TH, TW, BH, BW, slots, slot_words, tiles_x, tiles_y, n_tiles;
  size_t smem;
};

// The largest tile (columns first) whose box is a legal TMA box and whose
// slots and pixel list fit: WIN_SLOTS slots at WIN_PER_SM blocks an SM, else
// one slot in a whole SM.
bool win_geom(int B, int H, int W, int min_size, WinGeom* g) {
  g->r = min_size - 1;
  g->R = (g->r + 3) & ~3;
  g->TW = WIN_TW;
  while (g->TW > 32 && g->TW + 2 * g->R > BOX_MAX) g->TW /= 2;
  g->BW = g->TW + 2 * g->R;
  if (g->BW > BOX_MAX) return false;
  const int slot_tries[2] = {WIN_SLOTS, 1};
  const size_t budgets[2] = {SMEM_SM / WIN_PER_SM - 1024, SMEM_MAX};
  for (int attempt = 0; attempt < 2; ++attempt) {
    const int slots = slot_tries[attempt];
    const size_t budget = budgets[attempt];
    for (int th = WIN_TH; th >= 8; th /= 2) {
      const int bh = th + 2 * g->r;
      const int words = (bh * g->BW + 31) & ~31;  // 128-byte aligned slots
      const size_t smem = 128 + (size_t)slots * words * sizeof(int32_t) + (size_t)th * g->TW * sizeof(uint16_t);
      if (bh > BOX_MAX || smem > budget) continue;
      g->TH = th;
      g->BH = bh;
      g->slots = slots;
      g->slot_words = words;
      g->smem = smem;
      g->tiles_x = (W + g->TW - 1) / g->TW;
      g->tiles_y = (H + th - 1) / th;
      g->n_tiles = B * g->tiles_x * g->tiles_y;
      return true;
    }
  }
  return false;
}

__device__ __forceinline__ int row_matches(const int32_t* p, int32_t v, int n) {
  int c = 0;
  for (int i = 0; i < n; ++i) c += p[i] == v;
  return c;
}

template <bool kTma>
__global__ void __launch_bounds__(WIN_THREADS, WIN_PER_SM)
rm_window_kernel(const __grid_constant__ CUtensorMap map, const int32_t* __restrict__ lab,
                 int32_t* __restrict__ out, int H, int W, int min_size, const WinGeom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);          // one mbarrier a slot
  int* listed = reinterpret_cast<int*>(smem + 64);             // pixels listed, two tiles' counters
  int32_t* ring = reinterpret_cast<int32_t*>(smem + 128);
  uint16_t* list = reinterpret_cast<uint16_t*>(ring + g.slots * g.slot_words);  // the tile's labelled pixels
  const int tid = threadIdx.x, lane = tid % 32;
  const int per_image = g.tiles_x * g.tiles_y;
  // tile t → image b and the tile's first output row and column
  const auto origin = [&](int t, int& b, int& y0, int& x0) {
    b = t / per_image;
    const int i = t - b * per_image;
    y0 = i / g.tiles_x * g.TH;
    x0 = i % g.tiles_x * g.TW;
  };
  const auto load_box = [&](int slot, int t) {  // one thread: tile t's box into the slot
    int b, y0, x0;
    origin(t, b, y0, x0);
    sm90::mbar_arrive_expect_tx(&full[slot], (uint32_t)(g.BH * g.BW * sizeof(int32_t)));
    sm90::tma_load_3d(ring + slot * g.slot_words, &map, &full[slot], x0 - g.R, y0 - g.r, b);
  };
  if (tid == 0) {
    listed[0] = listed[1] = 0;
    if (kTma) {
      for (int s = 0; s < g.slots; ++s) sm90::mbar_init(&full[s], 1);
      sm90::mbar_fence_init();
      for (int s = 0; s < g.slots && blockIdx.x + s * gridDim.x < g.n_tiles; ++s)
        load_box(s, blockIdx.x + s * gridDim.x);
    }
  }
  __syncthreads();
  const int n = 2 * g.r + 1, tile_px = g.TH * g.TW, tw_log = __ffs(g.TW) - 1;
  int k = 0;
  for (int t = blockIdx.x; t < g.n_tiles; t += gridDim.x, ++k) {
    const int slot = kTma ? k % g.slots : 0;
    const int32_t* T = ring + slot * g.slot_words;
    int b, y0, x0;
    origin(t, b, y0, x0);
    int32_t* dst = out + (size_t)b * H * W;
    if (kTma) {
      sm90::mbar_wait(&full[slot], (k / g.slots) & 1);
    } else {
      const int32_t* src = lab + (size_t)b * H * W;
      int32_t* S = ring;
      for (int row = tid / 32; row < g.BH; row += WIN_THREADS / 32) {
        const int y = y0 - g.r + row;
        const bool in = y >= 0 && y < H;
        for (int col = lane; col < g.BW; col += 32) {
          const int x = x0 - g.R + col;
          S[row * g.BW + col] = in && x >= 0 && x < W ? src[(size_t)y * W + x] : 0;
        }
      }
      __syncthreads();
    }
    // pass 1, four pixels a thread: every pixel written, a labelled one with
    // its label for now, and listed (a warp's pixels in order)
    int* count = &listed[k & 1];
    for (int q0 = 0; q0 < tile_px; q0 += 4 * WIN_THREADS) {
      const int i = q0 + 4 * tid, ty = i >> tw_log, cx = i & (g.TW - 1), y = y0 + ty, x = x0 + cx;
      const bool row_in = i < tile_px && y < H;
      int4 q = make_int4(0, 0, 0, 0);
      if (row_in) q = *reinterpret_cast<const int4*>(T + (ty + g.r) * g.BW + cx + g.R);
      const int32_t e[4] = {max(q.x, 0), max(q.y, 0), max(q.z, 0), max(q.w, 0)};
      int mine = 0;  // the bits of this thread's labelled pixels
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (row_in && x + j < W && e[j] > 0) mine |= 1 << j;
      if (kTma) {  // W is a multiple of 4: the four pixels are in or out together
        if (row_in && x < W) *reinterpret_cast<int4*>(dst + (size_t)y * W + x) = make_int4(e[0], e[1], e[2], e[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (row_in && x + j < W) dst[(size_t)y * W + x + j] = e[j];
      }
      const int n_mine = __popc(mine);
      int upto = n_mine;  // inclusive scan of the warp's counts
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, upto, o);
        if (lane >= o) upto += u;
      }
      int base = 0;
      if (lane == 31 && upto) base = atomicAdd(count, upto);
      base = __shfl_sync(0xffffffffu, base, 31) + upto - n_mine;
      for (; mine; mine &= mine - 1) list[base++] = (uint16_t)(i + __ffs(mine) - 1);
    }
    __syncthreads();
    const int n_list = *count;
    if (tid == 0) listed[(k + 1) & 1] = 0;  // the next tile's counter: no thread uses it before the barrier below
    // pass 2: each listed pixel's window counted centre-out — the centre row,
    // then rows −1, +1, −2, +2, … — until it holds min_size pixels of v
    for (int j = tid; j < n_list; j += WIN_THREADS) {
      const int i = list[j], ty = i >> tw_log, cx = i & (g.TW - 1);
      const int32_t* c = T + (ty + g.r) * g.BW + cx + g.R - g.r;  // the window's centre row
      const int32_t v = c[g.r];
      int cnt = row_matches(c, v, n);
      for (int d = 1; d <= g.r && cnt < min_size; ++d) {
        cnt += row_matches(c - d * g.BW, v, n);
        if (cnt >= min_size) break;
        cnt += row_matches(c + d * g.BW, v, n);
      }
      if (cnt < min_size) dst[(size_t)(y0 + ty) * W + x0 + cx] = 0;
    }
    __syncthreads();  // every thread is done with the slot and the list
    if (kTma && tid == 0 && t + g.slots * gridDim.x < g.n_tiles) load_box(slot, t + g.slots * gridDim.x);
  }
}

// A 3-D (W, H, B) int32 map cut into BW × BH × 1 boxes; reads off the
// tensor fill 0. False if refused.
bool int32_map(CUtensorMap* map, const void* base, int W, int H, int B, int BW, int BH) {
  sm90::EncodeTiledFn encode = sm90::encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)W * H * 4};
  const cuuint32_t box[3] = {(cuuint32_t)BW, (cuuint32_t)BH, 1}, unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 3, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <bool kTma>
cudaError_t window_launch(const CUtensorMap& map, const int32_t* lab, int32_t* out, int H, int W,
                          int min_size, const WinGeom& g, cudaStream_t stream) {
  const auto kernel = rm_window_kernel<kTma>;
  // the shared-memory attribute and the blocks an SM, set and asked once a
  // device and size (each takes the host microseconds)
  static size_t smem_set[MAX_DEVICES] = {};
  static int per_sm_of[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (g.smem != smem_set[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm_of[dev], kernel, WIN_THREADS, g.smem);
    if (e != cudaSuccess) return e;
    smem_set[dev] = g.smem;
  }
  const int per_sm = per_sm_of[dev], sms = sm90::sm_count();
  if (per_sm < 1 || sms < 1) return cudaErrorInvalidConfiguration;
  // as many blocks as the SMs hold, fewer where that evens the tiles a block
  const int waves = (g.n_tiles + per_sm * sms - 1) / (per_sm * sms);
  const int grid = (g.n_tiles + waves - 1) / waves;
  kernel<<<grid, WIN_THREADS, g.smem, stream>>>(map, lab, out, H, W, min_size, g);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ B11

constexpr int RX_THREADS = 1024;
constexpr int RX_CLUSTER = 8;    // blocks an image: the portable maximum
constexpr int RX_UNROLL = 4;     // 16-byte loads in flight a thread
constexpr int RX_MAX_WORDS = 256;  // a slice's bit words: S ≤ 8192 bins
enum { RX_FILTER = 0, RX_HIST = 1, RX_KEEP = 2 };

__device__ __forceinline__ int radix_bin(int32_t v, int nb) { return min(max(v, 0), nb - 1); }

__device__ __forceinline__ void add_run(uint32_t* table, int bin, int n, int& zeros) {
  if (bin == 0) zeros += n;
  else atomicAdd(&table[bin], (uint32_t)n);
}

// Count 4 neighbouring pixels, one atomic a run of equal bins.
__device__ __forceinline__ void count4(uint32_t* table, int4 q, int nb, int& zeros) {
  const int b[4] = {radix_bin(q.x, nb), radix_bin(q.y, nb), radix_bin(q.z, nb), radix_bin(q.w, nb)};
  int cur = b[0], run = 1;
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    if (b[i] == cur) {
      ++run;
    } else {
      add_run(table, cur, run, zeros);
      cur = b[i];
      run = 1;
    }
  }
  add_run(table, cur, run, zeros);
}

// v kept by the bit table (bin b's bit in the word at (b & ~(S − 1)) +
// ((b & (S − 1)) >> 5), the words of slice b / S stored at its start)
__device__ __forceinline__ int32_t keep(const uint32_t* table, int32_t v, int nb, int S) {
  if (v <= 0) return 0;
  if (v >= nb) return v;
  const uint32_t w = table[(v & ~(S - 1)) + ((v & (S - 1)) >> 5)];
  return (w >> (v & 31)) & 1u ? 0 : v;
}

template <int MODE, bool kVec>
__global__ void __launch_bounds__(RX_THREADS, 1)
radix_filter_kernel(const int32_t* __restrict__ lab, float* __restrict__ hist, int32_t* __restrict__ out,
                    int HW, int nb, int S, int min_size) {
  extern __shared__ __align__(16) uint32_t table[];  // nb words: counts, then the bit table
  __shared__ uint32_t words[RX_MAX_WORDS];           // this block's slice of bits
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.x / K, tid = threadIdx.x;
  // the block's share of the image, in 4-pixel groups when kVec
  const int units = kVec ? HW / 4 : HW;
  const int u0 = (int)((long long)units * rank / K), u1 = (int)((long long)units * (rank + 1) / K);
  const int32_t* img = lab + (size_t)b * HW;

  if (MODE != RX_KEEP) {
    for (int i = tid; i < nb; i += RX_THREADS) table[i] = 0;
    __syncthreads();
    int zeros = 0;
    if (kVec) {
      const int4* src = reinterpret_cast<const int4*>(img);
      for (int i = u0 + tid; i < u1; i += RX_UNROLL * RX_THREADS) {
        int4 q[RX_UNROLL];
#pragma unroll
        for (int u = 0; u < RX_UNROLL; ++u)
          if (i + u * RX_THREADS < u1) q[u] = __ldg(src + i + u * RX_THREADS);
#pragma unroll
        for (int u = 0; u < RX_UNROLL; ++u)
          if (i + u * RX_THREADS < u1) count4(table, q[u], nb, zeros);
      }
    } else {
      for (int i = u0 + tid; i < u1; i += RX_THREADS) add_run(table, radix_bin(img[i], nb), 1, zeros);
    }
    zeros = (int)__reduce_add_sync(0xffffffffu, (unsigned)zeros);
    if ((tid & 31) == 0 && zeros) atomicAdd(&table[0], (uint32_t)zeros);
  }
  cluster.sync();  // barrier 1: every block's counts are complete, every block has started

  const int s0 = rank * S;  // this block's slice of bins, [s0, s0 + S)
  for (int i = tid; i < S; i += RX_THREADS) {
    const int bin = s0 + i;
    bool small = false;
    if (bin < nb) {
      float count;
      if (MODE == RX_KEEP) {
        count = hist[(size_t)b * nb + bin];
      } else {
        uint32_t total = 0;
        for (int p = 0; p < K; ++p) total += cluster.map_shared_rank(table, p)[bin];
        count = (float)total;
        if (hist != nullptr) hist[(size_t)b * nb + bin] = count;
      }
      small = count < (float)min_size;
    }
    if (MODE != RX_HIST) {
      const uint32_t w = __ballot_sync(0xffffffffu, small);
      if ((tid & 31) == 0) words[i >> 5] = w;
    }
  }
  if (MODE != RX_HIST) {
    __syncthreads();  // the slice's words are complete and its counts read in every table
    const int nw = s0 < nb ? (min(S, nb - s0) + 31) / 32 : 0;
    for (int j = tid; j < nw * K; j += RX_THREADS) {
      const int p = j / nw, w = j - p * nw;
      cluster.map_shared_rank(table, p)[s0 + w] = words[w];
    }
  }
  cluster.sync();  // barrier 2: the whole bit table is in every block; no block reads another's after it
  if (MODE == RX_HIST) return;

  int32_t* dst = out + (size_t)b * HW;
  if (kVec) {
    const int4* src = reinterpret_cast<const int4*>(img);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int i = u0 + tid; i < u1; i += RX_UNROLL * RX_THREADS) {
      int4 q[RX_UNROLL];
#pragma unroll
      for (int u = 0; u < RX_UNROLL; ++u)
        if (i + u * RX_THREADS < u1) q[u] = __ldg(src + i + u * RX_THREADS);
#pragma unroll
      for (int u = 0; u < RX_UNROLL; ++u)
        if (i + u * RX_THREADS < u1)
          d4[i + u * RX_THREADS] = make_int4(keep(table, q[u].x, nb, S), keep(table, q[u].y, nb, S),
                                             keep(table, q[u].z, nb, S), keep(table, q[u].w, nb, S));
    }
  } else {
    for (int i = u0 + tid; i < u1; i += RX_THREADS) dst[i] = keep(table, img[i], nb, S);
  }
}

template <int MODE, bool kVec>
cudaError_t radix_launch(const int32_t* lab, float* hist, int32_t* out, int B, int HW, int nb, int min_size,
                         cudaStream_t stream) {
  const auto kernel = radix_filter_kernel<MODE, kVec>;
  const size_t smem = (size_t)nb * sizeof(uint32_t);
  static size_t smem_set[MAX_DEVICES] = {};  // the attributes, set once a device and size
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem != smem_set[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess && RX_CLUSTER > 8)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    smem_set[dev] = smem;
  }
  int S = 32;  // the slice: the least power of two ≥ 32 with RX_CLUSTER slices covering nb
  while (S * RX_CLUSTER < nb) S *= 2;
  if (S > 32 * RX_MAX_WORDS) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(RX_CLUSTER * B);
  cfg.blockDim = dim3(RX_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = RX_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, lab, hist, out, HW, nb, S, min_size);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int MODE>
int radix(const void* lab, void* hist, void* out, int B, int HW, int hi_bins, int lo_bins, int min_size,
          void* stream) {
  if (B <= 0 || HW <= 0) return (int)cudaSuccess;
  if (hi_bins < 1 || lo_bins < 1 || (long long)hi_bins * lo_bins > SMEM_MAX / 4 - RX_MAX_WORDS)
    return (int)cudaErrorInvalidValue;
  const bool vec = HW % 4 == 0 && aligned16(lab) && aligned16(out);
  const int nb = hi_bins * lo_bins;
  const auto l = (const int32_t*)lab;
  const auto h = (float*)hist;
  const auto o = (int32_t*)out;
  const auto s = (cudaStream_t)stream;
  return (int)(vec ? radix_launch<MODE, true>(l, h, o, B, HW, nb, min_size, s)
                   : radix_launch<MODE, false>(l, h, o, B, HW, nb, min_size, s));
}

}  // namespace

// (B, H, W) int32 labels → labels of components with ≥ min_size pixels
// (2 ≤ min_size ≤ 105), others 0.
extern "C" int remove_small_objects(const void* lab, void* out, int B, int H, int W, int min_size,
                                    void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  WinGeom g;
  if (min_size < 2 || !win_geom(B, H, W, min_size, &g)) return (int)cudaErrorInvalidValue;
  CUtensorMap map = {};
  const auto l = (const int32_t*)lab;
  const auto o = (int32_t*)out;
  const auto s = (cudaStream_t)stream;
  if (W % 4 == 0 && aligned16(lab) && aligned16(out)) {
    if (!int32_map(&map, lab, W, H, B, g.BW, g.BH)) return (int)cudaErrorInvalidValue;
    return (int)window_launch<true>(map, l, o, H, W, min_size, g, s);
  }
  g.slots = 1;  // element-staged boxes: one slot
  g.smem = 128 + (size_t)g.slot_words * sizeof(int32_t) + (size_t)g.TH * g.TW * sizeof(uint16_t);
  return (int)window_launch<false>(map, l, o, H, W, min_size, g, s);
}

// (B, H·W) int32 ids → ids kept where > 0 and (their radix bin of
// hi_bins × lo_bins holds ≥ min_size pixels, or id ≥ hi_bins·lo_bins), else
// 0: the histogram and the lookup in one launch.
extern "C" int radix_filter(const void* lab, void* out, int B, int HW, int hi_bins, int lo_bins, int min_size,
                            void* stream) {
  return radix<RX_FILTER>(lab, nullptr, out, B, HW, hi_bins, lo_bins, min_size, stream);
}

// (B, H·W) int32 ids → (B, hi_bins, lo_bins) fp32 counts per radix bin.
extern "C" int radix_hist(const void* lab, void* hist, int B, int HW, int hi_bins, int lo_bins, void* stream) {
  return radix<RX_HIST>(lab, hist, nullptr, B, HW, hi_bins, lo_bins, 0, stream);
}

// (B, H·W) int32 ids and their (B, hi_bins, lo_bins) fp32 counts → ids kept
// where > 0 and (count ≥ min_size or id ≥ hi_bins·lo_bins), else 0.
extern "C" int rm_mapback(const void* lab, const void* hist, void* out, int B, int HW, int hi_bins,
                          int lo_bins, int min_size, void* stream) {
  return radix<RX_KEEP>(lab, const_cast<void*>(hist), out, B, HW, hi_bins, lo_bins, min_size, stream);
}
