// Connected-component root labels (B2) and label compaction by
// min-propagation (B4): every pass of one call in one launch, with each
// image's state resident in shared memory.
//
// Replaces (cellvit_tpu/ops/cc_pallas.py):
//   `_cc_kernel` :75       (pallas_call :101, `connected_components_pallas`)
//   `_propmin_kernel` :118 (pallas_call :148, `propagate_min_pallas`)
//
// What they compute: `n_outer` passes, each of four directional inclusive
// segmented min-scans (axis 0 forward, axis 0 reverse, axis 1 forward, axis 1
// reverse), with closed pixels set to INT_MAX after each. Min is idempotent
// and associative, so a forward scan, the re-mask and a reverse scan give
// every open pixel the minimum of its whole run along the axis (a run is a
// maximal stretch of open pixels): a pass is one run-min broadcast along the
// columns, then one along the rows, bit for bit the four-scan schedule. The
// pass order and `n_outer` are kept, so the result is the fixed-pass one, not
// a converged labelling.
//
// Bound on the H100 at (8, 1024, 1024): one read of the inputs and one write
// of the int32 output. B2 reads 1 byte and writes 4 a pixel (40 MB, 12.5 µs
// at 3.35 TB/s), B4 reads 5 and writes 4 (72 MB, 22.5 µs); bound by bytes.
//
// Design. A block owns one TR × TC tile of one image and keeps its int32
// state (rows padded to an odd stride, so that walks along rows and along
// columns are both free of bank conflicts) and its mask, as 32-bit words along
// rows and along columns, in shared memory for the whole call. It loads the
// tile once (B2's raster index or B4's seed where open, INT_MAX where closed)
// and stores it once (B2's +1 / 0 fused into the store): device memory sees
// the bound's bytes and a few hundred KB of edge summaries. In a phase (one
// axis) each thread takes a chunk of 32 pixels of one line into registers: a
// forward and a reverse walk give each pixel its run minimum within the
// chunk, stored back, and three values summarise the chunk: the minimum of
// the run at its first pixel, of the run at its last pixel, and whether all
// 32 are open. A run that leaves a chunk is resolved by folding these
// summaries along the line, within the tile through shared memory and across
// the tiles of the image through a workspace in device memory (one entry per
// line and tile), after one barrier among the tiles of the image; only each
// chunk's first and last runs are touched again. The tiles of an image (32
// at 1024²) must be resident together: the grid is persistent, as many
// groups of one image's tiles as the card holds at one block an SM, launched
// cooperatively (the runtime refuses a grid that cannot be co-resident), and
// each group walks its share of the batch in waves of whole images. The
// barrier is a counter per group, which the group leaves at 0 when it ends;
// a wait traps after 2^25 polls instead of hanging the card. Variants and
// their times: `scripts/seg_min_variants.py`.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int TR = 128;            // tile rows
constexpr int TC = 256;            // tile columns
constexpr int STRIDE = TC + 1;     // padded row of the resident state
constexpr int CH = 32;             // pixels of a line in one chunk: one mask word
constexpr int THREADS = 1024;
constexpr int CPT = TR * TC / CH / THREADS;  // chunks a thread holds in a phase
constexpr int MAX_TY = 12;         // tiles down a column (H ≤ 1536)
constexpr int MAX_TX = 8;          // tiles along a row (W ≤ 2048)
constexpr int MAX_GROUPS = 512;    // the wrapper's sync words: two a group
constexpr unsigned POLL_LIMIT = 1u << 25;
constexpr uint32_t ALL_OPEN = 0xffffffffu;
static_assert(TR % CH == 0 && TC % CH == 0 && THREADS % TC == 0 && CPT >= 1, "tile shape");

struct Smem {
  int32_t v[TR * STRIDE];              // the state
  uint32_t rowbits[TC / CH][TR];       // bit i of [j][r]: pixel (r, 32j + i) is open
  uint32_t colbits[TR / CH][TC];       // bit i of [k][c]: pixel (32k + i, c) is open
  int32_t head[TR * TC / CH];          // per chunk: min of the run at its first pixel,
  int32_t tail[TR * TC / CH];          //   at its last (INT_MAX where that pixel is closed),
  uint8_t full[TR * TC / CH];          //   and whether all of it is open
  int32_t cin[TC], cout[TC];           // per line: the minimum carried in from before and after the tile
  int4 stage[MAX_TY * TC > MAX_TX * TR ? MAX_TY * TC : MAX_TX * TR];  // other tiles' summaries
};

// The minimum that leaves a span of a line at its far end, given the one that
// entered it: a run crosses the span only if all of it is open.
__device__ __forceinline__ int32_t carry_fwd(int32_t c, int32_t tail, bool full) {
  return min(full ? c : INT_MAX, tail);
}
__device__ __forceinline__ int32_t carry_bwd(int32_t c, int32_t head, bool full) {
  return min(full ? c : INT_MAX, head);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Barrier among the T blocks of one group: the counter is 0 when a call
// starts and rises by T a barrier, so each arrival waits for the next
// multiple of T. The arrival releases the block's writes (ordered before it
// by the block barrier) and the polls acquire the other blocks'.
__device__ void group_barrier(unsigned* arrive, unsigned T) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned old;
    asm volatile("atom.add.release.gpu.global.u32 %0, [%1], 1;" : "=r"(old) : "l"(arrive) : "memory");
    const unsigned target = old - old % T + T;
    for (unsigned n = 0; (int)(ld_acquire(arrive) - target) < 0;)
      if (++n == POLL_LIMIT) __trap();
  }
  __syncthreads();
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

// Load the tile at (y0, x0) of image b: the state (B2: raster index, B4: seed
// where open; INT_MAX where closed or outside the image) and the mask words.
// Warp w takes 32 × 32 blocks; lane l holds column l of a block. B4's seeds
// go straight to shared memory (cp.async), so that only the mask bytes of
// the 32 rows in flight take registers.
template <bool kSeed>
__device__ void load_tile(Smem& s, const int8_t* __restrict__ fg, const int32_t* __restrict__ seed,
                          int b, int H, int W, int y0, int x0) {
  const int lane = threadIdx.x & 31;
  for (int blk = threadIdx.x >> 5; blk < (TR / CH) * (TC / CH); blk += THREADS / 32) {
    const int kb = blk / (TC / CH), jb = blk % (TC / CH), col = jb * CH + lane, x = x0 + col;
    const size_t row0 = ((size_t)b * H + y0 + kb * CH) * W + x;  // pixel (y0 + 32 kb, x)
    int8_t f[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const bool in = y0 + kb * CH + i < H && x < W;
      if (kSeed && in) cp_async4(&s.v[(kb * CH + i) * STRIDE + col], seed + row0 + (size_t)i * W);
      f[i] = in ? fg[row0 + (size_t)i * W] : 0;
    }
    if (kSeed) asm volatile("cp.async.wait_all;" ::: "memory");
    uint32_t row_word = 0;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int r = kb * CH + i;
      const bool open = f[i] != 0;
      if (!open) s.v[r * STRIDE + col] = INT_MAX;
      else if (!kSeed) s.v[r * STRIDE + col] = (y0 + r) * W + x;
      const uint32_t word = __ballot_sync(0xffffffffu, open);
      if (lane == i) row_word = word;
    }
    s.rowbits[jb][kb * CH + lane] = row_word;
    uint32_t col_word = 0;  // the 32 × 32 bit block transposed
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const uint32_t word = __ballot_sync(0xffffffffu, (row_word >> i) & 1u);
      if (lane == i) col_word = word;
    }
    s.colbits[kb][col] = col_word;
  }
}

// Store the tile, with B2's finalisation: open pixels hold a raster index,
// stored + 1, closed ones INT_MAX, stored as 0.
template <bool kSeed>
__device__ void store_tile(const Smem& s, int32_t* __restrict__ out, int b, int H, int W, int y0,
                           int x0) {
  const int lane = threadIdx.x & 31;
  for (int blk = threadIdx.x >> 5; blk < (TR / CH) * (TC / CH); blk += THREADS / 32) {
    const int kb = blk / (TC / CH), col = (blk % (TC / CH)) * CH + lane, x = x0 + col;
#pragma unroll 8
    for (int i = 0; i < CH; ++i) {
      const int r = kb * CH + i, y = y0 + r;
      if (y < H && x < W) {
        const int32_t v = s.v[r * STRIDE + col];
        out[((size_t)b * H + y) * W + x] = kSeed ? v : (v == INT_MAX ? 0 : v + 1);
      }
    }
  }
}

// One run-min broadcast along AXIS (0: down the columns, 1: along the rows).
// `lines` holds the image's summaries for this axis, `n_tiles` entries a
// line; this tile is entry `pos` of lines `first` … `first` + NL − 1, of
// which those below `n_lines` lie in the image.
template <int AXIS>
__device__ void phase(Smem& s, int4* __restrict__ lines, int n_lines, int n_tiles, int pos, int first,
                      unsigned* arrive, unsigned T) {
  constexpr int NL = AXIS == 0 ? TC : TR;          // lines in the tile
  constexpr int K = (AXIS == 0 ? TR : TC) / CH;    // chunks a line
  constexpr int STEP = AXIS == 0 ? STRIDE : 1;
  constexpr int Q = ((AXIS == 0 ? MAX_TY : MAX_TX) + K - 1) / K;  // entries a chunk stages
  const int line = threadIdx.x % NL;               // the same line for all of a thread's chunks

  int32_t v[CPT][CH];
  uint32_t m[CPT];
#pragma unroll
  for (int u = 0; u < CPT; ++u) {
    const int k = threadIdx.x / NL + u * (THREADS / NL), c = line + k * NL;
    const int base = AXIS == 0 ? k * CH * STRIDE + line : line * STRIDE + k * CH;
    m[u] = AXIS == 0 ? s.colbits[k][line] : s.rowbits[k][line];
#pragma unroll
    for (int i = 0; i < CH; ++i) v[u][i] = s.v[base + i * STEP];
    int32_t run = INT_MAX;  // closed pixels reset the run and hold INT_MAX: the re-mask
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      run = (m[u] >> i) & 1u ? min(run, v[u][i]) : INT_MAX;
      v[u][i] = run;
    }
    run = INT_MAX;
#pragma unroll
    for (int i = CH - 1; i >= 0; --i) {
      run = (m[u] >> i) & 1u ? min(run, v[u][i]) : INT_MAX;
      v[u][i] = run;
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) s.v[base + i * STEP] = v[u][i];
    s.head[c] = v[u][0];
    s.tail[c] = v[u][CH - 1];
    s.full[c] = m[u] == ALL_OPEN;
  }
  __syncthreads();

  // the line's summary for this tile, published to the other tiles along it
  const bool owner = threadIdx.x < NL, valid = first + line < n_lines;
  int4* entries = lines + (size_t)(first + line) * n_tiles;
  if (owner && valid) {
    int32_t h = INT_MAX, t = INT_MAX;
    bool full = true;
    for (int k = 0; k < K; ++k) {
      t = carry_fwd(t, s.tail[line + k * NL], s.full[line + k * NL]);
      full = full && s.full[line + k * NL];
    }
    for (int k = K - 1; k >= 0; --k) h = carry_bwd(h, s.head[line + k * NL], s.full[line + k * NL]);
    entries[pos] = make_int4(h, t, full, 0);
  }
  group_barrier(arrive, T);

  // every chunk of the line stages a few of the other tiles' entries (from
  // L2: written by other SMs), then the owner folds them
  if (valid) {
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const int k = threadIdx.x / NL + u * (THREADS / NL);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int p = k + q * K;
        if (p < n_tiles && p != pos) s.stage[p * NL + line] = __ldcg(entries + p);
      }
    }
  }
  __syncthreads();
  if (owner) {
    int32_t ci = INT_MAX, co = INT_MAX;
    if (valid) {
      for (int p = 0; p < pos; ++p) {
        const int4 e = s.stage[p * NL + line];
        ci = carry_fwd(ci, e.y, e.z != 0);
      }
      for (int p = n_tiles - 1; p > pos; --p) {
        const int4 e = s.stage[p * NL + line];
        co = carry_bwd(co, e.x, e.z != 0);
      }
    }
    s.cin[line] = ci;
    s.cout[line] = co;
  }
  __syncthreads();

  // each chunk's carries: the tile's, folded over the chunks between; the
  // first run (the chunk's leading open pixels) takes the one from before,
  // the last run (its trailing open pixels) the one from after
#pragma unroll
  for (int u = 0; u < CPT; ++u) {
    const int k = threadIdx.x / NL + u * (THREADS / NL);
    const int base = AXIS == 0 ? k * CH * STRIDE + line : line * STRIDE + k * CH;
    int32_t cl = s.cin[line], cr = s.cout[line];
    for (int j = 0; j < k; ++j) cl = carry_fwd(cl, s.tail[line + j * NL], s.full[line + j * NL]);
    for (int j = K - 1; j > k; --j) cr = carry_bwd(cr, s.head[line + j * NL], s.full[line + j * NL]);
    const int n_first = __clz(__brev(~m[u])), n_last = __clz(~m[u]);
    for (int i = 0; i < n_first; ++i) s.v[base + i * STEP] = min(s.v[base + i * STEP], cl);
    for (int i = CH - n_last; i < CH; ++i) s.v[base + i * STEP] = min(s.v[base + i * STEP], cr);
  }
  __syncthreads();
}

// Block g·T + t is tile t (row-major, TY × TX) of group g; group g takes
// images g, g + S, g + 2S, …. The workspace holds, per image, W × TY column
// entries and then H × TX row entries; `sync` two words a group.
template <bool kSeed>
__global__ void __launch_bounds__(THREADS, 1)
seg_min_kernel(const int8_t* __restrict__ fg, const int32_t* __restrict__ seed,
               int32_t* __restrict__ out, int4* __restrict__ ws, unsigned* __restrict__ sync, int B,
               int H, int W, int TY, int TX, int S, int n_outer) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& s = *reinterpret_cast<Smem*>(smem);
  const unsigned T = TY * TX;
  const int group = blockIdx.x / T, tile = blockIdx.x % T;
  const int ty = tile / TX, tx = tile % TX, y0 = ty * TR, x0 = tx * TC;
  unsigned* arrive = sync + 2 * group;
  const size_t per_image = (size_t)W * TY + (size_t)H * TX;
  for (int b = group; b < B; b += S) {
    load_tile<kSeed>(s, fg, seed, b, H, W, y0, x0);
    __syncthreads();
    int4* cols = ws + b * per_image;
    int4* rows = cols + (size_t)W * TY;
    for (int it = 0; it < n_outer; ++it) {
      phase<0>(s, cols, W, TY, ty, x0, arrive, T);
      phase<1>(s, rows, H, TX, tx, y0, arrive, T);
    }
    store_tile<kSeed>(s, out, b, H, W, y0, x0);
  }
  // the group's last block out leaves its counter at 0 for the next call
  if (n_outer > 0 && threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(arrive + 1, 1u) == T - 1) {
      atomicExch(arrive, 0u);
      atomicExch(arrive + 1, 0u);
    }
  }
}

// Co-resident blocks of one instantiation on the current device, found once
// per process and device.
template <bool kSeed>
cudaError_t capacity(int* cap) {
  static int cached[64];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    e = cudaFuncSetAttribute(seg_min_kernel<kSeed>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(Smem));
    if (e != cudaSuccess) return e;
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, seg_min_kernel<kSeed>, THREADS,
                                                      sizeof(Smem));
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    cached[dev] = per_sm * sms;
  }
  *cap = cached[dev];
  return cudaSuccess;
}

template <bool kSeed>
cudaError_t launch(const int8_t* fg, const int32_t* seed, int32_t* out, void* sync_words, void* ws_ints,
                   int B, int H, int W, int n_outer, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0) return cudaSuccess;
  int TY = (H + TR - 1) / TR, TX = (W + TC - 1) / TC;
  if (TY > MAX_TY || TX > MAX_TX || n_outer < 0) return cudaErrorInvalidValue;
  int cap = 0;
  cudaError_t e = capacity<kSeed>(&cap);
  if (e != cudaSuccess) return e;
  int S = cap / (TY * TX);
  if (S < 1) return cudaErrorCooperativeLaunchTooLarge;
  S = S < MAX_GROUPS ? S : MAX_GROUPS;
  S = S < B ? S : B;
  int4* ws = static_cast<int4*>(ws_ints);
  unsigned* sync = static_cast<unsigned*>(sync_words);
  void* args[] = {&fg, &seed, &out, &ws, &sync, &B, &H, &W, &TY, &TX, &S, &n_outer};
  e = cudaLaunchCooperativeKernel((const void*)seg_min_kernel<kSeed>, dim3(S * TY * TX),
                                  dim3(THREADS), args, sizeof(Smem), stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// (B, H, W) int8 mask → (B, H, W) int32 root labels (component-min linear
// index + 1, background 0) after `n_outer` passes. `sync`: 2 × 512 int32, 0
// between calls on one stream; `ws`: B · (W · ⌈H/128⌉ + H · ⌈W/256⌉) · 4 int32.
extern "C" int cc_labels(const void* fg, void* lab, void* sync, void* ws, int B, int H, int W,
                         int n_outer, void* stream) {
  return (int)launch<false>((const int8_t*)fg, nullptr, (int32_t*)lab, sync, ws, B, H, W, n_outer,
                            (cudaStream_t)stream);
}

// (B, H, W) int32 seeds + int8 mask → per-component min seed after `n_outer`
// passes (INT_MAX on background and where no finite seed reaches); `sync` and
// `ws` as for cc_labels.
extern "C" int propagate_min(const void* seed, const void* fg, void* out, void* sync, void* ws, int B,
                             int H, int W, int n_outer, void* stream) {
  return (int)launch<true>((const int8_t*)fg, (const int32_t*)seed, (int32_t*)out, sync, ws, B, H, W,
                           n_outer, (cudaStream_t)stream);
}
