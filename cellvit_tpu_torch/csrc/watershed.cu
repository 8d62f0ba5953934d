// Quantized level-sweep watershed: `levels` × `inner_iters` adoption passes,
// pass p admitting in-mask pixels of quantized height ≤ p ÷ inner_iters,
// then stabilization passes over the whole mask until a pass changes nothing
// or `max_final` passes have run, per image.
//
// Replaces (cellvit_tpu/ops/cc_pallas.py): `_watershed_kernel` :493 with
// `_ws_adopt` :468 (pallas_call :554, `watershed_pallas`).
//
// Every pass is Jacobi: an unlabelled admitted pixel takes the label of its
// labelled 4-neighbour (label > 0) of lowest quantized height in the labels
// before the pass, ties N, S, W, E by strict <. Negative labels neither
// change nor spread.
//
// Bound on the H100 at (8, 1024, 1024): q (int32), mask (int8) and markers
// (int32) read once and the labels written once, 104 MB (≈31 µs at 3.35
// TB/s). The 256 + s passes depend on each other, so a floor set by the
// latency of a pass (a block barrier and a few dependent shared-memory
// reads) lies far above that bound.
//
// Design: one cooperative launch a call, all passes inside it.
// * Compact state. A label never changes once it is > 0, so the labels are
//   one int32 buffer (the output), updated in place. What a pass reads of its
//   neighbours is only whether they are labelled, which is one bit a pixel:
//   the labelled bits L, the static bits P (in the mask, initially 0: may
//   still be labelled), both in 32-pixel row words, and the heights in a
//   byte (levels ≤ 256) or 16 bits (≤ 65535).
// * Bit-parallel frontier. A pass forms the candidate words
//   P ∧ ¬L ∧ (N ∨ S ∨ W ∨ E of L) from a snapshot of L and ands them with the
//   admitted bits P ∧ (q ≤ level), which a thread keeps in registers for its
//   words and recomputes by SIMD byte compares when the level changes; only
//   the set bits left compare neighbour heights, and they record the
//   direction of the neighbour they adopt (2 bits a pixel). The new bits go
//   into the other of two L buffers in shared memory: one barrier a pass.
//   A zero word costs one test; a staged tile with no candidate ends its
//   phase, since nothing can change after such a pass.
// * Temporal blocking. A block stages an owned TH × TW tile (256 × 256; 128
//   rows for 16-bit heights) with a halo of K = 16 rows and one word (32
//   columns) each side and runs K passes in shared memory: after pass j the staged rows and columns within j of the staged
//   edge may be wrong, so the owned tile is exact after K. At the end of a
//   phase each newly labelled owned pixel follows its directions back to a
//   pixel labelled before the phase (at most K steps, in shared memory) and
//   takes that pixel's label from the global buffer, where it was written
//   in an earlier phase; the owned L words go to the other of two global
//   L planes, so that tiles of the same phase read the snapshot of its start.
// * Persistent grid. The blocks form groups, one image a group at a time,
//   each block walking its share of the image's tiles; the tiles of a group
//   meet at a counter barrier (as in `seg_min.cu`) after the image's
//   initialisation and after each phase. Stabilization phases record which
//   of their passes changed an owned pixel (a 32-bit mask per image and
//   phase); after the barrier every block reads the same masks, so the group
//   stops at the first pass that changed nothing (pass count = that pass + 1)
//   or at `max_final`, and no work is issued for a converged image.
// Tile, K and the alternatives (one launch a phase, no candidate skip) were
// chosen by `scripts/watershed_variants.py`: at 8 × 1024² a pass costs ≈2.6
// µs all told, of which the barrier alone ≈0.7 (the pass-latency floor of
// this design).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int TH8 = 256, TW = 256;    // owned tile with byte heights (half the rows with 16-bit)
constexpr int K = 16;                 // passes a phase, halo rows
constexpr int THREADS = 1024;
constexpr int SWW = TW / 32 + 2;       // staged words a row: one word of halo each side
constexpr int SW = SWW * 32;           // staged columns

// Tile rows by height type: 16-bit heights take half the rows, to fit.
template <class QT>
struct Geo {
  static constexpr int TH = sizeof(QT) == 1 ? TH8 : TH8 / 2;
  static constexpr int SH = TH + 2 * K;  // staged rows
  static constexpr int NWORDS = SH * SWW;
  static constexpr int WPT = (NWORDS + THREADS - 1) / THREADS;
};
constexpr int MAX_GROUPS = 512;        // the wrapper's sync words: two a group
constexpr unsigned POLL_LIMIT = 1u << 25;
static_assert(TW % 32 == 0 && K >= 1 && K <= 32 && THREADS % 32 == 0, "tile shape");

struct Args {
  const int32_t* q;
  const uint8_t* mask;
  const int32_t* markers;
  int32_t* lab;
  uint32_t* lbits;   // two planes of B · H · NWG words
  uint32_t* pbits;   // one plane
  void* qs;          // heights, B · H rows of QP elements; pixel x at element 32 + x
  uint32_t* flags;   // B · NSTAB masks: bit j of [b, t] = pass t·K + j changed image b
  int32_t* passes;
  int B, H, W, NWG, QP, TY, TX, inner, sweep, NS, max_final, NSTAB;
};

template <class QT, class G = Geo<QT>>
struct Smem {
  QT q[G::SH * SW];
  uint32_t l0[G::NWORDS];       // L at the start of the phase
  uint32_t l[2][G::NWORDS];     // L before and after a pass
  uint32_t p[G::NWORDS];
  uint32_t d0[G::NWORDS], d1[G::NWORDS];  // direction adopted from: 0 N, 1 S, 2 W, 3 E
  uint32_t fl[3];            // per pass: 1 a candidate in the staged tile, 2 an owned pixel changed
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Barrier among the T blocks of one group (as in seg_min.cu): the counter
// is 0 when a call starts and rises by T a barrier.
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

// Bit i: q[i] ≤ lvl, for the 32 heights at q (4-byte aligned), 4 or 2 at a
// time by SIMD compares.
__device__ __forceinline__ uint32_t le_bits(const uint8_t* q, int lvl) {
  if (lvl >= 255) return 0xffffffffu;
  const uint32_t l4 = 0x01010101u * (uint32_t)lvl;
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t m = __vcmpleu4(reinterpret_cast<const uint32_t*>(q)[k], l4);  // 0xff per byte
    bits |= ((m & 1u) | ((m >> 7) & 2u) | ((m >> 14) & 4u) | ((m >> 21) & 8u)) << (4 * k);
  }
  return bits;
}

__device__ __forceinline__ uint32_t le_bits(const uint16_t* q, int lvl) {
  if (lvl >= 65535) return 0xffffffffu;
  const uint32_t l2 = 0x00010001u * (uint32_t)lvl;
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const uint32_t m = __vcmpleu2(reinterpret_cast<const uint32_t*>(q)[k], l2);  // 0xffff per half
    bits |= ((m & 1u) | ((m >> 15) & 2u)) << (2 * k);
  }
  return bits;
}

__device__ __forceinline__ size_t word_at(const Args& a, int b, int y, int gw) {
  return ((size_t)b * a.H + y) * a.NWG + gw;
}

// Labels, L plane 0, P and heights of the owned tile (ty, tx) of image b:
// a warp a row word, a lane a pixel.
template <class QT>
__device__ void init_tile(const Args& a, int b, int ty, int tx) {
  constexpr int TH = Geo<QT>::TH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int y0 = ty * TH, gw0 = tx * (TW / 32);
  QT* qs = static_cast<QT*>(a.qs);
  for (int task = warp; task < TH * (TW / 32); task += THREADS / 32) {
    const int y = y0 + task / (TW / 32), gw = gw0 + task % (TW / 32);
    if (y >= a.H || gw >= a.NWG) continue;
    const int x = gw * 32 + lane;
    const bool in = x < a.W;
    const size_t o = ((size_t)b * a.H + y) * a.W + x;
    const bool m = in && a.mask[o] != 0;
    const int32_t l = m ? a.markers[o] : 0;
    if (in) {
      a.lab[o] = l;
      qs[((size_t)b * a.H + y) * a.QP + 32 + x] = (QT)a.q[o];
    }
    const uint32_t lw = __ballot_sync(0xffffffffu, l > 0), pw = __ballot_sync(0xffffffffu, m && l == 0);
    if (lane == 0) {
      a.lbits[word_at(a, b, y, gw)] = lw;
      a.pbits[word_at(a, b, y, gw)] = pw;
    }
  }
}

// Whether image b runs phase phi: 1 it runs; 0 it stopped at the phase
// before, with its stabilization pass count in *count; -1 it stopped
// earlier. Sweep phases always run; stabilization phase t runs unless a
// pass of an earlier one changed nothing or t·K passes reached max_final.
__device__ int phase_status(const Args& a, int b, int phi, int* count) {
  if (phi < a.NS) return 1;
  const int t = phi - a.NS;
  const uint32_t* f = a.flags + (size_t)b * a.NSTAB;
  for (int u = 0; u < t; ++u) {
    const int n = min(K, a.max_final - u * K);
    const uint32_t full = n == 32 ? 0xffffffffu : (1u << n) - 1u;
    const uint32_t m = __ldcg(f + u);
    if (m != full) {
      *count = u * K + __ffs(~m);  // the first pass that changed nothing, counted
      return u == t - 1 ? 0 : -1;
    }
  }
  if (t >= a.NSTAB) {
    *count = a.max_final;
    return t == a.NSTAB ? 0 : -1;
  }
  return 1;
}

// One phase of tile (ty, tx) of image b: stage, run its passes, store the
// owned L words into the other plane and the new owned labels in place.
template <class QT>
__device__ void run_tile_phase(const Args& a, Smem<QT>& s, int b, int ty, int tx, int phi,
                               bool load_static) {
  constexpr int TH = Geo<QT>::TH, SH = Geo<QT>::SH, NWORDS = Geo<QT>::NWORDS, WPT = Geo<QT>::WPT;
  const int tid = threadIdx.x, lane = tid & 31;
  const int y0 = ty * TH, x0 = tx * TW;
  const int ys = y0 - K, gws = x0 / 32 - 1;  // staged origin (row, word)
  const size_t plane = (size_t)a.B * a.H * a.NWG;
  const uint32_t* lin = a.lbits + (phi & 1) * plane;
  uint32_t* lout = a.lbits + ((phi + 1) & 1) * plane;
  const bool stab = phi >= a.NS;
  const int p0 = stab ? (phi - a.NS) * K : phi * K;
  const int n = min(K, (stab ? a.max_final : a.sweep) - p0);

  __syncthreads();  // the previous tile's resolution has read the shared state
  for (int w = tid; w < NWORDS; w += THREADS) {
    const int r = w / SWW, wc = w - r * SWW, y = ys + r, gw = gws + wc;
    const bool in = y >= 0 && y < a.H && gw >= 0 && gw < a.NWG;
    const uint32_t l = in ? __ldcg(lin + word_at(a, b, y, gw)) : 0u;
    s.l0[w] = l;
    s.l[0][w] = l;
    if (load_static) s.p[w] = in ? __ldcg(a.pbits + word_at(a, b, y, gw)) : 0u;
  }
  if (load_static) {
    constexpr int CHUNKS = SW * (int)sizeof(QT) / 16;
    const QT* qs = static_cast<const QT*>(a.qs);
    for (int task = tid; task < SH * CHUNKS; task += THREADS) {
      const int r = task / CHUNKS, c = task - r * CHUNKS, y = ys + r;
      if (y < 0 || y >= a.H) continue;
      // staged column sc is image column x0 − 32 + sc, element x0 + sc of the row
      cp_async16(reinterpret_cast<char*>(s.q + r * SW) + 16 * c,
                 reinterpret_cast<const char*>(qs + ((size_t)b * a.H + y) * a.QP + x0) + 16 * c);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  }
  if (tid == 0) s.fl[0] = 0;
  __syncthreads();

  int cur = 0, adm_lvl = -1;
  uint32_t changed = 0, adm[WPT];  // a thread's words' admitted bits P ∧ (q ≤ level)
  for (int j = 0; j < n; ++j) {
    const int lvl = stab ? INT_MAX : (p0 + j) / a.inner;
    const uint32_t* L = s.l[cur];
    uint32_t* Ln = s.l[cur ^ 1];
    bool any = false, chg = false;
    const bool new_lvl = lvl != adm_lvl;
    adm_lvl = lvl;
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
      const int w = tid + k * THREADS;
      if (w >= NWORDS) break;
      const int r = w / SWW, wc = w - r * SWW;
      if (new_lvl) adm[k] = s.p[w] & le_bits(s.q + r * SW + wc * 32, lvl);
      const uint32_t c = L[w];
      const uint32_t nn = r > 0 ? L[w - SWW] : 0u, ss = r < SH - 1 ? L[w + SWW] : 0u;
      const uint32_t ww = (c << 1) | (wc > 0 ? L[w - 1] >> 31 : 0u);
      const uint32_t ee = (c >> 1) | (wc < SWW - 1 ? L[w + 1] << 31 : 0u);
      const uint32_t pend = s.p[w] & ~c & (nn | ss | ww | ee);  // candidates, admitted or not
      const uint32_t cand = pend & adm[k];
      any |= pend != 0;
      uint32_t nw = 0;
      if (cand) {
        uint32_t d0 = s.d0[w], d1 = s.d1[w];
        for (uint32_t m = cand; m; m &= m - 1) {
          const int i = __ffs(m) - 1;
          const QT* qr = s.q + r * SW + wc * 32 + i;
          int best = INT_MAX, dir = 0;
          if ((nn >> i) & 1u) best = qr[-SW];
          if (((ss >> i) & 1u) && (int)qr[SW] < best) { best = qr[SW]; dir = 1; }
          if (((ww >> i) & 1u) && (int)qr[-1] < best) { best = qr[-1]; dir = 2; }
          if (((ee >> i) & 1u) && (int)qr[1] < best) { best = qr[1]; dir = 3; }
          const uint32_t bit = 1u << i;
          nw |= bit;
          d0 = (dir & 1) ? d0 | bit : d0 & ~bit;
          d1 = (dir & 2) ? d1 | bit : d1 & ~bit;
        }
        if (nw) {
          s.d0[w] = d0;
          s.d1[w] = d1;
        }
      }
      Ln[w] = c | nw;
      chg |= nw != 0 && r >= K && r < K + TH && wc >= 1 && wc <= TW / 32;
    }
    const unsigned ba = __ballot_sync(0xffffffffu, any), bc = __ballot_sync(0xffffffffu, chg);
    if (lane == 0 && (ba | bc)) atomicOr(&s.fl[j % 3], (ba ? 1u : 0u) | (bc ? 2u : 0u));
    if (tid == 0) s.fl[(j + 1) % 3] = 0;
    __syncthreads();
    const uint32_t v = s.fl[j % 3];
    cur ^= 1;
    if (v & 2u) changed |= 1u << j;
    if (!(v & 1u)) break;  // no candidate: every later pass of the phase changes nothing
  }

  // owned words out; each newly labelled owned pixel takes the label at the
  // end of its chain of directions
  const uint32_t* L = s.l[cur];
  for (int task = tid; task < TH * (TW / 32); task += THREADS) {
    const int r = K + task / (TW / 32), wc = 1 + task % (TW / 32), y = ys + r, gw = gws + wc;
    if (y >= a.H || gw >= a.NWG) continue;
    const int w = r * SWW + wc;
    lout[word_at(a, b, y, gw)] = L[w];
    for (uint32_t m = L[w] & ~s.l0[w]; m; m &= m - 1) {
      const int i = __ffs(m) - 1;
      int rr = r, cc = wc * 32 + i;
      for (int step = 0;; ++step) {
        if (step > K) __trap();  // a chain longer than the phase: a broken invariant
        const int ww = rr * SWW + (cc >> 5), bb = cc & 31;
        const int dir = ((s.d0[ww] >> bb) & 1u) | (((s.d1[ww] >> bb) & 1u) << 1);
        rr += dir == 0 ? -1 : dir == 1 ? 1 : 0;
        cc += dir == 2 ? -1 : dir == 3 ? 1 : 0;
        if ((s.l0[rr * SWW + (cc >> 5)] >> (cc & 31)) & 1u) break;
      }
      const size_t row = (size_t)b * a.H;
      const int32_t label = __ldcg(a.lab + (row + ys + rr) * a.W + (gws * 32 + cc));
      a.lab[(row + y) * a.W + gw * 32 + i] = label;
    }
  }
  if (stab && tid == 0 && changed) atomicOr(a.flags + (size_t)b * a.NSTAB + (phi - a.NS), changed);
}

template <class QT>
__global__ void __launch_bounds__(THREADS, 1)
ws_kernel(Args a, unsigned* __restrict__ sync, int S, int NB) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem<QT>& s = *reinterpret_cast<Smem<QT>*>(smem);
  const int group = blockIdx.x / NB, blk = blockIdx.x % NB, NT = a.TY * a.TX;
  unsigned* arrive = sync + 2 * group;
  const int my_tiles = (NT - blk + NB - 1) / NB;
  for (int b = group; b < a.B; b += S) {
    for (int i = blk * THREADS + threadIdx.x; i < a.NSTAB; i += NB * THREADS)
      a.flags[(size_t)b * a.NSTAB + i] = 0;
    for (int t = blk; t < NT; t += NB) init_tile<QT>(a, b, t / a.TX, t % a.TX);
    group_barrier(arrive, NB);
    for (int phi = 0;; ++phi) {
      int count = 0;
      if (phase_status(a, b, phi, &count) != 1) {
        if (blk == 0 && threadIdx.x == 0) a.passes[b] = count;
        break;
      }
      // a block with one tile keeps its heights and P bits for the image
      for (int t = blk; t < NT; t += NB)
        run_tile_phase<QT>(a, s, b, t / a.TX, t % a.TX, phi, phi == 0 || my_tiles > 1);
      group_barrier(arrive, NB);
    }
  }
  // the group's last block out leaves its counter at 0 for the next call
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(arrive + 1, 1u) == (unsigned)NB - 1) {
      atomicExch(arrive, 0u);
      atomicExch(arrive + 1, 0u);
    }
  }
}

// Co-resident blocks of one instantiation on the current device, found once
// per process and device.
template <class QT>
cudaError_t capacity(int* cap) {
  static int cached[64];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    e = cudaFuncSetAttribute(ws_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(Smem<QT>));
    if (e != cudaSuccess) return e;
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ws_kernel<QT>, THREADS, sizeof(Smem<QT>));
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    cached[dev] = per_sm * sms;
  }
  *cap = cached[dev];
  return cudaSuccess;
}

struct Layout {
  int NWG, QP, TY, TX, NSTAB;
  size_t plane, qs_words, words;
};

Layout layout(int B, int H, int W, int levels, int max_final) {
  const int TH = levels <= 256 ? Geo<uint8_t>::TH : Geo<uint16_t>::TH;
  Layout l;
  l.NWG = (W + 31) / 32;
  l.TY = (H + TH - 1) / TH;
  l.TX = (W + TW - 1) / TW;
  l.QP = l.TX * TW + 64;  // a staged row of any tile stays inside its padded row
  l.NSTAB = (max_final + K - 1) / K;
  l.plane = (size_t)B * H * l.NWG;
  const size_t qbytes = (size_t)B * H * l.QP * (levels <= 256 ? 1 : 2);
  l.qs_words = (qbytes + 15) / 16 * 4;
  l.words = 3 * l.plane + l.qs_words + (size_t)B * l.NSTAB;
  return l;
}

template <class QT>
cudaError_t launch(const Args& a0, unsigned* sync, cudaStream_t stream) {
  Args a = a0;
  const int NT = a.TY * a.TX;
  int cap = 0;
  cudaError_t e = capacity<QT>(&cap);
  if (e != cudaSuccess) return e;
  if (cap < 1) return cudaErrorCooperativeLaunchTooLarge;
  int S = a.B < cap ? a.B : cap;
  S = S < MAX_GROUPS ? S : MAX_GROUPS;
  int NB = cap / S;
  NB = NB < NT ? NB : NT;
  void* args[] = {&a, &sync, &S, &NB};
  e = cudaLaunchCooperativeKernel((const void*)ws_kernel<QT>, dim3(S * NB), dim3(THREADS), args,
                                  sizeof(Smem<QT>), stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// int32 words of the workspace of one call (heights, L planes, P plane,
// stabilization masks).
extern "C" long long watershed_workspace_words(int B, int H, int W, int levels, int max_final) {
  return (long long)layout(B, H, W, levels, max_final).words;
}

// q (B, H, W) int32 quantized heights in [0, levels), mask uint8, markers
// int32 → labels in `lab`, stabilization pass counts in `passes` (B,) int32.
// ws: `watershed_workspace_words` int32 of scratch; sync: 2 × 512 int32, 0
// between calls on one stream (each call leaves them at 0).
extern "C" int watershed_sweep(const void* q, const void* mask, const void* markers, void* lab, void* ws,
                               void* sync, void* passes, int B, int H, int W, int levels,
                               int inner_iters, int max_final, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  if (levels < 1 || levels > 65535 || inner_iters < 0 || max_final < 1) return (int)cudaErrorInvalidValue;
  const Layout l = layout(B, H, W, levels, max_final);
  Args a;
  a.q = (const int32_t*)q;
  a.mask = (const uint8_t*)mask;
  a.markers = (const int32_t*)markers;
  a.lab = (int32_t*)lab;
  uint32_t* w = (uint32_t*)ws;  // heights first: their rows are read 16 bytes at a time
  a.qs = w;
  a.lbits = w + l.qs_words;
  a.pbits = a.lbits + 2 * l.plane;
  a.flags = a.pbits + l.plane;
  a.passes = (int32_t*)passes;
  a.B = B, a.H = H, a.W = W, a.NWG = l.NWG, a.QP = l.QP, a.TY = l.TY, a.TX = l.TX;
  a.inner = inner_iters > 0 ? inner_iters : 1;
  a.sweep = levels * inner_iters;
  a.NS = (a.sweep + K - 1) / K;
  a.max_final = max_final;
  a.NSTAB = l.NSTAB;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(levels <= 256 ? launch<uint8_t>(a, (unsigned*)sync, s)
                             : launch<uint16_t>(a, (unsigned*)sync, s));
}
