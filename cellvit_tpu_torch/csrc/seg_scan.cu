// Segmented directional OR-scans: border flood (hole filling).
//
// Replaces (cellvit_tpu/ops/cc_pallas.py):
//   `_flood_kernel` :225   (pallas_call :250, `flood_pallas`)
//
// The Pallas kernel runs `n_outer` passes; a pass scans along axis 0
// forward, axis 0 reverse, axis 1 forward, axis 1 reverse, re-masking after
// each. One doubling pass of `_segor_direction` is an exact inclusive
// segmented prefix-OR along the direction, in which barrier pixels (closed
// pixels) reset the running value and keep the identity 0. Any exact
// segmented scan therefore gives bit-identical results; here each line is
// scanned by a block in shared memory (chunked per thread, carries combined
// across threads), and the pass order and `n_outer` are kept exactly.
// (B2 and B4, the min-scans, are `seg_min.cu`.)
//
// Bound on the H100 at (8, 1024, 1024): one read of the two int8 inputs and
// one write of the int32 output, 16 MB + 32 MB (≈14 µs at 3.35 TB/s); bound
// by bytes. This design streams the int32 state and the int8 mask through
// device memory twice per pass (one column launch for both axis-0
// directions, one row launch for both axis-1 directions): ≈4 × 72 MB ≈ 0.09
// ms per 2-pass call. Keeping a whole image resident (the Pallas design) does
// not fit one block's 227 KB of shared memory at 1024²; fusing passes across
// blocks is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct OrOp {
  static __device__ __forceinline__ int32_t ident() { return 0; }
  static __device__ __forceinline__ int32_t op(int32_t a, int32_t b) { return a | b; }
};

constexpr int COLS = 32;          // columns per block in the axis-0 kernel
constexpr int COL_THREADS = 256;  // 8 warps; warp w scans rows chunk w of its 32 columns
constexpr int ROW_THREADS = 256;

// Axis-0 scans (forward then reverse) of a strip of COLS columns held in
// shared memory: value sv[r*COLS + c], open flag sf[r*COLS + c].
template <class Op>
__global__ void __launch_bounds__(COL_THREADS)
col_scan_kernel(int32_t* __restrict__ v, const int8_t* __restrict__ fg, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NW = COL_THREADS / 32;
  int32_t* sv = reinterpret_cast<int32_t*>(smem);
  int32_t* pv = sv + H * COLS;                       // per-warp chunk aggregates
  int8_t* pf = reinterpret_cast<int8_t*>(pv + NW * COLS);
  int8_t* sf = pf + NW * COLS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * COLS + lane;
  const bool colok = col < W;
  const long long base = (long long)blockIdx.y * H * W;

  for (int r = warp; r < H; r += NW) {
    sv[r * COLS + lane] = colok ? v[base + (long long)r * W + col] : Op::ident();
    sf[r * COLS + lane] = colok ? fg[base + (long long)r * W + col] : 0;
  }
  __syncthreads();
  const int R = (H + NW - 1) / NW;
  const int i0 = warp * R, i1 = min(H, i0 + R);
  for (int dir = 0; dir < 2; ++dir) {
    // 1. segmented aggregate of this warp's chunk (per column)
    int32_t acc = Op::ident();
    int8_t flag = 0;
    for (int i = i0; i < i1; ++i) {
      int r = dir ? H - 1 - i : i;
      if (!sf[r * COLS + lane]) { acc = Op::ident(); flag = 1; }
      else acc = Op::op(acc, sv[r * COLS + lane]);
    }
    pv[warp * COLS + lane] = acc;
    pf[warp * COLS + lane] = flag;
    __syncthreads();
    // 2. carry in from the chunks before this one
    int32_t run = Op::ident();
    for (int p = 0; p < warp; ++p)
      run = pf[p * COLS + lane] ? pv[p * COLS + lane] : Op::op(run, pv[p * COLS + lane]);
    // 3. rescan with the carry
    for (int i = i0; i < i1; ++i) {
      int r = dir ? H - 1 - i : i;
      if (!sf[r * COLS + lane]) run = Op::ident();
      else { run = Op::op(run, sv[r * COLS + lane]); sv[r * COLS + lane] = run; }
    }
    __syncthreads();
  }
  for (int r = warp; r < H; r += NW)
    if (colok)
      v[base + (long long)r * W + col] = sf[r * COLS + lane] ? sv[r * COLS + lane] : Op::ident();
}

// Axis-1 scans (forward then reverse) of one row per block.
template <class Op>
__global__ void __launch_bounds__(ROW_THREADS)
row_scan_kernel(int32_t* __restrict__ v, const int8_t* __restrict__ fg, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* sv = reinterpret_cast<int32_t*>(smem);
  int32_t* pv = sv + W;
  int8_t* pf = reinterpret_cast<int8_t*>(pv + ROW_THREADS);
  int8_t* sf = pf + ROW_THREADS;
  const int tid = threadIdx.x;
  const long long base = ((long long)blockIdx.y * gridDim.x + blockIdx.x) * W;
  for (int i = tid; i < W; i += ROW_THREADS) {
    sv[i] = v[base + i];
    sf[i] = fg[base + i];
  }
  __syncthreads();
  const int E = (W + ROW_THREADS - 1) / ROW_THREADS;
  const int i0 = min(W, tid * E), i1 = min(W, i0 + E);
  for (int dir = 0; dir < 2; ++dir) {
    int32_t acc = Op::ident();
    int8_t flag = 0;
    for (int i = i0; i < i1; ++i) {
      int p = dir ? W - 1 - i : i;
      if (!sf[p]) { acc = Op::ident(); flag = 1; }
      else acc = Op::op(acc, sv[p]);
    }
    pv[tid] = acc;
    pf[tid] = flag;
    __syncthreads();
    // inclusive Hillis-Steele scan of the (value, reset) pairs
    for (int off = 1; off < ROW_THREADS; off <<= 1) {
      int32_t a = Op::ident();
      int8_t af = 0;
      if (tid >= off) { a = pv[tid - off]; af = pf[tid - off]; }
      __syncthreads();
      if (tid >= off) {
        if (!pf[tid]) pv[tid] = Op::op(a, pv[tid]);
        pf[tid] |= af;
      }
      __syncthreads();
    }
    int32_t run = tid > 0 ? pv[tid - 1] : Op::ident();
    for (int i = i0; i < i1; ++i) {
      int p = dir ? W - 1 - i : i;
      if (!sf[p]) run = Op::ident();
      else { run = Op::op(run, sv[p]); sv[p] = run; }
    }
    __syncthreads();
  }
  for (int i = tid; i < W; i += ROW_THREADS) v[base + i] = sf[i] ? sv[i] : Op::ident();
}

__global__ void init_flood_kernel(const int8_t* __restrict__ seed, const int8_t* __restrict__ open,
                                  int32_t* __restrict__ out, long long total) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < total) out[i] = (seed[i] != 0 && open[i] != 0) ? 1 : 0;
}

size_t col_smem(int H) {
  constexpr int NW = COL_THREADS / 32;
  return (size_t)H * COLS * 5 + NW * COLS * 5;
}

size_t row_smem(int W) { return (size_t)W * 5 + ROW_THREADS * 5; }

template <class Op>
cudaError_t run_passes(int32_t* v, const int8_t* fg, int B, int H, int W, int n_outer,
                       cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(col_scan_kernel<Op>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)col_smem(H));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(row_scan_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)row_smem(W));
  if (e != cudaSuccess) return e;
  dim3 cgrid((W + COLS - 1) / COLS, B), rgrid(H, B);
  for (int it = 0; it < n_outer; ++it) {
    col_scan_kernel<Op><<<cgrid, COL_THREADS, col_smem(H), s>>>(v, fg, H, W);
    row_scan_kernel<Op><<<rgrid, ROW_THREADS, row_smem(W), s>>>(v, fg, W);
  }
  return cudaGetLastError();
}

inline unsigned blocks_for(long long total) { return (unsigned)((total + 255) / 256); }

}  // namespace

// (B, H, W) int8 seed + int8 open mask → int32 reachability (0/1) through
// open pixels, 4-connected.
extern "C" int flood(const void* seed, const void* open, void* out, int B, int H, int W,
                     int n_outer, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long total = (long long)B * H * W;
  init_flood_kernel<<<blocks_for(total), 256, 0, s>>>((const int8_t*)seed, (const int8_t*)open,
                                                      (int32_t*)out, total);
  cudaError_t e = run_passes<OrOp>((int32_t*)out, (const int8_t*)open, B, H, W, n_outer, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
