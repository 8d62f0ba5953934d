"""Variant study of the bit-packed cluster kernel of B3
(`cellvit_tpu_torch/csrc/flood_bits.cu`) on the GPU.

    python3 scripts/flood_bits_variants.py

Each variant is the shipped source with a few textual changes (its name says
which), built with the package's nvcc flags into `cellvit_tpu_torch/build/`,
called through its C entry points on `chip_smoke.py`'s (8, 1024, 1024) scan
masks with 8 blocks an image, held bit-equal to the plain versions where it
should be, then timed: the flood and the hole filling at `n_outer` 2 and 0
(the load and store alone), and the shipped kernel also with 2 and 4 blocks
an image. Times are device µs per call from
`torch.profiler` over 20 calls, so host time does not enter them, taken in
three rounds that visit every variant in turn (`timed_rounds`): the card's
clocks drift over a call by more than some variants differ.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent

LOADS = ["""      if (r < H) m = load_word(row, q, lane, W, vec);""",
         """        o[i][q] = r < H ? load_word(in1 + image + (size_t)r * W, q, lane, W, vec) & valid : 0u;"""]
# the state from the indices instead of the inputs (results wrong)
NO_LOADS = [(LOADS[0], """      if (r < H) m = 0x5a5a5a5au ^ (uint32_t)(r * 977 + c);"""),
            (LOADS[1], """        o[i][q] = r < H ? (0xa5a5a5a5u ^ (uint32_t)(r * 131 + c)) & valid : 0u;""")]
# the result stored only where it can never hold (results wrong)
NO_STORES = [("      store_word(out + image + (size_t)r * W, q, lane, W, vec, ",
              "      if (x[i][q] == 0x9e3779b9u && o[i][q] == 1u) store_word(out + image + (size_t)r * W, q, lane, W, vec, ")]
# the first version's column phase: each band's summary read from its block's
# shared memory after the cluster barrier (`ld.shared::cluster`), folded by a
# warp a word column, a block barrier more a pass, a cluster barrier at exit
PULL = [
(r"""struct Smem {
  // per chunk (warp) and word column: the run value leaving the chunk at its
  // bottom (t) and at its top (h) with no carries, and its all-open word (f);
  // once folded, t and f hold the carry and the all-open word from the band's
  // top down to the chunk, h and g the same from the band's bottom up
  uint32_t t[WARPS][WP], h[WARPS][WP], f[WARPS][WP], g[WARPS][WP];
  // every band's T, H and F a word column, by pass parity, written by the
  // band's own block
  uint32_t band[2][MAX_CLUSTER][3][MAX_WORDS];
};

""",
 r"""struct Smem {
  // per chunk (warp) and word column: the run value leaving the chunk at its
  // bottom and at its top (no carries) and its all-open word; once folded,
  // t and h hold the chunk's carries from above and from below
  uint32_t t[WARPS][WP], h[WARPS][WP], f[WARPS][WP];
  uint32_t pub[2][3][MAX_WORDS];  // this band's T, H, F a word column, by pass parity
};

"""),
(r"""// All threads of all blocks of the cluster: the arrival releases this
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

""",
 r"""// All threads of all blocks of the cluster: the arrival releases this
// block's shared-memory writes, the wait acquires the others'.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The two halves of `cluster_barrier`, for a wait that overlaps other work.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A word of block `rank`'s shared memory at this block's address `p`.
__device__ __forceinline__ uint32_t ld_cluster(const uint32_t* p, uint32_t rank) {
  uint32_t remote, v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(remote) : "memory");
  return v;
}

"""),
(r"""    __syncthreads();
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
""",
 r"""    __syncthreads();
    // 2: a warp per word column folds its 32 chunks (lane = chunk) into the
    // carries within the band and the band's summary, published for the
    // cluster
    uint32_t pa[2], pt[2], qa[2], qh[2];  // exclusive folds from above / below
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
      pt[k] = __shfl_up_sync(ALL, t, 1);
      pa[k] = __shfl_up_sync(ALL, a, 1);
      qh[k] = __shfl_down_sync(ALL, h, 1);
      qa[k] = __shfl_down_sync(ALL, bl, 1);
      if (lane == 0) {
        pt[k] = 0;
        pa[k] = ALL;
        s.pub[par][1][c] = h;
      }
      if (lane == 31) {
        qh[k] = 0;
        qa[k] = ALL;
        s.pub[par][0][c] = t;
        s.pub[par][2][c] = a;
      }
    }
    cluster_barrier();
    // 3: the bands above and below, read from their blocks' shared memory
    // (lane j: band j) and folded by the same shuffle scans
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int c = warp + 32 * k;
      if (c >= WW) break;
      uint32_t t = 0, h = 0, a = ALL;  // lanes past the cluster: no rows, all open
      if (lane < K) {
        t = ld_cluster(&s.pub[par][0][c], lane);
        h = ld_cluster(&s.pub[par][1][c], lane);
        a = ld_cluster(&s.pub[par][2][c], lane);
      }
      uint32_t bl = a;
      for (uint32_t d = 1; d < K; d <<= 1) {
        const uint32_t ua = __shfl_up_sync(ALL, a, d), ut = __shfl_up_sync(ALL, t, d);
        const uint32_t db = __shfl_down_sync(ALL, bl, d), dh = __shfl_down_sync(ALL, h, d);
        if (lane >= d) {
          t |= a & ut;
          a &= ua;
        }
        if (lane + d < 32) {
          h |= bl & dh;
          bl &= db;
        }
      }
      const uint32_t cin = __shfl_sync(ALL, t, (rank + 31) & 31), cout = __shfl_sync(ALL, h, (rank + 1) & 31);
      s.t[lane][c] = pt[k] | (pa[k] & (rank > 0 ? cin : 0u));
      s.h[lane][c] = qh[k] | (qa[k] & (rank + 1 < K ? cout : 0u));
    }
    __syncthreads();
    // 4: each chunk walked down and up with its carries
#pragma unroll
    for (int q = 0; q < NWL; ++q) {
      const int c = 32 * q + lane;
      uint32_t run = s.t[warp][c];
#pragma unroll
      for (int i = 0; i < RC; ++i) run = x[i][q] = x[i][q] | (o[i][q] & run);
      run = s.h[warp][c];
#pragma unroll
      for (int i = RC - 1; i >= 0; --i) run = x[i][q] = x[i][q] | (o[i][q] & run);
    }
"""),
(r"""  if (n_outer > 0) cluster_arrive_relaxed();  // waited for before the first store to another block
""",
 r""""""),
(r"""  // no block touches another's shared memory after the last pass's barrier
}""",
 r"""  cluster_barrier();  // no block leaves while another may read its summaries
}""")]
# a cluster barrier at exit, which the stores into other blocks do not need
EXIT_BARRIER = [("  // no block touches another's shared memory after the last pass's barrier\n}",
                 "  cluster_barrier();\n}")]
# the first version: each lane loads and stores its own word's 32 bytes
PER_LANE_IO = [("""    const int b0 = 1024 * q + 16 * (int)lane, b1 = b0 + 512;
    const uint32_t ha = b0 < W ? pack16(__ldg(reinterpret_cast<const uint4*>(row + b0))) : 0u;
    const uint32_t hb = b1 < W ? pack16(__ldg(reinterpret_cast<const uint4*>(row + b1))) : 0u;
    const uint32_t src = (2 * lane) & 31;
    const uint32_t la = __shfl_sync(ALL, ha, src), ua = __shfl_sync(ALL, ha, src + 1);
    const uint32_t lb = __shfl_sync(ALL, hb, src), ub = __shfl_sync(ALL, hb, src + 1);
    return lane < 16 ? la | ua << 16 : lb | ub << 16;""", """    if (32 * c >= W) return 0u;
    const uint4* p = reinterpret_cast<const uint4*>(row + 32 * c);
    return pack16(__ldg(p)) | pack16(__ldg(p + 1)) << 16;"""),
               ("""    const int b0 = 1024 * q + 16 * (int)lane, b1 = b0 + 512;
    const uint32_t wa = __shfl_sync(ALL, w, lane >> 1) >> (16 * (lane & 1));
    const uint32_t wb = __shfl_sync(ALL, w, 16 + (lane >> 1)) >> (16 * (lane & 1));
    if (b0 < W)
      *reinterpret_cast<uint4*>(row + b0) = make_uint4(unpack4(wa), unpack4(wa >> 4), unpack4(wa >> 8),
                                                       unpack4(wa >> 12));
    if (b1 < W)
      *reinterpret_cast<uint4*>(row + b1) = make_uint4(unpack4(wb), unpack4(wb >> 4), unpack4(wb >> 8),
                                                       unpack4(wb >> 12));
    return;""", """    const int c = 32 * q + (int)lane;
    if (32 * c >= W) return;
    uint4* p = reinterpret_cast<uint4*>(row + 32 * c);
    p[0] = make_uint4(unpack4(w), unpack4(w >> 4), unpack4(w >> 8), unpack4(w >> 12));
    p[1] = make_uint4(unpack4(w >> 16), unpack4(w >> 20), unpack4(w >> 24), unpack4(w >> 28));
    return;""")]
NO_ROWS = [("    for (int i = 0; i < RC; ++i) row_broadcast<NWL>(x[i], o[i], lane);\n", "    ;\n")]
# the column phase skipped at run time (no block touches another's shared
# memory)
NO_COLUMNS = [("    // ---- columns. 1:", "    if (vec < 0) {\n    // ---- columns. 1:"),
              ("    // ---- rows: each warp its own rows", "    }\n    // ---- rows: each warp its own rows"),
              ("  if (n_outer > 0) cluster_arrive_relaxed();", "")]

VARIANTS = {
    "shipped": ([], True),
    "each lane loads and stores its own word (the first version)": (PER_LANE_IO, True),
    "summaries read from the other blocks after the barrier (the first version)": (PULL, True),
    "a cluster barrier at exit": (EXIT_BARRIER, True),
    "diagnostic: no loads, the state from the indices (results wrong)": (NO_LOADS, False),
    "diagnostic: no stores (results wrong)": (NO_STORES, False),
    "diagnostic: no row phase (results wrong)": (NO_ROWS, False),
    "diagnostic: no column phase (results wrong)": (NO_COLUMNS, False),
}


def build(name: str, edits, src: Path, nvcc_flags, nvcc: str, out_dir: Path):
    text = src.read_text()
    for old, new in edits:
        if old not in text:
            return None, f"{name}: patch does not apply"
        text = text.replace(old, new)
    tag = "".join(ch if ch.isalnum() else "_" for ch in name)[:60]
    cu = out_dir / f"{src.stem}_variant_{tag}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(text)
    res = subprocess.run([nvcc, *nvcc_flags, "-I", str(src.parent), "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        return None, res.stdout + res.stderr
    return ctypes.CDLL(str(so)), res.stdout + res.stderr


def device_us(fn, calls: int = 20) -> float:
    """Device µs per call of the kernels `fn` launches (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / calls


def timed_rounds(runs: dict, rounds: int = 3) -> dict:
    """{variant: {measure: [device µs in each round]}} of `runs`, {variant:
    {measure: fn}}, every measure of every variant timed once a round."""
    out = {name: {m: [] for m in fns} for name, fns in runs.items()}
    for _ in range(rounds):
        for name, fns in runs.items():
            for m, fn in fns.items():
                out[name][m].append(device_us(fn))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("flood_bits_variants: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from cellvit_tpu_torch import _build
    from cellvit_tpu_torch.ops import cc_cuda
    from cellvit_tpu_torch.synthetic import blob_tiles

    print(f"card: {chip_smoke.card_line()}")
    _, masks = blob_tiles(8, 1024, 0)
    fg = torch.from_numpy(chip_smoke.scan_masks(masks)).cuda()
    seed, open_ = cc_cuda.border_seed(fg), ~fg
    b, h, w = fg.shape
    want = {n: (cc_cuda.flood_plain(seed, open_, n), cc_cuda.fill_holes_cuda(fg.cpu(), n).cuda()) for n in (0, 2)}
    reach, filled = torch.empty_like(fg), torch.empty_like(fg)
    stream = _build.stream_of(fg)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    runs, notes = {}, {}
    for name, (edits, must_be_exact) in VARIANTS.items():
        lib, log = build(name, edits, _build.CSRC / "flood_bits.cu", _build.NVCC_FLAGS, _build._nvcc(),
                         _build.BUILD_DIR)
        if lib is None:
            print(f"{name}: build failed\n{log}")
            return 1
        spills = {k: v for k, v in chip_smoke.ptxas_spills(log).items() if k.startswith("flood_bits_kernel<4, 1,")}
        flood, fill = lib.flood_bits, lib.fill_holes_bits
        flood.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fill.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

        def run_flood(n_outer, blocks=8, flood=flood, name=name):
            _build.check(flood(seed.data_ptr(), open_.data_ptr(), reach.data_ptr(), b, h, w, n_outer, blocks,
                               stream), name)

        def run_fill(n_outer, blocks=8, fill=fill, name=name):
            _build.check(fill(fg.data_ptr(), filled.data_ptr(), b, h, w, n_outer, blocks, stream), name)

        exact = True
        for n in (0, 2):
            run_flood(n)
            run_fill(n)
            torch.cuda.synchronize()
            exact = exact and torch.equal(reach, want[n][0]) and torch.equal(filled, want[n][1])
        if must_be_exact and not exact:
            print(f"{name}: not exact")
            return 1
        notes[name] = f"exact {exact}; spill bytes (stores, loads) {spills}"
        runs[name] = {"flood": lambda f=run_flood: f(2), "flood n_outer 0": lambda f=run_flood: f(0),
                      "fill_holes": lambda f=run_fill: f(2), "fill_holes n_outer 0": lambda f=run_fill: f(0)}
        if name == "shipped":
            for k in (2, 4):
                for n_outer in (0, 2):
                    run_flood(n_outer, k)
                    run_fill(n_outer, k)
                    torch.cuda.synchronize()
                    exact = exact and torch.equal(reach, want[n_outer][0]) and torch.equal(filled, want[n_outer][1])
                runs[name].update({f"flood, {k} blocks": lambda f=run_flood, k=k: f(2, k),
                                   f"fill_holes, {k} blocks": lambda f=run_fill, k=k: f(2, k)})
            if not exact:
                print(f"{name}: not exact with fewer blocks an image")
                return 1
    for name, times in timed_rounds(runs).items():
        print(f"{name}: {notes[name]}; device µs a call in 3 rounds: "
              + ", ".join(f"{m} " + " / ".join(f"{t:.2f}" for t in ts) for m, ts in times.items()))
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
