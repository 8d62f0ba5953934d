"""Variant study of the size-filter kernels B10 and B11
(`cellvit_tpu_torch/csrc/rm_small.cu`) on the GPU.

    python3 scripts/rm_small_variants.py [SUBSTRING ...]

With arguments, only the variants whose names hold one of them run, beside
the shipped source.
Each variant is the shipped source with a few textual changes (its name
says which), built with the package's nvcc flags into
`cellvit_tpu_torch/build/` and called through its C entry points. The
inputs are `chip_smoke.py`'s: the root labels and compacted markers of a
full-width CellViT-256 batch of 8 × 1024² blob tiles (probe weights). Every
variant that is not a diagnostic must equal the plain versions exactly:
B10 at min_size 10 on both tensors, B11's whole filter at min_size 10, its
histogram and its lookup on the markers. Times are device ms a call of
launches queued back to back behind a spin kernel (`chip_smoke.kernel_ms`),
in three interleaved rounds; the table prints each round and the median.
"""

from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

spec = importlib.util.spec_from_file_location("smoke", ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)

CENTRE_OUT = """      int cnt = row_matches(c, v, n);
      for (int d = 1; d <= g.r && cnt < min_size; ++d) {
        cnt += row_matches(c - d * g.BW, v, n);
        if (cnt >= min_size) break;
        cnt += row_matches(c + d * g.BW, v, n);
      }"""
# the window from its far edge, row y − r first, the exit tested once a row
FAR_EDGE = [(CENTRE_OUT, """      int cnt = 0;
      for (int dy = -g.r; dy <= g.r && cnt < min_size; ++dy) cnt += row_matches(c + dy * g.BW, v, n);""")]
# every pixel of the tile through the count, background included (no list
# of the labelled pixels: a warp's lanes follow its 32 pixels)
NO_LIST = [("        if (row_in && x + j < W && e[j] > 0) mine |= 1 << j;",
            "        if (row_in && x + j < W) mine |= 1 << j;"),
           ("      const int32_t v = c[g.r];\n", "      const int32_t v = c[g.r];\n      if (v <= 0) continue;\n")]
NO_COUNT = [(CENTRE_OUT, "      int cnt = min_size;")]

NO_TMA = [("  if (W % 4 == 0 && aligned16(lab) && aligned16(out)) {", "  if (false) {")]


def tile(th: int, tw: int, slots: int = 1, per_sm: int = 8, threads: int = 256):
    return [("constexpr int WIN_TH = 32, WIN_TW = 64;", f"constexpr int WIN_TH = {th}, WIN_TW = {tw};"),
            ("constexpr int WIN_SLOTS = 1;", f"constexpr int WIN_SLOTS = {slots};"),
            ("constexpr int WIN_PER_SM = 8;", f"constexpr int WIN_PER_SM = {per_sm};"),
            ("constexpr int WIN_THREADS = 256;", f"constexpr int WIN_THREADS = {threads};")]


# B11 on a grid of RX_CLUSTER blocks an image with a counter barrier in
# global memory instead of a cluster: each block's table goes to global
# memory before the first barrier, the bit words come back after the second
COOP_GRID = [
    ("constexpr int RX_MAX_WORDS = 256;  // a slice's bit words: S ≤ 8192 bins", """constexpr int RX_MAX_WORDS = 256;  // a slice's bit words: S ≤ 8192 bins
constexpr int COOP_NB = 8192;
__device__ uint32_t g_tables[64 * 16 * COOP_NB];
__device__ unsigned g_bar[2 * 64];
struct GridGroup {
  int K, rank, b;
  __device__ unsigned num_blocks() const { return K; }
  __device__ unsigned block_rank() const { return rank; }
  __device__ uint32_t* map_shared_rank(uint32_t*, int p) const { return g_tables + ((size_t)b * K + p) * COOP_NB; }
  __device__ void sync() const {
    __syncthreads();
    if (threadIdx.x == 0) {
      volatile unsigned* gen = &g_bar[2 * b + 1];
      const unsigned g0 = *gen;
      __threadfence();
      if (atomicAdd(&g_bar[2 * b], 1u) == (unsigned)K - 1) {
        g_bar[2 * b] = 0;
        __threadfence();
        atomicAdd(&g_bar[2 * b + 1], 1u);
      } else {
        while (*gen == g0) {}
      }
      __threadfence();
    }
    __syncthreads();
  }
};"""),
    ("  cg::cluster_group cluster = cg::this_cluster();",
     "  const GridGroup cluster{RX_CLUSTER, (int)(blockIdx.x % RX_CLUSTER), (int)(blockIdx.x / RX_CLUSTER)};"),
    ("  cluster.sync();  // barrier 1:", """  __syncthreads();
  if (MODE != RX_KEEP)
    for (int i = tid; i < nb; i += RX_THREADS) cluster.map_shared_rank(table, rank)[i] = table[i];
  cluster.sync();  // barrier 1:"""),
    ("  if (MODE == RX_HIST) return;\n", """  if (MODE == RX_HIST) return;
  for (int i = tid; i < nb; i += RX_THREADS) table[i] = cluster.map_shared_rank(table, rank)[i];
  __syncthreads();
"""),
    ("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;"),
]

# each variant: textual edits of the shipped source, and whether its results
# must be exact (a diagnostic that drops a step only times what remains)
VARIANTS = {
    "shipped": ([], True),
    "B10 far-edge count order": (FAR_EDGE, True),
    "B10 no list of labelled pixels": (NO_LIST, True),
    "B10 element-staged boxes (no TMA)": (NO_TMA, True),
    "B10 64 × 64 tiles, two slots, 3 blocks an SM": (tile(64, 64, slots=2, per_sm=3), True),
    "B10 32 × 128 tiles, 5 blocks an SM": (tile(32, 128, per_sm=5), True),
    "B10 64 × 64 tiles, 6 blocks an SM": (tile(64, 64, per_sm=6), True),
    "B10 64 × 128 tiles, 3 blocks an SM": (tile(64, 128, per_sm=3), True),
    "B10 64 × 64 tiles, 512 threads, 3 blocks an SM": (tile(64, 64, per_sm=3, threads=512), True),
    "B10 diagnostic: load and store only": (NO_COUNT, False),
    "B11 cluster of 12": ([("constexpr int RX_CLUSTER = 8;", "constexpr int RX_CLUSTER = 12;")], True),
    "B11 cluster of 16": ([("constexpr int RX_CLUSTER = 8;", "constexpr int RX_CLUSTER = 16;")], True),
    "B11 8 loads in flight a thread": ([("constexpr int RX_UNROLL = 4;", "constexpr int RX_UNROLL = 8;")], True),
    "B11 one atomic a pixel": ([("  int cur = b[0], run = 1;\n#pragma unroll\n  for (int i = 1; i < 4; ++i) {",
                                 "  int cur = b[0], run = 1;\n#pragma unroll\n  for (int i = 1; i < 4; ++i) {\n"
                                 "    if (true) { add_run(table, cur, run, zeros); cur = b[i]; run = 1; continue; }")],
                               True),
    "B11 cooperative grid of 8 blocks an image, counter barrier": (COOP_GRID, True),
    "B11 cooperative grid of 16 blocks an image, counter barrier": (
        COOP_GRID + [("constexpr int RX_CLUSTER = 8;", "constexpr int RX_CLUSTER = 16;")], True),
}


# appended to every variant: how many clusters of K blocks of the whole
# filter's kernel the card holds at once
MAX_CLUSTERS = """
extern "C" int rx_max_clusters(int K) {
  const auto kernel = radix_filter_kernel<RX_FILTER, true>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) != cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 8192 * 4) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K * 64);
  cfg.blockDim = dim3(RX_THREADS);
  cfg.dynamicSmemBytes = 8192 * 4;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess ? n : -1;
}
"""


def build(variants: dict) -> dict:
    """One nvcc a variant, all at once. Returns {name: loaded library}."""
    from cellvit_tpu_torch import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    shipped = (_build.CSRC / "rm_small.cu").read_text()
    procs = {}
    for i, (name, (edits, _)) in enumerate(variants.items()):
        text = shipped
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: patch does not apply: {old[:60]!r}")
            text = text.replace(old, new)
        cu = _build.BUILD_DIR / f"rm_variant_{i}.cu"
        cu.write_text(text + MAX_CLUSTERS)
        out = cu.with_suffix(".so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(out), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        print(f"  built {name}: spills {smoke.ptxas_spills(text)}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def callers(lib, roots, markers, hist):
    """{op: fn() → output} of one variant's entry points on the inputs."""
    p, i = ctypes.c_void_p, ctypes.c_int
    win = lib.remove_small_objects
    win.argtypes, win.restype = [p, p, i, i, i, i, p], i
    filt = lib.radix_filter
    filt.argtypes, filt.restype = [p, p, i, i, i, i, i, p], i
    hst = lib.radix_hist
    hst.argtypes, hst.restype = [p, p, i, i, i, i, p], i
    keep = lib.rm_mapback
    keep.argtypes, keep.restype = [p, p, p, i, i, i, i, i, p], i
    stream = torch.cuda.current_stream().cuda_stream
    b, h, w = roots.shape
    outs = {k: torch.empty_like(roots) for k in ("roots", "markers", "filter", "keep")}
    hout = torch.empty_like(hist)

    def check(err):
        if err:
            raise RuntimeError(f"cudaError_t {err}")

    return {
        "B10 roots": lambda: (check(win(roots.data_ptr(), outs["roots"].data_ptr(), b, h, w, 10, stream)),
                              outs["roots"])[1],
        "B10 markers": lambda: (check(win(markers.data_ptr(), outs["markers"].data_ptr(), b, h, w, 10, stream)),
                                outs["markers"])[1],
        "B11 whole filter": lambda: (check(filt(markers.data_ptr(), outs["filter"].data_ptr(), b, h * w, 64, 128,
                                                10, stream)), outs["filter"])[1],
        "B11 histogram": lambda: (check(hst(markers.data_ptr(), hout.data_ptr(), b, h * w, 64, 128, stream)),
                                  hout)[1],
        "B11 lookup": lambda: (check(keep(markers.data_ptr(), hist.data_ptr(), outs["keep"].data_ptr(), b, h * w,
                                          64, 128, 10, stream)), outs["keep"])[1],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("rm_small_variants: no CUDA device is available", file=sys.stderr)
        return 1
    from cellvit_tpu_torch.inference.cell_detection import CellSegmentationInference
    from cellvit_tpu_torch.models.cellvit import CellViT256
    from cellvit_tpu_torch.ops import cc
    from cellvit_tpu_torch.synthetic import blob_tiles, set_probe_weights

    print(f"card: {smoke.card_line()}")
    wanted = sys.argv[1:]
    libs = build({k: v for k, v in VARIANTS.items()
                  if k == "shipped" or not wanted or any(w in k for w in wanted)})
    fn = libs["shipped"].rx_max_clusters
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    print("clusters of K blocks of 1024 threads (B11's whole filter, 32 KB) the card holds at once: "
          + ", ".join(f"K {k}: {fn(k)}" for k in range(1, 17)))
    imgs, _ = blob_tiles(8, 1024, 0)
    torch.manual_seed(0)
    model = CellViT256(num_nuclei_classes=6, num_tissue_classes=19)
    set_probe_weights(model)
    infer = CellSegmentationInference(model=model, run_conf={"data": {"num_nuclei_classes": 6,
                                                                     "num_tissue_classes": 19}},
                                      mixed_precision=True, batch_size=8, device="cuda")
    inter = smoke.postproc_intermediates(infer, imgs)
    del model, infer
    torch.cuda.empty_cache()
    roots, markers = inter["roots"], inter["markers"]
    hist = cc.radix_histogram(markers)
    want = {"B10 roots": cc.remove_small_objects_window(roots, 10),
            "B10 markers": cc.remove_small_objects_window(markers, 10),
            "B11 whole filter": cc.remove_small_objects_bincount(markers, 10),
            "B11 histogram": hist, "B11 lookup": cc.radix_keep(markers, hist, 10)}
    runs = {name: callers(lib, roots, markers, hist) for name, lib in libs.items()}
    for name, ops in runs.items():
        exact = {op: torch.equal(fn(), want[op]) for op, fn in ops.items()}
        torch.cuda.synchronize()
        if VARIANTS[name][1] and not all(exact.values()):
            raise RuntimeError(f"{name} disagrees with the plain versions: {exact}")
        print(f"  {name}: exact {all(exact.values())}")
    times = {(v, op): [] for v in libs for op in want}
    for _ in range(3):
        for name, ops in runs.items():
            for op, fn in ops.items():
                times[(name, op)].append(smoke.kernel_ms(fn))
    for op in want:
        print(f"{op} (device ms a call, queued; three interleaved rounds and their median):")
        for name in libs:
            t = times[(name, op)]
            print(f"  {name}: " + ", ".join(f"{v:.5f}" for v in t) + f"; median {np.median(t):.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
