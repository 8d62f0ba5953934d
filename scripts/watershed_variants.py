"""Variant study of the sweep watershed kernel B9
(`cellvit_tpu_torch/csrc/watershed.cu`) on the GPU.

    python3 scripts/watershed_variants.py

Each variant is the shipped source with a few textual changes (its name
says which), built with the package's nvcc flags into
`cellvit_tpu_torch/build/` and called through its C entry point. The
inputs are `chip_smoke.py`'s two regimes on 8 × 1024² blob tiles: the
CellViT-256 main path's relief, marker labels and blob mask (a full-width
model with probe weights), and point-seeded floods of the tiles' discs.
Every variant that is not a diagnostic must be pixel-equal, with equal pass
counts, to the plain sweep. Times are device ms a call from CUDA events
around 10 back-to-back calls (the host enqueues a call in far less than
its device time), in three interleaved rounds; the relief's quantization
(torch ops, the same for every variant) is timed apart.
"""

from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

spec = importlib.util.spec_from_file_location("smoke", ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)


def tile(th: int, tw: int, threads: int, per_sm: int):
    return [("constexpr int TH8 = 256, TW = 256;", f"constexpr int TH8 = {th}, TW = {tw};"),
            ("constexpr int THREADS = 1024;", f"constexpr int THREADS = {threads};"),
            ("__launch_bounds__(THREADS, 1)", f"__launch_bounds__(THREADS, {per_sm})")]


# every bit of every word through the per-pixel loop, and no early end of a
# phase without candidates
NO_SKIP = [("""      if (cand) {
        uint32_t d0 = s.d0[w], d1 = s.d1[w];
        for (uint32_t m = cand; m; m &= m - 1) {
          const int i = __ffs(m) - 1;
""", """      {
        any = true;
        uint32_t d0 = s.d0[w], d1 = s.d1[w];
        for (int i = 0; i < 32; ++i) {
          if (!((cand >> i) & 1u)) continue;
"""), ("    if (!(v & 1u)) break;  // no candidate: every later pass of the phase changes nothing\n", "")]
# one launch a phase: a block a tile, the phases ordered by the launches
PHASED = [("// Co-resident blocks of one instantiation", """template <class QT>
__global__ void __launch_bounds__(THREADS, 1) ws_init_kernel(Args a) {
  const int b = blockIdx.y, t = blockIdx.x;
  if (t == 0)
    for (int i = threadIdx.x; i < a.NSTAB; i += THREADS) a.flags[(size_t)b * a.NSTAB + i] = 0;
  init_tile<QT>(a, b, t / a.TX, t % a.TX);
}

template <class QT>
__global__ void __launch_bounds__(THREADS, 1) ws_phase_kernel(Args a, int phi) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem<QT>& s = *reinterpret_cast<Smem<QT>*>(smem);
  const int b = blockIdx.y, t = blockIdx.x;
  int count = 0;
  const int st = phase_status(a, b, phi, &count);
  if (st == 0 && t == 0 && threadIdx.x == 0) a.passes[b] = count;
  if (st != 1) return;
  run_tile_phase<QT>(a, s, b, t / a.TX, t % a.TX, phi, true);
}

// Co-resident blocks of one instantiation"""), ("""  Args a = a0;
  const int NT = a.TY * a.TX;
""", """  Args a = a0;
  const int NT = a.TY * a.TX;
  {
    cudaError_t e = cudaFuncSetAttribute(ws_phase_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)sizeof(Smem<QT>));
    if (e != cudaSuccess) return e;
    const dim3 grid(NT, a.B);
    ws_init_kernel<QT><<<grid, THREADS, 0, stream>>>(a);
    for (int phi = 0; phi <= a.NS + a.NSTAB; ++phi)
      ws_phase_kernel<QT><<<grid, THREADS, sizeof(Smem<QT>), stream>>>(a, phi);
    (void)sync;
    return cudaGetLastError();
  }
""")]
NO_RESOLVE = [("for (uint32_t m = L[w] & ~s.l0[w]; m; m &= m - 1) {", "for (uint32_t m = 0u; m; m &= m - 1) {")]
NO_PASS = [("    for (int k = 0; k < WPT; ++k) {\n", "    for (int k = 0; k < 0; ++k) {\n"),
           ("    if (!(v & 1u)) break;  // no candidate: every later pass of the phase changes nothing\n", "")]

# each variant: textual edits of the shipped source, and whether its results
# must be exact (a diagnostic that drops a step only times what remains)
VARIANTS = {
    "shipped: 256 × 256 tiles, 1024 threads, K 16, candidate skip, one persistent launch": ([], True),
    "K 8": ([("constexpr int K = 16;", "constexpr int K = 8;")], True),
    "K 32": ([("constexpr int K = 16;", "constexpr int K = 32;")], True),
    "128 × 256 tiles, 512 threads, 2 blocks an SM": (tile(128, 256, 512, 2), True),
    "128 × 128 tiles, 256 threads, 4 blocks an SM": (tile(128, 128, 256, 4), True),
    "256 × 128 tiles, 512 threads, 2 blocks an SM": (tile(256, 128, 512, 2), True),
    "no candidate skip": (NO_SKIP, True),
    "one launch a phase of K passes": (PHASED, True),
    "diagnostic: no label resolution": (NO_RESOLVE, False),
    "diagnostic: passes that only meet at the barrier (pass-latency floor)": (NO_PASS, False),
}


def build(variants: dict) -> dict:
    """One nvcc a variant, all at once. Returns {name: loaded library}."""
    from cellvit_tpu_torch import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    shipped = (_build.CSRC / "watershed.cu").read_text()
    procs = {}
    for i, (name, (edits, _)) in enumerate(variants.items()):
        text = shipped
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: patch does not apply: {old[:60]!r}")
            text = text.replace(old, new)
        cu = _build.BUILD_DIR / f"ws_variant_{i}.cu"
        cu.write_text(text)
        out = cu.with_suffix(".so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        spills = smoke.ptxas_spills(text)
        print(f"  built {name}: spills {spills}; "
              + " | ".join(ln.strip() for ln in text.splitlines() if "registers" in ln))
        libs[name] = ctypes.CDLL(str(out))
    return libs


def caller(lib, image, markers, mask, levels=64, inner=4, cap=512):
    """fn() → (labels, passes) of one variant on the regime's inputs; the
    quantization happens once, here."""
    from cellvit_tpu_torch.ops import cc_cuda
    from cellvit_tpu_torch.ops import watershed as ws

    mask = mask.to(torch.bool).contiguous()
    q = ws.quantize(image, mask, levels).contiguous()
    markers = markers.to(torch.int32).contiguous()
    b, h, w = image.shape
    size = lib.watershed_workspace_words
    size.argtypes, size.restype = [ctypes.c_int] * 5, ctypes.c_longlong
    fn = lib.watershed_sweep
    fn.argtypes, fn.restype = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p], ctypes.c_int
    work = torch.empty(size(b, h, w, levels, cap), dtype=torch.int32, device=image.device)
    lab = torch.empty((b, h, w), dtype=torch.int32, device=image.device)
    passes = torch.empty(b, dtype=torch.int32, device=image.device)
    sync, stream = cc_cuda._sync_words(image)

    def run():
        err = fn(q.data_ptr(), mask.data_ptr(), markers.data_ptr(), lab.data_ptr(), work.data_ptr(),
                 sync.data_ptr(), passes.data_ptr(), b, h, w, levels, inner, cap, stream)
        if err:
            raise RuntimeError(f"cudaError_t {err}")
        return lab, passes

    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("watershed_variants: no CUDA device is available", file=sys.stderr)
        return 1
    import numpy as np

    from cellvit_tpu_torch.inference.cell_detection import CellSegmentationInference
    from cellvit_tpu_torch.models.cellvit import CellViT256
    from cellvit_tpu_torch.ops import watershed as ws
    from cellvit_tpu_torch.synthetic import blob_tiles, set_probe_weights

    print(f"card: {smoke.card_line()}")
    libs = build(VARIANTS)
    imgs, masks = blob_tiles(8, 1024, 0)
    torch.manual_seed(0)
    model = CellViT256(num_nuclei_classes=6, num_tissue_classes=19)
    set_probe_weights(model)
    infer = CellSegmentationInference(model=model, run_conf={"data": {"num_nuclei_classes": 6,
                                                                     "num_tissue_classes": 19}},
                                      mixed_precision=True, batch_size=8, device="cuda")
    inter = smoke.postproc_intermediates(infer, imgs)
    del model, infer
    relief, marks = smoke.point_seeded_floods(masks, 0)
    regimes = {
        "main path": (inter["dist"], inter["marker_lab"], inter["blb"]),
        "point-seeded": (torch.from_numpy(relief).cuda(), torch.from_numpy(marks).cuda(),
                         torch.from_numpy(masks).cuda()),
    }
    times = {(r, v): [] for r in regimes for v in VARIANTS}
    for rname, args in regimes.items():
        plab, ppasses = ws.watershed(*args, max_final_iters=512, schedule="sweep", return_passes=True)
        q_ms = smoke.time_ms(lambda: ws.quantize(args[0], args[2].bool(), 64), 10)
        print(f"{rname}: plain passes {ppasses.tolist()}; quantization (torch) {q_ms:.4f} ms a call")
        runs = {name: caller(lib, *args) for name, lib in libs.items()}
        for name, run in runs.items():
            lab, passes = run()
            torch.cuda.synchronize()
            exact = torch.equal(lab, plab) and torch.equal(passes, ppasses)
            if VARIANTS[name][1] and not exact:
                raise RuntimeError(f"{name} disagrees with the plain sweep on {rname}: "
                                   f"{int((lab != plab).sum())} px, passes {passes.tolist()}")
            print(f"  {name}: exact {exact}")
        for _ in range(3):
            for name, run in runs.items():
                times[(rname, name)].append(smoke.time_ms(run, 10))
    for rname in regimes:
        print(f"{rname} (device ms a call, three interleaved rounds):")
        for name in VARIANTS:
            t = times[(rname, name)]
            print(f"  {name}: " + ", ".join(f"{v:.4f}" for v in t) + f"; median {np.median(t):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
