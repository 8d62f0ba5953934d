"""Variant study of the resident-tile kernel of B2 and B4
(`cellvit_tpu_torch/csrc/seg_min.cu`) on the GPU.

    python3 scripts/seg_min_variants.py

Each variant is the shipped source with a few textual changes (its name says
which), built with the package's nvcc flags into `cellvit_tpu_torch/build/`, called through its C
entry points with a workspace for tiles down to 64², held bit-equal to the plain
versions, then timed at (8, 1024, 1024): B2 at `n_outer` 3 and 0 (the load
and store alone), B4 at 3. Times are device time per call from
`torch.profiler` over 20 calls, so host time does not enter them. The
shipped kernel is also timed as the wrappers run it, with CUDA events around
20 back-to-back calls, which the host's enqueue rate can bound.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent

# each variant: textual edits of the shipped source, and whether its results
# must be exact (a diagnostic that drops a step only times what remains)
FENCED_BARRIER = [("""    unsigned old;
    asm volatile("atom.add.release.gpu.global.u32 %0, [%1], 1;" : "=r"(old) : "l"(arrive) : "memory");""",
                   """    __threadfence();
    const unsigned old = atomicAdd(arrive, 1u);"""),
                  ("""      if (++n == POLL_LIMIT) __trap();
  }""", """      if (++n == POLL_LIMIT) __trap();
    __threadfence();
  }""")]
# the chunk's run minima kept in registers across the barrier, every pixel
# rewritten after it
REGISTER_FIXUP = [("""#pragma unroll
    for (int i = 0; i < CH; ++i) s.v[base + i * STEP] = v[u][i];
    s.head[c] = v[u][0];""", """    s.head[c] = v[u][0];"""),
                  ("""    for (int i = 0; i < n_first; ++i) s.v[base + i * STEP] = min(s.v[base + i * STEP], cl);
    for (int i = CH - n_last; i < CH; ++i) s.v[base + i * STEP] = min(s.v[base + i * STEP], cr);""",
                   """#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int32_t c = min(i < n_first ? cl : INT_MAX, i >= CH - n_last ? cr : INT_MAX);
      s.v[base + i * STEP] = min(v[u][i], c);
    }""")]
THREADS_512 = [("constexpr int THREADS = 1024;", "constexpr int THREADS = 512;")]
# B4's seeds loaded through registers beside the mask bytes, then stored
SEED_REGISTERS = [("""    int8_t f[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const bool in = y0 + kb * CH + i < H && x < W;
      if (kSeed && in) cp_async4(&s.v[(kb * CH + i) * STRIDE + col], seed + row0 + (size_t)i * W);
      f[i] = in ? fg[row0 + (size_t)i * W] : 0;
    }
    if (kSeed) asm volatile("cp.async.wait_all;" ::: "memory");""", """    int8_t f[CH];
    int32_t sd[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const bool in = y0 + kb * CH + i < H && x < W;
      f[i] = in ? fg[row0 + (size_t)i * W] : 0;
      sd[i] = kSeed && in ? seed[row0 + (size_t)i * W] : 0;
    }"""), ("""      if (!open) s.v[r * STRIDE + col] = INT_MAX;
      else if (!kSeed) s.v[r * STRIDE + col] = (y0 + r) * W + x;""",
        """      s.v[r * STRIDE + col] = !open ? INT_MAX : kSeed ? sd[i] : (y0 + r) * W + x;""")]
TILE_128 = [("constexpr int TC = 256;", "constexpr int TC = 128;"),
            ("constexpr int THREADS = 1024;", "constexpr int THREADS = 512;"),
            ("constexpr int MAX_TX = 8;", "constexpr int MAX_TX = 16;"),
            ("__launch_bounds__(THREADS, 1)", "__launch_bounds__(THREADS, 2)")]
NO_BARRIER = [("  group_barrier(arrive, T);\n", "  __syncthreads();\n")]

VARIANTS = {
    "shipped": ([], True),
    "first version: 512 threads, two chunks each in registers across the barrier, fenced atomic":
        (THREADS_512 + REGISTER_FIXUP + FENCED_BARRIER, True),
    "fenced relaxed atomic in the barrier": (FENCED_BARRIER, True),
    "chunk in registers across the barrier": (REGISTER_FIXUP, True),
    "B4's seeds through registers": (SEED_REGISTERS, True),
    "128 x 128 tiles, 512 threads, two blocks an SM": (TILE_128, True),
    "diagnostic: no barrier among the tiles (results wrong)": (NO_BARRIER, False),
}


def build(name: str, edits, src: Path, nvcc_flags, nvcc: str, out_dir: Path):
    text = src.read_text()
    for old, new in edits:
        if old not in text:
            return None, f"{name}: patch does not apply"
        text = text.replace(old, new)
    tag = "".join(ch if ch.isalnum() else "_" for ch in name)
    cu = out_dir / f"seg_min_variant_{tag}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(text)
    res = subprocess.run([nvcc, *nvcc_flags, "-o", str(so), str(cu)], capture_output=True, text=True)
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


def event_us(fn, calls: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("seg_min_variants: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from cellvit_tpu_torch import _build
    from cellvit_tpu_torch.ops import cc_cuda

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    rng = np.random.default_rng(0)
    m = rng.random((8, 1024, 1024)) < 0.55
    m[0, 100:400, 100:110] = m[0, 390:400, 100:400] = m[0, 100:400, 390:400] = True
    m[7] = True  # one run across every tile
    fg = torch.from_numpy(m).cuda()
    seed = torch.from_numpy(rng.integers(-2**31, 2**31, m.shape, dtype=np.int64).astype(np.int32)).cuda()
    want_lab = cc_cuda.connected_components_plain(fg, 3)
    want_pm = cc_cuda.propagate_min_plain(seed, fg, 3)
    _, sync, stream = cc_cuda._resident_scratch(fg)
    b, h, w = fg.shape
    ws = torch.empty(b * (w * -(-h // 64) + h * -(-w // 64)) * 4, dtype=torch.int32, device=fg.device)
    lab, pm = torch.empty_like(want_lab), torch.empty_like(want_pm)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    shipped = (lambda: cc_cuda.connected_components_cuda(fg, 3),
               lambda: cc_cuda.propagate_min_cuda(seed, fg, 3))
    print(f"shipped, through the wrappers: B2 {event_us(shipped[0]):.1f} / {event_us(shipped[0]):.1f} µs, "
          f"B4 {event_us(shipped[1]):.1f} / {event_us(shipped[1]):.1f} µs a call (CUDA events, 20 calls)")
    for name, (edits, must_be_exact) in VARIANTS.items():
        lib, log = build(name, edits, _build.CSRC / "seg_min.cu", _build.NVCC_FLAGS, _build._nvcc(),
                         _build.BUILD_DIR)
        if lib is None:
            print(f"{name}: build failed\n{log}")
            continue
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln or "registers" in ln]
        cc, pmin = lib.cc_labels, lib.propagate_min
        cc.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        pmin.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

        def run_cc(n_outer=3):
            _build.check(cc(fg.data_ptr(), lab.data_ptr(), sync.data_ptr(), ws.data_ptr(), b, h, w, n_outer,
                            stream), name)

        def run_pm():
            _build.check(pmin(seed.data_ptr(), fg.data_ptr(), pm.data_ptr(), sync.data_ptr(), ws.data_ptr(),
                              b, h, w, 3, stream), name)

        run_cc()
        run_pm()
        torch.cuda.synchronize()
        exact = torch.equal(lab, want_lab) and torch.equal(pm, want_pm)
        times = [(device_us(run_cc), device_us(lambda: run_cc(0)), device_us(run_pm)) for _ in range(2)]
        print(f"{name}: exact {exact}; device µs a call, two runs: B2 "
              + " / ".join(f"{t[0]:.1f}" for t in times) + ", B2 load and store only "
              + " / ".join(f"{t[1]:.1f}" for t in times) + ", B4 "
              + " / ".join(f"{t[2]:.1f}" for t in times) + "; " + " | ".join(spills))
        if must_be_exact and not exact:
            return 1
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
