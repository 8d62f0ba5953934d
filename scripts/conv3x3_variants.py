"""Variant study of the bf16 channel-major 3×3 conv kernel B12
(`cellvit_tpu_torch/csrc/conv3x3_cm.cu`) on the GPU.

    python3 scripts/conv3x3_variants.py

Each variant is the shipped source with a few textual changes (its name
says which), built with the package's nvcc flags into
`cellvit_tpu_torch/build/`, and called through its C entry point at
`chip_smoke.py`'s shape, (8, 64, 1024, 1024) → 64 bf16 with bias and ReLU,
on random inputs from a seed. Each variant first runs once in a process of
its own, so that one that faults does not end the study; every variant
that is not a diagnostic must then be within `CONV_BF16_L2` of the plain
version. Times are device ms a call from CUDA events around 10 calls, in
three interleaved rounds, beside cuDNN's conv + bias + ReLU on the same
inputs.
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

SHAPE = (8, 64, 1024, 1024, 64)  # B, C, H, W, F
# textual edits of the shipped source: (old, new, occurrences)
NO_SHIFT = [("const bool shift_box = kTMA && !tma_box;", "const bool shift_box = false;", 1)]
NO_TMA_LOAD = NO_SHIFT + [("const bool tma_box = kTMA && dx == 1;", "const bool tma_box = false;", 1)]
NO_TMA_STORE = [("kTMA && leader", "false", 2), ("if (kTMA) {", "if (false) {", 3)]
NO_X = NO_TMA_LOAD + [("          if (!tma_box && !shift_box) {", "          if (false) {", 1)]
NO_MMA = [("for (int ks = 0; ks < ksteps; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {", 1)]
# each variant: its edits, and whether its results must be within the bound
# (a diagnostic that drops a step only times what remains)
VARIANTS = {
    "shipped: dx = 1 box by TMA, dx = 0 and 2 shifted from aligned chunks, TMA epilogue store": ([], True),
    "dx = 0 and 2 boxes element by element": (NO_SHIFT, True),
    "every box element by element, TMA store": (NO_TMA_LOAD, True),
    "direct epilogue stores": (NO_TMA_STORE, True),
    "no TMA for x or the output (the path of unaligned widths)": (NO_TMA_LOAD + NO_TMA_STORE, True),
    "diagnostic: no x loads": (NO_X, False),
    "diagnostic: no products": (NO_MMA, False),
}


def lib_path(i: int) -> Path:
    from cellvit_tpu_torch import _build

    return _build.BUILD_DIR / f"conv_variant_{i}.so"


def build() -> None:
    from cellvit_tpu_torch import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    shipped = (_build.CSRC / "conv3x3_cm.cu").read_text()
    procs = {}
    for i, (name, (edits, _)) in enumerate(VARIANTS.items()):
        text = shipped
        for old, new, n in edits:
            if text.count(old) != n:
                raise RuntimeError(f"{name}: patch does not apply: {old!r}")
            text = text.replace(old, new)
        cu = lib_path(i).with_suffix(".cu")
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib_path(i)), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        print(f"  built {name}: spills {smoke.ptxas_spills(text)}")


def inputs():
    from cellvit_tpu_torch.ops import conv_cm

    b, c, h, w, f = SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((b, c, h, w), generator=g, device="cuda").to(torch.bfloat16)
    wt = (torch.randn((3, 3, c, f), generator=g, device="cuda") * c**-0.5).to(torch.bfloat16)
    bias = torch.randn(f, generator=g, device="cuda")
    return x, wt, bias, conv_cm.pack_kernel_tiles(wt)


def caller(lib, x, wk, bias, f):
    fn = lib.conv3x3_cm_bf16
    fn.argtypes, fn.restype = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p], ctypes.c_int
    b, c, h, w = x.shape
    out = torch.empty((b, f, h, w), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(x.data_ptr(), wk.data_ptr(), bias.data_ptr(), 0, out.data_ptr(), b, c, h, w, f,
                 wk.shape[0] * 64, 0, 0, 1, stream)
        if err:
            raise RuntimeError(f"cudaError_t {err}")
        return out

    return run


def check_one(i: int) -> int:
    """Run variant i once and print its relative L2 to the plain version."""
    from cellvit_tpu_torch.ops import conv_cm

    x, wt, bias, wk = inputs()
    out = caller(ctypes.CDLL(str(lib_path(i))), x, wk, bias, SHAPE[4])()
    torch.cuda.synchronize()
    ref = conv_cm.conv3x3_cm_reference(x, wt, bias, relu=True)
    print(((out.float() - ref.float()).norm() / ref.float().norm()).item())
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("conv3x3_variants: no CUDA device is available", file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    from cellvit_tpu_torch.ops import conv_cm

    print(f"card: {smoke.card_line()}; shape (B, C, H, W) → F {SHAPE}")
    build()
    usable = []
    for i, (name, (_, exact)) in enumerate(VARIANTS.items()):
        r = subprocess.run([sys.executable, __file__, "--check", str(i)], capture_output=True, text=True,
                           timeout=300)
        if r.returncode != 0:
            print(f"  {name}: FAILED: {(r.stderr.strip().splitlines() or ['?'])[-1][:200]}")
            continue
        rel = float(r.stdout.strip().splitlines()[-1])
        ok = rel <= conv_cm.CONV_BF16_L2
        print(f"  {name}: relative L2 to the plain version {rel:.3e} (bound {conv_cm.CONV_BF16_L2:g})")
        if exact and not ok:
            raise RuntimeError(f"{name} disagrees with the plain version")
        usable.append((i, name))
    x, wt, bias, wk = inputs()
    runs = {name: caller(ctypes.CDLL(str(lib_path(i))), x, wk, bias, SHAPE[4]) for i, name in usable}
    w_oihw = wt.permute(3, 2, 0, 1).contiguous()
    runs["cuDNN conv + bias, ReLU (library yardstick)"] = lambda: F.relu(F.conv2d(x, w_oihw, bias.to(x.dtype),
                                                                                   padding=1))
    times = {name: [] for name in runs}
    for _ in range(3):
        for name, run in runs.items():
            times[name].append(smoke.time_ms(run, 10))
    b, c, h, w, f = SHAPE
    bound = smoke.bound_ms(2 * (b * c * h * w + b * f * h * w), 2.0 * b * h * w * f * 9 * c)
    print(f"device ms a call, three interleaved rounds (bound {bound[0]:.4f} ms by {bound[1]}):")
    for name, t in times.items():
        print(f"  {name}: " + ", ".join(f"{v:.4f}" for v in t) + f"; median {np.median(t):.4f}")
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--check":
        sys.exit(check_one(int(sys.argv[2])))
    sys.exit(main())
