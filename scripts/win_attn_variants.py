"""Variant study of the whole-window attention kernel B7
(`cellvit_tpu_torch/csrc/win_attn.cu`) on the GPU.

    python3 scripts/win_attn_variants.py

Each variant is the shipped source with a few textual changes (its name says
which), built with the package's nvcc flags into `cellvit_tpu_torch/build/`
(`scripts/flood_bits_variants.py`'s `build`), called through its C entry
point on `relpos_aug`'s q′/k′ with SAM-H's tables (16 heads of 80) at a
224×256 tile's 14×16 grid (1, 224) and a batch of 8 256² tiles' 16×16
grids (8, 256), held to `window_attention_plain` within `WINDOW_BOUNDS`,
and timed: device µs per call from `torch.profiler` over 20 calls, in three
rounds that visit every variant in turn.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

from flood_bits_variants import build, timed_rounds  # noqa: E402

TWO = [("constexpr int NWG = 1;", "constexpr int NWG = 2;")]
V_BESIDE_K = [("constexpr bool V_AFTER_S = true;", "constexpr bool V_AFTER_S = false;")]

VARIANTS = {
    "shipped: one warpgroup a block, v loaded into k′'s tiles after S (two blocks an SM)": [],
    "one warpgroup a block, v loaded beside k′ at the start": V_BESIDE_K,
    "two warpgroups a block, v loaded into k′'s tiles after S": TWO,
    "two warpgroups a block, v loaded beside k′ at the start": TWO + V_BESIDE_K,
}


def main() -> int:
    if not torch.cuda.is_available():
        print("win_attn_variants: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from cellvit_tpu_torch import _build
    from cellvit_tpu_torch.ops import attention

    print(f"card: {chip_smoke.card_line()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for batch, (gh, gw) in ((1, (14, 16)), (8, (16, 16))):
        n = gh * gw
        q, k, v = torch.randn((batch, n, 3, 16, 80), generator=gen, device="cuda").to(torch.bfloat16).unbind(2)
        rh = (torch.randn((gh, gh, 80), generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        rw = (torch.randn((gw, gw, 80), generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        qa, ka = attention.relpos_aug(q, k, *attention.rel_pos_bias(q, rh, rw, (gh, gw)), (gh, gw))
        cases.append((f"({batch}, {n})", qa, ka, v, attention.window_attention_plain(qa, ka, v)))
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    runs = {}
    for name, edits in VARIANTS.items():
        lib, log = build(name, edits, _build.CSRC / "win_attn.cu", _build.NVCC_FLAGS, _build._nvcc(),
                         _build.BUILD_DIR)
        if lib is None:
            print(f"{name}: build failed\n{log}")
            return 1
        fn = lib.win_attn_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
        runs[name] = {}
        for label, qa, ka, v, ref in cases:
            b, n, h, dqk = qa.shape
            o = torch.empty((b, n, h, v.shape[-1]), dtype=v.dtype, device=v.device)

            def run(fn=fn, qa=qa, ka=ka, v=v, o=o, b=b, n=n, h=h, dqk=dqk, name=name):
                _build.check(fn(qa.data_ptr(), ka.data_ptr(), v.data_ptr(), o.data_ptr(), b, n, h, dqk,
                                v.shape[-1], *qa.stride()[:3], *ka.stride()[:3], *v.stride()[:3],
                                _build.stream_of(v)), name)

            run()
            torch.cuda.synchronize()
            errs = attention.attn_errors(o, ref)
            if not attention.within(errs, attention.WINDOW_BOUNDS):
                print(f"{name} {label}: disagrees {errs}")
                return 1
            runs[name][label] = run
    for name, times in timed_rounds(runs).items():
        print(f"{name}: within WINDOW_BOUNDS; device µs a call in 3 rounds: "
              + ", ".join(f"{label} " + " / ".join(f"{t:.2f}" for t in ts) for label, ts in times.items()))
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
