"""Time B3's and B7's ops of the port tree at ROOT on the card, for a
parent/change comparison in one call (one process per tree, each building
its own kernels):

    python3 scripts/b3_b7_ops.py [ROOT]

B3: `fill_holes_cuda` (the whole op, as postprocessing calls it) and
`flood_cuda` on `chip_smoke.py`'s (8, 1024, 1024) scan masks at `n_outer` 2.
B7: `window_attention` on `relpos_aug`'s q′/k′ of a 224×256 tile's 14×16
grid (1, 224, 16 heads, v 80) and of a batch of 8 256² tiles' 16×16 grids,
with SAM-H's tables. For each: device ms a call of launches queued back to
back (`chip_smoke.kernel_ms`), CUDA events around 20 calls as they are
enqueued (`chip_smoke.time_ms`), and the device kernels and device µs of 10
calls (`torch.profiler`). The timers and masks are this repository's.
"""

import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
sys.path.insert(0, str(root))

import torch  # noqa: E402

spec = importlib.util.spec_from_file_location("smoke", HERE / "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)


def report(name: str, fn) -> None:
    print(f"  {name}: kernel_ms {smoke.kernel_ms(fn):.4f} / {smoke.kernel_ms(fn):.4f}, CUDA events "
          f"{smoke.time_ms(fn, 20):.4f} / {smoke.time_ms(fn, 20):.4f} ms; device kernels over "
          f"{smoke.device_kernels(fn)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("b3_b7_ops: no CUDA device is available", file=sys.stderr)
        return 1
    from cellvit_tpu_torch import _build
    from cellvit_tpu_torch.ops import attention, cc_cuda
    from cellvit_tpu_torch.synthetic import blob_tiles

    if not Path(_build.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {_build.__file__}, not the tree at {root}")
    _build.build_all()
    print(f"{root}: {smoke.card_line()}")
    _, masks = blob_tiles(8, 1024, 0)
    fg = torch.from_numpy(smoke.scan_masks(masks)).cuda()
    seed, open_ = cc_cuda.border_seed(fg), ~fg
    report("B3 fill_holes_cuda", lambda: cc_cuda.fill_holes_cuda(fg, 2))
    report("B3 flood_cuda", lambda: cc_cuda.flood_cuda(seed, open_, 2))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for batch, (gh, gw) in ((1, (14, 16)), (8, (16, 16))):
        n = gh * gw
        q, k, v = torch.randn((batch, n, 3, 16, 80), generator=gen, device="cuda").to(torch.bfloat16).unbind(2)
        rh = (torch.randn((gh, gh, 80), generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        rw = (torch.randn((gw, gw, 80), generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        qa, ka = attention.relpos_aug(q, k, *attention.rel_pos_bias(q, rh, rw, (gh, gw)), (gh, gw))
        report(f"B7 window_attention ({batch}, {n}, 16, q′/k′ {qa.shape[-1]}, v 80)",
               lambda: attention.window_attention(qa, ka, v))
    return 0


if __name__ == "__main__":
    sys.exit(main())
