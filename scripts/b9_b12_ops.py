"""Time B9's and B12's ops of the port tree at ROOT on the card, for a
parent/change comparison in one call (one process per tree, each building
its own kernels):

    python3 scripts/b9_b12_ops.py [ROOT]

B9: `watershed_cuda` (levels 64, inner 4, cap 512) on `chip_smoke.py`'s
point-seeded floods of the 8 × 1024² blob tiles; the kernel alone is the op
less the quantization, which is timed apart (torch ops, the same in both
trees). B12: `conv3x3_cm` at (8, 64, 1024, 1024) → 64 bf16 with bias and
ReLU, and with a 3·64-channel residual's block 1, on random inputs from a
seed, beside cuDNN's conv + bias + ReLU. For each: device ms a call of
launches queued back to back (`chip_smoke.kernel_ms`), CUDA events around
10 calls as they are enqueued (`chip_smoke.time_ms`), and the device
kernels and device µs of 10 calls (`torch.profiler`). The timers and inputs
are this repository's.
"""

import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
sys.path.insert(0, str(root))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

spec = importlib.util.spec_from_file_location("smoke", HERE / "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)


def report(name: str, fn) -> None:
    print(f"  {name}: kernel_ms {smoke.kernel_ms(fn, 10):.4f} / {smoke.kernel_ms(fn, 10):.4f}, CUDA events "
          f"{smoke.time_ms(fn, 10):.4f} / {smoke.time_ms(fn, 10):.4f} ms; device kernels over "
          f"{smoke.device_kernels(fn)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("b9_b12_ops: no CUDA device is available", file=sys.stderr)
        return 1
    from cellvit_tpu_torch import _build
    from cellvit_tpu_torch.ops import cc_cuda, conv_cm
    from cellvit_tpu_torch.ops.watershed import quantize
    from cellvit_tpu_torch.synthetic import blob_tiles

    if not Path(_build.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {_build.__file__}, not the tree at {root}")
    _build.build_all()
    print(f"{root}: {smoke.card_line()}")
    _, masks = blob_tiles(8, 1024, 0)
    relief, marks = smoke.point_seeded_floods(masks, 0)
    img, mark, mask = (torch.from_numpy(a).cuda() for a in (relief, marks, masks))
    report("B9 watershed_cuda (quantization + kernel)", lambda: cc_cuda.watershed_cuda(img, mark, mask))
    print(f"  B9 quantization alone: {smoke.time_ms(lambda: quantize(img, mask, 64), 10):.4f} ms")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((8, 64, 1024, 1024), generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn((3, 3, 64, 64), generator=g, device="cuda") * 0.125).to(torch.bfloat16)
    b = torch.randn(64, generator=g, device="cuda")
    res = torch.randn((8, 192, 1024, 1024), generator=g, device="cuda").to(torch.bfloat16)
    report("B12 conv3x3_cm, bias + ReLU", lambda: conv_cm.conv3x3_cm(x, w, b, relu=True))
    report("B12 conv3x3_cm, + res block 1", lambda: conv_cm.conv3x3_cm(x, w, b, relu=True, res=res, res_block=1))
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    print(f"  cuDNN conv + bias, ReLU: {smoke.time_ms(lambda: F.relu(F.conv2d(x, w_oihw, b.to(x.dtype), padding=1)), 10):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
