"""Time the size filters' ops, B10 and B11, of the port tree at ROOT on the
card, for a parent/change comparison in one call (one process per tree,
each building its own kernels):

    python3 scripts/rm_small_ops.py [ROOT]

The inputs are `chip_smoke.py`'s: the root labels and compacted markers of
a full-width CellViT-256 batch of 8 × 1024² blob tiles (probe weights,
`chip_smoke.postproc_intermediates`). B10: `remove_small_objects_cuda` at
min_size 10 on both. B11: `remove_small_objects_bincount_cuda` (the whole
op) at min_size 10 and 64, `radix_histogram_cuda` and `radix_keep_cuda`
at min_size 10, on the markers. Each op's output is held against its plain
version, exactly. For each: device ms a call of launches queued back to
back behind a spin kernel (`chip_smoke.kernel_ms`, two readings), CUDA
events around 20 calls as the host enqueues them (`chip_smoke.time_ms`),
host µs a call (`chip_smoke.host_us`) and the device kernels and device µs
of 10 calls (`torch.profiler`). The build prints the ptxas report and the
spills of `rm_small.cu`. The timers and inputs are this repository's.
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
    print(f"  {name}: kernel_ms {smoke.kernel_ms(fn):.5f} / {smoke.kernel_ms(fn):.5f}; CUDA events "
          f"{smoke.time_ms(fn, 20):.5f} ms; host µs a call {smoke.host_us(fn):.1f}; device kernels over "
          f"{smoke.device_kernels(fn)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("rm_small_ops: no CUDA device is available", file=sys.stderr)
        return 1
    from cellvit_tpu_torch import _build
    from cellvit_tpu_torch.inference.cell_detection import CellSegmentationInference
    from cellvit_tpu_torch.models.cellvit import CellViT256
    from cellvit_tpu_torch.ops import cc, cc_cuda
    from cellvit_tpu_torch.synthetic import blob_tiles, set_probe_weights

    if not Path(_build.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {_build.__file__}, not the tree at {root}")
    report_ = _build.build_all(["rm_small.cu"])
    _build.build_all()
    print(f"{root}: {smoke.card_line()}")
    if "rm_small.cu" in report_:
        text = report_["rm_small.cu"][1]
        print("  rm_small.cu ptxas: " + " | ".join(ln.strip() for ln in text.splitlines()
                                                    if "registers" in ln or "spill" in ln))
        print(f"  rm_small.cu spill bytes (stores, loads): {smoke.ptxas_spills(text)}")
    imgs, _ = blob_tiles(8, 1024, 0)
    torch.manual_seed(0)
    model = CellViT256(num_nuclei_classes=6, num_tissue_classes=19)
    set_probe_weights(model)
    infer = CellSegmentationInference(
        model=model, run_conf={"data": {"num_nuclei_classes": 6, "num_tissue_classes": 19}},
        mixed_precision=True, batch_size=8, device="cuda")
    inter = smoke.postproc_intermediates(infer, imgs)
    del model, infer
    torch.cuda.empty_cache()
    roots, markers = inter["roots"], inter["markers"]
    n_ids = int(markers[markers < cc_cuda.INT_MAX].max())
    print(f"  inputs {tuple(roots.shape)}: labelled px {int((roots > 0).sum())} (roots), "
          f"{int((markers > 0).sum())} (markers, largest id below INT_MAX {n_ids})")
    checks = {
        "B10 roots": (cc_cuda.remove_small_objects_cuda(roots, 10), cc.remove_small_objects_window(roots, 10)),
        "B10 markers": (cc_cuda.remove_small_objects_cuda(markers, 10),
                        cc.remove_small_objects_window(markers, 10)),
        "B11 histogram": (cc_cuda.radix_histogram_cuda(markers), cc.radix_histogram(markers)),
        "B11 keep 10": (cc_cuda.radix_keep_cuda(markers, cc.radix_histogram(markers), 10),
                        cc.radix_keep(markers, cc.radix_histogram(markers), 10)),
    }
    for ms in (10, 64):
        checks[f"B11 whole op {ms}"] = (cc_cuda.remove_small_objects_bincount_cuda(markers, ms),
                                        cc.remove_small_objects_bincount(markers, ms))
    bad = [k for k, (a, b) in checks.items() if not torch.equal(a, b)]
    print(f"  exact against the plain versions: {'all' if not bad else 'NOT ' + ', '.join(bad)}")
    hist = cc_cuda.radix_histogram_cuda(markers)
    ops = {
        "B10 remove_small_objects_cuda, roots, min_size 10": lambda: cc_cuda.remove_small_objects_cuda(roots, 10),
        "B10 remove_small_objects_cuda, markers, min_size 10":
            lambda: cc_cuda.remove_small_objects_cuda(markers, 10),
        "B11 remove_small_objects_bincount_cuda, min_size 10":
            lambda: cc_cuda.remove_small_objects_bincount_cuda(markers, 10),
        "B11 remove_small_objects_bincount_cuda, min_size 64":
            lambda: cc_cuda.remove_small_objects_bincount_cuda(markers, 64),
        "B11 radix_histogram_cuda": lambda: cc_cuda.radix_histogram_cuda(markers),
        "B11 radix_keep_cuda, min_size 10": lambda: cc_cuda.radix_keep_cuda(markers, hist, 10),
    }
    for name, fn in ops.items():
        report(name, fn)
    n_px = roots.numel()
    print(f"  bounds (bytes / 3.35 TB/s): B10 {smoke.bound_ms(8 * n_px)[0]:.5f}, whole B11 op "
          f"{smoke.bound_ms(8 * n_px)[0]:.5f}, histogram {smoke.bound_ms(4 * n_px + 4 * hist.numel())[0]:.5f}, "
          f"keep {smoke.bound_ms(8 * n_px + 4 * hist.numel())[0]:.5f} ms")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
