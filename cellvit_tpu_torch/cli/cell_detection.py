"""WSI cell-detection CLI (port of `cellvit_tpu/cli/cell_detection.py`; the
reference `cell_segmentation/inference/cell_detection.py:906-1069`:
InferenceWSIParser with `process_wsi` / `process_dataset` subcommands).

Usage:
  python -m cellvit_tpu_torch.cli.cell_detection --model ckpt.pth [--geojson] \\
      process_wsi --wsi_path slide.svs --patched_slide_path pre/slide
  python -m cellvit_tpu_torch.cli.cell_detection --model ckpt.pth \\
      process_dataset --wsi_paths dir/ --patch_dataset_path pre/ \\
      [--filelist list.csv]

Runs on the GPU (`--device cuda`, the default; `--gpu N` picks `cuda:N`)
unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="Perform CellViT inference for given run-directory with "
        "model checkpoints and logs",
    )
    parser.add_argument("--model", type=str, help="Model checkpoint (.pth) or run dir", required=True)
    parser.add_argument("--gpu", type=int, default=0, help="CUDA device index (with --device cuda)")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                        help="run on the GPU or on the CPU")
    parser.add_argument("--magnification", type=float, default=40)
    parser.add_argument("--enforce_amp", action="store_true", help="Run inference in bf16")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--outdir_subdir", type=str, default=None)
    parser.add_argument("--geojson", action="store_true")
    # patch geometry: 1024/64 is the reference cell_detection.py pipeline,
    # 256/64 the reference cell_detection_256.py pipeline
    parser.add_argument("--patch_size", type=int, default=1024, choices=(256, 1024))
    parser.add_argument("--overlap", type=int, default=64)
    parser.add_argument(
        "--profile", type=str, default=None, metavar="DIR",
        help="write a torch.profiler trace of each WSI run to DIR "
        "(per-stage wall timings are always logged + saved to timings.json)",
    )

    subparsers = parser.add_subparsers(dest="command", required=True)

    single = subparsers.add_parser("process_wsi", description="Process a single WSI file")
    single.add_argument("--wsi_path", type=str, required=True)
    single.add_argument("--patched_slide_path", type=str, required=True)

    multi = subparsers.add_parser("process_dataset", description="Process a whole dataset")
    multi.add_argument("--wsi_paths", type=str, required=True)
    multi.add_argument("--patch_dataset_path", type=str, required=True)
    multi.add_argument("--filelist", type=str, default=None)
    multi.add_argument("--wsi_extension", type=str, default="svs")
    return parser


def main(argv: Optional[List[str]] = None):
    """Run the CLI on `argv` (default: the command line). Returns the
    `CellSegmentationInference` it ran, for callers in the same process."""
    from cellvit_tpu_torch.data.wsi import WSI
    from cellvit_tpu_torch.inference.cell_detection import CellSegmentationInference

    args = build_parser().parse_args(argv)
    model_arg = Path(args.model)
    device = f"cuda:{args.gpu}" if args.device == "cuda" else "cpu"
    kwargs = dict(batch_size=args.batch_size, mixed_precision=args.enforce_amp, device=device)
    if model_arg.is_dir():
        inference = CellSegmentationInference(run_dir=model_arg, **kwargs)
    else:
        inference = CellSegmentationInference(model_path=model_arg, **kwargs)

    def run_one(wsi_path: Path, patched: Path) -> None:
        wsi = WSI(
            name=wsi_path.stem, patient=wsi_path.stem, slide_path=wsi_path,
            patched_slide_path=patched,
        )
        inference.check_wsi(
            wsi, magnification=args.magnification,
            patch_size=args.patch_size, overlap=args.overlap,
        )
        inference.process_wsi(
            wsi, subdir_name=args.outdir_subdir, geojson=args.geojson,
            magnification=args.magnification,
            patch_size=args.patch_size, overlap=args.overlap,
            profile_dir=Path(args.profile) if args.profile else None,
        )

    if args.command == "process_wsi":
        run_one(Path(args.wsi_path), Path(args.patched_slide_path))
    else:
        wsi_root = Path(args.wsi_paths)
        patch_root = Path(args.patch_dataset_path)
        if args.filelist:
            # reference utils/file_handling.py:7-21: read the named
            # "Filename" column and filter by extension
            with open(args.filelist) as f:
                rows = [r for r in csv.DictReader(f) if r.get("Filename")]
            names = [
                r["Filename"]
                for r in rows
                if Path(r["Filename"]).suffix == f".{args.wsi_extension}"
            ]
            files = [wsi_root / n for n in names]
        else:
            # recursive: datasets may be laid out in per-case subdirectories
            # (reference cell_detection.py:1093-1100 uses **/*.ext)
            files = sorted(wsi_root.glob(f"**/*.{args.wsi_extension}"))
        for wsi_path in files:
            run_one(wsi_path, patch_root / wsi_path.stem)
    return inference


if __name__ == "__main__":
    main()
