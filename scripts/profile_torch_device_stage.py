"""Profile one batch of the PyTorch/CUDA port's device stage, or one
training step, on the GPU.

    python3 scripts/profile_torch_device_stage.py [--model cellvit256|sam-h|train]

Runs the workload of one of `chip_smoke.py`'s main paths: a full-width
CellViT-256 (the default) or CellViT-SAM-H with the probe weights of
`cellvit_tpu_torch/synthetic.py`, bf16, on its 8 × 1024² blob tiles (SAM-H
from `synthetic.random_sam_h`, as there); or `train`, one unfrozen
`CellViTTrainer.train_step` of `synthetic.cellvit256_trainer` on 4 × 1024²
tiles of `synthetic.training_batch`. After one warm-up batch (step), it
profiles one more with `torch.profiler` (CPU and CUDA activities). It
prints the wall time, the device time summed over kernels and its share of
the wall time, and the ops that take the most device time with their
kernel counts.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from cellvit_tpu_torch.inference.cell_detection import CellSegmentationInference  # noqa: E402
from cellvit_tpu_torch.models.cellvit import CellViT256  # noqa: E402
from cellvit_tpu_torch.synthetic import (  # noqa: E402
    TISSUE_TYPES,
    blob_tiles,
    cellvit256_trainer,
    random_sam_h,
    set_probe_weights,
    training_batch,
)
from cellvit_tpu_torch.train.trainer import prepare_batch  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=("cellvit256", "sam-h", "train"), default="cellvit256")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {card}; model {args.model}")
    if args.model == "train":
        trainer = cellvit256_trainer(seed=2, device="cuda")
        batch = trainer.to_device(prepare_batch(training_batch(4, 1024, 2), TISSUE_TYPES))
        run, report = (lambda: trainer.train_step(batch, freeze_encoder=False)), (lambda: "")
    else:
        run, report = _inference(args.model)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # kernels and copies only: an aten op's self device time repeats its kernels'
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f"wall {wall_ms:.2f} ms; device time {device_ms:.2f} ms "
          f"(busy share {device_ms / wall_ms:.4f}){report()}")
    print(events.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=48))
    return 0


def _inference(name: str):
    """(one batch of the device stage of `name`'s inference path, a report of
    its stage ms and watershed passes)."""
    imgs, _ = blob_tiles(8, 1024, 0)
    if name == "cellvit256":
        torch.manual_seed(0)
        model = CellViT256(num_nuclei_classes=6, num_tissue_classes=19)
    else:
        model = random_sam_h(1, "cuda")
    set_probe_weights(model)
    infer = CellSegmentationInference(
        model=model, run_conf={"data": {"num_nuclei_classes": 6, "num_tissue_classes": 19}},
        mixed_precision=True, device="cuda",
    )
    report = lambda: (f"; stage ms {infer.last_stage_ms}; watershed passes per tile "
                      f"{infer.last_watershed_passes.tolist()}")
    return (lambda: infer._device_outputs(imgs, 40)), report


if __name__ == "__main__":
    sys.exit(main())
