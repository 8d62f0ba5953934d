"""cellvit_tpu_torch: the PyTorch/CUDA port of cellvit_tpu for NVIDIA Hopper.

The layout mirrors the JAX package (`models/`, `ops/`, `inference/`). Plain
tensor work is PyTorch; every Pallas kernel of the JAX package on the ported
path is a hand-written CUDA kernel under `csrc/`, built with nvcc at first use
(`_build.py`). A kernel wrapper launches its kernel for a CUDA tensor and runs
the plain PyTorch version of the same function for a CPU tensor.

Entry points run on the GPU unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev
