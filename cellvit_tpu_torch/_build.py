"""Build the hand-written CUDA kernels with nvcc and bind them with ctypes.

Each `csrc/*.cu` file exposes a plain C interface (pointers and the CUDA
stream as `void*`, sizes as `int`, a `cudaError_t` as the return value), so
it compiles in seconds without PyTorch's headers. `png_unfilter.cu` is host
code alone, built the same way and bound without a stream (`bind_host`). A source is built at first
use into `build/`, under a name keyed by a hash of its text, the shared
`csrc/*.cuh` headers and the flags,
and loaded with `ctypes`. `build_all()` starts one `nvcc` per source, all at
once, and is what `chip_smoke.py` calls to time the build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
SOURCES = ("flash_attn.cu", "flash_attn_bwd.cu", "flood_bits.cu", "seg_min.cu", "win_qkv_attn.cu",
           "relpos_attn.cu", "win_attn.cu", "rm_small.cu", "watershed.cu", "conv3x3_cm.cu",
           "png_unfilter.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

#: kernel launches per wrapper, counted where each wrapper launches its kernel
LAUNCHES: Dict[str, int] = {
    "flash_attention": 0,
    "flash_attention_bwd": 0,
    "connected_components": 0,
    "flood": 0,
    "propagate_min": 0,
    "window_qkv_attention": 0,
    "flash_attention_relpos": 0,
    "window_attention": 0,
    "watershed": 0,
    "remove_small_objects": 0,
    "radix_filter": 0,
    "radix_hist": 0,
    "rm_mapback": 0,
    "conv3x3_cm": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def lib_path(src: str) -> Path:
    """The library of one source, named by a hash of its text, the shared
    headers' text and the flags."""
    text = (CSRC / src).read_bytes() + b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(src).stem}-{digest}.so"


def build_all(sources: Iterable[str] = SOURCES) -> Dict[str, Tuple[float, str]]:
    """Compile every source whose library is missing, one nvcc each, in
    parallel. Returns {source: (seconds, ptxas report)}; raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        out = lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter(),
        )
    report: Dict[str, Tuple[float, str]] = {}
    failed = []
    for src, (proc, tmp, out, t0) in procs.items():
        text, _ = proc.communicate()
        report[src] = (time.perf_counter() - t0, text)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src} (rc={proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(src: str) -> ctypes.CDLL:
    """The loaded library of one source, building it first if needed."""
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            path = lib_path(src)
            if not path.exists():
                build_all([src])
            lib = ctypes.CDLL(str(path))
            _libs[src] = lib
        return lib


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def bind(src: str, name: str, sig: str):
    """C entry `name` whose arguments are spelled by `sig` (p = pointer,
    i = int, f = float), followed by the stream."""
    fn = getattr(load(src), name)
    fn.argtypes = [_CTYPES[c] for c in sig] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bind_host(src: str, name: str, sig: str):
    """C entry `name` of host code, whose arguments are spelled by `sig`
    alone (no stream). ctypes releases the interpreter's lock for the call."""
    fn = getattr(load(src), name)
    fn.argtypes = [_CTYPES[c] for c in sig]
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {err}")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
