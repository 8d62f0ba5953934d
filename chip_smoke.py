"""Chip smoke test of the PyTorch/CUDA port (`cellvit_tpu_torch`) on one GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and the versions.
2. Builds every hand-written kernel from `cellvit_tpu_torch/csrc/` with nvcc.
3. Holds each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it: flash attention (8, 4097, 6, 64) bf16 within a
   bf16 output bound; the segmented-scan kernels on (8, 1024, 1024) blob
   masks with an L/U shape and a spiral that 3 passes do not converge,
   exactly, and connected components (B2) and min-propagation (B4), one
   resident-tile launch a call, also on a 9-image batch (more than one wave
   of images) whose last image is all open, with their times in two runs,
   host µs and device kernels per call (`torch.profiler`), and B4's whole
   op `compact_root_labels_cuda`; the flood (B3, one bit-packed cluster
   launch a call) and its hole-filling entry likewise, also on an
   all-closed image, with the whole op `fill_holes_cuda` and the cluster
   width; SAM-H's window qkv attention (B5) on 200
   windows of 196 tokens (C = 1280), and on SAM-B's and SAM-L's widths
   (head dim 64), its direct-bias flash attention on (8, 4096, 16, 80) and
   its whole-window attention (B7) on the 14×16 grid of a 224×256 tile and
   the 16×16 grids of a batch of 8 256² tiles, each within its bf16 bound;
   B7 also beside B1 on the same q′/k′, and the SASS of its instantiations
   checked for HGMMA.
   B5's phase also times its projection kernel beside `torch.matmul` of the
   same product and its three kernels by `torch.profiler`.
   Each phase times the kernel, the plain version and, where one exists, one
   PyTorch library call of the same function, beside the least time the card
   could take (for the attention kernels also their exponentials over the
   SFUs' rate at the card's maximum SM clock). B1, B5, B6 and B7, on wgmma
   and TMA, also print their TFLOP/s and host µs per call, and the build
   prints the ptxas spill bytes of every instantiation of theirs, of B8, of
   B2/B4's kernel and of B3's.
4. Drives the main paths through `CellSegmentationInference` on batches of
   8 × 1024² synthetic blob tiles, bf16, one warm-up batch and timed
   batches each: a full-width CellViT-256, then a full-width CellViT-SAM-H
   (random weights from a seed, with probe weights on the image skip path
   so the nucleus and HV maps follow the tiles), in mixed precision: bf16
   autocast over fp32 parameters, which it checks. It checks each path's
   kernel launch counts, its outputs, and one tile's instance map against
   the port's CPU path on the same forward outputs; it prints the INT_MAX
   pixels per tile of the CellViT-256 batch's compacted markers (ROADMAP C4)
   and the device time of SAM-H's per-forward parameter casts.
   B1 is also held, widened, on q′/k′ wider than v: a ragged 20×20 SAM-H
   grid through `flash_attention_relpos` (q′/k′ 120 wide, v 80) and the
   rel-pos backward's (1, 4096, 16, 208) against v of width 80. The fused
   flash backward B8 (dq, dk and dv in one kernel, for the JAX package's
   B8a and B8b) is held against `flash_attention_bwd_plain` at the training
   step's (4, 4097, 6, 64) and at SAM-H's rel-pos backward shape, with dq's
   run-to-run spread within one bf16 ulp; its kernel and whole-op times
   stand beside its bound and SDPA's backward on each backend. Then the
   gradient of every differentiable kernel op (B1, B6, B7, B5) against
   autograd through its plain version.
5. Drives one 224×256 tile through the SAM-H model, whose global blocks then
   take the whole-window kernel, and holds its outputs against the same
   forward with every SAM attention on its plain version.
6. Drives the training path: `CellViTTrainer` on a full-width CellViT-256,
   4 × 1024² synthetic tiles with HoVer-Net targets, bf16 autocast, AdamW
   (lr 3e-4, betas 0.85/0.95, wd 1e-4, exponential schedule), drop-path
   0.1: one warm-up step, timed unfrozen steps and a frozen step, then a
   validation epoch (bPQ through B2-B4). It checks the launches per step,
   finite and falling losses, and one step's gradients against the same
   step on the plain attention.
   After the CellViT-256 path, the five kernels that no main path runs are
   driven through their entry points on that batch's own tensors, the
   launch counts at 0 just before each, and held against their plain
   versions exactly (B9-B11) or within `CONV_BF16_L2` (B12): the window
   size filter B10 on the batch's root labels and compacted markers; the
   radix filter B11 (one cluster launch a call; its histogram and lookup
   entries apart) on its markers at min_size 10 and 64; the sweep
   watershed B9 on the batch's relief, markers and blob mask and on
   point-seeded floods of the blob discs, each also against 4096
   stabilization passes (ROADMAP C1); the channel-major conv B12 on the
   input of the type tower's 64→64 3×3 conv with its folded weights. Each
   of them also prints its kernel ms (launches queued back to back), host
   µs and device kernels a call, B9's quantization apart, B12's TFLOP/s and
   its fp32 instantiation at the same shape; the build prints the spills of
   their sources and checks the SASS of every bf16 B12 instantiation for
   HGMMA.
7. Drives the WSI pipeline end to end as a user runs it, after the
   CellViT-256 path: `cli.cell_detection.main([... "--device", "cuda",
   "--enforce_amp", "--geojson", "process_wsi", ...])` on a synthetic
   preprocessed slide that the script writes with the port's own tools (a
   4 × 4 grid of 1024² PNG patches at overlap 64, rows of all five PNG
   filter types, discs across the patches' borders, `metadata.yaml` by
   `utils/yaml_lite.dump`) and a full-width CellViT-256 saved as a reference
   `.pth`. It holds the compiled PNG unfilter (host C code) byte-equal to the
   plain one and to the encoded image on every patch, checks the launches a
   batch (B1 12, B2 2, B3 1, B4 1), that dedup removed cells and left some,
   every centroid inside the slide and no two within 3 px, and that a second
   `process_wsi` whose reader runs the plain unfilter writes the same
   `cells.json`; it prints `timings.json`'s stages, patches/s of the whole
   detection loop beside the device stage's, and host ms a batch of PNG
   decoding, contours and assembly, and dedup.
8. Drives the training CLI end to end as a user runs it, after the training
   path: first B1 and B8 against their plain versions at a 256² batch's
   attention shape (16, 257, 6, 64), B1 beside the einsum route; then
   `cli.run_cellvit.main(["--config", ...])` on the card with
   `configs/examples/train_cellvit.yaml` at its own settings but for the
   paths, `epochs: 2`, `unfreeze_epoch: 1` and no pretrained encoder, on a
   synthetic PanNuke-layout dataset (`synthetic.write_pannuke_folds`: folds
   of 48 / 16 / 16 256² PNG patches, ≈37 discs a patch, the repo's PanNuke
   configs). It checks the run directory (config, two epochs of finite
   metrics, both checkpoints, finite evaluation metrics), the launches of
   every step, validation epoch and evaluation batch, and the evaluation's
   first instance maps against the same postprocessing with B2-B4's plain
   versions on the card, pixel for pixel; also with the probe weights,
   whose maps have nuclei. It prints the step ms (frozen, unfrozen; CUDA
   events and wall), images/s, the loader's wait a step and its samples/s
   beside what the steps consume, a `torch.profiler` breakdown of one
   step, the peak memory and the evaluation's patches/s, writes one
   validation panel (`_plot_examples`) and decodes it, and runs `--sweep` on
   `train_cellvit_sweep.yaml` cut to a 2-run grid at one epoch, unfrozen
   (B1 and B8 12 a step). Both runs' launches join the kernels line.
9. Prints a JSON line of the ported kernels, then the card's name and power
   limit, and last `{"ok": true, "device": {...}}`.

Exits non-zero, without the last line, when no GPU is present or any phase
fails.
"""

from __future__ import annotations

import contextlib
import functools
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
SFU_EX2_PER_CLOCK = 132 * 16  # H100 SXM: 16 MUFU ex2 a clock on each of 132 SMs
BATCH, TILE = 8, 1024
TIMED_BATCHES = 2
SMALL_TILE = (224, 256)  # its SAM global grid, 14×16, takes the whole-window kernel
#: relative L2 of the 224×256 tile's outputs, kernels against plain versions
PATH_L2 = 5e-2
TRAIN_BATCH, TIMED_STEPS = 4, 3
#: relative L2, per parameter group, of one training step's gradients with
#: the flash kernels (B1 forward, B8 backward) against the same step with
#: the plain attention, both under bf16 autocast. Each attention output and
#: its input gradients differ by bf16 rounding (≈3e-3 of their size, within
#: FLASH_BOUNDS and FLASH_BWD_BOUNDS), and 12 residual blocks carry that into
#: the parameter gradients as they carry it into the outputs (PATH_L2).
GRAD_L2 = 5e-2


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10) -> float:
    """Mean device ms of `fn` over `reps` launches after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@functools.lru_cache(maxsize=None)
def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def bound_ms(n_bytes: float, n_flops: float = 0.0, n_ex2: float = 0.0):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over their peak rate, bf16 tensor-core
    FLOPs and, for the attention kernels, the exponentials over the SFUs'
    rate at the card's maximum SM clock."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(n_flops / BF16_FLOPS, n_ex2 / (SFU_EX2_PER_CLOCK * max_sm_clock_hz()) if n_ex2 else 0.0)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def queued_ms(fn) -> float:
    """Device ms of the launches `fn` enqueues, run back to back: a spin
    kernel (≈25 ms) goes first, so the host has queued all of them before
    the first one starts and no host gap falls between the two events."""
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def kernel_ms(fn, reps: int = 50) -> float:
    """Device ms per call of `fn`, its launches queued back to back behind a
    spin kernel (`queued_ms`): for kernels that take less time than the host
    needs to enqueue a call, which `time_ms` would measure instead. The
    median of three such runs: a host stall longer than the spin lets the
    queue drain, and one run then reads tens of times the kernel's time."""
    fn()
    return sorted(queued_ms(lambda: [fn() for _ in range(reps)]) / reps for _ in range(3))[1]


def host_us(fn, calls: int = 200) -> float:
    """Host µs per call of `fn` (an enqueue: the launches are not waited
    for), over `calls` back-to-back calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def device_kernels(fn, calls: int = 10) -> str:
    """The device kernels of `calls` calls of `fn` after a warm-up, counted
    by `torch.profiler`, as "n calls: {kernel: (launches, device µs a
    call)}"."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            m = re.search(r"\w+(<[^>]*>)?(?=\()", e.key)
            counts[m.group(0) if m else e.key] = (e.count, round(e.self_device_time_total / calls, 2))
    return f"{calls} calls: {counts}"


def scan_times(name: str, kd: dict, fn, timer=time_ms) -> None:
    """Print a scan kernel's time in two runs beside its bound, its host µs
    per call and the device kernels its calls run."""
    print(f"  {name}: kernel_ms {kd['ms']:.4f} / {timer(fn):.4f}, bound_ms {kd['bound'][0]:.4f} "
          f"({kd['bound'][1]}); host µs per call (enqueue, 200 calls) {host_us(fn):.1f}; "
          f"device kernels over {device_kernels(fn)}")


def attention_times(name: str, kd: dict, flops: float, ex2: float) -> None:
    """Print an attention kernel's TFLOP/s and its two operation bounds."""
    clock = max_sm_clock_hz()
    print(f"  {name}: kernel_ms {kd['ms']:.4f} ({flops / kd['ms'] / 1e9:.1f} TFLOP/s), library_ms "
          f"{kd['library_ms']:.4f}, kernel / library {kd['ms'] / kd['library_ms']:.3f}; bounds: "
          f"matrix {flops / BF16_FLOPS * 1e3:.4f} ms, ex2 {ex2 / (SFU_EX2_PER_CLOCK * clock) * 1e3:.4f} ms "
          f"({ex2 / 1e9:.3f} G at {clock / 1e6:.0f} MHz)")


def print_times(kernels: dict) -> None:
    for name, kd in kernels.items():
        print(f"  {name}: kernel_ms {kd['ms']:.4f} plain_ms {kd['plain_ms']:.4f} "
              f"library_ms {kd['library_ms']} bound_ms {kd['bound'][0]:.4f} ({kd['bound'][1]})")


def spiral(n: int, gap: int = 2) -> np.ndarray:
    """A one-pixel rectangular spiral: each turn needs another scan pass."""
    m = np.zeros((n, n), bool)
    y = x = 0
    m[0, 0] = True
    dirs = ((0, 1), (1, 0), (0, -1), (-1, 0))
    s = 0
    while True:
        length = n - 1 - gap * max(0, (s - 1) // 2)
        if length <= 0:
            return m
        dy, dx = dirs[s % 4]
        for _ in range(length):
            y, x = y + dy, x + dx
            m[y, x] = True
        s += 1


def scan_masks(masks: np.ndarray) -> np.ndarray:
    m = masks.copy()
    m[0, 100:400, 100:110] = True  # U shape
    m[0, 390:400, 100:400] = True
    m[0, 100:400, 390:400] = True
    m[1, :256, :256] = spiral(256)
    return m


def check_attention(name: str, o, po, bounds) -> float:
    """Print and check a SAM attention kernel's errors against its plain
    version; returns the largest absolute error."""
    from cellvit_tpu_torch.ops import attention

    errs = attention.attn_errors(o, po)
    max_err = (o.float() - po.float()).abs().max().item()
    print(f"{name}: max_abs_err {max_err:.3e}, max|o| {po.float().abs().max().item():.3e}, "
          f"mean|o| {po.float().abs().mean().item():.3e}; errors relative to |o| "
          + ", ".join(f"{k} {v:.3e} (bound {bounds[k]:g})" for k, v in errs.items()))
    require(attention.within(errs, bounds), f"{name} kernel disagrees")
    return max_err


@contextlib.contextmanager
def plain_sam_attention():
    """Route the SAM encoder's attention ops to their plain versions, on the
    card, for as long as the context lasts."""
    from cellvit_tpu_torch.models import sam_vit
    from cellvit_tpu_torch.ops import attention

    swaps = [(sam_vit, "window_qkv_attention", attention.window_qkv_attention_plain),
             (attention, "relpos_flash_attention", attention.relpos_attention_plain),
             (attention, "window_attention", attention.window_attention_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def tile_check(name: str, infer, imgs: np.ndarray) -> None:
    """Tile 0's instance map on the card against the port's CPU path on the
    same forward outputs (fixed-pass plain scans, fp32 filters)."""
    from cellvit_tpu_torch.ops.hv_postproc import instance_map_batch_maps

    x = torch.from_numpy((imgs[:1] - 0.5) / 0.5).to(infer.device, torch.bfloat16)
    out = infer.forward_maps(x)
    maps = [out["np_prob"], out["hv0"], out["hv1"]]
    card_inst = instance_map_batch_maps(*maps).cpu()
    unresolved = int((card_inst > TILE * TILE // 2 + 1).sum())
    cpu_inst = instance_map_batch_maps(*(t.cpu() for t in maps), use_kernels=True)
    n_card = int(torch.unique(card_inst).numel()) - 1
    n_cpu = int(torch.unique(cpu_inst).numel()) - 1
    agree = (card_inst == cpu_inst).float().mean().item()
    print(f"{name}: tile 0 card vs CPU path: instances {n_card} vs {n_cpu}, pixel agreement "
          f"{agree:.6f}; {unresolved} px carry a label the 3-pass compaction left unresolved")
    require(n_card == n_cpu and agree >= 0.999, f"{name}: card and CPU instance maps disagree")


def drive(name: str, infer, imgs: np.ndarray, per_batch, card: str, embed: int):
    """One warm-up batch, then TIMED_BATCHES timed batches of the device stage
    with the launch counts set to 0 just before them. Checks every kernel's
    count against `per_batch` (0 where absent), the outputs and tile 0;
    returns the counts."""
    from cellvit_tpu_torch import _build

    dtypes = {t.dtype for t in infer.model.state_dict().values() if t.is_floating_point()}
    print(f"{name}: mixed precision {infer.mixed_precision}, parameters and buffers {dtypes}")
    require(dtypes == {torch.float32}, f"{name}: mixed precision must keep fp32 parameters")
    t0 = time.perf_counter()
    infer._device_outputs(imgs, 40)
    print(f"{name}: warm-up batch {time.perf_counter() - t0:.3f} s")
    torch.cuda.synchronize()
    _build.reset_launches()
    batch_s, stage_ms = [], []
    for _ in range(TIMED_BATCHES):
        t0 = time.perf_counter()
        handles = infer._dispatch_device(imgs, 40)
        t1 = time.perf_counter()
        inst, stats, tokens = infer._fetch_device(handles)
        t2 = time.perf_counter()
        batch_s.append(t2 - t0)
        stage_ms.append(dict(infer.last_stage_ms, host_dispatch=(t1 - t0) * 1e3,
                             host_fetch=(t2 - t1) * 1e3))
    launches = dict(_build.LAUNCHES)
    passes = infer.last_watershed_passes.tolist()
    print(f"{name}: {TIMED_BATCHES} batches of {BATCH}×{TILE}²: "
          f"{BATCH * TIMED_BATCHES / sum(batch_s):.3f} patches/s on {card}; "
          f"batch s {[round(s, 4) for s in batch_s]}")
    for i, st in enumerate(stage_ms):
        print(f"  batch {i} ms (device events; host clock for host_*): "
              + ", ".join(f"{k} {v:.2f}" for k, v in st.items()))
    print(f"  watershed passes per tile: {passes}")
    print(f"  instances per tile: {stats['valid'].sum(1).tolist()}")
    print(f"  launches: {launches} (expected per batch {per_batch})")
    for kernel, n in launches.items():
        require(n == per_batch.get(kernel, 0) * TIMED_BATCHES, f"{name}: {kernel}: {n} launches")
    require(inst.shape == (BATCH, TILE, TILE) and tokens.shape == (BATCH, TILE // 16, TILE // 16, embed),
            f"{name}: unexpected output shapes")
    require(np.isfinite(tokens).all() and np.isfinite(stats["centroid"]).all(),
            f"{name}: non-finite outputs")
    require(all(0 < p < 4096 for p in passes), f"{name}: watershed hit its pass cap")
    tile_check(name, infer, imgs)
    return launches


def flash_bwd_phase(b: int, n: int, h: int, dqk: int, dv: int, scale: float, gen, dev):
    """The fused B8 kernel on random q, k, v, do against
    `flash_attention_bwd_plain`, and dq's run-to-run spread (its fp32
    partials are summed by atomics in any order) against one bf16 ulp of
    max|dq|; returns (q, k, v, o, lse, do, the kernel's checked operands),
    the max abs errors of (dq, dk, dv)."""
    from cellvit_tpu_torch.ops import attention

    r = lambda *shape, s=1.0: (torch.randn(shape, generator=gen, device=dev) * s).to(torch.bfloat16)
    if dqk == dv:  # strided out of one qkv tensor, as the encoder passes them
        q, k, v = r(b, n, 3, h, dqk).unbind(2)
    else:
        q, k, v = r(b, n, h, dqk, s=dqk**-0.25), r(b, n, h, dqk, s=dqk**-0.25), r(b, n, h, dv)
    o, lse = attention.flash_attention(q, k, v, scale=scale, return_lse=True)
    do = r(b, n, h, dv)
    grads = attention._flash_attention_bwd_cuda(q, k, v, o, lse, do, scale)
    again = attention._flash_attention_bwd_cuda(q, k, v, o, lse, do, scale)
    ref = attention.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    errs = attention.flash_bwd_errors(grads, ref)
    max_errs = [(a.float() - r_.float()).abs().max().item() for a, r_ in zip(grads, ref)]
    spread = (grads[0].float() - again[0].float()).abs().max().item()
    ulp = attention.bf16_ulp(grads[0].float().abs().max().item())
    print(f"B8 fused flash backward ({b}, {n}, {h}, q/k {dqk}, v {dv}; o and lse from B1): "
          "max_abs_err dq/dk/dv "
          + ", ".join(f"{e:.3e}" for e in max_errs) + "; errors relative to each gradient "
          + "; ".join(f"{g}: " + ", ".join(f"{k} {v:.3e}" for k, v in e.items())
                      for g, e in errs.items())
          + f" (bounds {attention.FLASH_BWD_BOUNDS}); run-to-run max|Δdq| {spread:.3e} "
          f"(bound: one bf16 ulp of max|dq|, {ulp:.3e}); dk, dv equal: "
          f"{torch.equal(grads[1], again[1]) and torch.equal(grads[2], again[2])}")
    require(attention.within_bwd(errs), "flash backward kernel disagrees")
    require(spread <= ulp, "flash backward: dq differs between two runs by more than one bf16 ulp")
    ops = attention._flash_bwd_operands(q, k, v, o, lse, do)
    return (q, k, v, o, lse, do, ops), max_errs


def flash_bwd_bound(b: int, n: int, h: int, dqk: int, dv: int):
    """(bound, FLOPs) of the fused backward: q, k, v, do (bf16), lse and Δ
    (fp32) read once, dq, dk, dv (bf16) written once; 5 products, q·kᵀ,
    do·vᵀ, pᵀ·do, dsᵀ·q and ds·k."""
    n_bytes = 2 * b * n * h * (2 * dqk + 2 * dv) + 2 * 4 * b * h * n + 2 * b * n * h * (2 * dqk + dv)
    flops = 2.0 * b * h * n * n * (3 * dqk + 2 * dv)
    return bound_ms(n_bytes, flops), flops


def sdpa_bwd_ms(q, k, v, do) -> dict:
    """ms of SDPA's backward (dq, dk, dv together) on each backend that takes
    these (B, N, H, ·) inputs; None where a backend refuses them."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    times = {}
    for name, backend in (("flash", SDPBackend.FLASH_ATTENTION), ("cudnn", SDPBackend.CUDNN_ATTENTION),
                          ("efficient", SDPBackend.EFFICIENT_ATTENTION)):
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        try:
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(qt, kt, vt)
                dot = do.transpose(1, 2)
                times[name] = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                                  retain_graph=True), 10)
        except RuntimeError as e:
            times[name] = None
            print(f"  SDPA backend {name} refused ({tuple(q.shape)}, v {v.shape[-1]}): "
                  f"{str(e).splitlines()[0][:120]}")
        del qt, kt, vt
    return times


def flash_bwd_timing(label: str, phase, scale: float, kernels=None):
    """Kernel ms, the whole op's ms (`_flash_backward`: Δ, workspace zeroing,
    kernel, dq cast), the fused bound, TFLOP/s reached and SDPA's backward on
    each backend; with `kernels`, the kernel's row."""
    from cellvit_tpu_torch.ops import attention

    (q, k, v, o, lse, do, ops), max_errs = phase
    b, n, h, dqk = q.shape
    dv = v.shape[-1]
    bwd_ms = time_ms(lambda: attention._flash_bwd_launch(*ops, scale), 20)
    op_ms = time_ms(lambda: attention._flash_backward(q, k, v, o, lse, do, scale), 20)
    bnd, flops = flash_bwd_bound(b, n, h, dqk, dv)
    sdpa = sdpa_bwd_ms(q, k, v, do)
    ok = {k_: t for k_, t in sdpa.items() if t is not None}
    best = min(ok, key=ok.get) if ok else None
    print(f"  B8 at {label}: kernel_ms {bwd_ms:.4f} ({flops / bwd_ms / 1e9:.1f} TFLOP/s), "
          f"whole op ms {op_ms:.4f}, fused bound_ms {bnd[0]:.4f} ({bnd[1]}, {flops / 1e9:.1f} GFLOP); "
          "SDPA backward ms " + ", ".join(f"{k_} {t:.4f}" if t is not None else f"{k_} refused"
                                          for k_, t in sdpa.items())
          + (f"; fastest {best}: whole op / SDPA {op_ms / ok[best]:.3f}" if best else ""))
    if kernels is not None:
        kernels["flash_attention_bwd"] = dict(
            route="cuda", source="cellvit_tpu_torch/csrc/flash_attn_bwd.cu",
            replaces="cellvit_tpu/ops/attention.py:106 and :143", max_abs_err=max(max_errs),
            ms=bwd_ms,
            plain_ms=time_ms(lambda: attention.flash_attention_bwd_plain(q, k, v, o, lse, do, scale), 2),
            library_ms=ok[best] if best else None, bound=bnd)


def kernel_name(entry: str) -> str:
    """A mangled kernel entry as its name and integer template arguments,
    e.g. `flash_fwd_kernel<2, 5, 80, 128, -1, 2, 0>`: the first
    length-prefixed name in it that ends in "kernel"."""
    i = 0
    while i < len(entry):
        m = re.match(r"\d+", entry[i:])
        if not m:
            i += 1
            continue
        j = i + len(m.group())
        name = entry[j:j + int(m.group())]
        if name.endswith("kernel"):
            args = re.match(r"I((?:L[ib]n?\d+E|[a-z])*)E", entry[j + len(name):])
            vals = [v.replace("n", "-") if v else t  # integer values; builtin types by their code (h: uint8_t)
                    for v, t in re.findall(r"L[ib](n?\d+)E|([a-z])", args.group(1))] if args else []
            return name + (f"<{', '.join(vals)}>" if vals else "")
        i = j + len(name)
    return entry


def ptxas_spills(text: str) -> dict:
    """{kernel: (spill store bytes, spill load bytes)} from `-Xptxas -v`, each
    kernel named by `kernel_name`."""
    spills, entry = {}, None
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            entry = kernel_name(ln.split("'")[1])
        elif "spill stores" in ln and entry is not None:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            spills[entry] = (nums[1], nums[2])
    return spills


def sass_hgmma(src: str) -> dict:
    """{kernel: HGMMA instructions in its SASS} of one built source, by
    `cuobjdump -sass`, each kernel named by `kernel_name`."""
    from pathlib import Path

    from cellvit_tpu_torch import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool) if tool.exists() else "cuobjdump", "-sass", str(_build.lib_path(src))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = kernel_name(m.group(1))
            counts[fn] = 0
        elif fn is not None and "HGMMA" in ln:
            counts[fn] += 1
    return counts


def grad_check(name: str, fn, plain, inputs, gen) -> None:
    """Gradients of `fn` (kernel forward, kernel or recompute backward) against
    autograd through `plain` on the same inputs and output gradient."""
    from cellvit_tpu_torch.ops import attention

    def grads(f):
        leaves = [t.detach().requires_grad_() for t in inputs]
        out = f(*leaves)
        do = torch.randn(out.shape, generator=torch.Generator(device=out.device).manual_seed(9),
                         device=out.device).to(out.dtype)
        return torch.autograd.grad(out, leaves, do)

    got, want = grads(fn), grads(plain)
    for i, (a, r) in enumerate(zip(got, want)):
        errs = attention.attn_errors(a, r)
        print(f"  {name} grad of input {i} {tuple(a.shape)}: "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        require(a.shape == r.shape and attention.within(errs, attention.FLASH_BWD_BOUNDS),
                f"{name}: gradient of input {i} disagrees with its plain version")


def plain_flash_attention(q, k, v):
    """The encoder's attention on the plain version, in fp32 whatever the
    autocast, checkpointed so that autograd keeps one block's N² logits at
    a time."""
    from torch.utils.checkpoint import checkpoint

    from cellvit_tpu_torch.ops import attention

    def run(q, k, v):
        with torch.autocast("cuda", enabled=False):
            return attention.flash_attention_plain(q, k, v)[0]

    return checkpoint(run, q, k, v, use_reentrant=False)


def group_grads(trainer) -> dict:
    groups = {"encoder": [], "skip decoders": [], "towers": []}
    for name, p in zip(trainer.param_names, trainer.params):
        key = ("encoder" if name.startswith("encoder.") else
               "skip decoders" if name.startswith("decoder") else "towers")
        groups[key].append(p.grad.float().flatten())
    return {k: torch.cat(v) for k, v in groups.items()}


def train_grad_check(trainer, batch) -> None:
    """One unfrozen step's parameter gradients, flash kernels against the
    plain attention, on the same batch and drop-path masks. Restores the
    BatchNorm statistics that the two forwards move."""
    from cellvit_tpu_torch.models import vit

    buffers = {k: v.clone() for k, v in trainer.model.named_buffers()}
    trainer.generator.manual_seed(5)
    trainer.loss_and_grads(batch, False)
    got = group_grads(trainer)
    trainer.generator.manual_seed(5)
    kernel_fn = vit.flash_attention
    vit.flash_attention = plain_flash_attention
    try:
        trainer.loss_and_grads(batch, False)
    finally:
        vit.flash_attention = kernel_fn
    want = group_grads(trainer)
    for p in trainer.params:
        p.grad = None
    with torch.no_grad():
        for k, v in trainer.model.named_buffers():
            v.copy_(buffers[k])
    for key in got:
        rel = ((got[key] - want[key]).norm() / want[key].norm()).item()
        print(f"  training step gradients, {key} ({want[key].numel()} values): relative L2 "
              f"kernels vs plain attention {rel:.3e} (bound {GRAD_L2:g}), "
              f"|g| {want[key].norm().item():.3e}")
        require(torch.isfinite(got[key]).all().item() and rel <= GRAD_L2,
                f"training step: {key} gradients disagree with the plain attention")


def drive_training(card: str):
    """The training path on a full-width CellViT-256 (see the module
    docstring). Returns the launch counts of the timed steps, the frozen
    step and the validation epoch."""
    from cellvit_tpu_torch import _build
    from cellvit_tpu_torch.synthetic import TISSUE_TYPES, cellvit256_trainer, training_batch
    from cellvit_tpu_torch.train.trainer import prepare_batch

    t0 = time.perf_counter()
    raw = training_batch(TRAIN_BATCH, TILE, seed=2)
    print(f"training: {TRAIN_BATCH} synthetic tiles with targets built in "
          f"{time.perf_counter() - t0:.2f} s; instances per tile "
          f"{[int(m.max()) for m in raw['masks/instance_map']]}")
    trainer = cellvit256_trainer(seed=2, device="cuda")
    batch = trainer.to_device(prepare_batch(raw, TISSUE_TYPES))
    train_grad_check(trainer, batch)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.train_step(batch, False)
    torch.cuda.synchronize()
    print(f"training: warm-up step {time.perf_counter() - t0:.3f} s")
    _build.reset_launches()
    per_step = {"flash_attention": 12, "flash_attention_bwd": 12}
    losses, step_ms, wall_ms = [], [], []
    for i in range(TIMED_STEPS + 1):
        frozen = i == TIMED_STEPS
        before = dict(_build.LAUNCHES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        metrics = trainer.train_step(batch, freeze_encoder=frozen)
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        host = trainer._host(metrics)
        diff = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}
        want = {"flash_attention": 12} if frozen else per_step
        print(f"training step {i} ({'frozen' if frozen else 'unfrozen'} encoder): "
              f"{start.elapsed_time(end):.2f} ms device events, {wall:.2f} ms wall, "
              f"loss {host['Total_Loss']:.5f} ("
              + ", ".join(f"{k} {v:.4f}" for k, v in host.items() if k != "Total_Loss")
              + f"); launches {diff}")
        require(diff == want, f"training step {i}: launches {diff}, expected {want}")
        require(all(np.isfinite(v) for v in host.values()), f"training step {i}: non-finite metrics")
        if not frozen:
            losses.append(host["Total_Loss"])
            step_ms.append(start.elapsed_time(end))
            wall_ms.append(wall)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"training: {TRAIN_BATCH}×{TILE}² CellViT-256 bf16 on {card}: unfrozen step ms "
          f"{[round(t, 2) for t in step_ms]} (wall {[round(t, 2) for t in wall_ms]}), "
          f"{TRAIN_BATCH * len(wall_ms) / (sum(wall_ms) / 1e3):.3f} images/s; "
          f"peak memory allocated {peak:.2f} GiB")
    require(losses[-1] < losses[0], f"training: losses did not fall over the timed steps: {losses}")

    before = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    scalars, bpq = trainer.validation_epoch([raw], epoch=0)
    diff = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}
    want = {"flash_attention": 12, "connected_components": 2, "flood": 1, "propagate_min": 1}
    print(f"validation epoch (1 batch, {time.perf_counter() - t0:.3f} s): bPQ {bpq:.4f} against "
          f"the synthetic instance maps, loss {scalars['Total_Loss']:.5f}, dice "
          f"{scalars['dice']:.4f}; launches {diff}")
    require(diff == want, f"validation: launches {diff}, expected {want}")
    require(np.isfinite(scalars["Total_Loss"]) and 0.0 <= bpq <= 1.0, "validation: bad metrics")
    launches = dict(_build.LAUNCHES)
    del trainer, batch
    torch.cuda.empty_cache()
    return launches


def driven(expected: dict, fn):
    """Run `fn` (entry points on the main path's tensors) with every launch
    count at 0 just before it; require exactly the `expected` launches just
    after. Returns fn's result."""
    from cellvit_tpu_torch import _build

    torch.cuda.synchronize()
    _build.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = {k: v for k, v in _build.LAUNCHES.items() if v}
    require(counts == expected, f"launches {counts}, expected {expected}")
    return out


def px_differ(a, b) -> int:
    return int((a != b).sum())


def max_abs(a, b) -> float:
    return float((a.long() - b.long()).abs().max())


@torch.no_grad()
def postproc_intermediates(infer, imgs: np.ndarray) -> dict:
    """The CellViT-256 batch's own postprocessing tensors, recomputed from
    `infer.forward_maps` with the port's public ops as `ops/hv_postproc.py`
    computes them on the card: root labels of np_prob ≥ 0.5, the blob mask
    `blb`, the relief `dist`, the compacted marker labels before and after
    their size filter."""
    from cellvit_tpu_torch.ops import cc, cc_cuda, filters

    x = torch.from_numpy(np.ascontiguousarray((imgs - infer.mean) / infer.std, np.float32))
    out = infer.forward_maps(x.to(infer.device).to(infer.dtype))
    roots = cc_cuda.connected_components_cuda(out["np_prob"] >= 0.5, n_outer=3)
    blb = cc.remove_small_objects_window(roots, 10) > 0
    blbf = blb.float()
    sobelh = 1.0 - filters.minmax_normalize(filters.sobel(filters.minmax_normalize(out["hv0"]), 1, 0, 21))
    sobelv = 1.0 - filters.minmax_normalize(filters.sobel(filters.minmax_normalize(out["hv1"]), 0, 1, 21))
    overall = torch.clamp(torch.maximum(sobelh, sobelv) - (1.0 - blbf), min=0.0)
    dist = -filters.gaussian_blur_3x3((1.0 - overall) * blbf)
    marker = cc.morph_open(cc_cuda.fill_holes_cuda(blb & ~(overall >= 0.4), n_outer=2))
    markers = cc_cuda.compact_root_labels_cuda(cc_cuda.connected_components_cuda(marker, 3), 3)
    return dict(roots=roots, blb=blb, dist=dist, markers=markers,
                marker_lab=cc.remove_small_objects_window(markers, 10))


def blob_discs(batch: int, tile: int, seed: int):
    """The discs of `synthetic.blob_tiles(batch, tile, seed)`, its random
    draws replayed: (tile index, cy, cx, r) each."""
    rng = np.random.default_rng(seed)
    discs = []
    for b in range(batch):
        for _ in range(600):
            cy, cx = rng.integers(10, tile - 10, 2)
            r = int(rng.integers(4, 12))
            rng.uniform(0.1, 0.4)  # the disc's shade
            discs.append((b, int(cy), int(cx), r))
    return discs


def point_seeded_floods(masks: np.ndarray, seed: int):
    """B9's second regime on the blob tiles: one marker pixel per disc (ids
    1…600 a tile, in draw order) and the relief −exp(−d²/R²) of each disc
    over it, the minimum where discs overlap. Requires that the replayed
    discs cover exactly the tiles' masks."""
    b, h, w = masks.shape
    relief = np.zeros(masks.shape, np.float32)
    marks = np.zeros(masks.shape, np.int32)
    cover = np.zeros(masks.shape, bool)
    for k, (i, cy, cx, r) in enumerate(blob_discs(b, h, seed)):
        y0, y1, x0, x1 = max(cy - r, 0), min(cy + r + 1, h), max(cx - r, 0), min(cx + r + 1, w)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        d2 = (yy - cy) ** 2 + (xx - cx) ** 2
        disc = d2 <= r * r
        box = relief[i, y0:y1, x0:x1]
        box[:] = np.minimum(box, np.where(disc, -np.exp(-d2 / r**2), 0.0))
        cover[i, y0:y1, x0:x1] |= disc
        marks[i, cy, cx] = k % 600 + 1
    require(np.array_equal(cover, masks), "the replayed discs do not cover the blob masks")
    return relief, marks


def size_filter_phases(inter: dict, kernels: dict, phase_launches: dict) -> None:
    """B10 on the batch's root labels and compacted markers (min_size 10);
    B11, one cluster launch a call, on its compacted markers: the whole
    filter at min_size 10 and 64, its histogram entry, and its lookup entry
    at both. Each op: kernel ms of calls queued back to back (`kernel_ms`),
    host µs and device kernels a call."""
    from cellvit_tpu_torch.ops import cc, cc_cuda

    roots, markers = inter["roots"], inter["markers"]
    n_px = roots.numel()
    outs = driven({"remove_small_objects": 2}, lambda: [
        cc_cuda.remove_small_objects_cuda(roots, 10), cc_cuda.remove_small_objects_cuda(markers, 10)])
    phase_launches["remove_small_objects"] = 2
    plain = [cc.remove_small_objects_window(roots, 10), cc.remove_small_objects_window(markers, 10)]
    diffs = [px_differ(a, p) for a, p in zip(outs, plain)]
    print(f"B10 window size filter, min_size 10: {diffs[0]} px differ on the root labels, {diffs[1]} "
          f"on the compacted markers (exact required); foreground kept {int((outs[0] > 0).sum())} of "
          f"{int((roots > 0).sum())} and {int((outs[1] > 0).sum())} of {int((markers > 0).sum())} px")
    require(diffs == [0, 0], "window size-filter kernel disagrees")
    win = lambda: cc_cuda.remove_small_objects_cuda(roots, 10)
    kd = dict(ms=kernel_ms(win), bound=bound_ms(4 * n_px + 4 * n_px))
    kernels["remove_small_objects"] = dict(
        route="cuda", source="cellvit_tpu_torch/csrc/rm_small.cu",
        replaces="cellvit_tpu/ops/cc_pallas.py:284",
        max_abs_err=max(max_abs(a, p) for a, p in zip(outs, plain)), ms=kd["ms"],
        plain_ms=time_ms(lambda: cc.remove_small_objects_window(roots, 10), 3),
        library_ms=None, bound=kd["bound"])
    scan_times("B10 remove_small_objects_cuda, root labels", kd, win, kernel_ms)
    print(f"  B10 on the compacted markers: kernel_ms "
          f"{kernel_ms(lambda: cc_cuda.remove_small_objects_cuda(markers, 10)):.4f}; CUDA events around 20 "
          f"calls (host-paced) {time_ms(win, 20):.4f} ms on the root labels")

    def b11():
        whole = [cc_cuda.remove_small_objects_bincount_cuda(markers, ms) for ms in (10, 64)]
        hist = cc_cuda.radix_histogram_cuda(markers)
        return whole, hist, [cc_cuda.radix_keep_cuda(markers, hist, ms) for ms in (10, 64)]

    whole, hist, keeps = driven({"radix_filter": 2, "radix_hist": 1, "rm_mapback": 2}, b11)
    phase_launches.update(radix_filter=2, radix_hist=1, rm_mapback=2)
    phist = cc.radix_histogram(markers)
    errs = {"histogram entry": max_abs(hist, phist)}
    for ms, out, keep in zip((10, 64), whole, keeps):
        errs[f"whole filter, min_size {ms}"] = max_abs(out, cc.remove_small_objects_bincount(markers, ms))
        errs[f"lookup entry, min_size {ms}"] = max_abs(keep, cc.radix_keep(markers, phist, ms))
    n_ids = int(markers[markers < cc_cuda.INT_MAX].max())
    differ = whole[0] != plain[1]
    print(f"B11 radix size filter on the compacted markers (largest id {n_ids}, table 8192): max |Δ| "
          + ", ".join(f"{k} {v:g}" for k, v in errs.items()) + " (exact required); min_size 10 "
          f"against B10 on the same labels: {int(differ.sum())} px differ, "
          f"{int((differ & (markers == cc_cuda.INT_MAX)).sum())} of them on the id INT_MAX that the "
          "3-pass compaction leaves unresolved (ROADMAP C4), an overflow id that B11 keeps")
    require(all(v == 0 for v in errs.values()), "radix size-filter kernel disagrees")
    nb = hist[0].numel()
    bins = (cc.radix_bins(markers, 64, 128)
            + nb * torch.arange(markers.shape[0], device=markers.device).view(-1, 1, 1)).flatten()
    common = dict(route="cuda", source="cellvit_tpu_torch/csrc/rm_small.cu", library_ms=None)
    ops = {
        "radix_filter": ("B11 remove_small_objects_bincount_cuda (the whole filter, one launch), min_size 10",
                         lambda: cc_cuda.remove_small_objects_bincount_cuda(markers, 10),
                         lambda: cc.remove_small_objects_bincount(markers, 10), 8 * n_px,
                         "cellvit_tpu/ops/cc_pallas.py:345 and :377",
                         max(v for k, v in errs.items() if k.startswith("whole"))),
        "radix_hist": ("B11 radix_histogram_cuda (the histogram entry)",
                       lambda: cc_cuda.radix_histogram_cuda(markers), lambda: cc.radix_histogram(markers),
                       4 * n_px + 4 * hist.numel(), "cellvit_tpu/ops/cc_pallas.py:345",
                       errs["histogram entry"]),
        "rm_mapback": ("B11 radix_keep_cuda (the lookup entry), min_size 10",
                       lambda: cc_cuda.radix_keep_cuda(markers, hist, 10), lambda: cc.radix_keep(markers, hist, 10),
                       8 * n_px + 4 * hist.numel(), "cellvit_tpu/ops/cc_pallas.py:377",
                       max(v for k, v in errs.items() if k.startswith("lookup"))),
    }
    for name, (label, fn, plain_fn, n_bytes, replaces, err) in ops.items():
        kd = dict(ms=kernel_ms(fn), bound=bound_ms(n_bytes))
        kernels[name] = dict(common, replaces=replaces, max_abs_err=err, ms=kd["ms"],
                             plain_ms=time_ms(plain_fn, 3), bound=kd["bound"])
        scan_times(label, kd, fn, kernel_ms)
    kernels["radix_hist"]["library_ms"] = time_ms(lambda: torch.bincount(bins, minlength=nb * markers.shape[0]), 20)
    print(f"  B11 whole filter at min_size 64: kernel_ms "
          f"{kernel_ms(lambda: cc_cuda.remove_small_objects_bincount_cuda(markers, 64)):.4f}; "
          f"torch.bincount of the same bins (CUDA events, 20 calls) {kernels['radix_hist']['library_ms']:.4f} ms")


def watershed_phase(inter: dict, masks: np.ndarray, kernels: dict, phase_launches: dict) -> None:
    """B9 in two regimes against the plain sweep with the same cap of 512,
    and the cap against 4096 passes (ROADMAP C1)."""
    from cellvit_tpu_torch.ops import cc_cuda
    from cellvit_tpu_torch.ops.watershed import quantize, watershed

    dev = inter["dist"].device
    relief, marks = point_seeded_floods(masks, 0)
    regimes = {
        "main path (its dist, marker labels and blob mask)": (inter["dist"], inter["marker_lab"],
                                                              inter["blb"]),
        "point-seeded blob floods": (torch.from_numpy(relief).to(dev), torch.from_numpy(marks).to(dev),
                                     torch.from_numpy(masks).to(dev)),
    }
    outs = driven({"watershed": 2}, lambda: [
        cc_cuda.watershed_cuda(*args, return_passes=True) for args in regimes.values()])
    phase_launches["watershed"] = 2
    errs, times = [], []
    for (name, args), (lab, passes) in zip(regimes.items(), outs):
        plab, ppasses = watershed(*args, max_final_iters=512, schedule="sweep", return_passes=True)
        lab4k, passes4k = watershed(*args, max_final_iters=4096, schedule="sweep", return_passes=True)
        diff, at_cap = px_differ(lab, plab), int((ppasses == 512).sum())
        errs.append(max_abs(lab, plab))
        times.append(time_ms(lambda: cc_cuda.watershed_cuda(*args), 5))
        print(f"B9 sweep watershed, {name}: {diff} px differ from the plain sweep (exact required); "
              f"stabilization passes per tile {passes.tolist()} (plain {ppasses.tolist()}); "
              f"C1: {at_cap} of {len(passes)} tiles at the 512 cap, {px_differ(plab, lab4k)} px differ "
              f"from the 4096-pass result (passes {passes4k.tolist()}); kernel_ms {times[-1]:.4f}")
        require(diff == 0 and torch.equal(passes, ppasses), f"watershed kernel disagrees ({name})")
    args = next(iter(regimes.values()))
    ws_call = lambda: cc_cuda.watershed_cuda(*args)
    q_ms = time_ms(lambda: quantize(args[0], args[2], 64), 10)
    bound = bound_ms(args[0].numel() * (4 + 4 + 1 + 4))
    kd = dict(ms=kernel_ms(ws_call, 10), bound=bound)
    kernels["watershed"] = dict(
        route="cuda", source="cellvit_tpu_torch/csrc/watershed.cu",
        replaces="cellvit_tpu/ops/cc_pallas.py:493", max_abs_err=max(errs), ms=kd["ms"],
        plain_ms=time_ms(lambda: watershed(*args, max_final_iters=512, schedule="sweep"), 1),
        library_ms=None, bound=bound)
    # the pass-latency floor of this design: 256 + s dependent passes, each at
    # least a block barrier (`scripts/watershed_variants.py` measures it)
    scan_times("B9 watershed_cuda on the main path's tensors (the op: quantization by torch ops, then "
               "the kernel)", kd, ws_call, kernel_ms)
    print(f"  B9 quantization alone (torch ops, timed apart): {q_ms:.4f} ms; CUDA events around 5 calls "
          f"(host-paced) {times[0]:.4f} / {times[1]:.4f} ms for the two regimes")


@torch.no_grad()
def conv_phase(infer, imgs: np.ndarray, kernels: dict, phase_launches: dict) -> None:
    """B12 on the input of the CellViT-256 type tower's 64→64 3×3 conv of
    `decoder0_header`, with that layer's folded weights, bf16: with bias and
    ReLU, and with a 3·F-channel residual's block 1."""
    from cellvit_tpu_torch.models import fused
    from cellvit_tpu_torch.ops import conv_cm

    model = infer.model
    x = torch.from_numpy(np.ascontiguousarray((imgs - infer.mean) / infer.std, np.float32))
    with infer.autocast():
        _, (p0, p1, p2, p3), z4 = model.encode_features(x.to(infer.device).to(infer.dtype))
        br = model.nuclei_type_maps_decoder
        y = br.bottleneck_upsampler(z4)
        for stage, p in ((br.decoder3_upsampler, p3), (br.decoder2_upsampler, p2),
                         (br.decoder1_upsampler, p1)):
            y = fused._run_stage(stage, torch.cat([p, y], dim=1))
        head = br.decoder0_header
        inp = fused._run_stage(head[:1], torch.cat([p0, y], dim=1)).contiguous()
    del p0, p1, p2, p3, z4, y
    w, b = fused.fold_bn(head[1], inp.dtype)  # OIHW
    model_out = F.relu(F.conv2d(inp, w, b, padding=1))
    w_hwio = w.permute(2, 3, 1, 0)
    f = w.shape[0]
    gen = torch.Generator(device=inp.device).manual_seed(4)
    res = torch.randn((inp.shape[0], 3 * f, *inp.shape[2:]), generator=gen, device=inp.device)
    res = res.to(inp.dtype)
    out, out_res = driven({"conv3x3_cm": 2}, lambda: (
        conv_cm.conv3x3_cm(inp, w_hwio, b, relu=True),
        conv_cm.conv3x3_cm(inp, w_hwio, b, relu=True, res=res, res_block=1)))
    phase_launches["conv3x3_cm"] = 2
    rel = lambda a, r: ((a.float() - r.float()).norm() / r.float().norm()).item()
    ref = conv_cm.conv3x3_cm_reference(inp, w_hwio, b, relu=True)
    ref_res = conv_cm.conv3x3_cm_reference(inp, w_hwio, b, relu=True, res=res, res_block=1)
    errs = {"bias + ReLU vs plain": rel(out, ref), "bias + ReLU vs the model's conv": rel(out, model_out),
            "+ res block 1 vs plain": rel(out_res, ref_res)}
    max_err = max((out.float() - ref.float()).abs().max().item(),
                  (out_res.float() - ref_res.float()).abs().max().item())
    print(f"B12 channel-major 3×3 conv {tuple(inp.shape)} → {f}, {inp.dtype}: relative L2 "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (bound {conv_cm.CONV_BF16_L2:g}); max_abs_err vs plain {max_err:.3e}, max|o| "
          f"{ref.float().abs().max().item():.3e}")
    require(all(v <= conv_cm.CONV_BF16_L2 for v in errs.values()), "conv kernel disagrees")
    n_flops = 2.0 * inp.shape[0] * inp.shape[2] * inp.shape[3] * f * 9 * inp.shape[1]
    res_ms = time_ms(lambda: conv_cm.conv3x3_cm(inp, w_hwio, b, relu=True, res=res, res_block=1), 10)
    conv = lambda: conv_cm.conv3x3_cm(inp, w_hwio, b, relu=True)
    kd = dict(ms=kernel_ms(conv, 10), bound=bound_ms(2 * (inp.numel() + out.numel()), n_flops))
    kernels["conv3x3_cm"] = dict(
        route="cuda", source="cellvit_tpu_torch/csrc/conv3x3_cm.cu",
        replaces="cellvit_tpu/ops/conv_cm.py:80", max_abs_err=max_err, ms=kd["ms"],
        plain_ms=time_ms(lambda: conv_cm.conv3x3_cm_reference(inp, w_hwio, b, relu=True), 3),
        library_ms=time_ms(lambda: F.relu(F.conv2d(inp, w, b, padding=1)), 10),
        bound=kd["bound"])
    scan_times("B12 conv3x3_cm (the op: weight packing, then the kernel)", kd, conv, kernel_ms)
    print(f"  B12 {n_flops / kd['ms'] / 1e9:.1f} TFLOP/s; with res: CUDA events {res_ms:.4f} ms; "
          f"CUDA events {time_ms(conv, 10):.4f} ms; cuDNN conv + bias, ReLU "
          f"{kernels['conv3x3_cm']['library_ms']:.4f} ms")
    xf, wf = inp.float(), w_hwio.float()
    f32_ms = time_ms(lambda: conv_cm.conv3x3_cm(xf, wf, b, relu=True), 3)
    f32_ref = conv_cm.conv3x3_cm_reference(xf, wf, b, relu=True)
    f32_rel = rel(conv_cm.conv3x3_cm(xf, wf, b, relu=True), f32_ref)
    print(f"  B12 fp32 instantiation (FFMA) at the same shape: {f32_ms:.4f} ms, relative L2 vs plain "
          f"{f32_rel:.3e} (bound 1e-5: the same fp32 products summed in another order)")
    require(f32_rel <= 1e-5, "the fp32 conv kernel disagrees")
    del f32_ref
    del xf, wf


WSI_GRID, WSI_OVERLAP = 4, 64  # a 4 × 4 grid of 1024² patches, 64 px overlap


def write_synthetic_slide(root, seed: int = 5):
    """A preprocessed slide written with the port's own tools (`data/png.py`,
    `utils/yaml_lite.py`): WSI_GRID² patches of TILE² cut at a distance of
    TILE − WSI_OVERLAP from one image of dark discs on a light background
    (the look of `synthetic.blob_tiles`), so that discs cross the patches'
    borders and lie in two or four patches' overlaps. Each patch's rows use
    the five PNG filter types in turn. Returns {patch name: its image}."""
    from cellvit_tpu_torch.data.png import encode_png
    from cellvit_tpu_torch.utils import yaml_lite

    dist = TILE - WSI_OVERLAP
    side = WSI_GRID * dist  # the slide; patches reach WSI_OVERLAP // 2 beyond it
    rng = np.random.default_rng(seed)
    img = np.full((side + WSI_OVERLAP, side + WSI_OVERLAP, 3), 191, np.uint8)
    pad = WSI_OVERLAP // 2
    for _ in range(600 * side * side // (TILE * TILE)):
        cy, cx = rng.integers(12, side - 12, 2) + pad
        r = int(rng.integers(4, 12))
        yy, xx = np.mgrid[cy - r:cy + r + 1, cx - r:cx + r + 1]
        img[cy - r:cy + r + 1, cx - r:cx + r + 1][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = \
            int(rng.integers(25, 103))
    (root / "patches").mkdir(parents=True)
    patches, entries = {}, []
    for row in range(WSI_GRID):
        for col in range(WSI_GRID):
            name = f"slide_{row}_{col}.png"
            patch = img[row * dist:row * dist + TILE, col * dist:col * dist + TILE]
            (root / "patches" / name).write_bytes(encode_png(patch, np.arange(TILE) % 5, level=1))
            patches[name] = patch
            entries.append({name: {"row": row, "col": col, "background_ratio": 0.0,
                                   "intersected_labels": [], "label_ratios": [],
                                   "metadata_path": f"./metadata/slide_{row}_{col}.yaml"}})
    (root / "patch_metadata.json").write_text(json.dumps(entries, indent=2))
    (root / "metadata.yaml").write_text(yaml_lite.dump({
        "orig_n_tiles_cols": WSI_GRID, "orig_n_tiles_rows": WSI_GRID, "base_magnification": 40.0,
        "downsampling": 1, "label_map": {"background": 0}, "magnification": 40.0, "base_mpp": 0.25,
        "target_patch_mpp": 0.25, "patch_overlap": WSI_OVERLAP, "patch_size": TILE,
        "patch_distance": dist, "stain_normalization": False,
    }))
    return patches


def host_routines(infer, patches: dict) -> None:
    """Host ms of the contour tracer and the cell assembly on the first batch
    of the WSI path's slide: contours a tile inside the device statistics'
    boxes (as `process_wsi` traces them) and, on tile 0, with each instance
    compared over the whole map (the JAX package's way), which must give
    the same contours; then a tile's whole assembly (contours and cell
    dicts)."""
    from cellvit_tpu_torch.inference import cell_detection as cd
    from cellvit_tpu_torch.ops.instance_stats import contours_from_instance_map

    imgs = np.stack(list(patches.values())[:BATCH]).astype(np.float32) / 255.0
    inst, stats, tokens = infer._device_outputs(imgs, 40)
    boxed, assembly, counts = [], [], []
    for i in range(inst.shape[0]):
        st = {k: v[i] for k, v in stats.items()}
        t0 = time.perf_counter()
        contours = contours_from_instance_map(inst[i], bboxes=st["bbox"])
        boxed.append((time.perf_counter() - t0) * 1e3)
        counts.append(len(contours))
        t0 = time.perf_counter()
        instances = cd.assemble_patch_instances(inst[i], st)
        cd.assemble_patch_cells(instances, tokens[i], 0, 0, TILE, WSI_OVERLAP, 1, 16)
        assembly.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            t0 = time.perf_counter()
            whole = contours_from_instance_map(inst[0])
            whole_ms = (time.perf_counter() - t0) * 1e3
            require(list(whole) == list(contours)
                    and all(np.array_equal(whole[k], contours[k]) for k in whole),
                    "the boxed contours differ from the whole-map ones")
    print(f"  host routines, one batch of this slide ({counts} instances with a contour a tile): "
          f"contours in boxes ms a tile {np.median(boxed):.1f} (median; {min(boxed):.1f}-"
          f"{max(boxed):.1f}), whole-map compare on tile 0 {whole_ms:.1f} (the same contours); "
          f"assembly (contours + cell dicts) ms a tile {np.median(assembly):.1f} (median; "
          f"{min(assembly):.1f}-{max(assembly):.1f})")


def wsi_phase(card: str) -> dict:
    """Main path 4: the WSI pipeline end to end through the CLI, as a user
    runs it: `cli.cell_detection.main` with `--device cuda --enforce_amp
    --geojson process_wsi` on a synthetic preprocessed slide of WSI_GRID²
    1024² patches (2 batches of 8) and a full-width CellViT-256 saved as a
    reference `.pth` (random weights from seed 0 and the probe weights).
    Checks the PNG unfilters, the launches a batch, dedup and the cells,
    and that a second run whose reader uses the plain unfilter writes the
    same cells.json. Returns the CLI run's launch counts."""
    import shutil
    import tempfile
    from pathlib import Path

    from scipy.spatial import cKDTree

    from cellvit_tpu_torch import _build
    from cellvit_tpu_torch.cli import cell_detection as cli
    from cellvit_tpu_torch.data import png
    from cellvit_tpu_torch.data.wsi import WSI
    from cellvit_tpu_torch.inference import cell_detection as cd
    from cellvit_tpu_torch.models.cellvit import CellViT256
    from cellvit_tpu_torch.synthetic import set_probe_weights

    root = Path(tempfile.mkdtemp(prefix="cellvit_wsi_"))
    try:
        t0 = time.perf_counter()
        patched = root / "slide"
        patches = write_synthetic_slide(patched)
        torch.manual_seed(0)
        model = CellViT256(num_nuclei_classes=6, num_tissue_classes=19)
        set_probe_weights(model)
        ckpt = root / "cellvit_256.pth"
        torch.save({"arch": "CellViT256", "model_state_dict": model.state_dict(),
                    "config": {"data.num_nuclei_classes": 6, "data.num_tissue_classes": 19}}, ckpt)
        del model
        print(f"WSI path: slide of {len(patches)} patches ({WSI_GRID}×{WSI_GRID}, {TILE}², overlap "
              f"{WSI_OVERLAP}) and checkpoint written in {time.perf_counter() - t0:.1f} s")

        # the PNG unfilters on every patch: compiled (host C) against plain and the image
        decode_ms = {True: 0.0, False: 0.0}
        for name, want in patches.items():
            data = (patched / "patches" / name).read_bytes()
            shape, raw = png.read_png(data)
            kinds = np.frombuffer(raw, np.uint8)[:: 1 + TILE * 3]
            require(sorted(set(kinds.tolist())) == [0, 1, 2, 3, 4], f"{name}: filter types {kinds}")
            got = {}
            for native in (True, False):
                t1 = time.perf_counter()
                got[native] = png.decode_png(data, native=native)
                decode_ms[native] += (time.perf_counter() - t1) * 1e3
            require(np.array_equal(got[True], got[False]) and np.array_equal(got[True], want),
                    f"{name}: the compiled PNG unfilter disagrees with the plain one or the image")
        per_batch = {k: v * BATCH / len(patches) for k, v in decode_ms.items()}
        print(f"  PNG decode (zlib + unfilter), one thread, ms a batch of {BATCH}: compiled "
              f"{per_batch[True]:.1f}, plain {per_batch[False]:.1f}; byte-equal to each other and "
              f"to the encoded image on all {len(patches)} patches (rows of all five filter types)")

        before_dedup = []

        class Recording(cd.dd.CellPostProcessor):
            def __init__(self, cells, logger=None):
                before_dedup.append(len(cells))
                super().__init__(cells, logger)

        original = cd.dd.CellPostProcessor
        cd.dd.CellPostProcessor = Recording
        try:
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            infer = cli.main(["--model", str(ckpt), "--device", "cuda", "--enforce_amp", "--geojson",
                              "--batch_size", str(BATCH), "--patch_size", str(TILE),
                              "--overlap", str(WSI_OVERLAP), "process_wsi", "--wsi_path",
                              str(root / "slide.svs"), "--patched_slide_path", str(patched)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
            outdir = patched / "cell_detection"
            cells = json.loads((outdir / "cells.json").read_text())
            timings = json.loads((outdir / "timings.json").read_text())
            stage_ms = infer.batch_stage_ms
            # the same slide again, the reader on the plain unfilter
            infer.native_png = False
            wsi = WSI(name="slide", patient="slide", slide_path=root / "slide.svs",
                      patched_slide_path=patched)
            plain_dir = infer.process_wsi(wsi, subdir_name="plain_png", geojson=True,
                                          patch_size=TILE, overlap=WSI_OVERLAP)
            plain_cells = json.loads((plain_dir / "cells.json").read_text())
            plain_timings = json.loads((plain_dir / "timings.json").read_text())
        finally:
            cd.dd.CellPostProcessor = original
        host_routines(infer, patches)
        del infer
        torch.cuda.empty_cache()

        n_batches = -(-len(patches) // BATCH)
        want = {"flash_attention": 12, "connected_components": 2, "flood": 1, "propagate_min": 1}
        print(f"  CLI run: {wall:.2f} s wall (model load included); launches {launches} "
              f"(expected per batch {want}, {n_batches} batches)")
        for kernel, n in launches.items():
            require(n == want.get(kernel, 0) * n_batches, f"WSI path: {kernel}: {n} launches")
        require(len(stage_ms) == n_batches, "WSI path: device stage times missing")
        stages = timings["stages_s"]
        n = timings["n_patches"]
        device_s = sum(sum(st.values()) for st in stage_ms) / 1e3
        print(f"  timings.json stages (s): {stages}; n_patches {n}")
        print(f"  plain-unfilter run stages (s): {plain_timings['stages_s']}")
        print(f"  patches/s on {card}: detection_loop {n / stages['detection_loop']:.3f}, device "
              f"stage {n / device_s:.3f} (device events: forward + postproc + stats, "
              f"{device_s * 1e3 / len(stage_ms):.2f} ms a batch over {len(stage_ms)} batches); "
              f"plain-unfilter run's detection_loop "
              f"{n / plain_timings['stages_s']['detection_loop']:.3f}")
        print(f"  host ms a batch: PNG decode (one thread) compiled {per_batch[True]:.1f} / plain "
              f"{per_batch[False]:.1f}; contours and assembly "
              f"{stages['host_assembly'] * 1e3 / n_batches:.1f}; patch_load wait "
              f"{stages['patch_load'] * 1e3 / n_batches:.1f}; dedup {stages['dedup'] * 1e3:.1f} ms "
              f"a slide")
        kept = cells["cells"]
        print(f"  cells: {before_dedup[0]} before dedup, {len(kept)} after")
        require(n == len(patches) and len(cells["processed_patches"]) == len(patches),
                "WSI path: patches missing")
        require(before_dedup[0] > len(kept) > 0, "WSI path: dedup removed nothing or no cell is left")
        cen = np.asarray([c["centroid"] for c in kept], np.float64)
        side = WSI_GRID * (TILE - WSI_OVERLAP)
        require(np.isfinite(cen).all() and (cen >= 0).all() and (cen < side).all(),
                "WSI path: a centroid lies outside the slide")
        close = cKDTree(cen).query_pairs(3.0)
        require(not close, f"WSI path: {len(close)} pairs of surviving centroids within 3 px")
        for name in ("cells.geojson", "cell_detection.geojson", "cells.pt", "cell_detection.json"):
            require((outdir / name).is_file(), f"WSI path: {name} missing")
        require(plain_cells == cells, "WSI path: the plain-unfilter run wrote other cells")
        print("  the plain-unfilter run wrote the same cells.json")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


TRAIN_CLI_FOLDS = {0: 48, 1: 16, 2: 16}  # PanNuke-layout folds: train, validation, test
TRAIN_CLI_TILE = 256


@contextlib.contextmanager
def plain_scans():
    """Route B2-B4's wrappers to their plain versions, on the card, for as
    long as the context lasts: the HV postprocessing then runs the same
    filters on the card with the plain scans."""
    from cellvit_tpu_torch.ops import cc_cuda

    def fill_holes_plain(mask, n_outer=2):
        bg = ~mask
        return mask | (bg & ~cc_cuda.flood_plain(cc_cuda.border_seed(mask), bg, n_outer))

    swaps = [("connected_components_cuda", cc_cuda.connected_components_plain),
             ("propagate_min_cuda", cc_cuda.propagate_min_plain),
             ("fill_holes_cuda", fill_holes_plain)]
    saved = [(name, getattr(cc_cuda, name)) for name, _ in swaps]
    try:
        for name, fn in swaps:
            setattr(cc_cuda, name, fn)
        yield
    finally:
        for name, fn in saved:
            setattr(cc_cuda, name, fn)


def against_plain_scans(label: str, first_batch: dict) -> None:
    """An evaluation's first batch: its instance maps (B2-B4) against the
    same postprocessing of the same maps on the card with the plain scans,
    pixel for pixel; the plain run must launch no kernel."""
    from cellvit_tpu_torch import _build
    from cellvit_tpu_torch.ops.hv_postproc import instance_map_batch_maps

    fb = first_batch
    torch.cuda.synchronize()
    _build.reset_launches()
    with plain_scans():
        plain = instance_map_batch_maps(fb["np_prob"], fb["hv0"], fb["hv1"], object_size=10, ksize=21)
    torch.cuda.synchronize()
    launched = {k: v for k, v in _build.LAUNCHES.items() if v}
    got = fb["inst"]
    print(f"  {label} batch 0 ({tuple(got.shape)}): instances a patch "
          f"{[int(m.max()) for m in got]}; pixels differing from the postprocessing with the plain "
          f"scans {px_differ(got, plain)}; the plain run's launches {launched}")
    require(not launched and torch.equal(got, plain),
            f"training CLI: {label}'s instance maps differ from the plain scans'")


def einsum_attention(q, k, v):
    """The encoder's einsum route (`models/vit.py`): fp32 logits and
    softmax, the product in v's dtype."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1).to(v.dtype), v)


class CliRecorder:
    """Wraps the trainer's and the evaluator's entry points for the training
    CLI phase: the launches, CUDA-event and wall ms of every training step,
    the loader's wait per step, the launches of every validation epoch and
    evaluation batch, the evaluator's wall time; `restore` puts them back."""

    def __init__(self) -> None:
        from cellvit_tpu_torch import _build
        from cellvit_tpu_torch.inference.eval_pannuke import InferenceCellViT
        from cellvit_tpu_torch.train.trainer import CellViTTrainer

        self.launches = _build.LAUNCHES
        self.steps, self.waits, self.val, self.eval_batches, self.evals = [], [], [], [], []
        self.trainer = self.inference = None
        self._saved = []
        rec = self

        def wrap(cls, name, fn):
            original = getattr(cls, name)
            self._saved.append((cls, name, original))
            setattr(cls, name, lambda obj, *a, **kw: fn(original, obj, *a, **kw))

        def train_step(original, trainer, batch, freeze_encoder):
            rec.trainer = trainer
            torch.cuda.synchronize()
            before = dict(rec.launches)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = original(trainer, batch, freeze_encoder)
            end.record()
            torch.cuda.synchronize()
            rec.steps.append(dict(frozen=freeze_encoder, ms=start.elapsed_time(end),
                                  wall=(time.perf_counter() - t0) * 1e3, launches=rec.diff(before)))
            return out

        def train_epoch(original, trainer, *a, **kw):
            out = original(trainer, *a, **kw)
            rec.waits.append(list(trainer.loader_wait_s))
            return out

        def validation_epoch(original, trainer, loader, *a, **kw):
            torch.cuda.synchronize()
            before = dict(rec.launches)
            out = original(trainer, loader, *a, **kw)
            torch.cuda.synchronize()
            rec.val.append(dict(batches=len(loader), launches=rec.diff(before)))
            return out

        def device_batch(original, inference, *a, **kw):
            torch.cuda.synchronize()
            before = dict(rec.launches)
            out = original(inference, *a, **kw)
            torch.cuda.synchronize()
            rec.eval_batches.append(rec.diff(before))
            return out

        def run_patch_inference(original, inference, *a, **kw):
            rec.inference = inference
            t0 = time.perf_counter()
            out = original(inference, *a, **kw)
            rec.evals.append(time.perf_counter() - t0)
            return out

        wrap(CellViTTrainer, "train_step", train_step)
        wrap(CellViTTrainer, "train_epoch", train_epoch)
        wrap(CellViTTrainer, "validation_epoch", validation_epoch)
        wrap(InferenceCellViT, "_device_batch", device_batch)
        wrap(InferenceCellViT, "run_patch_inference", run_patch_inference)

    def diff(self, before: dict) -> dict:
        return {k: v - before.get(k, 0) for k, v in self.launches.items() if v != before.get(k, 0)}

    def restore(self) -> None:
        for cls, name, original in self._saved:
            setattr(cls, name, original)


def train_cli_phase(card: str) -> dict:
    """Main path 5: the training CLI end to end, as a user runs it:
    `cli.run_cellvit.main(["--config", ...])` on the card with
    `configs/examples/train_cellvit.yaml` at its own settings (full-width
    CellViT-256, batch 16, AdamW, exponential schedule, cell+tissue
    sampling, every augmentation at its p, mixed precision) but for the
    paths, `epochs: 2`, `unfreeze_epoch: 1` and no pretrained encoder, on a
    synthetic PanNuke-layout dataset (folds of 48 / 16 / 16 256² patches);
    then `--sweep` on `train_cellvit_sweep.yaml` cut to a 2-run grid at
    `epochs: 1`, `unfreeze_epoch: 0`. First B1 and B8 are held against their
    plain versions at the training batch's attention shape (16, 257, 6, 64).
    Returns the two runs' launch counts."""
    import shutil
    import tempfile
    from pathlib import Path

    from cellvit_tpu_torch import _build, synthetic
    from cellvit_tpu_torch.cli import run_cellvit
    from cellvit_tpu_torch.data.png import decode_png
    from cellvit_tpu_torch.ops import attention
    from cellvit_tpu_torch.utils import yaml_lite

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    b, n, h, hd = 16, TRAIN_CLI_TILE ** 2 // 256 + 1, 6, 64
    q, k, v = (torch.randn((b, n, 3, h, hd), generator=gen, device=dev).to(torch.bfloat16)).unbind(2)
    o, lse = attention.flash_attention(q, k, v, return_lse=True)
    errs = attention.flash_errors(o, lse, *attention.flash_attention_plain(q, k, v))
    b1_ms, ein_ms = time_ms(lambda: attention.flash_attention(q, k, v), 50), \
        time_ms(lambda: einsum_attention(q, k, v), 50)
    print(f"training CLI: B1 at ({b}, {n}, {h}, {hd}) bf16 (a 256² batch's 257 tokens, the ragged "
          f"tail of 1 past 256): errors {errs} (bounds {attention.FLASH_BOUNDS}); B1 {b1_ms:.4f} ms, "
          f"the einsum route {ein_ms:.4f} ms ({ein_ms / b1_ms:.2f}×) on {card}")
    require(all(e <= attention.FLASH_BOUNDS[key] for key, e in errs.items()),
            "B1 disagrees at (16, 257, 6, 64)")
    flash_bwd_timing(f"({b}, {n}, {h}, {hd})", flash_bwd_phase(b, n, h, hd, hd, hd ** -0.5, gen, dev),
                     hd ** -0.5)
    del q, k, v, o, lse
    torch.cuda.empty_cache()

    root = Path(tempfile.mkdtemp(prefix="cellvit_train_"))
    rec = CliRecorder()
    try:
        # the repo's PanNuke configs: the 19 tissue names, the 5 nucleus types, the tissue counts
        t0 = time.perf_counter()
        configs = Path(__file__).resolve().parent / "configs"
        synthetic.write_pannuke_folds(
            root / "data", TRAIN_CLI_FOLDS,
            yaml_lite.load((configs / "datasets/PanNuke/dataset_config.yaml").read_text()),
            yaml_lite.load((configs / "datasets/PanNuke/weight_config.yaml").read_text()),
            tile=TRAIN_CLI_TILE)
        print(f"training CLI: PanNuke-layout folds {TRAIN_CLI_FOLDS} of {TRAIN_CLI_TILE}² written in "
              f"{time.perf_counter() - t0:.1f} s")
        examples = configs / "examples"
        config = yaml_lite.load((examples / "train_cellvit.yaml").read_text())
        config["logging"]["log_dir"] = str(root / "runs")
        config["data"]["dataset_path"] = str(root / "data")
        config["model"]["pretrained_encoder"] = None
        config["training"].update(epochs=2, unfreeze_epoch=1)
        (root / "train.yaml").write_text(yaml_lite.dump(config))
        attn_drop = config["training"]["attn_drop_rate"]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        run_dir = run_cellvit.main(["--config", str(root / "train.yaml")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"training CLI run: {wall:.1f} s wall (2 epochs, validation, test-fold evaluation); "
              f"launches {launches}; peak memory allocated {peak:.2f} GiB")

        # the run directory
        for name in ("config.yaml", "metrics.jsonl", "checkpoints/latest_checkpoint.pth",
                     "checkpoints/model_best.pth", "inference_results.json"):
            require((run_dir / name).is_file(), f"training CLI: {name} missing")
        lines = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
        kinds = [(line["step"], sorted({key.split("/")[0] for key in line if "/" in key})) for line in lines]
        require(kinds == [(0, ["Train"]), (0, ["Validation"]), (1, ["Train"]), (1, ["Validation"])],
                f"training CLI: metrics.jsonl lines {kinds}")
        for line in lines:
            loss = line.get("Train/Total_Loss", line.get("Validation/Total_Loss"))
            require(np.isfinite(loss), f"training CLI: a non-finite loss in {line}")
            print(f"  epoch {line['step']} " + ", ".join(f"{key} {val:.5f}" for key, val in line.items()
                                                         if "Loss" in key or key.endswith(("dice", "bPQ"))))
        results = json.loads((run_dir / "inference_results.json").read_text())["dataset"]
        print(f"  inference_results.json: " + ", ".join(f"{key} {val:.5f}" for key, val in results.items()))
        for key in ("bPQ", "bDQ", "bSQ", "mPQ", "f1_detection"):
            require(np.isfinite(results[key]), f"training CLI: {key} is {results[key]}")

        # launches: each training step, each validation epoch, each evaluation batch
        per_step = {} if attn_drop > 0 else {"flash_attention": 12}
        post = {"connected_components": 2, "flood": 1, "propagate_min": 1}
        per_val_batch = {"flash_attention": 12, **post}
        for i, st in enumerate(rec.steps):
            print(f"  step {i} ({'frozen' if st['frozen'] else 'unfrozen'} encoder): {st['ms']:.2f} ms "
                  f"device events, {st['wall']:.2f} ms wall; launches {st['launches']}")
            require(st["launches"] == per_step, f"training CLI step {i}: launches {st['launches']}")
        steps_per_epoch = TRAIN_CLI_FOLDS[0] // config["training"]["batch_size"]
        require(len(rec.steps) == 2 * steps_per_epoch, f"training CLI: {len(rec.steps)} steps")
        print(f"  training steps route attention by the config's attn_drop_rate {attn_drop}: "
              f"{'the einsum route (the flash kernels never form the probabilities to drop from)' if attn_drop > 0 else 'B1 and B8'}")
        for val in rec.val:
            want = {key: c * val["batches"] for key, c in per_val_batch.items()}
            print(f"  validation epoch ({val['batches']} batch): launches {val['launches']} (expected {want})")
            require(val["launches"] == want, "training CLI: validation launches")
        for i, got in enumerate(rec.eval_batches):
            require(got == per_val_batch, f"training CLI: evaluation batch {i} launches {got}")
        print(f"  evaluation: {len(rec.eval_batches)} batch(es), launches a batch {rec.eval_batches[0]}")

        frozen = [st for st in rec.steps if st["frozen"]]
        unfrozen = [st for st in rec.steps if not st["frozen"]]
        med = lambda xs: float(np.median(xs))
        bs = config["training"]["batch_size"]
        print(f"  training step on {card}: frozen median {med([s['ms'] for s in frozen]):.2f} ms events / "
              f"{med([s['wall'] for s in frozen]):.2f} ms wall, unfrozen median "
              f"{med([s['ms'] for s in unfrozen]):.2f} / {med([s['wall'] for s in unfrozen]):.2f}; "
              f"images/s over the unfrozen steps' wall {bs * len(unfrozen) / (sum(s['wall'] for s in unfrozen) / 1e3):.1f}")
        waits = [w * 1e3 for epoch in rec.waits for w in epoch]
        print(f"  loader wait a step (host decode, augmentations, targets; 16 threads): ms "
              f"{[round(w, 1) for w in waits]}, median {med(waits):.1f} beside the step's median wall "
              f"{med([s['wall'] for s in rec.steps]):.1f}")
        n_test = TRAIN_CLI_FOLDS[2]
        print(f"  evaluation: {n_test} test patches in {rec.evals[0]:.3f} s, "
              f"{n_test / rec.evals[0]:.2f} patches/s (loader, forward, postprocessing, host metrics)")

        # the evaluation's first batch: kernels against the plain postprocessing
        against_plain_scans("evaluation", rec.inference.first_batch)

        # a validation example panel (off the training path, as in the JAX package)
        trainer = rec.trainer
        panel = trainer._plot_examples(*first_val_batch(trainer), epoch=99)
        img = decode_png(panel.read_bytes())
        print(f"  example panel {panel.name}: {img.shape} PNG decodes")
        require(img.ndim == 3 and img.shape[2] == 3, "training CLI: the example panel")
        host_loader_rates(config, root / "data", med([s["wall"] for s in rec.steps]))
        profile_train_step(trainer)
        probe_evaluation(run_dir, card)
        del trainer
        rec.trainer = rec.inference = None
        torch.cuda.empty_cache()

        # --sweep: a 2-run grid at one epoch, the encoder unfrozen
        sweep = yaml_lite.load((examples / "train_cellvit_sweep.yaml").read_text())
        sweep["logging"]["log_dir"] = str(root / "sweep")
        sweep["data"]["dataset_path"] = str(root / "data")
        sweep["model"]["pretrained_encoder"] = None
        sweep["training"].update(epochs=1, unfreeze_epoch=0)
        sweep["parameters"] = {"training": {"optimizer_hyperparameter": {"lr": {"values": [0.0003, 0.0001]}}}}
        (root / "sweep.yaml").write_text(yaml_lite.dump(sweep))
        rec.steps, rec.val = [], []
        _build.reset_launches()
        t0 = time.perf_counter()
        best = run_cellvit.main(["--config", str(root / "sweep.yaml"), "--sweep"])
        torch.cuda.synchronize()
        sweep_launches = dict(_build.LAUNCHES)
        out = json.loads((root / "sweep" / "sweep_results.json").read_text())
        print(f"training CLI --sweep: {time.perf_counter() - t0:.1f} s; {len(out['runs'])} results, best "
              f"run {best.get('run')} bPQ {best.get('bPQ')}; launches {sweep_launches}")
        require(len(out["runs"]) == 2 and all(r.get("bPQ") is not None and "error" not in r
                                              for r in out["runs"]), f"training CLI --sweep: {out}")
        per_step = {"flash_attention": 12, "flash_attention_bwd": 12}
        for i, st in enumerate(rec.steps):
            require(st["launches"] == per_step, f"sweep step {i}: launches {st['launches']}")
        print(f"  sweep steps (unfrozen, no attention dropout): launches a step {rec.steps[0]['launches']}, "
              f"{med([s['ms'] for s in rec.steps[1:]]):.2f} ms events, "
              f"{med([s['wall'] for s in rec.steps[1:]]):.2f} ms wall (median past each run's first)")
        for val in rec.val:
            require(val["launches"] == {key: c * val["batches"] for key, c in per_val_batch.items()},
                    f"sweep validation launches {val['launches']}")
        return {key: launches.get(key, 0) + sweep_launches.get(key, 0)
                for key in set(launches) | set(sweep_launches)}
    finally:
        rec.restore()
        shutil.rmtree(root, ignore_errors=True)


def host_loader_rates(config: dict, data_dir, step_wall_ms: float) -> None:
    """How fast the host makes training batches: one thread's ms a sample
    (PNG decode, every augmentation at its p, targets) over the training
    fold, and the experiment's loader (16 threads, a batch each) over 16
    batches drawn from it, beside what the steps consume. The loader splits
    work by batch: an epoch's first batch waits for one thread to build all
    of it."""
    from cellvit_tpu_torch.data.datasets import PanNukeDataset
    from cellvit_tpu_torch.data.loader import DataLoader, WeightedRandomSampler
    from cellvit_tpu_torch.data.transforms import build_transforms

    train_tf, _ = build_transforms(config["transformations"], TRAIN_CLI_TILE, seed=19)
    ds = PanNukeDataset(data_dir, 0, transforms=train_tf, native_png=True)
    t0 = time.perf_counter()
    for i in range(len(ds)):
        ds[i]
    one = (time.perf_counter() - t0) * 1e3 / len(ds)
    bs = config["training"]["batch_size"]
    loader = DataLoader(ds, batch_size=bs, sampler=WeightedRandomSampler(np.ones(len(ds)), 16 * bs, 19),
                        num_workers=16, drop_last=True)
    t0 = time.perf_counter()
    n = sum(len(b["image"]) for b in loader)
    rate = n / (time.perf_counter() - t0)
    need = bs / (step_wall_ms / 1e3)
    print(f"  host loader: one thread {one:.1f} ms a sample; 16 threads {rate:.1f} samples/s over "
          f"{n} samples; the steps consume {need:.1f} samples/s (batch {bs} a {step_wall_ms:.1f} ms "
          f"step): the loader {'sets' if rate < need else 'keeps up with'} the pace")


def fold_batch(trainer, fold: int, n: int) -> dict:
    """The first `n` patches of a fold of the phase's dataset, normalized,
    as a `prepare_batch` dict."""
    from cellvit_tpu_torch.data.datasets import PanNukeDataset
    from cellvit_tpu_torch.data.loader import default_collate
    from cellvit_tpu_torch.data.transforms import build_transforms
    from cellvit_tpu_torch.train.trainer import prepare_batch

    _, val_tf = build_transforms({}, TRAIN_CLI_TILE)
    ds = PanNukeDataset(trainer.run_config["data.dataset_path"], fold, transforms=val_tf)
    return prepare_batch(default_collate([ds[i] for i in range(n)]), trainer.tissue_types)


def profile_train_step(trainer) -> None:
    """One unfrozen training step of the CLI run's trainer under
    `torch.profiler`: wall, device time summed over kernels and copies, the
    busy share, and the ops that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    batch = trainer.to_device(fold_batch(trainer, 0, trainer.run_config["training.batch_size"]))
    trainer._host(trainer.train_step(batch, False))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer._host(trainer.train_step(batch, False))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    top = sorted((e for e in events if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:10]
    print(f"  profile of one unfrozen step (torch.profiler): wall {wall:.2f} ms, device {device:.2f} ms "
          f"(busy share {device / wall:.4f}); top device ms: "
          + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.2f} ({e.count})" for e in top))


def probe_evaluation(run_dir, card: str) -> None:
    """The evaluator on the run's checkpoint with the probe weights
    (`synthetic.set_probe_weights`: the maps follow the dark discs), so
    that its instance maps and host metrics have nuclei: its first batch
    against the plain postprocessing, pixel for pixel, and its patches/s."""
    from cellvit_tpu_torch.inference.eval_pannuke import InferenceCellViT
    from cellvit_tpu_torch.models.checkpoint_io import load_checkpoint
    from cellvit_tpu_torch.synthetic import set_probe_weights

    ckpt_dir = run_dir / "checkpoints"
    ckpt = torch.load(str(ckpt_dir / "latest_checkpoint.pth"), weights_only=True)
    model, _, _ = load_checkpoint(ckpt_dir / "latest_checkpoint.pth")
    with torch.no_grad():
        set_probe_weights(model)
    ckpt["model_state_dict"] = model.state_dict()
    torch.save(ckpt, str(ckpt_dir / "probe.pth"))
    infer = InferenceCellViT(run_dir, "probe", device="cuda")
    t0 = time.perf_counter()
    results = infer.run_patch_inference()["dataset"]
    wall = time.perf_counter() - t0
    print(f"  evaluation with the probe weights: {TRAIN_CLI_FOLDS[2] / wall:.2f} patches/s on {card}; "
          f"bPQ {results['bPQ']:.4f}, f1_detection {results['f1_detection']:.4f}")
    require(int(infer.first_batch["inst"].max()) > 0, "training CLI: the probe evaluation found no nuclei")
    against_plain_scans("probe evaluation", infer.first_batch)


def first_val_batch(trainer):
    """(host batch, device predictions, instance map) of 4 validation
    patches, for `_plot_examples`."""
    batch = fold_batch(trainer, 1, 4)
    inst_gt = batch.pop("instance_map")
    _, preds = trainer.eval_step(trainer.to_device(batch))
    return batch, preds, inst_gt


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")

    from cellvit_tpu_torch import _build
    from cellvit_tpu_torch.inference.cell_detection import CellSegmentationInference
    from cellvit_tpu_torch.models.cellvit import CellViT256
    from cellvit_tpu_torch.models.sam_vit import window_partition
    from cellvit_tpu_torch.ops import attention, cc_cuda
    from cellvit_tpu_torch.synthetic import blob_tiles, random_sam_h, set_probe_weights

    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s ({len(report)} sources compiled)")
    for src, (sec, text) in report.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        print(f"  {src}: {sec:.2f} s; " + " | ".join(regs))
    for src, params in (("flash_attn.cu", "<KB, KS, DV, BK, bias, warpgroups, turns>"),
                        ("relpos_attn.cu", "<KB, KS, DV, BK, bias, warpgroups, turns>"),
                        ("flash_attn_bwd.cu", "<KB, DV>"),
                        ("win_qkv_attn.cu", "flash <KB, KS, DV, BK, bias (-1: EXPAND), warpgroups, "
                                            "turns>; terms <D>"),
                        ("seg_min.cu", "<seed>"),
                        ("flood_bits.cu", "<rows a warp, words a lane, mode (0 flood, 1 fill_holes)>"),
                        ("win_attn.cu", "<DV, key tiles>"),
                        ("watershed.cu", "<heights: h 8-bit, t 16-bit>"),
                        ("rm_small.cu", "window <TMA>; radix <mode (0 whole filter, 1 histogram, 2 lookup), "
                                        "16-byte route>"),
                        ("conv3x3_cm.cu", "<TMA, resident weights>")):
        if src in report:
            spills = ptxas_spills(report[src][1])
            print(f"  {src} spill bytes (stores, loads) per instantiation {params}: "
                  + ", ".join(f"{e}: {v}" for e, v in spills.items()))

    hgmma = sass_hgmma("win_attn.cu")
    print(f"  win_attn.cu HGMMA instructions per instantiation <DV, key tiles> (cuobjdump -sass): {hgmma}")
    require(len(hgmma) == 4 and all(n > 0 for n in hgmma.values()), "B7: an instantiation has no HGMMA")
    hgmma = {k: v for k, v in sass_hgmma("conv3x3_cm.cu").items() if "sm90" in k}
    print(f"  conv3x3_cm.cu HGMMA instructions per bf16 instantiation <TMA, resident weights> (cuobjdump "
          f"-sass): {hgmma}")
    require(len(hgmma) == 4 and all(n > 0 for n in hgmma.values()), "B12: a bf16 instantiation has no HGMMA")

    kernels = {}

    # ---- B1 flash attention at the encoder's shape
    gen = torch.Generator(device=dev).manual_seed(0)
    n_tok, heads, hd = (TILE // 16) ** 2 + 1, 6, 64
    qkv = torch.randn((BATCH, n_tok, 3, heads, hd), generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o, lse = attention.flash_attention(q, k, v, return_lse=True)
    po, plse = attention.flash_attention_plain(q, k, v)
    errs = attention.flash_errors(o, lse, po, plse)
    max_err = (o.float() - po.float()).abs().max().item()
    print(f"B1 flash: max_abs_err {max_err:.3e}, max|o| {po.float().abs().max().item():.3e}, "
          f"mean|o| {po.float().abs().mean().item():.3e}; errors relative to |o| "
          + ", ".join(f"{k} {v:.3e} (bound {attention.FLASH_BOUNDS[k]:g})" for k, v in errs.items()))
    require(attention.within(errs, attention.FLASH_BOUNDS), "flash kernel disagrees")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    b1_flops, b1_ex2 = 4.0 * BATCH * heads * n_tok * n_tok * hd, float(BATCH * heads * n_tok * n_tok)
    b1_bound = bound_ms(4 * BATCH * n_tok * heads * hd * 2 + BATCH * heads * n_tok * 4, b1_flops, b1_ex2)
    kernels["flash_attention"] = dict(
        route="cuda", source="cellvit_tpu_torch/csrc/flash_attn.cu",
        replaces="cellvit_tpu/ops/attention.py:32", max_abs_err=max_err,
        ms=time_ms(lambda: attention.flash_attention(q, k, v), 20),
        plain_ms=time_ms(lambda: attention.flash_attention_plain(q, k, v), 3),
        library_ms=time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), 20),
        bound=b1_bound,
    )
    attention_times(f"B1 flash ({BATCH}, {n_tok}, {heads}, {hd})", kernels["flash_attention"],
                    b1_flops, b1_ex2)
    print(f"  B1 host µs per flash_attention call (enqueue, 200 calls): "
          f"{host_us(lambda: attention.flash_attention(q, k, v)):.1f}")
    del qkv, q, k, v, o, po, lse, plse, qt, kt, vt

    # ---- B2-B4 segmented scans on blob masks + U shape + spiral; B2 and B4
    # (one resident-tile launch a call) also on a 9-image batch, more than one
    # wave of images, whose last image is all open: one run across every tile
    imgs, masks = blob_tiles(BATCH, TILE, 0)
    fg = torch.from_numpy(scan_masks(masks)).to(dev)
    n_px = fg.numel()
    lab = cc_cuda.connected_components_cuda(fg, 3)
    plab = cc_cuda.connected_components_plain(fg, 3)
    n_diff = int((lab != plab).sum())
    spiral_ids = int(torch.unique(lab[1, :256, :256]).numel()) - 1
    print(f"B2 connected components: {n_diff} px differ (exact required); "
          f"spiral split into {spiral_ids} labels after 3 passes (converged: 1)")
    require(n_diff == 0 and spiral_ids > 1, "connected-components kernel disagrees")
    fg9 = torch.cat([fg, torch.ones_like(fg[:1])])
    lab9 = cc_cuda.connected_components_cuda(fg9, 3)
    n_diff9 = int((lab9 != cc_cuda.connected_components_plain(fg9, 3)).sum())
    rank9 = cc_cuda.root_rank_seed(lab9)
    pm9 = cc_cuda.propagate_min_cuda(rank9, lab9 > 0, 3)
    n_diff9_pm = int((pm9 != cc_cuda.propagate_min_plain(rank9, lab9 > 0, 3)).sum())
    print(f"B2 / B4 on {tuple(fg9.shape)}, image 8 all open: {n_diff9} / {n_diff9_pm} px differ "
          f"(exact required); image 8 labels {torch.unique(lab9[8]).tolist()} (one run: [1])")
    require(n_diff9 == 0 and n_diff9_pm == 0 and bool((lab9[8] == 1).all()),
            "the resident-tile kernel disagrees on the 9-image batch")
    del fg9, lab9, rank9, pm9
    kernels["connected_components"] = dict(
        route="cuda", source="cellvit_tpu_torch/csrc/seg_min.cu",
        replaces="cellvit_tpu/ops/cc_pallas.py:75", max_abs_err=float(n_diff),
        ms=time_ms(lambda: cc_cuda.connected_components_cuda(fg, 3)),
        plain_ms=time_ms(lambda: cc_cuda.connected_components_plain(fg, 3), 3),
        library_ms=None, bound=bound_ms(n_px * 1 + n_px * 4),
    )
    scan_times("B2", kernels["connected_components"], lambda: cc_cuda.connected_components_cuda(fg, 3))

    # B3: the flood entry and the hole-filling entry, one bit-packed cluster
    # launch a call, on the smoke's masks, a 9-image batch whose last image
    # is all open, and an all-closed image
    seed = cc_cuda.border_seed(fg)
    open_ = ~fg
    reach = cc_cuda.flood_cuda(seed, open_, 2)
    n_diff = int((reach != cc_cuda.flood_plain(seed, open_, 2)).sum())
    fill_want = lambda m: m | (~m & ~cc_cuda.flood_plain(cc_cuda.border_seed(m), ~m, 2))
    filled = cc_cuda.fill_holes_cuda(fg, 2)
    n_diff_fill = int((filled != fill_want(fg)).sum())
    fg9 = torch.cat([fg, torch.zeros_like(fg[:1])])
    closed = torch.ones_like(fg[:1])
    diffs = [int((cc_cuda.flood_cuda(cc_cuda.border_seed(m), ~m, 2)
                  != cc_cuda.flood_plain(cc_cuda.border_seed(m), ~m, 2)).sum())
             + int((cc_cuda.fill_holes_cuda(m, 2) != fill_want(m)).sum()) for m in (fg9, closed)]
    print(f"B3 flood / fill_holes: {n_diff} / {n_diff_fill} px differ (exact required), reach "
          f"{reach.dtype}; 9-image batch with image 8 all open, and an all-closed image: {diffs} px differ; "
          f"image 8 reached whole: {bool(cc_cuda.flood_cuda(cc_cuda.border_seed(fg9), ~fg9, 2)[8].all())}")
    require(n_diff == 0 and n_diff_fill == 0 and diffs == [0, 0], "flood kernel disagrees")
    del fg9, closed
    # kernel ms: device time of launches queued back to back (a call takes
    # the host longer than the kernel takes the card)
    flood = lambda: cc_cuda.flood_cuda(seed, open_, 2)
    fill = lambda: cc_cuda.fill_holes_cuda(fg, 2)
    kernels["flood"] = dict(
        route="cuda", source="cellvit_tpu_torch/csrc/flood_bits.cu",
        replaces="cellvit_tpu/ops/cc_pallas.py:225", max_abs_err=float(n_diff + n_diff_fill),
        ms=kernel_ms(flood),
        plain_ms=time_ms(lambda: cc_cuda.flood_plain(seed, open_, 2), 3),
        library_ms=None, bound=bound_ms(2 * n_px + n_px),
    )
    scan_times("B3 flood", kernels["flood"], flood, kernel_ms)
    fill_kd = dict(ms=kernel_ms(fill), bound=bound_ms(n_px + n_px))
    scan_times("B3 fill_holes_cuda (the whole op)", fill_kd, fill, kernel_ms)
    print(f"  B3 through the wrappers, CUDA events around 10 calls (host-paced): flood {time_ms(flood):.4f}, "
          f"fill_holes_cuda {time_ms(fill):.4f} ms")
    print(f"  B3 cluster width: {cc_cuda.flood_cluster(*fg.shape[1:])} blocks an image (FLOOD_CLUSTER "
          f"{cc_cuda.FLOOD_CLUSTER}; other widths: scripts/flood_bits_variants.py)")
    del reach, filled

    lab_fg = lab > 0
    rank_seed = cc_cuda.root_rank_seed(lab)
    pm = cc_cuda.propagate_min_cuda(rank_seed, lab_fg, 3)
    n_diff = int((pm != cc_cuda.propagate_min_plain(rank_seed, lab_fg, 3)).sum())
    print(f"B4 propagate-min: {n_diff} px differ (exact required)")
    require(n_diff == 0, "propagate-min kernel disagrees")
    kernels["propagate_min"] = dict(
        route="cuda", source="cellvit_tpu_torch/csrc/seg_min.cu",
        replaces="cellvit_tpu/ops/cc_pallas.py:118", max_abs_err=float(n_diff),
        ms=time_ms(lambda: cc_cuda.propagate_min_cuda(rank_seed, lab_fg, 3)),
        plain_ms=time_ms(lambda: cc_cuda.propagate_min_plain(rank_seed, lab_fg, 3), 3),
        library_ms=None, bound=bound_ms(n_px * 4 + n_px + n_px * 4),
    )
    scan_times("B4", kernels["propagate_min"], lambda: cc_cuda.propagate_min_cuda(rank_seed, lab_fg, 3))
    compact = lambda: cc_cuda.compact_root_labels_cuda(lab, 3)
    print(f"  B4's op compact_root_labels_cuda (rank seed cumsum, B4, select): {time_ms(compact):.4f} / "
          f"{time_ms(compact):.4f} ms; device kernels over {device_kernels(compact)}")
    del fg, lab, plab, seed, open_, lab_fg, rank_seed, pm

    # ---- B5 window qkv attention at SAM-H's windowed blocks: 8 tiles' 64×64
    # token grids of LN'd-like tokens cut into 200 zero-padded windows; then
    # SAM-B's and SAM-L's widths (head dim 64) on 2 tiles
    gen = torch.Generator(device=dev).manual_seed(1)
    for label, c, heads, n_tiles in (("SAM-H", 1280, 16, BATCH), ("SAM-B", 768, 12, 2),
                                     ("SAM-L", 1024, 16, 2)):
        hd, win = c // heads, 14
        grid = torch.randn((n_tiles, TILE // 16, TILE // 16, c), generator=gen, device=dev)
        x = window_partition(grid, win)[0].reshape(-1, win * win, c).to(torch.bfloat16).contiguous()
        del grid
        w_lin = (torch.randn((3 * c, c), generator=gen, device=dev) * c**-0.5).to(torch.bfloat16)
        b_lin = (torch.randn(3 * c, generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        rh, rw = ((torch.randn((win, win, hd), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
                  for _ in range(2))
        args = (x, w_lin.t(), b_lin, rh, rw, heads)  # the qkv Linear's weight, as the model passes it
        o = attention.window_qkv_attention(*args)
        po = attention.window_qkv_attention_plain(*args)
        max_err = check_attention(f"B5 window qkv attention, {label} {tuple(x.shape)}, {heads} × {hd}",
                                  o, po, attention.WIN_QKV_BOUNDS)
        if label == "SAM-H":
            sam_h = (x, w_lin, b_lin, rh, rw, args, max_err)
        del x, w_lin, b_lin, rh, rw, args, o, po
    x, w_lin, b_lin, rh, rw, args, max_err = sam_h
    del sam_h
    c, heads, hd, win = 1280, 16, 80, 14
    nw, n = x.shape[:2]
    b5 = lambda: attention.window_qkv_attention(*args)
    b5_proj = 2.0 * nw * n * c * 3 * c
    b5_flops = b5_proj + 4.0 * nw * heads * n * n * hd + 4.0 * nw * heads * n * win * hd
    kernels["window_qkv_attention"] = dict(
        route="cuda", source="cellvit_tpu_torch/csrc/win_qkv_attn.cu",
        replaces="cellvit_tpu/ops/attention.py:862", max_abs_err=max_err,
        ms=time_ms(b5, 10),
        plain_ms=time_ms(lambda: attention.window_qkv_attention_plain(*args), 3),
        library_ms=None,
        bound=bound_ms(
            2 * (2 * x.numel() + w_lin.numel() + b_lin.numel() + rh.numel() + rw.numel()), b5_flops),
    )
    kd = kernels["window_qkv_attention"]
    ms2 = time_ms(b5, 10)
    print(f"  B5 ({nw}, {n}, {c}, {heads} × {hd}): kernel_ms {kd['ms']:.4f} / {ms2:.4f} "
          f"({b5_flops / kd['ms'] / 1e9:.1f} / {b5_flops / ms2 / 1e9:.1f} TFLOP/s, "
          f"{b5_flops / 1e9:.1f} GFLOP), bound_ms {kd['bound'][0]:.4f} ({kd['bound'][1]}); "
          f"host µs per window_qkv_attention call (enqueue, 200 calls): {host_us(b5):.1f}")
    # the projection kernel alone beside one torch.matmul of the same bf16
    # product: a yardstick the port never calls (B5's library_ms stays None:
    # no one PyTorch call computes the whole op)
    x2 = x.reshape(nw * n, c)
    gemm_ms = [time_ms(lambda: attention.win_qkv_proj(x2, args[1], b_lin), 10) for _ in range(2)]
    mm_ms = [time_ms(lambda: torch.matmul(x2, args[1]), 10) for _ in range(2)]
    print(f"  B5 projection ({nw * n} × {c})·({c} × {3 * c}) + bias: kernel_ms "
          + " / ".join(f"{t:.4f} ({b5_proj / t / 1e9:.1f} TFLOP/s)" for t in gemm_ms)
          + "; torch.matmul (cuBLAS, no bias) "
          + " / ".join(f"{t:.4f} ({b5_proj / t / 1e9:.1f} TFLOP/s)" for t in mm_ms)
          + f"; kernel / matmul {gemm_ms[0] / mm_ms[0]:.3f}")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            b5()
        torch.cuda.synchronize()
    rows = [(re.search(r"\w+(<[^>]*>)?(?=\()", e.key), e.self_device_time_total)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    print("  B5 device ms per call by kernel (torch.profiler, 10 calls): " + ", ".join(
        f"{m.group(0) if m else '?'}: {us / 10 / 1e3:.4f}" for m, us in sorted(rows, key=lambda r: -r[1])))
    del x, x2, w_lin, b_lin, rh, rw, args, b5, prof, rows

    # ---- B6 direct-bias flash attention at SAM-H's global blocks (64×64 grid)
    side = TILE // 16
    n = side * side
    qkv = torch.randn((BATCH, n, 3, heads, hd), generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    rh, rw = ((torch.randn((side, side, hd), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
              for _ in range(2))
    bh, bw = attention.rel_pos_bias(q, rh, rw, (side, side))
    o = attention.relpos_flash_attention(q, k, v, bh, bw)
    po = attention.relpos_attention_plain(q, k, v, bh, bw)
    max_err = check_attention("B6 rel-pos flash attention", o, po, attention.RELPOS_BOUNDS)
    bias = (bh[..., :, None] + bw[..., None, :]).reshape(BATCH, n, heads, n).transpose(1, 2).contiguous()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    b6_flops, b6_ex2 = 4.0 * BATCH * heads * n * n * hd, float(BATCH * heads * n * n)
    kernels["flash_attention_relpos"] = dict(
        route="cuda", source="cellvit_tpu_torch/csrc/relpos_attn.cu",
        replaces="cellvit_tpu/ops/attention.py:190", max_abs_err=max_err,
        ms=time_ms(lambda: attention.relpos_flash_attention(q, k, v, bh, bw), 10),
        plain_ms=time_ms(lambda: attention.relpos_attention_plain(q, k, v, bh, bw), 3),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias), 5),
        bound=bound_ms(2 * (4 * q.numel() + bh.numel() + bw.numel()), b6_flops, b6_ex2),
    )
    attention_times(f"B6 rel-pos flash ({BATCH}, {n}, {heads}, {hd}), {side}×{side} grid",
                    kernels["flash_attention_relpos"], b6_flops, b6_ex2)
    print(f"  B6 host µs per relpos_flash_attention call (enqueue, 200 calls): "
          f"{host_us(lambda: attention.relpos_flash_attention(q, k, v, bh, bw)):.1f}")
    del qkv, q, k, v, rh, rw, bh, bw, o, po, bias, qt, kt, vt

    # ---- B7 whole-window attention at a 224×256 tile's global blocks (14×16),
    # then at a batch of 8 256² tiles' (16×16), with SAM-H's tables
    gh, gw = SMALL_TILE[0] // 16, SMALL_TILE[1] // 16
    for batch, grid_hw in ((1, (gh, gw)), (BATCH, (16, 16))):
        n = grid_hw[0] * grid_hw[1]
        qkv = torch.randn((batch, n, 3, heads, hd), generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = qkv.unbind(2)
        rh = (torch.randn((grid_hw[0], grid_hw[0], hd), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        rw = (torch.randn((grid_hw[1], grid_hw[1], hd), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        qa, ka = attention.relpos_aug(q, k, *attention.rel_pos_bias(q, rh, rw, grid_hw), grid_hw)
        o = attention.window_attention(qa, ka, v)
        po = attention.window_attention_plain(qa, ka, v)
        label = f"({batch}, {n}, {heads}, q′/k′ {qa.shape[-1]}, v {hd}), {grid_hw[0]}×{grid_hw[1]} grid"
        max_err = check_attention(f"B7 window attention {label}", o, po, attention.WINDOW_BOUNDS)
        qt, kt, vt = (t.transpose(1, 2) for t in (qa, ka, v))
        flops = 2.0 * batch * heads * n * n * (qa.shape[-1] + hd)
        kd = dict(
            route="cuda", source="cellvit_tpu_torch/csrc/win_attn.cu",
            replaces="cellvit_tpu/ops/attention.py:257", max_abs_err=max_err,
            ms=kernel_ms(lambda: attention.window_attention(qa, ka, v)),
            plain_ms=time_ms(lambda: attention.window_attention_plain(qa, ka, v), 10),
            library_ms=kernel_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=1.0)),
            bound=bound_ms(2 * (qa.numel() + ka.numel() + 2 * v.numel()), flops, float(batch * heads * n * n)),
        )
        # the alternative design on the same operands: B1's online-softmax
        # kernel on q′/k′ read 8 columns wide (their zero padding included)
        qp, kp = (t.as_strided(t.shape[:-1] + (-(-t.shape[-1] // 8) * 8,), t.stride()) for t in (qa, ka))
        b7 = lambda: attention.window_attention(qa, ka, v)
        b1_ms = kernel_ms(lambda: attention.flash_attention(qp, kp, v, scale=1.0))
        print(f"  B7 {label}: kernel_ms {kd['ms']:.4f} / {kernel_ms(b7):.4f} "
              f"({flops / kd['ms'] / 1e9:.1f} TFLOP/s; device time queued back to back), CUDA events around "
              f"20 calls (host-paced) {time_ms(b7, 20):.4f}, SDPA (scale 1) {kd['library_ms']:.4f}, plain "
              f"{kd['plain_ms']:.4f}, bound_ms {kd['bound'][0]:.4f} ({kd['bound'][1]}); B1 on the same "
              f"q′/k′ {b1_ms:.4f}; host µs per window_attention call (enqueue, 200 calls) {host_us(b7):.1f}; "
              f"device kernels over {device_kernels(b7)}")
        if batch == 1:  # the 224×256 tile's shape is the main path's
            kernels["window_attention"] = kd
        del qkv, q, k, v, rh, rw, qa, ka, o, po, qt, kt, vt, qp, kp, b7

    # ---- B1 widened: q′/k′ wider than v. A ragged 20×20 SAM-H grid fits
    # neither B6 nor B7 and takes B1 on q′/k′ 80 + 20 + 20 wide, scale 1; the
    # rel-pos backward runs B1 on SAM-H's q′/k′ 80 + 64 + 64 wide.
    gen = torch.Generator(device=dev).manual_seed(3)
    side = 20
    qkv = torch.randn((1, side * side, 3, heads, hd), generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    rh, rw = ((torch.randn((side, side, hd), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
              for _ in range(2))
    before = _build.LAUNCHES["flash_attention"]
    o = attention.flash_attention_relpos(q, k, v, rh, rw, (side, side))
    require(_build.LAUNCHES["flash_attention"] == before + 1, "the ragged grid did not take B1")
    qa, ka = attention.relpos_aug(q, k, *attention.rel_pos_bias(q, rh, rw, (side, side)), (side, side))
    wide = [("ragged 20×20 grid", qa, ka, v, o)]
    qw = (torch.randn((1, 4096, heads, 208), generator=gen, device=dev) * 208**-0.25).to(torch.bfloat16)
    kw = (torch.randn((1, 4096, heads, 208), generator=gen, device=dev) * 208**-0.25).to(torch.bfloat16)
    vw = torch.randn((1, 4096, heads, hd), generator=gen, device=dev).to(torch.bfloat16)
    wide.append(("rel-pos backward width", qw, kw, vw, None))
    for label, qx, kx, vx, routed in wide:
        ox, lse = attention.flash_attention(qx, kx, vx, scale=1.0, return_lse=True)
        po, plse = attention.flash_attention_plain(qx, kx, vx, scale=1.0)
        errs = attention.flash_errors(ox, lse, po, plse)
        if routed is not None:
            require(torch.equal(routed, ox), f"B1 widened, {label}: the routed op differs")
        b_, n_, h_, d_ = qx.shape
        flops = 2.0 * b_ * h_ * n_ * n_ * (d_ + vx.shape[-1])
        bnd = bound_ms(2 * (2 * qx.numel() + 2 * vx.numel()) + 4 * b_ * h_ * n_, flops,
                       float(b_ * h_ * n_ * n_))
        wide_ms = time_ms(lambda: attention.flash_attention(qx, kx, vx, scale=1.0), 20)
        print(f"B1 widened, {label}: q/k {tuple(qx.shape)}, v {tuple(vx.shape)}: max_abs_err "
              f"{(ox.float() - po.float()).abs().max().item():.3e}; errors relative to |o| "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f"; kernel_ms {wide_ms:.4f} ({flops / wide_ms / 1e9:.1f} TFLOP/s)"
              f" plain_ms {time_ms(lambda: attention.flash_attention_plain(qx, kx, vx, 1.0), 3):.4f}"
              f" bound_ms {bnd[0]:.4f} ({bnd[1]})")
        require(attention.within(errs, attention.FLASH_BOUNDS), f"B1 widened, {label}: disagrees")
    del qkv, q, k, v, rh, rw, o, qa, ka, qw, kw, vw, wide, ox, lse, po, plse

    # ---- B8, the fused flash backward, at the training step's shape and at
    # SAM-H's rel-pos backward shape
    tb, t_heads = TRAIN_BATCH, 6
    phase = flash_bwd_phase(tb, n_tok, t_heads, 64, 64, 64**-0.5, gen, dev)
    flash_bwd_timing(f"({tb}, {n_tok}, {t_heads}, 64)", phase, 64**-0.5, kernels)
    del phase
    phase = flash_bwd_phase(1, 4096, heads, 208, hd, 1.0, gen, dev)
    flash_bwd_timing(f"(1, 4096, {heads}, q/k 208, v {hd})", phase, 1.0)
    del phase
    torch.cuda.empty_cache()

    # ---- gradients of every differentiable kernel op against autograd
    # through its plain version, at the ViT-256 training and SAM-H shapes
    print("gradients of the kernel ops against their plain versions "
          f"(bounds {attention.FLASH_BWD_BOUNDS}):")
    r = lambda *shape, s=1.0: (torch.randn(shape, generator=gen, device=dev) * s).to(torch.bfloat16)
    grad_check("B1 flash (ViT-256 training)", attention.flash_attention,
               lambda q, k, v: attention.flash_attention_plain(q, k, v)[0],
               r(tb, n_tok, 3, t_heads, 64).unbind(2), gen)
    side = TILE // 16
    grad_check("B6 rel-pos flash (SAM-H global, batch 2)",
               lambda q, k, v, rh, rw: attention.flash_attention_relpos(q, k, v, rh, rw, (side, side)),
               lambda q, k, v, rh, rw: attention.relpos_attention_plain(
                   q, k, v, *attention.rel_pos_bias(q, rh, rw, (side, side))),
               (*r(2, side * side, 3, heads, hd).unbind(2), r(side, side, hd, s=0.1),
                r(side, side, hd, s=0.1)), gen)
    q, k, v = r(1, gh * gw, 3, heads, hd).unbind(2)
    rh, rw = r(gh, gh, hd, s=0.1), r(gw, gw, hd, s=0.1)
    qa, ka = attention.relpos_aug(q, k, *attention.rel_pos_bias(q, rh, rw, (gh, gw)), (gh, gw))
    grad_check("B7 window (224×256 tile)", attention.window_attention,
               attention.window_attention_plain, (qa, ka, v), gen)
    grid = torch.randn((BATCH, side, side, c), generator=gen, device=dev)
    x = window_partition(grid, win)[0].reshape(-1, win * win, c).to(torch.bfloat16).contiguous()
    del grid
    grad_check("B5 window qkv (SAM-H windowed)",
               lambda *t: attention.window_qkv_attention(*t, heads),
               lambda *t: attention.window_qkv_attention_plain(*t, heads),
               (x, r(c, 3 * c, s=c**-0.5), r(3 * c, s=0.1), r(win, win, hd, s=0.1),
                r(win, win, hd, s=0.1)), gen)
    del q, k, v, rh, rw, qa, ka, x
    torch.cuda.empty_cache()

    print_times(kernels)

    # ---- main path 1: CellViT-256 WSI tile inference, device stage
    run_conf = {"data": {"num_nuclei_classes": 6, "num_tissue_classes": 19}}
    torch.manual_seed(0)
    model = CellViT256(num_nuclei_classes=6, num_tissue_classes=19)
    set_probe_weights(model)
    infer = CellSegmentationInference(model=model, run_conf=run_conf, mixed_precision=True,
                                      batch_size=BATCH, device="cuda")
    launches = drive("CellViT-256 path", infer, imgs, {
        "flash_attention": 12, "connected_components": 2, "flood": 1, "propagate_min": 1,
    }, card, embed=384)

    # ---- B9-B12, which no main path runs, driven through their entry points
    # on this batch's own tensors, each with the counts at 0 just before it
    phase_launches = {}
    t0 = time.perf_counter()
    inter = postproc_intermediates(infer, imgs)
    print("C4: INT_MAX pixels per tile in the compacted markers (ids the 3-pass compaction left "
          f"unresolved): {(inter['markers'] == cc_cuda.INT_MAX).sum((1, 2)).tolist()}")
    size_filter_phases(inter, kernels, phase_launches)
    watershed_phase(inter, masks, kernels, phase_launches)
    del inter
    conv_phase(infer, imgs, kernels, phase_launches)
    print(f"B9-B12 phases: {time.perf_counter() - t0:.1f} s")
    print_times({k: kernels[k] for k in phase_launches})
    del model, infer
    torch.cuda.empty_cache()

    # ---- main path 4: the WSI pipeline end to end, PNG patches to cells.json
    t0 = time.perf_counter()
    for name, n in wsi_phase(card).items():
        launches[name] += n
    print(f"WSI path: {time.perf_counter() - t0:.1f} s")

    # ---- main path 2: CellViT-SAM-H WSI tile inference, device stage
    model = random_sam_h(1, "cuda")
    set_probe_weights(model)
    infer = CellSegmentationInference(model=model, run_conf=run_conf, mixed_precision=True,
                                      batch_size=BATCH, device="cuda")
    params = list(infer.model.parameters())
    recast = lambda: [p.to(torch.bfloat16) for p in params]
    recast()
    print(f"CellViT-SAM-H: autocast re-casts {sum(p.numel() for p in params) / 1e9:.4f} G fp32 "
          f"parameters ({len(params)} tensors) to bf16 each forward: {queued_ms(recast):.3f} ms of "
          f"device time back to back, {time_ms(recast, 5):.3f} ms between events as the host "
          "enqueues them")
    del params
    sam_launches = drive("CellViT-SAM-H path", infer, imgs, {
        "window_qkv_attention": 28, "flash_attention_relpos": 4, "connected_components": 2,
        "flood": 1, "propagate_min": 1,
    }, card, embed=1280)
    for name, n in sam_launches.items():
        launches[name] += n

    # ---- one 224×256 tile through the SAM-H model: its global blocks see a
    # 14×16 grid and take B7. Held against the same forward with every SAM
    # attention on its plain version: each attention output then differs by
    # bf16 rounding (≈3e-3 of its size, the bounds above), and 32 residual
    # blocks carry that into the outputs, so they agree within PATH_L2.
    x = torch.from_numpy((imgs[:1, :SMALL_TILE[0], :SMALL_TILE[1]] - 0.5) / 0.5)
    x = x.to(dev, torch.bfloat16)
    _build.reset_launches()
    out = infer.forward_maps(x, retrieve_tokens=True)
    torch.cuda.synchronize()
    tile_launches = dict(_build.LAUNCHES)
    want = {"window_qkv_attention": 28, "window_attention": 4}
    print(f"224×256 tile: launches {tile_launches} (expected {want})")
    for name, n in tile_launches.items():
        require(n == want.get(name, 0), f"224×256 tile: {name} launched {n} times")
        launches[name] += n
    _build.reset_launches()
    with plain_sam_attention():
        ref = infer.forward_maps(x, retrieve_tokens=True)
    require(all(n == 0 for n in _build.LAUNCHES.values()), "the plain forward launched a kernel")
    require(out["tokens"].shape == (1, gh, gw, 1280), "unexpected token shape at 224×256")
    for key in ("tokens", "tissue_types", "type_map_cmajor", "np_prob", "hv0", "hv1"):
        a, b = out[key].float(), ref[key].float()
        rel = ((a - b).norm() / b.norm()).item()
        print(f"  224×256 tile {key}: relative L2 kernels vs plain {rel:.3e} (bound {PATH_L2:g}), "
              f"max|Δ| {(a - b).abs().max().item():.3e}")
        require(torch.isfinite(a).all().item() and rel <= PATH_L2,
                f"224×256 tile: {key} disagrees with the plain forward")
    del model, infer, out, ref
    torch.cuda.empty_cache()

    # ---- main path 3: CellViT-256 training on 4 × 1024² tiles
    for name, n in drive_training(card).items():
        launches[name] += n

    # ---- main path 5: the training CLI end to end, config to evaluated run
    t0 = time.perf_counter()
    for name, n in train_cli_phase(card).items():
        launches[name] += n
    print(f"training CLI phase: {time.perf_counter() - t0:.1f} s")

    for name, n in phase_launches.items():
        launches[name] += n
    rows = []
    for name, kd in kernels.items():
        ms, by = kd.pop("bound")
        rows.append(dict(name=name, route=kd["route"], source=kd["source"],
                         replaces=kd["replaces"], launches=launches[name],
                         max_abs_err=kd["max_abs_err"], ms=kd["ms"], plain_ms=kd["plain_ms"],
                         bound_ms=ms, bound_by=by, library_ms=kd["library_ms"]))
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
