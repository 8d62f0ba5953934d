"""Chip smoke test of the PyTorch/CUDA port (`cellvit_tpu_torch`) on one GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and the versions.
2. Builds every hand-written kernel from `cellvit_tpu_torch/csrc/` with nvcc.
3. Holds each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it: flash attention (8, 4097, 6, 64) bf16 within a
   bf16 output bound; the segmented-scan kernels on (8, 1024, 1024) blob
   masks with an L/U shape and a spiral that 3 passes do not converge,
   exactly; SAM-H's fused window qkv attention on 200 windows of 196 tokens
   (C = 1280), its direct-bias flash attention on (8, 4096, 16, 80) and its
   whole-window attention on a 14×16 grid, each within its bf16 bound.
   Each phase times the kernel, the plain version and, where one exists, one
   PyTorch library call of the same function, beside the least time the card
   could take.
4. Drives the main paths through `CellSegmentationInference` on batches of
   8 × 1024² synthetic blob tiles, bf16, one warm-up batch and timed
   batches each: a full-width CellViT-256, then a full-width CellViT-SAM-H
   (random weights from a seed, with probe weights on the image skip path
   so the nucleus and HV maps follow the tiles). It checks each path's
   kernel launch counts, its outputs, and one tile's instance map against
   the port's CPU path on the same forward outputs.
5. Drives one 224×256 tile through the SAM-H model, whose global blocks then
   take the whole-window kernel, and holds its outputs against the same
   forward with every SAM attention on its plain version.
6. Prints a JSON line of the ported kernels, then the card's name and power
   limit, and last `{"ok": true, "device": {...}}`.

Exits non-zero, without the last line, when no GPU is present or any phase
fails.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
BATCH, TILE = 8, 1024
TIMED_BATCHES = 2
SMALL_TILE = (224, 256)  # its SAM global grid, 14×16, takes the whole-window kernel
#: relative L2 of the 224×256 tile's outputs, kernels against plain versions
PATH_L2 = 5e-2


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


def bound_ms(n_bytes: float, n_flops: float = 0.0):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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
    from cellvit_tpu_torch.models.fused import forward_maps
    from cellvit_tpu_torch.ops.hv_postproc import instance_map_batch_maps

    x = torch.from_numpy((imgs[:1] - 0.5) / 0.5).to(infer.device, torch.bfloat16)
    out = forward_maps(infer.model, x)
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
    b1_bound = bound_ms(
        4 * BATCH * n_tok * heads * hd * 2 + BATCH * heads * n_tok * 4,
        4.0 * BATCH * heads * n_tok * n_tok * hd,
    )
    kernels["flash_attention"] = dict(
        route="cuda", source="cellvit_tpu_torch/csrc/flash_attn.cu",
        replaces="cellvit_tpu/ops/attention.py:32", max_abs_err=max_err,
        ms=time_ms(lambda: attention.flash_attention(q, k, v), 20),
        plain_ms=time_ms(lambda: attention.flash_attention_plain(q, k, v), 3),
        library_ms=time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), 20),
        bound=b1_bound,
    )
    del qkv, q, k, v, o, po, lse, plse, qt, kt, vt

    # ---- B2-B4 segmented scans on blob masks + U shape + spiral
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
    kernels["connected_components"] = dict(
        route="cuda", source="cellvit_tpu_torch/csrc/seg_scan.cu",
        replaces="cellvit_tpu/ops/cc_pallas.py:75", max_abs_err=float(n_diff),
        ms=time_ms(lambda: cc_cuda.connected_components_cuda(fg, 3)),
        plain_ms=time_ms(lambda: cc_cuda.connected_components_plain(fg, 3), 3),
        library_ms=None, bound=bound_ms(n_px * 1 + n_px * 4),
    )

    seed = cc_cuda.border_seed(fg)
    open_ = ~fg
    reach = cc_cuda.flood_cuda(seed, open_, 2)
    n_diff = int((reach != cc_cuda.flood_plain(seed, open_, 2)).sum())
    print(f"B3 flood: {n_diff} px differ (exact required)")
    require(n_diff == 0, "flood kernel disagrees")
    kernels["flood"] = dict(
        route="cuda", source="cellvit_tpu_torch/csrc/seg_scan.cu",
        replaces="cellvit_tpu/ops/cc_pallas.py:225", max_abs_err=float(n_diff),
        ms=time_ms(lambda: cc_cuda.flood_cuda(seed, open_, 2)),
        plain_ms=time_ms(lambda: cc_cuda.flood_plain(seed, open_, 2), 3),
        library_ms=None, bound=bound_ms(2 * n_px + n_px),
    )

    lab_fg = lab > 0
    rank_seed = cc_cuda.root_rank_seed(lab)
    pm = cc_cuda.propagate_min_cuda(rank_seed, lab_fg, 3)
    n_diff = int((pm != cc_cuda.propagate_min_plain(rank_seed, lab_fg, 3)).sum())
    print(f"B4 propagate-min: {n_diff} px differ (exact required)")
    require(n_diff == 0, "propagate-min kernel disagrees")
    kernels["propagate_min"] = dict(
        route="cuda", source="cellvit_tpu_torch/csrc/seg_scan.cu",
        replaces="cellvit_tpu/ops/cc_pallas.py:118", max_abs_err=float(n_diff),
        ms=time_ms(lambda: cc_cuda.propagate_min_cuda(rank_seed, lab_fg, 3)),
        plain_ms=time_ms(lambda: cc_cuda.propagate_min_plain(rank_seed, lab_fg, 3), 3),
        library_ms=None, bound=bound_ms(n_px * 4 + n_px + n_px * 4),
    )
    del fg, lab, plab, seed, open_, reach, lab_fg, rank_seed, pm

    # ---- B5 fused window qkv attention at SAM-H's windowed blocks: 8 tiles'
    # 64×64 token grids of LN'd-like tokens cut into 200 zero-padded windows
    c, heads, hd, win = 1280, 16, 80, 14
    gen = torch.Generator(device=dev).manual_seed(1)
    grid = torch.randn((BATCH, TILE // 16, TILE // 16, c), generator=gen, device=dev)
    x = window_partition(grid, win)[0].reshape(-1, win * win, c).to(torch.bfloat16).contiguous()
    del grid
    w_lin = (torch.randn((3 * c, c), generator=gen, device=dev) * c**-0.5).to(torch.bfloat16)
    b_lin = (torch.randn(3 * c, generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    rh, rw = ((torch.randn((win, win, hd), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
              for _ in range(2))
    args = (x, w_lin.t(), b_lin, rh, rw, heads)  # the qkv Linear's weight, as the model passes it
    o = attention.window_qkv_attention(*args)
    po = attention.window_qkv_attention_plain(*args)
    max_err = check_attention("B5 window qkv attention", o, po, attention.WIN_QKV_BOUNDS)
    nw, n = x.shape[:2]
    kernels["window_qkv_attention"] = dict(
        route="cuda", source="cellvit_tpu_torch/csrc/win_qkv_attn.cu",
        replaces="cellvit_tpu/ops/attention.py:862", max_abs_err=max_err,
        ms=time_ms(lambda: attention.window_qkv_attention(*args), 10),
        plain_ms=time_ms(lambda: attention.window_qkv_attention_plain(*args), 3),
        library_ms=None,
        bound=bound_ms(
            2 * (2 * x.numel() + w_lin.numel() + b_lin.numel() + rh.numel() + rw.numel()),
            2.0 * nw * n * c * 3 * c + 4.0 * nw * heads * n * n * hd + 4.0 * nw * heads * n * win * hd,
        ),
    )
    del x, w_lin, b_lin, rh, rw, args, o, po

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
    kernels["flash_attention_relpos"] = dict(
        route="cuda", source="cellvit_tpu_torch/csrc/relpos_attn.cu",
        replaces="cellvit_tpu/ops/attention.py:190", max_abs_err=max_err,
        ms=time_ms(lambda: attention.relpos_flash_attention(q, k, v, bh, bw), 10),
        plain_ms=time_ms(lambda: attention.relpos_attention_plain(q, k, v, bh, bw), 3),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias), 5),
        bound=bound_ms(2 * (4 * q.numel() + bh.numel() + bw.numel()),
                       4.0 * BATCH * heads * n * n * hd),
    )
    del qkv, q, k, v, rh, rw, bh, bw, o, po, bias, qt, kt, vt

    # ---- B7 whole-window attention at a 224×256 tile's global blocks (14×16)
    gh, gw = SMALL_TILE[0] // 16, SMALL_TILE[1] // 16
    n = gh * gw
    qkv = torch.randn((1, n, 3, heads, hd), generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    rh = (torch.randn((gh, gh, hd), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    rw = (torch.randn((gw, gw, hd), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    qa, ka = attention.relpos_aug(q, k, *attention.rel_pos_bias(q, rh, rw, (gh, gw)), (gh, gw))
    o = attention.window_attention(qa, ka, v)
    po = attention.window_attention_plain(qa, ka, v)
    max_err = check_attention("B7 window attention", o, po, attention.WINDOW_BOUNDS)
    qt, kt, vt = (t.transpose(1, 2) for t in (qa, ka, v))
    kernels["window_attention"] = dict(
        route="cuda", source="cellvit_tpu_torch/csrc/win_attn.cu",
        replaces="cellvit_tpu/ops/attention.py:257", max_abs_err=max_err,
        ms=time_ms(lambda: attention.window_attention(qa, ka, v), 20),
        plain_ms=time_ms(lambda: attention.window_attention_plain(qa, ka, v), 10),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=1.0), 20),
        bound=bound_ms(2 * (qa.numel() + ka.numel() + 2 * v.numel()),
                       2.0 * heads * n * n * (qa.shape[-1] + hd)),
    )
    del qkv, q, k, v, rh, rw, qa, ka, o, po, qt, kt, vt
    for name, kd in kernels.items():
        print(f"  {name}: kernel_ms {kd['ms']:.4f} plain_ms {kd['plain_ms']:.4f} "
              f"library_ms {kd['library_ms']} bound_ms {kd['bound'][0]:.4f} ({kd['bound'][1]})")

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
    del model, infer
    torch.cuda.empty_cache()

    # ---- main path 2: CellViT-SAM-H WSI tile inference, device stage
    model = random_sam_h(1, "cuda")
    set_probe_weights(model)
    infer = CellSegmentationInference(model=model, run_conf=run_conf, mixed_precision=True,
                                      batch_size=BATCH, device="cuda")
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
    from cellvit_tpu_torch.models.fused import forward_maps

    x = torch.from_numpy((imgs[:1, :SMALL_TILE[0], :SMALL_TILE[1]] - 0.5) / 0.5)
    x = x.to(dev, torch.bfloat16)
    _build.reset_launches()
    out = forward_maps(infer.model, x, retrieve_tokens=True)
    torch.cuda.synchronize()
    tile_launches = dict(_build.LAUNCHES)
    want = {"window_qkv_attention": 28, "window_attention": 4}
    print(f"224×256 tile: launches {tile_launches} (expected {want})")
    for name, n in tile_launches.items():
        require(n == want.get(name, 0), f"224×256 tile: {name} launched {n} times")
        launches[name] += n
    _build.reset_launches()
    with plain_sam_attention():
        ref = forward_maps(infer.model, x, retrieve_tokens=True)
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
