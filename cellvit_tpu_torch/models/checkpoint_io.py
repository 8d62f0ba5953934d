"""Weights for the port: reference `.pth` checkpoints and the JAX package's
variables (port of the CellViT part of `cellvit_tpu/models/checkpoint_io.py`).

The port's module names are the reference torch key names, so a reference
state dict loads as it is. `state_dict_from_flax` is this package's own copy
of the flax → torch key mapping and weight transposes
(`_flax_path_to_torch_key`, `_INVERSE`, `_inverse_patch`) for CellViT with a
histo or SAM encoder; it takes nested dicts of numpy arrays, so nothing of
JAX is needed.
"""

from __future__ import annotations

import pickle
import re
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from cellvit_tpu_torch.models.cellvit import BRANCHES, CellViT, CellViT256, CellViTSAM

# flax stage name in a tower → (torch Sequential name, number of ConvBNRelu)
_BRANCH_STAGES = {
    "d3_convs": ("decoder3_upsampler", 3),
    "d2_convs": ("decoder2_upsampler", 2),
    "d1_convs": ("decoder1_upsampler", 2),
    "d0_convs": ("decoder0_header", 2),
}
# tower's trailing module → its index in the torch Sequential
_BRANCH_TAILS = {
    "d3_up": ("decoder3_upsampler", 3),
    "d2_up": ("decoder2_upsampler", 2),
    "d1_up": ("decoder1_upsampler", 2),
    "header": ("decoder0_header", 2),
}
# SAM neck: Sequential indices 0 and 2 are the convs, 1 and 3 LayerNorm2d
_NECK = {
    "neck_conv1": ("neck.0", "conv"),
    "neck_ln1": ("neck.1", "norm"),
    "neck_conv2": ("neck.2", "conv"),
    "neck_ln2": ("neck.3", "norm"),
}

_INVERSE = {
    "linear": lambda w: w.T,
    "conv": lambda w: w.transpose(3, 2, 0, 1),    # (kh, kw, I, O) → (O, I, kh, kw)
    "deconv": lambda w: w.transpose(0, 3, 1, 2),  # (I, 2, 2, O) → (I, O, 2, 2)
    "none": lambda w: w,
}


def _inverse_patch(w: np.ndarray, patch: int, in_ch: int) -> np.ndarray:
    e = w.shape[-1]  # (p·p·C, E) → (E, C, p, p)
    return w.reshape(patch, patch, in_ch, e).transpose(3, 2, 0, 1)


def _leaf(leaf: str, kind: str, coll: str) -> Tuple[str, str]:
    """torch leaf name and transform for a flax leaf of a layer of `kind`."""
    if kind == "norm":
        if coll == "batch_stats":
            return ("running_mean" if leaf == "mean" else "running_var"), "none"
        return ("weight" if leaf == "scale" else "bias"), "none"
    if leaf == "kernel":
        return "weight", kind
    return "bias", "none"


def _conv_bn(inner: str, leaf: str, coll: str, idx: Dict[str, int]) -> Tuple[str, str]:
    kind = {"conv": "conv", "deconv": "deconv", "bn": "norm"}[inner]
    name, tf = _leaf(leaf, kind, coll)
    return f"block.{idx[inner]}.{name}", tf


def flax_path_to_torch_key(path: Tuple[str, ...], coll: str, sam: bool = False) -> Tuple[str, str]:
    """(torch key, transform) for one leaf of a CellViT's variables; `sam`
    for a SAM encoder (its MLP layers are `lin1`/`lin2`)."""
    parts, leaf = list(path), path[-1]
    if parts[0] == "classifier_head":
        name, tf = _leaf(leaf, "linear", coll)
        return f"classifier_head.{name}", tf
    if parts[0] == "encoder":
        sub = parts[1:]
        if sub[0] in ("cls_token", "pos_embed"):
            return f"encoder.{sub[0]}", "none"
        if sub[0] in _NECK:
            tname, kind = _NECK[sub[0]]
            name, tf = _leaf(leaf, kind, coll)
            return f"encoder.{tname}.{name}", tf
        if sub[0] == "patch_embed":
            return ("encoder.patch_embed.proj.weight", "patch") if leaf == "kernel" else (
                "encoder.patch_embed.proj.bias", "none")
        if sub[0] == "norm":
            name, tf = _leaf(leaf, "norm", coll)
            return f"encoder.norm.{name}", tf
        if sub[0] == "head":
            name, tf = _leaf(leaf, "linear", coll)
            return f"encoder.head.{name}", tf
        if sub[0].startswith("blocks_"):
            i, inner = sub[0].split("_")[1], sub[1]
            if inner in ("norm1", "norm2"):
                name, tf = _leaf(leaf, "norm", coll)
                return f"encoder.blocks.{i}.{inner}.{name}", tf
            if inner == "attn" and sub[2] in ("rel_pos_h", "rel_pos_w"):
                return f"encoder.blocks.{i}.attn.{sub[2]}", "none"
            if inner in ("attn", "mlp"):
                layer = {"fc1": "lin1", "fc2": "lin2"}.get(sub[2], sub[2]) if sam else sub[2]
                name, tf = _leaf(leaf, "linear", coll)
                return f"encoder.blocks.{i}.{inner}.{layer}.{name}", tf
        raise KeyError(f"unexportable path {path}")

    m = re.match(r"decoder(\d)_(\d+)$", parts[0])
    if m:
        d, j = m.group(1), m.group(2)
        idx = {"conv": 0, "bn": 1} if d == "0" else {"deconv": 0, "conv": 1, "bn": 2}
        key, tf = _conv_bn(parts[1], leaf, coll, idx)
        return f"decoder{d}.{j}.{key}", tf

    if parts[0] in BRANCHES:
        branch, inner = parts[0], parts[1]
        if inner == "bottleneck_upsampler":
            name, tf = _leaf(leaf, "deconv", coll)
            return f"{branch}.bottleneck_upsampler.{name}", tf
        if inner in _BRANCH_TAILS:
            stage, i = _BRANCH_TAILS[inner]
            name, tf = _leaf(leaf, "conv" if inner == "header" else "deconv", coll)
            return f"{branch}.{stage}.{i}.{name}", tf
        prefix, _, j = inner.rpartition("_")
        if prefix in _BRANCH_STAGES:
            stage, _ = _BRANCH_STAGES[prefix]
            key, tf = _conv_bn(parts[2], leaf, coll, {"conv": 0, "bn": 1})
            return f"{branch}.{stage}.{j}.{key}", tf
    raise KeyError(f"unexportable path {path}")


def state_dict_from_flax(
    params: Mapping[str, Any],
    batch_stats: Optional[Mapping[str, Any]] = None,
    patch_size: int = 16,
    in_chans: int = 3,
) -> Dict[str, torch.Tensor]:
    """The JAX package's CellViT variables (nested dicts of arrays) → this
    package's state dict, fp32 tensors under the reference torch key names.
    A SAM encoder is recognised by its neck."""
    out: Dict[str, torch.Tensor] = {}
    sam = "neck_conv1" in params.get("encoder", {})

    def walk(node: Mapping[str, Any], path: Tuple[str, ...], coll: str) -> None:
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,), coll)
                continue
            key, tf = flax_path_to_torch_key(path + (k,), coll, sam)
            arr = np.asarray(v, dtype=np.float32)
            arr = _inverse_patch(arr, patch_size, in_chans) if tf == "patch" else _INVERSE[tf](arr)
            out[key] = torch.from_numpy(np.array(arr, np.float32))  # a writable copy

    walk(params, (), "params")
    walk(batch_stats or {}, (), "batch_stats")
    return out


def load_state_dict_into(model: torch.nn.Module, state_dict: Mapping[str, Any]) -> None:
    """Strict `load_state_dict`, tolerating only absent BatchNorm
    `num_batches_tracked` counters (unused at inference)."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    for key, buf in model.state_dict().items():
        if key.endswith("num_batches_tracked") and key not in sd:
            sd[key] = torch.zeros_like(buf)
    model.load_state_dict(sd, strict=True)


def unflatten_dict(flat: Mapping[str, Any], sep: str = ".") -> Dict[str, Any]:
    """'a.b.c': v → {'a': {'b': {'c': v}}}."""
    out: Dict[str, Any] = {}
    for key, val in flat.items():
        node = out
        parts = key.split(sep)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def build_model_from_config(arch: str, run_conf: Mapping[str, Any]) -> CellViT:
    """Rebuild the model from a checkpoint's config."""
    data, mcfg = run_conf["data"], run_conf.get("model", {})
    common = dict(
        num_nuclei_classes=data["num_nuclei_classes"],
        num_tissue_classes=data["num_tissue_classes"],
        regression_loss=mcfg.get("regression_loss", False),
    )
    if arch == "CellViT256":
        return CellViT256(**common)
    if arch == "CellViT":
        return CellViT(
            embed_dim=mcfg["embed_dim"], depth=mcfg["depth"], num_heads=mcfg["num_heads"],
            extract_layers=tuple(mcfg["extract_layers"]), encoder_type="histo", **common,
        )
    if arch == "CellViTSAM":
        return CellViTSAM(vit_structure=mcfg["backbone"], **common)
    raise NotImplementedError(f"arch {arch!r} is not ported yet")


def load_checkpoint(
    path: Union[str, Path],
) -> Tuple[CellViT, Dict[str, torch.Tensor], Dict[str, Any]]:
    """Read a reference training checkpoint (`arch`, `model_state_dict`,
    flattened `config`): returns (model with the weights loaded, state dict,
    run config). Tensor-only checkpoints load with `weights_only=True`; a
    checkpoint whose config holds other Python objects needs full unpickling."""
    try:
        ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    run_conf = unflatten_dict(ckpt["config"])
    model = build_model_from_config(ckpt["arch"], run_conf)
    state_dict = ckpt["model_state_dict"]
    load_state_dict_into(model, state_dict)
    return model, state_dict, run_conf
