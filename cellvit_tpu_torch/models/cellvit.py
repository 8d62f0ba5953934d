"""CellViT with a ViT-256 or SAM encoder and HoVer-Net decoder towers (port
of `cellvit_tpu/models/cellvit.py`).

Module attribute names follow the reference torch CellViT (the keys that
`cellvit_tpu.models.checkpoint_io.export_torch_state_dict` emits), so a
reference state dict loads with `load_state_dict`:

  encoder.*                      HistoViT, or SamViT
  classifier_head.*              tissue head on the pooled SAM neck (SAM only)
  decoder0.{j}.block.*           Conv2DBlocks on the image (skip p0)
  decoder1..3.{j}.block.*        Deconv2DBlocks on skip tokens (p1..p3)
  {branch}.bottleneck_upsampler  ConvT on the last skip (z4)
  {branch}.decoder3_upsampler / decoder2_upsampler / decoder1_upsampler /
  {branch}.decoder0_header       fuse/upsample stages, 1×1 header last

The shared skip projections run once and feed all three towers (the
reference re-runs them per tower — identical outputs at inference; the JAX
package runs them once in training too). `forward` keeps the JAX package's
NHWC layout at its inputs and outputs. `train()` switches BatchNorm to batch
statistics and turns on the dropouts and the encoder's drop-path.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from cellvit_tpu_torch.models.layers import ConvBNRelu, ConvTranspose2x2, DeconvBlock
from cellvit_tpu_torch.models.sam_vit import SamViT
from cellvit_tpu_torch.models.vit import HistoViT

BRANCHES = (
    "nuclei_binary_map_decoder",
    "hv_map_decoder",
    "nuclei_type_maps_decoder",
)


class UpsamplingBranch(nn.Module):
    """One decoder tower: bottleneck ConvT + 4 fuse/upsample stages."""

    def __init__(self, embed_dim: int, num_classes: int, bottleneck_dim: int,
                 dropout: float = 0.0) -> None:
        super().__init__()
        bott, d = bottleneck_dim, dropout
        self.bottleneck_upsampler = ConvTranspose2x2(embed_dim, bott)
        self.decoder3_upsampler = nn.Sequential(
            ConvBNRelu(2 * bott, bott, dropout=d),
            ConvBNRelu(bott, bott, dropout=d),
            ConvBNRelu(bott, bott, dropout=d),
            ConvTranspose2x2(bott, 256),
        )
        self.decoder2_upsampler = nn.Sequential(
            ConvBNRelu(2 * 256, 256, dropout=d),
            ConvBNRelu(256, 256, dropout=d),
            ConvTranspose2x2(256, 128),
        )
        self.decoder1_upsampler = nn.Sequential(
            ConvBNRelu(2 * 128, 128, dropout=d),
            ConvBNRelu(128, 128, dropout=d),
            ConvTranspose2x2(128, 64),
        )
        self.decoder0_header = nn.Sequential(
            ConvBNRelu(2 * 64, 64, dropout=d),
            ConvBNRelu(64, 64, dropout=d),
            nn.Conv2d(64, num_classes, 1),
        )

    def forward(self, p0, p1, p2, p3, z4) -> torch.Tensor:
        x = self.bottleneck_upsampler(z4)
        x = self.decoder3_upsampler(torch.cat([p3, x], dim=1))
        x = self.decoder2_upsampler(torch.cat([p2, x], dim=1))
        x = self.decoder1_upsampler(torch.cat([p1, x], dim=1))
        return self.decoder0_header(torch.cat([p0, x], dim=1))


class CellViT(nn.Module):
    """CellViT segmentation model (HoVer-Net heads). `encoder_type` "histo"
    is the ViT-256/DINO encoder with its CLS-token tissue head; "sam" is the
    SAM ViTDet encoder (`global_attn_indexes`, `window_size`, a
    `prompt_embed_dim`-channel neck) with `classifier_head` on the pooled
    neck.

    forward(x: (B, H, W, 3) normalised) returns a dict:
      tissue_types       (B, num_tissue_classes)        raw logits
      nuclei_binary_map  (B, H, W, 2)                   raw logits
      hv_map             (B, H, W, 2)
      nuclei_type_map    (B, H, W, num_nuclei_classes)  raw logits
      [regression_map    (B, H, W, 2)]                  if regression_loss
      [tokens            (B, Ht, Wt, E)]                if retrieve_tokens

    `drop_rate` acts in the histo encoder and after every decoder
    ConvBNRelu; `attn_drop_rate` and `drop_path_rate` in the histo encoder
    (the SAM encoder has none, as in the JAX package).
    """

    def __init__(self, num_nuclei_classes: int, num_tissue_classes: int, embed_dim: int,
                 depth: int, num_heads: int, extract_layers: Sequence[int],
                 encoder_type: str = "histo", mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, regression_loss: bool = False,
                 global_attn_indexes: Sequence[int] = (), window_size: int = 14,
                 prompt_embed_dim: int = 256, patch_size: int = 16) -> None:
        super().__init__()
        if len(extract_layers) != 4:
            raise ValueError("need 4 skip connections")
        self.num_nuclei_classes = num_nuclei_classes
        self.num_tissue_classes = num_tissue_classes
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.extract_layers = tuple(extract_layers)
        self.encoder_type = encoder_type
        self.patch_size = patch_size
        self.regression_loss = regression_loss
        if encoder_type == "histo":
            self.encoder = HistoViT(
                embed_dim=embed_dim, depth=depth, num_heads=num_heads, mlp_ratio=mlp_ratio,
                qkv_bias=qkv_bias, num_classes=num_tissue_classes, patch_size=patch_size,
                extract_layers=extract_layers, dropout=drop_rate, attn_dropout=attn_drop_rate,
                drop_path_rate=drop_path_rate,
            )
        elif encoder_type == "sam":
            self.encoder = SamViT(
                embed_dim=embed_dim, depth=depth, num_heads=num_heads, mlp_ratio=mlp_ratio,
                qkv_bias=qkv_bias, out_chans=prompt_embed_dim, patch_size=patch_size,
                window_size=window_size, global_attn_indexes=global_attn_indexes,
                extract_layers=extract_layers,
            )
            self.classifier_head = nn.Linear(prompt_embed_dim, num_tissue_classes)
        else:
            raise ValueError(f"unknown encoder_type {encoder_type!r}")
        s11, s12, bott = self.skip_dims
        d = drop_rate
        self.decoder0 = nn.Sequential(ConvBNRelu(3, 32, dropout=d), ConvBNRelu(32, 64, dropout=d))
        self.decoder1 = nn.Sequential(
            DeconvBlock(embed_dim, s11, dropout=d),
            DeconvBlock(s11, s12, dropout=d),
            DeconvBlock(s12, 128, dropout=d),
        )
        self.decoder2 = nn.Sequential(
            DeconvBlock(embed_dim, s11, dropout=d), DeconvBlock(s11, 256, dropout=d)
        )
        self.decoder3 = nn.Sequential(DeconvBlock(embed_dim, bott, dropout=d))
        offset = 2 if regression_loss else 0
        self.nuclei_binary_map_decoder = UpsamplingBranch(embed_dim, 2 + offset, bott, d)
        self.hv_map_decoder = UpsamplingBranch(embed_dim, 2, bott, d)
        self.nuclei_type_maps_decoder = UpsamplingBranch(embed_dim, num_nuclei_classes, bott, d)

    @property
    def skip_dims(self) -> Tuple[int, int, int]:
        if self.embed_dim < 512:
            return 256, 128, 312
        return 512, 256, 512

    def encode_features(self, x: torch.Tensor, freeze_encoder: bool = False):
        """Encoder + shared skip projections for NHWC `x`: returns
        ({"tissue_types"}, (p0..p3) NCHW, z4 NCHW). With `freeze_encoder`
        the encoder runs without autograd except its tissue head (the
        reference `freeze_encoder` keeps the head trainable; SAM's
        `classifier_head` sits outside the encoder)."""
        b, h, w, _ = x.shape
        if h % self.patch_size or w % self.patch_size:
            raise ValueError(f"input {h}×{w} is not a multiple of the patch size")
        ht, wt = h // self.patch_size, w // self.patch_size
        xc = x.to(self.encoder.patch_embed.proj.weight.dtype).permute(0, 3, 1, 2)
        with torch.set_grad_enabled(torch.is_grad_enabled() and not freeze_encoder):
            logits_or_pooled, cls_token, skips = self.encoder(xc)
        if self.encoder_type == "histo":
            tissue = self.encoder.head(cls_token) if freeze_encoder else logits_or_pooled
            # skips are token sequences with a CLS token first
            skips = [z[:, 1:, :].reshape(b, ht, wt, z.shape[-1]) for z in skips]
        else:  # skips are (B, Ht, Wt, E) already
            tissue = self.classifier_head(logits_or_pooled)
        z1, z2, z3, z4 = (z.permute(0, 3, 1, 2) for z in skips)
        p0 = self.decoder0(xc)
        p1 = self.decoder1(z1)
        p2 = self.decoder2(z2)
        p3 = self.decoder3(z3)
        return {"tissue_types": tissue}, (p0, p1, p2, p3), z4

    def forward(self, x: torch.Tensor, retrieve_tokens: bool = False,
                freeze_encoder: bool = False) -> Dict[str, torch.Tensor]:
        out, (p0, p1, p2, p3), z4 = self.encode_features(x, freeze_encoder)
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        nb = nhwc(self.nuclei_binary_map_decoder(p0, p1, p2, p3, z4))
        if self.regression_loss:
            out["nuclei_binary_map"] = nb[..., :2]
            out["regression_map"] = nb[..., 2:]
        else:
            out["nuclei_binary_map"] = nb
        out["hv_map"] = nhwc(self.hv_map_decoder(p0, p1, p2, p3, z4))
        out["nuclei_type_map"] = nhwc(self.nuclei_type_maps_decoder(p0, p1, p2, p3, z4))
        if retrieve_tokens:
            out["tokens"] = nhwc(z4)
        return out


def CellViT256(num_nuclei_classes: int, num_tissue_classes: int, drop_rate: float = 0.0,
               attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
               regression_loss: bool = False) -> CellViT:
    """CellViT with the HIPT/DINO ViT-256 backbone: embed 384, depth 12,
    heads 6, skips at blocks 3/6/9/12."""
    return CellViT(
        num_nuclei_classes=num_nuclei_classes, num_tissue_classes=num_tissue_classes,
        embed_dim=384, depth=12, num_heads=6, extract_layers=(3, 6, 9, 12),
        encoder_type="histo", drop_rate=drop_rate, attn_drop_rate=attn_drop_rate,
        drop_path_rate=drop_path_rate, regression_loss=regression_loss,
    )


SAM_CONFIGS = {
    # reference cellvit.py:646-665
    "SAM-B": dict(embed_dim=768, depth=12, num_heads=12,
                  global_attn_indexes=(2, 5, 8, 11), extract_layers=(3, 6, 9, 12)),
    "SAM-L": dict(embed_dim=1024, depth=24, num_heads=16,
                  global_attn_indexes=(5, 11, 17, 23), extract_layers=(6, 12, 18, 24)),
    "SAM-H": dict(embed_dim=1280, depth=32, num_heads=16,
                  global_attn_indexes=(7, 15, 23, 31), extract_layers=(8, 16, 24, 32)),
}


def CellViTSAM(num_nuclei_classes: int, num_tissue_classes: int, vit_structure: str,
               drop_rate: float = 0.0, regression_loss: bool = False) -> CellViT:
    """CellViT with a SAM ViTDet backbone; `vit_structure` is SAM-B, SAM-L or
    SAM-H (window 14, a 256-channel neck)."""
    return CellViT(
        num_nuclei_classes=num_nuclei_classes, num_tissue_classes=num_tissue_classes,
        encoder_type="sam", drop_rate=drop_rate, regression_loss=regression_loss,
        **SAM_CONFIGS[vit_structure.upper()],
    )
