"""DepthAnything: a DINOv2 encoder and the DPT head, the frozen monocular
depth tower of the 2D-3D model.

Counterpart of the JAX package's nn/depth_anything.py (the reference's
depth_anything/dpt.py and blocks.py), in NCHW:

  * the taps are the encoder's last 4 blocks with the final LayerNorm
    applied (``get_intermediate_layers(x, 4)``);
  * reassemble: per tap a 1 x 1 projection, then a learned resize:
    ConvTranspose k4 s4, ConvTranspose k2 s2, identity, a stride-2 3 x 3
    convolution with a symmetric pad of 1;
  * ``scratch.layerN_rn``: bias-free 3 x 3 convolutions to the fusion width;
  * ``scratch.refinenet4..1``: residual convolution units, an align-corners
    bilinear upsample, a 1 x 1 ``out_conv``;
  * the head: 3 x 3, upsample to 14 x the patch grid, 3 x 3, ReLU, 1 x 1,
    ReLU, an align-corners resize to the input's size, ReLU.

Parameter names are the reference's (``pretrained.*``, ``depth_head.*``).
The reference's ``refinenet4.resConfUnit1`` takes no input and has no
counterpart here; ``models/towers.py:load_tower_runner`` drops it from a
released state_dict.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.vision import resize_align_corners
from .dinov2 import DinoV2Config, DinoVisionTransformer


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    features: int = 256
    out_channels: Tuple[int, ...] = (256, 512, 1024, 1024)
    n_taps: int = 4          # the encoder's LAST n_taps blocks


class ResidualConvUnit(nn.Module):
    """relu, conv, relu, conv, plus the skip."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(torch.relu(self.conv1(torch.relu(x))))


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int, with_skip: bool = True):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features) if with_skip else None
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None, out_hw: Optional[Tuple[int, int]] = None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        if out_hw is None:
            out_hw = (2 * x.shape[-2], 2 * x.shape[-1])
        return self.out_conv(resize_align_corners(x, out_hw))


class _Scratch(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        f = cfg.features
        for i, oc in enumerate(cfg.out_channels):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(oc, f, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(f, with_skip=i < 4))
        self.output_conv1 = nn.Conv2d(f, f // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
                                          nn.Conv2d(32, 1, 1), nn.ReLU())


class DPTHead(nn.Module):
    def __init__(self, cfg: DPTConfig, embed_dim: int):
        super().__init__()
        oc = cfg.out_channels
        self.projects = nn.ModuleList(nn.Conv2d(embed_dim, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1)])
        self.scratch = _Scratch(cfg)

    def forward(self, taps: Sequence[torch.Tensor], out_hw: Tuple[int, int]):
        """taps: 4 patch-token grids [B, h, w, D], shallow to deep -> the
        non-negative relative depth (disparity) [B, H, W] at ``out_hw``."""
        ph, pw = taps[0].shape[1:3]
        s = self.scratch
        feats = []
        for i, tap in enumerate(taps):
            h = self.resize_layers[i](self.projects[i](tap.permute(0, 3, 1, 2)))
            feats.append(getattr(s, f"layer{i + 1}_rn")(h))
        p = s.refinenet4(feats[3], out_hw=feats[2].shape[-2:])
        p = s.refinenet3(p, feats[2], out_hw=feats[1].shape[-2:])
        p = s.refinenet2(p, feats[1], out_hw=feats[0].shape[-2:])
        p = s.refinenet1(p, feats[0])
        h = resize_align_corners(s.output_conv1(p), (14 * ph, 14 * pw))
        h = resize_align_corners(s.output_conv2(h), out_hw)
        return torch.relu(h)[:, 0]


class DepthAnything(nn.Module):
    """DINOv2 encoder + DPT head: image [B, 3, H, W] -> relative depth [B, H, W]."""

    def __init__(self, vit: DinoV2Config, dpt: DPTConfig):
        super().__init__()
        self.n_taps = dpt.n_taps
        self.pretrained = DinoVisionTransformer(vit)
        self.depth_head = DPTHead(dpt, vit.embed_dim)

    def forward(self, image):
        depth = self.pretrained.cfg.depth
        _, taps = self.pretrained(image, return_layers=tuple(range(depth - self.n_taps, depth)),
                                  norm_taps=True)
        return self.depth_head(taps, tuple(image.shape[-2:]))
