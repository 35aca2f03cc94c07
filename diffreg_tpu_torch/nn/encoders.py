"""Frozen CNN feature pyramids of the 2D-3D branch (the reference's
encoders.py).

Counterpart of the JAX package's nn/encoders.py. ``VGG19BN`` is torchvision's
``vgg19_bn().features[:40]`` as the reference uses it: conv / BatchNorm /
ReLU stacks, each block's activation kept before its max pool, at scales 1,
2, 4 and 8. BatchNorm always runs on its running statistics (the tower is
frozen). ``CNNandDinov2`` adds the DINOv2 ViT's final patch tokens at scale
16. NCHW in and out; submodules carry the JAX package's names (``conv0``,
``bn0``, ..., ``cnn``, ``dinov2``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.precision import pin_float32
from .dinov2 import DinoV2Config, DinoVisionTransformer

# torchvision vgg19_bn features[:40]: (convs, width) of each block before its max pool
VGG19_PLAN: Tuple[Tuple[int, int], ...] = ((2, 64), (2, 128), (4, 256), (4, 512))


class VGG19BN(nn.Module):
    """image [B, C, H, W] -> {1: [B, 64, H, W], 2: 128 ch at H/2, 4: 256 at H/4,
    8: 512 at H/8}."""

    def __init__(self, plan: Tuple[Tuple[int, int], ...] = VGG19_PLAN, in_channels: int = 3):
        super().__init__()
        pin_float32()
        self.plan = tuple(plan)
        li = 0
        for n_convs, width in self.plan:
            for _ in range(n_convs):
                self.add_module(f"conv{li}", nn.Conv2d(in_channels, width, 3, 1, 1))
                self.add_module(f"bn{li}", nn.BatchNorm2d(width, eps=1e-5))
                in_channels = width
                li += 1

    def forward(self, image) -> Dict[int, torch.Tensor]:
        x, feats, scale, li = image, {}, 1, 0
        for n_convs, _ in self.plan:
            for _ in range(n_convs):
                bn = getattr(self, f"bn{li}")
                x = F.relu(F.batch_norm(getattr(self, f"conv{li}")(x), bn.running_mean,
                                        bn.running_var, bn.weight, bn.bias, training=False,
                                        eps=bn.eps))
                li += 1
            feats[scale] = x
            scale *= 2
            x = F.max_pool2d(x, 2, 2)
        return feats


class CNNandDinov2(nn.Module):
    """The VGG pyramid and the ViT's final (normed) patch tokens: {1, 2, 4, 8:
    VGG features, 16: tokens [B, D, H / patch, W / patch]}."""

    def __init__(self, vit: DinoV2Config):
        super().__init__()
        self.vit = vit
        self.cnn = VGG19BN()
        self.dinov2 = DinoVisionTransformer(vit)

    def forward(self, image_rgb) -> Dict[int, torch.Tensor]:
        feats = self.cnn(image_rgb)
        b, _, h, w = image_rgb.shape
        p = self.vit.patch_size
        tokens, _ = self.dinov2(image_rgb, return_layers=(self.vit.depth - 1,))
        feats[16] = tokens.reshape(b, h // p, w // p, self.vit.embed_dim).permute(0, 3, 1, 2)
        return feats
