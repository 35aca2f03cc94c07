"""DINOv2 vision transformer: the frozen image tower of the 2D-3D model.

Counterpart of the JAX package's nn/dinov2.py (the reference's vendored
DinoVisionTransformer): patch 14, pre-norm blocks with LayerScale, an exact
GELU MLP, LayerNorm eps 1e-6, a cls token and position embeddings resized
bicubically (antialiased, half-pixel centres, as ``jax.image.resize``) to the
image's patch grid. The attention is a plain matmul, softmax, matmul in
float32, as the JAX package computes it.

Parameter names are the reference torch module's (``cls_token``,
``pos_embed``, ``patch_embed.proj``, ``blocks.{i}.{norm1, attn.qkv,
attn.proj, ls1.gamma, norm2, mlp.fc1, mlp.fc2, ls2.gamma}``, ``norm``), so a
released state_dict loads as it is (``models/towers.py:load_tower_runner``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.vision import resize


@dataclasses.dataclass(frozen=True)
class DinoV2Config:
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    layerscale_init: float = 1e-5
    img_size: int = 518          # the position embeddings' native grid (37 x 37)


def vit_large_config() -> DinoV2Config:
    return DinoV2Config()


def vit_base_config() -> DinoV2Config:
    return DinoV2Config(embed_dim=768, depth=12, num_heads=12)


def vit_small_config() -> DinoV2Config:
    return DinoV2Config(embed_dim=384, depth=12, num_heads=6)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init)))

    def forward(self, x):
        return x * self.gamma


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, dim = x.shape
        h = self.num_heads
        d = dim // h
        q, k, v = self.qkv(x).reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4)  # 3 x [b, h, n, d]
        a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d), dim=-1)
        return self.proj((a @ v).transpose(1, 2).reshape(b, n, dim))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class Block(nn.Module):
    def __init__(self, cfg: DinoV2Config):
        super().__init__()
        dim = cfg.embed_dim
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, cfg.num_heads)
        self.ls1 = LayerScale(dim, cfg.layerscale_init)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio))
        self.ls2 = LayerScale(dim, cfg.layerscale_init)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: DinoV2Config, in_channels: int = 3):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, cfg.embed_dim, cfg.patch_size, cfg.patch_size)

    def forward(self, image):
        return self.proj(image).flatten(2).transpose(1, 2)


class DinoVisionTransformer(nn.Module):
    def __init__(self, cfg: DinoV2Config):
        super().__init__()
        self.cfg = cfg
        grid = cfg.img_size // cfg.patch_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, cfg.embed_dim))
        self.patch_embed = PatchEmbed(cfg)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=1e-6)

    def forward(self, image, return_layers: Sequence[int] = (),
                norm_taps: bool = False) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """image [B, C, H, W] (H, W multiples of the patch size) -> (final
        patch tokens [B, h*w, D], the patch-token grids [B, h, w, D] of the
        blocks ``return_layers``, all blocks when empty). ``norm_taps`` applies
        the final LayerNorm to each tap (torch hub's
        ``get_intermediate_layers(..., norm=True)``, which DepthAnything reads)."""
        c = self.cfg
        b, _, hh, ww = image.shape
        ph, pw = hh // c.patch_size, ww // c.patch_size
        x = torch.cat([self.cls_token.expand(b, 1, c.embed_dim), self.patch_embed(image)], dim=1)
        grid = c.img_size // c.patch_size
        pos_cls, pos_patch = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if (ph, pw) != (grid, grid):
            pos_patch = pos_patch.reshape(1, grid, grid, c.embed_dim).permute(0, 3, 1, 2)
            pos_patch = resize(pos_patch, (ph, pw), "bicubic").flatten(2).transpose(1, 2)
        x = x + torch.cat([pos_cls, pos_patch], dim=1)
        want = set(return_layers) if return_layers else set(range(c.depth))
        taps = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in want:
                t = self.norm(x) if norm_taps else x
                taps.append(t[:, 1:].reshape(b, ph, pw, c.embed_dim))
        return self.norm(x)[:, 1:], taps
