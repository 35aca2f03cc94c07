"""Cross-modal fusion transformer: image tokens <-> point tokens.

Counterpart of the JAX package's nn/fusion.py (the 2D-3D experiment's
CrossModalFusionModule): linear projections of both sides into the hidden
width (with ``dino_dim``, the image side's projection concatenated with a
projection of the DINOv2 tokens, a ReLU and a projection back to the hidden
width), Fourier embeddings of the normalised pixels and of the centred
points, then interleaved self and cross TransformerLayers.
One layer serves both sides of a block. Its 12 attention calls per pass
(image self, node self, image -> node, node -> image, three times) go
through the masked-attention kernel on CUDA tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .layers2d3d import TransformerLayer, fourier_embedding


class CrossModalFusionModule(nn.Module):
    def __init__(self, img_dim: int, pcd_dim: int, output_dim: int, hidden_dim: int,
                 num_heads: int, blocks: Tuple[str, ...] = ("self", "cross") * 3,
                 embedding_dim: int = 10, dino_dim: Optional[int] = None):
        super().__init__()
        self.blocks = tuple(blocks)
        self.embedding_dim = embedding_dim
        self.img_in_proj = nn.Linear(img_dim, hidden_dim)
        self.use_dino = bool(dino_dim)
        if self.use_dino:
            self.img_in_proj_dino = nn.Linear(dino_dim, hidden_dim)
            self.img_in_proj_all = nn.Linear(2 * hidden_dim, hidden_dim)
        self.pcd_in_proj = nn.Linear(pcd_dim, hidden_dim)
        self.img_emb_proj = nn.Linear(2 * (2 * embedding_dim + 1), hidden_dim)
        self.pcd_emb_proj = nn.Linear(3 * (2 * embedding_dim + 1), hidden_dim)
        self.transformer = nn.ModuleList(TransformerLayer(hidden_dim, num_heads)
                                         for _ in self.blocks)
        self.out_proj = nn.Linear(hidden_dim, output_dim)

    def forward(self, img_feats, img_pixels, pcd_feats, pcd_points, img_valid=None,
                pcd_valid=None, img_feats_dino=None):
        """img_feats [B, HW, Ci], img_pixels [B, HW, 2] (normalised), pcd_feats
        [B, N, Cp], pcd_points [B, N, 3], with ``dino_dim`` img_feats_dino
        [B, HW, dino_dim] -> (image tokens, point tokens)."""
        img = self.img_in_proj(img_feats)
        if self.use_dino:
            img = self.img_in_proj_all(torch.relu(torch.cat(
                [img, self.img_in_proj_dino(img_feats_dino)], dim=-1)))
        img = img + self.img_emb_proj(fourier_embedding(img_pixels, self.embedding_dim))
        # the centroid is taken over the valid nodes only: padding must not move it
        if pcd_valid is not None:
            w = pcd_valid[..., None].to(pcd_points.dtype)
            mean = torch.sum(pcd_points * w, dim=1, keepdim=True) \
                / pcd_valid.sum(dim=1, keepdim=True).clamp_min(1)[..., None].to(w.dtype)
        else:
            mean = pcd_points.mean(dim=1, keepdim=True)
        pcd = self.pcd_in_proj(pcd_feats) + self.pcd_emb_proj(
            fourier_embedding(pcd_points - mean, self.embedding_dim))

        for block, layer in zip(self.blocks, self.transformer):
            if block == "self":
                img = layer(img, img, img, img_valid)
                pcd = layer(pcd, pcd, pcd, pcd_valid)
            else:
                img = layer(img, pcd, pcd, pcd_valid)
                pcd = layer(pcd, img, img, img_valid)
        return self.out_proj(img), self.out_proj(pcd)
