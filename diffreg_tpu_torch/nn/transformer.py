"""Repositioning transformer — self/cross geometry attention with rotary VolPE.

Counterpart of the JAX package's nn/transformer.py (``GeometryAttentionLayer``
and ``RepositioningTransformer``) for 'self' and 'cross' layers. Only the
math is ported: the JAX package's lane-layout switches (align_heads,
rotary_half, fused_rotary_qkv, logits_layout) give identical outputs.
Attention goes through ``ops.attention.masked_attention``: the Hopper kernel
for CUDA tensors, the plain version on the CPU. The 'positioning' layer keeps
its parameters (``layers.<i>.0``, a Matching) so reference weights load, but
running it is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ..ops.attention import masked_attention
from ..ops.position_encoding import embed_rotary, volumetric_pe
from .matching import Matching, MatchingConfig


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    feature_dim: int = 432
    n_head: int = 4
    layer_types: Tuple[str, ...] = ("self", "cross", "positioning", "self", "cross")
    vol_origin: Tuple[float, float, float] = (-3.6, -2.4, 1.14)
    voxel_size: float = 0.08
    feature_matching: MatchingConfig = MatchingConfig()


class GeometryAttentionLayer(nn.Module):
    """Rotary multi-head attention + gated-concat FFN (transformero.py:13-96)."""

    def __init__(self, d_model: int, n_head: int):
        super().__init__()
        self.d_model, self.n_head = d_model, n_head
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.mlp = nn.Sequential(nn.Linear(2 * d_model, 2 * d_model, bias=False), nn.ReLU(),
                                 nn.Linear(2 * d_model, d_model, bias=False))
        # Flax's LayerNorm epsilon (1e-6), which the weights were trained with
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, x, source, x_pe, source_pe, source_mask):
        """x [B, L, C] attends to source [B, S, C]; pe [.., C, 2]; source_mask [B, S]."""
        b, h = x.shape[0], self.n_head
        dim = self.d_model // h
        q = embed_rotary(self.q_proj(x), x_pe[..., 0], x_pe[..., 1])
        k = embed_rotary(self.k_proj(source), source_pe[..., 0], source_pe[..., 1])
        v = self.v_proj(source)
        heads = lambda t: t.reshape(b, -1, h, dim).transpose(1, 2)   # [B, H, N, D]
        o = masked_attention(heads(q), heads(k), heads(v), source_mask, dim ** -0.5)
        message = self.norm1(self.merge(o.transpose(1, 2).reshape(b, -1, h * dim)))
        y = self.norm2(self.mlp(torch.cat([x, message], dim=-1)))
        return x + y


class RepositioningTransformer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        layers = []
        for lt in cfg.layer_types:
            if lt in ("self", "cross"):
                layers.append(GeometryAttentionLayer(cfg.feature_dim, cfg.n_head))
            elif lt == "positioning":
                layers.append(nn.ModuleList([Matching(cfg.feature_matching)]))
            else:
                raise KeyError(lt)
        self.layers = nn.ModuleList(layers)

    def _pe(self, xyz):
        return volumetric_pe(xyz, self.cfg.feature_dim, self.cfg.vol_origin,
                             self.cfg.voxel_size)

    def forward(self, src_feat, tgt_feat, s_pcd, t_pcd, src_mask, tgt_mask):
        """-> (src_feat, tgt_feat, src_pe, tgt_pe)."""
        s_pe, t_pe = self._pe(s_pcd), self._pe(t_pcd)
        for lt, layer in zip(self.cfg.layer_types, self.layers):
            if lt == "self":
                if src_feat.shape[1] == tgt_feat.shape[1]:
                    # src and tgt share the weights and are independent: one [2B] call
                    both = torch.cat([src_feat, tgt_feat], dim=0)
                    pe2 = torch.cat([s_pe, t_pe], dim=0)
                    both = layer(both, both, pe2, pe2, torch.cat([src_mask, tgt_mask], dim=0))
                    src_feat, tgt_feat = both[:src_feat.shape[0]], both[src_feat.shape[0]:]
                else:
                    src_feat = layer(src_feat, src_feat, s_pe, s_pe, src_mask)
                    tgt_feat = layer(tgt_feat, tgt_feat, t_pe, t_pe, tgt_mask)
            elif lt == "cross":
                src_feat = layer(src_feat, tgt_feat, s_pe, t_pe, tgt_mask)
                # tgt attends to the updated src, as in the reference
                tgt_feat = layer(tgt_feat, src_feat, t_pe, s_pe, src_mask)
            else:
                raise NotImplementedError(f"layer type {lt!r} is not ported yet")
        return src_feat, tgt_feat, s_pe, t_pe
