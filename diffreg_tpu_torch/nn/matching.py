"""Matcher head: feature projection + rotary PE + learned-dustbin Sinkhorn.

Reference behaviors kept on purpose: ``src_proj`` projects BOTH sides (the
reference never applies its ``tgt_proj``, so the port has none), and the
features are divided by sqrt(C) before the similarity product. The 2D-3D
matcher passes no position code (its fused features carry position) and
static-padding masks besides the validity masks (see ops/sinkhorn.py).
The similarity product runs at the config's ``precision``, the one site of
the JAX matcher that reads ``get_precision()``, in the forward and in both
GEMMs of its backward (``utils/precision.py:policy_bmm``).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.masked import mask_matrix
from ..ops.position_encoding import embed_rotary
from ..ops.select import thresholded_mutual_argmax_mask
from ..ops.sinkhorn import log_sinkhorn
from ..utils.precision import policy_bmm


@dataclasses.dataclass(frozen=True)
class MatchingConfig:
    feature_dim: int = 432
    confidence_threshold: float = 0.2
    skh_init_bin_score: float = 1.0
    skh_iters: int = 3
    precision: str = "highest"            # "default": TF32 similarity product on CUDA


class Matching(nn.Module):
    def __init__(self, cfg: MatchingConfig):
        super().__init__()
        self.cfg = cfg
        self.src_proj = nn.Linear(cfg.feature_dim, cfg.feature_dim, bias=False)
        self.bin_score = nn.Parameter(torch.tensor(float(cfg.skh_init_bin_score)))

    def forward(self, src_feats, tgt_feats, src_pe, tgt_pe, src_mask, tgt_mask,
                src_pad=None, tgt_pad=None):
        """-> (conf_matrix [B, S, T], match_mask [B, S, T] bool). ``src_pe``
        None: no position code."""
        src, tgt = self.src_proj(src_feats), self.src_proj(tgt_feats)
        if src_pe is not None:
            src = embed_rotary(src, src_pe[..., 0], src_pe[..., 1])
            tgt = embed_rotary(tgt, tgt_pe[..., 0], tgt_pe[..., 1])
        scale = src.shape[-1] ** 0.5
        sim = policy_bmm(src / scale, (tgt / scale).transpose(1, 2), self.cfg.precision)
        conf = self.sinkhorn(sim, src_mask, tgt_mask, src_pad, tgt_pad)
        match_mask = thresholded_mutual_argmax_mask(conf, self.cfg.confidence_threshold)
        return conf, match_mask

    def sinkhorn(self, scores, src_mask, tgt_mask, src_pad=None, tgt_pad=None):
        """Learned-dustbin Sinkhorn confidences of an external score matrix."""
        scores = mask_matrix(scores, src_mask, tgt_mask)
        z = log_sinkhorn(scores, self.bin_score, self.cfg.skh_iters, src_mask, tgt_mask,
                         src_pad, tgt_pad)
        return torch.exp(z)[:, :-1, :-1]
