"""Matcher head: feature projection + position code + Sinkhorn or dual softmax.

Reference behaviors kept on purpose: ``src_proj`` projects BOTH sides (the
reference never applies its ``tgt_proj``, so the port has none), and the
features are divided by sqrt(C) before the similarity product. The position
code is the transformer's (``pe_type`` rotary or sinusoidal); an ``entangled``
matcher applies none, its features carrying it already. The confidences are
the learned-dustbin Sinkhorn's (``match_type`` sinkhorn) or the dual
softmax's at ``dsmax_temperature``. A Sinkhorn matcher has a learned
dustbin score ``bin_score``; so has a dual-softmax matcher built with
``projection``, the denoising matcher whose ``sinkhorn`` projects the DDIM's
noisy matrix (the JAX package creates ``bin_score`` for the Sinkhorn matcher
only, so its DDIM loop fails on a dual-softmax model; see
tests/test_torch_variants.py). The 2D-3D matcher passes no position code (its fused features carry position) and
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
from ..ops.position_encoding import embed_pos
from ..ops.select import thresholded_mutual_argmax_mask
from ..ops.sinkhorn import dual_softmax_conf_matrix, log_sinkhorn
from ..utils.precision import policy_bmm

MATCH_TYPES = ("sinkhorn", "dual_softmax")


@dataclasses.dataclass(frozen=True)
class MatchingConfig:
    feature_dim: int = 432
    match_type: str = "sinkhorn"          # sinkhorn | dual_softmax
    confidence_threshold: float = 0.2
    dsmax_temperature: float = 0.1
    skh_init_bin_score: float = 1.0
    skh_iters: int = 3
    entangled: bool = False               # the features carry the position code already
    precision: str = "highest"            # "default": TF32 similarity product on CUDA


class Matching(nn.Module):
    def __init__(self, cfg: MatchingConfig, projection: bool = False):
        super().__init__()
        if cfg.match_type not in MATCH_TYPES:
            raise ValueError(f"match_type {cfg.match_type!r}: one of {MATCH_TYPES}")
        self.cfg = cfg
        self.src_proj = nn.Linear(cfg.feature_dim, cfg.feature_dim, bias=False)
        if cfg.match_type == "sinkhorn" or projection:
            self.bin_score = nn.Parameter(torch.tensor(float(cfg.skh_init_bin_score)))

    def forward(self, src_feats, tgt_feats, src_pe, tgt_pe, src_mask, tgt_mask,
                src_pad=None, tgt_pad=None, pe_type="rotary"):
        """-> (conf_matrix [B, S, T], match_mask [B, S, T] bool). ``src_pe``
        None: no position code; ``pe_type`` the code's kind."""
        cfg = self.cfg
        src, tgt = self.src_proj(src_feats), self.src_proj(tgt_feats)
        if not cfg.entangled and src_pe is not None:
            src = embed_pos(pe_type, src, src_pe)
            tgt = embed_pos(pe_type, tgt, tgt_pe)
        scale = src.shape[-1] ** 0.5
        sim = policy_bmm(src / scale, (tgt / scale).transpose(1, 2), cfg.precision)
        if cfg.match_type == "dual_softmax":
            conf = dual_softmax_conf_matrix(sim, cfg.dsmax_temperature, src_mask, tgt_mask)
        else:
            conf = self.sinkhorn(sim, src_mask, tgt_mask, src_pad, tgt_pad)
        match_mask = thresholded_mutual_argmax_mask(conf, self.cfg.confidence_threshold)
        return conf, match_mask

    def sinkhorn(self, scores, src_mask, tgt_mask, src_pad=None, tgt_pad=None):
        """Learned-dustbin Sinkhorn confidences of an external score matrix."""
        scores = mask_matrix(scores, src_mask, tgt_mask)
        z = log_sinkhorn(scores, self.bin_score, self.cfg.skh_iters, src_mask, tgt_mask,
                         src_pad, tgt_pad)
        return torch.exp(z)[:, :-1, :-1]
