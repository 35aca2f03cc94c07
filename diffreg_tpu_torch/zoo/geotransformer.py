"""GeoTransformer family (vision3d/models/geotransformer/): the geometric
structure embedding (V1, V2), the geometric transformer (and its lite
variant), the vanilla siamese transformer, superpoint matching, point
matching and local-to-global registration.

Counterpart of the JAX package's zoo/geotransformer.py, static-shaped as it
is: the reference's ragged outputs (nonzero, boolean indexing) are
fixed-capacity index tables with validity masks, and the registration's
hypotheses are verified in one batched pass. Top-k selections break ties by
the lower index, as ``jax.lax.top_k`` does. The transformer's self blocks
take the relative-position route of ``nn.layers2d3d.MultiHeadAttention``
(plain PyTorch), its cross blocks the attention kernel (``csrc/attention.cu``
on CUDA tensors). Submodules carry the JAX package's names.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..geometry.procrustes import weighted_kabsch
from ..nn.layers2d3d import TransformerLayer
from ..ops.masked import NEG_INF
from ..ops.partition import batch_mutual_topk_select
from ..ops.topk import stable_top_k
from ..ops.vision import pairwise_distance


def sinusoidal_embedding(indices, d_model: int):
    """vision3d SinusoidalEmbedding: float indices [...] -> [..., d_model],
    interleaved [sin, cos] pairs; no gradient."""
    half = torch.arange(d_model // 2, dtype=indices.dtype, device=indices.device)
    div = torch.exp(half * (-math.log(10000.0) * 2.0 / d_model))
    omegas = indices.detach()[..., None] * div
    return torch.stack([torch.sin(omegas), torch.cos(omegas)], dim=-1).reshape(
        *indices.shape, d_model)


def _knn_exclude_self(points, k, mask=None):
    """Indices [B, N, k] of each point's k nearest other points."""
    d = pairwise_distance(points, points, squared=True)
    n = points.shape[-2]
    d = d + torch.eye(n, dtype=d.dtype, device=d.device) * 1e10
    if mask is not None:
        d = torch.where(mask[..., None, :], d, torch.full_like(d, 1e10))
    return stable_top_k(-d, k)[1]


def _pair_angles(points, knn_indices):
    """Angles [B, N, N, k] between each pair's direction and the anchor's kNN
    directions."""
    b, n, k = knn_indices.shape
    rows = knn_indices + torch.arange(b, device=points.device).reshape(b, 1, 1) * n
    knn_points = points.reshape(b * n, 3).index_select(0, rows.reshape(-1)).reshape(b, n, k, 3)
    ref = knn_points - points[:, :, None, :]                        # [B, N, k, 3]
    anc = points[:, None, :, :] - points[:, :, None, :]             # [B, N, N, 3]
    cross = torch.linalg.cross(ref[:, :, None, :, :].expand(b, n, n, k, 3),
                               anc[:, :, :, None, :].expand(b, n, n, k, 3), dim=-1)
    sin_v = torch.linalg.norm(cross, dim=-1)
    cos_v = torch.sum(ref[:, :, None, :, :] * anc[:, :, :, None, :], dim=-1)
    return torch.atan2(sin_v, cos_v)


def _distance_indices(points, sigma_d):
    dist = torch.sqrt(pairwise_distance(points, points, squared=True).clamp_min(1e-12))
    return (dist / sigma_d).detach()


class GeometricStructureEmbedding(nn.Module):
    """Pair-distance and triplet-angle embedding [B, N, 3] -> [B, N, N, C]."""

    def __init__(self, hidden_dim: int, sigma_d: float, sigma_a: float = 15.0,
                 angle_k: int = 3, angle_reduction: str = "max", use_angle_embed: bool = True):
        super().__init__()
        self.hidden_dim, self.sigma_d, self.sigma_a = hidden_dim, sigma_d, sigma_a
        self.angle_k, self.angle_reduction = angle_k, angle_reduction
        self.use_angle_embed = use_angle_embed
        self.proj_d = nn.Linear(hidden_dim, hidden_dim)
        if use_angle_embed:
            self.proj_a = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, points, mask=None):
        emb = self.proj_d(sinusoidal_embedding(_distance_indices(points, self.sigma_d),
                                               self.hidden_dim))
        if self.use_angle_embed:
            k = min(self.angle_k, points.shape[-2] - 1)
            knn_idx = _knn_exclude_self(points, k, mask)
            a_indices = (_pair_angles(points, knn_idx)
                         * (180.0 / (self.sigma_a * math.pi))).detach()
            a_emb = self.proj_a(sinusoidal_embedding(a_indices, self.hidden_dim))
            a_emb = a_emb.amax(dim=3) if self.angle_reduction == "max" else a_emb.mean(dim=3)
            emb = emb + a_emb
        return emb


class GeometricStructureEmbeddingV2(nn.Module):
    """V2: the angle quantised to whole degrees and read from a 181-entry
    embedded table, the sum through a leaky ReLU, ``proj_e`` and LayerNorm."""

    def __init__(self, hidden_dim: int, sigma_d: float, sigma_a: float = 15.0,
                 angle_k: int = 3, angle_reduction: str = "max"):
        super().__init__()
        self.hidden_dim, self.sigma_d, self.sigma_a = hidden_dim, sigma_d, sigma_a
        self.angle_k, self.angle_reduction = angle_k, angle_reduction
        self.proj_d = nn.Linear(hidden_dim, hidden_dim)
        self.proj_a = nn.Linear(hidden_dim, hidden_dim)
        self.proj_e = nn.Linear(hidden_dim, hidden_dim)
        self.norm = nn.LayerNorm(hidden_dim, eps=1e-5)

    def forward(self, points, mask=None):
        d_emb = self.proj_d(sinusoidal_embedding(_distance_indices(points, self.sigma_d),
                                                 self.hidden_dim))
        knn_idx = _knn_exclude_self(points, self.angle_k, mask)
        deg = torch.round(_pair_angles(points, knn_idx) * (180.0 / math.pi))
        deg = deg.clamp(0, 180).to(torch.int64).detach()
        table = self.proj_a(sinusoidal_embedding(
            torch.arange(181, dtype=points.dtype, device=points.device) / self.sigma_a,
            self.hidden_dim))
        a_emb = table[deg]                                              # [B, N, N, k, C]
        a_emb = a_emb.amax(dim=3) if self.angle_reduction == "max" else a_emb.mean(dim=3)
        emb = self.proj_e(F.leaky_relu(d_emb + a_emb, negative_slope=0.2))
        return self.norm(emb)


class GeometricTransformer(nn.Module):
    """Self (relative-position) and cross transformer over superpoint
    features: (src_points, tgt_points [B, N|M, 3], src_feats, tgt_feats
    [B, N|M, input_dim], masks) -> the features [B, N|M, output_dim]. ``lite``:
    GeometricTransformerLite (the V2 embedding, added to the keys unprojected).
    ``precision``: the attention's product policy (``utils/precision.py``)."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int, num_heads: int,
                 blocks: Tuple[str, ...], sigma_d: float, sigma_a: float = 15.0,
                 angle_k: int = 3, angle_reduction: str = "max", use_angle_embed: bool = True,
                 lite: bool = False, precision: str = "highest"):
        super().__init__()
        self.blocks = tuple(blocks)
        if lite:
            self.embedding = GeometricStructureEmbeddingV2(hidden_dim, sigma_d, sigma_a,
                                                           angle_k, angle_reduction)
        else:
            self.embedding = GeometricStructureEmbedding(hidden_dim, sigma_d, sigma_a, angle_k,
                                                         angle_reduction, use_angle_embed)
        self.in_proj = nn.Linear(input_dim, hidden_dim)
        for i, block in enumerate(self.blocks):
            if block not in ("self", "cross"):
                raise KeyError(block)
            self.add_module(f"transformer{i}", TransformerLayer(
                hidden_dim, num_heads, precision, qk_embed_proj=block == "self" and not lite))
        self.out_proj = nn.Linear(hidden_dim, output_dim)

    def forward(self, src_points, tgt_points, src_feats, tgt_feats, src_masks=None,
                tgt_masks=None):
        src_emb = self.embedding(src_points, src_masks)
        tgt_emb = self.embedding(tgt_points, tgt_masks)
        src, tgt = self.in_proj(src_feats), self.in_proj(tgt_feats)
        for i, block in enumerate(self.blocks):
            layer = getattr(self, f"transformer{i}")
            if block == "self":
                src = layer(src, src, src, src_masks, qk_embeds=src_emb)
                tgt = layer(tgt, tgt, tgt, tgt_masks, qk_embeds=tgt_emb)
            else:
                src = layer(src, tgt, tgt, tgt_masks)
                tgt = layer(tgt, src, src, src_masks)
        return self.out_proj(src), self.out_proj(tgt)


class VanillaSiameseTransformer(nn.Module):
    """Self / cross transformer without positions (siamese_transformer)."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int, num_heads: int,
                 blocks: Tuple[str, ...], precision: str = "highest"):
        super().__init__()
        self.blocks = tuple(blocks)
        self.in_proj = nn.Linear(input_dim, hidden_dim)
        for i in range(len(self.blocks)):
            self.add_module(f"transformer{i}", TransformerLayer(hidden_dim, num_heads, precision))
        self.out_proj = nn.Linear(hidden_dim, output_dim)

    def forward(self, src_feats, tgt_feats, src_masks=None, tgt_masks=None):
        src, tgt = self.in_proj(src_feats), self.in_proj(tgt_feats)
        for i, block in enumerate(self.blocks):
            layer = getattr(self, f"transformer{i}")
            if block == "self":
                src = layer(src, src, src, src_masks)
                tgt = layer(tgt, tgt, tgt, tgt_masks)
            else:
                src = layer(src, tgt, tgt, tgt_masks)
                tgt = layer(tgt, src, src, src_masks)
        return self.out_proj(src), self.out_proj(tgt)


def _flat_topk_correspondences(score, valid, capacity, largest):
    """The best ``capacity`` valid entries of score [N, M]: (src_idx, tgt_idx,
    scores, mask) each [capacity]."""
    m = score.shape[1]
    s = torch.where(valid, score if largest else -score, torch.full_like(score, NEG_INF))
    vals, flat_idx = stable_top_k(s.reshape(-1), capacity)
    keep = vals > NEG_INF / 2
    out_scores = torch.where(keep, score.reshape(-1)[flat_idx], torch.zeros_like(vals))
    return flat_idx // m, flat_idx % m, out_scores, keep


def _pair_valid(shape, src_masks, tgt_masks, device):
    valid = torch.ones(shape, dtype=torch.bool, device=device)
    if src_masks is not None:
        valid = valid & src_masks[:, None]
    if tgt_masks is not None:
        valid = valid & tgt_masks[None, :]
    return valid


def superpoint_matching_mutual_topk(src_feats, tgt_feats, k: int, num_correspondences: int,
                                    src_masks=None, tgt_masks=None,
                                    threshold: Optional[float] = None, mutual: bool = True,
                                    eps: float = 1e-8):
    """Mutual top-k of the feature distances [N, M] (features L2-normalised),
    thresholded with a fall-back to the mutual top-k when too few pass; at
    most ``num_correspondences``. Returns (src_idx, tgt_idx, scores, valid)."""
    dist = torch.sqrt(pairwise_distance(src_feats, tgt_feats, squared=True) + eps)
    valid = _pair_valid(dist.shape, src_masks, tgt_masks, dist.device)
    corr = batch_mutual_topk_select(
        dist[None], k, largest=False, mutual=mutual,
        valid_row=None if src_masks is None else src_masks[None],
        valid_col=None if tgt_masks is None else tgt_masks[None])[0] & valid
    if threshold is not None:
        good = corr & (dist <= threshold)
        corr = torch.where(good.sum() >= num_correspondences, good, corr)
    return _flat_topk_correspondences(dist, corr, num_correspondences, largest=False)


def superpoint_matching_global_topk(src_feats, tgt_feats, num_correspondences: int,
                                    src_masks=None, tgt_masks=None, src_weights=None,
                                    tgt_weights=None, dual_normalization: bool = True):
    """exp(-squared feature distance), dual-normalised over the valid entries
    and weighted per node, then the global top ``num_correspondences``."""
    score = torch.exp(-pairwise_distance(src_feats, tgt_feats, squared=True))
    valid = _pair_valid(score.shape, src_masks, tgt_masks, score.device)
    score = torch.where(valid, score, torch.zeros_like(score))
    if dual_normalization:
        s_row = score / score.sum(dim=1, keepdim=True).clamp_min(1e-12)
        s_col = score / score.sum(dim=0, keepdim=True).clamp_min(1e-12)
        score = s_row * s_col
    if src_weights is not None:
        score = score * src_weights[:, None]
    if tgt_weights is not None:
        score = score * tgt_weights[None, :]
    return _flat_topk_correspondences(score, valid, num_correspondences, largest=True)


def adaptive_superpoint_matching(src_feats, tgt_feats, min_num_correspondences: int,
                                 similarity_threshold: float, src_masks=None, tgt_masks=None,
                                 capacity: Optional[int] = None):
    """Every pair within the distance threshold, falling back to the best
    ``min_num_correspondences`` when too few; ``capacity`` slots (default 8x
    the minimum)."""
    capacity = capacity or min_num_correspondences * 8
    dist = torch.sqrt(pairwise_distance(src_feats, tgt_feats, squared=True).clamp_min(1e-12))
    valid = _pair_valid(dist.shape, src_masks, tgt_masks, dist.device)
    under = valid & (dist <= similarity_threshold)
    enough = under.sum() >= min_num_correspondences
    src_idx, tgt_idx, scores, keep = _flat_topk_correspondences(
        dist, torch.where(enough, under, valid), capacity, largest=False)
    rank = torch.arange(capacity, device=dist.device)
    keep = keep & (enough | (rank < min_num_correspondences))
    return src_idx, tgt_idx, scores, keep


@dataclasses.dataclass(frozen=True)
class PointMatchingConfig:
    """Point matching's knobs; ``selection='threshold'`` takes every pair above
    the confidence threshold (LocalGlobalRegistrationThreshold)."""
    k: int = 3
    mutual: bool = True
    confidence_threshold: float = 0.05
    use_dustbin: bool = False
    use_global_score: bool = False
    selection: str = "mutual_topk"     # 'mutual_topk' | 'threshold'


def deduplicate_correspondences(src_idx, tgt_idx, valid, num_cols: int):
    """``valid`` with every repeat of a (src, tgt) pair masked but one."""
    key = src_idx.long() * num_cols + tgt_idx.long()
    key = torch.where(valid, key, -1 - torch.arange(key.shape[0], device=key.device))
    order = torch.argsort(key, stable=True)
    ks = key[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=ks.device), ks[1:] != ks[:-1]])
    keep = torch.zeros_like(valid).scatter(0, order, first)
    return valid & keep


def point_matching_scores(score_mat, src_knn_masks, tgt_knn_masks, global_scores,
                          cfg: PointMatchingConfig, use_logits: bool = True):
    """Per-patch (mutual) top-k or threshold correspondence mask and the gated
    scores, the dustbin sliced off when ``use_dustbin``."""
    if use_logits:
        score_mat = torch.exp(score_mat)
    if cfg.selection == "threshold":
        corr = score_mat > cfg.confidence_threshold
        if src_knn_masks is not None:
            corr = corr & src_knn_masks[..., :, None]
        if tgt_knn_masks is not None:
            corr = corr & tgt_knn_masks[..., None, :]
    else:
        corr = batch_mutual_topk_select(score_mat, cfg.k, valid_row=src_knn_masks,
                                        valid_col=tgt_knn_masks,
                                        threshold=cfg.confidence_threshold, mutual=cfg.mutual)
    if cfg.use_dustbin:
        corr, score_mat = corr[:, :-1, :-1], score_mat[:, :-1, :-1]
    if cfg.use_global_score:
        score_mat = score_mat * global_scores[:, None, None]
    return score_mat * corr, corr


def _global_correspondences(gated, corr, capacity):
    """The best ``capacity`` gated entries over all patches: (values, valid,
    patch, source row, target row)."""
    b, kk, _ = gated.shape
    vals, flat_idx = stable_top_k(torch.where(corr.reshape(-1), gated.reshape(-1),
                                              torch.full_like(gated.reshape(-1), -1.0)), capacity)
    return vals, vals > 0.0, flat_idx // (kk * kk), (flat_idx // kk) % kk, flat_idx % kk


def point_matching(src_knn_points, tgt_knn_points, src_knn_masks, tgt_knn_masks,
                   src_knn_indices, tgt_knn_indices, score_mat, global_scores,
                   cfg: PointMatchingConfig, max_correspondences: int):
    """Up to ``max_correspondences`` point correspondences over all patch
    pairs: (src_points, tgt_points, src_indices, tgt_indices, scores, valid)."""
    gated, corr = point_matching_scores(score_mat, src_knn_masks, tgt_knn_masks, global_scores,
                                        cfg)
    vals, valid, bi, si, ti = _global_correspondences(gated, corr, max_correspondences)
    return (src_knn_points[bi, si], tgt_knn_points[bi, ti], src_knn_indices[bi, si],
            tgt_knn_indices[bi, ti], torch.where(valid, vals, torch.zeros_like(vals)), valid)


@dataclasses.dataclass(frozen=True)
class LGRConfig:
    matching: PointMatchingConfig = PointMatchingConfig()
    acceptance_radius: float = 0.1
    use_logits: bool = True
    min_local_correspondences: int = 3
    max_global_correspondences: int = 2048
    num_refinement_steps: int = 5


def local_global_registration(src_knn_points, tgt_knn_points, src_knn_masks, tgt_knn_masks,
                              score_mat, global_scores, cfg: LGRConfig):
    """LocalGlobalRegistration for one pair's patches: a weighted-Procrustes
    hypothesis per patch over its K x K weights, the hypothesis with the most
    inliers on the global correspondence set (all correspondences' solve when
    no patch has enough), then ``num_refinement_steps`` reweighted solves.
    Returns (src_corr_points, tgt_corr_points, corr_scores, corr_valid,
    R [3, 3], t [3])."""
    gated, corr = point_matching_scores(score_mat, src_knn_masks, tgt_knn_masks, global_scores,
                                        cfg.matching, use_logits=cfg.use_logits)
    b, kk, _ = gated.shape
    vals, g_valid, bi, si, ti = _global_correspondences(gated, corr,
                                                        cfg.max_global_correspondences)
    g_src = src_knn_points[bi, si] * g_valid[:, None]
    g_tgt = tgt_knn_points[bi, ti] * g_valid[:, None]
    g_scores = torch.where(g_valid, vals, torch.zeros_like(vals))

    pair_src = src_knn_points[:, :, None, :].expand(b, kk, kk, 3).reshape(b, kk * kk, 3)
    pair_tgt = tgt_knn_points[:, None, :, :].expand(b, kk, kk, 3).reshape(b, kk * kk, 3)
    r_h, t_h, _ = weighted_kabsch(pair_src, pair_tgt, gated.reshape(b, kk * kk, 1))
    hyp_ok = corr.sum(dim=(1, 2)) >= cfg.min_local_correspondences

    aligned = torch.einsum("bij,gj->bgi", r_h, g_src) + t_h.transpose(1, 2)
    residuals = torch.linalg.norm(g_tgt[None] - aligned, dim=-1)       # [B, G]
    inliers = (residuals < cfg.acceptance_radius) & g_valid[None]
    counts = torch.where(hyp_ok, inliers.sum(dim=1), torch.full_like(hyp_ok, -1, dtype=torch.long))
    best = torch.argmax(counts)
    r0, t0, _ = weighted_kabsch(g_src[None], g_tgt[None], g_scores[None, :, None])
    any_ok = hyp_ok.any()
    r, t = torch.where(any_ok, r_h[best], r0[0]), torch.where(any_ok, t_h[best], t0[0])
    for _ in range(cfg.num_refinement_steps):
        resid = torch.linalg.norm(g_tgt - (g_src @ r.T + t[:, 0]), dim=-1)
        w = g_scores * (resid < cfg.acceptance_radius)
        r2, t2, _ = weighted_kabsch(g_src[None], g_tgt[None], w[None, :, None])
        r, t = r2[0], t2[0]
    return g_src, g_tgt, g_scores, g_valid, r, t[:, 0]
