"""CoFiNet, Predator, D3Feat, FCGF and URR families
(vision3d/models/{cofinet,predator,d3feat,fcgf,urr}).

Counterpart of the JAX package's zoo/matching_models.py, static-shaped as it
is: ragged outputs (nonzero, host subsampling) are fixed-capacity masked
tables, and the reference's [B, C, N] layouts are channel-last [B, N, C].
Draws go through ``rng`` (a ``torch.Generator`` or a draw source,
``utils/draws.py``), split where JAX splits its keys. Submodules carry the
JAX package's names.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..geometry.procrustes import weighted_kabsch
from ..ops.masked import NEG_INF
from ..ops.topk import stable_top_k, top_k
from ..ops.vision import pairwise_distance
from ..utils.draws import as_draws
from .pointnets import batched_knn, group_gather


# ---------------------------------------------------------------------------
# CoFiNet (vision3d/models/cofinet)


def cofinet_node_matching(score_mat, min_num_correspondences: int,
                          confidence_threshold: float, capacity: int, src_masks=None,
                          tgt_masks=None):
    """NodeMatching: exp(log-scores) [N, M], every entry above the threshold,
    falling back to the best ``min_num_correspondences``; ``capacity`` slots:
    (src_idx, tgt_idx, scores, valid)."""
    score = torch.exp(score_mat)
    if src_masks is not None:
        score = score * src_masks[:, None]
    if tgt_masks is not None:
        score = score * tgt_masks[None, :]
    above = score > confidence_threshold
    enough = above.sum() >= min_num_correspondences
    m = score.shape[1]
    sel = torch.where(enough, torch.where(above, score, torch.full_like(score, -1.0)), score)
    vals, flat = stable_top_k(sel.reshape(-1), capacity)
    rank = torch.arange(capacity, device=score.device)
    keep = torch.where(enough, vals > 0.0, rank < min_num_correspondences)
    scores = score.reshape(-1)[flat]
    keep = keep & (scores > 0)
    return flat // m, flat % m, torch.where(keep, scores, torch.zeros_like(scores)), keep


def cofinet_node_proposals(rng, gt_src_corr_indices, gt_tgt_corr_indices, gt_corr_overlaps,
                           valid, num_proposals: int):
    """NodeProposalGenerator: ``num_proposals`` ground-truth node
    correspondences drawn without replacement with probability by overlap
    (Gumbel top-k, one draw from ``rng``)."""
    logp = torch.where(valid & (gt_corr_overlaps > 0),
                       torch.log(gt_corr_overlaps.clamp_min(1e-12)),
                       torch.full_like(gt_corr_overlaps, NEG_INF))
    g = as_draws(rng).gumbel(logp.shape, logp.dtype)
    _, sel = stable_top_k(logp + g, num_proposals)
    keep = valid[sel] & (torch.arange(num_proposals, device=sel.device)
                         < torch.clamp(valid.sum(), max=num_proposals))
    return gt_src_corr_indices[sel], gt_tgt_corr_indices[sel], gt_corr_overlaps[sel], keep


# ---------------------------------------------------------------------------
# Predator GCN (vision3d/models/predator/modules.py)


def _instance_norm(x, dims):
    mu = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, unbiased=False)
    return (x - mu) / torch.sqrt(var + 1e-5)


class _EdgeConv(nn.Module):
    """Linear over [x ++ (neighbour - x)], InstanceNorm over (N, k) per
    channel (no affine), LeakyReLU 0.2, max over the neighbours."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.conv = nn.Linear(2 * in_dim, out_dim, bias=False)

    def forward(self, feats, idx):
        nbrs = group_gather(feats, idx)                                  # [B, N, k, C]
        x = torch.cat([feats[:, :, None, :].expand_as(nbrs), nbrs - feats[:, :, None, :]],
                      dim=-1)
        x = F.leaky_relu(_instance_norm(self.conv(x), (1, 2)), negative_slope=0.2)
        return x.amax(dim=2)


class PredatorSelfAttention(nn.Module):
    """Coordinate-guided self attention: two edge convs over one kNN graph
    (self excluded), the dense skip concatenation, Linear, InstanceNorm,
    LeakyReLU 0.2. Features [B, N, feature_dim]."""

    def __init__(self, feature_dim: int, k: int = 10):
        super().__init__()
        self.k = k
        self.edge1 = _EdgeConv(feature_dim, feature_dim)
        self.edge2 = _EdgeConv(feature_dim, feature_dim * 2)
        self.conv3 = nn.Linear(feature_dim * 4, feature_dim, bias=False)

    def forward(self, coords, feats):
        idx = batched_knn(coords, coords, self.k + 1)[:, :, 1:]
        x1 = self.edge1(feats, idx)
        x2 = self.edge2(x1, idx)
        x3 = self.conv3(torch.cat([feats, x1, x2], dim=-1))
        return F.leaky_relu(_instance_norm(x3, (1,)), negative_slope=0.2)


class AttentionalPropagation(nn.Module):
    """SuperGlue message passing: multi-head attention, then an MLP over
    [x ++ message] (Linear, InstanceNorm, ReLU, Linear)."""

    def __init__(self, feature_dim: int, num_heads: int):
        super().__init__()
        c = feature_dim
        self.num_heads = num_heads
        self.proj_q = nn.Linear(c, c)
        self.proj_k = nn.Linear(c, c)
        self.proj_v = nn.Linear(c, c)
        self.merge = nn.Linear(c, c)
        self.mlp0 = nn.Linear(2 * c, 2 * c)
        self.mlp1 = nn.Linear(2 * c, c)
        nn.init.zeros_(self.mlp1.bias)

    def forward(self, x, source):
        h, c = self.num_heads, self.merge.in_features
        dim = c // h
        q = self.proj_q(x).reshape(*x.shape[:2], h, dim)
        k = self.proj_k(source).reshape(*source.shape[:2], h, dim)
        v = self.proj_v(source).reshape(*source.shape[:2], h, dim)
        a = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(dim)
        msg = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(a, dim=-1), v).reshape(*x.shape[:2], c)
        y = self.mlp0(torch.cat([x, self.merge(msg)], dim=-1))
        return self.mlp1(F.relu(_instance_norm(y, (1,))))


class PredatorGCN(nn.Module):
    """Self (edge conv) and cross (attentional propagation) blocks, named
    ``layer{i}_self`` / ``layer{i}_cross``."""

    def __init__(self, feature_dim: int, num_heads: int, k: int, layer_names: Tuple[str, ...]):
        super().__init__()
        self.layer_names = tuple(layer_names)
        for i, name in enumerate(self.layer_names):
            if name == "cross":
                self.add_module(f"layer{i}_cross", AttentionalPropagation(feature_dim, num_heads))
            elif name == "self":
                self.add_module(f"layer{i}_self", PredatorSelfAttention(feature_dim, k))
            else:
                raise KeyError(name)

    def forward(self, coords0, coords1, desc0, desc1):
        for i, name in enumerate(self.layer_names):
            layer = getattr(self, f"layer{i}_{name}")
            if name == "cross":
                desc0 = desc0 + layer(desc0, desc1)
                desc1 = desc1 + layer(desc1, desc0)
            else:
                desc0 = layer(coords0, desc0)
                desc1 = layer(coords1, desc1)
        return desc0, desc1


# ---------------------------------------------------------------------------
# D3Feat (vision3d/models/d3feat)


def compute_detection_scores(feats, neighbor_indices, training: bool, eps: float = 1e-6):
    """D3Feat keypoint scores of feats [N, C] over neighbour indices [N, k]
    (the shadow sentinel N): local softplus contrast times depth-wise
    contrast, gated by the local maximum at eval."""
    n = feats.shape[0]
    feats = feats / (feats.max() + eps)
    padded = torch.cat([feats, torch.zeros_like(feats[:1])], dim=0)
    nbr = padded[neighbor_indices.long()]                                # [N, k, C]
    num = (neighbor_indices != n).sum(dim=-1, keepdim=True)
    local_mean = nbr.sum(dim=1) / (num.to(feats.dtype) + eps)
    local_max_scores = F.softplus(feats - local_mean)
    depth_max_scores = F.softplus(feats - feats.mean(dim=1, keepdim=True))
    scores = (local_max_scores * depth_max_scores).amax(dim=1)
    if not training:
        is_max = torch.isclose(feats, nbr.amax(dim=1)).to(feats.dtype).amax(dim=1)
        scores = scores * is_max
    return scores


@dataclasses.dataclass(frozen=True)
class D3FeatLossConfig:
    log_scale: float = 10.0
    pos_optimal: float = 0.1
    neg_optimal: float = 1.4
    pos_margin: float = 0.1
    neg_margin: float = 1.4
    pos_radius: float = 0.021      # the reference adds 0.001 to the config value
    neg_radius: float = 0.05
    alpha_circle: float = 1.0
    alpha_detection: float = 1.0


def _circle_loss_cd_fd(cd, fd, pair_ok, corr_mask, cfg):
    """Metric circle loss over coordinate / feature distance matrices (D3Feat
    and Predator)."""
    pos_mask = (cd < cfg.pos_radius) & pair_ok
    neg_mask = (cd > cfg.neg_radius) & pair_ok
    row_sel = (pos_mask.sum(-1) > 0) & (neg_mask.sum(-1) > 0) & corr_mask
    col_sel = (pos_mask.sum(-2) > 0) & (neg_mask.sum(-2) > 0) & corr_mask
    pos_w = (torch.where(pos_mask, fd, torch.full_like(fd, -1e5))
             - cfg.pos_optimal).clamp_min(0.0).detach()
    neg_w = (cfg.neg_optimal
             - torch.where(neg_mask, fd, torch.full_like(fd, 1e5))).clamp_min(0.0).detach()
    pos = cfg.log_scale * (fd - cfg.pos_margin) * pos_w
    neg = cfg.log_scale * (cfg.neg_margin - fd) * neg_w
    loss_row = F.softplus(torch.logsumexp(pos, dim=-1) + torch.logsumexp(neg, dim=-1)) \
        / cfg.log_scale
    loss_col = F.softplus(torch.logsumexp(pos, dim=-2) + torch.logsumexp(neg, dim=-2)) \
        / cfg.log_scale
    zero = torch.zeros_like(loss_row)
    return 0.5 * (torch.where(row_sel, loss_row, zero).sum() / row_sel.sum().clamp_min(1)
                  + torch.where(col_sel, loss_col, zero).sum() / col_sel.sum().clamp_min(1))


def _feature_match_recall(cd, fd, pair_ok, corr_mask, pos_radius):
    """Feature-match recall among the anchors that have a true positive."""
    has_pos = ((cd < pos_radius) & pair_ok).sum(-1) > 0
    nn_idx = torch.argmin(torch.where(pair_ok, fd, torch.full_like(fd, 1e5)), dim=-1)
    nn_cd = torch.gather(cd, 1, nn_idx[:, None])[:, 0]
    return ((nn_cd < pos_radius) & has_pos & corr_mask).sum() / (
        (has_pos & corr_mask).sum().to(cd.dtype).clamp_min(1e-12))


def _distances(a, b):
    return torch.sqrt(pairwise_distance(a, b, squared=True).clamp_min(1e-12))


def d3feat_loss(points0, points1, feats0, feats1, scores0, scores1, corr_mask, rotation,
                translation, cfg: D3FeatLossConfig):
    """D3FeatLoss over a fixed-size correspondence set (points0 / points1
    [P, 3] matched rows, ``corr_mask`` [P] their validity; points1 moved by
    the pose): circle loss, detection loss and feature-match recall."""
    p1 = points1 @ rotation.T + translation
    cd, fd = _distances(points0, p1), _distances(feats0, feats1)
    pair_ok = corr_mask[:, None] & corr_mask[None, :]
    circle = _circle_loss_cd_fd(cd, fd, pair_ok, corr_mask, cfg)
    eye = torch.eye(fd.shape[0], dtype=torch.bool, device=fd.device) & pair_ok
    furthest_pos = torch.where(eye, fd, torch.zeros_like(fd)).amax(dim=1)
    closest_neg = torch.where(eye | ~pair_ok, torch.full_like(fd, 1e5), fd).amin(dim=1)
    det_vals = (furthest_pos - closest_neg) * (scores0 + scores1)
    detection = torch.where(corr_mask, det_vals, torch.zeros_like(det_vals)).sum() \
        / corr_mask.sum().clamp_min(1)
    recall = _feature_match_recall(cd, fd, pair_ok, corr_mask, cfg.pos_radius)
    overall = cfg.alpha_circle * circle + cfg.alpha_detection * detection
    return {"overall_loss": overall, "circle_loss": circle, "detection_loss": detection,
            "recall": recall}


@dataclasses.dataclass(frozen=True)
class PredatorLossConfig:
    log_scale: float = 10.0
    pos_optimal: float = 0.1
    neg_optimal: float = 1.4
    pos_margin: float = 0.1
    neg_margin: float = 1.4
    pos_radius: float = 0.0375
    neg_radius: float = 0.1
    saliency_pos_radius: float = 0.075
    alpha_circle: float = 1.0
    alpha_overlap: float = 1.0
    alpha_saliency: float = 1.0


def _weighted_bce(preds, labels, mask):
    """Class-balanced BCE over the masked entries, with their precision and
    recall at 0.5."""
    zero = torch.zeros_like(preds)
    count = mask.sum().clamp_min(1)
    neg_w = torch.where(mask, labels, zero).sum() / count
    w = torch.where(labels >= 0.5, 1.0 - neg_w, neg_w)
    p = preds.clamp(1e-7, 1.0 - 1e-7)
    bce = -(labels * torch.log(p) + (1.0 - labels) * torch.log1p(-p))
    loss = torch.where(mask, w * bce, zero).sum() / count
    pred_pos = (preds >= 0.5) & mask
    true_pos = pred_pos & (labels >= 0.5)
    precision = true_pos.sum() / pred_pos.sum().clamp_min(1)
    recall = true_pos.sum() / ((labels >= 0.5) & mask).sum().clamp_min(1)
    return loss, precision, recall


def predator_loss(points0, points1, feats0, feats1, mask0, mask1, corr_pairs, corr_mask,
                  rotation, translation, overlap_scores0, overlap_scores1, saliency_scores0,
                  saliency_scores1, cfg: PredatorLossConfig):
    """PredatorLoss: circle loss on the sampled ground-truth correspondences
    ``corr_pairs`` [P, 2] (``corr_mask`` [P]), class-balanced BCE on the
    overlap scores (labels: membership of the correspondences) and on the
    saliency scores (labels: mutual feature nearest neighbours among the
    overlap points within ``saliency_pos_radius`` after the pose)."""
    p1 = points1 @ rotation.T + translation
    i0, i1 = corr_pairs[:, 0].long(), corr_pairs[:, 1].long()
    n, m = points0.shape[0], points1.shape[0]
    # membership scattered through a sentinel slot for padded pairs
    in_ov0 = torch.zeros(n + 1, dtype=torch.bool, device=points0.device).index_fill(
        0, torch.where(corr_mask, i0, torch.full_like(i0, n)), True)[:n] & mask0
    in_ov1 = torch.zeros(m + 1, dtype=torch.bool, device=points0.device).index_fill(
        0, torch.where(corr_mask, i1, torch.full_like(i1, m)), True)[:m] & mask1
    ov_loss, ov_p, ov_r = _weighted_bce(
        torch.cat([overlap_scores0, overlap_scores1]),
        torch.cat([in_ov0, in_ov1]).to(points0.dtype), torch.cat([mask0, mask1]))

    sim = feats0 @ feats1.T
    sim = torch.where(in_ov0[:, None] & in_ov1[None, :], sim, torch.full_like(sim, -1e9))
    nn0, nn1 = sim.argmax(dim=1), sim.argmax(dim=0)
    d0 = torch.linalg.norm(points0 - p1[nn0], dim=1)
    d1 = torch.linalg.norm(p1 - points0[nn1], dim=1)
    sal_labels = torch.cat([d0 < cfg.saliency_pos_radius, d1 < cfg.saliency_pos_radius])
    sal_loss, sal_p, sal_r = _weighted_bce(
        torch.cat([saliency_scores0, saliency_scores1]), sal_labels.to(points0.dtype),
        torch.cat([in_ov0, in_ov1]))

    cd = _distances(points0[i0], p1[i1])
    fd = _distances(feats0[i0], feats1[i1])
    pair_ok = corr_mask[:, None] & corr_mask[None, :]
    circle = _circle_loss_cd_fd(cd, fd, pair_ok, corr_mask, cfg)
    recall = _feature_match_recall(cd, fd, pair_ok, corr_mask, cfg.pos_radius)
    overall = cfg.alpha_circle * circle + cfg.alpha_overlap * ov_loss \
        + cfg.alpha_saliency * sal_loss
    return {"overall_loss": overall, "circle_loss": circle, "recall": recall,
            "overlap_loss": ov_loss, "overlap_precision": ov_p, "overlap_recall": ov_r,
            "saliency_loss": sal_loss, "saliency_precision": sal_p, "saliency_recall": sal_r}


# ---------------------------------------------------------------------------
# FCGF (vision3d/models/fcgf/modules.py)


def fcgf_hardest_contrastive_loss(feats0, feats1, pos_pairs, pos_pair_mask, pos_thresh,
                                  neg_thresh, **kw):
    """FCGF's HardestContrastiveLoss: ``engine.loss_library``'s (the
    reference's FCGF copy of it does not import)."""
    from ..engine.loss_library import hardest_contrastive_loss

    return hardest_contrastive_loss(feats0, feats1, pos_pairs, pos_pair_mask, pos_thresh,
                                    neg_thresh, **kw)


# ---------------------------------------------------------------------------
# URR (vision3d/models/urr)


def urr_extract_correspondences(src_points, tgt_points, src_feats, tgt_feats,
                                num_correspondences: int, eps: float = 1e-8):
    """CorrespondenceExtractor: each side's nearest neighbour in (normalised)
    feature space weighted by the Lowe ratio, the best
    ``num_correspondences`` of each direction concatenated: (src_corr,
    tgt_corr, weights) with 2 * num_correspondences rows."""
    def one_side(q_pts, s_pts, q_f, s_f):
        neg, idx = stable_top_k(-(1.0 - q_f @ s_f.T), 2)
        weights = 1.0 - (-neg[:, 0]) / (-neg[:, 1] + eps)
        w_top, q_idx = stable_top_k(weights, num_correspondences)
        return q_pts[q_idx], s_pts[idx[q_idx, 0]], w_top

    s1, t1, w1 = one_side(src_points, tgt_points, src_feats, tgt_feats)
    t2, s2, w2 = one_side(tgt_points, src_points, tgt_feats, src_feats)
    return torch.cat([s1, s2]), torch.cat([t1, t2]), torch.cat([w1, w2])


def randomized_weighted_procrustes(rng, src_corr_points, tgt_corr_points, corr_weights,
                                   num_subsets: int, num_samples: int):
    """``num_subsets`` weighted Procrustes solves on random subsets of
    ``num_samples`` correspondences (one set of subsets for the batch, each a
    random permutation's head, drawn from one split of ``rng`` each), the
    transform with the lowest weighted residual kept. Batched [B, N, 3];
    returns (R [B, 3, 3], t [B, 3])."""
    b, n, _ = src_corr_points.shape
    sel = torch.stack([d.permutation(n)[:num_samples]
                       for d in as_draws(rng).split(num_subsets)])      # [T, K]
    sel = sel.to(src_corr_points.device)
    r, t, _ = weighted_kabsch(src_corr_points[:, sel].reshape(b * num_subsets, num_samples, 3),
                              tgt_corr_points[:, sel].reshape(b * num_subsets, num_samples, 3),
                              corr_weights[:, sel].reshape(b * num_subsets, num_samples, 1))
    r = r.reshape(b, num_subsets, 3, 3)
    t = t.reshape(b, num_subsets, 3)
    aligned = torch.einsum("btij,bnj->btni", r, src_corr_points) + t[:, :, None, :]
    err = torch.linalg.norm(aligned - tgt_corr_points[:, None], dim=-1)      # [B, T, N]
    best = torch.argmin(torch.mean(err * corr_weights[:, None, :], dim=-1), dim=1)
    bi = torch.arange(b, device=best.device)
    return r[bi, best], t[bi, best]


def differentiable_render(pcd_points, pcd_colors, pcd_feats, intrinsics, image_h: int,
                          image_w: int, num_samples: int, radius: float, sigma: float,
                          weighting_fn: str = "exponential", compositing_fn: str = "weighted",
                          eps: float = 1e-10, min_depth: float = 1e-6):
    """DifferentiableRenderer: project the points, take each pixel's
    ``num_samples`` nearest projections sorted by depth, weight them (soft,
    within ``radius``) and composite depth, colour and feature images.
    Points behind the camera are moved to infinity. Returns (depths [H, W],
    colors [H, W, 3] or None, feats [H, W, C] or None, masks [H, W])."""
    depths = pcd_points[:, 2]
    front = depths > min_depth
    fx, fy, cx, cy = intrinsics[0, 0], intrinsics[1, 1], intrinsics[0, 2], intrinsics[1, 2]
    z = torch.where(front, depths, torch.ones_like(depths))
    px = torch.stack([pcd_points[:, 0] * fx / z + cx, pcd_points[:, 1] * fy / z + cy], dim=-1)
    px = torch.where(front[:, None], px, torch.full_like(px, 1e6))
    vs, us = torch.meshgrid(torch.arange(image_h, dtype=px.dtype, device=px.device),
                            torch.arange(image_w, dtype=px.dtype, device=px.device),
                            indexing="ij")
    img_px = torch.stack([us.reshape(-1), vs.reshape(-1)], dim=-1)       # (HW, 2) as (x, y)
    d = torch.sqrt(pairwise_distance(img_px, px, squared=True).clamp_min(1e-12))
    # continuous distances: ``top_k`` (a full sort's tie order is not needed)
    negd, idx = top_k(-d, num_samples)
    order = torch.argsort(depths[idx], dim=-1, stable=True)
    idx = torch.gather(idx, -1, order)
    dist = torch.gather(-negd, -1, order)
    masks = dist < radius
    if weighting_fn == "exponential":
        w = torch.exp(-dist ** 2 / sigma ** 2) * masks
    else:
        w = (1.0 - dist ** 2 / sigma ** 2) * masks
    if compositing_fn == "weighted":
        w = w / (w.sum(dim=-1, keepdim=True) + eps)
    else:
        alphas = torch.cat([torch.ones_like(w[..., :1]), 1.0 - w[..., :-1] + eps], dim=-1)
        w = w * torch.cumprod(alphas, dim=-1)
    out_depth = (depths[idx] * w).sum(dim=-1).reshape(image_h, image_w)
    out_colors = out_feats = None
    if pcd_colors is not None:
        out_colors = (pcd_colors[idx] * w[..., None]).sum(dim=-2).reshape(image_h, image_w, -1)
    if pcd_feats is not None:
        out_feats = (pcd_feats[idx] * w[..., None]).sum(dim=-2).reshape(image_h, image_w, -1)
    return out_depth, out_colors, out_feats, masks.any(dim=-1).reshape(image_h, image_w)
