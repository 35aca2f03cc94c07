"""2D-3D training losses: the weighted circle loss on the fused coarse
features, the focal matching loss on the denoised matrix, and the fine circle
loss on ground-truth pixel <-> point pairs.

Counterpart of the JAX package's engine/losses2d3d.py (the reference's
OverallLoss and vision3d's circle loss). Every reduction counts valid
(unpadded) entries only; padded index lists point past the end and are
dropped. The batch-wide reductions (the pair means, the focal terms'
normalisers) are those of ``reduce``, as in ``engine.losses``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.masked import scatter_pairs as scatter_overlaps  # the JAX package's name
from ..ops.vision import l2_normalize, pairwise_distance, render
from .losses import LOCAL_BATCH, BatchReduction, LossConfig, focal_correspondence_loss


@dataclasses.dataclass(frozen=True)
class CircleLossConfig:
    positive_margin: float = 0.1
    negative_margin: float = 1.4
    positive_optimal: float = 0.1
    negative_optimal: float = 1.4
    log_scale: float = 40.0
    positive_overlap: float = 0.3
    negative_overlap: float = 0.2


@dataclasses.dataclass(frozen=True)
class FineLossConfig:
    positive_radius_3d: float = 0.0375
    negative_radius_3d: float = 0.1
    positive_radius_2d: float = 8.0
    negative_radius_2d: float = 12.0
    circle: CircleLossConfig = CircleLossConfig()


def _masked_mean(values, mask):
    """Mean of ``values`` over ``mask`` along the last axis (0 when empty)."""
    total = torch.where(mask, values, torch.zeros_like(values)).sum(dim=-1)
    return total / mask.sum(dim=-1).clamp_min(1).to(values.dtype)


def circle_loss(feat_dists, pos_masks, neg_masks, cfg: CircleLossConfig, pos_scales=None,
                row_valid=None, col_valid=None):
    """Weighted circle loss over feature distances [..., N, M] -> [...].

    A row (column) takes part only if it has a positive and a negative (and is
    valid); the loss is the mean of the rows' and the columns' means. The
    weights are constants of the backward (the JAX package's stop_gradient)."""
    row_masks = (pos_masks.sum(dim=-1) > 0) & (neg_masks.sum(dim=-1) > 0)
    col_masks = (pos_masks.sum(dim=-2) > 0) & (neg_masks.sum(dim=-2) > 0)
    if row_valid is not None:
        row_masks = row_masks & row_valid
    if col_valid is not None:
        col_masks = col_masks & col_valid
    dtype = feat_dists.dtype
    pos_w = torch.clamp_min(feat_dists - 1e5 * (~pos_masks).to(dtype) - cfg.positive_optimal,
                            0.0)
    if pos_scales is not None:
        pos_w = pos_w * pos_scales
    neg_w = torch.clamp_min(cfg.negative_optimal - (feat_dists + 1e5 * (~neg_masks).to(dtype)),
                            0.0)
    logits_pos = cfg.log_scale * (feat_dists - cfg.positive_margin) * pos_w.detach()
    logits_neg = cfg.log_scale * (cfg.negative_margin - feat_dists) * neg_w.detach()
    zero = feat_dists.new_zeros(())

    def side(dim):
        lse = torch.logsumexp(logits_pos, dim=dim) + torch.logsumexp(logits_neg, dim=dim)
        return torch.logaddexp(lse, zero) / cfg.log_scale            # softplus
    return 0.5 * (_masked_mean(side(-1), row_masks) + _masked_mean(side(-2), col_masks))


def normalized_feat_dists(a, b, eps: float = 1e-8):
    """sqrt(squared distance + eps) of the L2-normalised features."""
    return torch.sqrt(pairwise_distance(l2_normalize(a, eps), l2_normalize(b, eps)) + eps)


def overlap_masks(overlaps, cfg: CircleLossConfig):
    """(positives, negatives, sqrt-overlap positive scales) of an overlap matrix."""
    pos = overlaps > cfg.positive_overlap
    neg = overlaps < cfg.negative_overlap
    return pos, neg, torch.sqrt(overlaps * pos.to(overlaps.dtype))


def _argmin_first(x):
    """Index of the smallest entry along the last axis, the lowest on ties; a
    NaN counts as the smallest (numpy's and JAX's argmin)."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device).expand_as(x)
    low = (x == x.amin(dim=-1, keepdim=True)) | torch.isnan(x)
    return torch.where(low, idx, torch.full_like(idx, n)).amin(dim=-1)


def fine_matching_loss(img_feats, img_points, img_pixels, pcd_feats, pcd_points_cam,
                       pcd_pixels, valid, cfg: FineLossConfig):
    """Fine circle loss on sampled ground-truth pixel <-> point pairs [..., F]:
    positives within both the 3D and the 2D radius, negatives outside either
    negative radius; squared distances of the (normalised) features. Returns
    (loss [...], recall [...]): the share of rows with a positive whose
    feature-nearest column is one."""
    d3 = pairwise_distance(img_points, pcd_points_cam, squared=False)
    d2 = pairwise_distance(img_pixels, pcd_pixels, squared=False)
    v = valid[..., :, None] & valid[..., None, :]
    pos = (d3 < cfg.positive_radius_3d) & (d2 < cfg.positive_radius_2d) & v
    neg = ((d3 > cfg.negative_radius_3d) | (d2 > cfg.negative_radius_2d)) & v
    fdist = pairwise_distance(img_feats, pcd_feats, squared=True)
    loss = circle_loss(fdist, pos, neg, cfg.circle, row_valid=valid, col_valid=valid)
    with torch.no_grad():
        has_pos = pos.sum(dim=-1) > 0
        nn_idx = _argmin_first(torch.where(v, fdist, torch.full_like(fdist, float("inf"))))
        hit = torch.gather(pos, -1, nn_idx[..., None])[..., 0]
        recall = (hit & has_pos).sum(dim=-1) / has_pos.sum(dim=-1).clamp_min(1)
    return loss, recall.to(fdist.dtype)


def _rows(table, idx):
    """table [N, C] rows at idx [F] (index_select: an atomic backward on CUDA,
    where advanced indexing's backward sorts)."""
    return torch.index_select(table, 0, idx.long())


def fine_loss_from_batch(outputs, batch, cfg: FineLossConfig,
                         reduce: BatchReduction = LOCAL_BATCH):
    """The fine circle loss of each pair on its ground-truth pairs (image
    features at the pixels, point features at the point indices, the points in
    the camera frame and rendered to pixels) -> (mean loss, mean recall) over
    the batch."""
    img_f, pcd_f = outputs["img_feats_f"], outputs["pcd_feats_f"]    # [B, H, W, C], [B, N0, C]
    b, h, w, c = img_f.shape
    cols = {k: [] for k in ("img_feats", "img_points", "pcd_feats", "pcd_points", "pcd_pixels")}
    for i in range(b):
        pix = batch.fine_pixels[i].long()
        flat = pix[:, 0] * w + pix[:, 1]
        pidx = batch.fine_pcd_idx[i]
        tfm = batch.transform[i]
        pts_cam = batch.points[0][i] @ tfm[:3, :3].T + tfm[:3, 3]
        cols["img_feats"].append(l2_normalize(_rows(img_f[i].reshape(h * w, c), flat)))
        cols["img_points"].append(_rows(batch.img_points[i], flat))
        cols["pcd_feats"].append(l2_normalize(_rows(pcd_f[i], pidx)))
        cols["pcd_points"].append(_rows(pts_cam, pidx))
        cols["pcd_pixels"].append(render(cols["pcd_points"][-1], batch.intrinsics[i])[0])
    s = {k: torch.stack(v) for k, v in cols.items()}
    losses, recalls = fine_matching_loss(
        s["img_feats"], s["img_points"], batch.fine_pixels.to(img_f.dtype), s["pcd_feats"],
        s["pcd_points"], s["pcd_pixels"], batch.fine_valid, cfg)
    return reduce.mean(losses), reduce.mean(recalls)


def loss_2d3d(outputs, circle_cfg: CircleLossConfig, focal_cfg: LossConfig, batch=None,
              fine_cfg: FineLossConfig | None = None, reduce: BatchReduction = LOCAL_BATCH):
    """Total 2D-3D training loss -> (loss, info of 0-d tensors).

    ``circle + gt_hat + fine``, as the reference's OverallLoss at its default
    weights (1); the focal loss on ``conf_matrix_pred`` is logged,
    not added. The circle loss's positives (sqrt-scaled) and negatives both
    come from the MIN overlap ratio (the reference aliases the max overlaps to
    the min ones); without overlap pairs in the batch the binary GT matrix
    stands in. The fine loss needs the batch's fine GT pairs and ``fine_cfg``.
    """
    matrix_gt = outputs["matrix_gt"]
    node_masks, img_valid = outputs["node_masks"], outputs["img_valid_c"]
    valid = node_masks[:, :, None] & img_valid[:, None, :]
    n, m = matrix_gt.shape[1], matrix_gt.shape[2]
    if batch is not None and batch.ov_valid is not None:
        min_ov = scatter_overlaps(batch.ov_src, batch.ov_tgt, batch.ov_min, batch.ov_valid, n, m)
    else:
        min_ov = matrix_gt
    pos, neg, scales = overlap_masks(min_ov, circle_cfg)
    dists = normalized_feat_dists(outputs["pcd_feats_c"], outputs["img_feats_c"])
    l_circle = reduce.mean(circle_loss(dists, pos & valid, neg & valid, circle_cfg, scales,
                                       row_valid=node_masks, col_valid=img_valid))
    l_focal = focal_correspondence_loss(outputs["conf_matrix_pred"], matrix_gt, valid, focal_cfg,
                                        reduce)
    l_gt_hat = focal_correspondence_loss(outputs["conf_matrix_gt_hat"], matrix_gt, valid,
                                         focal_cfg, reduce)
    info = {"circle": l_circle, "focal": l_focal, "gt_hat": l_gt_hat}
    total = l_circle + l_gt_hat
    if fine_cfg is not None and batch is not None and batch.fine_valid is not None:
        l_fine, recall = fine_loss_from_batch(outputs, batch, fine_cfg, reduce)
        total = total + l_fine
        info.update({"fine": l_fine, "fine_recall": recall})
    info["loss"] = total
    return total, info
