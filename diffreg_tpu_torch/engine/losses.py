"""Training losses and match metrics — masked, static-shape.

Counterpart of the JAX package's engine/losses.py (the reference
MatchMotionLoss, Diff-Reg-3dmatch/models/loss.py:47-175): the focal
correspondence loss on the Sinkhorn confidences (positive and negative
terms), the same loss on the denoised matrix ``conf_matrix_gt_hat``, an
optional L1 warped-flow motion loss, and recall/precision. Every reduction
counts valid (unpadded) entries only.

The normalisers are the batch's: the focal terms divide by the batch-wide
positive and negative counts, recall and precision count over the batch, the
motion loss divides by the batch-wide overlap count. ``reduce`` (a
``BatchReduction``) says what "the batch" is: in one process the pairs at hand;
in the data-parallel step (``parallel.mesh.GlobalBatch``) the pairs of every
process, as JAX's jit over the sharded global batch takes them.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LossConfig:
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    pos_weight: float = 1.0
    neg_weight: float = 1.0
    motion_weight: float = 0.0
    match_weight: float = 1.0
    match_type: str = "sinkhorn"
    dataset: str = "3dmatch"


class BatchReduction:
    """The batch-wide reductions of the losses, over the pairs at hand (one
    process). ``sum(x)``: the batch's total of ``x``, this process's partial
    sum; ``mean(x)``: the mean of the per-pair values ``x`` over the batch."""

    def sum(self, x):
        return x

    def mean(self, x):
        return x.mean()


LOCAL_BATCH = BatchReduction()


def _masked_mean(values, mask, reduce: BatchReduction = LOCAL_BATCH):
    """Sum of values over mask / max(count, 1), both over the batch."""
    total = reduce.sum(torch.where(mask, values, torch.zeros_like(values)).sum())
    return total / reduce.sum(mask.sum()).clamp_min(1).to(values.dtype)


def focal_correspondence_loss(conf, conf_gt, valid, cfg: LossConfig,
                              reduce: BatchReduction = LOCAL_BATCH):
    """Focal loss over the matching matrix (loss.py:273-315). conf, conf_gt
    [B, S, T]; valid [B, S, T] bool. The positive term averages over GT
    entries, the negative one over valid non-GT entries; the positive term is
    dropped when the batch has no GT match (loss.py:286-290)."""
    conf = torch.clamp(conf, 1e-6, 1.0 - 1e-6)
    pos = (conf_gt > 0.5) & valid
    neg = (conf_gt <= 0.5) & valid
    alpha, gamma = cfg.focal_alpha, cfg.focal_gamma
    loss_pos = _masked_mean(-alpha * (1.0 - conf) ** gamma * torch.log(conf), pos, reduce)
    if cfg.match_type == "dual_softmax":
        return cfg.pos_weight * loss_pos
    loss_neg = _masked_mean(-alpha * conf ** gamma * torch.log(1.0 - conf), neg, reduce)
    has_pos = (reduce.sum(pos.sum()) > 0).to(conf.dtype)
    return cfg.pos_weight * loss_pos * has_pos + cfg.neg_weight * loss_neg


def match_recall_precision(conf_gt, pred_mask, reduce: BatchReduction = LOCAL_BATCH):
    """Recall and precision of a predicted match mask against the GT matrix."""
    gt = conf_gt > 0.5
    tp = reduce.sum((pred_mask & gt).sum())
    return (tp / reduce.sum(gt.sum()).clamp_min(1),
            tp / reduce.sum(pred_mask.sum()).clamp_min(1))


def motion_l1_loss(s_pcd, rotation_pred, translation_pred, rot_gt, trn_gt, overlap_mask,
                   coarse_flow=None, reduce: BatchReduction = LOCAL_BATCH):
    """L1 between the predicted and GT source flow on overlap points
    (loss.py:113-132); ``coarse_flow`` deforms the source first (4DMatch)."""
    pred_warp = s_pcd @ rotation_pred.transpose(1, 2) + translation_pred.transpose(1, 2)
    base = s_pcd + coarse_flow if coarse_flow is not None else s_pcd
    gt_warp = base @ rot_gt.transpose(1, 2) + trn_gt.transpose(1, 2)
    e1 = torch.sum(torch.abs((pred_warp - s_pcd) - (gt_warp - s_pcd)), dim=2)   # [B, S]
    return _masked_mean(e1, overlap_mask, reduce)


def diffreg_loss(outputs, batch, cfg: LossConfig, reduce: BatchReduction = LOCAL_BATCH):
    """Total training loss (loss.py:80-175): focal(pred) + focal(gt_hat)
    [+ motion L1], its normalisers over the batch of ``reduce``. Returns
    (loss, info) with 0-d tensors."""
    valid = batch.src_mask[:, :, None] & batch.tgt_mask[:, None, :]
    matrix_gt = outputs["matrix_gt"]
    focal_coarse = focal_correspondence_loss(outputs["conf_matrix_pred"], matrix_gt, valid, cfg,
                                             reduce)
    recall, precision = match_recall_precision(matrix_gt, outputs["match_mask_pred"], reduce)
    loss = cfg.match_weight * focal_coarse
    info = {"focal_coarse": focal_coarse, "recall_coarse": recall,
            "precision_coarse": precision}
    if cfg.motion_weight > 0:
        # overlap: source rows that appear in the GT correspondences
        overlap = (matrix_gt.sum(dim=2) > 0) & batch.src_mask
        flow = batch.coarse_flow if cfg.dataset == "4dmatch" else None
        l1 = motion_l1_loss(outputs["s_pcd"], outputs["rotation_pred"],
                            outputs["translation_pred"], batch.rot_gt, batch.trn_gt, overlap,
                            flow, reduce)
        # the reference gates the motion loss on recall > 0.01 (loss.py:113)
        loss = loss + cfg.motion_weight * l1 * (recall > 0.01).to(l1.dtype)
        info["l1_motion"] = l1
    loss_gt_hat = focal_correspondence_loss(outputs["conf_matrix_gt_hat"], matrix_gt, valid, cfg,
                                            reduce)
    loss = loss + loss_gt_hat
    info["loss_matrix_gt_hat"] = loss_gt_hat
    info["loss"] = loss
    return loss, info
