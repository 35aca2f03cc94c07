"""vision3d loss library (torch): masked, static-shape losses.

Counterpart of the JAX package's engine/loss_library.py, the general-purpose
losses of the reference's ``vision3d/loss/`` that are not on the Diff-Reg
path but belong to the framework surface, and the deformable KPConv's
fitting regularizer:

  * chamfer_distance_loss, sigmoid_focal_loss(_with_logits),
    weighted_bce_loss(_with_logits), orthogonal_loss, rotation_loss,
    translation_loss, transformation_loss, smooth_cross_entropy_loss,
    hardest_contrastive_loss, as_rigid_as_possible_loss;
  * p2p_fitting_regularizer over the deformable KPConv modules'
    ``deform_aux`` (``nn.kpfcn.KPConv``).

Masks mean valid = True. As in JAX, the chamfer masks exclude invalid points
both as neighbours and from the mean (the reference's masking selects the very
rows it sets to inf), and the regularizer is not part of ``diffreg_loss``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.vision import pairwise_distance

_BIG = 1e10


def _reduce(x, mask, reduction):
    """Masked reduction over all axes; mask None means all valid."""
    if reduction == "none":
        return x if mask is None else torch.where(mask, x, torch.zeros_like(x))
    if mask is None:
        return x.mean() if reduction == "mean" else x.sum()
    total = torch.where(mask, x, torch.zeros_like(x)).sum()
    if reduction == "sum":
        return total
    return total / mask.sum().clamp_min(1)


def chamfer_distance_loss(src_points, tgt_points, src_mask=None, tgt_mask=None,
                          squared: bool = False, truncate: Optional[float] = None,
                          reduction: str = "mean"):
    """(Truncated) chamfer distance of [*, N, 3] and [*, M, 3] point sets:
    each direction's nearest-neighbour distances reduced over the valid points
    (``truncate``: only those below it), the two directions added."""
    d = pairwise_distance(src_points, tgt_points, squared=True)
    if not squared:
        d = torch.sqrt(d.clamp_min(1e-12))
    if src_mask is not None:
        d = torch.where(src_mask[..., :, None], d, torch.full_like(d, _BIG))
    if tgt_mask is not None:
        d = torch.where(tgt_mask[..., None, :], d, torch.full_like(d, _BIG))
    src_nn = d.amin(dim=-1)
    tgt_nn = d.amin(dim=-2)
    src_valid = src_mask if src_mask is not None else torch.ones_like(src_nn, dtype=torch.bool)
    tgt_valid = tgt_mask if tgt_mask is not None else torch.ones_like(tgt_nn, dtype=torch.bool)
    if truncate is not None:
        thr = truncate ** 2 if squared else truncate
        src_valid = src_valid & (src_nn < thr)
        tgt_valid = tgt_valid & (tgt_nn < thr)
    return _reduce(src_nn, src_valid, reduction) + _reduce(tgt_nn, tgt_valid, reduction)


def _bce(p, targets, eps=1e-7):
    p = p.clamp(eps, 1.0 - eps)
    return -(targets * torch.log(p) + (1.0 - targets) * torch.log1p(-p))


def _bce_with_logits(logits, targets):
    return logits.clamp_min(0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _focal(ce, p, targets, alpha, gamma):
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
    return loss


def sigmoid_focal_loss(inputs, targets, alpha: float = -1, gamma: float = 2,
                       reduction: str = "none", mask=None):
    """Focal loss on probabilities (the FVCore formula)."""
    return _reduce(_focal(_bce(inputs, targets), inputs, targets, alpha, gamma), mask,
                   reduction)


def sigmoid_focal_loss_with_logits(inputs, targets, alpha: float = -1, gamma: float = 2,
                                   reduction: str = "none", mask=None):
    """Focal loss on logits."""
    return _reduce(_focal(_bce_with_logits(inputs, targets), torch.sigmoid(inputs), targets,
                          alpha, gamma), mask, reduction)


def _balance(targets, mask):
    """Per-entry class weights: targets (1 - mean) + (1 - targets) mean, the
    mean over the valid entries, detached."""
    neg_w = _reduce(targets, mask, "mean")
    return (targets * (1.0 - neg_w) + (1.0 - targets) * neg_w).detach()


def weighted_bce_loss(inputs, targets, reduction: str = "mean", mask=None):
    """BCE on probabilities with detached positive/negative class balancing."""
    return _reduce(_balance(targets, mask) * _bce(inputs, targets), mask, reduction)


def weighted_bce_loss_with_logits(inputs, targets, reduction: str = "mean", mask=None):
    """``weighted_bce_loss`` on logits."""
    return _reduce(_balance(targets, mask) * _bce_with_logits(inputs, targets), mask,
                   reduction)


def orthogonal_loss(inputs, targets=None, reduction: str = "mean"):
    """Mean squared entry of R^T R* - I (``targets`` None: of R - I)."""
    r = inputs if targets is None else inputs.transpose(-1, -2) @ targets
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(r.shape)
    return _reduce((r - eye) ** 2, None, reduction)


def rotation_loss(estimated_rotations, gt_rotations):
    """MSE of R_est^T R_gt against the identity."""
    return orthogonal_loss(estimated_rotations, gt_rotations, reduction="mean")


def translation_loss(estimated_translations, gt_translations):
    """MSE of the translations."""
    return ((estimated_translations - gt_translations) ** 2).mean()


def transformation_loss(est_rotations, est_translations, gt_rotations, gt_translations,
                        weight_r: float = 1.0, weight_t: float = 1.0):
    """(weight_r r_loss + weight_t t_loss, r_loss, t_loss) of (R, t) poses."""
    r_loss = rotation_loss(est_rotations, gt_rotations)
    t_loss = translation_loss(est_translations, gt_translations)
    return weight_r * r_loss + weight_t * t_loss, r_loss, t_loss


def smooth_cross_entropy_loss(inputs, targets, eps: float = 0.1):
    """Label-smoothed cross-entropy of logits [B, C, *] and int labels [B, *]."""
    num_classes = inputs.shape[1]
    logp = F.log_softmax(inputs, dim=1)
    one_hot = F.one_hot(targets.long(), num_classes).movedim(-1, 1).to(logp.dtype)
    smoothed = one_hot * (1.0 - eps) + eps / num_classes
    return -(smoothed * logp).sum(dim=1).mean()


def hardest_contrastive_loss(feats0, feats1, pos_pairs, pos_pair_mask, pos_thresh: float,
                             neg_thresh: float, mask0=None, mask1=None):
    """Hardest-in-batch contrastive loss over padded positive pairs [P, 2]
    (``pos_pair_mask`` [P]), every point a negative candidate unless it is a
    valid positive of the anchor or masked out. Returns dict(loss, pos_loss,
    neg_loss)."""
    i0, i1 = pos_pairs[:, 0].long(), pos_pairs[:, 1].long()
    a0, a1 = feats0[i0], feats1[i1]
    pos_d = torch.linalg.norm(a0 - a1, dim=-1)
    pos_loss = _reduce((pos_d - pos_thresh).clamp_min(0.0) ** 2, pos_pair_mask, "mean")

    n, m = feats0.shape[0], feats1.shape[0]
    # positives of each anchor row; padded pairs write a sentinel row
    safe_i0 = torch.where(pos_pair_mask, i0, torch.full_like(i0, n))
    pos0 = torch.zeros((n + 1, m), dtype=torch.bool, device=feats0.device)
    pos0[safe_i0, i1] = True
    pos0 = pos0[:n]
    d0 = torch.sqrt(pairwise_distance(a0, feats1, squared=True).clamp_min(1e-12))
    d1 = torch.sqrt(pairwise_distance(a1, feats0, squared=True).clamp_min(1e-12))
    bad0, bad1 = pos0[i0], pos0[:, i1].T
    if mask1 is not None:
        bad0 = bad0 | ~mask1[None, :]
    if mask0 is not None:
        bad1 = bad1 | ~mask0[None, :]
    nn0 = torch.where(bad0, torch.full_like(d0, _BIG), d0).amin(dim=1)
    nn1 = torch.where(bad1, torch.full_like(d1, _BIG), d1).amin(dim=1)
    neg0 = _reduce((neg_thresh - nn0).clamp_min(0.0) ** 2, pos_pair_mask, "mean")
    neg1 = _reduce((neg_thresh - nn1).clamp_min(0.0) ** 2, pos_pair_mask, "mean")
    neg_loss = 0.5 * (neg0 + neg1)
    return {"loss": pos_loss + neg_loss, "pos_loss": pos_loss, "neg_loss": neg_loss}


def as_rigid_as_possible_loss(nodes, rotations, translations, edge_indices,
                              edge_weights=None, edge_mask=None):
    """ARAP regularizer of a deformation graph: nodes [V, 3], per-node
    rotations [V, 3, 3] and translations [V, 3], padded edges [E, 2] (anchor,
    reference) with optional weights and validity."""
    anc, ref = edge_indices[:, 0].long(), edge_indices[:, 1].long()
    anc_nodes, ref_nodes = nodes[anc], nodes[ref]
    warped = torch.einsum("eij,ej->ei", rotations[anc], ref_nodes - anc_nodes) \
        + translations[anc] + anc_nodes
    vals = ((warped - (ref_nodes + translations[ref])) ** 2).sum(dim=-1)
    if edge_weights is not None:
        vals = vals * edge_weights
    return _reduce(vals, edge_mask, "mean")


def deform_auxes(model):
    """The ``deform_aux`` of every deformable KPConv of ``model`` that has run
    a forward, in module order."""
    return [m.deform_aux for m in model.modules() if getattr(m, "deform_aux", None) is not None]


def p2p_fitting_regularizer(auxes, fitting_power: float = 1.0, repulse_extent: float = 1.2):
    """KPConv's point-to-point fitting regularizer of deformable convs, summed
    over them, times ``fitting_power``; 0 where there are none.

    ``auxes``: a model (its ``deform_auxes``) or a list of ``deform_aux``
    dicts (``min_d2`` [B, Nq, P], ``deformed_kp`` [B, Nq, P, 3], ``kp_extent``,
    ``q_mask`` [B, Nq]). Per conv, over the valid queries: the fitting term,
    the mean of min_d2 / extent^2 (each deformed point pulled to its nearest
    input point), and the repulsive term, the sum over ordered pairs of
    distinct points of min(|kp_i - kp_j| / extent - repulse_extent, 0)^2 / P
    with kp_j detached."""
    if isinstance(auxes, torch.nn.Module):
        auxes = deform_auxes(auxes)
    total = torch.zeros((), dtype=torch.float32)
    for aux in auxes:
        extent = aux["kp_extent"]
        m = aux["q_mask"].to(torch.float32)
        denom = m.sum().clamp_min(1.0)
        total = total.to(m.device) + ((aux["min_d2"].mean(dim=-1) / extent ** 2) * m).sum() / denom
        kp = aux["deformed_kp"] / extent
        p = kp.shape[-2]
        diff = kp[..., :, None, :] - kp[..., None, :, :].detach()
        sq = (diff * diff).sum(dim=-1)
        eye = torch.eye(p, dtype=torch.bool, device=kp.device)
        dist = torch.sqrt(torch.where(eye, torch.ones_like(sq), sq))
        pen = torch.where(eye, torch.zeros_like(dist), (dist - repulse_extent).clamp_max(0.0) ** 2)
        total = total + (pen.sum(dim=(-1, -2)) / p * m).sum() / denom
    return fitting_power * total
