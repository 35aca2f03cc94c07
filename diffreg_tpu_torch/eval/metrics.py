"""Registration metrics: IR, FMR, RR (covariance criterion) and NFMR.

Counterpart of the JAX package's eval/metrics.py (the reference
models/loss.py:27-44, 178-271, 382-448):

  * inlier ratio under the GT transform, from a correspondence buffer or from
    a boolean match matrix; for 4DMatch the source is deformed by the GT flow
    first;
  * registration recall by the Predator covariance-weighted transform error;
  * NFMR for deformable pairs: the predicted anchor motions blended onto the
    metric points by radius-limited 3-NN inverse-distance weights.

``inlier_ratio``, ``masked_inlier_ratio`` and the recall functions take a
leading batch axis (the JAX tester ``vmap``s them over pairs);
``blend_anchor_motion`` and ``nfmr`` take one pair, as the JAX tester calls
them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.topk import top_k


def matrix_to_quaternion(r):
    """Rotation matrices [..., 3, 3] -> unit quaternions [..., 4] (w, x, y, z),
    Shepperd's branch chosen by the largest of (trace, m00, m11, m22)."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22
    root = lambda x: torch.sqrt(torch.clamp(x, min=1e-12))

    qw0 = root(1 + tr) / 2
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], -1)
    s1 = root(1 + m00 - m11 - m22) * 2
    q1 = torch.stack([(m21 - m12) / s1, s1 / 4, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    s2 = root(1 - m00 + m11 - m22) * 2
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, s2 / 4, (m12 + m21) / s2], -1)
    s3 = root(1 - m00 - m11 + m22) * 2
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, s3 / 4], -1)

    best = torch.argmax(torch.stack([tr, m00, m11, m22], -1), dim=-1)   # first maximum
    qs = torch.stack([q0, q1, q2, q3], dim=-2)                         # [..., 4, 4]
    q = torch.take_along_dim(qs, best[..., None, None].expand(*best.shape, 1, 4),
                             dim=-2)[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def _warp(points, rot_gt, trn_gt):
    """points [B, N, 3] under (rot_gt [B, 3, 3], trn_gt [B, 3] or [B, 3, 1])."""
    return points @ rot_gt.transpose(-1, -2) + trn_gt.reshape(-1, 1, 3)


def _ratio(inliers, count, min_matches):
    ir = inliers.sum(dim=-1).to(torch.float32) / count.clamp_min(1).to(torch.float32)
    return torch.where(count >= min_matches, ir, torch.zeros_like(ir))


def inlier_ratio(src_corr, tgt_corr, corr_valid, rot_gt, trn_gt, inlier_thr=0.1,
                 coarse_flow_corr=None, min_matches=3):
    """IR per pair from correspondence buffers src_corr/tgt_corr [B, C, 3],
    corr_valid [B, C] (loss.py:382-410). For 4DMatch pass the per-
    correspondence GT flow, which deforms the source before the GT warp."""
    base = src_corr + coarse_flow_corr if coarse_flow_corr is not None else src_corr
    d2 = torch.sum((_warp(base, rot_gt, trn_gt) - tgt_corr) ** 2, dim=-1)
    return _ratio((d2 < inlier_thr ** 2) & corr_valid, corr_valid.sum(dim=-1), min_matches)


def masked_inlier_ratio(corr_mask, s_pcd, t_pcd, rot_gt, trn_gt, inlier_thr=0.1,
                        coarse_flow=None, min_matches=3):
    """IR per pair over every match of corr_mask [B, S, T] (no buffer, so no
    score-ordered truncation); invalid entries must already be masked out.
    For 4DMatch pass the per-source GT flow [B, S, 3]."""
    base = s_pcd + coarse_flow if coarse_flow is not None else s_pcd
    warped = _warp(base, rot_gt, trn_gt)
    d2 = torch.sum((warped[:, :, None, :] - t_pcd[:, None, :, :]) ** 2, dim=-1)
    inl = ((d2 < inlier_thr ** 2) & corr_mask).flatten(1)
    return _ratio(inl, corr_mask.flatten(1).sum(dim=-1), min_matches)


def transformation_error_covariance(pred_rot, pred_trn, rot_gt, trn_gt, info):
    """Predator/redwood covariance-weighted transform error (loss.py:27-44):
    trans = inv(gt) @ pred; er = [t; quat_xyz]; p = er^T info er / info[0, 0]."""
    rel_r = rot_gt.transpose(-1, -2) @ pred_rot
    rel_t = rot_gt.transpose(-1, -2) @ (pred_trn - trn_gt)
    q = matrix_to_quaternion(rel_r)
    er = torch.cat([rel_t[..., 0], q[..., 1:]], dim=-1)                # [..., 6]
    return torch.einsum("...i,...ij,...j->...", er, info, er) / info[..., 0, 0]


def registration_recall_success(pred_rot, pred_trn, rot_gt, trn_gt, gt_cov, thr=0.2):
    """Success per pair: covariance transform error <= thr^2."""
    return transformation_error_covariance(pred_rot, pred_trn, rot_gt, trn_gt, gt_cov) <= thr ** 2


def blend_anchor_motion(query, anchors, anchor_motion, anchor_valid, knn=3, search_radius=0.1):
    """Inverse-distance blend of the motion of the ``knn`` nearest valid anchors
    onto query [M, 3] (loss.py:250-271); anchors [A, 3] padded with
    anchor_valid [A]. Returns (blended [M, 3], invalid [M]): a query with no
    anchor within ``search_radius`` is invalid."""
    a = torch.where(anchor_valid[:, None], anchors, torch.full_like(anchors, 1e6))
    d2 = torch.sum((query[:, None, :] - a[None, :, :]) ** 2, dim=-1)   # [M, A]
    neg, idx = top_k(-d2, knn)
    dists = torch.clamp(torch.sqrt(torch.clamp(-neg, min=1e-20)), min=1e-10)
    out_of_range = dists > search_radius
    w = 1.0 / torch.where(out_of_range, torch.full_like(dists, 1e10), dists)
    w = w / torch.sum(w, dim=1, keepdim=True)
    blended = torch.sum(anchor_motion[idx] * w[..., None], dim=1)
    return blended, out_of_range.sum(dim=1) >= knn


def nfmr(metric_pcd, metric_flow_gt, rot_gt, trn_gt, anchor_src, anchor_tgt, anchor_valid,
         metric_valid, recall_thr=0.04, min_anchors=3):
    """Non-rigid feature matching recall of one pair (loss.py:178-248):
    metric_pcd [M, 3] raw source points with GT flow [M, 3]; the matched coarse
    correspondences (anchor_src -> anchor_tgt [A, 3]) are the motion anchors."""
    blended, _ = blend_anchor_motion(metric_pcd, anchor_src, anchor_tgt - anchor_src,
                                     anchor_valid)
    gt_warped = (metric_pcd + metric_flow_gt) @ rot_gt.T + trn_gt.reshape(1, 3)
    dist = torch.linalg.norm(metric_pcd + blended - gt_warped, dim=1)
    ok = (dist < recall_thr) & metric_valid
    r = ok.sum().to(torch.float32) / metric_valid.sum().clamp_min(1).to(torch.float32)
    return torch.where(anchor_valid.sum() >= min_anchors, r, torch.zeros_like(r))


def fmr_from_irs(irs, fmr_thr: float = 0.05) -> float:
    """Feature matching recall: the fraction of pairs with IR > fmr_thr."""
    return float((np.asarray(irs) > fmr_thr).mean())
