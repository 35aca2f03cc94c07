"""Correspondence-based RANSAC on the device, all hypotheses at once, batched over pairs.

Replaces Open3D's sequential ``registration_ransac_based_on_correspondence``:
sample 3-point minimal sets from each pair's correspondence list, solve each
by frame alignment, count inliers of every hypothesis with one matmul over
17 static features, keep the best, then refine with weighted Kabsch on its
inlier set. The hypothesis draws ``u`` are passed in, so a test can feed
both packages the same numbers.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.procrustes import weighted_kabsch
from ..geometry.se3 import apply_transform


class RansacResult(NamedTuple):
    rotation: torch.Tensor       # [B, 3, 3]
    translation: torch.Tensor    # [B, 3, 1]
    inlier_count: torch.Tensor   # [B]
    best_fraction: torch.Tensor  # [B] inliers / valid correspondences


def _three_point_pose(s3, t3, eps=1e-12, degenerate_tol=1e-5):
    """Rigid pose from minimal sets s3, t3 [..., 3 points, 3] by frame alignment
    -> (R [..., 3, 3], t [..., 3, 1], ok). ok is False for degenerate
    (duplicated or collinear) samples, whose R is not orthonormal."""
    def frame(p):
        u1 = p[..., 1, :] - p[..., 0, :]
        u2 = p[..., 2, :] - p[..., 0, :]
        n1 = torch.linalg.norm(u1, dim=-1, keepdim=True)
        e1 = u1 / n1.clamp_min(eps)
        u2p = u2 - torch.sum(u2 * e1, dim=-1, keepdim=True) * e1
        n2 = torch.linalg.norm(u2p, dim=-1, keepdim=True)
        e2 = u2p / n2.clamp_min(eps)
        e3 = torch.linalg.cross(e1, e2, dim=-1)
        ok = (n1[..., 0] > degenerate_tol) & (n2[..., 0] > degenerate_tol)
        return torch.stack([e1, e2, e3], dim=-1), ok   # frame vectors as columns

    fs, ok_s = frame(s3)
    ft, ok_t = frame(t3)
    r = ft @ fs.transpose(-1, -2)
    cs = s3.mean(dim=-2, keepdim=True)
    ct = t3.mean(dim=-2, keepdim=True)
    t = ct.transpose(-1, -2) - r @ cs.transpose(-1, -2)
    return r, t, ok_s & ok_t


def _inliers(src_corr, tgt_corr, corr_valid, r, t, thr2):
    warped = apply_transform(src_corr, r, t)
    return (torch.sum((warped - tgt_corr) ** 2, dim=-1) < thr2) & corr_valid


def ransac_pose(u, src_corr, tgt_corr, corr_valid, distance_threshold=0.05,
                refine_iters=2):
    """RANSAC for a batch of pairs.

    u [B, H, 3] uniform draws in [0, 1) (one minimal set per hypothesis);
    src_corr, tgt_corr [B, C, 3] score-sorted correspondences with the valid
    ones first; corr_valid [B, C] bool.
    """
    b, c, _ = src_corr.shape
    h = u.shape[1]
    thr2 = distance_threshold ** 2
    n_valid = corr_valid.sum(dim=1).clamp_min(1)                       # [B]
    # indices [0, n_valid) hit exactly the valid (sorted-first) entries
    idx = torch.clamp((u * n_valid[:, None, None].to(u.dtype)).to(torch.int64), 0, c - 1)
    gather = lambda pts: torch.gather(
        pts, 1, idx.reshape(b, h * 3, 1).expand(b, h * 3, 3)).reshape(b, h, 3, 3)
    r_h, t_h, ok_h = _three_point_pose(gather(src_corr), gather(tgt_corr))

    # ||R s + t - t'||^2 = (||s||^2 + ||t'||^2) + ||t||^2 + 2 <R^T t, s>
    #                      - 2 <t, t'> - 2 <vec(R), vec(t' s^T)>
    # so d2[h, c] = W[h, :] @ G[:, c] with 17 static features.
    ones_c = src_corr.new_ones((b, c, 1))
    g = torch.cat([
        ones_c,
        (torch.sum(src_corr ** 2, -1) + torch.sum(tgt_corr ** 2, -1))[..., None],
        src_corr,
        tgt_corr,
        (tgt_corr[..., :, None] * src_corr[..., None, :]).reshape(b, c, 9),
    ], dim=-1)                                                            # [B, C, 17]
    t_flat = t_h[..., 0]                                                  # [B, H, 3]
    rt_t = torch.einsum("bhij,bhi->bhj", r_h, t_flat)
    w = torch.cat([
        torch.sum(t_flat ** 2, -1, keepdim=True),
        t_flat.new_ones((b, h, 1)),
        2.0 * rt_t,
        -2.0 * t_flat,
        -2.0 * r_h.reshape(b, h, 9),
    ], dim=-1)                                                            # [B, H, 17]
    d2 = w @ g.transpose(1, 2)                                            # [B, H, C]
    counts = ((d2 < thr2) & corr_valid[:, None, :]).sum(dim=-1)
    counts = torch.where(ok_h, counts, torch.full_like(counts, -1))
    best = torch.argmax(counts, dim=1)                                    # first maximum
    pick = torch.arange(b, device=u.device)
    r, t = r_h[pick, best], t_h[pick, best]
    best_inliers = _inliers(src_corr, tgt_corr, corr_valid, r, t, thr2)

    for _ in range(refine_iters):
        r_new, t_new, _ = weighted_kabsch(src_corr, tgt_corr,
                                          best_inliers.to(src_corr.dtype)[..., None])
        new_inliers = _inliers(src_corr, tgt_corr, corr_valid, r_new, t_new, thr2)
        improve = new_inliers.sum(dim=1) >= best_inliers.sum(dim=1)
        r = torch.where(improve[:, None, None], r_new, r)
        t = torch.where(improve[:, None, None], t_new, t)
        best_inliers = torch.where(improve[:, None], new_inliers, best_inliers)

    count = best_inliers.sum(dim=1)
    return RansacResult(r, t, count, count / n_valid)
