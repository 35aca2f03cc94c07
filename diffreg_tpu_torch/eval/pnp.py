"""PnP-RANSAC on the device: every hypothesis at once.

Counterpart of the JAX package's eval/pnp.py (which replaces the reference's
host cv2.solvePnPRansac): a hypothesis is a 6-correspondence DLT (the
smallest eigenvector of a 12x12 normal matrix, from a batched eigh) whose
3x3 block is projected onto the nearest rotation (Horn); hypotheses are
scored by reprojection inliers, and the best is refined twice by a DLT
weighted by its inliers. The draws ``u`` [H, 6], U[0, 1), come in as a
tensor. Returns the camera-from-cloud pose.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.procrustes import _horn_rotation


class PnPResult(NamedTuple):
    rotation: torch.Tensor      # [3, 3]
    translation: torch.Tensor   # [3, 1]
    inlier_count: torch.Tensor
    success: torch.Tensor       # bool: >= 4 inliers and a finite pose


def _dlt_projection(points, pixels, w):
    """Weighted DLT of x ~ P X: points [..., N, 3], pixels [..., N, 2] in
    normalised camera coordinates, w [..., N] -> P [..., 3, 4]."""
    x = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)   # [..., N, 4]
    zeros = torch.zeros_like(x)
    r1 = torch.cat([x, zeros, -pixels[..., 0:1] * x], dim=-1)           # [..., N, 12]
    r2 = torch.cat([zeros, x, -pixels[..., 1:2] * x], dim=-1)
    a = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)      # [..., 2N, 12]
    ata = a.transpose(-1, -2) @ a
    # torch's eigh raises on a non-finite matrix where JAX's returns NaN:
    # solve a stand-in there and return a NaN projection, whose hypothesis
    # then counts no inlier
    finite = torch.isfinite(ata).all(dim=-1).all(dim=-1)[..., None, None]
    stand_in = torch.diag(torch.arange(12, dtype=ata.dtype, device=ata.device))
    _, vecs = torch.linalg.eigh(torch.where(finite, ata, stand_in))
    p = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 4))
    return torch.where(finite, p, torch.full_like(p, float("nan")))


def _pose_from_projection(p):
    """P = [M | m] (K = I) -> (R, t) with det(M) > 0."""
    p = p * torch.where(torch.linalg.det(p[..., :3]) < 0, -1.0, 1.0)[..., None, None]
    scale = torch.linalg.det(p[..., :3]).clamp_min(1e-12) ** (1.0 / 3.0)
    r = _horn_rotation(p[..., :3] / scale[..., None, None])
    return r, (p[..., 3] / scale[..., None])[..., None]


def _reproject_inliers(r, t, points, pixels_px, intrinsics, valid, thr_px):
    """r [..., 3, 3], t [..., 3, 1]; points [N, 3], pixels (u, v) [N, 2]."""
    cam = points @ r.transpose(-1, -2) + t.transpose(-1, -2)
    z = cam[..., 2].clamp_min(1e-6)
    u = cam[..., 0] / z * intrinsics[0, 0] + intrinsics[0, 2]
    v = cam[..., 1] / z * intrinsics[1, 1] + intrinsics[1, 2]
    err2 = (u - pixels_px[:, 0]) ** 2 + (v - pixels_px[:, 1]) ** 2
    return (err2 < thr_px ** 2) & valid & (cam[..., 2] > 0)


def pnp_ransac(u, points3d, pixels, corr_valid, intrinsics, distance_tolerance=8.0,
               refine_iters=2) -> PnPResult:
    """u [H, 6] U[0, 1) draws; points3d [C, 3] cloud points, pixels [C, 2]
    (u, v) in pixels, corr_valid [C] (valid entries first), intrinsics [3, 3]."""
    c = points3d.shape[0]
    n_valid = corr_valid.sum().clamp_min(1)
    fx, fy, cx, cy = intrinsics[0, 0], intrinsics[1, 1], intrinsics[0, 2], intrinsics[1, 2]
    norm_pix = torch.stack([(pixels[:, 0] - cx) / fx, (pixels[:, 1] - cy) / fy], dim=1)

    idx = (u * n_valid).to(torch.int32).clamp(0, c - 1).long()        # [H, 6]
    p = _dlt_projection(points3d[idx], norm_pix[idx], torch.ones_like(u))
    r_h, t_h = _pose_from_projection(p)                               # [H, 3, 3], [H, 3, 1]
    counts = _reproject_inliers(r_h, t_h, points3d, pixels, intrinsics, corr_valid,
                                distance_tolerance).sum(dim=-1)
    best = torch.argmax(counts)
    r, t = r_h[best], t_h[best]
    best_inl = _reproject_inliers(r, t, points3d, pixels, intrinsics, corr_valid,
                                  distance_tolerance)
    for _ in range(refine_iters):
        r_new, t_new = _pose_from_projection(_dlt_projection(points3d, norm_pix,
                                                             best_inl.to(points3d.dtype)))
        inl_new = _reproject_inliers(r_new, t_new, points3d, pixels, intrinsics, corr_valid,
                                     distance_tolerance)
        improve = inl_new.sum() >= best_inl.sum()
        r = torch.where(improve, r_new, r)
        t = torch.where(improve, t_new, t)
        best_inl = torch.where(improve, inl_new, best_inl)
    finite = torch.isfinite(r).all() & torch.isfinite(t).all()
    count = best_inl.sum()
    return PnPResult(r, t, count, (count >= 4) & finite)
