"""Geometric feature ops: vector angles, point-pair features, local
reference frames, PCA normal estimation.

Counterpart of the JAX package's ops/features.py (the reference's
vision3d/ops/{vector_angle,point_pair_feature,local_reference_frame,
normal_estimation}.py) in channel-last layout ([B, N, 3] / [N, 3]). Every
function runs on the device of its inputs; the k-nearest cuts break ties by
the lower index, as ``jax.lax.top_k`` does, and the 3x3 covariance
eigendecomposition of the normals runs batched on that device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .topk import stable_top_k
from .vision import pairwise_distance


def rad2deg(rad):
    return rad * (180.0 / math.pi)


def deg2rad(deg):
    return deg * (math.pi / 180.0)


def vector_angle(x, y, use_degree: bool = False):
    """Angle between 3D vectors over the last axis."""
    x, y = torch.broadcast_tensors(x, y)
    cross = torch.linalg.norm(torch.linalg.cross(x, y, dim=-1), dim=-1)
    dot = torch.sum(x * y, dim=-1)
    ang = torch.atan2(cross, dot)
    return rad2deg(ang) if use_degree else ang


def _group(x, idx):
    """[B, M, C] gathered by [B, N, K] -> [B, N, K, C]."""
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[b, idx]


def local_ppf(q_points, s_points, q_normals, s_normals, neighbor_indices,
              use_absolute_position: bool = False,
              use_relative_position: bool = False,
              use_degree: bool = False):
    """Local point-pair features [<na,d>, <nr,d>, <na,nr>, ||d||]: inputs
    [B, N, 3], neighbor indices [B, N, K] into s_points; output
    [B, N, K, 4/7/10]."""
    nbr_p = _group(s_points, neighbor_indices)
    nbr_n = _group(s_normals, neighbor_indices)
    anc_p = q_points[:, :, None, :].expand_as(nbr_p)
    anc_n = q_normals[:, :, None, :].expand_as(nbr_n)
    d = nbr_p - anc_p
    feats = torch.stack([
        vector_angle(anc_n, d, use_degree),
        vector_angle(nbr_n, d, use_degree),
        vector_angle(anc_n, nbr_n, use_degree),
        torch.linalg.norm(d, dim=-1),
    ], dim=-1)
    if use_relative_position:
        feats = torch.cat([d, feats], dim=-1)
    if use_absolute_position:
        feats = torch.cat([anc_p, feats], dim=-1)
    return feats


def global_ppf(points, normals, use_degree: bool = False):
    """All-pairs PPF: [B, N, N, 4]."""
    d = points[:, None, :, :] - points[:, :, None, :]
    anc_n = normals[:, :, None, :].expand_as(d)
    ref_n = normals[:, None, :, :].expand_as(d)
    return torch.stack([
        vector_angle(anc_n, d, use_degree),
        vector_angle(ref_n, d, use_degree),
        vector_angle(anc_n, ref_n, use_degree),
        torch.linalg.norm(d, dim=-1),
    ], dim=-1)


def build_local_reference_frame(points, normals, num_neighbors: int,
                                return_axes: bool = False):
    """LRF per point ("The Perfect Match" smoothed-density frames): z = normal;
    x = weighted in-plane direction (weights |z-coord|/dist); y = x × z.
    Returns the knn coordinates in the LRF [B, N, K, 3] (+ the axes [B, N, 3]
    x3 when return_axes)."""
    d2 = pairwise_distance(points, points, squared=True)
    _, idx = stable_top_k(-d2, num_neighbors)
    knn_points = _group(points, idx)                      # [B, N, K, 3]

    origins = points[:, :, None, :]
    z = normals / torch.linalg.norm(normals, dim=-1, keepdim=True).clamp_min(1e-12)
    z_ax = z[:, :, None, :]                               # [B, N, 1, 3]

    off = knn_points - origins
    dist = torch.linalg.norm(off, dim=-1, keepdim=True)
    z_coord = torch.sum(off * z_ax, dim=-1, keepdim=True)
    plane_off = off - z_coord * z_ax
    w = torch.abs(z_coord) / (dist + 1e-10)
    w = w / torch.sum(w, dim=2, keepdim=True).clamp_min(1e-12)
    x = torch.sum(plane_off * w, dim=2)
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-12)
    y = torch.linalg.cross(x, z, dim=-1)

    lrf = torch.stack([
        torch.sum(off * x[:, :, None, :], dim=-1),
        torch.sum(off * y[:, :, None, :], dim=-1),
        z_coord[..., 0],
    ], dim=-1)
    if return_axes:
        return x, y, z, lrf
    return lrf


def estimate_normals(q_points, s_points: Optional[torch.Tensor] = None,
                     k: int = 50, disambiguate_directions: bool = True):
    """PCA normals from the k nearest support points, unbatched [N, 3]. The
    eigenvector's sign is arbitrary unless ``disambiguate_directions`` turns
    each normal away from its neighbours' side."""
    if s_points is None:
        s_points = q_points
    d2 = pairwise_distance(q_points, s_points, squared=True)
    _, idx = stable_top_k(-d2, k)
    knn = s_points[idx]                                   # [N, K, 3]
    cen = knn.mean(dim=1, keepdim=True)
    off = knn - cen
    cov = torch.einsum("nki,nkj->nij", off, off) / k
    _, vecs = torch.linalg.eigh(cov)                      # ascending
    normals = vecs[:, :, 0]
    if disambiguate_directions:
        off_q = knn - q_points[:, None, :]
        proj = torch.sum(normals[:, None, :] * off_q, dim=2)
        flips = (torch.sum(proj, dim=-1, keepdim=True) > 0).to(normals.dtype)
        normals = (1.0 - 2.0 * flips) * normals
    return normals


def safe_divide(a, b, eps: float = 1e-6):
    return a / torch.clamp(b, min=eps)


def safe_sqrt(a, eps: float = 1e-6):
    return torch.sqrt(torch.clamp(a, min=eps))
