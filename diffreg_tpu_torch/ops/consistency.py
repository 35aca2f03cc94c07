"""Correspondence spatial-consistency ops (the reference's vision3d/ops/
spatial_consistency.py and eigenvector.py): the SC²/PointDSC outlier-rejection
primitives.

Counterpart of the JAX package's ops/consistency.py. The leading eigenvector
runs a fixed number of power iterations on the device: no early exit, so no
read back to the host between them.
"""
from __future__ import annotations

import torch

from .vision import pairwise_distance


def spatial_consistency(src_corr_points, tgt_corr_points, sigma: float):
    """SC_ij = relu(1 - d_ij^2 / sigma^2), d = | |p_i-p_j| - |q_i-q_j| |:
    [*, N, 3] x2 -> [*, N, N]."""
    sd = pairwise_distance(src_corr_points, src_corr_points, squared=False)
    td = pairwise_distance(tgt_corr_points, tgt_corr_points, squared=False)
    delta = torch.abs(sd - td)
    return torch.relu(1.0 - delta ** 2 / sigma ** 2)


def cross_spatial_consistency(q_src, q_tgt, s_src, s_tgt, sigma: float):
    """Consistency between two correspondence sets: [*, N, M]."""
    sd = pairwise_distance(q_src, s_src, squared=False)
    td = pairwise_distance(q_tgt, s_tgt, squared=False)
    delta = torch.abs(sd - td)
    return torch.relu(1.0 - delta ** 2 / sigma ** 2)


def leading_eigenvector(mat, num_iterations: int = 10):
    """Leading eigenvector by power iteration. mat: [*, M, M] (symmetric,
    non-negative, e.g. a consistency matrix). Returns [*, M]."""
    v = torch.ones_like(mat[..., :1])
    for _ in range(num_iterations):
        v = mat @ v
        v = v / torch.linalg.norm(v, dim=-2, keepdim=True).clamp_min(1e-12)
    return v[..., 0]
