"""SE(3) helpers (batched)."""
from __future__ import annotations

import torch


def apply_transform(points, rotation, translation):
    """R p + t for points [B, N, 3], rotation [B, 3, 3], translation [B, 3, 1]."""
    return points @ rotation.transpose(-1, -2) + translation.transpose(-1, -2)


def rotation_error_deg(r_est, r_gt):
    """Isotropic rotation error in degrees (RRE) of [..., 3, 3] rotations."""
    trace = torch.einsum("...ij,...ij->...", r_est, r_gt)
    return torch.rad2deg(torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)))


def translation_error(t_est, t_gt):
    """Euclidean translation error (RTE); t are [..., 3] or [..., 3, 1]."""
    d = t_est - t_gt
    if d.shape[-1] == 1:
        d = d[..., 0]
    return torch.linalg.norm(d, dim=-1)
