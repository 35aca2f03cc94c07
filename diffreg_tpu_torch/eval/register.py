"""End-to-end registration: DDIM matching, correspondence list, RANSAC pose.

The flow of the JAX package's ``bench.py:register``: ``ddim_sample``, then
``extract_correspondences`` with ``max_corr = S + T`` and RANSAC with a
0.05 distance threshold over the hypotheses drawn in ``u``.
"""
from __future__ import annotations

import torch

from ..ops.select import extract_correspondences
from ..utils.device import resolve_device
from .ransac import ransac_pose


def _rows(pts, idx):
    return torch.gather(pts, 1, idx[..., None].expand(-1, -1, 3))


@torch.no_grad()
def correspond_and_ransac(out: dict, u, distance_threshold: float = 0.05):
    """RANSAC pose [B, 3, 3], [B, 3, 1] from a ``ddim_sample`` output."""
    s_pcd, t_pcd = out["s_pcd"], out["t_pcd"]
    corrs = extract_correspondences(out["corr_mask"], out["conf_matrix_pred"],
                                    s_pcd.shape[1] + t_pcd.shape[1])
    res = ransac_pose(u, _rows(s_pcd, corrs.src_idx), _rows(t_pcd, corrs.tgt_idx),
                      corrs.valid, distance_threshold=distance_threshold)
    return res.rotation, res.translation


def register(model, batch, x_init, u, device=None, distance_threshold: float = 0.05):
    """Register a batch of pairs on ``device`` (default "cuda"; raises when CUDA is
    missing). x_init [B, S, T] is the DDIM start, u [B, H, 3] the RANSAC draws
    (H = 8192 on the benchmark path). Returns the ``ddim_sample`` outputs plus
    ``ransac_rotation`` and ``ransac_translation``."""
    device = resolve_device(device)
    out = model.ddim_sample(batch.to(device), x_init.to(device))
    rot, trn = correspond_and_ransac(out, u.to(device), distance_threshold)
    return {**out, "ransac_rotation": rot, "ransac_translation": trn}
