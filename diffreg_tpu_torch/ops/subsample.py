"""Voxel-grid barycenter subsampling: on the device with a static output
size (``grid_subsample``) and on the host (numpy). Outputs are ordered by
voxel key."""
from __future__ import annotations

import numpy as np
import torch

_SENTINEL = 2 ** 30


def grid_subsample(points, valid, voxel_size, max_out: int):
    """Barycentre of every occupied voxel of points [N, 3] (``valid`` [N]
    bool), on their device, in ``max_out`` static slots ordered by the voxel's
    integer coordinates (x, then y, then z); voxels past ``max_out`` are
    dropped. Returns (sub_points [max_out, 3], sub_valid [max_out] bool,
    num_valid)."""
    sentinel = torch.tensor(_SENTINEL, dtype=torch.int32, device=points.device)
    inf = torch.full_like(points, float("inf"))
    origin = torch.where(valid[:, None], points, inf).amin(dim=0)
    coords = torch.floor((points - origin) / voxel_size).to(torch.int32)
    coords = torch.where(valid[:, None], coords, sentinel)
    uniq, inv = torch.unique(coords, dim=0, sorted=True, return_inverse=True)
    slots = max_out + 1
    if uniq.shape[0] < slots:
        uniq = torch.cat([uniq, sentinel.expand(slots - uniq.shape[0], 3)])
    uniq = uniq[:slots]
    kept = inv < slots                                   # voxels past the slots drop out
    seg = torch.where(kept, inv, torch.zeros_like(inv))
    ones = (valid & kept).to(points.dtype)
    counts = torch.zeros(slots, dtype=points.dtype, device=points.device).index_add_(0, seg, ones)
    sums = torch.zeros(slots, 3, dtype=points.dtype, device=points.device).index_add_(
        0, seg, points * ones[:, None])
    bary = sums / counts.clamp_min(1.0)[:, None]
    sub_valid = (counts > 0) & (uniq != sentinel).any(dim=1)
    return bary[:max_out], sub_valid[:max_out], sub_valid[:max_out].sum().to(torch.int32)


def grid_subsample_np(points: np.ndarray, voxel_size: float):
    """Barycenter of every occupied voxel, ordered by voxel key."""
    origin = points.min(axis=0)
    coords = np.floor((points - origin) / voxel_size).astype(np.int64)
    dims = coords.max(axis=0) + 1
    key = (coords[:, 0] * dims[1] + coords[:, 1]) * dims[2] + coords[:, 2]
    uniq, inv = np.unique(key, return_inverse=True)
    counts = np.bincount(inv, minlength=len(uniq)).astype(points.dtype)
    out = np.zeros((len(uniq), 3), dtype=points.dtype)
    for d in range(3):
        out[:, d] = np.bincount(inv, weights=points[:, d], minlength=len(uniq))
    return out / counts[:, None]


def grid_subsample_with_features_np(points, features, voxel_size):
    """``grid_subsample_np`` that also averages ``features`` [N, C] per voxel."""
    origin = points.min(axis=0)
    coords = np.floor((points - origin) / voxel_size).astype(np.int64)
    dims = coords.max(axis=0) + 1
    key = (coords[:, 0] * dims[1] + coords[:, 1]) * dims[2] + coords[:, 2]
    uniq, inv = np.unique(key, return_inverse=True)
    counts = np.bincount(inv, minlength=len(uniq)).astype(points.dtype)
    pts = np.zeros((len(uniq), 3), dtype=points.dtype)
    for d in range(3):
        pts[:, d] = np.bincount(inv, weights=points[:, d], minlength=len(uniq))
    feats = np.zeros((len(uniq), features.shape[1]), dtype=features.dtype)
    for d in range(features.shape[1]):
        feats[:, d] = np.bincount(inv, weights=features[:, d], minlength=len(uniq))
    return pts / counts[:, None], feats / counts[:, None]
