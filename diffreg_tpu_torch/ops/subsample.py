"""Voxel-grid barycenter subsampling on the host (numpy)."""
from __future__ import annotations

import numpy as np


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
