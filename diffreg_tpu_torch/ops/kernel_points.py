"""Kernel point dispositions for KPConv.

A deterministic repulsive-potential relaxation in the unit ball, identical
to the JAX package's ops/kernel_points.py (same seed, same iterations), so
both packages build the same dispositions:

  * ``fixed='center'``: point 0 pinned at the origin;
  * non-center points rescaled so their mean distance to center is
    ``ratio`` (0.66, the KPConv default);
  * the caller scales the unit disposition by the layer radius.
"""
from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def unit_kernel_points(num_points: int = 15, dimension: int = 3, fixed: str = "center",
                       ratio: float = 0.66, seed: int = 42) -> np.ndarray:
    """Deterministic unit-scale kernel disposition [num_points, dimension]."""
    rng = np.random.RandomState(seed)

    # init: uniform in the unit ball (rejection sampling)
    pts = np.zeros((0, dimension))
    while pts.shape[0] < num_points:
        cand = rng.rand(4 * num_points, dimension) * 2.0 - 1.0
        cand = cand[np.sum(cand**2, axis=1) < 1.0]
        pts = np.vstack([pts, cand])
    pts = pts[:num_points]

    fixed_rows = 0
    if fixed == "center":
        pts[0] = 0.0
        fixed_rows = 1
    elif fixed == "verticals":
        pts[:3] = 0.0
        pts[1, -1] = 2.0 / 3.0
        pts[2, -1] = -2.0 / 3.0
        fixed_rows = 3

    # Repulsive relaxation: each pair repels with 1/r^2 force; points are kept
    # inside the unit ball by radial projection. Small step with decay.
    step = 0.01
    for _ in range(2000):
        diff = pts[:, None, :] - pts[None, :, :]                 # [K, K, D]
        d = np.sqrt(np.sum(diff**2, axis=-1)) + 1e-9
        force = diff / (d**3)[..., None]
        np.einsum("iid->id", force)[...] = 0.0
        grad = force.sum(axis=1)
        # cap gradient norm for stability
        gn = np.linalg.norm(grad, axis=1, keepdims=True)
        grad = grad / np.maximum(gn, 1.0) * np.minimum(gn, 10.0)
        pts = pts + step * grad
        r = np.linalg.norm(pts, axis=1, keepdims=True)
        pts = np.where(r > 1.0, pts / r, pts)
        if fixed == "center":
            pts[0] = 0.0
        elif fixed == "verticals":
            pts[:3, :-1] = 0.0
            pts[1, -1] = max(pts[1, -1], 1e-3)
            pts[2, -1] = min(pts[2, -1], -1e-3)
        step *= 0.999

    # rescale mean non-fixed-center radius to `ratio`
    r = np.linalg.norm(pts, axis=1)
    denom = np.mean(r[fixed_rows:]) if fixed_rows else np.mean(r)
    pts = pts * (ratio / denom)
    if fixed == "center":
        pts[0] = 0.0
    return pts.astype(np.float32)


def load_kernel_points(radius: float, num_points: int = 15, dimension: int = 3,
                       fixed: str = "center") -> np.ndarray:
    """Disposition scaled to the given layer radius."""
    return unit_kernel_points(num_points, dimension, fixed) * np.float32(radius)
