"""Fixed-K radius neighbors / kNN: on the device (chunked brute force) and on
the host (KD-tree).

Counterpart of the JAX package's ops/neighbors.py, with its contract: each
query row gets up to K neighbor indices within ``radius``, padded with the
sentinel index ``num_supports`` (the KPConv gather's shadow point), sorted
by distance so that index 0 is the nearest. Distances are JAX's
sum((q - s)^2), not the matmul expansion, so that the radius cut falls where
it falls there, and ties go to the lower index as in ``jax.lax.top_k``.
"""
from __future__ import annotations

import numpy as np
import torch

from .topk import stable_top_k


def squared_distances(a, b):
    """sum((a - b)^2) over the last axis (broadcast), summed x, y, z in that
    order as the JAX package reduces, so that the card and the CPU agree bit
    for bit."""
    d = a - b
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _supports(supports, s_valid):
    """Invalid supports moved far away, as the JAX package does."""
    return torch.where(s_valid[:, None], supports, torch.full_like(supports, 1.0e6))


def radius_neighbors(queries, q_valid, supports, s_valid, radius, k: int, chunk: int = 2048):
    """Fixed-K radius search, sentinel-padded, distance-sorted.

    Args:
      queries:  [Nq, 3]; q_valid [Nq] bool.
      supports: [Ns, 3]; s_valid [Ns] bool.
      radius:   search radius.
      k:        max neighbors.
      chunk:    query tile size (bounds the [chunk, Ns] distance tile).

    Returns:
      neighbors [Nq, k] int32: indices into supports, Ns where there is no
      neighbor.
    """
    ns = supports.shape[0]
    s_big = _supports(supports, s_valid)
    r = torch.as_tensor(radius, dtype=supports.dtype, device=supports.device)
    r2 = r * r                                              # rounded in f32, as in JAX
    out = []
    for start in range(0, queries.shape[0], chunk):
        d2 = squared_distances(queries[start:start + chunk, None, :], s_big[None])
        d2 = torch.where(q_valid[start:start + chunk, None], d2,
                         torch.full_like(d2, float("inf")))
        neg, idx = stable_top_k(-d2, k)
        within = (-neg) <= r2
        out.append(torch.where(within, idx, torch.full_like(idx, ns)))
    return torch.cat(out).to(torch.int32)


def knn(queries, q_valid, supports, s_valid, k: int, chunk: int = 2048):
    """k nearest neighbors (no radius cut) and their distances; invalid queries
    get the sentinel Ns (their distances are left as computed, as in JAX)."""
    ns = supports.shape[0]
    s_big = _supports(supports, s_valid)
    idxs, dists = [], []
    for start in range(0, queries.shape[0], chunk):
        d2 = squared_distances(queries[start:start + chunk, None, :], s_big[None])
        qv = q_valid[start:start + chunk, None]
        neg, idx = stable_top_k(-d2, k)
        dists.append(torch.sqrt(torch.clamp(-neg, min=0.0)))
        idxs.append(torch.where(qv, idx, torch.full_like(idx, ns)))
    return torch.cat(idxs).to(torch.int32), torch.cat(dists)


def radius_neighbors_np(queries, supports, radius, k):
    """Host KD-tree radius search, same contract (sentinel = len(supports))."""
    from scipy.spatial import cKDTree

    tree = cKDTree(supports)
    _, idx = tree.query(queries, k=k, distance_upper_bound=radius)
    if k == 1:
        idx = idx[:, None]
    # cKDTree pads missing results with index == len(supports) already
    return idx.astype(np.int32)


def knn_np(queries, supports, k):
    from scipy.spatial import cKDTree

    tree = cKDTree(supports)
    dists, idx = tree.query(queries, k=k)
    if k == 1:
        dists = dists[:, None]
        idx = idx[:, None]
    return idx.astype(np.int32), dists
