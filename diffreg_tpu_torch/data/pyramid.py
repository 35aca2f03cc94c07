"""Graph pyramid construction (host, numpy) with bucketed static padding.

Per pair: per-level points, fixed-K radius neighbor tables, pooling and
upsample tables, and the coarse-level split and GT structures, all padded to
a ``ShapeSpec``. The same contract as the JAX package's data/pyramid.py:

  * src and tgt clouds are subsampled and radius-searched independently, then
    packed [src ++ tgt ++ padding] per level; neighbor indices of the tgt
    half are offset by the packed src length; missing neighbors use the
    static sentinel ``spec.n_points[level]``;
  * pooling at layer l subsamples at cell 2 * dl * 2^l and searches with the
    layer radius; upsample tables use radius 2r;
  * neighbor lists are sorted nearest first, so closest-pool reads column 0.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .batch import PairBatch, ShapeSpec, pad_to, stack_pairs
from .native import grid_subsample_native, radius_neighbors_native


@dataclasses.dataclass(frozen=True)
class PyramidConfig:
    num_levels: int = 4
    first_subsampling_dl: float = 0.025
    conv_radius: float = 2.5
    coarse_level: int = -2
    coarse_match_radius: float = 0.06


def _mutual_nn_with_radius(src: np.ndarray, tgt: np.ndarray, radius: float):
    """Mutual nearest-neighbor correspondences within ``radius`` ([2, M])."""
    if len(src) == 0 or len(tgt) == 0:
        return np.zeros((2, 0), np.int64)
    from scipy.spatial import cKDTree

    d_st, nn_st = cKDTree(tgt).query(src, k=1)
    _, nn_ts = cKDTree(src).query(tgt, k=1)
    src_idx = np.arange(len(src))
    ok = (nn_ts[nn_st] == src_idx) & (d_st <= radius)
    return np.stack([src_idx[ok], nn_st[ok]], axis=0)


def build_pair_pyramid(
    src_pcd: np.ndarray,
    tgt_pcd: np.ndarray,
    rot: np.ndarray,
    trn: np.ndarray,
    cfg: PyramidConfig,
    spec: ShapeSpec,
    scene_flow: Optional[np.ndarray] = None,
    gt_cov: Optional[np.ndarray] = None,
) -> dict:
    """Build one pair's padded pyramid sample (dict of numpy arrays).
    ``scene_flow`` [N_src, 3] (4DMatch) deforms the source before the GT pose:
    each coarse source point takes the flow of its nearest raw source point
    (``coarse_flow``), and the GT matches are found after that deformation.
    ``gt_cov`` [6, 6] is the pair's registration-recall covariance."""
    dtype = np.float32
    src_pcd = src_pcd.astype(dtype)
    tgt_pcd = tgt_pcd.astype(dtype)

    # ---- per-level clouds (src/tgt subsampled independently) ----
    src_levels: List[np.ndarray] = [src_pcd]
    tgt_levels: List[np.ndarray] = [tgt_pcd]
    r_normal = cfg.first_subsampling_dl * cfg.conv_radius
    radii = []
    for _ in range(cfg.num_levels - 1):
        radii.append(r_normal)
        dl = 2.0 * r_normal / cfg.conv_radius
        src_levels.append(grid_subsample_native(src_levels[-1], dl).astype(dtype))
        tgt_levels.append(grid_subsample_native(tgt_levels[-1], dl).astype(dtype))
        r_normal *= 2.0
    radii.append(r_normal)

    points, masks, neighbors, pools, upsamples = [], [], [], [], []
    n_src = [len(s) for s in src_levels]
    n_tgt = [len(t) for t in tgt_levels]

    def packed_neighbors(q_src, q_tgt, s_src, s_tgt, radius, k, support_pad, query_pad):
        """Radius neighbors respecting the src/tgt boundary, packed; the
        sentinel for missing neighbors and padded queries is ``support_pad``."""
        ns = len(s_src)
        idx_s = (radius_neighbors_native(q_src, s_src, radius, k) if len(q_src)
                 else np.zeros((0, k), np.int32))
        idx_t = (radius_neighbors_native(q_tgt, s_tgt, radius, k) if len(q_tgt)
                 else np.zeros((0, k), np.int32))
        idx_s = np.where(idx_s >= len(s_src), support_pad, idx_s)
        idx_t = np.where(idx_t >= len(s_tgt), support_pad, idx_t + ns)
        out = np.concatenate([idx_s, idx_t], axis=0).astype(np.int32)
        return pad_to(out, query_pad, axis=0, fill=support_pad)

    for level in range(cfg.num_levels):
        pts = np.concatenate([src_levels[level], tgt_levels[level]], axis=0)
        n_real = len(pts)
        if n_real > spec.n_points[level]:
            raise ValueError(
                f"bucket too small at level {level}: {n_real} > {spec.n_points[level]}")
        points.append(pad_to(pts, spec.n_points[level], axis=0))
        masks.append(np.arange(spec.n_points[level]) < n_real)
        neighbors.append(packed_neighbors(
            src_levels[level], tgt_levels[level], src_levels[level], tgt_levels[level],
            radii[level], spec.k_neighbors[level], spec.n_points[level],
            spec.n_points[level]))
        if level < cfg.num_levels - 1:
            pools.append(packed_neighbors(
                src_levels[level + 1], tgt_levels[level + 1],
                src_levels[level], tgt_levels[level],
                radii[level], spec.k_pools[level],
                spec.n_points[level], spec.n_points[level + 1]))
            upsamples.append(packed_neighbors(
                src_levels[level], tgt_levels[level],
                src_levels[level + 1], tgt_levels[level + 1],
                2.0 * radii[level], spec.k_upsamples[level],
                spec.n_points[level + 1], spec.n_points[level]))

    # features: ones, like the reference in_feats_dim=1
    feats = np.concatenate([np.ones((n_src[0], 1), dtype), np.ones((n_tgt[0], 1), dtype)])
    feats = pad_to(feats, spec.n_points[0], axis=0)

    # ---- coarse split indices ----
    cl = cfg.coarse_level % cfg.num_levels
    nc_pad = spec.n_points[cl]
    ns_c, nt_c = n_src[cl], n_tgt[cl]
    if ns_c > spec.n_src or nt_c > spec.n_tgt:
        raise ValueError(f"coarse bucket too small: {ns_c}x{nt_c} vs {spec.n_src}x{spec.n_tgt}")
    src_idx = np.full(spec.n_src, nc_pad, np.int32)
    src_idx[:ns_c] = np.arange(ns_c)
    tgt_idx = np.full(spec.n_tgt, nc_pad, np.int32)
    tgt_idx[:nt_c] = np.arange(nt_c) + ns_c

    # ---- GT coarse matches ----
    c_src, c_tgt = src_levels[cl], tgt_levels[cl]
    if scene_flow is not None:
        from scipy.spatial import cKDTree

        _, nn = cKDTree(src_pcd).query(c_src, k=1)
        c_src_deformed = c_src + scene_flow[nn].astype(dtype)
        coarse_flow = c_src_deformed - c_src
    else:
        c_src_deformed = c_src
        coarse_flow = np.zeros_like(c_src)
    c_src_warped = (rot @ c_src_deformed.T + trn.reshape(3, 1)).T
    matches = _mutual_nn_with_radius(c_src_warped, c_tgt, cfg.coarse_match_radius)
    g = spec.n_gt_matches
    n_m = min(matches.shape[1], g)
    gt_src = np.zeros(g, np.int32)
    gt_tgt = np.zeros(g, np.int32)
    gt_valid = np.zeros(g, bool)
    gt_src[:n_m] = matches[0, :n_m]
    gt_tgt[:n_m] = matches[1, :n_m]
    gt_valid[:n_m] = True

    return {
        "points": tuple(p.astype(dtype) for p in points),
        "masks": tuple(masks),
        "neighbors": tuple(neighbors),
        "pools": tuple(pools),
        "upsamples": tuple(upsamples),
        "features": feats,
        "src_idx_coarse": src_idx,
        "tgt_idx_coarse": tgt_idx,
        "src_mask": np.arange(spec.n_src) < ns_c,
        "tgt_mask": np.arange(spec.n_tgt) < nt_c,
        "rot_gt": rot.astype(dtype),
        "trn_gt": trn.reshape(3, 1).astype(dtype),
        "gt_src": gt_src,
        "gt_tgt": gt_tgt,
        "gt_valid": gt_valid,
        "coarse_flow": pad_to(coarse_flow.astype(dtype), spec.n_src, axis=0),
        "gt_cov": np.zeros((6, 6), dtype) if gt_cov is None else gt_cov.astype(dtype),
    }


def batch_from_samples(samples) -> PairBatch:
    """Stack per-pair samples into a PairBatch of CPU tensors."""
    return PairBatch.from_numpy(stack_pairs(list(samples)))
