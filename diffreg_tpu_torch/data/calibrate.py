"""Shape calibration: turn sample pairs into a static ShapeSpec (and sample
clouds into a 2D-3D ``Spec2D3D``).

The reference's ``calibrate_neighbors`` statistic (a percentile of the
neighborhood sizes, capped) decides the static K per level; the padded point
counts per level and the coarse src/tgt token counts come from the largest
sample times a headroom, rounded up.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from ..ops.subsample import grid_subsample_np
from .batch import ShapeSpec
from .pyramid import PyramidConfig


def _round_up(x: int, mult: int) -> int:
    return int(math.ceil(max(x, 1) / mult) * mult)


def calibrate_spec(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    cfg: PyramidConfig,
    neighbor_percentile: float = 90.0,
    headroom: float = 1.3,
    round_points: int = 256,
    round_tokens: int = 64,
    k_cap: int = 64,
    max_query_sample: int = 2000,
) -> ShapeSpec:
    """Measure level sizes and neighborhood statistics over sample pairs."""
    from scipy.spatial import cKDTree

    L = cfg.num_levels
    level_sizes = np.zeros((len(pairs), L), np.int64)
    src_sizes = np.zeros(len(pairs), np.int64)
    tgt_sizes = np.zeros(len(pairs), np.int64)
    neigh_counts: List[List[int]] = [[] for _ in range(L)]
    pool_counts: List[List[int]] = [[] for _ in range(L - 1)]
    up_counts: List[List[int]] = [[] for _ in range(L - 1)]
    cl = cfg.coarse_level % L

    def sample(cloud):
        return cloud[np.random.RandomState(0).permutation(len(cloud))[:max_query_sample]]

    for pi, (src, tgt) in enumerate(pairs):
        src_l, tgt_l = [src], [tgt]
        r = cfg.first_subsampling_dl * cfg.conv_radius
        radii = []
        for _ in range(L - 1):
            radii.append(r)
            dl = 2 * r / cfg.conv_radius
            src_l.append(grid_subsample_np(src_l[-1], dl))
            tgt_l.append(grid_subsample_np(tgt_l[-1], dl))
            r *= 2
        radii.append(r)

        for l in range(L):
            level_sizes[pi, l] = len(src_l[l]) + len(tgt_l[l])
            for cloud in (src_l[l], tgt_l[l]):
                neigh_counts[l].extend(map(len, cKDTree(cloud).query_ball_point(
                    sample(cloud), radii[l])))
            if l < L - 1:
                for qc, sc in ((src_l[l + 1], src_l[l]), (tgt_l[l + 1], tgt_l[l])):
                    pool_counts[l].extend(map(len, cKDTree(sc).query_ball_point(
                        sample(qc), radii[l])))
                for qc, sc in ((src_l[l], src_l[l + 1]), (tgt_l[l], tgt_l[l + 1])):
                    up_counts[l].extend(map(len, cKDTree(sc).query_ball_point(
                        sample(qc), 2 * radii[l])))
        src_sizes[pi] = len(src_l[cl])
        tgt_sizes[pi] = len(tgt_l[cl])

    def pct(counts):
        return int(np.clip(np.percentile(counts, neighbor_percentile), 1, k_cap))

    n_src = _round_up(int(src_sizes.max() * headroom), round_tokens)
    n_tgt = _round_up(int(tgt_sizes.max() * headroom), round_tokens)
    return ShapeSpec(
        n_points=tuple(_round_up(int(level_sizes[:, l].max() * headroom), round_points)
                       for l in range(L)),
        k_neighbors=tuple(pct(neigh_counts[l]) for l in range(L)),
        k_pools=tuple(pct(pool_counts[l]) for l in range(L - 1)),
        k_upsamples=tuple(min(pct(up_counts[l]), 8) for l in range(L - 1)),
        n_src=n_src,
        n_tgt=n_tgt,
        n_gt_matches=max(64, min(n_src, n_tgt)),
    )


def calibrate_spec_2d3d(clouds: Sequence[np.ndarray], *, init_radius: float = 0.0625,
                        neighbor_percentile: float = 90.0, headroom: float = 1.3,
                        round_points: int = 256, k_cap: int = 64,
                        max_query_sample: int = 2000, **spec_overrides):
    """The 2D-3D twin of ``calibrate_spec``: the 3-level cloud pyramid of raw
    level-0 clouds -> ``Spec2D3D`` (padded level sizes, the neighbourhood
    percentile K per level). The image side needs none: its token count is
    fixed by the crop."""
    from scipy.spatial import cKDTree

    from .collate2d3d import Spec2D3D

    L = 3
    level_sizes = np.zeros((len(clouds), L), np.int64)
    neigh_counts: List[List[int]] = [[] for _ in range(L)]
    pool_counts: List[List[int]] = [[] for _ in range(L - 1)]
    up_counts: List[List[int]] = [[] for _ in range(L - 1)]

    def sample(cloud):
        return cloud[np.random.RandomState(0).permutation(len(cloud))[:max_query_sample]]

    for pi, cloud in enumerate(clouds):
        levels = [np.asarray(cloud, np.float32)]
        r = init_radius
        radii = [r]
        for _ in range(L - 1):
            levels.append(grid_subsample_np(levels[-1], 2 * r / 2.5))
            r *= 2
            radii.append(r)
        for l in range(L):
            level_sizes[pi, l] = len(levels[l])
            neigh_counts[l].extend(map(len, cKDTree(levels[l]).query_ball_point(
                sample(levels[l]), radii[l])))
            if l < L - 1:
                pool_counts[l].extend(map(len, cKDTree(levels[l]).query_ball_point(
                    sample(levels[l + 1]), radii[l])))
                up_counts[l].extend(map(len, cKDTree(levels[l + 1]).query_ball_point(
                    sample(levels[l]), 2 * radii[l])))

    def pct(counts):
        return int(np.clip(np.percentile(counts, neighbor_percentile), 1, k_cap))

    return Spec2D3D(
        n_points=tuple(_round_up(int(level_sizes[:, l].max() * headroom), round_points)
                       for l in range(L)),
        k_neighbors=tuple(pct(neigh_counts[l]) for l in range(L)),
        k_pools=tuple(pct(pool_counts[l]) for l in range(L - 1)),
        k_upsamples=tuple(min(pct(up_counts[l]), 8) for l in range(L - 1)),
        init_radius=init_radius,
        **spec_overrides,
    )
