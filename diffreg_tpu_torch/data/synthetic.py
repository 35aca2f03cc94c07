"""Synthetic rigid registration pairs — test fixtures and the chip smoke's data.

Structured point clouds (multi-blob surfaces) under a random rigid transform
with noise and partial-overlap cropping, run through the real pyramid
construction. Same draws as the JAX package's data/synthetic.py at the same seed.
"""
from __future__ import annotations

import numpy as np

from .batch import ShapeSpec
from .pyramid import PyramidConfig, batch_from_samples, build_pair_pyramid


def make_cloud(rng: np.random.RandomState, n: int, n_blobs: int = 6, extent: float = 1.5):
    """Blobby surface-ish cloud in a box of the given extent."""
    centers = (rng.rand(n_blobs, 3) - 0.5) * extent
    assign = rng.randint(0, n_blobs, n)
    pts = centers[assign] + rng.randn(n, 3) * 0.12
    return pts.astype(np.float32)


def make_pair(rng: np.random.RandomState, n_points: int = 1024, overlap: float = 0.8,
              noise: float = 0.005, max_rot_deg: float = 45.0):
    """Returns (src, tgt, rot [3, 3], trn [3, 1]) with tgt ~ rot @ src + trn."""
    base = make_cloud(rng, n_points)
    # partial overlap: drop a directional slab from each side
    d = rng.randn(3)
    d /= np.linalg.norm(d)
    proj = base @ d
    lo, hi = np.quantile(proj, [1 - overlap, overlap])
    src = base[proj <= hi]
    tgt_base = base[proj >= lo]

    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    angle = np.deg2rad(rng.rand() * max_rot_deg)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    rot = (np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)).astype(np.float32)
    trn = (rng.randn(3, 1) * 0.3).astype(np.float32)

    tgt = (rot @ tgt_base.T + trn).T + rng.randn(len(tgt_base), 3) * noise
    return src.astype(np.float32), tgt.astype(np.float32), rot, trn


def tiny_spec(n0: int = 256, levels: int = 4) -> ShapeSpec:
    """A small ShapeSpec for tests: generous uniform capacity per level."""
    cap = 2 * n0
    return ShapeSpec(
        n_points=(cap,) * levels,
        k_neighbors=(16,) * levels,
        k_pools=(16,) * (levels - 1),
        k_upsamples=(4,) * (levels - 1),
        n_src=n0,
        n_tgt=n0,
        n_gt_matches=n0 // 2,
    )


def synthetic_batch(batch_size: int = 2, n_points: int = 256, seed: int = 0,
                    spec: ShapeSpec | None = None, cfg: PyramidConfig | None = None):
    """(PairBatch of CPU tensors, spec, cfg) for ``batch_size`` random pairs."""
    rng = np.random.RandomState(seed)
    cfg = cfg or PyramidConfig(first_subsampling_dl=0.06, coarse_match_radius=0.15)
    spec = spec or tiny_spec(n_points)
    samples = []
    for _ in range(batch_size):
        src, tgt, rot, trn = make_pair(rng, n_points)
        samples.append(build_pair_pyramid(src, tgt, rot, trn, cfg, spec))
    return batch_from_samples(samples), spec, cfg
