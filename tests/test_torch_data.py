"""The port's host data pipeline against the JAX package's (numpy, exact).

Both packages build pyramids with the same native C++ and numpy code from
the same seed, so every array must be identical, not merely close.
"""
import dataclasses

import numpy as np
import pytest

from diffreg_tpu.data import synthetic_batch as jax_synthetic_batch
from diffreg_tpu.data.calibrate import calibrate_spec as jax_calibrate_spec
from diffreg_tpu.data.pyramid import PyramidConfig as JaxPyramidConfig
from diffreg_tpu.data.synthetic import make_pair as jax_make_pair
from diffreg_tpu.ops.subsample import grid_subsample_np as jax_grid_subsample_np
from diffreg_tpu_torch.data.calibrate import calibrate_spec
from diffreg_tpu_torch.data.native import grid_subsample_native, radius_neighbors_native
from diffreg_tpu_torch.data.pyramid import PyramidConfig
from diffreg_tpu_torch.data.synthetic import make_pair, synthetic_batch
from diffreg_tpu_torch.ops.subsample import grid_subsample_np

FIELDS = ("points", "masks", "neighbors", "pools", "upsamples", "features",
          "src_idx_coarse", "tgt_idx_coarse", "src_mask", "tgt_mask", "rot_gt",
          "trn_gt", "gt_src", "gt_tgt", "gt_valid", "coarse_flow", "gt_cov")


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_batch_identical(seed):
    ref, ref_spec, _ = jax_synthetic_batch(batch_size=2, n_points=128, seed=seed,
                                           as_jnp=False)
    got, spec, _ = synthetic_batch(batch_size=2, n_points=128, seed=seed)
    assert dataclasses.astuple(spec) == dataclasses.astuple(ref_spec)
    for name in FIELDS:
        r, g = getattr(ref, name), getattr(got, name)
        if isinstance(r, tuple):
            assert len(r) == len(g), name
            pairs = list(zip(r, g))
        else:
            pairs = [(r, g)]
        for a, b in pairs:
            b = b.numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_calibrate_spec_identical():
    """The bench's pyramid config at a reduced cloud size (1024 points)."""
    cfg_j = JaxPyramidConfig(first_subsampling_dl=0.03, coarse_match_radius=0.1)
    cfg_p = PyramidConfig(first_subsampling_dl=0.03, coarse_match_radius=0.1)
    rng_j, rng_p = np.random.RandomState(0), np.random.RandomState(0)
    pairs_j = [jax_make_pair(rng_j, 1024)[:2] for _ in range(2)]
    pairs_p = [make_pair(rng_p, 1024)[:2] for _ in range(2)]
    for (a, b), (c, d) in zip(pairs_j, pairs_p):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    ref = jax_calibrate_spec(pairs_j, cfg_j, k_cap=40, neighbor_percentile=90.0)
    got = calibrate_spec(pairs_p, cfg_p, k_cap=40, neighbor_percentile=90.0)
    assert dataclasses.astuple(got) == dataclasses.astuple(ref)


def test_native_subsample_and_neighbors(rng):
    pts = rng.rand(500, 3).astype(np.float32)
    sub = grid_subsample_native(pts, 0.1)
    np.testing.assert_array_equal(grid_subsample_np(pts, 0.1), jax_grid_subsample_np(pts, 0.1))
    # same voxel barycenters as the numpy twin, up to ordering and f32 sums
    ref = grid_subsample_np(pts, 0.1)
    order = lambda a: a[np.lexsort(a.T)]
    np.testing.assert_allclose(order(sub), order(ref), atol=1e-5)
    nb = radius_neighbors_native(sub, pts, 0.15, 8)
    assert nb.shape == (len(sub), 8) and nb.dtype == np.int32
    d = np.linalg.norm(pts[np.minimum(nb, len(pts) - 1)] - sub[:, None], axis=-1)
    assert np.all((nb == len(pts)) | (d <= 0.15 + 1e-6))
    # nearest first
    dd = np.where(nb == len(pts), 1e9, d)
    assert np.all(np.diff(dd, axis=1) >= -1e-7)
