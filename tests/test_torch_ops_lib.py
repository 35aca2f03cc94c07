"""The port's library ops against the JAX package's, on the CPU: point features,
sampling, neighbours, consistency, batch/pack conversion, rendering.

Inputs are made with numpy from a seed and fed to both packages. Limits:
integer outputs (indices, masks) identical, on clouds with duplicate points
and grid-spaced coordinates, so that distances tie and the lower index must
win; float outputs within 1e-6 of the largest entry of JAX's result
(``assert_rel``). Random draws are JAX's own, replayed through
``torch_jax_draws.JaxDraws``.
"""
import torch_native_guard  # noqa: F401  (makes the JAX native library whole first)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffreg_tpu.ops import consistency as jax_consistency
from diffreg_tpu.ops import conversion as jax_conversion
from diffreg_tpu.ops import features as jax_features
from diffreg_tpu.ops import neighbors as jax_neighbors
from diffreg_tpu.ops import render as jax_render
from diffreg_tpu.ops import sampling as jax_sampling
from diffreg_tpu_torch.ops import consistency, conversion, features, neighbors, render, sampling
from torch_jax_draws import JaxDraws

T = torch.from_numpy
REL = 1e-6


def assert_rel(got, ref, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - ref.astype(np.float64)).max())
    assert err <= rel * scale, (err, scale)


def assert_same(got, ref):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def _unit(rng, shape):
    v = rng.randn(*shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _grid_cloud(rng, n, n_dup):
    """Points on a 0.25 grid (distances tie exactly) with duplicated rows."""
    pts = (rng.randint(0, 8, (n, 3)) * 0.25).astype(np.float32)
    pts[rng.choice(n, n_dup, replace=False)] = pts[rng.choice(n, n_dup, replace=False)]
    return pts


# ---------------------------------------------------------------- features


@pytest.mark.parametrize("use_degree", [False, True])
def test_vector_angle(use_degree):
    rng = np.random.RandomState(0)
    x, y = rng.randn(2, 6, 40, 3).astype(np.float32)
    y[0, :5] = x[0, :5]                      # parallel pairs: angle 0
    y[1, :5] = -x[1, :5]                     # antiparallel pairs: angle pi
    ref = jax_features.vector_angle(jnp.asarray(x), jnp.asarray(y), use_degree)
    assert_rel(features.vector_angle(T(x), T(y), use_degree), ref)


@pytest.mark.parametrize("flags", [(False, False, False), (True, True, True)])
def test_local_ppf(flags):
    rng = np.random.RandomState(1)
    b, n, m, k = 2, 24, 30, 6
    q, s = rng.randn(b, n, 3).astype(np.float32), rng.randn(b, m, 3).astype(np.float32)
    qn, sn = _unit(rng, (b, n, 3)), _unit(rng, (b, m, 3))
    idx = rng.randint(0, m, (b, n, k))
    ref = jax_features.local_ppf(*map(jnp.asarray, (q, s, qn, sn, idx)), *flags)
    assert_rel(features.local_ppf(T(q), T(s), T(qn), T(sn), T(idx), *flags), ref)


def test_global_ppf():
    rng = np.random.RandomState(2)
    p, nrm = rng.randn(2, 20, 3).astype(np.float32), _unit(rng, (2, 20, 3))
    ref = jax_features.global_ppf(jnp.asarray(p), jnp.asarray(nrm), True)
    assert_rel(features.global_ppf(T(p), T(nrm), True), ref)


def test_build_local_reference_frame():
    rng = np.random.RandomState(3)
    p, nrm = rng.randn(2, 64, 3).astype(np.float32), _unit(rng, (2, 64, 3))
    ref = jax_features.build_local_reference_frame(jnp.asarray(p), jnp.asarray(nrm), 9, True)
    got = features.build_local_reference_frame(T(p), T(nrm), 9, True)
    for g, r in zip(got, ref):
        assert_rel(g, r)


@pytest.mark.parametrize("disambiguate", [True, False])
def test_estimate_normals(disambiguate):
    """With ``disambiguate_directions`` both packages orient each normal; without,
    the eigenvector's sign is arbitrary and the normals are compared up to it."""
    rng = np.random.RandomState(4)
    q, s = rng.randn(50, 3).astype(np.float32), rng.randn(200, 3).astype(np.float32)
    s[:, 2] *= 0.1                                         # a flattened cloud
    ref = np.asarray(jax_features.estimate_normals(jnp.asarray(q), jnp.asarray(s), 16,
                                                   disambiguate))
    got = features.estimate_normals(T(q), T(s), 16, disambiguate).numpy()
    if not disambiguate:
        got = got * np.sign(np.sum(got * ref, axis=-1, keepdims=True))
    assert_rel(got, ref)


def test_safe_divide_and_sqrt():
    a = np.array([1.0, -2.0, 0.0, 3e-7], np.float32)
    b = np.array([2.0, 0.0, -1.0, 1e-7], np.float32)
    assert_rel(features.safe_divide(T(a), T(b)), jax_features.safe_divide(a, b))
    assert_rel(features.safe_sqrt(T(a)), jax_features.safe_sqrt(a))
    assert_rel(features.rad2deg(features.deg2rad(T(a))), a)


# ---------------------------------------------------------------- sampling


@pytest.mark.parametrize("n_valid,num_samples", [(150, 64), (20, 32)])
def test_farthest_point_sampling(n_valid, num_samples):
    """Indices identical; past the number of valid points the first index
    repeats; invalid points are never picked."""
    rng = np.random.RandomState(5)
    pts = _grid_cloud(rng, 200, 40)
    valid = np.zeros(200, bool)
    valid[rng.choice(200, n_valid, replace=False)] = True
    ref_idx, ref_mask = jax_sampling.farthest_point_sampling(jnp.asarray(pts),
                                                             jnp.asarray(valid), num_samples)
    idx, mask = sampling.farthest_point_sampling(T(pts), T(valid), num_samples)
    assert idx.dtype == torch.int32
    assert_same(idx, ref_idx)
    assert_same(mask, ref_mask)
    assert valid[idx.numpy()].all()


@pytest.mark.parametrize("with_valid", [False, True])
def test_random_choice(with_valid):
    key = jax.random.PRNGKey(6)
    valid = np.random.RandomState(6).rand(50) > 0.4
    ref = jax_sampling.random_choice(key, 50, 30, jnp.asarray(valid) if with_valid else None)
    got = sampling.random_choice(JaxDraws(key), 50, 30, T(valid) if with_valid else None)
    assert_same(got, ref)
    gen = torch.Generator().manual_seed(0)
    own = sampling.random_choice(gen, 50, 30, T(valid) if with_valid else None)
    assert own.shape == (30,) and (not with_valid or valid[own.numpy()].all())


# ---------------------------------------------------------------- neighbours


@pytest.mark.parametrize("k", [1, 7, 64])
def test_stable_top_k_matches_lax_top_k(k):
    """The searches' top-k picks what jax.lax.top_k picks (ties to the lower
    index), on rows of small integers (many ties) and of -inf: identical."""
    from diffreg_tpu_torch.ops.topk import stable_top_k

    x = np.random.RandomState(k).randint(0, 5, (40, 300)).astype(np.float32)
    x[0] = -np.inf
    x[1, :k + 3] = -np.inf
    ref = jax.lax.top_k(jnp.asarray(x), k)
    for got, want in zip(stable_top_k(torch.from_numpy(x), k), ref):
        assert_same(got, want)


@pytest.fixture(scope="module")
def neighbour_case():
    """Grid clouds with duplicates, padded; the radius falls on grid distances
    (0.5 = 2 grid steps), so neighbours sit exactly on the cut. One JAX compile
    of each search."""
    rng = np.random.RandomState(7)
    q, s = _grid_cloud(rng, 90, 20), _grid_cloud(rng, 120, 30)
    qv, sv = rng.rand(90) > 0.1, rng.rand(120) > 0.1
    args = (q, qv, s, sv)
    ref_r = jax_neighbors.radius_neighbors(*map(jnp.asarray, args), 0.5, 12, chunk=32)
    ref_k = jax_neighbors.knn(*map(jnp.asarray, args), 10, chunk=32)
    return args, ref_r, ref_k


def test_radius_neighbors(neighbour_case):
    (q, qv, s, sv), ref, _ = neighbour_case
    got = neighbors.radius_neighbors(T(q), T(qv), T(s), T(sv), 0.5, 12, chunk=32)
    assert got.dtype == torch.int32
    assert_same(got, ref)
    assert (got.numpy() == len(s)).any() and (got.numpy() < len(s)).any()


def test_knn(neighbour_case):
    (q, qv, s, sv), _, (ref_idx, ref_dist) = neighbour_case
    idx, dist = neighbors.knn(T(q), T(qv), T(s), T(sv), 10, chunk=32)
    assert_same(idx, ref_idx)
    assert_rel(dist, ref_dist)


def test_host_twins(neighbour_case):
    (q, _, s, _), _, _ = neighbour_case
    assert_same(neighbors.radius_neighbors_np(q, s, 0.6, 5),
                jax_neighbors.radius_neighbors_np(q, s, 0.6, 5))
    for got, ref in zip(neighbors.knn_np(q, s, 1), jax_neighbors.knn_np(q, s, 1)):
        assert_same(got, ref)


# ---------------------------------------------------------------- consistency


# the distances are JAX's a^2 - 2ab + b^2 expansion, whose matmul each package
# sums in its own order: a few ulps of |p|^2 there come out as up to 1.6e-6 of
# the consistency (seeds 0-7) after the square root and the difference of two
# distances
SC_REL = 1e-5


def test_consistency_and_leading_eigenvector():
    rng = np.random.RandomState(8)
    src = rng.randn(2, 60, 3).astype(np.float32)
    tgt = src + 0.05 * rng.randn(2, 60, 3).astype(np.float32)
    tgt[:, :15] = rng.randn(2, 15, 3)                      # outliers
    sc_ref = jax_consistency.spatial_consistency(jnp.asarray(src), jnp.asarray(tgt), 0.3)
    sc = consistency.spatial_consistency(T(src), T(tgt), 0.3)
    assert_rel(sc, sc_ref, SC_REL)
    cross_ref = jax_consistency.cross_spatial_consistency(
        *map(jnp.asarray, (src[:, :20], tgt[:, :20], src, tgt)), 0.3)
    assert_rel(consistency.cross_spatial_consistency(T(src[:, :20]), T(tgt[:, :20]), T(src),
                                                     T(tgt), 0.3), cross_ref, SC_REL)
    # on the same matrix the power iteration agrees at the elementwise limit
    assert_rel(consistency.leading_eigenvector(T(np.array(sc_ref))),
               jax_consistency.leading_eigenvector(sc_ref))


# ---------------------------------------------------------------- conversion


@pytest.mark.parametrize("capacity", [None, 40])
def test_batch_pack_round_trip(capacity):
    rng = np.random.RandomState(9)
    x = rng.randn(3, 20, 5).astype(np.float32)
    masks = rng.rand(3, 20) > 0.4
    ref = jax_conversion.batch_to_pack(jnp.asarray(x), jnp.asarray(masks), capacity)
    got = conversion.batch_to_pack(T(x), T(masks), capacity)
    for g, r in zip(got, ref):
        assert_same(g, r)
    back_ref = jax_conversion.pack_to_batch(ref[0], ref[1], 20, -1.0)
    back = conversion.pack_to_batch(got[0], got[1], 20, -1.0)
    for g, r in zip(back, back_ref):
        assert_same(g, r)
    unmasked = conversion.batch_to_pack(T(x))
    assert_same(unmasked[0], x.reshape(-1, 5))


# ---------------------------------------------------------------- render


@pytest.mark.parametrize("deterministic", [True, False])
def test_sample_pdf(deterministic):
    rng = np.random.RandomState(10)
    z = np.sort(rng.rand(30, 17).astype(np.float32), axis=-1)
    w = rng.rand(30, 16).astype(np.float32)
    w[:4] = 0.0                                            # flat rows: the eps floor
    key = jax.random.PRNGKey(10)
    ref = jax_render.sample_pdf(key, jnp.asarray(z), jnp.asarray(w), 24, deterministic)
    assert_rel(render.sample_pdf(JaxDraws(key), T(z), T(w), 24, deterministic), ref)


@pytest.mark.parametrize("case", ["colors", "white_noise", "depths", "opacity"])
def test_volume_render(case):
    rng = np.random.RandomState(11)
    d = rng.randn(25, 3).astype(np.float32)
    z = np.sort(rng.rand(25, 12).astype(np.float32) * 4, axis=-1)
    sig = rng.randn(25, 12).astype(np.float32) * 2
    col = rng.rand(25, 12, 3).astype(np.float32)
    key = jax.random.PRNGKey(11)
    kw = dict(colors=dict(point_colors=col), depths={}, opacity=dict(opacity_only=True),
              white_noise=dict(point_colors=col, white_background=True, sigma_noise=0.5))[case]
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tkw = {k: T(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    ref = jax_render.volume_render(jnp.asarray(d), jnp.asarray(z), jnp.asarray(sig), rng=key,
                                   **jkw)
    got = render.volume_render(T(d), T(z), T(sig), rng=JaxDraws(key), **tkw)
    for g, r in zip(*((got, ref) if isinstance(ref, tuple) else ((got,), (ref,)))):
        assert_rel(g, r)
