"""The port's ops (plain PyTorch versions) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. Unless a
test says otherwise the tolerance is f32 round-off of a short reduction
(atol/rtol 1e-5): the two packages sum in different orders.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffreg_tpu.geometry.procrustes import soft_procrustes as jax_soft_procrustes
from diffreg_tpu.eval.ransac import ransac_pose as jax_ransac_pose
from diffreg_tpu.ops.kernel_points import load_kernel_points as jax_load_kernel_points
from diffreg_tpu.ops.masked import masked_instance_norm as jax_masked_instance_norm
from diffreg_tpu.ops.pallas.attention_kernel import masked_attention_pallas
from diffreg_tpu.ops.pallas.kpconv_kernel import _xla_post_gather
from diffreg_tpu.ops.position_encoding import embed_rotary as jax_embed_rotary
from diffreg_tpu.ops.position_encoding import volumetric_pe as jax_volumetric_pe
from diffreg_tpu.ops.select import extract_correspondences as jax_extract
from diffreg_tpu.ops.select import mutual_topk_mask as jax_mutual_topk_mask
from diffreg_tpu.ops.select import thresholded_mutual_argmax_mask as jax_argmax_mask
from diffreg_tpu.ops.sinkhorn import log_sinkhorn as jax_log_sinkhorn
from diffreg_tpu_torch.eval.ransac import ransac_pose
from diffreg_tpu_torch.geometry.procrustes import soft_procrustes
from diffreg_tpu_torch.ops.attention import (masked_attention, masked_attention_cuda,
                                             masked_attention_plain)
from diffreg_tpu_torch.ops.kernel_points import load_kernel_points
from diffreg_tpu_torch.ops.kpconv import (closest_pool, kpconv, kpconv_batched, kpconv_cuda,
                                          max_pool)
from diffreg_tpu_torch.ops.masked import masked_instance_norm
from diffreg_tpu_torch.ops.position_encoding import embed_rotary, volumetric_pe
from diffreg_tpu_torch.ops.select import (extract_correspondences, mutual_topk_mask,
                                          thresholded_mutual_argmax_mask)
from diffreg_tpu_torch.ops.sinkhorn import log_sinkhorn

T = torch.from_numpy
# the JAX package's ops/__init__ re-exports a function named kpconv
jax_kpconv = importlib.import_module("diffreg_tpu.ops.kpconv")


@pytest.mark.parametrize("radius", [0.0625, 0.15, 1.2])
def test_kernel_points_identical(radius):
    np.testing.assert_array_equal(load_kernel_points(radius), jax_load_kernel_points(radius))


def test_masked_instance_norm(rng):
    x = rng.randn(2, 40, 8).astype(np.float32)
    mask = rng.rand(2, 40) > 0.3
    ref = jax_masked_instance_norm(jnp.asarray(x), jnp.asarray(mask))
    got = masked_instance_norm(T(x), T(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert np.all(got.numpy()[~mask] == 0.0)


def _kpconv_inputs(seed, b=2, nq=48, ns=64, k=12, cin=8, cout=16):
    rng = np.random.RandomState(seed)
    s = rng.rand(b, ns, 3).astype(np.float32) * 0.3
    q = s[:, :nq] + rng.randn(b, nq, 3).astype(np.float32) * 0.01
    idx = rng.randint(0, ns, (b, nq, k)).astype(np.int32)
    idx[rng.rand(b, nq, k) < 0.3] = ns                     # sentinel shadow rows
    idx[:, -4:] = ns                                        # padded queries
    x = rng.randn(b, ns, cin).astype(np.float32)
    x[:, -5:] = 0.0                                         # padded support rows
    kp = load_kernel_points(0.1)
    w = (rng.randn(15, cin, cout) * 0.1).astype(np.float32)
    return q, s, idx, x, kp, w


@pytest.mark.parametrize("cin,cout", [(1, 8), (8, 16)])
def test_kpconv_plain_matches_jax(cin, cout):
    q, s, idx, x, kp, w = _kpconv_inputs(0, cin=cin, cout=cout)
    extent = 0.08
    ref = jax_kpconv.kpconv_batched(*map(jnp.asarray, (q, s, idx, x, kp, w)), extent,
                                    use_pallas=False)
    got = kpconv(*map(T, (q, s, idx, x, kp, w)), extent)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert np.all(got.numpy()[:, -4:] == 0.0)


def test_kpconv_plain_matches_xla_post_gather():
    """The Pallas kernel's XLA twin (the kernel itself needs a TPU) reads the
    K-major gathered rows [B, K, N, 3+C] with the shadow row at 1e6."""
    q, s, idx, x, kp, w = _kpconv_inputs(1, nq=64)
    b = x.shape[0]
    table = np.concatenate([
        np.concatenate([s, np.full((b, 1, 3), 1e6, np.float32)], axis=1),
        np.concatenate([x, np.zeros((b, 1, x.shape[-1]), np.float32)], axis=1)], axis=-1)
    gathered = np.stack([table[i][idx[i].T] for i in range(b)])   # [B, K, N, 3+C]
    ref = _xla_post_gather(jnp.asarray(gathered), jnp.asarray(q), jnp.asarray(kp),
                           jnp.asarray(w), 0.08)
    got = kpconv(*map(T, (q, s, idx, x, kp, w)), 0.08)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_cpu_wrappers_run_plain_versions():
    """A CPU tensor takes the plain version and launches no kernel."""
    q, s, idx, x, kp, w = map(T, _kpconv_inputs(2))
    before = kpconv_cuda.launches
    torch.testing.assert_close(kpconv_batched(q, s, idx, x, kp, w, 0.08),
                               kpconv(q, s, idx, x, kp, w, 0.08), rtol=0, atol=0)
    assert kpconv_cuda.launches == before
    qa, ka, va = (torch.randn(1, 2, 5, 4) for _ in range(3))
    m = torch.tensor([[True, True, False, True, False]])
    before = masked_attention_cuda.launches
    torch.testing.assert_close(masked_attention(qa, ka, va, m, 0.5),
                               masked_attention_plain(qa, ka, va, m, 0.5), rtol=0, atol=0)
    assert masked_attention_cuda.launches == before
    with pytest.raises(ValueError):
        kpconv_cuda(q, s, idx, x, kp, w, 0.08)
    with pytest.raises(ValueError):
        masked_attention_cuda(qa, ka, va, m, 0.5)


def test_pools_match_jax(rng):
    x = rng.randn(2, 30, 6).astype(np.float32)
    idx = rng.randint(0, 31, (2, 20, 5)).astype(np.int32)
    ref_max = jax.vmap(jax_kpconv.max_pool)(jnp.asarray(x), jnp.asarray(idx))
    ref_closest = jax.vmap(jax_kpconv.closest_pool)(jnp.asarray(x), jnp.asarray(idx))
    np.testing.assert_array_equal(max_pool(T(x), T(idx)).numpy(), np.asarray(ref_max))
    np.testing.assert_array_equal(closest_pool(T(x), T(idx)).numpy(), np.asarray(ref_closest))


def test_attention_plain_matches_pallas_interpret(rng):
    """The plain version against the Pallas kernel in interpret mode, on valid
    query rows, with the true-head-dim scale override of the main path."""
    b, h, l, s, d = 2, 2, 24, 40, 12
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32) for n in (l, s, s))
    kv_mask = rng.rand(b, s) > 0.3
    scale = 1.0 / np.sqrt(d)
    ref = masked_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(kv_mask), 8, 16, True, scale=scale)
    got = masked_attention_plain(T(q), T(k), T(v), T(kv_mask), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=2e-5)


def test_volumetric_pe_and_rotary(rng):
    xyz = (rng.rand(2, 10, 3) * 2 - 1).astype(np.float32)
    ref = jax_volumetric_pe(jnp.asarray(xyz), 48, (-3.6, -2.4, 1.14), 0.08, "rotary")
    got = volumetric_pe(T(xyz), 48, (-3.6, -2.4, 1.14), 0.08)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    x = rng.randn(2, 10, 48).astype(np.float32)
    pe = np.array(ref)
    np.testing.assert_allclose(
        embed_rotary(T(x), T(pe[..., 0]), T(pe[..., 1])).numpy(),
        np.asarray(jax_embed_rotary(jnp.asarray(x), pe[..., 0], pe[..., 1])),
        rtol=1e-5, atol=1e-5)


def _masks(rng, b, n, m):
    sm = np.zeros((b, n), bool)
    tm = np.zeros((b, m), bool)
    for i in range(b):
        sm[i, :rng.randint(n // 2, n + 1)] = True
        tm[i, :rng.randint(m // 2, m + 1)] = True
    return sm, tm


def test_log_sinkhorn(rng):
    b, n, m = 2, 20, 24
    scores = rng.randn(b, n, m).astype(np.float32)
    sm, tm = _masks(rng, b, n, m)
    ref = jax_log_sinkhorn(jnp.asarray(scores), 1.0, 3, jnp.asarray(sm), jnp.asarray(tm))
    got = log_sinkhorn(T(scores), torch.tensor(1.0), 3, T(sm), T(tm))
    valid = np.pad(sm, ((0, 0), (0, 1)), constant_values=True)[:, :, None] \
        & np.pad(tm, ((0, 0), (0, 1)), constant_values=True)[:, None, :]
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(ref)[valid], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("gate", [0.0, 40.0])
def test_soft_procrustes(rng, gate):
    b, n, m = 2, 30, 28
    conf = rng.rand(b, n, m).astype(np.float32) ** 8
    s_pcd = rng.randn(b, n, 3).astype(np.float32)
    t_pcd = rng.randn(b, m, 3).astype(np.float32)
    sm, tm = _masks(rng, b, n, m)
    conf = conf * (sm[:, :, None] & tm[:, None, :])
    args = (conf, s_pcd, t_pcd, sm, tm)
    kw = dict(sample_rate=1.0, max_condition_num=gate, use_masked_lengths=True)
    ref = jax_soft_procrustes(*map(jnp.asarray, args), **kw)
    got = soft_procrustes(*map(T, args), **kw)
    # the condition numbers are far from the gate, so both gate alike
    assert np.all(np.abs(np.asarray(ref.condition) - 40.0) > 5.0)
    for name in ("rotation", "translation", "rotation_fwd", "translation_fwd"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=2e-5, err_msg=name)
    np.testing.assert_allclose(got.condition.numpy(), np.asarray(ref.condition), rtol=1e-4)
    np.testing.assert_array_equal(got.solution_mask.numpy(), np.asarray(ref.solution_mask))


def test_selection_masks_and_extraction(rng):
    b, n, m = 2, 16, 18
    conf = rng.rand(b, n, m).astype(np.float32)
    for mutual in (False, True):
        ref = jax.vmap(lambda c: jax_mutual_topk_mask(c, 1, mutual=mutual))(jnp.asarray(conf))
        np.testing.assert_array_equal(mutual_topk_mask(T(conf), 1, mutual=mutual).numpy(),
                                      np.asarray(ref))
    np.testing.assert_array_equal(
        thresholded_mutual_argmax_mask(T(conf), 0.2).numpy(),
        np.asarray(jax_argmax_mask(jnp.asarray(conf), 0.2)))
    corr = mutual_topk_mask(T(conf), 1, mutual=False)
    got = extract_correspondences(corr, T(conf), n + m)
    for i in range(b):
        ref = jax_extract(jnp.asarray(corr.numpy()[i]), jnp.asarray(conf[i]), n + m)
        v = np.asarray(ref.valid)
        np.testing.assert_array_equal(got.valid[i].numpy(), v)
        np.testing.assert_array_equal(got.src_idx[i].numpy()[v], np.asarray(ref.src_idx)[v])
        np.testing.assert_array_equal(got.tgt_idx[i].numpy()[v], np.asarray(ref.tgt_idx)[v])
        np.testing.assert_allclose(got.scores[i].numpy(), np.asarray(ref.scores))


def test_ransac_pose_with_shared_draws(rng):
    """Same correspondences and the same hypothesis draws u (jax.random.uniform
    of the key the JAX version draws from) -> the same pose."""
    b, c, h = 2, 64, 512
    src = rng.rand(b, c, 3).astype(np.float32)
    ang = 0.4
    rot = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                   np.float32)
    tgt = src @ rot.T + np.float32([0.1, -0.2, 0.3])
    tgt[:, 40:] = rng.rand(b, c - 40, 3).astype(np.float32)     # outliers
    valid = np.ones((b, c), bool)
    valid[1, 56:] = False
    keys = jax.random.split(jax.random.PRNGKey(3), b)
    u = np.stack([np.asarray(jax.random.uniform(k, (h, 3))) for k in keys])
    got = ransac_pose(T(u), T(src), T(tgt), T(valid), distance_threshold=0.05)
    for i in range(b):
        ref = jax_ransac_pose(keys[i], jnp.asarray(src[i]), jnp.asarray(tgt[i]),
                              jnp.asarray(valid[i]), distance_threshold=0.05, num_hypotheses=h)
        assert int(got.inlier_count[i]) == int(ref.inlier_count)
        np.testing.assert_allclose(got.rotation[i].numpy(), np.asarray(ref.rotation), atol=1e-5)
        np.testing.assert_allclose(got.translation[i].numpy(), np.asarray(ref.translation),
                                   atol=1e-5)
        np.testing.assert_allclose(got.rotation[i].numpy(), rot, atol=1e-4)
