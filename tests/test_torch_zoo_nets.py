"""The port's zoo against the JAX package on the CPU (part 2 of 3): the point
nets (PointNet, PointNet++, PointTransformer, PAT, FoldingNet), the layer
library (Vector Neurons, PNConv, SAConv, GSAConv, EdgeConv,
FeaturePropagate, XConv) and the matching models (CoFiNet, Predator, D3Feat,
FCGF, URR), with weights carried by ``convert.zoo_state_dict_from_flax`` (a
strict load) and JAX's draws replayed. Tolerances: f32 modules 1e-5 of their
largest output (``F32_REL``); losses 1e-5 relative; index outputs equal.
"""
import torch_native_guard  # noqa: F401  (makes the JAX native library whole first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_draws import JaxDraws
from torch_zoo_support import F32_REL, T, apply, carry, close, init_apply, jit, np_

from diffreg_tpu import zoo as jzoo
from diffreg_tpu_torch import zoo as pzoo


def _pts(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------- neighbourhood helpers


def test_neighbourhood_helpers():
    q, s = _pts(0, 2, 12, 3), _pts(1, 2, 20, 3)
    f = _pts(2, 2, 20, 5)
    for exclude in (False, True):
        np.testing.assert_array_equal(np_(pzoo.batched_knn(T(s), T(s), 4, exclude)),
                                      np_(jzoo.batched_knn(s, s, 4, exclude)))
    ball = pzoo.batched_ball_query(T(q), T(s), 6, 0.9)
    np.testing.assert_array_equal(np_(ball), np_(jzoo.batched_ball_query(q, s, 6, 0.9)))
    close(pzoo.group_gather(T(f), ball), jzoo.group_gather(f, np_(ball)), rel=0)
    valid = np.random.RandomState(3).rand(2, 20) > 0.3
    np.testing.assert_array_equal(np_(pzoo.batched_fps(T(s), 7, T(valid))),
                                  np_(jzoo.batched_fps(s, 7, valid)))
    np.testing.assert_array_equal(np_(pzoo.batched_fps(T(s), 7)), np_(jzoo.batched_fps(s, 7)))


# ---------------------------------------------------------------- PointNet, PointNet++


def test_tnet_and_losses():
    pts = _pts(4, 2, 16, 3)
    mask = np.random.RandomState(4).rand(2, 16) > 0.2
    jm = jzoo.TNet(3, (16, 32), (16,))
    var, _ = init_apply(jm, pts, mask)
    # perturb the zero-initialised head so that the comparison sees the MLPs
    params = jax.tree_util.tree_map(lambda a: a, var["params"])
    params = {**params, "weight": jnp.asarray(_pts(5, 16, 9) * 0.1)}
    var = {"params": params}
    ref = apply(jm, var, pts, mask)
    got = carry(pzoo.TNet(3, (16, 32), (16,)), var)(T(pts), T(mask))
    close(got, ref)
    close(pzoo.tnet_loss(got), jit(jzoo.tnet_loss, ref), rel=1e-5)
    logits = _pts(6, 2, 5)
    labels = np.array([1, 3])
    for eps in (None, 0.1):
        for g, r in zip(pzoo.pointnet_loss(T(logits), T(labels), got, label_smoothing_eps=eps),
                        jit(jzoo.pointnet_loss, logits, labels, ref,
                            label_smoothing_eps=eps)):
            close(g, r, rel=1e-5)


def test_set_abstraction_modules():
    pts, feats = _pts(7, 2, 32, 3), _pts(8, 2, 32, 4)
    jm = jzoo.SetAbstractionModule((16, 24), num_centroids=8, num_samples=6, radius=1.2)
    var, ref = init_apply(jm, pts, feats)
    got = carry(pzoo.SetAbstractionModule(4, (16, 24), 8, 6, 1.2), var)(T(pts), T(feats))
    close(got[0], ref[0], rel=0)
    close(got[1], ref[1])
    cfgs = ({"output_dims": (8,), "num_samples": 4, "radius": 1.0},
            {"output_dims": (12,), "num_samples": 8, "radius": 5.0})
    jm = jzoo.MultiScaleSetAbstractionModule(8, cfgs)
    var, ref = init_apply(jm, pts)
    got = carry(pzoo.MultiScaleSetAbstractionModule(0, 8, cfgs), var)(T(pts))
    close(got[1], ref[1])
    mask = np.random.RandomState(9).rand(2, 32) > 0.2
    jm = jzoo.GlobalAbstractionModule((16, 8))
    var, ref = init_apply(jm, pts, feats, mask)
    close(carry(pzoo.GlobalAbstractionModule(4, (16, 8)), var)(T(pts), T(feats), T(mask)), ref)


def test_point_transformer():
    pts, feats = _pts(10, 1, 24, 3), _pts(11, 1, 24, 16)
    jm = jzoo.PointTransformerBlock(16, 16, num_neighbors=6)
    var, ref = init_apply(jm, feats, pts)
    got = carry(pzoo.PointTransformerBlock(16, 16, 6), var)(T(feats), T(pts))
    close(got[0], ref[0])
    jm = jzoo.TransitionDownBlock(12, downsample_ratio=4, num_neighbors=4)
    var, ref = init_apply(jm, feats[..., :8], pts)
    got = carry(pzoo.TransitionDownBlock(8, 12, 4, 4), var)(T(feats[..., :8]), T(pts))
    close(got[0], ref[0])
    close(got[1], ref[1], rel=0)


def test_pat_modules():
    pts = _pts(12, 1, 20, 3)
    for training in (True, False):
        jm = jzoo.AbsoluteRelativePositionEmbedding((16,), (24,), num_neighbor=5, dilation=2)
        var, ref = init_apply(jm, pts, training=training)
        got = carry(pzoo.AbsoluteRelativePositionEmbedding((16,), (24,), 5, dilation=2),
                    var)(T(pts), training=training)
        close(got, ref)
    f = np_(ref)
    jm = jzoo.GroupShuffleAttention(24, groups=8)
    var, ref = init_apply(jm, f, seed=1)
    close(carry(pzoo.GroupShuffleAttention(24, 8), var)(T(f)), ref)
    jm = jzoo.GumbelSubsetSampling(6)
    key = jax.random.PRNGKey(4)
    var = jm.init({"params": jax.random.PRNGKey(2)}, f, rng=jax.random.PRNGKey(3), training=True)
    pm = carry(pzoo.GumbelSubsetSampling(24, 6), var)
    close(pm(T(f), rng=JaxDraws(key), training=True), apply(jm, var, f, rng=key, training=True))
    close(pm(T(f), training=False), apply(jm, var, f, training=False))
    jm = jzoo.AttentionSubsetSampling(5)
    var, ref = init_apply(jm, f)
    close(carry(pzoo.AttentionSubsetSampling(24, 5), var)(T(f)), ref)


def test_foldingnet():
    code = _pts(13, 2, 32)
    jm = jzoo.FoldingNet(32, 64, steps=5)
    var, ref = init_apply(jm, code)
    close(carry(pzoo.FoldingNet(32, 64, 5), var)(T(code)), ref)


# ---------------------------------------------------------------- the layer library


def _rot_z(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("name", ["VNLinear", "VNLeakyReLU", "VNLeakyReLU_shared",
                                  "VNLinearLeakyReLU", "VNBatchNorm", "VNMaxPool",
                                  "VNStdFeature", "VNStdFeature_frame"])
def test_vector_neurons(name):
    """Against JAX, and SO(3) equivariance (invariance for VNStdFeature) of the
    port's layer."""
    x = _pts(14, 2, 6, 5, 8, 3) if name == "VNMaxPool" else _pts(14, 2, 16, 8, 3)
    make = {"VNLinear": (lambda: jzoo.VNLinear(12), lambda: pzoo.VNLinear(8, 12)),
            "VNLeakyReLU": (lambda: jzoo.VNLeakyReLU(), lambda: pzoo.VNLeakyReLU(8)),
            "VNLeakyReLU_shared": (lambda: jzoo.VNLeakyReLU(True),
                                   lambda: pzoo.VNLeakyReLU(8, True)),
            "VNLinearLeakyReLU": (lambda: jzoo.VNLinearLeakyReLU(12),
                                  lambda: pzoo.VNLinearLeakyReLU(8, 12)),
            "VNBatchNorm": (lambda: jzoo.VNBatchNorm(), lambda: pzoo.VNBatchNorm(8)),
            "VNMaxPool": (lambda: jzoo.VNMaxPool(), lambda: pzoo.VNMaxPool(8)),
            "VNStdFeature": (lambda: jzoo.VNStdFeature(8), lambda: pzoo.VNStdFeature(8)),
            "VNStdFeature_frame": (lambda: jzoo.VNStdFeature(8, normalize_frame=True),
                                   lambda: pzoo.VNStdFeature(8, normalize_frame=True))}[name]
    jm = make[0]()
    var, ref = init_apply(jm, x)
    pm = carry(make[1](), var)
    got = pm(T(x))
    if name == "VNStdFeature_frame":
        # Gram-Schmidt of the frame's two vectors amplifies rounding by
        # |v2| / |v2 - (v2.u1) u1|, which random weights bring to ~600 at a
        # few points: each point is held at F32_REL times its own factor
        z = pm.vn_lin(pm.vn2(pm.vn1(T(x)))).detach().numpy()
        u1 = z[..., 0, :] / np.linalg.norm(z[..., 0, :], axis=-1, keepdims=True)
        v2 = z[..., 1, :]
        perp = v2 - (v2 * u1).sum(-1, keepdims=True) * u1
        factor = np.maximum(np.linalg.norm(v2, axis=-1) / np.linalg.norm(perp, axis=-1), 1.0)
        for g, r in zip(got, ref):
            err = np.abs(np_(g) - np_(r)).reshape(*factor.shape, -1).max(-1)
            assert (err <= F32_REL * factor * np.abs(np_(r)).max()).all()
        close(pm(T(x) @ T(_rot_z(-1.2)).T)[0], got[0], rel=2e-5 * factor.max())
    elif name == "VNStdFeature":
        close(got[0], ref[0])
        close(got[1], ref[1])
        rotated = pm(T(x) @ T(_rot_z(-1.2)).T)[0]
        close(rotated, got[0], rel=2e-5)
    else:
        close(got, ref)
        r = T(_rot_z(0.9))
        close(pm(T(x) @ r.T), got @ r.T, rel=2e-5)


def test_pnconv_saconv_gsaconv_edgeconv():
    g = _pts(15, 1, 6, 4, 5)
    for normalize in (False, True):
        jm = jzoo.PNConv((8,), (10,), normalize=normalize)
        var, ref = init_apply(jm, g)
        close(carry(pzoo.PNConv(5, (8,), (10,), normalize), var)(T(g)), ref)
    q, s, f = _pts(16, 1, 6, 3), _pts(17, 1, 12, 3), _pts(18, 1, 12, 4)
    idx = np.random.RandomState(19).randint(0, 12, (1, 6, 4))
    jm = jzoo.SAConv((8, 16))
    var, ref = init_apply(jm, q, s, f, idx)
    close(carry(pzoo.SAConv(4, (8, 16)), var)(T(q), T(s), T(f), T(idx)), ref)
    var, ref = init_apply(jm, q, s, None, idx)
    close(carry(pzoo.SAConv(0, (8, 16)), var)(T(q), T(s), None, T(idx)), ref)
    mask = np.random.RandomState(20).rand(1, 12) > 0.2
    jm = jzoo.GSAConv((8,))
    var, ref = init_apply(jm, s, f, mask)
    close(carry(pzoo.GSAConv(4, (8,)), var)(T(s), T(f), T(mask)), ref)
    qf = _pts(21, 1, 6, 4)
    m = np.random.RandomState(22).rand(1, 6, 4) > 0.3
    jm = jzoo.EdgeConv((8, 12))
    var, ref = init_apply(jm, qf, f, idx, m)
    close(carry(pzoo.EdgeConv(4, (8, 12)), var)(T(qf), T(f), T(idx), T(m)), ref)


def test_feature_propagate_and_xconv():
    q, s = _pts(23, 1, 10, 3), _pts(24, 1, 12, 3)
    qf, sf = _pts(25, 1, 10, 3), _pts(26, 1, 12, 5)
    jm = jzoo.FeaturePropagate((8, 6))
    var, ref = init_apply(jm, q, s, qf, sf)
    close(carry(pzoo.FeaturePropagate(8, (8, 6)), var)(T(q), T(s), T(qf), T(sf)), ref)
    var, ref = init_apply(jzoo.FeaturePropagate(()), s, s, None, sf)
    close(carry(pzoo.FeaturePropagate(5, ()), var)(T(s), T(s), None, T(sf)), ref)
    q, s, f = _pts(27, 1, 8, 3), _pts(28, 1, 16, 3), _pts(29, 1, 16, 6)
    idx = np.random.RandomState(30).randint(0, 16, (1, 8, 4))
    for with_global, feats, cin in ((False, f, 6), (True, None, 0)):
        jm = jzoo.XConv(output_dim=20, hidden_dim=8, kernel_size=4, with_global=with_global)
        var, ref = init_apply(jm, q, s, feats, idx)
        pm = carry(pzoo.XConv(cin, 20, 8, 4, with_global), var)
        close(pm(T(q), T(s), None if feats is None else T(feats), T(idx)), ref)


# ---------------------------------------------------------------- the matching models


def test_cofinet():
    rs = np.random.RandomState(31)
    log_s = np.log(rs.rand(8, 9).astype(np.float32) * 0.5 + 1e-3)
    sm, tm = rs.rand(8) > 0.2, rs.rand(9) > 0.2
    for args in ((4, 0.9, 16, None, None), (2, 0.05, 72, sm, tm)):
        got = pzoo.cofinet_node_matching(T(log_s), *args[:3], *(None if a is None else T(a)
                                                                for a in args[3:]))
        ref = jit(lambda *a: jzoo.cofinet_node_matching(a[0], *args[:3], *a[1:]), log_s,
                  *args[3:])
        for g, r in zip(got, ref):
            (close(g, r, rel=1e-6) if np_(r).dtype.kind == "f" else
             np.testing.assert_array_equal(np_(g), np_(r)))
    n = 50
    ov = (rs.rand(n) * (rs.rand(n) > 0.5)).astype(np.float32)
    valid = rs.rand(n) > 0.1
    key = jax.random.PRNGKey(5)
    got = pzoo.cofinet_node_proposals(JaxDraws(key), torch.arange(n), torch.arange(n) + 1,
                                      T(ov), T(valid), 8)
    ref = jit(jzoo.cofinet_node_proposals, key, jnp.arange(n), jnp.arange(n) + 1, ov, valid,
              num_proposals=8)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np_(g), np_(r))


def test_predator_gcn():
    coords, feats = _pts(32, 1, 20, 3), _pts(33, 1, 20, 16)
    coords1, feats1 = _pts(34, 1, 22, 3), _pts(35, 1, 22, 16)
    jm = jzoo.PredatorGCN(16, 4, 6, ("self", "cross", "self"))
    var, ref = init_apply(jm, coords, coords1, feats, feats1)
    got = carry(pzoo.PredatorGCN(16, 4, 6, ("self", "cross", "self")), var)(
        T(coords), T(coords1), T(feats), T(feats1))
    for g, r in zip(got, ref):
        close(g, r, rel=2e-5)


def test_detection_scores_and_d3feat_loss():
    rs = np.random.RandomState(36)
    n, k, c = 12, 4, 8
    feats = np.abs(rs.randn(n, c)).astype(np.float32)
    nbrs = rs.randint(0, n, (n, k)).astype(np.int32)
    nbrs[0, 2:] = n
    for training in (True, False):
        close(pzoo.compute_detection_scores(T(feats), T(nbrs), training),
              jit(jzoo.compute_detection_scores, feats, nbrs, training=training))
    p = 16
    pts = (rs.rand(p, 3) * 4).astype(np.float32)
    f0 = rs.randn(p, 8).astype(np.float32)
    f0 /= np.linalg.norm(f0, axis=1, keepdims=True)
    f1 = f0[rs.permutation(p)]
    cfg = jzoo.D3FeatLossConfig(pos_radius=0.05, neg_radius=0.5)
    mask = rs.rand(p) > 0.1
    rot, trn = _rot_z(0.3), np.array([0.1, 0.0, -0.2], np.float32)
    s0, s1 = rs.rand(p).astype(np.float32), rs.rand(p).astype(np.float32)
    got = pzoo.d3feat_loss(T(pts), T(pts), T(f0), T(f1), T(s0), T(s1), T(mask), T(rot), T(trn),
                           pzoo.D3FeatLossConfig(pos_radius=0.05, neg_radius=0.5))
    ref = jit(jzoo.d3feat_loss, pts, pts, f0, f1, s0, s1, mask, rot, trn, cfg=cfg)
    for key in ref:
        close(got[key], ref[key], rel=1e-5, what=key)


def test_predator_and_fcgf_losses():
    rs = np.random.RandomState(37)
    n = 24
    pts = rs.randn(n, 3).astype(np.float32)
    p1 = (pts + rs.randn(n, 3) * 0.02).astype(np.float32)
    feats = rs.randn(n, 8).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    f1 = (feats + rs.randn(n, 8) * 0.3).astype(np.float32)
    pairs = np.stack([np.arange(14), rs.permutation(n)[:14]], axis=1)
    cmask = rs.rand(14) > 0.2
    m0, m1 = rs.rand(n) > 0.1, rs.rand(n) > 0.1
    scores = [rs.rand(n).astype(np.float32) for _ in range(4)]
    args = (pts, p1, feats, f1, m0, m1, pairs, cmask, np.eye(3, dtype=np.float32),
            np.zeros(3, np.float32), *scores)
    got = pzoo.predator_loss(*[T(np.asarray(a)) for a in args], pzoo.PredatorLossConfig())
    ref = jit(jzoo.predator_loss, *args, cfg=jzoo.PredatorLossConfig())
    for key in ref:
        close(got[key], ref[key], rel=1e-5, what=key)
    got = pzoo.fcgf_hardest_contrastive_loss(T(feats), T(f1), T(pairs), T(cmask), 0.1, 1.4)
    ref = jit(jzoo.fcgf_hardest_contrastive_loss, feats, f1, pairs, cmask, pos_thresh=0.1,
              neg_thresh=1.4)
    for key in ref:
        close(got[key], ref[key], rel=1e-5, what=key)


def test_urr_and_randomized_procrustes():
    rs = np.random.RandomState(38)
    n = 20
    f = rs.randn(n, 8).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    f1 = (f + rs.randn(n, 8) * 0.2).astype(np.float32)
    f1 /= np.linalg.norm(f1, axis=1, keepdims=True)
    pts = rs.randn(n, 3).astype(np.float32)
    got = pzoo.urr_extract_correspondences(T(pts), T(pts + 5.0), T(f), T(f1), 8)
    ref = jit(jzoo.urr_extract_correspondences, pts, pts + 5.0, f, f1, num_correspondences=8)
    for g, r in zip(got, ref):
        close(g, r, rel=1e-6)
    src = rs.randn(2, 64, 3).astype(np.float32)
    r, t = _rot_z(0.4), np.array([0.1, 0.2, -0.3], np.float32)
    tgt = (src @ r.T + t + rs.randn(2, 64, 3) * 0.05).astype(np.float32)
    w = rs.rand(2, 64).astype(np.float32)
    key = jax.random.PRNGKey(6)
    got = pzoo.randomized_weighted_procrustes(JaxDraws(key), T(src), T(tgt), T(w), 4, 16)
    ref = jit(jzoo.randomized_weighted_procrustes, key, src, tgt, w, num_subsets=4,
              num_samples=16)
    for g, rr in zip(got, ref):
        close(g, rr, rel=1e-5)


@pytest.mark.parametrize("weighting,compositing", [("exponential", "weighted"),
                                                   ("linear", "alpha")])
def test_differentiable_render(weighting, compositing):
    rs = np.random.RandomState(39)
    pts = np.concatenate([rs.rand(60, 2) * 16 - 2, rs.rand(60, 1) + 1.5], 1).astype(np.float32)
    pts[:3, 2] = -1.0                      # behind the camera
    colors, feats = rs.rand(60, 3).astype(np.float32), rs.randn(60, 4).astype(np.float32)
    intr = np.array([[8.0, 0, 6], [0, 8.0, 5], [0, 0, 1]], np.float32)
    got = pzoo.differentiable_render(T(pts), T(colors), T(feats), T(intr), 12, 14, 4, 2.5, 2.0,
                                     weighting, compositing)
    ref = jit(jzoo.differentiable_render, pts, colors, feats, intr, image_h=12, image_w=14,
              num_samples=4, radius=2.5, sigma=2.0, weighting_fn=weighting,
              compositing_fn=compositing)
    for g, r in zip(got[:3], ref[:3]):
        close(g, r, rel=F32_REL)
    np.testing.assert_array_equal(np_(got[3]), np_(ref[3]))
