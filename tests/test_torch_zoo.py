"""The port's zoo against the JAX package on the CPU (part 1 of 3): the
relative-position attention, the small library functions, the GeoTransformer
family, and a GeoTransformer-shaped registration composed of the zoo's
pieces (KPConv-FPN, geometric transformer, superpoint matching, patches,
Sinkhorn, local-to-global registration) at small width.

Weights are carried by ``convert.zoo_state_dict_from_flax`` (a strict load:
every flax path maps and no port key is left unset); draws are JAX's,
replayed through ``tests/torch_jax_draws.py``. Tolerances: one f32 module
1e-5 of its largest output (``F32_REL``); index outputs equal; poses 1e-5.
The composition's stacks (KPConv-FPN's 11 KPConvs, four transformer blocks,
100 Sinkhorn iterations) sum in other orders in each package: features and
scores held at 1e-4 of their scale (``COMPOSE_REL``), its index outputs
(superpoint correspondences, patches, LGR's correspondence mask) equal.
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
from diffreg_tpu.geometry import se3 as jse3
from diffreg_tpu.nn import layers2d3d as jl
from diffreg_tpu.ops import masked as jmasked
from diffreg_tpu.ops import partition as jpart
from diffreg_tpu.ops import select as jselect
from diffreg_tpu.ops import sinkhorn as jsink
from diffreg_tpu.ops import subsample as jsub
from diffreg_tpu_torch import geometry as pgeo
from diffreg_tpu_torch import ops as pops
from diffreg_tpu_torch import zoo as pzoo
from diffreg_tpu_torch.nn import layers2d3d as pl
from diffreg_tpu_torch.ops import attention as pattention

COMPOSE_REL = 1e-4


# ---------------------------------------------------------------- the relative-position attention


def _attention_inputs(seed=0, b=2, n=6, m=9, c=16):
    rs = np.random.RandomState(seed)
    return dict(q=rs.randn(b, n, c).astype(np.float32), k=rs.randn(b, m, c).astype(np.float32),
                k_valid=rs.rand(b, m) > 0.25,
                qk_embeds=rs.randn(b, n, m, c).astype(np.float32),
                k_weights=rs.rand(b, m).astype(np.float32) + 0.5,
                qk_weights=rs.rand(b, n, m).astype(np.float32) + 0.5,
                qk_valid=rs.rand(b, n, m) > 0.25)


RELATIVE = {"qk_embeds": ("qk_embeds",), "k_weights": ("k_weights",),
            "qk_weights": ("qk_weights",), "qk_valid": ("qk_valid",),
            "all": ("qk_embeds", "k_weights", "qk_weights", "qk_valid")}


@pytest.mark.parametrize("case,proj", [(case, False) for case in RELATIVE]
                         + [("qk_embeds", True), ("all", True)])
def test_relative_attention(case, proj):
    x = _attention_inputs()
    rel = {name: x[name] for name in RELATIVE[case]}
    jm = jl.MultiHeadAttention(16, 4, qk_embed_proj=proj)
    var, ref = init_apply(jm, x["q"], x["k"], x["k"], x["k_valid"], **rel)
    pm = carry(pl.MultiHeadAttention(16, 4, qk_embed_proj=proj), var)
    calls = []
    real = pattention.masked_attention
    pattention_calls = lambda *a, **k: calls.append(1) or real(*a, **k)  # noqa: E731
    pl.masked_attention, saved = pattention_calls, pl.masked_attention
    try:
        got = pm(T(x["q"]), T(x["k"]), T(x["k"]), T(x["k_valid"]),
                 **{k: T(v) for k, v in rel.items()})
    finally:
        pl.masked_attention = saved
    assert not calls                      # the relative route never reaches the kernel's
    close(got, ref, what=case)


def test_attention_kernel_route_unchanged():
    """With none of the four arguments the layer takes masked_attention (the
    kernel on CUDA tensors), held against JAX with and without a key mask."""
    x = _attention_inputs(1)
    jm = jl.MultiHeadAttention(16, 4)
    var, ref = init_apply(jm, x["q"], x["k"], x["k"], x["k_valid"])
    pm = carry(pl.MultiHeadAttention(16, 4), var)
    calls = []
    real = pl.masked_attention
    pl.masked_attention = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        got = pm(T(x["q"]), T(x["k"]), T(x["k"]), T(x["k_valid"]))
        got_open = pm(T(x["q"]), T(x["k"]), T(x["k"]))
    finally:
        pl.masked_attention = real
    assert len(calls) == 2
    close(got, ref)
    close(got_open, apply(jm, var, x["q"], x["k"], x["k"]))


def test_transformer_layer_with_projected_embeddings():
    x = _attention_inputs(2)
    jm = jl.TransformerLayer(16, 4, qk_embed_proj=True)
    var, ref = init_apply(jm, x["q"], x["q"], x["q"], None, qk_embeds=x["qk_embeds"][:, :, :6],
                          qk_valid=x["qk_valid"][:, :, :6])
    pm = carry(pl.TransformerLayer(16, 4, qk_embed_proj=True), var)
    got = pm(T(x["q"]), T(x["q"]), T(x["q"]), qk_embeds=T(x["qk_embeds"][:, :, :6]),
             qk_valid=T(x["qk_valid"][:, :, :6]))
    close(got, ref)


# ---------------------------------------------------------------- the small library functions


def test_masked_var_and_sinkhorn_conf_matrix():
    rs = np.random.RandomState(3)
    x = rs.randn(2, 7, 5).astype(np.float32)
    mask = rs.rand(2, 7) > 0.3
    close(pops.masked_var(T(x), T(mask), 1), jit(jmasked.masked_var, x, mask, axis=1))
    close(pops.masked_var(T(x), T(mask), 1, keepdim=True),
          jit(jmasked.masked_var, x, mask, axis=1, keepdims=True))
    s = rs.randn(2, 6, 8).astype(np.float32)
    sm, tm = rs.rand(2, 6) > 0.2, rs.rand(2, 8) > 0.2
    close(pops.sinkhorn_conf_matrix(T(s), 0.5, 20, T(sm), T(tm)),
          jit(lambda a, b, c: jsink.sinkhorn_conf_matrix(a, 0.5, 20, b, c), s, sm, tm))
    close(pops.sinkhorn_conf_matrix(T(s), 0.5, 20),
          jit(lambda a: jsink.sinkhorn_conf_matrix(a, 0.5, 20), s))


def test_mutual_topk_correspondences_and_proposals():
    rs = np.random.RandomState(4)
    s = rs.randn(2, 9, 11).astype(np.float32)
    got = pops.mutual_topk_correspondences(T(s), 2, 12, threshold=-0.5)
    for i in range(2):
        ref = jit(jselect.mutual_topk_correspondences, s[i], k=2, max_corr=12, threshold=-0.5)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(np_(g)[i], np_(r))
    n = 40
    src, tgt = np.arange(n), np.arange(n)[::-1].copy()
    ov = (rs.rand(n) * 0.4).astype(np.float32)
    valid = rs.rand(n) > 0.2
    key = jax.random.PRNGKey(7)
    for probabilistic in (False, True):
        for thr in (0.3, 0.9):
            got = pops.superpoint_proposals(T(src), T(tgt), T(ov), T(valid), 8, JaxDraws(key),
                                            overlap_threshold=thr, probabilistic=probabilistic)
            ref = jit(jselect.superpoint_proposals, src, tgt, ov, valid, num_proposals=8,
                      rng=key, overlap_threshold=thr, probabilistic=probabilistic)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(np_(g), np_(r))


def test_knn_interpolate_and_index_select():
    rs = np.random.RandomState(5)
    q, s = rs.randn(30, 3).astype(np.float32), rs.randn(20, 3).astype(np.float32)
    q[:4] = s[:4]                          # queries on supports reproduce their features
    f = rs.randn(20, 6).astype(np.float32)
    qv, sv = rs.rand(30) > 0.1, rs.rand(20) > 0.1
    close(pops.knn_interpolate(T(q), T(s), T(f), T(qv), T(sv), k=3),
          jit(jpart.knn_interpolate, q, s, f, qv, sv, k=3))
    idx = rs.randint(0, 20, (4, 5))
    np.testing.assert_array_equal(np_(pops.index_select(T(f), T(idx), 0)),
                                  np_(jpart.index_select(f, idx, 0)))
    np.testing.assert_array_equal(np_(pops.index_select(T(f), T(idx % 6), 1)),
                                  np_(jpart.index_select(f, idx % 6, 1)))


@pytest.mark.parametrize("max_out", [8, 40, 400])
def test_grid_subsample(max_out):
    """Same slots as JAX's (voxel-key order, truncation past max_out), and the
    numpy barycentres where nothing is truncated."""
    rs = np.random.RandomState(6)
    pts = (rs.rand(300, 3) * 2.0).astype(np.float32)
    valid = rs.rand(300) > 0.1
    got = pops.grid_subsample(T(pts), T(valid), 0.25, max_out)
    ref = jsub.grid_subsample(pts, valid, 0.25, max_out)
    close(got[0], ref[0], rel=1e-6)
    np.testing.assert_array_equal(np_(got[1]), np_(ref[1]))
    assert int(got[2]) == int(ref[2])
    if max_out == 400:
        want = jsub.grid_subsample_np(pts[valid], 0.25)
        close(np_(got[0])[np_(got[1])], want, rel=1e-6)


def test_grid_subsample_with_features_np_and_se3():
    rs = np.random.RandomState(8)
    pts = rs.rand(200, 3).astype(np.float32)
    feats = rs.randn(200, 4).astype(np.float32)
    for g, r in zip(pops.grid_subsample_with_features_np(pts, feats, 0.2),
                    jsub.grid_subsample_with_features_np(pts, feats, 0.2)):
        np.testing.assert_array_equal(g, r)
    r1, r2 = (np.linalg.qr(rs.randn(2, 3, 3))[0]).astype(np.float32)
    t1, t2 = rs.randn(2, 3, 1).astype(np.float32)
    for g, r in zip(pgeo.compose(T(r1), T(t1), T(r2), T(t2)),
                    jit(jse3.compose, r1, t1, r2, t2)):
        close(g, r, rel=1e-6)
    for g, r in zip(pgeo.inverse(T(r1), T(t1)), jit(jse3.inverse, r1, t1)):
        close(g, r, rel=1e-6)


# ---------------------------------------------------------------- GeoTransformer


def test_sinusoidal_embedding():
    idx = (np.random.RandomState(9).rand(5, 7) * 10).astype(np.float32)
    close(pzoo.sinusoidal_embedding(T(idx), 8), jzoo.sinusoidal_embedding(jnp.asarray(idx), 8),
          rel=1e-6)


def _cloud(seed, b, n, grid=False):
    """Points [B, N, 3] and masks; ``grid``: coordinates on a 1/64 grid within
    +-4, whose squared distances in the a^2 - 2ab + b^2 form are exact in f32
    in any order of summation."""
    rs = np.random.RandomState(seed)
    pts = rs.randn(b, n, 3).astype(np.float32)
    if grid:
        pts = np.clip(np.round(pts * 64.0) / 64.0, -4.0, 4.0).astype(np.float32)
    return pts, rs.rand(b, n) > 0.2


# The self-pair distance of the a^2 - 2ab + b^2 form both packages take is the
# square root of rounding noise (about 1e-7 |p|^2 summed in another order in
# each), so an embedding's diagonal entries [i, i] read sqrt(noise) / sigma_d,
# up to 3e-3 apart between the packages at |p| ~ 2; they are held at
# SELF_PAIR_REL, every other entry at F32_REL.
SELF_PAIR_REL = 1e-2


def _close_pairs(got, ref):
    got, ref = np_(got), np_(ref)
    n = ref.shape[1]
    off = ~np.eye(n, dtype=bool)
    scale = float(np.abs(ref).max())
    assert np.abs(got - ref)[:, off].max() <= F32_REL * scale
    assert np.abs(got - ref)[:, ~off].max() <= SELF_PAIR_REL * scale


@pytest.mark.parametrize("reduction", ["max", "mean"])
@pytest.mark.parametrize("masked", [False, True])
def test_geometric_structure_embedding(reduction, masked):
    pts, mask = _cloud(10, 2, 12)
    mask = mask if masked else None
    jm = jzoo.GeometricStructureEmbedding(16, sigma_d=0.2, angle_reduction=reduction)
    var, ref = init_apply(jm, pts, mask)
    pm = carry(pzoo.GeometricStructureEmbedding(16, 0.2, angle_reduction=reduction), var)
    _close_pairs(pm(T(pts), None if mask is None else T(mask)), ref)


def test_geometric_structure_embedding_v2_and_no_angles():
    pts, mask = _cloud(11, 2, 10)
    jm = jzoo.GeometricStructureEmbeddingV2(16, sigma_d=0.2)
    var, ref = init_apply(jm, pts, mask)
    pm = carry(pzoo.GeometricStructureEmbeddingV2(16, 0.2), var)
    _close_pairs(pm(T(pts), T(mask)), ref)
    jm = jzoo.GeometricStructureEmbedding(16, sigma_d=0.2, use_angle_embed=False)
    var, ref = init_apply(jm, pts)
    _close_pairs(carry(pzoo.GeometricStructureEmbedding(16, 0.2, use_angle_embed=False),
                       var)(T(pts)), ref)


@pytest.mark.parametrize("lite", [False, True])
def test_geometric_transformer(lite):
    """On grid coordinates (exact self-pair distances: the attention mixes the
    embeddings' diagonal into every row)."""
    sp, sm = _cloud(12, 2, 10, grid=True)
    tp, tm = _cloud(13, 2, 12, grid=True)
    rs = np.random.RandomState(14)
    sf, tf = rs.randn(2, 10, 24).astype(np.float32), rs.randn(2, 12, 24).astype(np.float32)
    blocks = ("self", "cross", "self")
    jm = jzoo.GeometricTransformer(24, 20, 16, 4, blocks, sigma_d=0.2, lite=lite)
    var, ref = init_apply(jm, sp, tp, sf, tf, sm, tm)
    pm = carry(pzoo.GeometricTransformer(24, 20, 16, 4, blocks, 0.2, lite=lite), var)
    got = pm(T(sp), T(tp), T(sf), T(tf), T(sm), T(tm))
    for g, r in zip(got, ref):
        close(g, r, rel=3e-5)


def test_vanilla_siamese_transformer():
    rs = np.random.RandomState(15)
    sf, tf = rs.randn(2, 8, 12).astype(np.float32), rs.randn(2, 9, 12).astype(np.float32)
    sm, tm = rs.rand(2, 8) > 0.2, rs.rand(2, 9) > 0.2
    jm = jzoo.VanillaSiameseTransformer(12, 10, 16, 4, ("self", "cross", "self"))
    var, ref = init_apply(jm, sf, tf, sm, tm)
    pm = carry(pzoo.VanillaSiameseTransformer(12, 10, 16, 4, ("self", "cross", "self")), var)
    for g, r in zip(pm(T(sf), T(tf), T(sm), T(tm)), ref):
        close(g, r)


def _assert_tables(got, ref, float_rel=1e-6):
    for g, r in zip(got, ref):
        g, r = np_(g), np_(r)
        if r.dtype.kind == "f":
            close(g, r, rel=float_rel)
        else:
            np.testing.assert_array_equal(g, r)


def test_superpoint_matchings():
    rs = np.random.RandomState(16)
    f0, f1 = rs.randn(10, 8).astype(np.float32), rs.randn(12, 8).astype(np.float32)
    f0 /= np.linalg.norm(f0, axis=1, keepdims=True)
    f1 /= np.linalg.norm(f1, axis=1, keepdims=True)
    m0, m1 = rs.rand(10) > 0.2, rs.rand(12) > 0.2
    w0, w1 = rs.rand(10).astype(np.float32), rs.rand(12).astype(np.float32)
    for thr in (None, 1.2, 0.1):
        _assert_tables(pzoo.superpoint_matching_mutual_topk(T(f0), T(f1), 2, 10, T(m0), T(m1),
                                                            threshold=thr),
                       jit(jzoo.superpoint_matching_mutual_topk, f0, f1, k=2,
                           num_correspondences=10, src_masks=m0, tgt_masks=m1, threshold=thr))
    for dual in (True, False):
        _assert_tables(pzoo.superpoint_matching_global_topk(T(f0), T(f1), 15, T(m0), T(m1),
                                                            T(w0), T(w1), dual),
                       jit(lambda *a: jzoo.superpoint_matching_global_topk(
                           a[0], a[1], 15, *a[2:], dual_normalization=dual),
                           f0, f1, m0, m1, w0, w1))
    for thr in (-1.0, 1.2):
        _assert_tables(pzoo.adaptive_superpoint_matching(T(f0), T(f1), 5, thr, T(m0), T(m1)),
                       jit(lambda *a: jzoo.adaptive_superpoint_matching(a[0], a[1], 5, thr,
                                                                        *a[2:]),
                           f0, f1, m0, m1))


def test_deduplicate_and_point_matching():
    si, ti = np.array([0, 1, 0, 2, 1, 3]), np.array([3, 4, 3, 5, 4, 1])
    valid = np.array([True, True, True, True, False, True])
    np.testing.assert_array_equal(np_(pzoo.deduplicate_correspondences(T(si), T(ti), T(valid),
                                                                       8)),
                                  np_(jzoo.deduplicate_correspondences(si, ti, valid, 8)))
    rs = np.random.RandomState(17)
    b, k = 3, 6
    score = rs.randn(b, k + 1, k + 1).astype(np.float32)
    masks = rs.rand(b, k + 1) > 0.2
    pts = rs.randn(b, k + 1, 3).astype(np.float32)
    idx = np.tile(np.arange(k + 1), (b, 1))
    gs = rs.rand(b).astype(np.float32)
    for cfg in (jzoo.PointMatchingConfig(k=2, confidence_threshold=0.0),
                jzoo.PointMatchingConfig(selection="threshold", confidence_threshold=0.5,
                                         use_dustbin=True, use_global_score=True)):
        pcfg = pzoo.PointMatchingConfig(**vars(cfg))
        _assert_tables(pzoo.point_matching(T(pts), T(pts), T(masks), T(masks), T(idx), T(idx),
                                           T(score), T(gs), pcfg, 32),
                       jit(jzoo.point_matching, pts, pts, masks, masks, idx, idx, score, gs,
                           cfg=cfg, max_correspondences=32))


def _rot_z(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("selection", ["mutual_topk", "threshold"])
def test_local_global_registration(selection):
    """A known pose from diagonal-peaked scores, and noisy scores held against
    JAX output for output."""
    rs = np.random.RandomState(18)
    b, k = 8, 16
    src = rs.randn(b, k, 3).astype(np.float32)
    r, t = _rot_z(0.5), np.array([0.3, -0.2, 0.8], np.float32)
    tgt = src @ r.T + t
    masks = np.ones((b, k), bool)
    score = np.full((b, k, k), -8.0, np.float32)
    score[:, np.arange(k), np.arange(k)] = 0.0
    match = (jzoo.PointMatchingConfig(k=1) if selection == "mutual_topk" else
             jzoo.PointMatchingConfig(selection="threshold", confidence_threshold=0.5))
    cfg = jzoo.LGRConfig(matching=match, acceptance_radius=0.05, max_global_correspondences=256)
    pcfg = pzoo.LGRConfig(matching=pzoo.PointMatchingConfig(**vars(match)),
                          acceptance_radius=0.05, max_global_correspondences=256)
    got = pzoo.local_global_registration(T(src), T(tgt), T(masks), T(masks), T(score),
                                         torch.ones(b), pcfg)
    np.testing.assert_allclose(np_(got[4]), r, atol=1e-4)
    np.testing.assert_allclose(np_(got[5]), t, atol=1e-4)
    noisy = (score + rs.randn(b, k, k) * 2.0).astype(np.float32)
    tgt_noisy = (tgt + rs.randn(b, k, 3) * 0.02).astype(np.float32)
    masks[0, :3] = False
    got = pzoo.local_global_registration(T(src), T(tgt_noisy), T(masks), T(masks), T(noisy),
                                         torch.ones(b), pcfg)
    ref = jit(jzoo.local_global_registration, src, tgt_noisy, masks, masks, noisy, jnp.ones(b),
              cfg=cfg)
    _assert_tables(got[:4], ref[:4])
    close(got[4], ref[4], rel=1e-5)
    close(got[5], ref[5], rel=1e-5)


# ---------------------------------------------------------------- the composition


def _pyramid_and_counts(seed, n_points):
    """A 4-level pair pyramid (``build_pair_pyramid``) as numpy arrays, and each
    level's source and target point counts (the packed rows: source first)."""
    from diffreg_tpu_torch.data.native import grid_subsample_native
    from diffreg_tpu_torch.data.pyramid import PyramidConfig, build_pair_pyramid
    from diffreg_tpu_torch.data.synthetic import make_pair, tiny_spec

    cfg = PyramidConfig(first_subsampling_dl=0.06)
    src, tgt, rot, trn, _ = make_pair(np.random.RandomState(seed), n_points)
    sample = build_pair_pyramid(src, tgt, rot, trn, cfg, tiny_spec(n_points))
    counts, s, t, r = [], src.astype(np.float32), tgt.astype(np.float32), None
    r = cfg.first_subsampling_dl * cfg.conv_radius
    counts.append((len(s), len(t)))
    for _ in range(cfg.num_levels - 1):
        dl = 2.0 * r / cfg.conv_radius
        s = grid_subsample_native(s, dl).astype(np.float32)
        t = grid_subsample_native(t, dl).astype(np.float32)
        counts.append((len(s), len(t)))
        r *= 2.0
    pyr = {k: [np.asarray(a)[None] for a in sample[k]]
           for k in ("points", "masks", "neighbors", "pools", "upsamples")}
    pyr["features"] = np.asarray(sample["features"])[None]
    return pyr, counts, rot


def _split(x, counts, level, cap):
    """The packed level's source and target rows, each padded to ``cap``, with
    masks: ([2, cap, ...] stacked source then target, [2, cap])."""
    ns, nt = counts[level]
    out = np.zeros((2, cap) + x.shape[1:], x.dtype)
    out[0, :ns], out[1, :nt] = x[:ns], x[ns:ns + nt]
    mask = np.zeros((2, cap), bool)
    mask[0, :ns], mask[1, :nt] = True, True
    return out, mask


@pytest.fixture(scope="module")
def composition():
    """The JAX composition's outputs and weights, and its inputs."""
    pyr, counts, rot = _pyramid_and_counts(3, 160)
    fpn_cfg = dict(input_dim=1, output_dim=16, first_dim=8, voxel_size=0.06,
                   encoder_stages=4, decoder_stages=3)
    jfpn = jzoo.KPConvFPN(jzoo.KPConvFPNConfig(**fpn_cfg))
    jpyr = {k: ([jnp.asarray(a) for a in v] if isinstance(v, list) else jnp.asarray(v))
            for k, v in pyr.items()}
    fpn_var = jax.jit(jfpn.init)(jax.random.PRNGKey(0), jpyr)
    feats = [np.asarray(f) for f in jax.jit(jfpn.apply)(fpn_var, jpyr)]   # levels 1, 2, 3
    cap_c = int(max(max(c) for c in counts[3:]))
    nodes, node_mask = _split(pyr["points"][3][0], counts, 3, cap_c)
    # the superpoints on a 1/64 grid, so that their self-pair distances are
    # exact in both packages (see SELF_PAIR_REL)
    nodes = (np.round(nodes * 64.0) / 64.0).astype(np.float32)
    node_feats, _ = _split(feats[2][0], counts, 3, cap_c)
    blocks = ("self", "cross", "self", "cross")
    jgt = jzoo.GeometricTransformer(128, 16, 16, 4, blocks, sigma_d=0.3)
    gt_var, (src_c, tgt_c) = init_apply(jgt, nodes[:1], nodes[1:], node_feats[:1],
                                        node_feats[1:], node_mask[:1], node_mask[1:])
    src_c, tgt_c = np.asarray(src_c[0]), np.asarray(tgt_c[0])
    norm = lambda f: f / np.linalg.norm(f, axis=1, keepdims=True)  # noqa: E731
    corr = [np.asarray(a) for a in jit(
        lambda *a: jzoo.superpoint_matching_global_topk(a[0], a[1], 8, *a[2:]),
        norm(src_c), norm(tgt_c), node_mask[0], node_mask[1])]
    cap_f = int(max(counts[1]))
    pts1, mask1 = _split(pyr["points"][1][0], counts, 1, cap_f)
    f1, _ = _split(feats[0][0], counts, 1, cap_f)
    parts = [jit(jpart.point_to_node_partition, pts1[i], nodes[i], mask1[i], node_mask[i], k=12)
             for i in range(2)]
    src_knn = np.asarray(parts[0].node_knn_indices)[corr[0]]
    tgt_knn = np.asarray(parts[1].node_knn_indices)[corr[1]]
    src_km = np.asarray(parts[0].node_knn_masks)[corr[0]]
    tgt_km = np.asarray(parts[1].node_knn_masks)[corr[1]]
    pad = lambda a: np.concatenate([a, np.zeros_like(a[:1])])  # noqa: E731 (sentinel row)
    sp, tp = pad(pts1[0])[src_knn], pad(pts1[1])[tgt_knn]
    sf, tf = pad(f1[0])[src_knn], pad(f1[1])[tgt_knn]
    scores = np.einsum("bnc,bmc->bnm", sf, tf) / np.sqrt(16.0)
    z = np.asarray(jit(lambda sc, a, sm, tm: jsink.log_sinkhorn(sc, a, 100, sm, tm), scores,
                       jnp.asarray(0.7), src_km, tgt_km))[:, :-1, :-1]
    lgr = jzoo.LGRConfig(matching=jzoo.PointMatchingConfig(k=3, confidence_threshold=0.05),
                         acceptance_radius=0.1, max_global_correspondences=256)
    out = jit(jzoo.local_global_registration, sp, tp, src_km, tgt_km, z, corr[2], cfg=lgr)
    return dict(pyr=pyr, counts=counts, fpn_cfg=fpn_cfg, fpn_var=fpn_var, feats=feats,
                blocks=blocks, gt_var=gt_var, src_c=src_c, tgt_c=tgt_c, corr=corr, z=z,
                nodes=nodes, node_mask=node_mask, pts1=pts1, mask1=mask1,
                knn=(src_knn, tgt_knn, src_km, tgt_km), out=[np.asarray(a) for a in out],
                cap_c=cap_c)


def test_geotransformer_composition(composition):
    """The port's pieces composed as GeoTransformer's forward, held step by
    step against JAX's (inputs of each step the port's own outputs)."""
    c = composition
    pyr = {k: ([T(a) for a in v] if isinstance(v, list) else T(v)) for k, v in c["pyr"].items()}
    fpn = carry(pzoo.KPConvFPN(pzoo.KPConvFPNConfig(**c["fpn_cfg"])), c["fpn_var"])
    feats = fpn(pyr)
    assert len(feats) == 3
    for g, r in zip(feats, c["feats"]):
        close(g, r, rel=COMPOSE_REL, what="KPConv-FPN")
    node_feats, _ = _split(np_(feats[2])[0], c["counts"], 3, c["cap_c"])
    nodes, node_mask = T(c["nodes"]), T(c["node_mask"])
    gt = carry(pzoo.GeometricTransformer(128, 16, 16, 4, c["blocks"], 0.3), c["gt_var"])
    src_c, tgt_c = gt(nodes[:1], nodes[1:], T(node_feats[:1]), T(node_feats[1:]),
                      node_mask[:1], node_mask[1:])
    close(src_c[0], c["src_c"], rel=COMPOSE_REL, what="transformer")
    close(tgt_c[0], c["tgt_c"], rel=COMPOSE_REL, what="transformer")
    norm = lambda f: f / torch.linalg.norm(f, dim=1, keepdim=True)  # noqa: E731
    corr = pzoo.superpoint_matching_global_topk(norm(src_c[0]), norm(tgt_c[0]), 8,
                                                node_mask[0], node_mask[1])
    for g, r in zip(corr, c["corr"]):
        if r.dtype.kind == "f":
            close(g, r, rel=COMPOSE_REL)
        else:
            np.testing.assert_array_equal(np_(g), r)
    from diffreg_tpu_torch.ops.partition import point_to_node_partition
    from diffreg_tpu_torch.ops.sinkhorn import log_sinkhorn

    part = point_to_node_partition(T(c["pts1"]), nodes, T(c["mask1"]), node_mask, 12)
    src_knn = part.node_knn_indices[0][corr[0]]
    tgt_knn = part.node_knn_indices[1][corr[1]]
    for g, r in zip((src_knn, tgt_knn), c["knn"][:2]):
        np.testing.assert_array_equal(np_(g), r)
    src_km, tgt_km = part.node_knn_masks[0][corr[0]], part.node_knn_masks[1][corr[1]]
    pad = lambda a: torch.cat([a, torch.zeros_like(a[:1])])  # noqa: E731
    pts1 = T(c["pts1"])
    f1, _ = _split(np_(feats[0])[0], c["counts"], 1, c["pts1"].shape[1])
    f1 = T(f1)
    sp, tp = pad(pts1[0])[src_knn], pad(pts1[1])[tgt_knn]
    sf, tf = pad(f1[0])[src_knn], pad(f1[1])[tgt_knn]
    z = log_sinkhorn(torch.einsum("bnc,bmc->bnm", sf, tf) / 4.0, torch.tensor(0.7), 100,
                     src_km, tgt_km)[:, :-1, :-1]
    close(z, c["z"], rel=COMPOSE_REL, what="patch scores")
    lgr = pzoo.LGRConfig(matching=pzoo.PointMatchingConfig(k=3, confidence_threshold=0.05),
                         acceptance_radius=0.1, max_global_correspondences=256)
    out = pzoo.local_global_registration(sp, tp, src_km, tgt_km, z, corr[2], lgr)
    ref = c["out"]
    np.testing.assert_array_equal(np_(out[3]), ref[3])
    for i in (0, 1, 2):
        close(out[i], ref[i], rel=COMPOSE_REL)
    close(out[4], ref[4], rel=COMPOSE_REL, what="rotation")
    close(out[5], ref[5], rel=COMPOSE_REL, what="translation")
