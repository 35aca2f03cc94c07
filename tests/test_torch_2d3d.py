"""The port's 2D-3D slice against the JAX package, on the CPU, at the size of
``tests/test_2d3d.py`` (32 x 48 image, 160 points, widths 16/32/64, 2 heads,
SAMPLE_STEP 2): vision and partition ops, Sinkhorn and the matcher with pad
masks, GroupNormPack, attention and transformer layers, ConvBlock, both
backbones and the fusion module, ``DiffReg2D3D`` in ``backbone`` and ``ddim``
mode, ``fine_matching``, ``pnp_ransac`` on a known pose, the tester's summary
and cache evaluation, the data path (collate, calibration, synthetic pairs),
the PNG reader against OpenCV, and the weight bridge. Weights are carried by
``diffreg_tpu_torch.convert.state_dict_2d3d_from_flax``; the DDIM start and
the PnP draws are JAX's, made from its keys and passed in.

Tolerances: data arrays, partitions and index outputs are equal. Single ops
agree to f32 rounding (1e-6 relative). Deep stacks sum in different orders in
each package: the backbones' features to 1e-4 of their scale, the fusion
tokens to 1e-4 (its attention scales q by 1/sqrt(d) before the product where
JAX scales the logits after it: one rounding at d = 32, none at the
full-width d = 64). Sinkhorn confidences to 1e-5 absolute; the top-1
correspondence masks agree except where a row's or column's best two
confidences lie within twice that (random weights make them near-uniform). PnP recovers a known pose to 1e-3 in both packages.
"""
import torch_native_guard  # noqa: F401  (makes the JAX native library whole first)
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from diffreg_tpu.data import calibrate as jcal
from diffreg_tpu.data import collate2d3d as jcol
from diffreg_tpu.data import datasets2d3d as jds
from diffreg_tpu.data.synthetic2d3d import synthetic_2d3d_batch as jax_synthetic_2d3d_batch
from diffreg_tpu.engine import tester2d3d as jt
from diffreg_tpu.eval.pnp import pnp_ransac as jax_pnp_ransac
from diffreg_tpu.models import pipeline_2d3d as jp
from diffreg_tpu.nn import fusion as jfusion
from diffreg_tpu.nn import image_backbone as jimg
from diffreg_tpu.nn import layers2d3d as jl
from diffreg_tpu.nn import point_backbone as jpb
from diffreg_tpu.nn.matching import Matching as JaxMatching
from diffreg_tpu.nn.matching import MatchingConfig as JaxMatchingConfig
from diffreg_tpu.ops import partition as jpart
from diffreg_tpu.ops import vision as jv
from diffreg_tpu.ops.sinkhorn import log_sinkhorn as jax_log_sinkhorn
from diffreg_tpu_torch.convert import _translate_2d3d, state_dict_2d3d_from_flax
from diffreg_tpu_torch.data import calibrate as pcal
from diffreg_tpu_torch.data import collate2d3d as pcol
from diffreg_tpu_torch.data import datasets2d3d as pds
from diffreg_tpu_torch.data.synthetic2d3d import synthetic_2d3d_batch
from diffreg_tpu_torch.engine import tester2d3d as pt
from diffreg_tpu_torch.eval.pnp import pnp_ransac
from diffreg_tpu_torch.models import pipeline_2d3d as pp
from diffreg_tpu_torch.nn import image_backbone as pimg
from diffreg_tpu_torch.nn import layers2d3d as pl
from diffreg_tpu_torch.nn import point_backbone as ppb
from diffreg_tpu_torch.nn.matching import Matching, MatchingConfig
from diffreg_tpu_torch.ops import partition as ppart
from diffreg_tpu_torch.ops import vision as pv
from diffreg_tpu_torch.ops.sinkhorn import log_sinkhorn

T = torch.from_numpy
B, HW, N_POINTS, DATA_SEED, STEPS = 2, (32, 48), 160, 0, 2
FEAT_TOL = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(dict(tree)).items()}


def _close(got, ref, rel, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= rel, f"{what}: {err:.3e} of the scale {scale:.3e}"


def _sub_state(params, buffers, flax_prefix, port_prefix):
    """Port state of a standalone JAX module: its flax paths read as those of
    ``flax_prefix`` in the full DiffReg2D3D, translated, ``port_prefix`` cut."""
    out = state_dict_2d3d_from_flax({flax_prefix + k: v for k, v in params.items()},
                                    {flax_prefix + k: v for k, v in buffers.items()})
    return {k[len(port_prefix):]: v for k, v in out.items()}


def _jax_cfg(**kw):
    return jp.Pipeline2D3DConfig(
        img_out_dim=32, img_base_dim=16,
        pcd_backbone=jpb.PointBackboneConfig(output_dim=32, init_dim=16, init_radius=0.1,
                                             init_sigma=0.08),
        hidden_dim=64, output_dim=64, num_heads=2,
        matching=JaxMatchingConfig(feature_dim=64), sample_steps=STEPS, **kw)


def _port_cfg(**kw):
    return pp.Pipeline2D3DConfig(
        img_out_dim=32, img_base_dim=16,
        pcd_backbone=ppb.PointBackboneConfig(output_dim=32, init_dim=16, init_radius=0.1,
                                             init_sigma=0.08),
        hidden_dim=64, output_dim=64, num_heads=2,
        matching=MatchingConfig(feature_dim=64), sample_steps=STEPS, **kw)


def _to_jax_batch(batch):
    return jp.Batch2D3D(**{k: (tuple(jnp.asarray(_np(t)) for t in v) if isinstance(v, tuple)
                               else jnp.asarray(_np(v)))
                           for k, v in vars(batch).items() if v is not None})


# ---------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def setup():
    """The JAX model's variables, the port model carrying them, and the same
    synthetic batch in both packages."""
    batch = synthetic_2d3d_batch(batch_size=B, img_hw=HW, n_points=N_POINTS, seed=DATA_SEED)
    jbatch = _to_jax_batch(batch)
    model = jp.DiffReg2D3D(_jax_cfg())
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(lambda b, r: model.init({"params": r}, b, r, mode="train"))(jbatch, rng)
    port = pp.DiffReg2D3D(_port_cfg(), device="cpu", seed=9)
    sd = state_dict_2d3d_from_flax(_flat(variables["params"]), _flat(variables["buffers"]))
    port.load_state_dict(sd, strict=True)
    return {"batch": batch, "jbatch": jbatch, "model": model, "variables": variables,
            "port": port, "sd": sd}


@pytest.fixture(scope="module")
def runs(setup):
    """Both packages' outputs in ``backbone`` mode and (through the JAX
    tester's own jitted forward, reused by the tester test) in ``ddim`` mode."""
    s = setup
    jtester = jt.TwoDThreeDTester(s["model"], s["variables"], jt.Test2D3DConfig(
        pnp_hypotheses=512, max_fine_corr=256))
    r1 = jax.random.split(jax.random.PRNGKey(5), 3)[1]
    ref_ddim = jtester._forward(s["variables"], s["jbatch"], r1)
    n, m = ref_ddim["conf_matrix_pred"].shape[1:]
    x_init = T(np.array(jax.random.normal(r1, (B, n, m))))
    ref_bb = jax.jit(lambda v, b: s["model"].apply(v, b, jax.random.PRNGKey(0),
                                                   mode="backbone"))(s["variables"], s["jbatch"])
    with torch.no_grad():
        got_bb = s["port"](s["batch"], mode="backbone")
        got_ddim = s["port"](s["batch"], mode="ddim", x_init=x_init)
    return {"jtester": jtester, "backbone": (got_bb, ref_bb), "ddim": (got_ddim, ref_ddim)}


# ---------------------------------------------------------------- ops


@pytest.mark.parametrize("normalized,centered", [(False, False), (True, False), (True, True)])
def test_create_meshgrid(normalized, centered):
    got = pv.create_meshgrid(7, 11, normalized=normalized, centered=centered, flatten=True)
    ref = jv.create_meshgrid(7, 11, normalized=normalized, centered=centered, flatten=True)
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


def test_vision_ops(rng):
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    got = pv.resize_align_corners(T(x).permute(0, 3, 1, 2), (9, 13)).permute(0, 2, 3, 1)
    _close(got, jv.resize_align_corners(jnp.asarray(x), (9, 13)), 1e-6, "resize")
    depth = (rng.rand(6, 8) * 3).astype(np.float32)
    depth[0, :3] = 0.0
    depth[1, 1] = 7.0
    k = np.array([[50.0, 0, 4.2], [0, 48.0, 2.9], [0, 0, 1]], np.float32)
    got, got_valid = pv.back_project(T(depth), T(k))
    ref, ref_valid = jv.back_project(jnp.asarray(depth), jnp.asarray(k))
    _close(got, ref, 1e-6, "back_project")
    np.testing.assert_array_equal(_np(got_valid), np.asarray(ref_valid))
    for g, r in zip(pv.patchify(16, 24, 8), jv.patchify(16, 24, 8)):
        np.testing.assert_array_equal(_np(g), np.asarray(r))
    np.testing.assert_array_equal(pp.patch_pixel_table(16, 24, 8), jp.patch_pixel_table(16, 24, 8))
    a, b = rng.randn(2, 9, 4).astype(np.float32), rng.randn(2, 6, 4).astype(np.float32)
    _close(pv.pairwise_distance(T(a), T(b)), jv.pairwise_distance(jnp.asarray(a), jnp.asarray(b)),
           1e-6, "pairwise_distance")
    _close(pv.pairwise_cosine_similarity(T(a), T(b)),
           jv.pairwise_cosine_similarity(jnp.asarray(a), jnp.asarray(b)), 1e-6, "cosine")


def test_point_to_node_partition(rng):
    """Equal partitions; the data keep each point's two nearest nodes apart
    (a near-tie would let the packages' distance roundings disagree)."""
    pts = rng.rand(B, 300, 3).astype(np.float32)
    nodes = rng.rand(B, 40, 3).astype(np.float32)
    pv_, nv = np.arange(300) < 280, np.arange(40) < 35
    pv_, nv = np.stack([pv_, np.roll(pv_, 5)]), np.stack([nv, nv])
    d = np.sort(np.linalg.norm(pts[:, :, None] - nodes[:, None, :35], axis=-1), axis=-1)
    assert (d[:, :, 1] - d[:, :, 0])[pv_].min() > 1e-6
    got = ppart.point_to_node_partition(T(pts), T(nodes), T(pv_), T(nv), 16)
    ref = jax.vmap(lambda p, n, a, b: jpart.point_to_node_partition(p, n, a, b, 16))(
        jnp.asarray(pts), jnp.asarray(nodes), jnp.asarray(pv_), jnp.asarray(nv))
    for g, r, name in zip(got, ref, ref._fields):
        np.testing.assert_array_equal(_np(g), np.asarray(r), err_msg=name)
    assert int(got.node_sizes.sum()) == int(pv_.sum()) and bool(got.node_knn_masks.any())


def test_knn_interpolate_from_table(rng):
    q, s = rng.rand(B, 30, 3).astype(np.float32), rng.rand(B, 12, 3).astype(np.float32)
    f = rng.randn(B, 12, 5).astype(np.float32)
    table = rng.randint(0, 14, (B, 30, 4)).astype(np.int32)      # 12, 13: sentinels
    got = ppart.knn_interpolate_from_table(T(q), T(s), T(f), T(table))
    ref = jax.vmap(jpart.knn_interpolate_from_table)(jnp.asarray(q), jnp.asarray(s),
                                                     jnp.asarray(f), jnp.asarray(table))
    _close(got, ref, 1e-6, "knn_interpolate_from_table")


@pytest.mark.parametrize("mutual,threshold,largest", [(True, None, True), (False, None, True),
                                                      (True, 0.3, True), (True, 0.4, False)])
def test_batch_mutual_topk_select(rng, mutual, threshold, largest):
    s = rng.rand(B, 9, 7).astype(np.float32)
    rows, cols = rng.rand(B, 9) > 0.2, rng.rand(B, 7) > 0.2
    got = ppart.batch_mutual_topk_select(T(s), 2, T(rows), T(cols), threshold=threshold,
                                         largest=largest, mutual=mutual)
    ref = jpart.batch_mutual_topk_select(jnp.asarray(s), 2, jnp.asarray(rows), jnp.asarray(cols),
                                         threshold=threshold, largest=largest, mutual=mutual)
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


def _masks(rng, n, m):
    src_pad = np.arange(n)[None].repeat(B, 0) < np.array([[n - 2], [n - 4]])
    src_mask = src_pad & (rng.rand(B, n) > 0.3)
    tgt_mask = rng.rand(B, m) > 0.4
    return src_mask, tgt_mask, src_pad, np.ones((B, m), bool)


def test_log_sinkhorn_pads(rng):
    scores = rng.randn(B, 10, 8).astype(np.float32)
    sm, tm, sp, tp = _masks(rng, 10, 8)
    got = log_sinkhorn(T(scores), torch.tensor(0.7), 3, T(sm), T(tm), T(sp), T(tp))
    ref = jax_log_sinkhorn(jnp.asarray(scores), 0.7, 3, jnp.asarray(sm), jnp.asarray(tm),
                           src_pad=jnp.asarray(sp), tgt_pad=jnp.asarray(tp))
    _close(torch.exp(got), jnp.exp(ref), 1e-6, "sinkhorn with pads")
    # without pads the masks are the pads: bit-identical to the unpadded call
    plain = log_sinkhorn(T(scores), torch.tensor(0.7), 3, T(sm), T(tm))
    same = log_sinkhorn(T(scores), torch.tensor(0.7), 3, T(sm), T(tm), T(sm), T(tm))
    assert torch.equal(plain, same)


def test_matching_no_pe_with_pads(rng):
    src, tgt = rng.randn(B, 10, 16).astype(np.float32), rng.randn(B, 8, 16).astype(np.float32)
    sm, tm, sp, tp = _masks(rng, 10, 8)
    jm = JaxMatching(JaxMatchingConfig(feature_dim=16))
    args = (jnp.asarray(src), jnp.asarray(tgt), None, None, jnp.asarray(sm), jnp.asarray(tm))
    kw = dict(pe_type="sinusoidal", src_pad=jnp.asarray(sp), tgt_pad=jnp.asarray(tp))
    variables = jm.init(jax.random.PRNGKey(1), *args, **kw)
    ref_conf, ref_mask = jm.apply(variables, *args, **kw)
    port = Matching(MatchingConfig(feature_dim=16))
    port.load_state_dict(_sub_state(_flat(variables["params"]), {}, "coarse_matching/",
                                    "coarse_matching."))
    conf, mask = port(T(src), T(tgt), None, None, T(sm), T(tm), src_pad=T(sp), tgt_pad=T(tp))
    _close(conf, ref_conf, 1e-6, "matching conf")
    np.testing.assert_array_equal(_np(mask), np.asarray(ref_mask))


# ---------------------------------------------------------------- layers


def test_group_norm_pack(rng):
    x = rng.randn(B, 20, 32).astype(np.float32)
    mask = np.arange(20)[None].repeat(B, 0) < np.array([[17], [12]])
    jm = jl.GroupNormPack(32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    variables = {"params": {"scale": jnp.asarray(rng.rand(32) + 0.5, jnp.float32),
                            "bias": jnp.asarray(rng.randn(32), jnp.float32)}}
    port = pl.GroupNormPack(32)
    port.load_state_dict(_sub_state(_flat(variables["params"]), {}, "pcd_backbone/b/norm/",
                                    "pcd_backbone.b.norm."))
    assert port.norm.num_groups == jl.optimal_groups(32) == 4
    _close(port(T(x), T(mask)), jm.apply(variables, jnp.asarray(x), jnp.asarray(mask)), 1e-6,
           "GroupNormPack")
    assert [pl.optimal_groups(c) for c in (8, 16, 64, 96, 256)] == \
        [jl.optimal_groups(c) for c in (8, 16, 64, 96, 256)]


@pytest.mark.parametrize("kind", ["attention", "transformer"])
def test_attention_and_transformer_layer(rng, kind):
    q = rng.randn(B, 13, 32).astype(np.float32)
    kv = rng.randn(B, 9, 32).astype(np.float32)
    valid = rng.rand(B, 9) > 0.3
    args = (jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), jnp.asarray(valid))
    if kind == "attention":
        jm, port = jl.MultiHeadAttention(32, 2), pl.MultiHeadAttention(32, 2)
        prefix, port_prefix = "fusion/transformer0/attention/", \
            "transformer.transformer.0.attention.attention."
    else:
        jm, port = jl.TransformerLayer(32, 2), pl.TransformerLayer(32, 2)
        prefix, port_prefix = "fusion/transformer0/", "transformer.transformer.0."
    variables = jm.init(jax.random.PRNGKey(2), *args)
    port.load_state_dict(_sub_state(_flat(variables["params"]), {}, prefix, port_prefix))
    got = port(T(q), T(kv), T(kv), T(valid))
    _close(got, jm.apply(variables, *args), 1e-5, kind)
    # no key mask: every key counts
    _close(port(T(q), T(kv), T(kv)), jm.apply(variables, *args[:3]), 1e-5, kind + " unmasked")
    if kind == "attention":
        # the relative-position arguments are ported: k_weights against JAX's
        w = rng.rand(B, 9).astype(np.float32) + 0.5
        _close(port(T(q), T(kv), T(kv), T(valid), k_weights=T(w)),
               jm.apply(variables, *args, k_weights=jnp.asarray(w)), 1e-5, kind + " k_weights")


@pytest.mark.parametrize("k,stride,use_norm,use_act", [(7, 2, True, True), (3, 1, True, False),
                                                       (1, 1, False, False), (3, 2, True, True)])
def test_conv_block(rng, k, stride, use_norm, use_act):
    x = rng.randn(1, 11, 14, 8).astype(np.float32)
    jm = jl.ConvBlock(16, k, stride, use_norm=use_norm, use_act=use_act)
    variables = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    port = pl.ConvBlock(8, 16, k, stride, use_norm=use_norm, use_act=use_act)
    port.load_state_dict(_sub_state(_flat(variables["params"]), {}, "img_backbone/encoder1/",
                                    "img_backbone.encoder1."))
    got = port(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, jm.apply(variables, jnp.asarray(x)), 1e-5, "ConvBlock")


# ---------------------------------------------------------------- modules


def test_image_backbone(rng):
    x = rng.rand(1, 32, 48, 1).astype(np.float32)
    jm = jimg.ImageBackbone(out_channels=16, base_channels=8)
    variables = jm.init(jax.random.PRNGKey(4), jnp.asarray(x))
    port = pimg.ImageBackbone(out_channels=16, base_channels=8)
    port.load_state_dict(_sub_state(_flat(variables["params"]), {}, "img_backbone/",
                                    "img_backbone."), strict=True)
    with torch.no_grad():
        got = port(T(x).permute(0, 3, 1, 2))
    for level, (g, r) in enumerate(zip(got, jm.apply(variables, jnp.asarray(x)))):
        _close(g.permute(0, 2, 3, 1), r, FEAT_TOL, f"image level {level}")


def test_point_backbone(setup):
    """Every level's features against the JAX backbone, with the full model's
    weights (8 KPConv layers, the max-pool shortcuts and the table decoder)."""
    s = setup
    jb = s["jbatch"]
    pyr = {"points": jb.points, "masks": jb.masks, "neighbors": jb.neighbors, "pools": jb.pools,
           "upsamples": jb.upsamples, "features": jb.pcd_feats}
    jm = jpb.PointBackbone(_jax_cfg().pcd_backbone)
    ref = jm.apply({"params": s["variables"]["params"]["pcd_backbone"],
                    "buffers": s["variables"]["buffers"]["pcd_backbone"]}, pyr)
    with torch.no_grad():
        got = s["port"].pcd_backbone(s["batch"])
    for level, (g, r, m) in enumerate(zip(got, ref, (0, 1, 2))):
        valid = _np(s["batch"].masks[m])
        _close(_np(g)[valid], np.asarray(r)[valid], FEAT_TOL, f"point level {level}")


def test_fusion(setup, rng):
    s = setup
    cfg = _jax_cfg()
    jm = jfusion.CrossModalFusionModule(cfg.output_dim, cfg.hidden_dim, cfg.num_heads,
                                        cfg.fusion_blocks, use_dino=False)
    img = rng.randn(B, 24, 64).astype(np.float32)
    pix = np.asarray(jv.create_meshgrid(4, 6, normalized=True, flatten=True))[None].repeat(B, 0)
    pcd = rng.randn(B, 15, 128).astype(np.float32)
    pts = rng.randn(B, 15, 3).astype(np.float32)
    valid = np.arange(15)[None].repeat(B, 0) < np.array([[15], [11]])
    ref = jm.apply({"params": s["variables"]["params"]["fusion"]}, jnp.asarray(img),
                   jnp.asarray(pix), jnp.asarray(pcd), jnp.asarray(pts), img_valid=None,
                   pcd_valid=jnp.asarray(valid))
    with torch.no_grad():
        got = s["port"].transformer(T(img), T(pix), T(pcd), T(pts), None, T(valid))
    _close(got[0], ref[0], FEAT_TOL, "image tokens")
    _close(_np(got[1])[valid], np.asarray(ref[1])[valid], FEAT_TOL, "point tokens")


# ---------------------------------------------------------------- the model


def _valid(out):
    return _np(out["node_masks"])[:, :, None] & _np(out["img_valid_c"])[:, None, :]


def _mask_agrees(got, ref, conf, valid, tol):
    """The union top-1 masks agree except where the row's or the column's best
    two confidences lie within ``tol`` (random weights give near-uniform
    confidences, so such near-ties occur)."""
    c = np.where(valid, conf, -1.0)
    top_r = -np.sort(-c, axis=2)
    top_c = -np.sort(-c, axis=1)
    row_gap = top_r[:, :, 0] - top_r[:, :, 1]                       # [B, N]
    col_gap = top_c[:, 0, :] - top_c[:, 1, :]                       # [B, M]
    b, i, j = np.nonzero(got != ref)
    assert len(b) <= 0.01 * max(int(ref.sum()), 1) + 2, len(b)
    assert ((row_gap[b, i] < tol) | (col_gap[b, j] < tol)).all()


@pytest.mark.parametrize("mode", ["backbone", "ddim"])
def test_model(runs, setup, mode):
    got, ref = runs[mode]
    for key in ("node_masks", "img_valid_c"):
        np.testing.assert_array_equal(_np(got[key]), np.asarray(ref[key]), err_msg=key)
    for field in ("point_to_node", "node_sizes", "node_masks", "node_knn_masks"):
        np.testing.assert_array_equal(_np(getattr(got["partition"], field)),
                                      np.asarray(getattr(ref["partition"], field)), err_msg=field)
    # the synthetic cloud lies on a pixel grid, so a node's members tie in
    # distance up to the rounding of each package's a^2 - 2ab + b^2: each
    # node's members are the same set, in an order the port's distances sort
    knn, ref_knn = _np(got["partition"].node_knn_indices), \
        np.asarray(ref["partition"].node_knn_indices)
    np.testing.assert_array_equal(np.sort(knn, -1), np.sort(ref_knn, -1))
    pts = _np(setup["batch"].points[0])
    nodes = _np(setup["batch"].points[2])
    for i in range(B):
        padded = np.concatenate([pts[i], np.full((1, 3), np.inf, np.float32)])
        d = np.linalg.norm(padded[knn[i]] - nodes[i][:, None], axis=-1)
        d = np.where(np.isfinite(d), d, np.inf)
        assert (np.diff(d, axis=-1)[np.isfinite(d[:, 1:])] >= -1e-6).all()
        assert (knn[i] != ref_knn[i]).sum() <= 8
    _close(got["patch_centers"], ref["patch_centers"], 1e-6, "patch centres")
    valid = _valid(ref)
    conf, ref_conf = _np(got["conf_matrix_pred"]), np.asarray(ref["conf_matrix_pred"])
    assert np.abs(conf - ref_conf)[valid].max() <= 1e-5
    assert np.abs(conf[~valid]).max() <= 1e-6
    _mask_agrees(_np(got["corr_mask"]), np.asarray(ref["corr_mask"]), ref_conf, valid, 2e-5)
    assert int(ref["corr_mask"].sum()) > 0
    _close(got["img_feats_f"], ref["img_feats_f"], FEAT_TOL, "fine image features")
    pad = _np(setup["batch"].masks[0])
    _close(_np(got["pcd_feats_f"])[pad], np.asarray(ref["pcd_feats_f"])[pad], FEAT_TOL,
           "fine point features")


def test_model_refuses_what_is_not_ported(setup):
    """The tower variant builds, as the JAX package's does (its parameters:
    dino_proj, both fusions' DINO projections, the depth affine;
    tests/test_torch_towers.py runs it); the DDIM needs its start, and the
    modes are ddim and backbone (training is ``train_forward``)."""
    model = pp.DiffReg2D3D(_port_cfg(use_dino=True, use_mono_depth=True, dino_dim=24),
                           device="cpu")
    names = dict(model.named_parameters())
    assert names["dino_proj.weight"].shape == (64, 24)
    assert names["transformer.img_in_proj_dino.weight"].shape == (64, 24)
    assert names["denoising_transformer.img_in_proj_all.weight"].shape == (64, 128)
    assert float(names["depth_coffa"].detach()) == 1.0
    assert float(names["depth_coffb"].detach()) == 0.0
    assert not any("dino" in n or "coff" in n for n, _ in setup["port"].named_parameters())
    with pytest.raises(ValueError, match="x_init"):
        setup["port"](setup["batch"], mode="ddim")
    with pytest.raises(KeyError):
        setup["port"](setup["batch"], mode="sample")


def test_fine_matching(runs, setup):
    """``fine_matching`` on the same (JAX) features and coarse correspondences,
    without a threshold (random weights' similarities are low): equal buffers."""
    from diffreg_tpu.ops.select import extract_correspondences as jax_extract

    _, ref = runs["backbone"]
    jb = setup["jbatch"]
    h, w = HW
    table = jp.patch_pixel_table(h, w, 8)
    pix = np.asarray(jv.create_meshgrid(h, w, flatten=True))[:, ::-1].copy()
    corrs = jax.vmap(lambda m, s: jax_extract(m, s, 64))(ref["corr_mask"], ref["conf_matrix_pred"])
    part = ref["partition"]
    for i in range(B):
        args = [np.asarray(a) for a in (
            ref["img_feats_f"][i], jb.img_points[i], pix, ref["pcd_feats_f"][i], jb.points[0][i],
            corrs.src_idx[i], corrs.tgt_idx[i], corrs.valid[i], part.node_knn_indices[i],
            part.node_knn_masks[i], table)]
        refm = jp.fine_matching(*[jnp.asarray(a) for a in args], 128, topk=2, threshold=-1.0)
        gotm = pp.fine_matching(*[T(np.ascontiguousarray(a)) for a in args], 128, topk=2,
                                threshold=-1.0)
        assert int(refm["corr_valid"].sum()) > 5
        for key in ("corr_valid", "img_corr_indices", "pcd_corr_indices", "img_corr_pixels",
                    "img_corr_points", "pcd_corr_points"):
            np.testing.assert_array_equal(_np(gotm[key]), np.asarray(refm[key]), err_msg=key)
        _close(gotm["corr_scores"], refm["corr_scores"], 1e-6, "fine scores")


def _pnp_scene(seed, n=300, outliers=0.4):
    """Cloud points, their pixels under a known pose (40% moved to random
    pixels) and Kinect-like intrinsics."""
    from scipy.spatial.transform import Rotation

    rs = np.random.RandomState(seed)
    k = np.array([[570.0, 0, 320.0], [0, 570.0, 240.0], [0, 0, 1]], np.float32)
    rot = Rotation.from_euler("zyx", rs.rand(3) * 0.6).as_matrix().astype(np.float32)
    trn = np.array([0.1, -0.2, 2.0], np.float32)
    pts = (rs.rand(n, 3) - 0.5).astype(np.float32) * 2.0
    cam = pts @ rot.T + trn
    pix = np.stack([cam[:, 0] / cam[:, 2] * k[0, 0] + k[0, 2],
                    cam[:, 1] / cam[:, 2] * k[1, 1] + k[1, 2]], -1).astype(np.float32)
    bad = rs.rand(n) < outliers
    pix[bad] = (rs.rand(int(bad.sum()), 2) * [640, 480]).astype(np.float32)
    valid = np.arange(n) < n - 20                       # a padded tail
    return pts, pix, valid, k, rot, trn, bad


def test_pnp_ransac_known_pose():
    pts, pix, valid, k, rot, trn, bad = _pnp_scene(3)
    key = jax.random.PRNGKey(11)
    u = np.array(jax.random.uniform(key, (2048, 6)))
    ref = jax_pnp_ransac(key, jnp.asarray(pts), jnp.asarray(pix), jnp.asarray(valid),
                         jnp.asarray(k), num_hypotheses=2048)
    got = pnp_ransac(T(u), T(pts), T(pix), T(valid), T(k))
    for res in (got, ref):
        assert bool(res.success)
        assert np.abs(_np(res.rotation) - rot).max() < 1e-3
        assert np.abs(_np(res.translation)[:, 0] - trn).max() < 1e-3
    assert int(got.inlier_count) == int(ref.inlier_count) == int((~bad & valid).sum())
    # degenerate draws (one point six times) lose the vote; a non-finite
    # 12 x 12 system (torch's eigh raises on it, JAX's returns NaN) fails it
    deg = pnp_ransac(torch.zeros(4, 6), T(pts), T(pix), T(valid), T(k))
    assert int(deg.inlier_count) < 10
    pts[0] = np.nan
    bad_sys = pnp_ransac(torch.zeros(4, 6), T(pts), T(pix), T(valid), T(k))
    assert not bool(bad_sys.success)


class _JaxDraws:
    """The JAX tester's keys: per batch ``rng, r1, r2 = split(rng, 3)``, the
    DDIM start from r1, pair i's PnP draws from ``split(r2, B)[i]``; per
    cached pair of eval_from_cache ``rng, k = split(rng)``."""

    def __init__(self, seed, hypotheses):
        self.rng = jax.random.PRNGKey(seed)
        self.eval_rng = jax.random.PRNGKey(0)      # eval_from_cache's default key
        self.h = hypotheses

    def start(self, tester, batch, n, m, generator):
        self.rng, r1, self.r2 = jax.random.split(self.rng, 3)
        return T(np.array(jax.random.normal(r1, (batch.batch_size, n, m))))

    def pnp(self, tester, batch, generator):
        keys = jax.random.split(self.r2, batch.batch_size)
        return T(np.stack([np.array(jax.random.uniform(k, (self.h, 6))) for k in keys]))

    def pnp_eval(self, generator, cfg, device):
        self.eval_rng, k = jax.random.split(self.eval_rng)
        return T(np.array(jax.random.uniform(k, (self.h, 6))))


def test_tester_and_cache(runs, setup, tmp_path, monkeypatch):
    """``TwoDThreeDTester.test`` and ``eval_from_cache`` on the fixture's batch
    (ddim, fine threshold 0.75 as in the protocol) against the JAX tester,
    with JAX's draws: every summary entry and every cache file."""
    cfg_kw = dict(pnp_hypotheses=512, max_fine_corr=256)
    draws = _JaxDraws(5, 512)
    monkeypatch.setattr(pt.TwoDThreeDTester, "draw_start",
                        lambda self, b, n, m, g: draws.start(self, b, n, m, g))
    monkeypatch.setattr(pt.TwoDThreeDTester, "draw_pnp", lambda self, b, g: draws.pnp(self, b, g))
    monkeypatch.setattr(pt, "draw_pnp_eval", draws.pnp_eval)
    jbatch, batch = setup["jbatch"], setup["batch"]
    meta = ["scene_a", "scene_b"]
    ref = runs["jtester"].test(lambda: iter([(jbatch, meta)]), rng=jax.random.PRNGKey(5),
                               cache_dir=str(tmp_path / "jax"))
    tester = pt.TwoDThreeDTester(setup["port"], pt.Test2D3DConfig(**cfg_kw), device="cpu")
    got = tester.test(lambda: iter([(batch, meta)]), cache_dir=str(tmp_path / "port"))
    assert set(got) == set(ref) and got["pairs"] == ref["pairs"] == B
    for key in ref:
        assert got[key] == pytest.approx(float(ref[key]), rel=1e-5, abs=1e-5), key
    for scene in meta:
        g = np.load(tmp_path / "port" / scene / f"{meta.index(scene):06d}.npz")
        r = np.load(tmp_path / "jax" / scene / f"{meta.index(scene):06d}.npz")
        assert set(g.files) == set(r.files)
        for name in r.files:
            np.testing.assert_allclose(g[name], r[name], rtol=1e-5, atol=1e-6, err_msg=name)
    got_eval = pt.eval_from_cache(str(tmp_path / "port"), pt.Test2D3DConfig(**cfg_kw),
                                  device="cpu")
    ref_eval = jt.eval_from_cache(str(tmp_path / "jax"), jt.Test2D3DConfig(**cfg_kw))
    assert set(got_eval["scenes"]) == set(meta)
    for key, val in ref_eval.items():
        if key != "scenes":
            assert got_eval[key] == pytest.approx(float(val), rel=1e-5, abs=1e-5), key
    # the host PnP: OpenCV's where cv2 imports, the device PnP (with a
    # warning) where it does not, as the JAX package's main falls back
    host = pt.TwoDThreeDTester(setup["port"], pt.Test2D3DConfig(pnp_backend="opencv"),
                               device="cpu")
    assert host.cfg.pnp_backend == "opencv"
    from diffreg_tpu_torch.eval import host_estimators

    monkeypatch.setattr(host_estimators, "has_module", lambda name: False)
    fallback = pt.TwoDThreeDTester(setup["port"], pt.Test2D3DConfig(pnp_backend="opencv"),
                                   device="cpu")
    assert fallback.cfg.pnp_backend == "device"


# ---------------------------------------------------------------- data


def _raw_sample(seed, h=48, w=64, n_points=900):
    """A raw reader dict: a smooth depth map, a gray image, intrinsics, and a
    cloud of the camera points (plus some outside the view) in a world frame."""
    from scipy.spatial.transform import Rotation

    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = (1.5 + 0.3 * np.sin(xx / 9.0) + 0.2 * np.cos(yy / 7.0)).astype(np.float32)
    depth[:3, :5] = 0.0
    k = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]], np.float32)
    pts, valid = jcol._back_project_np(depth, k)
    cam = pts[valid][rs.permutation(int(valid.sum()))[:n_points]]
    cam = np.concatenate([cam, cam[:100] + [0.8, 0.0, 0.3]])
    rot = Rotation.from_euler("zyx", rs.rand(3)).as_matrix().astype(np.float32)
    trn = rs.randn(3).astype(np.float32) * 0.3
    tfm = np.eye(4, dtype=np.float32)
    tfm[:3, :3], tfm[:3, 3] = rot, trn
    world = ((cam - trn) @ rot).astype(np.float32)
    gray = rs.rand(h, w).astype(np.float32)
    return {"depth": depth, "intrinsics": k, "transform": tfm, "points": world,
            "feats": np.ones((len(world), 1), np.float32), "image_gray": gray - gray.mean(),
            "image": np.repeat(gray[..., None], 3, -1), "scene_name": "s"}


def test_collate_and_calibrate():
    raws = [_raw_sample(s) for s in (1, 2)]
    clouds = [r["points"] for r in raws]
    got_spec = pcal.calibrate_spec_2d3d(clouds, init_radius=0.05, n_gt=64, n_overlap=128,
                                        n_fine_gt=64, num_points_in_patch=32)
    ref_spec = jcal.calibrate_spec_2d3d(clouds, init_radius=0.05, n_gt=64, n_overlap=128,
                                        n_fine_gt=64, num_points_in_patch=32)
    assert vars(got_spec) == vars(ref_spec)
    got = [pcol.build_2d3d_sample(r, got_spec, 8) for r in raws]
    ref = [jcol.build_2d3d_sample(r, ref_spec, 8) for r in raws]
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for key in r:
            for a, b in (zip(g[key], r[key]) if isinstance(r[key], tuple) else [(g[key], r[key])]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=key)
    assert ref[0]["gt_valid"].sum() > 0 and ref[0]["ov_valid"].sum() > 0
    assert ref[0]["fine_valid"].sum() > 0
    batch = pcol.batch_2d3d(got)
    jbatch = jcol.batch_2d3d(ref)
    for name, val in vars(batch).items():
        rval = getattr(jbatch, name)
        for a, b in (zip(val, rval) if isinstance(val, tuple) else [(val, rval)]):
            np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=name)


def test_synthetic_2d3d_batch():
    got = synthetic_2d3d_batch(batch_size=2, img_hw=(32, 48), n_points=160, seed=4)
    ref = jax_synthetic_2d3d_batch(batch_size=2, img_hw=(32, 48), n_points=160, seed=4)
    for name, val in vars(got).items():
        rval = getattr(ref, name)
        if val is None:
            assert rval is None, name
            continue
        for a, b in (zip(val, rval) if isinstance(val, tuple) else [(val, rval)]):
            np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=name)


def _png_chunk(kind, body):
    import struct
    import zlib

    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _write_png_all_filters(path, img):
    """An 8-bit gray or RGB PNG whose rows cycle through the five filter types."""
    import struct
    import zlib

    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * ch).astype(np.int32)
    raw, prev = b"", np.zeros(w * ch, np.int32)
    for y in range(h):
        ftype, cur = y % 5, rows[y]
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int32), prev[:-ch]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        raw += bytes([ftype]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur
    ctype = {1: 0, 3: 2}[ch]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                                                          0, 0, 0))
                + _png_chunk(b"IDAT", zlib.compress(raw)) + _png_chunk(b"IEND", b""))


def test_png_reader_matches_opencv(tmp_path, rng):
    """The port's PNG reader against cv2 (which the JAX package reads with):
    16-bit depth and 8-bit colour as cv2 writes them, every filter type, gray,
    and the RGB -> gray rounding; other files raise."""
    depth = (rng.rand(21, 34) * 6000).astype(np.uint16)
    depth[rng.rand(21, 34) < 0.1] = 0
    cv2.imwrite(str(tmp_path / "d.png"), depth)
    bgr = rng.randint(0, 256, (21, 34, 3)).astype(np.uint8)     # every gray rounding case
    bgr[:5] = (np.add.outer(np.arange(5), np.arange(34)) * 3 % 256)[..., None]
    for level in (0, 9):
        cv2.imwrite(str(tmp_path / f"c{level}.png"), bgr, [cv2.IMWRITE_PNG_COMPRESSION, level])
    _write_png_all_filters(tmp_path / "f3.png", bgr[..., ::-1])
    _write_png_all_filters(tmp_path / "f1.png", bgr[..., 0])
    cv2.imwrite(str(tmp_path / "rgba.png"), np.concatenate(
        [bgr, rng.randint(0, 256, (21, 34, 1)).astype(np.uint8)], -1))
    np.testing.assert_array_equal(pds.read_depth_image(str(tmp_path / "d.png")),
                                  jds.read_depth_image(str(tmp_path / "d.png")))
    for name in ("c0", "c9", "f3", "f1"):
        path = str(tmp_path / f"{name}.png")
        for gray in (False, True):
            np.testing.assert_array_equal(pds.read_image(path, as_gray=gray),
                                          jds.read_image(path, as_gray=gray), err_msg=name)
    with pytest.raises(FileNotFoundError):
        pds.read_image(str(tmp_path / "missing.png"))
    (tmp_path / "x.png").write_bytes(b"not a png")
    for bad in ("x", "rgba"):                       # not a PNG; a colour type the datasets lack
        with pytest.raises(ValueError):
            pds.read_image(str(tmp_path / f"{bad}.png"))


# ---------------------------------------------------------------- the weight bridge


def test_weight_bridge_is_key_complete(setup):
    """Every flax entry has a port key, distinct and of the right shape; every
    port parameter and buffer gets one (no parameter left at its init)."""
    v = setup["variables"]
    paths = list(_flat(v["params"])) + list(_flat(v["buffers"]))
    keys = [_translate_2d3d(p)[0] for p in paths]
    assert len(set(keys)) == len(keys) == len(paths)
    port_state = setup["port"].state_dict()
    assert set(keys) == set(port_state)
    for key, val in setup["sd"].items():
        assert tuple(val.shape) == tuple(port_state[key].shape), key
    with pytest.raises(KeyError):
        _translate_2d3d("fusion/unknown")
