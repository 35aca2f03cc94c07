"""The port's model variants against the JAX package, on the CPU: KPConv in
every influence and aggregation mode (f32 and bf16), the deformable and
modulated KPConv with its gradients, dual-softmax matching, the sinusoidal
position code, the loss library with the fitting regularizer on the port's
``deform_aux``, and two whole variants of ``preset_tiny`` (the DDIM and one
train step), with the same weights (``diffreg_tpu_torch.convert``) and draws.

Variant A: the coarsest level's three encoder blocks deformable (KPConv's
deformable configurations place them there), modulated, gaussian influence,
the "verticals" dispositions, batch norm off, sinusoidal PE and dual-softmax
matching. Variant B: constant influence, "closest" aggregation, entangled
transformers and matchers.

The JAX package creates a matcher's ``bin_score`` for the Sinkhorn matcher
only, yet its DDIM loop and its gated warp call the denoising matcher's
``sinkhorn`` (diffreg_tpu/nn/matching.py:43-44, 94): a dual-softmax model
fails there with an AttributeError. The port's denoising matcher keeps
``bin_score`` whatever its match type. Variant A's JAX model here is the
package's model with that one parameter added to its denoising matcher
(``_JaxModelWithBin``), at the port's initial value; nothing else of it
differs.

Tolerances, relative to the largest entry of the reference:
  * KPConv: f32 1e-5; bf16 1e-5 (``tests/test_torch_bf16.py``: the same
    roundings, f32 sums in another order);
  * the deformable KPConv: outputs, ``min_d2``, ``deformed_kp`` and the
    gradients 1e-4 (the offset conv's f32 sums move the deformed points), but
    in bf16 the features' gradient, whose gathered rows' bf16 cotangents JAX
    sums in bf16 and the port in f32: 2e-2 max and 1e-3 mean, as in
    ``tests/test_torch_train_bf16.py`` (measured 3.8e-3 and 2.5e-4);
  * the variants' DDIM confidences 1e-5 of the largest and rtol 1e-5; the
    train step's loss 1e-5 relative, each parameter's gradient 1e-4 of that
    tensor's largest entry (variant A's attention q and k projections 2e-3:
    ``GRAD_QK_TOL_A``); the regularizer 1e-5 relative.
"""
import torch_native_guard  # noqa: F401  (makes the JAX native library whole first)
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax.traverse_util import flatten_dict

from diffreg_tpu.data import synthetic_batch as jax_synthetic_batch
from diffreg_tpu.diffusion.schedule import make_schedule as jax_make_schedule
from diffreg_tpu.engine import loss_library as jll
from diffreg_tpu.engine.losses import LossConfig as JaxLossConfig
from diffreg_tpu.engine.losses import diffreg_loss as jax_diffreg_loss
from diffreg_tpu.models import DiffusionMatchingModel as JaxModel
from diffreg_tpu.models.presets import preset_tiny as jax_preset_tiny
from diffreg_tpu.nn import matching as jax_matching
from diffreg_tpu.nn.kpfcn import KPFCN as JaxKPFCN
from diffreg_tpu.nn.transformer import GeometryAttentionLayer as JaxAttentionLayer
from diffreg_tpu.nn.transformer import RepositioningTransformer as JaxTransformer
from diffreg_tpu.ops.kpconv import _influence_weights as jax_influence_weights
from diffreg_tpu.ops.kpconv import kpconv_batched as jax_kpconv_batched
from diffreg_tpu.ops.kpconv import kpconv_deformable as jax_kpconv_deformable
from diffreg_tpu.ops.position_encoding import embed_pos as jax_embed_pos
from diffreg_tpu.ops.position_encoding import volumetric_pe as jax_volumetric_pe
from diffreg_tpu.ops.sinkhorn import dual_softmax_conf_matrix as jax_dual_softmax
from diffreg_tpu_torch.convert import _translate, state_dict_from_flax
from diffreg_tpu_torch.data.synthetic import synthetic_batch
from diffreg_tpu_torch.engine import loss_library as pll
from diffreg_tpu_torch.engine.losses import LossConfig, diffreg_loss
from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
from diffreg_tpu_torch.models.presets import preset_tiny, with_condition_gate
from diffreg_tpu_torch.nn.transformer import GeometryAttentionLayer
from diffreg_tpu_torch.ops import kpconv as pkp
from diffreg_tpu_torch.ops.kernel_points import load_kernel_points
from diffreg_tpu_torch.ops.position_encoding import embed_pos, volumetric_pe
from diffreg_tpu_torch.ops.sinkhorn import dual_softmax_conf_matrix

T = torch.from_numpy
# variant A's attention q and k projections: their gradients are small
# differences (largest entries 3e-5 to 5e-4, the other tensors' 1e-2 to 1), and
# a 1e-7 relative perturbation of the KPConv outputs alone moves them by up to
# 3.4e-4 of their largest entry in the port itself (measured as
# tools/grad_sensitivity_port.py measures, at the variant), so the packages'
# f32 summation orders give them up to 8.2e-4 (measured); every other tensor,
# and all of variant B, is held at 1e-4
GRAD_QK_TOL_A = 2e-3
QK = re.compile(r"transformer\.layers\.\d+\.[qk]_proj\.weight$")
B, N_POINTS, DATA_SEED, TRAIN_KEY, X_SEED = 2, 96, 2, 1, 0
ORIGIN, VOXEL = (-3.6, -2.4, 1.14), 0.08
MODES = [(i, a) for i in ("linear", "constant", "gaussian") for a in ("sum", "closest")]
DEFORM_ARCH = ("simple", "resnetb", "resnetb_strided", "resnetb", "resnetb", "resnetb_strided",
               "resnetb", "resnetb", "resnetb_deformable_strided", "resnetb_deformable",
               "resnetb_deformable", "nearest_upsample", "unary", "nearest_upsample", "unary",
               "nearest_upsample", "unary")
VARIANTS = {
    "A": {"kpfcn": {"architecture": DEFORM_ARCH, "modulated": True, "kp_influence": "gaussian",
                    "fixed_kernel_points": "verticals", "use_batch_norm": False},
          "transformer": {"pe_type": "sinusoidal"}, "matching": {"match_type": "dual_softmax"}},
    "B": {"kpfcn": {"kp_influence": "constant", "aggregation_mode": "closest"},
          "transformer": {"entangled": True}, "matching": {"entangled": True}},
}


def _flat(tree, prefix=""):
    return {prefix + "/".join(k): np.asarray(v) for k, v in flatten_dict(dict(tree)).items()}


def _rel(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max()


def _rel_mean(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).mean() / np.abs(np.asarray(ref)).max()


def _variant(cfg, name):
    """``cfg`` (either package's PipelineConfig) as variant ``name``."""
    v = VARIANTS[name]
    matching = dataclasses.replace(cfg.coarse_matching, **v["matching"])
    transformer = dataclasses.replace(cfg.coarse_transformer, feature_matching=matching,
                                      **v["transformer"])
    return dataclasses.replace(cfg, kpfcn=dataclasses.replace(cfg.kpfcn, **v["kpfcn"]),
                               coarse_transformer=transformer, coarse_matching=matching)


# ---------------------------------------------------------------- KPConv


def _kpconv_inputs(rng, b=2, nq=24, ns=40, k=12, cin=8, cout=16):
    centre = np.array([3.2, -2.1, 1.7], np.float32)
    s = (centre + rng.rand(b, ns, 3) * 0.1).astype(np.float32)
    q = (centre + rng.rand(b, nq, 3) * 0.1).astype(np.float32)
    inds = rng.randint(0, ns + 1, (b, nq, k)).astype(np.int32)
    x = rng.randn(b, ns, cin).astype(np.float32)
    kp = load_kernel_points(0.04)
    w = (rng.randn(15, cin, cout) * 0.1).astype(np.float32)
    return q, s, inds, x, kp, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("influence,aggregation", MODES)
def test_kpconv_modes_match_jax(rng, influence, aggregation, dtype):
    q, s, inds, x, kp, w = _kpconv_inputs(rng)
    cd = jnp.bfloat16 if dtype == "bfloat16" else None
    # jitted: XLA's CPU runtime has no eager bf16 x bf16 -> f32 dot for some modes
    conv = jax.jit(functools.partial(jax_kpconv_batched, kp_extent=0.05, influence=influence,
                                     aggregation=aggregation, compute_dtype=cd))
    ref = np.asarray(conv(*map(jnp.asarray, (q, s, inds, x, kp, w))))
    got = pkp.kpconv_batched(*map(T, (q, s, inds, x, kp, w)), 0.05,
                             None if cd is None else "bfloat16", influence, aggregation)
    assert _rel(got.numpy(), ref) <= 1e-5
    assert np.abs(ref).max() > 0


def test_kpconv_rejects_unknown_modes(rng):
    args = tuple(map(T, _kpconv_inputs(rng))) + (0.05,)
    with pytest.raises(ValueError):
        pkp.kpconv_batched(*args, None, "cubic", "sum")
    with pytest.raises(ValueError):
        pkp.kpconv_batched(*args, None, "linear", "max")


def test_influence_weights_closest_takes_the_first_of_ties():
    """Equal distances to two kernel points: the first keeps its influence,
    as ``jnp.argmin`` chooses it."""
    sq_d = torch.tensor([[[0.5, 0.2, 0.2, 0.9]]])
    w = pkp.influence_weights(sq_d, 1.0, "constant", "closest")
    assert w.tolist() == [[[0.0, 1.0, 0.0, 0.0]]]
    ref = jax_influence_weights(jnp.asarray(sq_d.numpy()), 1.0, "constant", "closest", 4)
    np.testing.assert_array_equal(np.asarray(ref), w.numpy())


def _deform_inputs(rng, modulated, cin=8, cout=16):
    q, s, inds, x, kp, w = _kpconv_inputs(rng, cin=cin, cout=cout)
    okp = load_kernel_points(0.04, fixed="verticals")
    od = (4 if modulated else 3) * 15
    ow = (rng.randn(15, cin, od) * 0.05).astype(np.float32)
    ob = (rng.randn(od) * 0.1).astype(np.float32)
    return q, s, inds, x, kp, w, ow, ob, okp


@pytest.mark.parametrize("modulated,influence,aggregation,dtype", [
    (False, "linear", "sum", "float32"), (True, "linear", "sum", "float32"),
    (True, "gaussian", "closest", "float32"), (True, "linear", "sum", "bfloat16")])
def test_kpconv_deformable_matches_jax(rng, modulated, influence, aggregation, dtype):
    """The output, min_d2, deformed_kp and offset features, and the gradients
    of a projection of all three with respect to the features, the weights,
    the offset weights and the offset bias, against ``jax.grad``."""
    q, s, inds, x, kp, w, ow, ob, okp = _deform_inputs(rng, modulated)
    extent = 0.05
    cd = jnp.bfloat16 if dtype == "bfloat16" else None
    proj = [rng.randn(*shape).astype(np.float32)
            for shape in ((2, 24, 16), (2, 24, 15), (2, 24, 15, 3))]
    def jax_loss(xx, ww, oww, obb):
        conv = functools.partial(jax_kpconv_deformable, kernel_points=jnp.asarray(kp),
                                 weights=ww, offset_weights=oww, offset_bias=obb,
                                 kp_extent=extent, influence=influence,
                                 aggregation=aggregation, modulated=modulated,
                                 compute_dtype=cd, offset_kernel_points=jnp.asarray(okp))
        out, aux = jax.vmap(conv)(jnp.asarray(q), jnp.asarray(s), jnp.asarray(inds), xx)
        total = (jnp.sum(out * proj[0]) + jnp.sum(aux["min_d2"] * proj[1])
                 + jnp.sum(aux["deformed_kp"] * proj[2]))
        return total, (out, aux)

    (_, (ref_out, ref_aux)), ref_grads = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3), has_aux=True))(*map(jnp.asarray, (x, w, ow, ob)))
    leaves = [T(a).requires_grad_() for a in (x, w, ow, ob)]
    out, aux = pkp.kpconv_deformable(T(q), T(s), T(inds), leaves[0], T(kp), leaves[1],
                                     leaves[2], leaves[3], extent, influence, aggregation,
                                     modulated, None if cd is None else "bfloat16", T(okp))
    total = ((out * T(proj[0])).sum() + (aux["min_d2"] * T(proj[1])).sum()
             + (aux["deformed_kp"] * T(proj[2])).sum())
    grads = torch.autograd.grad(total, leaves)
    assert _rel(out.detach(), ref_out) <= 1e-4
    for name in ("min_d2", "deformed_kp", "offset_features"):
        assert _rel(aux[name].detach(), ref_aux[name]) <= 1e-4, name
    for name, g, r in zip(("x", "weights", "offset_weights", "offset_bias"), grads, ref_grads):
        if name == "x" and cd is not None:
            # the gathered rows' bf16 cotangents, summed per support row in f32
            # here and in bf16 by XLA (tests/test_torch_train_bf16.py's limits)
            assert _rel(g, r) <= 2e-2 and _rel_mean(g, r) <= 1e-3, name
        else:
            assert _rel(g, r) <= 1e-4, name
    # some neighbours fall outside every deformed point's extent, some inside
    assert 0 < float(np.mean(np.asarray(ref_aux["min_d2"]) < extent ** 2)) < 1


# ---------------------------------------------------------------- matching, PE


@pytest.mark.parametrize("masked", [False, True])
def test_dual_softmax_conf_matrix(rng, masked):
    b, s, t = 2, 20, 24
    sim = rng.randn(b, s, t).astype(np.float32)
    sm = np.arange(s)[None] < np.array([[s], [s - 6]]) if masked else None
    tm = np.arange(t)[None] < np.array([[t - 3], [t]]) if masked else None
    to_j = lambda a: None if a is None else jnp.asarray(a)   # noqa: E731
    to_t = lambda a: None if a is None else T(a)              # noqa: E731
    ref = np.asarray(jax_dual_softmax(jnp.asarray(sim), 0.1, to_j(sm), to_j(tm)))
    got = dual_softmax_conf_matrix(T(sim), 0.1, to_t(sm), to_t(tm)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


def test_sinusoidal_pe_and_embed_pos(rng):
    xyz = (rng.rand(2, 30, 3) * 4 - 2).astype(np.float32)
    ref = np.asarray(jax_volumetric_pe(jnp.asarray(xyz), 48, ORIGIN, VOXEL, "sinusoidal"))
    got = volumetric_pe(T(xyz), 48, ORIGIN, VOXEL, "sinusoidal")
    assert got.shape == (2, 30, 48)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    x = rng.randn(2, 30, 48).astype(np.float32)
    for pe_type in ("sinusoidal", "rotary"):
        pe = jax_volumetric_pe(jnp.asarray(xyz), 48, ORIGIN, VOXEL, pe_type)
        np.testing.assert_allclose(
            embed_pos(pe_type, T(x), T(np.array(pe))).numpy(),
            np.asarray(jax_embed_pos(pe_type, jnp.asarray(x), pe)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["self", "cross"])
def test_sinusoidal_attention_layer(rng, kind):
    b, l, s, d, h = 2, 20, 24, 48, 2
    x = rng.randn(b, l, d).astype(np.float32)
    src = x if kind == "self" else rng.randn(b, s, d).astype(np.float32)
    xyz = lambda n: (rng.rand(b, n, 3) * 2 - 1).astype(np.float32)      # noqa: E731
    pe = lambda n: np.array(jax_volumetric_pe(jnp.asarray(xyz(n)), d, ORIGIN, VOXEL,  # noqa
                                              "sinusoidal"))
    x_pe = pe(l)
    s_pe = x_pe if kind == "self" else pe(s)
    x_mask = np.arange(l)[None] < np.array([[l], [l - 5]])
    s_mask = x_mask if kind == "self" else np.arange(s)[None] < np.array([[s - 3], [s - 9]])
    layer = JaxAttentionLayer(d, h, "sinusoidal")
    args = tuple(map(jnp.asarray, (x, src, x_pe, s_pe, x_mask, s_mask)))
    params = layer.init(jax.random.PRNGKey(1), *args)["params"]
    ref = np.asarray(layer.apply({"params": params}, *args))
    sd = state_dict_from_flax(_flat(params, "denoising_transformer/layer0_self/"), {})
    port = GeometryAttentionLayer(d, h, pe_type="sinusoidal")
    port.load_state_dict({k.split("layers.0.")[1]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port(T(x), T(src), T(x_pe), T(s_pe), T(s_mask)).numpy()
    np.testing.assert_allclose(got[x_mask], ref[x_mask], rtol=1e-5, atol=2e-5)


# ---------------------------------------------------------------- the loss library


def _loss_cases():
    rng = np.random.RandomState(3)
    pts = lambda n: rng.rand(2, n, 3).astype(np.float32)                # noqa: E731
    sm = np.arange(30)[None] < np.array([[30], [22]])
    tm = np.arange(26)[None] < np.array([[20], [26]])
    probs = rng.rand(2, 16, 12).astype(np.float32)
    logits = rng.randn(2, 16, 12).astype(np.float32) * 3
    targets = (rng.rand(2, 16, 12) > 0.7).astype(np.float32)
    mask = rng.rand(2, 16, 12) > 0.2

    def rot(n):
        a = rng.randn(n, 3, 3).astype(np.float32)
        return np.linalg.qr(a)[0].astype(np.float32)

    f0 = rng.randn(40, 16).astype(np.float32)
    f1 = rng.randn(36, 16).astype(np.float32)
    f0 /= np.linalg.norm(f0, axis=-1, keepdims=True)
    f1 /= np.linalg.norm(f1, axis=-1, keepdims=True)
    pairs = np.stack([rng.randint(0, 40, 12), rng.randint(0, 36, 12)], -1).astype(np.int32)
    pair_mask = np.arange(12) < 9
    nodes = rng.rand(20, 3).astype(np.float32)
    edges = rng.randint(0, 20, (30, 2)).astype(np.int32)
    return {
        "chamfer": ("chamfer_distance_loss", (pts(30), pts(26), sm, tm), {"truncate": 0.3}),
        "chamfer_squared_sum": ("chamfer_distance_loss", (pts(30), pts(26)),
                                {"squared": True, "reduction": "sum"}),
        "focal": ("sigmoid_focal_loss", (probs, targets),
                  {"alpha": 0.25, "reduction": "mean", "mask": mask}),
        "focal_logits": ("sigmoid_focal_loss_with_logits", (logits, targets),
                         {"alpha": 0.25, "gamma": 2.0, "reduction": "sum"}),
        "weighted_bce": ("weighted_bce_loss", (probs, targets), {"mask": mask}),
        "weighted_bce_logits": ("weighted_bce_loss_with_logits", (logits, targets), {}),
        "orthogonal": ("orthogonal_loss", (rot(4), rot(4)), {}),
        "orthogonal_self": ("orthogonal_loss", (rng.randn(4, 3, 3).astype(np.float32),),
                            {"reduction": "sum"}),
        "rotation": ("rotation_loss", (rot(4), rot(4)), {}),
        "translation": ("translation_loss", (rng.randn(4, 3, 1).astype(np.float32),
                                             rng.randn(4, 3, 1).astype(np.float32)), {}),
        "transformation": ("transformation_loss",
                           (rot(4), rng.randn(4, 3, 1).astype(np.float32), rot(4),
                            rng.randn(4, 3, 1).astype(np.float32)), {"weight_t": 0.5}),
        "smooth_ce": ("smooth_cross_entropy_loss",
                      (rng.randn(4, 7, 5).astype(np.float32),
                       rng.randint(0, 7, (4, 5)).astype(np.int32)), {"eps": 0.1}),
        "hardest_contrastive": ("hardest_contrastive_loss", (f0, f1, pairs, pair_mask, 0.1, 1.4),
                                {"mask0": np.arange(40) < 36, "mask1": np.arange(36) < 33}),
        "arap": ("as_rigid_as_possible_loss",
                 (nodes, rot(20), rng.randn(20, 3).astype(np.float32) * 0.1, edges,
                  rng.rand(30).astype(np.float32), np.arange(30) < 25), {}),
        "p2p_fitting": ("p2p_fitting_regularizer", None, {}),
    }


def _leaves(value):
    if isinstance(value, dict):
        return [value[k] for k in sorted(value)]
    if isinstance(value, (tuple, list)):
        return list(value)
    return [value]


@pytest.mark.parametrize("case", sorted(_loss_cases()))
def test_loss_library_matches_jax(case):
    name, args, kwargs = _loss_cases()[case]
    if name == "p2p_fitting_regularizer":
        rng = np.random.RandomState(4)
        auxes = [{"min_d2": rng.rand(2, 10, 15).astype(np.float32) * 1e-3,
                  "deformed_kp": rng.randn(2, 10, 15, 3).astype(np.float32) * 0.02,
                  "kp_extent": np.float32(0.03),
                  "q_mask": np.arange(10)[None] < np.array([[10], [7]])} for _ in range(2)]
        ref = jll.p2p_fitting_regularizer(
            {"a": {"deform_aux": tuple({k: jnp.asarray(v) for k, v in aux.items()}
                                       for aux in auxes)}}, fitting_power=0.5)
        got = pll.p2p_fitting_regularizer(
            [{k: torch.as_tensor(v) for k, v in aux.items()} for aux in auxes], fitting_power=0.5)
    else:
        to_j = lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a      # noqa: E731
        to_t = lambda a: T(a) if isinstance(a, np.ndarray) else a                # noqa: E731
        ref = getattr(jll, name)(*map(to_j, args), **{k: to_j(v) for k, v in kwargs.items()})
        got = getattr(pll, name)(*map(to_t, args), **{k: to_t(v) for k, v in kwargs.items()})
    for g, r in zip(_leaves(got), _leaves(ref)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), rtol=1e-5, atol=1e-7)
        assert np.all(np.isfinite(np.asarray(r)))


# ---------------------------------------------------------------- whole variants


class _JaxMatchingWithBin(jax_matching.Matching):
    """JAX's matcher with ``bin_score`` whatever its match type."""

    def setup(self):
        super().setup()
        if self.cfg.match_type != "sinkhorn":
            self.bin_score = self.param(
                "bin_score", fnn.initializers.constant(self.cfg.skh_init_bin_score), ())


class _JaxModelWithBin(JaxModel):
    """JAX's DiffusionMatchingModel (its setup, diffreg_tpu/models/
    diffusion_matching.py:75-84) with a ``_JaxMatchingWithBin`` denoising
    matcher."""

    def setup(self):
        cfg = self.cfg
        self.backbone = JaxKPFCN(cfg.kpfcn)
        self.coarse_transformer = JaxTransformer(cfg.coarse_transformer)
        self.coarse_matching = jax_matching.Matching(cfg.coarse_matching)
        self.denoising_transformer = JaxTransformer(dataclasses.replace(
            cfg.coarse_transformer, layer_types=cfg.denoising_layer_types))
        self.denoising_matching = _JaxMatchingWithBin(cfg.coarse_matching)
        self.schedule = jax_make_schedule(cfg.timesteps)


def _jax_cfg(name, gate):
    cfg = _variant(jax_preset_tiny("3dmatch", sample_steps=2), name)
    proc = dataclasses.replace(cfg.procrustes, max_condition_num=gate)
    return dataclasses.replace(cfg, procrustes=proc, coarse_transformer=dataclasses.replace(
        cfg.coarse_transformer, procrustes=proc))


def _port_model(name, sd, gate):
    model = DiffusionMatchingModel(_variant(with_condition_gate(preset_tiny(2), gate), name),
                                   device="cpu")
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected
    # absent from JAX's tree: the fine phase only
    assert all(k.startswith(("backbone.decoder_blocks.3.", "backbone.decoder_blocks.5.",
                             "backbone.coarse_in.", "backbone.fine_out.")) for k in missing)
    return model


def _train_draws(key, spec):
    rng_t, rng_noise, rng_pos = jax.random.split(key, 3)
    return {"t": T(np.array(jax.random.randint(rng_t, (B,), 0, 1000))),
            "g": T(np.array(jax.random.normal(rng_noise, (B, spec.n_src, spec.n_tgt)))),
            "euler": T(np.array(jax.random.uniform(rng_pos, (B, 3)) * 2.0 * jnp.pi))}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    """JAX's variables of the variant (converted for the port), its DDIM
    confidences at gate 0 and its train step at gate 200 (the loss, every
    gradient, and the deform_aux its encode sows)."""
    name = request.param
    jbatch, spec, _ = jax_synthetic_batch(batch_size=B, n_points=N_POINTS, seed=DATA_SEED)
    pbatch, _, _ = synthetic_batch(batch_size=B, n_points=N_POINTS, seed=DATA_SEED)
    rng = jax.random.PRNGKey(0)
    init_model = _JaxModelWithBin(_jax_cfg(name, 0.0))
    variables = jax.jit(lambda b, r: init_model.init({"params": r}, b, r, mode="train"))(
        jbatch, rng)
    sd = state_dict_from_flax(_flat(variables["params"]), _flat(variables["buffers"]))
    x_init = np.random.RandomState(X_SEED).randn(B, spec.n_src, spec.n_tgt).astype(np.float32)
    ddim = jax.jit(lambda v, b, x: _JaxModelWithBin(_jax_cfg(name, 0.0)).apply(
        v, b, jax.random.PRNGKey(0), mode="ddim", x_init=x))(variables, jbatch,
                                                              jnp.asarray(x_init))
    key = jax.random.PRNGKey(TRAIN_KEY)
    train_model = _JaxModelWithBin(_jax_cfg(name, 200.0))

    def loss_fn(params):
        out, sown = train_model.apply({"params": params, "buffers": variables["buffers"]},
                                      jbatch, key, mode="train", mutable=["intermediates"])
        return jax_diffreg_loss(out, jbatch, JaxLossConfig())[0], sown

    (loss, sown), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return {"name": name, "pbatch": pbatch, "spec": spec, "sd": sd, "x_init": x_init,
            "ddim": ddim, "key": key, "loss": loss, "grads": grads,
            "intermediates": sown.get("intermediates", {})}


def test_variant_config_is_the_asked_for_model(variant):
    model = _port_model(variant["name"], variant["sd"], 0.0)
    kpconvs = [m for m in model.backbone.modules() if hasattr(m, "offset_conv")]
    deformable = [m for m in kpconvs if m.offset_conv is not None]
    if variant["name"] == "A":
        assert len(deformable) == 3 and all(m.modulated for m in deformable)
        assert deformable[0].offset_bias.shape == (60,)
        unary = model.backbone.encoder_blocks[1].unary2
        assert unary.batch_norm.bias.shape == (unary.mlp.out_features,)
        assert model.coarse_transformer.layers[2][0].cfg.match_type == "dual_softmax"
        assert model.coarse_transformer.cfg.pe_type == "sinusoidal"
    else:
        assert not deformable and all(m.modes == ("constant", "closest") for m in kpconvs)
        assert len(model.coarse_transformer.layers[2]) == 0     # entangled: no positioning matcher


def test_variant_ddim_matches_jax(variant):
    pbatch = variant["pbatch"]
    got = _port_model(variant["name"], variant["sd"], 0.0).ddim_sample(pbatch,
                                                                       T(variant["x_init"]))
    ref = variant["ddim"]
    valid = (pbatch.src_mask[:, :, None] & pbatch.tgt_mask[:, None, :]).numpy()
    conf = np.asarray(ref["conf_matrix_pred"])
    np.testing.assert_allclose(got["conf_matrix_pred"].numpy()[valid], conf[valid], rtol=1e-5,
                               atol=1e-5 * np.abs(conf).max())
    np.testing.assert_array_equal(got["corr_mask"].numpy()[valid],
                                  np.asarray(ref["corr_mask"])[valid])
    for name in ("rotation_pred", "translation_pred"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), atol=1e-4)


def test_variant_train_step_matches_jax(variant):
    """The loss and d loss / d parameter for every parameter of JAX's tree, at
    gate 200 (the positioning layer's matcher, where there is one, feeds only
    the detached position code: zero in JAX, None here)."""
    pbatch = variant["pbatch"]
    model = _port_model(variant["name"], variant["sd"], 200.0)
    out = model.train_forward(pbatch, **_train_draws(variant["key"], variant["spec"]))
    loss = diffreg_loss(out, pbatch, LossConfig())[0]
    np.testing.assert_allclose(loss.item(), float(variant["loss"]), rtol=1e-5)
    loss.backward()
    params = dict(model.named_parameters())
    for path, ref in _flat(variant["grads"]).items():
        name, layout = _translate(path)
        ref = ref.T if layout == "T" else ref.T[:, :, None] if layout == "conv" else ref
        grad = params[name].grad
        if np.all(ref == 0.0) and grad is None:
            assert name.startswith(("coarse_transformer.layers.2.0.",
                                    "denoising_coarse_matching.bin_score")), name
            continue
        assert grad is not None, name
        tol = GRAD_QK_TOL_A if variant["name"] == "A" and QK.search(name) else 1e-4
        np.testing.assert_allclose(grad.numpy(), ref, rtol=0,
                                   atol=tol * max(np.abs(ref).max(), 1e-12), err_msg=name)


def test_p2p_fitting_regularizer_on_deform_aux(variant):
    """The regularizer of the port's deform_aux after an encode against JAX's
    of its sown intermediates of the same model; the aux arrays themselves."""
    model = _port_model(variant["name"], variant["sd"], 0.0)
    with torch.no_grad():
        model.encode(variant["pbatch"])
    auxes = pll.deform_auxes(model)
    sown = variant["intermediates"].get("backbone", {})
    ref_auxes = [sown[k]["KPConvLayer_0"]["deform_aux"][0]
                 for k in sorted(sown, key=lambda k: int(k[3:].split("_")[0]))]
    assert len(auxes) == len(ref_auxes) == (3 if variant["name"] == "A" else 0)
    for aux, ref in zip(auxes, ref_auxes):
        for key in ("min_d2", "deformed_kp"):
            assert _rel(aux[key], ref[key]) <= 1e-4, key
        np.testing.assert_array_equal(aux["q_mask"].numpy(), np.asarray(ref["q_mask"]))
        assert float(aux["kp_extent"]) == float(ref["kp_extent"])
    got = float(pll.p2p_fitting_regularizer(model, fitting_power=1.0))
    ref = float(jll.p2p_fitting_regularizer(variant["intermediates"], fitting_power=1.0))
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert (got > 0) == (variant["name"] == "A")


def test_2d3d_precision_default_reaches_the_matchers_and_attention():
    """``precision: default`` on a 2D-3D YAML (the JAX main sets the policy for
    every dataset): the 2D-3D config carries it to both matchers and to every
    attention layer of both fusion modules, whose plain version computes
    float32 on the CPU either way."""
    import os

    from diffreg_tpu_torch.main import pipeline_2d3d_config
    from diffreg_tpu_torch.models.pipeline_2d3d import DiffReg2D3D
    from diffreg_tpu_torch.nn.layers2d3d import MultiHeadAttention
    from diffreg_tpu_torch.ops.attention import masked_attention
    from diffreg_tpu_torch.utils.config import load_yaml

    raw = load_yaml(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                 "configs", "test", "rgbdv2.yaml"))
    assert pipeline_2d3d_config(raw).precision == "highest"
    raw["precision"] = "default"
    cfg = pipeline_2d3d_config(raw)
    cfg = dataclasses.replace(cfg, img_out_dim=16, img_base_dim=16, hidden_dim=32,
                              output_dim=32, matching=dataclasses.replace(cfg.matching,
                                                                          feature_dim=32))
    model = DiffReg2D3D(cfg, device="cpu")
    assert model.coarse_matching.cfg.precision == model.denoising_coarse_matching.cfg.precision \
        == "default"
    layers = [m for m in model.modules() if isinstance(m, MultiHeadAttention)]
    assert len(layers) == 12 and all(m.precision == "default" for m in layers)
    rng = np.random.RandomState(0)
    q, k, v = (T(rng.randn(2, 4, n, 8).astype(np.float32)) for n in (5, 7, 7))
    mask = T(np.arange(7)[None] < np.array([[7], [4]]))
    torch.testing.assert_close(masked_attention(q, k, v, mask, 0.35, "default"),
                               masked_attention(q, k, v, mask, 0.35), rtol=0, atol=0)
    with pytest.raises(ValueError):
        pipeline_2d3d_config({**raw, "precision": "bf16"})
