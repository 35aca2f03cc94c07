"""The port's modules and its whole DDIM registration slice against the JAX
package at ``preset_tiny``, on the CPU, with the same weights carried across
by ``diffreg_tpu_torch.convert`` and the same random draws.

Tolerances: the backbone stacks 13 normalised blocks of f32 arithmetic
summed in a different order by each package, so its features agree to
atol 1e-4; everything downstream of it to 1e-5 relative to the values'
scale. The DDIM start is passed in; the RANSAC draws are
``jax.random.uniform`` of the keys the JAX version draws from.
"""
import torch_native_guard  # noqa: F401  (makes the JAX native library whole first)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from diffreg_tpu.data import synthetic_batch as jax_synthetic_batch
from diffreg_tpu.eval import ransac_pose as jax_ransac_pose
from diffreg_tpu.models import DiffusionMatchingModel as JaxModel
from diffreg_tpu.models.presets import preset_tiny as jax_preset_tiny
from diffreg_tpu.nn.matching import Matching as JaxMatching
from diffreg_tpu.nn.matching import MatchingConfig as JaxMatchingConfig
from diffreg_tpu.nn.transformer import GeometryAttentionLayer as JaxAttentionLayer
from diffreg_tpu.ops.position_encoding import volumetric_pe as jax_volumetric_pe
from diffreg_tpu.ops.select import extract_correspondences as jax_extract
from diffreg_tpu_torch.convert import state_dict_from_flax
from diffreg_tpu_torch.data.synthetic import synthetic_batch
from diffreg_tpu_torch.eval.register import register
from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
from diffreg_tpu_torch.models.presets import preset_tiny, with_condition_gate
from diffreg_tpu_torch.nn.matching import Matching, MatchingConfig
from diffreg_tpu_torch.nn.transformer import GeometryAttentionLayer

T = torch.from_numpy
B, N_POINTS, DATA_SEED, X_SEED, H = 2, 96, 2, 0, 8192


def _flat(tree, prefix=""):
    return {prefix + "/".join(k): np.asarray(v) for k, v in flatten_dict(dict(tree)).items()}


def _jax_cfg(gate):
    cfg = jax_preset_tiny("3dmatch", sample_steps=2)
    proc = dataclasses.replace(cfg.procrustes, max_condition_num=gate)
    return dataclasses.replace(cfg, procrustes=proc, coarse_transformer=dataclasses.replace(
        cfg.coarse_transformer, procrustes=proc))


@pytest.fixture(scope="module")
def setup():
    jbatch, spec, _ = jax_synthetic_batch(batch_size=B, n_points=N_POINTS, seed=DATA_SEED)
    pbatch, _, _ = synthetic_batch(batch_size=B, n_points=N_POINTS, seed=DATA_SEED)
    model = JaxModel(_jax_cfg(0.0))
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(lambda b, r: model.init({"params": r}, b, r, mode="train"))(jbatch, rng)
    sd = state_dict_from_flax(_flat(variables["params"]), _flat(variables["buffers"]))
    return jbatch, pbatch, spec, variables, sd


def _port_model(sd, gate):
    model = DiffusionMatchingModel(with_condition_gate(preset_tiny(2), gate), device="cpu")
    missing, unexpected = model.load_state_dict(sd, strict=False)
    # decoder tail and fine-phase heads: not in the JAX coarse-path variables
    assert not unexpected
    assert all(k.startswith(("backbone.decoder_blocks.3.", "backbone.decoder_blocks.5.",
                             "backbone.coarse_in.", "backbone.fine_out.")) for k in missing)
    return model


def test_kpfcn_encode(setup):
    jbatch, pbatch, _, variables, sd = setup
    ref = jax.jit(lambda v, b: JaxModel(_jax_cfg(0.0)).apply(
        v, b, method=lambda m, bb: m.encode(bb)))(variables, jbatch)
    with torch.no_grad():
        got = _port_model(sd, 0.0).encode(pbatch)
    valid = [pbatch.src_mask.numpy(), pbatch.tgt_mask.numpy()] * 2
    for r, g, v in zip(ref, got, valid):
        np.testing.assert_allclose(g.numpy()[v], np.asarray(r)[v], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["self", "cross"])
def test_geometry_attention_layer(rng, kind):
    b, l, s, d, h = 2, 20, 24, 48, 2
    x = rng.randn(b, l, d).astype(np.float32)
    src = x if kind == "self" else rng.randn(b, s, d).astype(np.float32)
    xyz = lambda n: (rng.rand(b, n, 3) * 2 - 1).astype(np.float32)
    x_pe = np.array(jax_volumetric_pe(jnp.asarray(xyz(l)), d, (-3.6, -2.4, 1.14), 0.08, "rotary"))
    s_pe = x_pe if kind == "self" else np.array(
        jax_volumetric_pe(jnp.asarray(xyz(s)), d, (-3.6, -2.4, 1.14), 0.08, "rotary"))
    x_mask = np.arange(l)[None] < np.array([[l], [l - 5]])
    s_mask = x_mask if kind == "self" else np.arange(s)[None] < np.array([[s - 3], [s - 9]])
    layer = JaxAttentionLayer(d, h, "rotary")
    args = tuple(map(jnp.asarray, (x, src, x_pe, s_pe, x_mask, s_mask)))
    if kind == "self":
        args = (args[0], args[0], args[2], args[2], args[4], args[4])
    params = layer.init(jax.random.PRNGKey(1), *args)["params"]
    ref = np.asarray(layer.apply({"params": params}, *args))
    prefix = "denoising_transformer/layer0_self/"
    sd = state_dict_from_flax(_flat(params, prefix), {})
    port = GeometryAttentionLayer(d, h)
    port.load_state_dict({k.split("layers.0.")[1]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port(T(x), T(src), T(x_pe), T(s_pe), T(s_mask)).numpy()
    np.testing.assert_allclose(got[x_mask], ref[x_mask], rtol=1e-5, atol=2e-5)


def test_matching(rng):
    b, s, t, d = 2, 20, 24, 48
    sf, tf = rng.randn(b, s, d).astype(np.float32), rng.randn(b, t, d).astype(np.float32)
    pe = lambda n: np.array(jax_volumetric_pe(
        jnp.asarray((rng.rand(b, n, 3) * 2 - 1).astype(np.float32)), d,
        (-3.6, -2.4, 1.14), 0.08, "rotary"))
    spe, tpe = pe(s), pe(t)
    sm = np.arange(s)[None] < np.array([[s], [s - 6]])
    tm = np.arange(t)[None] < np.array([[t - 2], [t - 7]])
    args = tuple(map(jnp.asarray, (sf, tf, spe, tpe, sm, tm)))
    matcher = JaxMatching(JaxMatchingConfig(feature_dim=d))
    params = matcher.init(jax.random.PRNGKey(2), *args)["params"]
    ref_conf, ref_mask = matcher.apply({"params": params}, *args)
    sd = state_dict_from_flax(_flat(params, "denoising_matching/"), {})
    port = Matching(MatchingConfig(feature_dim=d))
    port.load_state_dict({k.split("denoising_coarse_matching.")[1]: v for k, v in sd.items()})
    with torch.no_grad():
        conf, mask = port(*map(T, (sf, tf, spe, tpe, sm, tm)))
    valid = sm[:, :, None] & tm[:, None, :]
    np.testing.assert_allclose(conf.numpy()[valid], np.asarray(ref_conf)[valid], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(mask.numpy()[valid], np.asarray(ref_mask)[valid])


@pytest.mark.parametrize("gate", [0.0, 40.0])
def test_register_matches_jax(setup, gate):
    """The whole slice: DDIM (2 steps, shared x_init), correspondences, RANSAC."""
    jbatch, pbatch, spec, variables, sd = setup
    x_init = np.random.RandomState(X_SEED).randn(B, spec.n_src, spec.n_tgt).astype(np.float32)
    ref = jax.jit(lambda v, b, x: JaxModel(_jax_cfg(gate)).apply(
        v, b, jax.random.PRNGKey(0), mode="ddim", x_init=x))(variables, jbatch, jnp.asarray(x_init))
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    u = np.stack([np.asarray(jax.random.uniform(k, (H, 3))) for k in keys])
    got = register(_port_model(sd, gate), pbatch, T(x_init), T(u), device="cpu")

    if gate > 0:
        # every step's Procrustes condition is far from the gate, so both
        # packages accept or reject the same warps
        assert np.all(np.abs(got["step_condition"].numpy() - gate) > 10.0)
    sm, tm = pbatch.src_mask.numpy(), pbatch.tgt_mask.numpy()
    valid = sm[:, :, None] & tm[:, None, :]
    conf = np.asarray(ref["conf_matrix_pred"])
    # soft Procrustes keeps the top max(|S|, |T|) confidences: the seed is chosen
    # so that the cut falls in a gap wider than the ~2e-8 differences between
    # the packages, or the two would weight different correspondences
    for i in range(B):
        top = np.sort(got["conf_matrix_pred"][i].numpy().ravel())[::-1]
        cut = int(max(sm[i].sum(), tm[i].sum()))
        assert top[cut - 1] - top[cut] > 1e-7
    np.testing.assert_allclose(got["conf_matrix_pred"].numpy()[valid], conf[valid],
                               rtol=1e-4, atol=1e-5 * np.abs(conf).max())
    np.testing.assert_array_equal(got["corr_mask"].numpy()[valid],
                                  np.asarray(ref["corr_mask"])[valid])
    # the pose solve amplifies the confidences' differences by its condition number
    np.testing.assert_allclose(got["rotation_pred"].numpy(), np.asarray(ref["rotation_pred"]),
                               atol=1e-4)
    np.testing.assert_allclose(got["translation_pred"].numpy(),
                               np.asarray(ref["translation_pred"]), atol=1e-4)

    for i in range(B):
        corrs = jax_extract(ref["corr_mask"][i], ref["conf_matrix_pred"][i],
                            spec.n_src + spec.n_tgt)
        # the same set of valid correspondences (slot order of ties may differ)
        assert int(corrs.valid.sum()) == int(got["corr_mask"][i].sum())
        res = jax_ransac_pose(keys[i], ref["s_pcd"][i][corrs.src_idx],
                              ref["t_pcd"][i][corrs.tgt_idx], corrs.valid,
                              distance_threshold=0.05, num_hypotheses=H)
        np.testing.assert_allclose(got["ransac_rotation"][i].numpy(), np.asarray(res.rotation),
                                   atol=1e-4)
        np.testing.assert_allclose(got["ransac_translation"][i].numpy(),
                                   np.asarray(res.translation), atol=1e-4)
