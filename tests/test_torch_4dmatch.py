"""The port's 4DMatch slice against the JAX package, on the CPU: deformable
synthetic pairs and their coarse flow, the DDIM coefficients, every function
of ``eval/metrics.py``, the 4DMatch ``ddim_sample`` (stochastic and with
``zero_ddim_noise``), ``train_forward``, the loss with its motion term and
every parameter's gradient, and both testers' per-pair metrics on the same
model outputs. Weights are carried by ``diffreg_tpu_torch.convert``; random
draws are JAX's, reproduced from its keys and passed in.

Tolerances: data and metrics of the same f32 inputs agree exactly or to f32
rounding (1e-6); the model's outputs as in ``tests/test_torch_train.py``: the
backbone's features agree to about 1e-4, so sigmoid confidences are held to
1e-4 of their scale, poses to 1e-4 and gradients to 5e-4 of each tensor's
largest entry. Cut gaps and condition numbers are asserted away from ties,
and the data seed keeps the first layer's pre-activations away from zero: a
leaky-ReLU sign that flips between the packages moves that layer's weight
gradient discretely (data seed 2 flips one, by 8e-3 of the largest entry).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from diffreg_tpu.data.pyramid import PyramidConfig as JaxPyramidConfig
from diffreg_tpu.data.pyramid import batch_from_samples as jax_batch_from_samples
from diffreg_tpu.data.pyramid import build_pair_pyramid as jax_build_pair_pyramid
from diffreg_tpu.data.synthetic import make_pair as jax_make_pair
from diffreg_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from diffreg_tpu.data.synthetic import tiny_spec as jax_tiny_spec
from diffreg_tpu.diffusion.schedule import make_schedule as jax_make_schedule
from diffreg_tpu.engine.losses import LossConfig as JaxLossConfig
from diffreg_tpu.engine.losses import diffreg_loss as jax_diffreg_loss
from diffreg_tpu.engine.tester import FourDMatchTester as JaxFourDMatchTester
from diffreg_tpu.engine.tester import TestConfig as JaxTestConfig
from diffreg_tpu.engine.tester import _pair_metrics_3dmatch as jax_pair_metrics_3dmatch
from diffreg_tpu.engine.tester import make_metric_points_fn as jax_metric_points_fn
from diffreg_tpu.eval import metrics as jm
from diffreg_tpu.models import DiffusionMatchingModel as JaxModel
from diffreg_tpu.models.presets import preset_4dmatch as jax_preset_4dmatch
from diffreg_tpu.models.presets import preset_tiny as jax_preset_tiny
from diffreg_tpu.ops.select import mutual_topk_mask as jax_mutual_topk_mask
from diffreg_tpu_torch.convert import _translate, state_dict_from_flax
from diffreg_tpu_torch.data.pyramid import PyramidConfig
from diffreg_tpu_torch.data.pyramid import batch_from_samples, build_pair_pyramid
from diffreg_tpu_torch.data.synthetic import make_pair, synthetic_batch, tiny_spec
from diffreg_tpu_torch.diffusion.schedule import ddim_coefficients, make_schedule
from diffreg_tpu_torch.engine import tester as pt
from diffreg_tpu_torch.engine.losses import LossConfig, diffreg_loss
from diffreg_tpu_torch.eval import metrics as pm
from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
from diffreg_tpu_torch.models.presets import preset_4dmatch, preset_tiny

T = torch.from_numpy
B, N_POINTS, DATA_SEED, DDIM_KEY, TRAIN_KEY = 2, 96, 5, 0, 1
LOSS_KW = dict(motion_weight=0.1, dataset="4dmatch")   # configs/train/4dmatch.yaml


def _flat(tree, prefix=""):
    return {prefix + "/".join(k): np.asarray(v) for k, v in flatten_dict(dict(tree)).items()}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cut_gap(conf, src_mask, tgt_mask):
    """Soft Procrustes keeps the top max(|S|, |T|) confidences: the smallest
    gap at that cut over the pairs."""
    gaps = []
    for i in range(conf.shape[0]):
        top = np.sort(conf[i].ravel())[::-1]
        cut = int(max(src_mask[i].sum(), tgt_mask[i].sum()))
        gaps.append(top[cut - 1] - top[cut])
    return min(gaps)


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("flow_amp,scale", [(0.05, 1.0), (0.3, 1.0 / 3.0)])
def test_deformable_make_pair(flow_amp, scale):
    ref = jax_make_pair(np.random.RandomState(4), 512, deformable=True, flow_amp=flow_amp,
                        scale=scale)
    got = make_pair(np.random.RandomState(4), 512, deformable=True, flow_amp=flow_amp,
                    scale=scale)
    assert len(got) == len(ref) == 5 and got[4].shape == got[0].shape
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert make_pair(np.random.RandomState(4), 512)[4] is None


def test_pyramid_coarse_flow_and_gt_cov():
    src, tgt, rot, trn, flow = make_pair(np.random.RandomState(6), 256, deformable=True,
                                         flow_amp=0.2)
    cov = np.diag(np.arange(1, 7)).astype(np.float32)
    cfg, spec = PyramidConfig(first_subsampling_dl=0.06, coarse_match_radius=0.15), tiny_spec(256)
    got = build_pair_pyramid(src, tgt, rot, trn, cfg, spec, scene_flow=flow, gt_cov=cov)
    ref = jax_build_pair_pyramid(src, tgt, rot, trn, JaxPyramidConfig(first_subsampling_dl=0.06, coarse_match_radius=0.15),
                                 jax_tiny_spec(256), scene_flow=flow, gt_cov=cov)
    assert np.abs(got["coarse_flow"]).max() > 0.05 and got["gt_valid"].sum() > 0
    for key in ("coarse_flow", "gt_cov", "gt_src", "gt_tgt", "gt_valid", "src_mask"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_synthetic_batch_deformable():
    got, _, _ = synthetic_batch(batch_size=2, n_points=128, seed=3, deformable=True)
    ref, _, _ = jax_synthetic_batch(batch_size=2, n_points=128, seed=3, deformable=True)
    for key in ("coarse_flow", "gt_src", "gt_tgt", "gt_valid", "rot_gt", "trn_gt"):
        np.testing.assert_array_equal(_np(getattr(got, key)), np.asarray(getattr(ref, key)))
    np.testing.assert_array_equal(_np(got.points[2]), np.asarray(ref.points[2]))


def test_ddim_coefficients_sigma():
    """sigma of the stochastic update, as the JAX loop forms it in f32."""
    acp = jax_make_schedule(1000).alphas_cumprod
    sched = make_schedule(1000)
    for t, t_next in [(999, 949), (500, 450), (49, 0)]:
        a, a_next = acp[t], acp[t_next]
        sigma = np.asarray(1.0 * jnp.sqrt((1 - a / a_next) * (1 - a_next) / (1 - a)))
        sqrt_next, c, got = ddim_coefficients(sched, t, t_next, 1.0)
        np.testing.assert_allclose(got, sigma, rtol=1e-6)
        assert sqrt_next == pytest.approx(float(np.sqrt(np.asarray(a_next))), rel=1e-7)
        assert 0.0 <= c < 1.0


# ---------------------------------------------------------------- metrics


def _rotations(rng, n):
    from scipy.spatial.transform import Rotation

    rots = Rotation.random(n, random_state=rng).as_matrix().astype(np.float32)
    # each Shepperd branch: trace largest, and each diagonal entry largest
    rots[:4] = [np.eye(3), np.diag([1, -1, -1]), np.diag([-1, 1, -1]), np.diag([-1, -1, 1])]
    return rots


def _metric_case(name, rng):
    """(port result, JAX result, tolerance) of one metric on the same inputs."""
    b, c = 3, 40
    rot = _rotations(rng, b + 4)[4:]
    trn = rng.randn(b, 3, 1).astype(np.float32) * 0.1
    src = rng.rand(b, c, 3).astype(np.float32)
    flow = rng.randn(b, c, 3).astype(np.float32) * 0.02
    tgt = (src + flow) @ rot.transpose(0, 2, 1) + trn.transpose(0, 2, 1) \
        + rng.randn(b, c, 3).astype(np.float32) * 0.05
    valid = rng.rand(b, c) > 0.2
    valid[2, 2:] = False                                   # below min_matches
    if name == "matrix_to_quaternion":
        r = _rotations(rng, 12)
        return pm.matrix_to_quaternion(T(r)), jm.matrix_to_quaternion(jnp.asarray(r)), 1e-6
    if name == "inlier_ratio":
        kw = dict(inlier_thr=0.08)
        return (pm.inlier_ratio(T(src), T(tgt), T(valid), T(rot), T(trn), coarse_flow_corr=T(flow),
                                **kw),
                jax.vmap(lambda *a: jm.inlier_ratio(*a[:4], a[4][:, 0], coarse_flow_corr=a[5],
                                                    **kw))(
                    *map(jnp.asarray, (src, tgt, valid, rot, trn, flow))), 1e-6)
    if name == "masked_inlier_ratio":
        mask = rng.rand(b, c, c) > 0.97
        mask[np.arange(b)[:, None], np.arange(c), np.arange(c)] |= valid
        kw = dict(inlier_thr=0.08)
        return (pm.masked_inlier_ratio(T(mask), T(src), T(tgt), T(rot), T(trn),
                                       coarse_flow=T(flow), **kw),
                jax.vmap(lambda m, s, t, r, tr, f: jm.masked_inlier_ratio(
                    m, s, t, r, tr[:, 0], coarse_flow=f, **kw))(
                    *map(jnp.asarray, (mask, src, tgt, rot, trn, flow))), 1e-6)
    cov = rng.randn(b, 6, 6).astype(np.float32)
    cov = cov @ cov.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)
    pred_rot = np.stack([r @ _rotations(rng, 5)[4] if i else r for i, r in enumerate(rot)])
    pred_rot[1] = rot[1]                                  # near the GT pose
    pred_trn = trn + rng.randn(b, 3, 1).astype(np.float32) * 0.05
    args = (pred_rot, pred_trn, rot, trn, cov)
    if name == "transformation_error_covariance":
        return (pm.transformation_error_covariance(*map(T, args)),
                jm.transformation_error_covariance(*map(jnp.asarray, args)), 1e-5)
    if name == "registration_recall_success":
        return (pm.registration_recall_success(*map(T, args), thr=0.3),
                jm.registration_recall_success(*map(jnp.asarray, args), thr=0.3), 0)
    m, a = 60, 25
    query = rng.rand(m, 3).astype(np.float32) * 0.6
    anchors = rng.rand(a, 3).astype(np.float32) * 0.6
    motion = rng.randn(a, 3).astype(np.float32) * 0.03
    a_valid = rng.rand(a) > 0.3
    if name == "blend_anchor_motion":
        got = pm.blend_anchor_motion(T(query), T(anchors), T(motion), T(a_valid))
        ref = jm.blend_anchor_motion(*map(jnp.asarray, (query, anchors, motion, a_valid)))
        assert 0 < int(ref[1].sum()) < m                  # some queries out of range
        return torch.cat([got[0], got[1][:, None].float()], 1), \
            jnp.concatenate([ref[0], ref[1][:, None].astype(jnp.float32)], 1), 1e-6
    if name == "nfmr":
        m_flow = rng.randn(m, 3).astype(np.float32) * 0.02
        m_valid = rng.rand(m) > 0.1
        a_tgt = (anchors + motion) @ rot[0].T + trn[0].T
        args = (query, m_flow, rot[0], trn[0][:, 0], anchors, a_tgt, a_valid, m_valid)
        return (torch.stack([pm.nfmr(*map(T, args), recall_thr=thr) for thr in (0.02, 0.05)]),
                jnp.stack([jm.nfmr(*map(jnp.asarray, args), recall_thr=thr)
                           for thr in (0.02, 0.05)]), 1e-6)
    if name == "fmr_from_irs":
        irs = rng.rand(20) * 0.1
        return (torch.tensor(pm.fmr_from_irs(irs, 0.05), dtype=torch.float64),
                jm.fmr_from_irs(irs, 0.05), 0)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["matrix_to_quaternion", "inlier_ratio", "masked_inlier_ratio",
                                  "transformation_error_covariance",
                                  "registration_recall_success", "blend_anchor_motion", "nfmr",
                                  "fmr_from_irs"])
def test_metric(name, rng):
    got, ref, tol = _metric_case(name, rng)
    ref = np.asarray(ref)
    assert np.isfinite(ref).all()
    if ref.dtype == bool:
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)


# ---------------------------------------------------------------- the model


@pytest.fixture(scope="module")
def setup():
    jbatch, spec, _ = jax_synthetic_batch(batch_size=B, n_points=N_POINTS, seed=DATA_SEED,
                                          deformable=True)
    pbatch, _, _ = synthetic_batch(batch_size=B, n_points=N_POINTS, seed=DATA_SEED,
                                   deformable=True)
    model = JaxModel(jax_preset_tiny("4dmatch", sample_steps=2))
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(lambda b, r: model.init({"params": r}, b, r, mode="train"))(jbatch, rng)
    sd = state_dict_from_flax(_flat(variables["params"]), _flat(variables["buffers"]))
    return jbatch, pbatch, spec, variables, sd


def _port_model(sd):
    model = DiffusionMatchingModel(preset_tiny("4dmatch", 2), device="cpu")
    _, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected
    return model


def test_presets_match_jax():
    for got, ref in ((preset_4dmatch(20), jax_preset_4dmatch(20)),
                     (preset_tiny("4dmatch", 2), jax_preset_tiny("4dmatch", 2)),
                     (preset_tiny(3), jax_preset_tiny("3dmatch", 3))):
        assert got.variant == ref.variant and ref.stochastic_ddim == (got.variant == "4dmatch")
        assert got.sample_steps == ref.sample_steps
        assert dataclasses.asdict(got.procrustes) == dataclasses.asdict(ref.procrustes)
        for sub in ("kpfcn", "coarse_transformer", "coarse_matching"):
            g, r = getattr(got, sub), getattr(ref, sub)
            for f in dataclasses.fields(g):
                if f.name not in ("procrustes", "feature_matching"):
                    assert getattr(g, f.name) == getattr(r, f.name), (sub, f.name)
    cfg = preset_4dmatch()
    assert cfg.coarse_transformer.feature_dim // cfg.coarse_transformer.n_head == 132


def _ddim_draws(spec):
    """JAX ddim_sample's draws: x0 from split(rng)[0], step i's noise from
    fold_in(split(rng)[1], i)."""
    rng_init, rng_loop = jax.random.split(jax.random.PRNGKey(DDIM_KEY))
    shape = (B, spec.n_src, spec.n_tgt)
    x0 = np.array(jax.random.normal(rng_init, shape))
    noise = np.stack([np.array(jax.random.normal(jax.random.fold_in(rng_loop, i), shape))
                      for i in range(2)])
    return x0, noise


@pytest.fixture(scope="module")
def ddim(setup):
    """Per zero_ddim_noise: the JAX package's and the port's 4DMatch DDIM outputs."""
    jbatch, pbatch, spec, variables, sd = setup
    x0, noise = _ddim_draws(spec)
    port = _port_model(sd)
    res = {}
    for zero in (False, True):
        ref = jax.jit(lambda v, b, zero=zero: JaxModel(jax_preset_tiny("4dmatch", 2)).apply(
            v, b, jax.random.PRNGKey(DDIM_KEY), mode="ddim", zero_ddim_noise=zero))(
            variables, jbatch)
        kw = {"zero_ddim_noise": True} if zero else {"ddim_noise": T(noise)}
        res[zero] = (ref, port.ddim_sample(pbatch, T(x0), **kw))
    return res


@pytest.mark.parametrize("zero", [False, True], ids=["stochastic", "zero_ddim_noise"])
def test_ddim_sample_4dmatch(setup, ddim, zero):
    _, pbatch, _, _, _ = setup
    ref, got = ddim[zero]
    sm, tm = pbatch.src_mask.numpy(), pbatch.tgt_mask.numpy()
    valid = sm[:, :, None] & tm[:, None, :]
    conf = np.asarray(ref["conf_matrix_pred"])
    # the gated warp of every step is decided alike in both packages
    assert np.all(np.abs(got["step_condition"].numpy() - 40.0) > 1.0)
    assert _cut_gap(got["conf_matrix_pred"].numpy(), sm, tm) > 1e-6
    np.testing.assert_array_equal(got["conf_matrix_pred"].numpy()[~valid], 0.0)
    np.testing.assert_allclose(got["conf_matrix_pred"].numpy()[valid], conf[valid], rtol=1e-4,
                               atol=1e-4 * np.abs(conf).max())
    np.testing.assert_array_equal(got["corr_mask"].numpy(), np.asarray(ref["corr_mask"]))
    for name in ("rotation_pred", "translation_pred"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), atol=1e-4)


def test_ddim_noise_is_required(setup):
    _, pbatch, spec, _, sd = setup
    port = _port_model(sd)
    x0 = torch.zeros(B, spec.n_src, spec.n_tgt)
    with pytest.raises(ValueError, match="needs ddim_noise"):
        port.ddim_sample(pbatch, x0)
    with pytest.raises(ValueError, match="shape"):
        port.ddim_sample(pbatch, x0, ddim_noise=torch.zeros(3, *x0.shape))
    rigid = DiffusionMatchingModel(preset_tiny(2), device="cpu")
    with pytest.raises(ValueError, match="deterministic"):
        rigid.ddim_sample(pbatch, x0, ddim_noise=torch.zeros(2, *x0.shape))


def _train_draws(spec):
    rng_t, rng_noise, rng_pos = jax.random.split(jax.random.PRNGKey(TRAIN_KEY), 3)
    return {"t": T(np.array(jax.random.randint(rng_t, (B,), 0, 1000))),
            "g": T(np.array(jax.random.normal(rng_noise, (B, spec.n_src, spec.n_tgt)))),
            "euler": T(np.array(jax.random.uniform(rng_pos, (B, 3)) * 2.0 * jnp.pi))}


@pytest.fixture(scope="module")
def jax_train(setup):
    """JAX's 4DMatch train_forward, loss, info and the gradient of every parameter."""
    jbatch, _, _, variables, _ = setup
    model = JaxModel(jax_preset_tiny("4dmatch", 2))

    def loss_fn(params):
        out = model.apply({"params": params, "buffers": variables["buffers"]}, jbatch,
                          jax.random.PRNGKey(TRAIN_KEY), mode="train")
        loss, info = jax_diffreg_loss(out, jbatch, JaxLossConfig(**LOSS_KW))
        return loss, (info, out)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])


def test_train_forward_4dmatch(setup, jax_train):
    _, pbatch, spec, _, sd = setup
    (_, (_, ref)), _ = jax_train
    with torch.no_grad():
        got = _port_model(sd).train_forward(pbatch, **_train_draws(spec))
    sm, tm = pbatch.src_mask.numpy(), pbatch.tgt_mask.numpy()
    valid = sm[:, :, None] & tm[:, None, :]
    np.testing.assert_array_equal(got["matrix_gt"].numpy(), np.asarray(ref["matrix_gt"]))
    assert _cut_gap(got["conf_matrix_pred"].numpy(), sm, tm) > 5e-6
    for name in ("conf_matrix_pred", "conf_matrix_gt_hat"):
        conf = np.asarray(ref[name])
        np.testing.assert_allclose(got[name].numpy()[valid], conf[valid], rtol=1e-4,
                                   atol=1e-4 * np.abs(conf).max(), err_msg=name)
    for name in ("rotation_pred", "translation_pred"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), atol=1e-4)
    (layer,), (ref_layer,) = got["position_layers"], ref["position_layers"]
    assert np.all(np.abs(layer["condition"].numpy() - 40.0) > 1.0)
    np.testing.assert_array_equal(layer["solution_mask"].numpy(),
                                  np.asarray(ref_layer["solution_mask"]))


def test_loss_and_gradients_4dmatch(setup, jax_train):
    """diffreg_loss with the motion term on the 4DMatch outputs, and d loss /
    d parameter for every parameter of JAX's tree."""
    _, pbatch, spec, _, sd = setup
    (ref_loss, (ref_info, _)), grads = jax_train
    model = _port_model(sd)
    got = model.train_forward(pbatch, **_train_draws(spec))
    loss, info = diffreg_loss(got, pbatch, LossConfig(**LOSS_KW))
    assert set(info) == set(ref_info) and "l1_motion" in info
    for name, value in info.items():
        np.testing.assert_allclose(float(value.detach()), float(ref_info[name]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    loss.backward()
    params = dict(model.named_parameters())
    flat = _flat(grads)
    assert len(flat) == len(model.named_trained_parameters())
    for path, ref in flat.items():
        name, layout = _translate(path)
        ref = ref.T if layout == "T" else ref.T[:, :, None] if layout == "conv" else ref
        grad = params[name].grad
        if name.startswith("coarse_transformer.layers.2.0."):
            assert np.all(ref == 0.0) and grad is None, name
            continue
        assert grad is not None, name
        np.testing.assert_allclose(grad.numpy(), ref, rtol=0,
                                   atol=5e-4 * max(np.abs(ref).max(), 1e-12), err_msg=name)


# ---------------------------------------------------------------- testers


def _scored_outputs(rng, pbatch, jbatch, sharp):
    """Model-like outputs on the batch's coarse points: confidences peaked
    at the GT matches (plus noise), so the match extraction finds inliers."""
    coarse = np.asarray(jbatch.points[2])
    coarse = np.concatenate([coarse, np.zeros_like(coarse[:, :1])], axis=1)  # sentinel row
    rows = lambda idx: coarse[np.arange(B)[:, None], np.asarray(idx)]
    s_pcd, t_pcd = rows(jbatch.src_idx_coarse), rows(jbatch.tgt_idx_coarse)
    valid = np.asarray(jbatch.src_mask)[:, :, None] & np.asarray(jbatch.tgt_mask)[:, None, :]
    logits = rng.randn(*valid.shape).astype(np.float32) + sharp * np.asarray(jbatch.matrix_gt())
    conf = (1.0 / (1.0 + np.exp(-logits))).astype(np.float32) * valid
    corr = np.asarray(jax.vmap(lambda m: jax_mutual_topk_mask(m, 1, mutual=False))(
        jnp.asarray(conf))) & valid
    return {"s_pcd": s_pcd.astype(np.float32), "t_pcd": t_pcd.astype(np.float32),
            "conf_matrix_pred": conf, "corr_mask": corr}


def test_four_d_match_tester_metrics(setup, rng):
    """IR (GT flow) and NFMR (metric points of make_metric_points_fn) of the
    same outputs through both FourDMatchTesters."""
    jbatch, pbatch, _, _, _ = setup
    out = _scored_outputs(rng, pbatch, jbatch, sharp=4.0)
    cfg = dict(inlier_thr=0.04, match_thr=0.55, max_corr=24)
    ref_tester = JaxFourDMatchTester(None, None, JaxTestConfig(**cfg))
    ref_ir, ref_n = ref_tester._metrics({k: jnp.asarray(v) for k, v in out.items()}, jbatch)
    port_out = {k: T(v) for k, v in out.items()}
    tester = pt.FourDMatchTester(None, pt.TestConfig(**cfg), device="cpu")
    ir, n = pt.pair_metrics_4dmatch(port_out, pbatch, tester.cfg)
    assert int(n.min()) > 3 and float(ir.max()) > 0
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
    np.testing.assert_allclose(ir.numpy(), np.asarray(ref_ir), rtol=1e-6)

    meta = []
    for i in range(B):
        src = rng.rand(80, 3).astype(np.float32) * 0.5 + out["s_pcd"][i, :1]
        meta.append({"src_pcd": src, "scene_flow": rng.randn(80, 3).astype(np.float32) * 0.01,
                     "metric_index": np.arange(0, 80, 2) if i else None})
    ref = ref_tester._nfmr_for_batch({k: jnp.asarray(v) for k, v in out.items()}, jbatch, meta,
                                     jax_metric_points_fn(64))
    got = tester.nfmr_for_batch(port_out, pbatch, meta, pt.make_metric_points_fn(64))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_three_d_match_tester_metrics(rng):
    """IR, RANSAC pose, recall and n_corr of the same outputs through both
    3DMatch metric paths, RANSAC drawing JAX's numbers (split(rng, B))."""
    cov = np.diag([4.0, 4.0, 4.0, 1.0, 1.0, 1.0]).astype(np.float32)
    samples, jsamples = [], []
    rs = np.random.RandomState(8)
    for _ in range(B):
        src, tgt, rot, trn, _ = make_pair(rs, N_POINTS)
        samples.append(build_pair_pyramid(src, tgt, rot, trn, PyramidConfig(first_subsampling_dl=0.06, coarse_match_radius=0.15),
                                          tiny_spec(N_POINTS), gt_cov=cov))
        jsamples.append(jax_build_pair_pyramid(src, tgt, rot, trn,
                                               JaxPyramidConfig(first_subsampling_dl=0.06, coarse_match_radius=0.15),
                                               jax_tiny_spec(N_POINTS), gt_cov=cov))
    pbatch, jbatch = batch_from_samples(samples), jax_batch_from_samples(jsamples)
    out = _scored_outputs(rng, pbatch, jbatch, sharp=8.0)
    h = 512
    jcfg = JaxTestConfig(ransac_hypotheses=h, max_corr=64)
    key = jax.random.PRNGKey(11)
    ref = jax.jit(lambda o, b, r: jax_pair_metrics_3dmatch(o, b, jcfg, r))(
        {k: jnp.asarray(v) for k, v in out.items()}, jbatch, key)
    u = np.stack([np.asarray(jax.random.uniform(k, (h, 3))) for k in jax.random.split(key, B)])
    got = pt.pair_metrics_3dmatch({k: T(v) for k, v in out.items()}, pbatch,
                                  pt.TestConfig(ransac_hypotheses=h, max_corr=64), T(u))
    assert float(got[1].sum()) > 0                   # a registration succeeds
    for g, r, name in zip(got, ref, ("ir", "ok", "n_corr", "rotation", "translation")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5, err_msg=name)
