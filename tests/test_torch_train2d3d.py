"""The port's 2D-3D training slice against the JAX package, on the CPU, at the
size of ``tests/test_torch_2d3d.py`` (32 x 48 image, 160 points, widths
16/32/64, 2 heads): ``render``, the circle, overlap and fine losses on random
inputs, the synthetic batch with its training GT, ``DiffReg2D3D`` in
``train`` mode, ``loss_2d3d``, the gradient of the loss with respect to every
parameter, and one Adam step of ``make_train_step_2d3d`` (on a finite and on
a non-finite gradient). Weights are carried by
``convert.state_dict_2d3d_from_flax``; the train draws (timesteps and the
normal draw of the noise) are JAX's, made from its key and passed in. The
JAX value-and-grad and train step are compiled once, in a module fixture.

Tolerances: index outputs, masks and data arrays are equal; the losses on
random inputs agree to 1e-5 relative (f32 sums in another order). Through the
model: fused features to 1e-4 of their scale and confidences to 1e-5
absolute (``tests/test_torch_2d3d.py``), every loss term to 1e-5 relative,
each parameter's gradient to 5e-4 of that tensor's largest entry
(``tests/test_torch_train.py``). Adam's first step moves an entry by lr times
g / (|g| + 1e-8): the steps agree to 1e-3 of lr where the gradient is above
1e-3 of its tensor's largest entry (its sign is then the same in both), and
every step is at most lr; a NaN gradient entry is zeroed and its step is
0 in both. ``tests/test_torch_train2d3d_cli.py`` holds
``main --mode train`` against the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from diffreg_tpu.data.synthetic2d3d import synthetic_2d3d_batch as jax_synthetic_2d3d_batch
from diffreg_tpu.engine import losses2d3d as jl
from diffreg_tpu.engine.losses import LossConfig as JaxLossConfig
from diffreg_tpu.engine.train import OptimConfig as JaxOptimConfig
from diffreg_tpu.engine.train import TrainState as JaxTrainState
from diffreg_tpu.engine.train import make_optimizer as jax_make_optimizer
from diffreg_tpu.engine.train2d3d import make_train_step_2d3d as jax_make_train_step_2d3d
from diffreg_tpu.models import pipeline_2d3d as jp
from diffreg_tpu.nn import point_backbone as jpb
from diffreg_tpu.nn.matching import MatchingConfig as JaxMatchingConfig
from diffreg_tpu.ops import vision as jv
from diffreg_tpu_torch.convert import state_dict_2d3d_from_flax
from diffreg_tpu_torch.data.synthetic2d3d import synthetic_2d3d_batch
from diffreg_tpu_torch.diffusion.schedule import q_sample
from diffreg_tpu_torch.engine import losses2d3d as pl
from diffreg_tpu_torch.engine.losses import LossConfig
from diffreg_tpu_torch.engine.train import OptimConfig
from diffreg_tpu_torch.engine.train2d3d import create_train_state_2d3d, make_train_step_2d3d
from diffreg_tpu_torch.geometry.procrustes import soft_procrustes
from diffreg_tpu_torch.models import pipeline_2d3d as pp
from diffreg_tpu_torch.nn import point_backbone as ppb
from diffreg_tpu_torch.nn.matching import MatchingConfig
from diffreg_tpu_torch.ops import vision as pv

T = torch.from_numpy
B, HW, N_POINTS, DATA_SEED, TRAIN_KEY = 2, (32, 48), 160, 0, 3
FEAT_TOL, CONF_TOL, LOSS_TOL, GRAD_TOL = 1e-4, 1e-5, 1e-5, 5e-4
LR = 1e-4


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(dict(tree)).items()}


def _close(got, ref, rel, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= rel, f"{what}: {err:.3e} of the scale {scale:.3e}"


def _jax_cfg():
    return jp.Pipeline2D3DConfig(
        img_out_dim=32, img_base_dim=16,
        pcd_backbone=jpb.PointBackboneConfig(output_dim=32, init_dim=16, init_radius=0.1,
                                             init_sigma=0.08),
        hidden_dim=64, output_dim=64, num_heads=2, matching=JaxMatchingConfig(feature_dim=64),
        sample_steps=2)


def _port_cfg():
    return pp.Pipeline2D3DConfig(
        img_out_dim=32, img_base_dim=16,
        pcd_backbone=ppb.PointBackboneConfig(output_dim=32, init_dim=16, init_radius=0.1,
                                             init_sigma=0.08),
        hidden_dim=64, output_dim=64, num_heads=2, matching=MatchingConfig(feature_dim=64),
        sample_steps=2)


def _to_jax_batch(batch):
    return jp.Batch2D3D(**{k: (tuple(jnp.asarray(_np(t)) for t in v) if isinstance(v, tuple)
                               else jnp.asarray(_np(v)))
                           for k, v in vars(batch).items() if v is not None})


def _jax_draws(key, b, n, m):
    """JAX ``mode="train"``'s timesteps and normal draw from its rng."""
    rng_t, rng_n = jax.random.split(key)
    return {"t": T(np.array(jax.random.randint(rng_t, (b,), 0, 1000))),
            "noise": T(np.array(jax.random.normal(rng_n, (b, n, m))))}


def _nonfinite(batch):
    """The batch with one NaN pixel: the image features, the loss and the
    gradients turn non-finite."""
    image = batch.image.clone()
    image[0, 3, 5] = float("nan")
    return pp.Batch2D3D(**{**vars(batch), "image": image})


# ---------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def setup():
    """The same batch (with the training GT) in both packages, JAX's initial
    variables, and the port's model carrying them."""
    batch = synthetic_2d3d_batch(batch_size=B, img_hw=HW, n_points=N_POINTS, seed=DATA_SEED,
                                 with_full_gt=True)
    jbatch = _to_jax_batch(batch)
    model = jp.DiffReg2D3D(_jax_cfg())
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(lambda b, r: model.init({"params": r}, b, r, mode="train"))(jbatch, rng)
    sd = state_dict_2d3d_from_flax(_flat(variables["params"]), _flat(variables["buffers"]))
    n = batch.points[-1].shape[1]
    m = (HW[0] // 8) * (HW[1] // 8)
    return {"batch": batch, "jbatch": jbatch, "model": model, "variables": variables, "sd": sd,
            "key": jax.random.PRNGKey(TRAIN_KEY), "draws": _jax_draws(
                jax.random.PRNGKey(TRAIN_KEY), B, n, m)}


@pytest.fixture(scope="module")
def jax_run(setup):
    """One jit, called on the batch and on its non-finite twin: the outputs,
    loss and info of ``mode="train"``, the gradient of the loss with respect
    to every parameter, and the parameters and info after one step of
    ``diffreg_tpu.engine.train2d3d.make_train_step_2d3d`` (Adam, lr 1e-4)."""
    s = setup
    model, variables, key = s["model"], s["variables"], s["key"]
    circle, fine = jl.CircleLossConfig(), jl.FineLossConfig()
    ocfg = JaxOptimConfig(optimizer="adam", lr=LR)
    step = jax_make_train_step_2d3d(model, circle, JaxLossConfig(), ocfg, fine_cfg=fine)

    def run(params, opt_state, batch):
        def loss_fn(p):
            out = model.apply({"params": p, "buffers": variables["buffers"]}, batch, key,
                              mode="train")
            loss, info = jl.loss_2d3d(out, circle, JaxLossConfig(), batch=batch, fine_cfg=fine)
            return loss, (info, out)
        (loss, (info, out)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        state = JaxTrainState(params, variables["buffers"], opt_state, jnp.zeros((), jnp.int32))
        after, step_info = step(state, batch, key)
        return loss, info, out, grads, after.params, step_info

    fn = jax.jit(run)
    opt_state = jax_make_optimizer(ocfg).init(variables["params"])
    return {name: fn(variables["params"], opt_state, b)
            for name, b in (("finite", s["jbatch"]),
                            ("nonfinite", _to_jax_batch(_nonfinite(s["batch"]))))}


def _port_model(setup):
    model = pp.DiffReg2D3D(_port_cfg(), device="cpu", seed=9)
    model.load_state_dict(setup["sd"], strict=True)
    return model


@pytest.fixture(scope="module")
def port_run(setup):
    """The port's train forward, loss and gradients on JAX's weights and draws."""
    model = _port_model(setup)
    out = model.train_forward(setup["batch"], **setup["draws"])
    loss, info = pl.loss_2d3d(out, pl.CircleLossConfig(), LossConfig(), batch=setup["batch"],
                              fine_cfg=pl.FineLossConfig())
    loss.backward()
    return model, out, loss, info


# ---------------------------------------------------------------- ops and losses


def test_render(rng):
    """Camera-frame points to unrounded pixels (the JAX render with
    ``rounding=False``, as the fine loss calls it)."""
    pts = (rng.rand(50, 3) * [2.0, 2.0, 3.0] - [1.0, 1.0, 0.5]).astype(np.float32)
    pts[:3, 2] = [0.0, -0.2, 1e-7]                     # on and behind the camera plane
    k = np.array([[60.0, 0, 24.3], [0, 58.0, 15.7], [0, 0, 1]], np.float32)
    got = pv.render(T(pts), T(k))
    ref = jv.render(jnp.asarray(pts), jnp.asarray(k), rounding=False)
    _close(got[0], ref[0], 1e-6, "pixels")
    _close(got[1], ref[1], 1e-6, "depth")
    np.testing.assert_array_equal(_np(got[2]), np.asarray(ref[2]))
    assert not bool(got[2].all())


def _overlap_lists(rng, n, m, q):
    """Padded (node, patch, min overlap, valid) lists without repeated pairs."""
    flat = rng.choice(n * m, q, replace=False)
    ov = rng.rand(B, q).astype(np.float32)
    valid = rng.rand(B, q) > 0.3
    src = np.stack([flat // m, np.roll(flat, 3) // m]).astype(np.int32)
    tgt = np.stack([flat % m, np.roll(flat, 3) % m]).astype(np.int32)
    return src, tgt, ov, valid


@pytest.mark.parametrize("scaled", [False, True])
def test_circle_loss_overlaps_and_masks(rng, scaled):
    """``scatter_overlaps``, ``overlap_masks``, ``normalized_feat_dists`` and
    ``circle_loss`` on random inputs; some rows and columns have no positive
    or no negative, some are invalid: they take no part."""
    n, m, q = 14, 11, 40
    src, tgt, ov, valid = _overlap_lists(rng, n, m, q)
    got_ov = pl.scatter_overlaps(*map(T, (src, tgt, ov, valid)), n, m)
    ref_ov = jl.scatter_overlaps(*map(jnp.asarray, (src, tgt, ov, valid)), n, m)
    np.testing.assert_array_equal(_np(got_ov), np.asarray(ref_ov))
    cfg = jl.CircleLossConfig()
    got_masks = pl.overlap_masks(got_ov, pl.CircleLossConfig())
    ref_masks = jl.overlap_masks(ref_ov, cfg)
    for g, r in zip(got_masks, ref_masks):
        np.testing.assert_array_equal(_np(g), np.asarray(r))
    a, b = rng.randn(B, n, 8).astype(np.float32), rng.randn(B, m, 8).astype(np.float32)
    got_d = pl.normalized_feat_dists(T(a), T(b))
    ref_d = jax.vmap(jl.normalized_feat_dists)(jnp.asarray(a), jnp.asarray(b))
    _close(got_d, ref_d, 1e-6, "normalized_feat_dists")
    row_valid, col_valid = rng.rand(B, n) > 0.2, rng.rand(B, m) > 0.2
    pos, neg, scales = (_np(x) for x in got_masks)
    neg[:, :3] = False                                 # rows without a negative
    neg[:, :, :2] = False
    assert ((pos.sum(-1) == 0) & (neg.sum(-1) > 0)).any()      # rows without a positive
    d = np.asarray(ref_d)
    ref = jax.vmap(lambda d, p, ng, s, rv, cv: jl.circle_loss(
        d, p, ng, cfg, s if scaled else None, rv, cv))(
        *map(jnp.asarray, (d, pos, neg, scales, row_valid, col_valid)))
    got = pl.circle_loss(T(d), T(pos), T(neg), pl.CircleLossConfig(),
                         T(scales) if scaled else None, T(row_valid), T(col_valid))
    _close(got, ref, LOSS_TOL, "circle loss")
    assert float(got.min()) > 0


def test_fine_matching_loss(rng):
    """The fine circle loss and its recall on random pairs, some invalid; the
    feature-nearest column of one row ties (the lower index wins)."""
    f = 24
    img_pts = rng.rand(B, f, 3).astype(np.float32) * 0.2
    pcd_pts = img_pts + rng.randn(B, f, 3).astype(np.float32) * 0.03
    img_pix = rng.rand(B, f, 2).astype(np.float32) * 20
    pcd_pix = img_pix + rng.randn(B, f, 2).astype(np.float32) * 6
    img_f = rng.randn(B, f, 8).astype(np.float32)
    pcd_f = img_f + rng.randn(B, f, 8).astype(np.float32) * 0.8
    pcd_f[:, 5] = pcd_f[:, 4]                           # a tie for the nearest feature
    valid = np.arange(f)[None].repeat(B, 0) < np.array([[f], [f - 5]])
    args = (img_f, img_pts, img_pix, pcd_f, pcd_pts, pcd_pix, valid)
    got = pl.fine_matching_loss(*map(T, args), pl.FineLossConfig())
    ref = jax.vmap(lambda *a: jl.fine_matching_loss(*a, jl.FineLossConfig()))(
        *map(jnp.asarray, args))
    _close(got[0], ref[0], LOSS_TOL, "fine loss")
    np.testing.assert_array_equal(_np(got[1]), np.asarray(ref[1]))
    assert 0 < float(got[1].max()) < 1


def test_synthetic_2d3d_batch_with_full_gt():
    got = synthetic_2d3d_batch(batch_size=2, img_hw=(32, 48), n_points=160, seed=4,
                               with_full_gt=True, n_overlap=64, n_fine_gt=48)
    ref = jax_synthetic_2d3d_batch(batch_size=2, img_hw=(32, 48), n_points=160, seed=4,
                                   with_full_gt=True, n_overlap=64, n_fine_gt=48)
    for name, val in vars(got).items():
        rval = getattr(ref, name)
        if val is None:
            assert rval is None, name
            continue
        for a, b in (zip(val, rval) if isinstance(val, tuple) else [(val, rval)]):
            np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=name)
    assert int(got.ov_valid.sum()) > 0 and int(got.fine_valid.sum()) > 0


# ---------------------------------------------------------------- the model


def _valid(out):
    return _np(out["node_masks"])[:, :, None] & _np(out["img_valid_c"])[:, None, :]


def test_train_forward(setup, jax_run, port_run):
    """``mode="train"`` on JAX's weights and draws: the GT matrix and the
    timesteps equal, confidences and fused coarse features within the 2D-3D
    forward tolerances; the noisy matrix's soft-Procrustes cut lies in a gap
    wider than the packages' differences."""
    model, got, _, _ = port_run
    ref = jax_run["finite"][2]
    for key in ("timesteps", "matrix_gt", "node_masks", "img_valid_c"):
        np.testing.assert_array_equal(_np(got[key]), np.asarray(ref[key]), err_msg=key)
    assert float(got["matrix_gt"].sum()) > 0
    valid = _valid(ref)
    for key in ("conf_matrix_pred", "conf_matrix_gt_hat"):
        err = np.abs(_np(got[key]) - np.asarray(ref[key]))[valid].max()
        assert err <= CONF_TOL, (key, err)
    for key, mask in (("pcd_feats_c", _np(setup["batch"].masks[-1])), ("img_feats_c", None)):
        g, r = _np(got[key]), np.asarray(ref[key])
        _close(g[mask] if mask is not None else g, r[mask] if mask is not None else r,
               FEAT_TOL, key)
    # the warp's top-k cut (max of the masks' lengths, per pair)
    batch = setup["batch"]
    with torch.no_grad():
        x = q_sample(model.schedule, got["matrix_gt"], got["timesteps"],
                        setup["draws"]["noise"])
        conf = model.denoising_coarse_matching.sinkhorn(
            x, got["node_masks"], got["img_valid_c"], batch.masks[-1],
            torch.ones_like(got["img_valid_c"]))
        res = soft_procrustes(conf, got["nodes"], got["patch_centers"], got["node_masks"],
                              got["img_valid_c"], max_condition_num=200.0,
                              use_masked_lengths=True)
    for i in range(B):
        top = np.sort(_np(conf[i]).ravel())[::-1]
        cut = int(max(got["node_masks"][i].sum(), got["img_valid_c"][i].sum()))
        assert top[cut - 1] - top[cut] > 1e-6
    assert np.all(np.abs(_np(res.condition) - 200.0) > 10.0)


def test_loss_2d3d(jax_run, port_run):
    """Every term, and the total: circle + gt_hat + fine (the focal loss on
    the coarse confidences is logged only)."""
    _, _, loss, info = port_run
    ref_loss, ref_info = jax_run["finite"][:2]
    assert set(info) == set(ref_info) == {"circle", "focal", "gt_hat", "fine", "fine_recall",
                                          "loss"}
    for key, val in ref_info.items():
        np.testing.assert_allclose(float(info[key]), float(val), rtol=LOSS_TOL, err_msg=key)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(loss), float(info["circle"] + info["gt_hat"] + info["fine"]),
                               rtol=1e-6)
    assert 0 < float(info["fine_recall"]) <= 1


def test_loss_2d3d_on_the_binary_gt(rng):
    """Without overlap pairs or fine GT in the batch the binary GT matrix
    stands in for the overlaps, and there is no fine term."""
    n, m = 12, 9
    gt = (rng.rand(B, n, m) > 0.85).astype(np.float32)
    outputs = {"matrix_gt": gt, "node_masks": rng.rand(B, n) > 0.2,
               "img_valid_c": rng.rand(B, m) > 0.1,
               "pcd_feats_c": rng.randn(B, n, 16).astype(np.float32),
               "img_feats_c": rng.randn(B, m, 16).astype(np.float32),
               "conf_matrix_pred": rng.rand(B, n, m).astype(np.float32),
               "conf_matrix_gt_hat": rng.rand(B, n, m).astype(np.float32)}
    ref_loss, ref_info = jl.loss_2d3d({k: jnp.asarray(v) for k, v in outputs.items()},
                                      jl.CircleLossConfig(), JaxLossConfig())
    loss, info = pl.loss_2d3d({k: T(v) for k, v in outputs.items()}, pl.CircleLossConfig(),
                              LossConfig())
    assert set(info) == set(ref_info) == {"circle", "focal", "gt_hat", "loss"}
    for key, val in ref_info.items():
        np.testing.assert_allclose(float(info[key]), float(val), rtol=LOSS_TOL, err_msg=key)


def test_gradients_match_jax(jax_run, port_run):
    """d loss / d parameter for every parameter of JAX's tree. The coarse
    matcher feeds only the logged focal loss: its gradient is zero in JAX and
    absent (None) in the port."""
    params = dict(port_run[0].named_parameters())
    ref_grads = state_dict_2d3d_from_flax(_flat(jax_run["finite"][3]), {})
    assert set(ref_grads) == set(params)
    largest = max(float(g.abs().max()) for g in ref_grads.values())
    for name, ref in ref_grads.items():
        grad = params[name].grad
        if name.startswith("coarse_matching."):
            assert grad is None and not ref.any(), name
            continue
        assert grad is not None and float(ref.abs().max()) > 0, name
        if name.endswith("k_token_layer.bias"):
            # softmax ignores a key bias: its gradient is rounding in both
            assert max(float(ref.abs().max()), float(grad.abs().max())) < 1e-8 * largest, name
            continue
        np.testing.assert_allclose(_np(grad), _np(ref), rtol=0,
                                   atol=GRAD_TOL * float(ref.abs().max()), err_msg=name)


@pytest.mark.parametrize("case", ["finite", "nonfinite"])
def test_adam_step_matches_jax(setup, jax_run, case):
    """One step of ``make_train_step_2d3d`` (Adam, lr 1e-4) against the JAX
    package's: the info, and the parameters after it. On a non-finite
    gradient both report ``grads_finite`` False and, unlike the 3D steps, do
    not skip the step: the NaN entries are zeroed (optax.zero_nans) and the
    update is applied (a zeroed entry does not move)."""
    batch = setup["batch"] if case == "finite" else _nonfinite(setup["batch"])
    model = _port_model(setup)
    state = create_train_state_2d3d(model, OptimConfig(optimizer="adam", lr=LR))
    step = make_train_step_2d3d(pl.CircleLossConfig(), LossConfig(), pl.FineLossConfig())
    state, info = step(state, batch, setup["draws"])
    _, _, _, grads, ref_params, ref_info = jax_run[case]
    assert bool(info["grads_finite"]) == bool(ref_info["grads_finite"]) == (case == "finite"), \
        (bool(info["grads_finite"]), bool(ref_info["grads_finite"]))
    assert np.isfinite(float(info["loss"])) == np.isfinite(float(ref_info["loss"]))
    assert state.optimizer.count == 1
    if case == "finite":
        np.testing.assert_allclose(float(info["loss"]), float(ref_info["loss"]), rtol=LOSS_TOL)
    params = dict(model.named_parameters())
    before = setup["sd"]
    ref_grads = state_dict_2d3d_from_flax(_flat(grads), {})
    n_clear = n_all = n_nan = 0
    for name, after in state_dict_2d3d_from_flax(_flat(ref_params), {}).items():
        ref_step = _np(after) - _np(before[name])
        got_step = _np(params[name]) - _np(before[name])
        assert np.abs(got_step).max() <= LR * (1 + 1e-3), name
        g = np.abs(_np(ref_grads[name]))
        nan = np.isnan(g)
        n_nan += int(nan.sum())
        np.testing.assert_array_equal(got_step[nan], ref_step[nan], err_msg=name)
        assert not ref_step[nan].any(), name
        # |g| > 1e-4 = 1e4 eps: Adam's step is lr (1 - 1e-4) sign(g) or more
        g = np.where(nan, 0.0, g)
        clear = (g > 1e-3 * g.max()) & (g > 1e-4)
        n_clear += int(clear.sum())
        n_all += g.size
        np.testing.assert_allclose(got_step[clear], ref_step[clear], rtol=0, atol=1e-3 * LR,
                                   err_msg=name)
    assert (n_nan > 0) == (case == "nonfinite")
    assert n_clear > 0.5 * n_all or case == "nonfinite"
