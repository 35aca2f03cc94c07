"""The port's training slice against the JAX package at ``preset_tiny``, on the
CPU: the GT matrix and the noise, the positioning layer, ``backbone_forward``,
``train_forward``, ``diffreg_loss`` and the gradient of the loss with respect
to every parameter, with the same weights (``diffreg_tpu_torch.convert``) and
the same random draws (JAX's, split from its ``rng`` as ``train_forward``
splits it).

Tolerances: the backbone's features agree to about 1e-4 (13 normalised
blocks summed in another order, ``tests/test_torch_model.py``), so the
confidences downstream are held to 1e-4 of their scale, poses to 1e-4, and
each parameter's gradient to 5e-4 of that tensor's largest entry (measured
5e-5). The JAX train step is compiled once, in a module-scoped fixture.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from diffreg_tpu.data import synthetic_batch as jax_synthetic_batch
from diffreg_tpu.diffusion.schedule import make_schedule as jax_make_schedule
from diffreg_tpu.diffusion.schedule import q_sample as jax_q_sample
from diffreg_tpu.diffusion.schedule import signed_fractional_noise as jax_sfn
from diffreg_tpu.engine.losses import LossConfig as JaxLossConfig
from diffreg_tpu.geometry.procrustes import soft_procrustes as jax_soft_procrustes
from diffreg_tpu.engine.losses import diffreg_loss as jax_diffreg_loss
from diffreg_tpu.models import DiffusionMatchingModel as JaxModel
from diffreg_tpu.models.presets import preset_tiny as jax_preset_tiny
from diffreg_tpu.nn.transformer import RepositioningTransformer as JaxTransformer
from diffreg_tpu.ops.position_encoding import volumetric_pe as jax_volumetric_pe
from diffreg_tpu_torch.convert import _translate, state_dict_from_flax
from diffreg_tpu_torch.data.synthetic import synthetic_batch
from diffreg_tpu_torch.diffusion.schedule import make_schedule, q_sample, signed_fractional_noise
from diffreg_tpu_torch.engine.losses import LossConfig, diffreg_loss
from diffreg_tpu_torch.geometry.procrustes import soft_procrustes
from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel, masked_min
from diffreg_tpu_torch.models.presets import preset_tiny, with_condition_gate
from diffreg_tpu_torch.nn.transformer import RepositioningTransformer
from diffreg_tpu_torch.ops.position_encoding import volumetric_pe

T = torch.from_numpy
B, N_POINTS, DATA_SEED, TRAIN_KEY = 2, 96, 2, 1
GATES = (0.0, 200.0)


def _flat(tree, prefix=""):
    return {prefix + "/".join(k): np.asarray(v) for k, v in flatten_dict(dict(tree)).items()}


def _jax_cfg(gate):
    cfg = jax_preset_tiny("3dmatch", sample_steps=2)
    proc = dataclasses.replace(cfg.procrustes, max_condition_num=gate)
    return dataclasses.replace(cfg, procrustes=proc, coarse_transformer=dataclasses.replace(
        cfg.coarse_transformer, procrustes=proc))


def _train_draws(key, spec):
    """JAX train_forward's t, g and Euler angles from its rng split."""
    rng_t, rng_noise, rng_pos = jax.random.split(key, 3)
    return {"t": T(np.array(jax.random.randint(rng_t, (B,), 0, 1000))),
            "g": T(np.array(jax.random.normal(rng_noise, (B, spec.n_src, spec.n_tgt)))),
            "euler": T(np.array(jax.random.uniform(rng_pos, (B, 3)) * 2.0 * jnp.pi))}


@pytest.fixture(scope="module")
def setup():
    jbatch, spec, _ = jax_synthetic_batch(batch_size=B, n_points=N_POINTS, seed=DATA_SEED)
    pbatch, _, _ = synthetic_batch(batch_size=B, n_points=N_POINTS, seed=DATA_SEED)
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(lambda b, r: JaxModel(_jax_cfg(0.0)).init(
        {"params": r}, b, r, mode="train"))(jbatch, rng)
    sd = state_dict_from_flax(_flat(variables["params"]), _flat(variables["buffers"]))
    return jbatch, pbatch, spec, variables, sd


@pytest.fixture(scope="module")
def jax_train(setup):
    """Per gate: JAX's train_forward outputs, loss and info; at gate 200 also
    the gradient of the loss with respect to every parameter (one jax.grad)."""
    jbatch, _, _, variables, _ = setup
    key = jax.random.PRNGKey(TRAIN_KEY)
    results = {}
    for gate in GATES:
        model = JaxModel(_jax_cfg(gate))

        def loss_fn(params, model=model):
            out = model.apply({"params": params, "buffers": variables["buffers"]}, jbatch,
                              key, mode="train")
            loss, info = jax_diffreg_loss(out, jbatch, JaxLossConfig())
            return loss, (info, out)

        if gate > 0:
            (loss, (info, out)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                variables["params"])
        else:
            (loss, (info, out)), grads = jax.jit(loss_fn)(variables["params"]), None
        results[gate] = (loss, info, out, grads)
    return key, results


def _port_model(sd, gate):
    model = DiffusionMatchingModel(with_condition_gate(preset_tiny(2), gate), device="cpu")
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected
    trained = {n for n, _ in model.named_trained_parameters()}
    assert not trained & set(missing)    # the fine phase only is absent from JAX's tree
    return model


def _assert_cut_gap(conf, src_mask, tgt_mask):
    """Soft Procrustes keeps the top max(|S|, |T|) confidences; the seeds put
    the cut in a gap wider than the packages' ~1e-6 differences."""
    for i in range(conf.shape[0]):
        top = np.sort(conf[i].ravel())[::-1]
        cut = int(max(src_mask[i].sum(), tgt_mask[i].sum()))
        assert top[cut - 1] - top[cut] > 5e-6


def test_matrix_gt(setup):
    jbatch, pbatch, _, _, _ = setup
    got = pbatch.matrix_gt()
    assert got.dtype == torch.float32 and got.sum() > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbatch.matrix_gt()))


def test_q_sample_and_noise_on_jax_draws(rng):
    key = jax.random.PRNGKey(5)
    shape = (B, 30, 34)
    g = np.array(jax.random.normal(key, shape))
    ref_noise = np.asarray(jax_sfn(key, shape))
    noise = signed_fractional_noise(T(g))
    np.testing.assert_array_equal(noise.numpy(), ref_noise)
    x0 = (rng.rand(*shape) > 0.9).astype(np.float32)
    t = np.array([0, 731], np.int32)
    ref = jax_q_sample(jax_make_schedule(1000), jnp.asarray(x0), jnp.asarray(t),
                       jnp.asarray(ref_noise))
    got = q_sample(make_schedule(1000), T(x0), T(t), noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("positioning", ["procrustes", "randSO3", "oracle"])
def test_positioning_layer(rng, positioning):
    """The coarse transformer with its positioning layer against the JAX
    RepositioningTransformer, aux included (gate 200: the warp is live)."""
    b, s, t, d = 2, 40, 36, 48
    cfg = dataclasses.replace(_jax_cfg(200.0).coarse_transformer, positioning_type=positioning)
    sf, tf = rng.randn(b, s, d).astype(np.float32), rng.randn(b, t, d).astype(np.float32)
    rot = np.stack([np.float32([[0.96, -0.28, 0], [0.28, 0.96, 0], [0, 0, 1]])] * b)
    trn = rng.randn(b, 3, 1).astype(np.float32) * 0.1
    s_pcd = rng.rand(b, s, 3).astype(np.float32)
    t_pcd = (s_pcd[:, :t] + rng.randn(b, t, 3).astype(np.float32) * 0.02) @ rot[0].T \
        + trn.transpose(0, 2, 1)
    sm = np.arange(s)[None] < np.array([[s], [s - 7]])
    tm = np.arange(t)[None] < np.array([[t - 2], [t - 5]])
    key = jax.random.PRNGKey(3)
    args = tuple(map(jnp.asarray, (sf, tf, s_pcd, t_pcd, sm, tm)))
    layer = JaxTransformer(cfg)
    params = layer.init(key, *args, rot_gt=rot, trn_gt=trn, rng=key)["params"]
    ref = layer.apply({"params": params}, *args, rot_gt=rot, trn_gt=trn, rng=key)
    sd = state_dict_from_flax(_flat(params, "coarse_transformer/"), {})
    port = RepositioningTransformer(dataclasses.replace(
        with_condition_gate(preset_tiny(2), 200.0).coarse_transformer,
        positioning_type=positioning))
    port.load_state_dict({k.split("coarse_transformer.")[1]: v for k, v in sd.items()})
    euler = T(np.array(jax.random.uniform(key, (b, 3)) * 2.0 * jnp.pi))
    with torch.no_grad():
        got = port(*map(T, (sf, tf, s_pcd, t_pcd, sm, tm)), rot_gt=T(rot), trn_gt=T(trn),
                   euler=euler)
    for g, r, mask in zip(got[:2], ref[:2], (sm, tm)):
        np.testing.assert_allclose(g.numpy()[mask], np.asarray(r)[mask], rtol=1e-4, atol=1e-4)
    for g, r in zip(got[2:4], ref[2:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    layers, ref_layers = got[4]["position_layers"], ref[4]["position_layers"]
    assert len(layers) == len(ref_layers) == (positioning == "procrustes")
    for g, r in zip(layers, ref_layers):
        valid = sm[:, :, None] & tm[:, None, :]
        np.testing.assert_allclose(g["conf_matrix"].numpy()[valid],
                                   np.asarray(r["conf_matrix"])[valid], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(g["match_mask"].numpy()[valid],
                                      np.asarray(r["match_mask"])[valid])
        _assert_cut_gap(g["conf_matrix"].numpy(), sm, tm)
        # conditions far from the gate: both packages accept or reject alike
        assert np.all(np.abs(g["condition"].numpy() - 200.0) > 10.0)
        np.testing.assert_array_equal(g["solution_mask"].numpy(), np.asarray(r["solution_mask"]))
        for name in ("rotation", "translation"):
            np.testing.assert_allclose(g[name].numpy(), np.asarray(r[name]), atol=1e-4)


@pytest.mark.parametrize("gate", GATES)
def test_backbone_forward(setup, gate):
    jbatch, pbatch, _, variables, sd = setup
    ref = jax.jit(lambda v, b: JaxModel(_jax_cfg(gate)).apply(
        v, b, jax.random.PRNGKey(0), mode="backbone"))(variables, jbatch)
    with torch.no_grad():
        got = _port_model(sd, gate).backbone_forward(pbatch)
    sm, tm = pbatch.src_mask.numpy(), pbatch.tgt_mask.numpy()
    valid = sm[:, :, None] & tm[:, None, :]
    conf = np.asarray(ref["conf_matrix_pred"])
    _assert_cut_gap(got["conf_matrix_pred"].numpy(), sm, tm)
    np.testing.assert_allclose(got["conf_matrix_pred"].numpy()[valid], conf[valid], rtol=1e-4,
                               atol=1e-4 * np.abs(conf).max())
    np.testing.assert_array_equal(got["corr_mask"].numpy()[valid],
                                  np.asarray(ref["corr_mask"])[valid])
    for name in ("rotation_pred", "translation_pred"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), atol=1e-4)


def _port_train_forward(setup, jax_train, gate, grad=False):
    _, pbatch, spec, _, sd = setup
    key, _ = jax_train
    model = _port_model(sd, gate)
    with torch.set_grad_enabled(grad):
        out = model.train_forward(pbatch, **_train_draws(key, spec))
    return model, out


@pytest.mark.parametrize("gate", GATES)
def test_train_forward(setup, jax_train, gate):
    _, pbatch, spec, _, _ = setup
    ref = jax_train[1][gate][2]
    model, got = _port_train_forward(setup, jax_train, gate)
    sm, tm = pbatch.src_mask.numpy(), pbatch.tgt_mask.numpy()
    valid = sm[:, :, None] & tm[:, None, :]
    np.testing.assert_array_equal(got["timesteps"].numpy(), np.asarray(ref["timesteps"]))
    np.testing.assert_array_equal(got["matrix_gt"].numpy(), np.asarray(ref["matrix_gt"]))
    for name in ("conf_matrix_pred", "conf_matrix_gt_hat"):
        conf = np.asarray(ref[name])
        np.testing.assert_allclose(got[name].numpy()[valid], conf[valid], rtol=1e-4,
                                   atol=1e-4 * np.abs(conf).max(), err_msg=name)
    for name in ("match_mask_pred", "match_mask_gt_hat"):
        np.testing.assert_array_equal(got[name].numpy()[valid], np.asarray(ref[name])[valid])
    _assert_cut_gap(got["conf_matrix_pred"].numpy(), sm, tm)
    for name in ("rotation_pred", "translation_pred"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), atol=1e-4)
    (layer,), (ref_layer,) = got["position_layers"], ref["position_layers"]
    _assert_cut_gap(layer["conf_matrix"].numpy(), sm, tm)
    np.testing.assert_array_equal(layer["solution_mask"].numpy(),
                                  np.asarray(ref_layer["solution_mask"]))
    for name in ("rotation", "translation"):
        np.testing.assert_allclose(layer[name].numpy(), np.asarray(ref_layer[name]), atol=1e-4)
    if gate > 0:
        assert np.all(np.abs(layer["condition"].numpy() - gate) > 10.0)
        # the gated warp from the noisy GT matrix: a wide cut gap and conditions
        # far from the gate, so both packages warp alike
        s_pcd, t_pcd = got["s_pcd"], got["t_pcd"]
        noisy = q_sample(model.schedule, got["matrix_gt"], got["timesteps"],
                         signed_fractional_noise(_train_draws(jax_train[0], spec)["g"]))
        noisy = noisy - masked_min(noisy, pbatch.src_mask, pbatch.tgt_mask)
        with torch.no_grad():
            conf = model.denoising_coarse_matching.sinkhorn(noisy, pbatch.src_mask,
                                                            pbatch.tgt_mask)
            res = model._pose(conf, s_pcd, t_pcd, pbatch.src_mask, pbatch.tgt_mask)
        _assert_cut_gap(conf.numpy(), sm, tm)
        assert np.all(np.abs(res.condition.numpy() - gate) > 10.0)


@pytest.mark.parametrize("gate", GATES)
def test_diffreg_loss_on_train_forward(setup, jax_train, gate):
    _, pbatch, _, _, _ = setup
    ref_loss, ref_info = jax_train[1][gate][:2]
    _, got = _port_train_forward(setup, jax_train, gate)
    loss, info = diffreg_loss(got, pbatch, LossConfig())
    assert set(info) == set(ref_info)
    for name, value in info.items():
        np.testing.assert_allclose(float(value), float(ref_info[name]), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)


@pytest.mark.parametrize("case", ["default", "motion", "no_positives", "dual_softmax"])
def test_diffreg_loss_cases(rng, case):
    """The loss's terms and corner cases on the same random inputs."""
    b, s, t = 2, 20, 24
    sm = np.arange(s)[None] < np.array([[s], [s - 6]])
    tm = np.arange(t)[None] < np.array([[t - 3], [t]])
    gt = np.zeros((b, s, t), np.float32)
    if case != "no_positives":
        for i in range(b):
            gt[i, rng.choice(s - 6, 8, replace=False), rng.choice(t - 3, 8, replace=False)] = 1.0
    mask = lambda: rng.rand(b, s, t) > 0.9
    outputs = {"matrix_gt": gt, "conf_matrix_pred": rng.rand(b, s, t).astype(np.float32),
               "conf_matrix_gt_hat": rng.rand(b, s, t).astype(np.float32),
               "match_mask_pred": mask() | (gt > 0) & (rng.rand(b, s, t) > 0.5),
               "s_pcd": rng.randn(b, s, 3).astype(np.float32),
               "rotation_pred": np.stack([np.eye(3, dtype=np.float32)] * b),
               "translation_pred": rng.randn(b, 3, 1).astype(np.float32) * 0.1}
    batch = {"src_mask": sm, "tgt_mask": tm,
             "rot_gt": np.stack([np.eye(3, dtype=np.float32)] * b),
             "trn_gt": rng.randn(b, 3, 1).astype(np.float32) * 0.1,
             "coarse_flow": np.zeros((b, s, 3), np.float32)}
    kw = {"motion": {"motion_weight": 1.0}, "dual_softmax": {"match_type": "dual_softmax"}}
    kw = kw.get(case, {})
    ref_loss, ref_info = jax_diffreg_loss(
        {k: jnp.asarray(v) for k, v in outputs.items()},
        types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in batch.items()}),
        JaxLossConfig(**kw))
    loss, info = diffreg_loss({k: T(v) for k, v in outputs.items()},
                              types.SimpleNamespace(**{k: T(v) for k, v in batch.items()}),
                              LossConfig(**kw))
    assert set(info) == set(ref_info)
    for name, value in info.items():
        np.testing.assert_allclose(float(value), float(ref_info[name]), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)


def test_gradients_match_jax(setup, jax_train):
    """d loss / d parameter for every parameter of JAX's tree, at gate 200.
    The positioning layer's matcher feeds only the detached position code:
    its gradient is zero in JAX and absent (None) in the port."""
    _, pbatch, _, variables, _ = setup
    grads = jax_train[1][200.0][3]
    model, got = _port_train_forward(setup, jax_train, 200.0, grad=True)
    diffreg_loss(got, pbatch, LossConfig())[0].backward()
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
        assert grad is not None and np.abs(ref).max() > 0, name
        np.testing.assert_allclose(grad.numpy(), ref, rtol=0,
                                   atol=5e-4 * np.abs(ref).max(), err_msg=name)


def test_volumetric_pe_is_detached(rng):
    xyz = T((rng.rand(2, 10, 3) * 2 - 1).astype(np.float32)).requires_grad_(True)
    code = volumetric_pe(xyz, 48, (-3.6, -2.4, 1.14), 0.08)
    assert code.grad_fn is None and not code.requires_grad
    ref = jax_volumetric_pe(jnp.asarray(xyz.detach().numpy()), 48, (-3.6, -2.4, 1.14), 0.08,
                            "rotary")
    np.testing.assert_allclose(code.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_soft_procrustes_falls_back_on_nonfinite_confidences(rng):
    """A NaN confidence (a NaN batch in training) gives the identity pose with
    condition 0, as JAX's eigh of a NaN matrix does, instead of an error."""
    b, n, m = 2, 16, 18
    conf = rng.rand(b, n, m).astype(np.float32) ** 6
    conf[0, 3, 4] = np.nan
    s_pcd, t_pcd = rng.randn(b, n, 3).astype(np.float32), rng.randn(b, m, 3).astype(np.float32)
    sm, tm = np.ones((b, n), bool), np.ones((b, m), bool)
    kw = dict(sample_rate=1.0, max_condition_num=200.0, use_masked_lengths=True)
    ref = jax_soft_procrustes(*map(jnp.asarray, (conf, s_pcd, t_pcd, sm, tm)), **kw)
    got = soft_procrustes(*map(T, (conf, s_pcd, t_pcd, sm, tm)), **kw)
    np.testing.assert_array_equal(got.rotation[0].numpy(), np.eye(3, dtype=np.float32))
    assert float(got.condition[0]) == 0.0 and bool(got.solution_mask[0])
    for name in ("rotation", "translation", "rotation_fwd", "translation_fwd"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=2e-5, err_msg=name)
    np.testing.assert_array_equal(got.solution_mask.numpy(), np.asarray(ref.solution_mask))
