"""The port at every shape the two TPU kernels take, against the JAX package,
on the CPU: KPConv at kernel-point counts other than 15, attention at head
widths that are not multiples of 4 or lie above the Hopper kernel's tuned
instances (136 in f32, 144 in bf16), the 2D-3D point backbone at 7 kernel
points, and ``preset_tiny`` with 7 kernel points and 3 or 1 attention heads
through the DDIM and one train step. On the card these shapes take the
kernels' any-P and any-D routes; here the plain versions, which the card's
kernels are held against (``chip_smoke.py`` phase 23).

Inputs are drawn with numpy from a seed; weights are carried by
``diffreg_tpu_torch.convert`` (the whole path's from the port's model into
JAX's, through the bridge's translation backwards). The Pallas kernels run as the JAX package's
own tests run them on the CPU: attention in interpret mode, KPConv through
its plain reference (``_xla_post_gather``, the kernel's XLA twin).

Tolerances: KPConv and f32 attention rtol 1e-5 with atol 1e-5 (KPConv) and
2e-5 (attention); bf16 attention at ``tests/test_torch_bf16.py``'s limits
(the Pallas kernel rounds elsewhere: 8e-3 worst and 1e-3 mean of the largest
entry; JAX's XLA bf16 path written out in jnp: equal but for single
rounding flips, each one bf16 ulp of its entry, where the two f32 sums of a
logit's 528 products end in another bit); the point backbone's
features 1e-5 of their largest; the whole path at
``tests/test_torch_variants.py``'s (confidences 1e-5 of the largest and rtol
1e-5, the union mask equal, poses 1e-4; the loss 1e-5 relative, each
gradient 1e-4 of its tensor's largest entry).
"""
import torch_native_guard  # noqa: F401  (makes the JAX native library whole first)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from diffreg_tpu.data import synthetic_batch as jax_synthetic_batch
from diffreg_tpu.engine.losses import LossConfig as JaxLossConfig
from diffreg_tpu.engine.losses import diffreg_loss as jax_diffreg_loss
from diffreg_tpu.models import DiffusionMatchingModel as JaxModel
from diffreg_tpu.models.presets import preset_tiny as jax_preset_tiny
from diffreg_tpu.nn import point_backbone as jpb
from diffreg_tpu.ops.kpconv import kpconv_batched as jax_kpconv_batched
from diffreg_tpu.ops.pallas.attention_kernel import masked_attention_pallas
from diffreg_tpu.ops.pallas.kpconv_kernel import _xla_post_gather
from diffreg_tpu_torch.convert import _translate, _translate_2d3d
from diffreg_tpu_torch.data.synthetic import synthetic_batch
from diffreg_tpu_torch.data.synthetic2d3d import synthetic_2d3d_batch
from diffreg_tpu_torch.engine.losses import LossConfig, diffreg_loss
from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
from diffreg_tpu_torch.models.presets import preset_tiny, with_condition_gate
from diffreg_tpu_torch.nn import point_backbone as ppb
from diffreg_tpu_torch.ops import kpconv as pkp
from diffreg_tpu_torch.ops.attention import (masked_attention, masked_attention_bf16_plain,
                                             masked_attention_plain)
from diffreg_tpu_torch.ops.kernel_points import load_kernel_points

T = torch.from_numpy
# 16, 17, 32 and 33 lie on each side of the any-P tensor-core kernels' chunks
# of 16 kernel points; 128/129 and 256/257 on each side of the any-D route's
# 128-column slices (one, two, three), 137 and 144/145 past the tuned
# attention instances' widest (f32 136, bf16 144)
KERNEL_POINTS = (1, 7, 16, 17, 24, 32, 33)
HEAD_WIDTHS = (6, 54, 66, 128, 129, 137, 144, 145, 216, 256, 257, 528)
EXTENT = 0.05
B, N_POINTS, TRAIN_KEY, X_SEED = 2, 96, 1, 0
TINY_POINTS = 7
TINY_HEADS = (3, 1)
# the whole path's pairs. tests/test_torch_variants.py's seed 2 puts, at 7
# kernel points, a kink of the encoder within f32 rounding of the train
# step's forward: there the port's own backbone gradients move by 3.8e-4 of
# their largest entry when each KPConv output is multiplied by 1 + 1e-7 N(0, 1)
# (tools/grad_sensitivity_port.py's perturbation; 1.6e-2 at 1e-6), beyond the
# 1e-4 limit, and the packages' summation orders give 3.8e-3 (2 heads) and
# 8.8e-3 (3 heads) there. At seed 3 the same perturbation moves every
# gradient by at most 2.9e-5 (3 and 1 heads), and the packages agree within
# 7.6e-5 (measured on this sandbox's CPU)
DATA_SEED = 3


def _flat(tree, prefix=""):
    return {prefix + "/".join(k): np.asarray(v) for k, v in flatten_dict(dict(tree)).items()}


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    return np.abs(got - ref).max() / scale, np.abs(got - ref).mean() / scale


# ---------------------------------------------------------------- KPConv


def _kpconv_inputs(rng, n_points, b=2, nq=24, ns=40, k=12, cin=8, cout=16):
    centre = np.array([3.2, -2.1, 1.7], np.float32)
    s = (centre + rng.rand(b, ns, 3) * 0.1).astype(np.float32)
    q = (centre + rng.rand(b, nq, 3) * 0.1).astype(np.float32)
    inds = rng.randint(0, ns + 1, (b, nq, k)).astype(np.int32)
    x = rng.randn(b, ns, cin).astype(np.float32)
    kp = load_kernel_points(0.04, n_points)
    w = (rng.randn(n_points, cin, cout) * 0.1).astype(np.float32)
    return q, s, inds, x, kp, w


@pytest.mark.parametrize("n_points", KERNEL_POINTS)
def test_kpconv_at_any_kernel_point_count(rng, n_points):
    """The plain KPConv (the any-P kernel's reference on the card) against
    JAX's XLA KPConv and the Pallas kernel's plain reference on the same
    gathered rows."""
    q, s, inds, x, kp, w = _kpconv_inputs(rng, n_points)
    got = pkp.kpconv(*map(T, (q, s, inds, x, kp, w)), EXTENT).numpy()
    ref = np.asarray(jax_kpconv_batched(*map(jnp.asarray, (q, s, inds, x, kp, w)), EXTENT,
                                        use_pallas=False))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    b = x.shape[0]
    table = np.concatenate([np.concatenate([s, np.full((b, 1, 3), 1e6, np.float32)], 1),
                            np.concatenate([x, np.zeros((b, 1, x.shape[2]), np.float32)], 1)],
                           axis=-1)
    gathered = np.stack([table[i][inds[i].T] for i in range(b)])          # [B, K, Nq, 3+C]
    post = np.asarray(_xla_post_gather(*map(jnp.asarray, (gathered, q, kp, w)), EXTENT))
    np.testing.assert_allclose(got, post, rtol=1e-5, atol=1e-5)
    # the entry the backbone calls takes the plain version on CPU tensors
    assert torch.equal(pkp.kpconv_batched(*map(T, (q, s, inds, x, kp, w)), EXTENT),
                       torch.from_numpy(got))
    assert np.abs(ref).max() > 0


@pytest.mark.parametrize("n_points", KERNEL_POINTS)
def test_kpconv_bf16_at_any_kernel_point_count(rng, n_points):
    """The plain bf16 KPConv (the bf16 any-P kernel's reference) against JAX's
    bf16 XLA KPConv, as ``tests/test_torch_variants.py`` holds it at 15."""
    q, s, inds, x, kp, w = _kpconv_inputs(rng, n_points)
    conv = jax.jit(functools.partial(jax_kpconv_batched, kp_extent=EXTENT,
                                     compute_dtype=jnp.bfloat16))
    ref = np.asarray(conv(*map(jnp.asarray, (q, s, inds, x, kp, w))))
    got = pkp.kpconv_batched(*map(T, (q, s, inds, x, kp, w)), EXTENT, "bfloat16")
    assert _rel(got.numpy(), ref)[0] <= 1e-5


# ---------------------------------------------------------------- attention


def _attention_inputs(rng, d, b=2, h=2, length=16, keys=56):
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32) for n in (length, keys, keys))
    mask = np.arange(keys)[None] < np.array([[keys - 5], [keys - 20]])
    return q, k, v, mask, d ** -0.5


@pytest.mark.parametrize("d", HEAD_WIDTHS)
def test_attention_at_any_head_width(rng, d):
    """The plain attention (the any-D route's reference on the card)
    against the Pallas kernel in interpret mode, over several key tiles."""
    q, k, v, mask, scale = _attention_inputs(rng, d)
    ref = np.asarray(masked_attention_pallas(*map(jnp.asarray, (q, k, v, mask)), q_tile=8,
                                             kv_tile=128, interpret=True, scale=scale))
    got = masked_attention_plain(*map(T, (q, k, v, mask)), scale)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=2e-5)
    assert torch.equal(masked_attention(*map(T, (q, k, v, mask)), scale), got)


@pytest.mark.parametrize("d", HEAD_WIDTHS)
def test_attention_bf16_at_any_head_width(rng, d):
    """The plain bf16 attention against the Pallas kernel with bf16 q, k, v
    (interpret mode) and against the JAX layer's XLA bf16 path written out
    in jnp, at test_torch_bf16.py's limits."""
    q, k, v, mask, scale = _attention_inputs(rng, d)
    jq, jk, jv = (jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v))
    pallas = np.asarray(masked_attention_pallas(jq, jk, jv, jnp.asarray(mask), q_tile=8,
                                                kv_tile=128, interpret=True, scale=scale))
    a = jnp.einsum("bhld,bhsd->bhls", jq, jk, preferred_element_type=jnp.float32)
    a = jnp.where(jnp.asarray(mask)[:, None, None, :], a, -1e9)
    a = jax.nn.softmax(a / jnp.sqrt(jnp.asarray(d, a.dtype)), axis=-1)
    xla = np.asarray(jnp.einsum("bhls,bhsd->bhld", a.astype(jnp.bfloat16), jv,
                                preferred_element_type=jnp.float32).astype(jnp.bfloat16)
                     .astype(jnp.float32))
    tq, tk, tv = (T(t).bfloat16() for t in (q, k, v))
    got = masked_attention_bf16_plain(tq, tk, tv, T(mask), scale)
    assert got.dtype == torch.bfloat16
    assert torch.equal(masked_attention(tq, tk, tv, T(mask), scale), got)
    # f32 sums of the bf16 products in another order than XLA's: at D = 528 a
    # logit's last bit can move a probability, and then an output, across a
    # bf16 rounding. Each entry that differs does so by one bf16 ulp of itself,
    # at most 1e-3 of the entries (measured 1 of 33,792 at D = 528, none below)
    got_np = got.float().numpy()
    flips = got_np != xla
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(got_np), np.abs(xla)) + 1e-30)) - 7)
    assert flips.mean() <= 1e-3 and np.all(np.abs(got_np - xla)[flips] <= ulp[flips])
    worst, mean = _rel(got_np, pallas)
    assert worst <= 8e-3 and mean <= 1e-3, (worst, mean)


# ---------------------------------------------------------------- 2D-3D point backbone


def test_point_backbone_at_seven_kernel_points():
    """The 2D-3D point backbone built at ``kernel_size`` 7 (its 8 KPConv
    layers at 7 kernel points) against JAX's, every level's features; the
    port's weights (drawn from a seed) carried into JAX's tree through the
    bridge's translation backwards."""
    batch = synthetic_2d3d_batch(batch_size=2, img_hw=(32, 48), n_points=160, seed=0)
    pyr = {"points": tuple(jnp.asarray(p.numpy()) for p in batch.points),
           "masks": tuple(jnp.asarray(m.numpy()) for m in batch.masks),
           "neighbors": tuple(jnp.asarray(n.numpy()) for n in batch.neighbors),
           "pools": tuple(jnp.asarray(p.numpy()) for p in batch.pools),
           "upsamples": tuple(jnp.asarray(u.numpy()) for u in batch.upsamples),
           "features": jnp.asarray(batch.pcd_feats.numpy())}
    kw = dict(output_dim=32, init_dim=16, init_radius=0.1, init_sigma=0.08, kernel_size=7)
    port = ppb.PointBackbone(ppb.PointBackboneConfig(**kw))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in port.named_parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * (0.1 if p.dim() == 1 else 0.3))
    jm = jpb.PointBackbone(jpb.PointBackboneConfig(**kw))
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, pyr))
    sd = port.state_dict()
    variables = {}
    for collection, tree in shapes.items():
        flat = {}
        for path, leaf in flatten_dict(dict(tree)).items():
            key, layout = _translate_2d3d("pcd_backbone/" + "/".join(path))
            value = sd[key[len("pcd_backbone."):]].numpy()
            flat[path] = jnp.asarray(value.T if layout == "T" else value)
            assert flat[path].shape == leaf.shape, path
        variables[collection] = unflatten_dict(flat)
    ref = jax.jit(jm.apply)(variables, pyr)
    assert port.encoder1_1.conv.weights.shape[0] == 7
    assert port.encoder3_3.conv.conv.kernel_points.shape == (7, 3)
    with torch.no_grad():
        got = port(batch)
    for level, (g, r) in enumerate(zip(got, ref)):
        valid = batch.masks[level].numpy()
        assert _rel(g.numpy()[valid], np.asarray(r)[valid])[0] <= 1e-5, level


# ---------------------------------------------------------------- the whole path


def _jax_cfg(n_head, gate):
    cfg = jax_preset_tiny("3dmatch", sample_steps=2)
    transformer = dataclasses.replace(cfg.coarse_transformer, n_head=n_head)
    kpfcn = dataclasses.replace(cfg.kpfcn, num_kernel_points=TINY_POINTS)
    proc = dataclasses.replace(cfg.procrustes, max_condition_num=gate)
    return dataclasses.replace(cfg, kpfcn=kpfcn, procrustes=proc,
                               coarse_transformer=dataclasses.replace(transformer,
                                                                      procrustes=proc))


def _port_model(n_head, sd, gate):
    cfg = with_condition_gate(preset_tiny(2), gate)
    cfg = dataclasses.replace(
        cfg, kpfcn=dataclasses.replace(cfg.kpfcn, num_kernel_points=TINY_POINTS),
        coarse_transformer=dataclasses.replace(cfg.coarse_transformer, n_head=n_head))
    model = DiffusionMatchingModel(cfg, device="cpu", seed=0)
    if sd is None:
        return model
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected
    assert all(k.startswith(("backbone.decoder_blocks.3.", "backbone.decoder_blocks.5.",
                             "backbone.coarse_in.", "backbone.fine_out.")) for k in missing)
    return model


def _train_draws(key, spec):
    rng_t, rng_noise, rng_pos = jax.random.split(key, 3)
    return {"t": T(np.array(jax.random.randint(rng_t, (B,), 0, 1000))),
            "g": T(np.array(jax.random.normal(rng_noise, (B, spec.n_src, spec.n_tgt)))),
            "euler": T(np.array(jax.random.uniform(rng_pos, (B, 3)) * 2.0 * jnp.pi))}


def _flax_from_port(sd, shapes):
    """JAX variables holding the port's state_dict ``sd``: each flax path of
    ``shapes`` (``jax.eval_shape`` of the init: no compile of it) read through
    the weight bridge's translation backwards."""
    layouts = {None: lambda a: a, "T": lambda a: a.T, "conv": lambda a: a[:, :, 0].T}
    out = {}
    for collection, tree in shapes.items():
        for path, leaf in flatten_dict(dict(tree)).items():
            key, layout = _translate("/".join(path))
            out[(collection, *path)] = jnp.asarray(layouts[layout](sd[key].numpy()))
            assert out[(collection, *path)].shape == leaf.shape, path
    return unflatten_dict(out)


@pytest.fixture(scope="module", params=TINY_HEADS)
def tiny(request):
    """The port's weights of preset_tiny at 7 kernel points and ``n_head``
    heads carried into JAX's model (the head count changes no weight's
    shape), JAX's DDIM output at gate 0 and its train step at gate 200 (the
    loss and every gradient)."""
    n_head = request.param
    jbatch, spec, _ = jax_synthetic_batch(batch_size=B, n_points=N_POINTS, seed=DATA_SEED)
    pbatch, _, _ = synthetic_batch(batch_size=B, n_points=N_POINTS, seed=DATA_SEED)
    init_model = JaxModel(_jax_cfg(n_head, 0.0))
    rng = jax.random.PRNGKey(0)
    sd = _port_model(n_head, None, 0.0).state_dict()
    variables = _flax_from_port(sd, jax.eval_shape(
        lambda: init_model.init({"params": rng}, jbatch, rng, mode="train")))
    x_init = np.random.RandomState(X_SEED).randn(B, spec.n_src, spec.n_tgt).astype(np.float32)
    ddim = jax.jit(lambda v, b, x: JaxModel(_jax_cfg(n_head, 0.0)).apply(
        v, b, jax.random.PRNGKey(0), mode="ddim", x_init=x))(variables, jbatch,
                                                              jnp.asarray(x_init))
    key = jax.random.PRNGKey(TRAIN_KEY)
    train_model = JaxModel(_jax_cfg(n_head, 200.0))

    def loss_fn(params):
        out = train_model.apply({"params": params, "buffers": variables["buffers"]}, jbatch,
                                key, mode="train")
        return jax_diffreg_loss(out, jbatch, JaxLossConfig())[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    return {"n_head": n_head, "pbatch": pbatch, "spec": spec, "sd": sd, "x_init": x_init,
            "ddim": ddim, "key": key, "loss": loss, "grads": grads}


def test_tiny_config_is_the_asked_for_model(tiny):
    model = _port_model(tiny["n_head"], tiny["sd"], 0.0)
    convs = [m for m in model.backbone.modules() if hasattr(m, "offset_conv")]
    assert convs and all(m.weights.shape[0] == TINY_POINTS for m in convs)
    assert all(m.kernel_points.shape == (TINY_POINTS, 3) for m in convs)
    assert model.cfg.coarse_transformer.n_head == tiny["n_head"]


def test_tiny_ddim_matches_jax(tiny):
    pbatch = tiny["pbatch"]
    got = _port_model(tiny["n_head"], tiny["sd"], 0.0).ddim_sample(pbatch, T(tiny["x_init"]))
    ref = tiny["ddim"]
    valid = (pbatch.src_mask[:, :, None] & pbatch.tgt_mask[:, None, :]).numpy()
    conf = np.asarray(ref["conf_matrix_pred"])
    np.testing.assert_allclose(got["conf_matrix_pred"].numpy()[valid], conf[valid], rtol=1e-5,
                               atol=1e-5 * np.abs(conf).max())
    np.testing.assert_array_equal(got["corr_mask"].numpy()[valid],
                                  np.asarray(ref["corr_mask"])[valid])
    for name in ("rotation_pred", "translation_pred"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), atol=1e-4)


def test_tiny_train_step_matches_jax(tiny):
    """The loss and d loss / d parameter for every parameter of JAX's tree, at
    gate 200 (the positioning layer's matcher feeds only the detached
    position code: zero in JAX, None here)."""
    pbatch = tiny["pbatch"]
    model = _port_model(tiny["n_head"], tiny["sd"], 200.0)
    out = model.train_forward(pbatch, **_train_draws(tiny["key"], tiny["spec"]))
    loss = diffreg_loss(out, pbatch, LossConfig())[0]
    np.testing.assert_allclose(loss.item(), float(tiny["loss"]), rtol=1e-5)
    loss.backward()
    params = dict(model.named_parameters())
    for path, ref in _flat(tiny["grads"]).items():
        name, layout = _translate(path)
        ref = ref.T if layout == "T" else ref.T[:, :, None] if layout == "conv" else ref
        grad = params[name].grad
        if np.all(ref == 0.0) and grad is None:
            assert name.startswith("coarse_transformer.layers.2.0."), name
            continue
        assert grad is not None, name
        np.testing.assert_allclose(grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-12), err_msg=name)
