"""bf16 training (``compute_dtype: bfloat16`` with ``precision: default``, the
JAX package's tools/bench_train.py setting) against ``jax.grad`` of the JAX
package, on the CPU at ``preset_tiny`` widths, with the same weights (the
port's, seeded, carried into JAX's tree through ``diffreg_tpu_torch.convert``'s
translation) and the same draws (JAX's, split from its key as
``train_forward`` splits it); and the similarity product's TF32 policy in the
backward.

Tolerances, each relative to the largest entry of the reference:
  * KPConv's gradients. The weights' agree to f32 summation order (held at
    1e-5; measured 0): the port's plain bf16 version rounds where JAX rounds,
    in the forward and, by autograd of the same casts, in the backward. The
    features' agree as closely where no support row is gathered twice. Where
    rows are shared (every real neighbourhood) the gathered rows' bf16
    cotangents are summed per row: XLA's scatter-add on the CPU rounds each
    addition to bf16 in index order, the port sums in f32 (so that its CUDA
    recompute, adding with atomics, agrees with it to f32 order). Held at
    2e-2 max and 1e-3 mean there (measured 5.8e-3 and 3.2e-4; the f32 path
    is 5.6e-3 and 5.7e-4 away, and 4.4e-3 in the weights' gradient).
  * Attention's q, k, v gradients: the roundings of JAX's XLA path (held at
    1e-5; measured 0).
  * One bf16 attention layer, the gradients of its inputs and of every
    parameter: max 1e-2, mean 1e-3 (measured at most 4.4e-3 and 2.6e-4,
    about one bf16 ulp of the largest entry, 2^-8 = 3.9e-3, where a bf16
    cotangent is summed or rounded in another place).
  * The whole step. XLA does not round a bf16 program in the same places in
    every compilation: JAX's own bf16 train_forward compiled alone and
    compiled inside ``value_and_grad`` differ by up to 3.2e-2 of the largest
    confidence, 9.7e-4 in the mean and 3.0e-4 in the loss (both are read
    here, and held to each other within the port's limits). Random weights
    leave the confidences near-uniform, so soft Procrustes' top-k cut and the
    gated warps turn such differences into others of the pose; the seeds put
    the positioning layer's cut in a gap of at least 2e-3 of the largest
    confidence (3.1e-3, 6.8e-3) and its conditions 30% or more from the gate
    (asserted). Held against both JAX readings: the confidences at 0.2 max
    and 1e-2 mean (measured at most 1.6e-2 / 1.3e-3 for 3DMatch, 0.105 /
    3.8e-3 for 4DMatch; the f32 path is 0.07-0.78 / 5.4e-3 to 6.3e-2 away,
    held beyond twice the port's mean), the loss at 1e-3 (measured at most
    2.0e-4; the f32 path 2.5e-3 to 3.8e-3, held beyond) and each term at 1e-2
    (measured at most 6.2e-3, the 4DMatch motion term on the soft-Procrustes
    pose). Against JAX's gradient: the whole gradient's relative norm at
    0.25, the median tensor's worst entry at 0.15 and the worst tensor's at
    0.6 (measured 0.129 / 0.050 / 0.39 and 0.135 / 0.070 / 0.21); the f32
    path's norm lies beyond (0.57, 0.77).
  * One SGD step: the port's optimizer makes of the port's gradients what
    optax's chain makes of them (1e-6), and its update is JAX's within the
    gradients' norm limit (measured 0.129, 0.135).
"""
import torch_native_guard  # noqa: F401  (makes the JAX native library whole first)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from torch.utils._python_dispatch import TorchDispatchMode

from diffreg_tpu.data import synthetic_batch as jax_synthetic_batch
from diffreg_tpu.engine.losses import LossConfig as JaxLossConfig
from diffreg_tpu.engine.losses import diffreg_loss as jax_diffreg_loss
from diffreg_tpu.engine.train import OptimConfig as JaxOptimConfig
from diffreg_tpu.engine.train import make_optimizer
from diffreg_tpu.models import DiffusionMatchingModel as JaxModel
from diffreg_tpu.models.presets import preset_tiny as jax_preset_tiny
from diffreg_tpu.nn.transformer import GeometryAttentionLayer as JaxAttentionLayer
from diffreg_tpu.ops.kpconv import kpconv as jax_kpconv
from diffreg_tpu.ops.position_encoding import volumetric_pe as jax_volumetric_pe
from diffreg_tpu.utils import precision as jax_precision
from diffreg_tpu_torch.convert import _translate, state_dict_from_flax
from diffreg_tpu_torch.data.synthetic import synthetic_batch
from diffreg_tpu_torch.engine.losses import LossConfig, diffreg_loss
from diffreg_tpu_torch.engine.train import OptimConfig, apply_gradients, create_train_state
from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
from diffreg_tpu_torch.models.presets import preset_tiny, with_condition_gate, with_fast_path
from diffreg_tpu_torch.nn.matching import Matching, MatchingConfig
from diffreg_tpu_torch.nn.transformer import GeometryAttentionLayer
from diffreg_tpu_torch.ops.attention import masked_attention, masked_attention_bf16_plain
from diffreg_tpu_torch.ops.kpconv import kpconv, kpconv_batched, kpconv_bf16_plain
from diffreg_tpu_torch.utils.precision import pin_float32

T = torch.from_numpy
B, N_POINTS, TRAIN_KEY = 2, 96, 1
ORIGIN, VOXEL = (-3.6, -2.4, 1.14), 0.08
# per variant: data seed, weight seed, condition gate, loss config (configs/train/*.yaml)
VARIANTS = {"3dmatch": (6, 2, 200.0, {}),
            "4dmatch": (2, 1, 40.0, {"motion_weight": 0.1, "dataset": "4dmatch"})}
NO_GRADIENT = "coarse_transformer.layers.2.0."


def _flat(tree, prefix=""):
    return {prefix + "/".join(k): np.asarray(v) for k, v in flatten_dict(dict(tree)).items()}


def _rel(got, ref):
    scale = max(np.abs(ref).max(), 1e-30)
    return np.abs(got - ref).max() / scale, np.abs(got - ref).mean() / scale


def _bf16(a):
    """numpy f32 -> the f32 values of its bf16 rounding (as both packages round)."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


# ---------------------------------------------------------------- KPConv


@pytest.mark.parametrize("shared", [False, True], ids=["distinct-rows", "shared-rows"])
def test_kpconv_bf16_gradients_match_jax(rng, shared):
    """d/dx and d/dweights of the plain bf16 KPConv against ``jax.grad`` of
    the JAX package's ``kpconv(..., compute_dtype=bfloat16)``, positions
    about 4 m from the origin (the hi/lo split) and shadow neighbours."""
    b, nq, ns, k, cin, cout, p = 2, 24, 40, 12, 8, 16, 15
    if not shared:
        ns = nq * k
    centre = np.array([3.2, -2.1, 1.7], np.float32)
    s = (centre + rng.rand(b, ns, 3) * 0.1).astype(np.float32)
    q = (centre + rng.rand(b, nq, 3) * 0.1).astype(np.float32)
    if shared:
        inds = rng.randint(0, ns + 1, (b, nq, k)).astype(np.int32)
    else:   # every support row at most once, the rest shadow neighbours
        inds = np.stack([rng.permutation(ns).reshape(nq, k) for _ in range(b)]).astype(np.int32)
        inds[rng.rand(b, nq, k) < 0.2] = ns
    x = rng.randn(b, ns, cin).astype(np.float32)
    kp = (rng.randn(p, 3) * 0.02).astype(np.float32)
    w = (rng.randn(p, cin, cout) * 0.1).astype(np.float32)
    proj = rng.randn(b, nq, cout).astype(np.float32)

    def f(x, w):
        out = jax.vmap(lambda qq, ss, ii, xx: jax_kpconv(
            qq, ss, ii, xx, kp, w, 0.05, compute_dtype=jnp.bfloat16))(q, s, inds, x)
        return jnp.sum(out * proj)

    ref = [np.asarray(g) for g in jax.jit(jax.grad(f, argnums=(0, 1)))(x, w)]
    got, f32 = [], []
    for fn, grads in ((kpconv_bf16_plain, got), (kpconv, f32)):
        tx, tw = T(x).requires_grad_(), T(w).requires_grad_()
        (fn(T(q), T(s), T(inds), tx, T(kp), tw, 0.05) * T(proj)).sum().backward()
        grads += [tx.grad.numpy(), tw.grad.numpy()]
    assert _rel(got[1], ref[1])[0] <= 1e-5
    assert _rel(f32[1], ref[1])[0] > 1e-3                       # the f32 path is another one
    if shared:
        worst, mean = _rel(got[0], ref[0])
        assert worst <= 2e-2 and mean <= 1e-3, (worst, mean)
    else:
        assert _rel(got[0], ref[0])[0] <= 1e-5
        assert _rel(f32[0], ref[0])[0] > 1e-3


def test_masked_attention_bf16_gradients_match_jax(rng):
    """d/dq, d/dk, d/dv of the plain bf16 attention (bf16 in, bf16 out and
    bf16 gradients) against ``jax.grad`` of the JAX layer's XLA path
    (nn/transformer.py:414-429) written out in jnp."""
    b, h, length, keys, d = 2, 2, 40, 56, 24
    q, k, v = (_bf16(rng.randn(b, h, n, d).astype(np.float32)) for n in (length, keys, keys))
    mask = np.arange(keys)[None] < np.array([[keys - 5], [keys - 20]])
    proj = rng.randn(b, h, length, d).astype(np.float32)

    def f(q, k, v):
        a = jnp.einsum("bhld,bhsd->bhls", q, k, preferred_element_type=jnp.float32)
        a = jnp.where(jnp.asarray(mask)[:, None, None, :], a, -1e9)
        a = jax.nn.softmax(a / jnp.sqrt(jnp.asarray(d, a.dtype)), axis=-1)
        o = jnp.einsum("bhls,bhsd->bhld", a.astype(jnp.bfloat16), v,
                       preferred_element_type=jnp.float32).astype(jnp.bfloat16)
        return jnp.sum(o.astype(jnp.float32) * proj)

    ref = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(*(jnp.asarray(t).astype(jnp.bfloat16)
                                          for t in (q, k, v)))
    leaves = [T(t).bfloat16().requires_grad_() for t in (q, k, v)]
    out = masked_attention(*leaves, T(mask), d ** -0.5)
    (out.float() * T(proj)).sum().backward()
    for name, leaf, r in zip("qkv", leaves, ref):
        assert leaf.grad.dtype == torch.bfloat16
        assert _rel(leaf.grad.float().numpy(), np.asarray(r.astype(jnp.float32)))[0] <= 1e-5, name


def _to_port(path, leaf):
    """(port key, the flax leaf in the port's layout)."""
    name, layout = _translate(path)
    leaf = np.asarray(leaf)
    return name, leaf.T if layout == "T" else leaf.T[:, :, None] if layout == "conv" else leaf


def _pe(rng, b, n, d):
    xyz = (rng.rand(b, n, 3) * 2 - 1).astype(np.float32)
    return np.array(jax_volumetric_pe(jnp.asarray(xyz), d, ORIGIN, VOXEL, "rotary"))


@pytest.mark.parametrize("kind", ["self", "cross"])
def test_geometry_attention_layer_bf16_gradients(rng, kind):
    """A bf16 ``GeometryAttentionLayer``: the gradients of x, of the source
    and of every parameter against ``jax.grad`` of the JAX layer's XLA path."""
    b, length, keys, d, h = 2, 20, 24, 48, 2
    x = rng.randn(b, length, d).astype(np.float32)
    src = x if kind == "self" else rng.randn(b, keys, d).astype(np.float32)
    x_pe = _pe(rng, b, length, d)
    s_pe = x_pe if kind == "self" else _pe(rng, b, keys, d)
    x_mask = np.arange(length)[None] < np.array([[length], [length - 5]])
    s_mask = x_mask if kind == "self" else np.arange(keys)[None] < np.array([[keys - 3],
                                                                             [keys - 9]])
    proj = rng.randn(b, length, d).astype(np.float32) * x_mask[..., None]
    layer = JaxAttentionLayer(d, h, "rotary", use_flash=False, compute_dtype="bfloat16")
    args = [jnp.asarray(t) for t in (x, src, x_pe, s_pe, x_mask, s_mask)]
    params = jax.jit(layer.init)(jax.random.PRNGKey(1), *args)["params"]

    def f(params, x, src):
        out = layer.apply({"params": params}, x, x if kind == "self" else src, *args[2:])
        return jnp.sum(out * proj)

    ref_p, ref_x, ref_s = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(params, args[0], args[1])
    prefix = "denoising_transformer/layer0_self/"
    sd = state_dict_from_flax(_flat(params, prefix), {})
    port = GeometryAttentionLayer(d, h, "bfloat16")
    port.load_state_dict({k.split("layers.0.")[1]: v for k, v in sd.items()})
    tx = T(x).requires_grad_()
    ts = tx if kind == "self" else T(src).requires_grad_()
    out = port(tx, ts, T(x_pe), T(s_pe), T(s_mask))
    (out * T(proj)).sum().backward()
    if kind == "self":      # x is the source too
        pairs = [("x", tx.grad.numpy(), np.asarray(ref_x) + np.asarray(ref_s))]
    else:
        pairs = [("x", tx.grad.numpy(), np.asarray(ref_x)),
                 ("source", ts.grad.numpy(), np.asarray(ref_s))]
    params_port = dict(port.named_parameters())
    for path, r in _flat(ref_p, prefix).items():
        name, r = _to_port(path, r)
        pairs.append((name, params_port[name.split("layers.0.")[1]].grad.numpy(), r))
    assert len(pairs) == len(params_port) + 1 + (kind == "cross")
    for name, got, r in pairs:
        worst, mean = _rel(got, r)
        assert worst <= 1e-2 and mean <= 1e-3, (name, worst, mean)


# ---------------------------------------------------------------- the whole step


def _jax_cfg(variant):
    _, _, gate, _ = VARIANTS[variant]
    cfg = jax_preset_tiny(variant, sample_steps=2)
    proc = dataclasses.replace(cfg.procrustes, max_condition_num=gate)
    return dataclasses.replace(
        cfg, procrustes=proc,
        kpfcn=dataclasses.replace(cfg.kpfcn, compute_dtype="bfloat16"),
        coarse_transformer=dataclasses.replace(cfg.coarse_transformer, procrustes=proc,
                                               compute_dtype="bfloat16"))


def _port_cfg(variant, fast=True):
    _, _, gate, _ = VARIANTS[variant]
    cfg = with_condition_gate(preset_tiny(variant, 2), gate)
    return with_fast_path(cfg) if fast else cfg


def _train_draws(spec):
    rng_t, rng_noise, rng_pos = jax.random.split(jax.random.PRNGKey(TRAIN_KEY), 3)
    return {"t": T(np.array(jax.random.randint(rng_t, (B,), 0, 1000))),
            "g": T(np.array(jax.random.normal(rng_noise, (B, spec.n_src, spec.n_tgt)))),
            "euler": T(np.array(jax.random.uniform(rng_pos, (B, 3)) * 2.0 * jnp.pi))}


def _flax_from_port(sd, shapes):
    """JAX variables holding the port's state_dict ``sd``, on the tree of
    ``jax.eval_shape`` of the init (no compile of it)."""
    out = {}
    for path, leaf in flatten_dict(dict(shapes)).items():
        name, layout = _translate("/".join(path[1:]))
        value = sd[name].numpy()
        value = value.T if layout == "T" else value[:, :, 0].T if layout == "conv" else value
        assert value.shape == leaf.shape, path
        out[path] = jnp.asarray(value)
    return unflatten_dict(out)


@pytest.fixture(scope="module", params=list(VARIANTS))
def step(request):
    """Per variant: the batches, the port's weights in both packages, and in
    two JAX compiles under ``precision: default`` (restored after):
    train_forward with the loss, and the same inside ``value_and_grad`` with
    every parameter's gradient; then the optax SGD chain's update of those
    gradients."""
    variant = request.param
    seed, weight_seed, _, loss_kw = VARIANTS[variant]
    deformable = variant == "4dmatch"
    jbatch, spec, _ = jax_synthetic_batch(batch_size=B, n_points=N_POINTS, seed=seed,
                                          deformable=deformable)
    pbatch, _, _ = synthetic_batch(batch_size=B, n_points=N_POINTS, seed=seed,
                                   deformable=deformable)
    sd = {k: v.clone() for k, v in DiffusionMatchingModel(
        _port_cfg(variant), device="cpu", seed=weight_seed).state_dict().items()}
    model = JaxModel(_jax_cfg(variant))
    key = jax.random.PRNGKey(TRAIN_KEY)
    variables = _flax_from_port(sd, jax.eval_shape(
        lambda: model.init({"params": key}, jbatch, key, mode="train")))

    def loss_fn(params):
        out = model.apply({"params": params, "buffers": variables["buffers"]}, jbatch, key,
                          mode="train")
        loss, info = jax_diffreg_loss(out, jbatch, JaxLossConfig(**loss_kw))
        return loss, (info, out)

    before = jax_precision.get_precision()
    jax_precision.set_precision("default")
    try:
        forward = jax.jit(loss_fn)(variables["params"])
        (loss, (info, out)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"])
    finally:
        jax_precision._PRECISION = before
    tx = make_optimizer(JaxOptimConfig())
    updates, _ = tx.update(grads, tx.init(variables["params"]), variables["params"])
    return {"variant": variant, "pbatch": pbatch, "spec": spec, "sd": sd, "tx": tx,
            "loss_kw": loss_kw, "forward": forward, "loss": loss, "info": info, "out": out,
            "grads": grads, "params": variables["params"],
            "stepped": optax.apply_updates(variables["params"], updates)}


def _port_step(step, fast=True):
    model = DiffusionMatchingModel(_port_cfg(step["variant"], fast), device="cpu")
    model.load_state_dict(step["sd"])
    out = model.train_forward(step["pbatch"], **_train_draws(step["spec"]))
    loss, info = diffreg_loss(out, step["pbatch"], LossConfig(**step["loss_kw"]))
    return model, out, loss, info


def _cut_gap(conf, src_mask, tgt_mask):
    """Soft Procrustes keeps the top max(|S|, |T|) confidences: the smallest
    gap at that cut over the pairs, relative to the largest confidence."""
    gaps = []
    for i in range(conf.shape[0]):
        top = np.sort(conf[i].ravel())[::-1]
        cut = int(max(src_mask[i].sum(), tgt_mask[i].sum()))
        gaps.append((top[cut - 1] - top[cut]) / top[0])
    return min(gaps)


def test_train_forward_bf16_matches_jax(step):
    """train_forward and diffreg_loss in bf16 against JAX's, compiled alone
    and compiled inside ``value_and_grad``; JAX's two compilations against
    each other within the same limits. Every output the loss reads is f32, as
    in JAX (its bf16 layers return their input's dtype); the f32 path lies
    farther."""
    pbatch = step["pbatch"]
    with torch.no_grad():
        _, got, loss, info = _port_step(step)
        _, f32, loss32, _ = _port_step(step, fast=False)
    for name, value in got.items():
        if isinstance(value, torch.Tensor) and value.is_floating_point():
            assert value.dtype == torch.float32, name
    sm, tm = pbatch.src_mask.numpy(), pbatch.tgt_mask.numpy()
    valid = sm[:, :, None] & tm[:, None, :]
    gate = VARIANTS[step["variant"]][2]
    (layer,) = got["position_layers"]
    assert _cut_gap(layer["conf_matrix"].numpy(), sm, tm) > 2e-3
    alone_loss, (alone_info, alone) = step["forward"]
    readings = {"alone": (alone_loss, alone_info, alone),
                "in value_and_grad": (step["loss"], step["info"], step["out"])}
    candidates = {"port": (loss, info, got),
                  "JAX in value_and_grad": readings["in value_and_grad"]}
    for ref_name, (ref_loss, ref_info, ref) in readings.items():
        np.testing.assert_array_equal(got["matrix_gt"].numpy(), np.asarray(ref["matrix_gt"]))
        np.testing.assert_array_equal(got["timesteps"].numpy(), np.asarray(ref["timesteps"]))
        (ref_layer,) = ref["position_layers"]
        for cond in (layer["condition"].numpy(), np.asarray(ref_layer["condition"])):
            assert np.all(np.abs(cond - gate) > 0.3 * gate), cond
        np.testing.assert_array_equal(layer["solution_mask"].numpy(),
                                      np.asarray(ref_layer["solution_mask"]))
        for who, (c_loss, c_info, c_out) in candidates.items():
            if who.startswith("JAX") and ref_name != "alone":
                continue
            for name in ("conf_matrix_pred", "conf_matrix_gt_hat"):
                conf = np.asarray(ref[name])[valid]
                worst, mean = _rel(np.asarray(c_out[name])[valid], conf)
                assert worst <= 0.2 and mean <= 1e-2, (who, ref_name, name, worst, mean)
                if who == "port":
                    assert _rel(f32[name].numpy()[valid], conf)[1] > 2 * mean, name
            assert set(c_info) == set(ref_info)
            for name, value in c_info.items():
                np.testing.assert_allclose(float(value), float(ref_info[name]), rtol=1e-2,
                                           atol=1e-6, err_msg=f"{who} against {ref_name}")
            assert abs(float(c_loss) - float(ref_loss)) <= 1e-3 * abs(float(ref_loss))
        assert abs(float(loss32) - float(ref_loss)) > 1e-3 * abs(float(ref_loss))


def _global(got, ref):
    """||got - ref|| / ||ref|| over all tensors together."""
    num = sum(float(((got[k] - ref[k]).astype(np.float64) ** 2).sum()) for k in ref)
    den = sum(float((ref[k].astype(np.float64) ** 2).sum()) for k in ref)
    return float(np.sqrt(num / den))


def _port_grads(step, fast=True):
    """{port key: d loss / d parameter} for every parameter of JAX's tree
    (f32), and JAX's, in the port's layout; the positioning matcher's
    (zero in JAX, None in the port) left out."""
    model, _, loss, _ = _port_step(step, fast)
    loss.backward()
    params = dict(model.named_parameters())
    got, ref = {}, {}
    for path, r in _flat(step["grads"]).items():
        name, r = _to_port(path, r)
        grad = params[name].grad
        if name.startswith(NO_GRADIENT):
            assert np.all(r == 0.0) and grad is None, name
            continue
        assert grad is not None and grad.dtype == torch.float32, name
        got[name], ref[name] = grad.numpy(), r
    assert len(got) + sum(n.startswith(NO_GRADIENT) for n in params) == len(
        model.named_trained_parameters())
    return got, ref


def test_gradients_bf16_match_jax(step):
    """d loss / d parameter for every parameter of JAX's tree against
    ``jax.grad``: the whole gradient's relative norm, the median tensor's
    and the worst tensor's largest difference; the f32 path farther."""
    got, ref = _port_grads(step)
    f32, _ = _port_grads(step, fast=False)
    errs = sorted(_rel(got[n], ref[n])[0] for n in ref)
    worst, median, total = errs[-1], errs[len(errs) // 2], _global(got, ref)
    assert total <= 0.25 and median <= 0.15 and worst <= 0.6, (total, median, worst)
    assert _global(f32, ref) > 0.25


def test_sgd_step_bf16_matches_jax(step):
    """One step of the reference SGD (lr 0.015, momentum 0.93, weight decay
    1e-6) on the f32 master parameters: the port's update of its own
    gradients is what optax's chain makes of them, the optimizer's state is
    f32, and the update is JAX's within the gradients' limit."""
    model, _, loss, _ = _port_step(step)
    state = create_train_state(model, OptimConfig())
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads = torch.autograd.grad(loss, state.optimizer.params, allow_unused=True)
    finite, _ = apply_gradients(state.optimizer, grads)
    assert bool(finite)
    for tensors in (state.optimizer.params, *state.optimizer.buffers["momentum"].values()):
        for t in (tensors if isinstance(tensors, list) else [tensors]):
            assert t.dtype == torch.float32
    port_grads = {n: (torch.zeros_like(p) if g is None else g).numpy()
                  for n, p, g in zip(state.optimizer.names, state.optimizer.params, grads)}
    params = dict(model.named_parameters())
    flat_params = _flat(step["params"])
    tree = {}
    for path in flat_params:
        name, layout = _translate(path)
        g = port_grads[name]
        tree[tuple(path.split("/"))] = jnp.asarray(
            g.T if layout == "T" else g[:, :, 0].T if layout == "conv" else g)
    tx = step["tx"]
    updates, _ = tx.update(unflatten_dict(tree), tx.init(step["params"]), step["params"])
    got, ref = {}, {}
    stepped = _flat(step["stepped"])
    for path, new in _flat(optax.apply_updates(step["params"], updates)).items():
        name, new = _to_port(path, new)
        np.testing.assert_allclose(params[name].detach().numpy(), new, rtol=1e-6, atol=1e-9,
                                   err_msg=name)
        if not name.startswith(NO_GRADIENT):
            got[name] = (params[name].detach() - before[name]).numpy()
            ref[name] = _to_port(path, stepped[path] - flat_params[path])[1]
    assert _global(got, ref) <= 0.25


# ---------------------------------------------------------------- TF32 policy and wrappers


class _Tf32Log(TorchDispatchMode):
    """Records, for each batched and plain matrix product dispatched inside,
    the op and whether CUDA matmuls were allowed TF32 at that moment."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.bmm.default, torch.ops.aten.mm.default):
            self.calls.append((func, torch.backends.cuda.matmul.allow_tf32))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", ["default", "highest"])
def test_similarity_backward_runs_under_the_policy(rng, policy):
    """The matcher's similarity product is JAX's einsum at ``get_precision()``,
    whose transpose keeps that precision: its two backward GEMMs run with
    TF32 allowed under "default" and not under "highest", as its forward
    does, while the projection's GEMMs (a flax Dense at full precision in
    JAX) keep the f32 baseline. CPU tensors have no TF32, but the flag each
    product runs under is recorded here."""
    matcher = Matching(MatchingConfig(feature_dim=16, precision=policy))
    src = T(rng.randn(2, 10, 16).astype(np.float32)).requires_grad_()
    tgt = T(rng.randn(2, 12, 16).astype(np.float32)).requires_grad_()
    pe = [T(rng.randn(2, n, 16, 2).astype(np.float32)) for n in (10, 12)]
    masks = [torch.ones(2, n, dtype=torch.bool) for n in (10, 12)]
    pin_float32()
    forward = _Tf32Log()
    with forward:
        conf, _ = matcher(src, tgt, pe[0], pe[1], *masks)
    backward = _Tf32Log()
    with backward:
        torch.autograd.grad(conf.square().sum(), [src, tgt, matcher.src_proj.weight])
    assert torch.backends.cuda.matmul.allow_tf32 is False      # restored after each product
    want = policy == "default"
    for log, n_bmm in ((forward, 1), (backward, 2)):
        bmm = [tf32 for func, tf32 in log.calls if func is torch.ops.aten.bmm.default]
        mm = [tf32 for func, tf32 in log.calls if func is torch.ops.aten.mm.default]
        assert bmm == [want] * n_bmm, (policy, log.calls)
        assert mm and not any(mm), (policy, log.calls)


def test_bf16_functions_on_the_cpu(rng):
    """bf16 CPU tensors with a gradient take the plain bf16 versions (autograd
    of them, no launch); the Functions around the bf16 instances launch the
    kernel or raise, so CPU tensors are refused there."""
    from diffreg_tpu_torch.ops.attention import (MaskedAttentionBF16Function,
                                                 masked_attention_cuda_bf16)
    from diffreg_tpu_torch.ops.kpconv import KPConvBF16Function, kpconv_cuda_bf16

    q, k, v = (T(rng.randn(1, 2, n, 8).astype(np.float32)).bfloat16().requires_grad_()
               for n in (5, 7, 7))
    mask = torch.ones(1, 7, dtype=torch.bool)
    qp, sp = T(rng.rand(1, 4, 3).astype(np.float32)), T(rng.rand(1, 6, 3).astype(np.float32))
    inds = T(rng.randint(0, 7, (1, 4, 3)).astype(np.int32))
    x = T(rng.randn(1, 6, 2).astype(np.float32)).requires_grad_()
    w = T(rng.randn(15, 2, 8).astype(np.float32)).requires_grad_()
    kp = T(rng.randn(15, 3).astype(np.float32) * 0.01)
    before = masked_attention_cuda_bf16.launches, kpconv_cuda_bf16.launches
    att = masked_attention(q, k, v, mask, 0.5)
    conv = kpconv_batched(qp, sp, inds, x, kp, w, 0.05, compute_dtype="bfloat16")
    assert att.dtype == torch.bfloat16 and conv.dtype == torch.float32
    grads = torch.autograd.grad(att.float().sum() + conv.sum(), [q, k, v, x, w])
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3 + [torch.float32] * 2
    assert torch.equal(att, masked_attention_bf16_plain(q, k, v, mask, 0.5))
    assert torch.equal(conv, kpconv_bf16_plain(qp, sp, inds, x, kp, w, 0.05))
    assert (masked_attention_cuda_bf16.launches, kpconv_cuda_bf16.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        MaskedAttentionBF16Function.apply(q, k, v, mask, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        KPConvBF16Function.apply(qp, sp, inds, x, kp, w, 0.05)
