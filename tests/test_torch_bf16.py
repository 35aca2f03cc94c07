"""The port's bf16 compute path (``compute_dtype: bfloat16``, ``precision:
default``; configs/test/3dmatch_fast.yaml) against the JAX package's, on the
CPU at ``preset_tiny`` widths, with the same weights (carried by
``diffreg_tpu_torch.convert``) and the same draws.

Tolerances, each relative to the largest entry of the reference (max, and
mean where one rounding that lands on the other side moves an entry by a
bf16 ulp, 2^-8 of it, without saying anything about the rest):
  * KPConv: 1e-5. The port's plain bf16 version rounds where JAX rounds (the
    hi/lo table, the influence, the weighted features, the weights) and every
    product of two bf16 values is exact in f32, so only f32 summation order
    differs (measured 1.3e-7; the f32 path is 2.3e-3 away).
  * Attention: the port rounds where JAX's XLA path does (measured 0 against
    it; held at 1e-5). The Pallas kernel rounds q * scale and not the
    probabilities: max 8e-3, mean 1e-3 (measured 3.0e-3, 3.8e-4).
  * One attention layer, and the denoiser's six: against the XLA path, max
    1e-4 and mean 1e-6 (measured 1.9e-7 and 1e-8; one flipped rounding gave
    4e-5); against the Pallas path, max 1e-2 / 3e-2 and mean 1.5e-3 / 5e-3
    (measured 3.8e-3 / 1.1e-2 and 6.2e-4 / 2.0e-3).
  * The bf16 encode: the inputs of each layer's bf16 roundings differ by f32
    summation order, so a few roundings flip and the flips spread through 13
    normalised blocks: max 1e-2, mean 1e-3 (measured 2.9e-3 and 2.9e-4; the
    f32 encode is 3.6e-2 and 6.5e-3 away, held above 2e-3 mean).
  * The whole DDIM (2 steps): the final Sinkhorn confidences at 2e-3 of the
    largest (measured 6.9e-4; the f32 path is 5.4e-3 away), and the top-1
    union mask exactly outside rows and columns whose best two confidences
    lie within twice that limit of each other (near-ties).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from diffreg_tpu.data import synthetic_batch as jax_synthetic_batch
from diffreg_tpu.models import DiffusionMatchingModel as JaxModel
from diffreg_tpu.models.presets import preset_tiny as jax_preset_tiny
from diffreg_tpu.nn.transformer import GeometryAttentionLayer as JaxAttentionLayer
from diffreg_tpu.nn.transformer import RepositioningTransformer as JaxTransformer
from diffreg_tpu.ops.kpconv import kpconv as jax_kpconv
from diffreg_tpu.ops.pallas.attention_kernel import masked_attention_pallas
from diffreg_tpu.ops.position_encoding import volumetric_pe as jax_volumetric_pe
from diffreg_tpu.utils import precision as jax_precision
from diffreg_tpu_torch.convert import state_dict_from_flax
from diffreg_tpu_torch.data.synthetic import synthetic_batch
from diffreg_tpu_torch.eval.register import register
from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
from diffreg_tpu_torch.models.presets import preset_tiny, with_condition_gate, with_fast_path
from diffreg_tpu_torch.nn.transformer import GeometryAttentionLayer, RepositioningTransformer
from diffreg_tpu_torch.ops.attention import masked_attention, masked_attention_bf16_plain
from diffreg_tpu_torch.ops.kpconv import kpconv, kpconv_batched, kpconv_bf16_plain

T = torch.from_numpy
B, N_POINTS, DATA_SEED, X_SEED, H = 2, 96, 2, 0, 8192
ORIGIN, VOXEL = (-3.6, -2.4, 1.14), 0.08


def _flat(tree, prefix=""):
    return {prefix + "/".join(k): np.asarray(v) for k, v in flatten_dict(dict(tree)).items()}


def _rel(got, ref):
    scale = np.abs(ref).max()
    return np.abs(got - ref).max() / scale, np.abs(got - ref).mean() / scale


def _bf16(a):
    """numpy f32 -> the f32 values of its bf16 rounding (as both packages round)."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


# ---------------------------------------------------------------- KPConv


def test_kpconv_bf16_plain_matches_jax(rng):
    """Positions about 4 m from the origin, where one bf16 is ~2 cm off and
    the hi/lo split matters; sentinel rows; features whose sums are negative
    for some neighbours (the density count's quirk)."""
    b, nq, ns, k, cin, cout, p = 2, 24, 40, 12, 8, 16, 15
    centre = np.array([3.2, -2.1, 1.7], np.float32)
    s = (centre + rng.rand(b, ns, 3) * 0.1).astype(np.float32)
    q = (centre + rng.rand(b, nq, 3) * 0.1).astype(np.float32)
    inds = rng.randint(0, ns + 1, (b, nq, k)).astype(np.int32)
    x = rng.randn(b, ns, cin).astype(np.float32)
    kp = (rng.randn(p, 3) * 0.02).astype(np.float32)
    w = (rng.randn(p, cin, cout) * 0.1).astype(np.float32)
    assert (inds == ns).any() and (x.sum(-1) < 0).any()
    ref = np.stack([np.asarray(jax_kpconv(q[i], s[i], inds[i], x[i], kp, w, 0.05,
                                          compute_dtype=jnp.bfloat16)) for i in range(b)])
    args = tuple(map(T, (q, s, inds, x, kp, w))) + (0.05,)
    got = kpconv_bf16_plain(*args).numpy()
    assert _rel(got, ref)[0] <= 1e-5
    assert _rel(kpconv(*args).numpy(), ref)[0] > 1e-4            # the f32 path is another one
    np.testing.assert_array_equal(kpconv_batched(*args, compute_dtype="bfloat16").numpy(), got)


def test_kpconv_bf16_table_aligned(rng):
    """The CUDA route's table holds the JAX package's bf16 table
    (``diffreg_tpu/ops/kpconv.py:_gather_pos_feats``: hi and lo of the
    positions, then the features, the shadow row appended), written out in
    jnp, column for column, with two zero columns between the positions and
    the features (which then start at a 16-byte boundary)."""
    from diffreg_tpu_torch.ops.kpconv import kpconv_bf16_table_aligned

    s = (np.array([3.2, -2.1, 1.7]) + rng.rand(2, 30, 3)).astype(np.float32)
    x = rng.randn(2, 30, 64).astype(np.float32)
    pad_s = jnp.concatenate([jnp.asarray(s), jnp.full((2, 1, 3), 1.0e6, jnp.float32)], axis=1)
    pad_x = jnp.concatenate([jnp.asarray(x), jnp.zeros((2, 1, 64), jnp.float32)], axis=1)
    hi = pad_s.astype(jnp.bfloat16)
    lo = (pad_s - hi.astype(jnp.float32)).astype(jnp.bfloat16)
    ref = np.asarray(jnp.concatenate([hi, lo, pad_x.astype(jnp.bfloat16)], axis=-1)
                     .astype(jnp.float32))
    got = kpconv_bf16_table_aligned(T(s), T(x))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 31, 8 + 64)
    np.testing.assert_array_equal(got[..., :6].float().numpy(), ref[..., :6])
    np.testing.assert_array_equal(got[..., 8:].float().numpy(), ref[..., 6:])
    assert not got[..., 6:8].float().any()
    assert (got.shape[-1] * got.element_size()) % 16 == 0 and 8 * got.element_size() == 16


# ---------------------------------------------------------------- attention


def _attention_inputs(rng, b=2, h=2, length=40, keys=56, d=24):
    qkv = [_bf16(rng.randn(b, h, n, d).astype(np.float32)) for n in (length, keys, keys)]
    mask = np.arange(keys)[None] < np.array([[keys - 5], [keys - 20]])
    return qkv, mask, d ** -0.5


def test_masked_attention_bf16_plain_matches_jax(rng):
    """Against the JAX Pallas kernel with bf16 q, k, v (interpret mode, several
    key tiles) and against the XLA bf16 path of the JAX layer
    (nn/transformer.py:414-429), written out in jnp."""
    (q, k, v), mask, scale = _attention_inputs(rng)
    jq, jk, jv = (jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v))
    pallas = np.asarray(masked_attention_pallas(jq, jk, jv, jnp.asarray(mask), q_tile=8,
                                                kv_tile=128, interpret=True, scale=scale))
    a = jnp.einsum("bhld,bhsd->bhls", jq, jk, preferred_element_type=jnp.float32)
    a = jnp.where(jnp.asarray(mask)[:, None, None, :], a, -1e9)
    a = jax.nn.softmax(a / jnp.sqrt(jnp.asarray(q.shape[-1], a.dtype)), axis=-1)
    xla = np.asarray(jnp.einsum("bhls,bhsd->bhld", a.astype(jnp.bfloat16), jv,
                                preferred_element_type=jnp.float32).astype(jnp.bfloat16)
                     .astype(jnp.float32))
    tq, tk, tv = (T(t).bfloat16() for t in (q, k, v))
    got = masked_attention_bf16_plain(tq, tk, tv, T(mask), scale)
    assert got.dtype == torch.bfloat16
    assert torch.equal(masked_attention(tq, tk, tv, T(mask), scale), got)
    assert _rel(got.float().numpy(), xla)[0] <= 1e-5
    worst, mean = _rel(got.float().numpy(), pallas)
    assert worst <= 8e-3 and mean <= 1e-3, (worst, mean)


def _jax_xla_attention(q, k, v, mask):
    """JAX's bf16 XLA attention path (nn/transformer.py:414-429) in jnp, f32 out."""
    jq, jk, jv = (jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v))
    a = jnp.einsum("bhld,bhsd->bhls", jq, jk, preferred_element_type=jnp.float32)
    a = jnp.where(jnp.asarray(mask)[:, None, None, :], a, -1e9)
    a = jax.nn.softmax(a / jnp.sqrt(jnp.asarray(q.shape[-1], a.dtype)), axis=-1)
    return np.asarray(jnp.einsum("bhls,bhsd->bhld", a.astype(jnp.bfloat16), jv,
                                 preferred_element_type=jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _split_attention(q, k, v, mask, scale, blocks=4, tile=32):
    """The arithmetic of the bf16 kernel (csrc/attention.cu) in torch: the
    keys split into ``blocks`` ranges of whole 32-key tiles (one block of a
    cluster each); logits masked (-1e9) and scaled in f32; the row max over
    the ranges; each range's sum of exp(s - max), added in range order;
    p = exp(s - max) * (1 / sum) rounded to bf16; each range's P.V in f32,
    the ranges' partial sums added in order; bf16 out."""
    qf, kf, vf = q.float(), k.float(), v.float()
    n_keys = k.shape[2]
    per = -(-(-(-n_keys // tile)) // blocks) * tile
    ranges = [(a, min(a + per, n_keys)) for a in range(0, n_keys, per)]
    s = torch.einsum("bhld,bhsd->bhls", qf, kf)
    s = torch.where(mask[:, None, None, :], s * scale, torch.full_like(s, -1e9))
    m = torch.stack([s[..., a:b].amax(-1) for a, b in ranges]).amax(0)
    e = torch.exp(s - m[..., None])
    total = sum(e[..., a:b].sum(-1) for a, b in ranges)
    p = (e * (1.0 / total)[..., None]).to(torch.bfloat16).float()
    out = sum(torch.einsum("bhls,bhsd->bhld", p[..., a:b], vf[:, :, a:b]) for a, b in ranges)
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("length,keys,d,one_valid", [
    (704, 704, 108, False), (70, 45, 108, False), (1, 768, 132, False), (768, 1, 132, False),
    (96, 768, 132, True)], ids=["3dmatch", "70x45", "1x768", "768x1", "one-valid-key"])
def test_split_attention_matches_jax(rng, length, keys, d, one_valid):
    """The bf16 kernel's split of the keys over a cluster's four blocks (the
    row max and sum combined across them, the partial P.V sums added in
    f32) changes only the order of f32 sums: held against JAX's XLA path at
    chip_smoke's kernel limit, 1e-2 of the largest entry (one bf16 ulp is
    3.9e-3 of an entry), and 1e-4 in the mean (measured at most 2.5e-3, one
    flipped rounding, and 4.7e-7)."""
    b, h = 2, 2
    q, k, v = (_bf16(rng.randn(b, h, n, d).astype(np.float32)) for n in (length, keys, keys))
    mask = np.arange(keys)[None] < np.array([[keys], [max(keys - 37, 1)]])
    if one_valid:
        mask[0] = False
        mask[0, keys // 2] = True
    ref = _jax_xla_attention(q, k, v, mask)
    got = _split_attention(*(T(t).bfloat16() for t in (q, k, v)), T(mask), d ** -0.5)
    worst, mean = _rel(got.float().numpy(), ref)
    assert worst <= 1e-2 and mean <= 1e-4, (worst, mean)


def test_bf16_wrappers_on_the_cpu(rng):
    """CPU tensors take the plain bf16 versions and launch nothing; the bf16
    kernels' wrappers refuse CPU tensors (a CUDA tensor launches them or
    raises), and so does a dtype they do not take."""
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda_bf16
    from diffreg_tpu_torch.ops.kpconv import kpconv_bf16_table_aligned, kpconv_cuda_bf16

    (q, k, v), mask, scale = _attention_inputs(rng)
    tq, tk, tv = (T(t).bfloat16() for t in (q, k, v))
    before = masked_attention_cuda_bf16.launches, kpconv_cuda_bf16.launches
    masked_attention(tq, tk, tv, T(mask), scale)
    qp, sp = T(rng.rand(1, 4, 3).astype(np.float32)), T(rng.rand(1, 6, 3).astype(np.float32))
    inds = T(rng.randint(0, 7, (1, 4, 3)).astype(np.int32))
    x, w = T(rng.randn(1, 6, 2).astype(np.float32)), T(rng.randn(15, 2, 8).astype(np.float32))
    kp = T(rng.randn(15, 3).astype(np.float32) * 0.01)
    kpconv_batched(qp, sp, inds, x, kp, w, 0.05, compute_dtype="bfloat16")
    assert (masked_attention_cuda_bf16.launches, kpconv_cuda_bf16.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        masked_attention_cuda_bf16(tq, tk, tv, T(mask), scale)
    with pytest.raises(ValueError, match="CUDA"):
        kpconv_cuda_bf16(qp, kpconv_bf16_table_aligned(sp, x), inds, kp, w.bfloat16(), 0.05)
    with pytest.raises(ValueError, match="compute_dtype"):
        kpconv_batched(qp, sp, inds, x, kp, w, 0.05, compute_dtype="float16")


# ---------------------------------------------------------------- layers


def _pe(rng, b, n, d):
    xyz = (rng.rand(b, n, 3) * 2 - 1).astype(np.float32)
    return np.array(jax_volumetric_pe(jnp.asarray(xyz), d, ORIGIN, VOXEL, "rotary"))


@pytest.mark.parametrize("flash", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("kind", ["self", "cross"])
def test_geometry_attention_layer_bf16(rng, kind, flash):
    b, length, keys, d, h = 2, 20, 24, 48, 2
    x = rng.randn(b, length, d).astype(np.float32)
    src = x if kind == "self" else rng.randn(b, keys, d).astype(np.float32)
    x_pe = _pe(rng, b, length, d)
    s_pe = x_pe if kind == "self" else _pe(rng, b, keys, d)
    x_mask = np.arange(length)[None] < np.array([[length], [length - 5]])
    s_mask = x_mask if kind == "self" else np.arange(keys)[None] < np.array([[keys - 3],
                                                                             [keys - 9]])
    layer = JaxAttentionLayer(d, h, "rotary", use_flash=flash, compute_dtype="bfloat16",
                              flash_q_tile=8, flash_kv_tile=128)
    args = tuple(map(jnp.asarray, (x, src, x_pe, s_pe, x_mask, s_mask)))
    if kind == "self":
        args = (args[0], args[0], args[2], args[2], args[4], args[4])
    params = layer.init(jax.random.PRNGKey(1), *args)["params"]
    ref = np.asarray(layer.apply({"params": params}, *args))
    sd = state_dict_from_flax(_flat(params, "denoising_transformer/layer0_self/"), {})
    port = GeometryAttentionLayer(d, h, "bfloat16")
    port.load_state_dict({k.split("layers.0.")[1]: v for k, v in sd.items()})
    with torch.no_grad():
        xt = T(x)
        got = port(xt, xt if kind == "self" else T(src), T(x_pe), T(s_pe), T(s_mask))
    assert got.dtype == torch.float32
    worst, mean = _rel(got.numpy()[x_mask], ref[x_mask])
    limits = (1e-2, 1.5e-3) if flash else (1e-4, 1e-6)
    assert worst <= limits[0] and mean <= limits[1], (worst, mean)


@pytest.mark.parametrize("flash", [False, True], ids=["xla", "pallas"])
def test_repositioning_transformer_bf16(rng, flash):
    """The denoiser's six layers (self, cross) x 3, bf16, against JAX's (head
    lanes aligned and rotary in half-split layout there: the same sums)."""
    b, s, t = 2, 20, 24
    cfg = jax_preset_tiny("3dmatch").coarse_transformer
    jcfg = dataclasses.replace(cfg, layer_types=("self", "cross") * 3, compute_dtype="bfloat16",
                               flash_attention=flash, flash_q_tile=32, flash_kv_tile=128)
    d = cfg.feature_dim
    feats = [rng.randn(b, n, d).astype(np.float32) for n in (s, t)]
    pcd = [(rng.rand(b, n, 3) * 2 - 1).astype(np.float32) for n in (s, t)]
    masks = [np.arange(n)[None] < np.array([[n], [n - 6]]) for n in (s, t)]
    args = tuple(map(jnp.asarray, (*feats, *pcd, *masks)))
    # the parameters do not depend on the attention path: initialise without Pallas
    init = JaxTransformer(dataclasses.replace(jcfg, flash_attention=False)).init
    params = jax.jit(init)(jax.random.PRNGKey(2), *args)["params"]
    ref = jax.jit(JaxTransformer(jcfg).apply)({"params": params}, *args)
    sd = state_dict_from_flax(_flat(params, "denoising_transformer/"), {})
    pcfg = dataclasses.replace(preset_tiny().coarse_transformer,
                               layer_types=("self", "cross") * 3, compute_dtype="bfloat16")
    port = RepositioningTransformer(pcfg)
    port.load_state_dict({k.split("denoising_transformer.")[1]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port(*map(T, (*feats, *pcd, *masks)))
    limits = (3e-2, 5e-3) if flash else (1e-4, 1e-6)
    for i in range(2):
        worst, mean = _rel(got[i].numpy()[masks[i]], np.asarray(ref[i])[masks[i]])
        assert worst <= limits[0] and mean <= limits[1], (i, worst, mean)


# ---------------------------------------------------------------- the whole DDIM


def _jax_cfg(gate):
    cfg = jax_preset_tiny("3dmatch", sample_steps=2)
    proc = dataclasses.replace(cfg.procrustes, max_condition_num=gate)
    return dataclasses.replace(
        cfg, procrustes=proc,
        kpfcn=dataclasses.replace(cfg.kpfcn, compute_dtype="bfloat16"),
        coarse_transformer=dataclasses.replace(cfg.coarse_transformer, procrustes=proc,
                                               compute_dtype="bfloat16"))


def _port_model(sd, gate, fast=True):
    cfg = with_condition_gate(preset_tiny(2), gate)
    model = DiffusionMatchingModel(with_fast_path(cfg) if fast else cfg, device="cpu")
    _, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected
    return model


@pytest.fixture(scope="module")
def setup():
    """JAX's weights, converted once; JAX's bf16 DDIM at gates 0 and 40 under
    ``precision: default`` (restored after)."""
    jbatch, spec, _ = jax_synthetic_batch(batch_size=B, n_points=N_POINTS, seed=DATA_SEED)
    pbatch, _, _ = synthetic_batch(batch_size=B, n_points=N_POINTS, seed=DATA_SEED)
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(lambda b, r: JaxModel(_jax_cfg(0.0)).init(
        {"params": r}, b, r, mode="train"))(jbatch, rng)
    sd = state_dict_from_flax(_flat(variables["params"]), _flat(variables["buffers"]))
    x_init = np.random.RandomState(X_SEED).randn(B, spec.n_src, spec.n_tgt).astype(np.float32)
    before = jax_precision.get_precision()
    jax_precision.set_precision("default")
    try:
        refs = {gate: jax.jit(lambda v, b, x, g=gate: JaxModel(_jax_cfg(g)).apply(
            v, b, jax.random.PRNGKey(0), mode="ddim", x_init=x))(variables, jbatch,
                                                                 jnp.asarray(x_init))
            for gate in (0.0, 40.0)}
        enc = jax.jit(lambda v, b: JaxModel(_jax_cfg(0.0)).apply(
            v, b, method=lambda m, bb: m.encode(bb)))(variables, jbatch)
    finally:
        jax_precision._PRECISION = before
    return pbatch, sd, x_init, refs, enc


def test_encode_bf16_matches_jax_from_the_same_weights(setup):
    """The converted f32 weights drive both dtypes: the bf16 encode holds to
    JAX's bf16 encode, and the f32 model loaded from the same state dict
    gives features that differ from it by bf16-sized amounts only."""
    pbatch, sd, _, _, enc = setup
    with torch.no_grad():
        got = _port_model(sd, 0.0).encode(pbatch)
        f32 = _port_model(sd, 0.0, fast=False).encode(pbatch)
    valid = [pbatch.src_mask.numpy(), pbatch.tgt_mask.numpy()]
    for r, g, f, v in zip(enc[:2], got[:2], f32[:2], valid):
        r, g, f = np.asarray(r)[v], g.numpy()[v], f.numpy()[v]
        worst, mean = _rel(g, r)
        assert worst <= 1e-2 and mean <= 1e-3, (worst, mean)
        assert _rel(f, r)[1] > 2e-3



def test_bf16_training_runs(setup):
    """bf16 trains (tests/test_torch_train_bf16.py holds it against
    jax.grad): train_forward on the CPU's plain bf16 versions gives finite
    losses and a finite gradient for every trained parameter it reaches."""
    from diffreg_tpu_torch.engine.losses import LossConfig, diffreg_loss

    pbatch, sd, _, _, _ = setup
    model = _port_model(sd, 200.0)
    out = model.train_forward(pbatch, **model.draw_train_inputs(
        pbatch, torch.Generator().manual_seed(0)))
    loss, info = diffreg_loss(out, pbatch, LossConfig())
    assert all(bool(torch.isfinite(v)) for v in info.values())
    params = [p for _, p in model.named_trained_parameters()]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    reached = [g for g in grads if g is not None]
    assert len(reached) == len(params) - 2      # not the positioning matcher's two
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in reached)


@pytest.mark.parametrize("gate", [0.0, 40.0])
def test_ddim_bf16_matches_jax(setup, gate):
    pbatch, sd, x_init, refs, _ = setup
    ref = refs[gate]
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    u = np.stack([np.asarray(jax.random.uniform(k, (H, 3))) for k in keys])
    got = register(_port_model(sd, gate), pbatch, T(x_init), T(u), device="cpu")
    if gate > 0:
        # the steps' Procrustes conditions are far from the gate: the same warps
        assert np.all(np.abs(got["step_condition"].numpy() - gate) > 10.0)
    sm, tm = pbatch.src_mask.numpy(), pbatch.tgt_mask.numpy()
    valid = sm[:, :, None] & tm[:, None, :]
    conf = np.asarray(ref["conf_matrix_pred"])
    limit = 2e-3 * np.abs(conf[valid]).max()
    err = np.abs(got["conf_matrix_pred"].numpy() - conf)[valid].max()
    assert err <= limit, (err, limit)
    # the top-1 union mask: every difference lies in a near-tie row or column
    masked = np.where(valid, conf, -1.0)
    rows = -np.partition(-masked, 1, axis=2)
    cols = -np.partition(-masked, 1, axis=1)
    row_tie = rows[:, :, 0] - rows[:, :, 1] <= 2 * limit
    col_tie = cols[:, 0, :] - cols[:, 1, :] <= 2 * limit
    differ = (got["corr_mask"].numpy() != np.asarray(ref["corr_mask"])) & valid
    bb, ii, jj = np.nonzero(differ)
    assert np.all(row_tie[bb, ii] | col_tie[bb, jj])
    assert (~row_tie & sm).any()                   # some rows are held exactly
    for key in ("rotation_pred", "translation_pred"):
        assert np.isfinite(got[key].numpy()).all()
