"""The port's frozen towers and the dino 2D-3D model against the JAX package,
on the CPU.

Towers, at small widths with random weights (every flax leaf redrawn from a
seed, so that biases, LayerScale and the transposed convolutions' kernels all
count): the half-pixel resize against ``jax.image.resize`` (bicubic and
bilinear, up and down); DINOv2 (embed 64, 2 blocks, 2 heads, native grid
10 x 10) on a 126 x 168 image, whose 9 x 12 patch grid resizes the position
embeddings down in one axis and up in the other: final tokens, and every
block's taps with ``norm_taps`` off and on; DepthAnything (embed 64, 4 blocks,
DPT features 16, out channels 8/16/32/32): the depth map, and
``TowerRunner.mono_depth`` at a 120 x 160 image whose resizes to the 126 x 168
multiple of 14 and back are not the identity; the weight bridge's round
trip; ``load_tower_runner`` on torch state_dicts.

The dino model (``use_dino``, ``use_mono_depth``, as configs/test/
rgbdv2_dino.yaml, at the size of tests/test_2d3d.py's tower test: a 56 x 56
image, stride 14, dino_dim 64, widths 16/32, one fusion block pair,
procrustes_max_condition 1e9 so that the warp is active at random init; 384
points rather than 128, with which only 2 or 3 nodes pass the member-count
gate and every warp is degenerate (condition inf) or ill-conditioned (up to
2.5e4, where the packages' roundings move the pose); with 30 gated nodes a
pair, every warp of these draws has a condition below 300):
encode, the DepthAnything-lifted patch centres, ``backbone`` and ``ddim``
mode with JAX's DDIM start passed in, and one Adam step of ``train_forward``
with JAX's train draws, in which dino_proj, depth_coffa and depth_coffb get
non-zero gradients equal to ``jax.grad``'s. JAX compiles each tower and the
model once (module fixtures).

Tolerances: the resize to 2e-5 of its scale (PyTorch's antialiased
interpolation computes the sample positions in another order: measured
1.4e-5 upsampling 120 -> 126, 1e-6 elsewhere). The towers' tokens, taps and
depth to 1e-4 of their scale (float32 sums of 64- to 256-wide products and
2 to 4 blocks in another order). The model: features to 1e-4 of their scale
(``FEAT_TOL`` of tests/test_torch_2d3d.py), patch centres to 1e-6,
confidences to 1e-5 absolute and the top-1 masks equal except at near-ties,
the loss to 1e-5 relative, each gradient to 5e-4 of its tensor's largest
entry, and Adam's first step to 1e-3 of lr where the gradient is clear of 0
(the limits of tests/test_torch_train2d3d.py).
"""
import torch_native_guard  # noqa: F401  (makes the JAX native library whole first)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from diffreg_tpu.data.synthetic2d3d import synthetic_2d3d_batch as jax_synthetic_2d3d_batch
from diffreg_tpu.engine import losses2d3d as jl
from diffreg_tpu.engine.losses import LossConfig as JaxLossConfig
from diffreg_tpu.engine.train import OptimConfig as JaxOptimConfig
from diffreg_tpu.engine.train import make_optimizer as jax_make_optimizer
from diffreg_tpu.models import pipeline_2d3d as jp
from diffreg_tpu.models import towers as jtowers
from diffreg_tpu.nn import depth_anything as jda
from diffreg_tpu.nn import dinov2 as jdino
from diffreg_tpu.nn import point_backbone as jpb
from diffreg_tpu.nn.matching import MatchingConfig as JaxMatchingConfig
from diffreg_tpu.ops import partition as jpart
from diffreg_tpu_torch import convert
from diffreg_tpu_torch.data.synthetic2d3d import synthetic_2d3d_batch
from diffreg_tpu_torch.engine import losses2d3d as pl
from diffreg_tpu_torch.engine.losses import LossConfig
from diffreg_tpu_torch.engine.train import OptimConfig
from diffreg_tpu_torch.engine.train2d3d import create_train_state_2d3d, make_train_step_2d3d
from diffreg_tpu_torch.models import pipeline_2d3d as pp
from diffreg_tpu_torch.models import towers as ptowers
from diffreg_tpu_torch.nn import depth_anything as pda
from diffreg_tpu_torch.nn import dinov2 as pdino
from diffreg_tpu_torch.nn import point_backbone as ppb
from diffreg_tpu_torch.nn.matching import MatchingConfig
from diffreg_tpu_torch.ops import vision as pv
from test_torch_2d3d import FEAT_TOL, _close, _flat, _mask_agrees, _np, _to_jax_batch, _valid

T = torch.from_numpy
RESIZE_TOL, TOWER_TOL = 2e-5, 1e-4
CENTER_TOL, CONF_TOL, LOSS_TOL, GRAD_TOL = 1e-6, 1e-5, 1e-5, 5e-4
LR = 1e-4
DINO_CFG = dict(embed_dim=64, depth=2, num_heads=2, img_size=140)
DA_VIT = dict(embed_dim=64, depth=4, num_heads=2, img_size=140)
DA_DPT = dict(features=16, out_channels=(8, 16, 32, 32))
IMAGE_HW = (126, 168)
B, HW, N_POINTS, DINO_DIM, STEPS, TRAIN_KEY = 2, (56, 56), 384, 64, 2, 3
FUSION_BLOCKS = ("self", "cross")       # one block pair: JAX compiles the model in ~40 s


def _redraw(model, seed, *args):
    """Flax params of ``model`` with every leaf drawn from ``seed``: kernels
    normal / sqrt(fan in), LayerNorm scales and LayerScale gammas
    1 + N(0, 0.1), the rest N(0, 0.1). The tree's shapes come from
    ``jax.eval_shape`` (no compile of the init)."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args))["params"]
    rs = np.random.RandomState(seed)
    out = {}
    for path, leaf in flatten_dict(dict(shapes)).items():
        shape = leaf.shape
        if path[-1] == "kernel":
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif path[-1] in ("scale", "gamma"):
            v = 1.0 + 0.1 * rs.randn(*shape)
        else:
            v = 0.1 * rs.randn(*shape)
        out[path] = jnp.asarray(v, jnp.float32)
    return unflatten_dict(out)


def _image(seed, hw):
    return np.random.RandomState(seed).rand(1, *hw, 3).astype(np.float32)


# ---------------------------------------------------------------- towers


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("shapes", [((37, 37), (34, 45)), ((10, 10), (9, 12)),
                                    ((120, 160), (126, 168)), ((126, 168), (120, 160))],
                         ids=["37-to-34x45", "10-to-9x12", "up", "down"])
def test_resize_matches_jax(method, shapes):
    (h, w), (nh, nw) = shapes
    x = np.random.RandomState(h + w).randn(2, h, w, 3).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, nh, nw, 3), method)
    got = pv.resize(T(x).permute(0, 3, 1, 2), (nh, nw), method).permute(0, 2, 3, 1)
    _close(got, ref, RESIZE_TOL, f"{method} {shapes}")
    assert pv.resize(T(x).permute(0, 3, 1, 2), (h, w), method).data_ptr() \
        == T(x).permute(0, 3, 1, 2).data_ptr()


@pytest.fixture(scope="module")
def dino():
    """A small DINOv2 with redrawn weights: JAX's outputs (final tokens, taps
    plain and normed) in one compile, and the port's model carrying them."""
    cfg = jdino.DinoV2Config(**DINO_CFG)
    model = jdino.DinoVisionTransformer(cfg)
    image = _image(1, IMAGE_HW)
    params = _redraw(model, 11, image)

    def run(p, x):
        tokens, taps = model.apply({"params": p}, x)
        return tokens, taps, model.apply({"params": p}, x, norm_taps=True)[1]
    ref = jax.jit(run)(params, image)
    port = pdino.DinoVisionTransformer(pdino.DinoV2Config(**DINO_CFG))
    port.load_state_dict(convert.dinov2_state_dict_from_flax(_flat(params)), strict=True)
    return {"params": params, "image": image, "ref": ref, "port": port.eval()}


def test_dinov2_matches_jax(dino):
    """Final tokens [1, 108, 64] and both blocks' taps [1, 9, 12, 64], with
    norm_taps off and on."""
    tokens, taps, normed = dino["ref"]
    x = T(dino["image"]).permute(0, 3, 1, 2)
    with torch.no_grad():
        got_tokens, got_taps = dino["port"](x)
        _, got_normed = dino["port"](x, norm_taps=True)
        _, only = dino["port"](x, return_layers=(1,))
    assert got_tokens.shape == (1, 108, 64) and len(got_taps) == len(got_normed) == 2
    _close(got_tokens, tokens, TOWER_TOL, "tokens")
    for i in range(2):
        _close(got_taps[i], taps[i], TOWER_TOL, f"tap {i}")
        _close(got_normed[i], normed[i], TOWER_TOL, f"normed tap {i}")
    assert len(only) == 1 and torch.equal(only[0], got_taps[1])


@pytest.fixture(scope="module")
def depth_anything():
    """A small DepthAnything with redrawn weights; the JAX TowerRunner's
    jitted apply (one compile, reused by mono_depth at the same shape)."""
    vit, dpt = jdino.DinoV2Config(**DA_VIT), jda.DPTConfig(**DA_DPT)
    model = jda.DepthAnything(vit, dpt)
    x = _image(2, IMAGE_HW)
    params = _redraw(model, 12, x)
    runner = jtowers.TowerRunner(da_variables={"params": params}, da_vit_cfg=vit, da_dpt_cfg=dpt)
    port = pda.DepthAnything(pdino.DinoV2Config(**DA_VIT), pda.DPTConfig(**DA_DPT))
    port.load_state_dict(convert.depth_anything_state_dict_from_flax(_flat(params)), strict=True)
    return {"params": params, "image": x, "runner": runner, "port": port.eval(),
            "ref": runner._da_fn(x)}


def test_depth_anything_matches_jax(depth_anything):
    """The depth map [1, 126, 168]: the DPT head's transposed convolutions
    (k4 s4, k2 s2) carry the bridge's kernel flip, the stride-2 resize3 its
    symmetric pad."""
    with torch.no_grad():
        got = depth_anything["port"](T(depth_anything["image"]).permute(0, 3, 1, 2))
    ref = np.asarray(depth_anything["ref"])
    assert got.shape == (1, *IMAGE_HW) and float(np.abs(ref).max()) > 0
    _close(got, ref, TOWER_TOL, "depth")


def test_tower_runner_matches_jax(dino, depth_anything):
    """``dino_tokens`` [1, 9, 12, 64] and ``mono_depth`` at a 120 x 160 image
    with target (126, 168): bicubic up to 126 x 168, the tower, bilinear back
    down to 120 x 160 (neither resize is the identity)."""
    vit, dpt = jdino.DinoV2Config(**DA_VIT), jda.DPTConfig(**DA_DPT)
    assert jtowers._multiple_of_14_lower_bound(120, 160, *IMAGE_HW) \
        == ptowers._multiple_of_14_lower_bound(120, 160, *IMAGE_HW) == IMAGE_HW
    for args in ((480, 640, 476, 630), (100, 300, 476, 630)):
        assert ptowers._multiple_of_14_lower_bound(*args) \
            == jtowers._multiple_of_14_lower_bound(*args)
    image = _image(3, (120, 160))
    ref = depth_anything["runner"].mono_depth(image, target_hw=IMAGE_HW)
    runner = ptowers.TowerRunner(dino["port"], depth_anything["port"], device="cpu")
    got = runner.mono_depth(image, target_hw=IMAGE_HW)
    assert got.shape == (1, 120, 160)
    _close(got, ref, TOWER_TOL, "mono_depth")
    jrunner = jtowers.TowerRunner(dino_variables={"params": dino["params"]},
                                  dino_cfg=jdino.DinoV2Config(**DINO_CFG), da_vit_cfg=vit)
    _close(runner.dino_tokens(dino["image"]), jrunner.dino_tokens(dino["image"]), TOWER_TOL,
           "dino_tokens")
    assert ptowers.TowerRunner(device="cpu").dino_tokens(image) is None


def test_tower_weights_round_trip(dino, depth_anything):
    """flax params -> the port's state_dict -> tools/convert_towers.py (which
    reads the reference torch modules' names) -> the same flax params: the
    port's names are the reference's. The JAX converter does not flip the
    transposed convolutions' kernels, so resize0 / resize1 come back flipped
    (the JAX DepthAnything on a converted release computes another function
    than the reference's), and it reads the reference's unused
    refinenet4.resConfUnit1."""
    from tools.convert_towers import convert_depth_anything, convert_dinov2

    sd = {k: v.numpy() for k, v in dino["port"].state_dict().items()}
    back = _flat(convert_dinov2(sd))
    assert back.keys() == _flat(dino["params"]).keys()
    for key, val in _flat(dino["params"]).items():
        np.testing.assert_array_equal(back[key], val, err_msg=key)

    sd = {k: v.numpy() for k, v in depth_anything["port"].state_dict().items()}
    unused = "depth_head.scratch.refinenet4.resConfUnit1"
    for conv in ("conv1", "conv2"):
        sd[f"{unused}.{conv}.weight"] = np.zeros((16, 16, 3, 3), np.float32)
        sd[f"{unused}.{conv}.bias"] = np.zeros(16, np.float32)
    back = _flat(convert_depth_anything(sd))
    ref = _flat(depth_anything["params"])
    assert set(back) - set(ref) == {f"head/fusion4/rcu1/{c}/{leaf}" for c in ("conv1", "conv2")
                                    for leaf in ("kernel", "bias")}
    for key, val in ref.items():
        flip = key in ("head/resize0/kernel", "head/resize1/kernel")
        np.testing.assert_array_equal(back[key], val[::-1, ::-1] if flip else val, err_msg=key)


def test_load_tower_runner(tmp_path, dino, depth_anything):
    """Torch state_dict files with the released checkpoints' unused entries
    (DINOv2's mask token, refinenet4.resConfUnit1) load and give the same
    outputs; a directory (the JAX package's orbax format) is refused."""
    sd = dict(dino["port"].state_dict(), mask_token=torch.zeros(1, 64))
    torch.save(sd, tmp_path / "dino.pth")
    sd = dict(depth_anything["port"].state_dict())
    sd["pretrained.mask_token"] = torch.zeros(1, 64)
    sd["depth_head.scratch.refinenet4.resConfUnit1.conv1.weight"] = torch.zeros(16, 16, 3, 3)
    torch.save({"state_dict": sd}, tmp_path / "da.pth")
    runner = ptowers.load_tower_runner(
        str(tmp_path / "dino.pth"), str(tmp_path / "da.pth"), device="cpu",
        dino_cfg=pdino.DinoV2Config(**DINO_CFG), da_vit_cfg=pdino.DinoV2Config(**DA_VIT),
        da_dpt_cfg=pda.DPTConfig(**DA_DPT))
    same = ptowers.TowerRunner(dino["port"], depth_anything["port"], device="cpu")
    image = _image(4, IMAGE_HW)
    np.testing.assert_array_equal(runner.dino_tokens(image), same.dino_tokens(image))
    np.testing.assert_array_equal(runner.mono_depth(image, IMAGE_HW),
                                  same.mono_depth(image, IMAGE_HW))
    assert not any(p.requires_grad for p in runner.dino.parameters())
    with pytest.raises(ValueError, match="orbax"):
        ptowers.load_tower_runner(str(tmp_path), device="cpu")


def test_synthesised_towers_run():
    """``synthesise_tower_weights`` gives finite, non-trivial outputs (the
    card's smoke test runs the full-width towers on them)."""
    model = pda.DepthAnything(pdino.DinoV2Config(**DA_VIT), pda.DPTConfig(**DA_DPT))
    ptowers.synthesise_tower_weights(model, seed=0)
    assert float(model.pretrained.blocks[0].ls1.gamma.detach()[0]) == 1.0
    with torch.no_grad():
        depth = model(T(_image(5, (56, 70))).permute(0, 3, 1, 2))
    assert depth.shape == (1, 56, 70) and bool(torch.isfinite(depth).all())
    assert float(depth.max()) > 0


# ---------------------------------------------------------------- the dino model


def _jax_cfg():
    return jp.Pipeline2D3DConfig(
        img_out_dim=16, img_base_dim=16,
        pcd_backbone=jpb.PointBackboneConfig(output_dim=16, init_dim=8, init_radius=0.1,
                                             init_sigma=0.08),
        hidden_dim=32, output_dim=32, num_heads=2, fusion_blocks=FUSION_BLOCKS,
        matching=JaxMatchingConfig(feature_dim=32), sample_steps=STEPS, coarse_stride=14,
        use_dino=True, use_mono_depth=True,
        dino_dim=DINO_DIM, procrustes_max_condition=1e9)


def _port_cfg():
    return pp.Pipeline2D3DConfig(
        img_out_dim=16, img_base_dim=16,
        pcd_backbone=ppb.PointBackboneConfig(output_dim=16, init_dim=8, init_radius=0.1,
                                             init_sigma=0.08),
        hidden_dim=32, output_dim=32, num_heads=2, fusion_blocks=FUSION_BLOCKS,
        matching=MatchingConfig(feature_dim=32), sample_steps=STEPS, coarse_stride=14,
        use_dino=True, use_mono_depth=True,
        dino_dim=DINO_DIM, procrustes_max_condition=1e9)


def _flax_from_port(sd, shapes):
    """The JAX DiffReg2D3D variables holding the port's state_dict ``sd``: each
    flax path of ``shapes`` (``jax.eval_shape`` of the init, so no compile),
    read through the bridge's translation backwards."""
    layouts = {None: lambda a: a, "T": lambda a: a.T,
               "conv2d": lambda a: a.transpose(2, 3, 1, 0)}
    out = {}
    for path, leaf in flatten_dict(dict(shapes)).items():
        key, layout = convert._translate_2d3d("/".join(path[1:]))
        out[path] = jnp.asarray(layouts[layout](_np(sd[key])))
        assert out[path].shape == leaf.shape, path
    return unflatten_dict(out)


@pytest.fixture(scope="module")
def model_setup():
    """The synthetic dino batch (stand-in tower outputs, the training GT) in
    both packages; the port's model (seed 9, the depth affine moved off
    (1, 0) so that the lift's arithmetic counts) and JAX's variables holding
    its weights; in one JAX compile the DDIM outputs (from a DDIM start drawn
    from a key and passed to the port), the train loss with its outputs (the
    backbone's coarse pass), its gradient and Adam's first step."""
    batch = synthetic_2d3d_batch(batch_size=B, img_hw=HW, n_points=N_POINTS, seed=0,
                                 coarse_stride=14, with_full_gt=True, with_dino=True,
                                 dino_dim=DINO_DIM, with_mono_depth=True)
    jbatch = _to_jax_batch(batch)
    port = pp.DiffReg2D3D(_port_cfg(), device="cpu", seed=9)
    with torch.no_grad():
        port.depth_coffa.fill_(1.1)
        port.depth_coffb.fill_(0.05)
    sd = {k: v.clone() for k, v in port.state_dict().items()}
    model = jp.DiffReg2D3D(_jax_cfg())
    rng = jax.random.PRNGKey(0)
    variables = _flax_from_port(sd, jax.eval_shape(
        lambda: model.init({"params": rng}, jbatch, rng, mode="train")))
    params, buffers = variables["params"], variables["buffers"]
    n, m = batch.points[-1].shape[1], (HW[0] // 14) * (HW[1] // 14)
    x_init = jax.random.normal(jax.random.PRNGKey(5), (B, n, m))
    key = jax.random.PRNGKey(TRAIN_KEY)
    rng_t, rng_n = jax.random.split(key)
    draws = {"t": T(np.array(jax.random.randint(rng_t, (B,), 0, 1000))),
             "noise": T(np.array(jax.random.normal(rng_n, (B, n, m))))}
    circle, fine = jl.CircleLossConfig(), jl.FineLossConfig()
    tx = jax_make_optimizer(JaxOptimConfig(optimizer="adam", lr=LR))

    def run(p, b):
        ddim = model.apply({"params": p, "buffers": buffers}, b, rng, mode="ddim",
                           x_init=x_init)

        def loss_fn(q):
            out = model.apply({"params": q, "buffers": buffers}, b, key, mode="train")
            loss, info = jl.loss_2d3d(out, circle, JaxLossConfig(), batch=b, fine_cfg=fine)
            return loss, (info, out)
        (loss, (info, out)), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return ddim, loss, info, out, grads, optax.apply_updates(p, updates)

    ref = dict(zip(("ddim", "loss", "info", "train", "grads", "after"),
                   jax.jit(run)(params, jbatch)))
    # backbone mode is the train forward's coarse pass and the top-1 union mask
    train = ref["train"]
    ref["backbone"] = {**train, "corr_mask": jpart.batch_mutual_topk_select(
        train["conf_matrix_pred"], 1, train["node_masks"], train["img_valid_c"], mutual=False)}
    return {"batch": batch, "jbatch": jbatch, "ref": ref, "sd": sd, "port": port,
            "x_init": T(np.array(x_init)), "draws": draws}


def test_dino_synthetic_batch_matches_jax(model_setup):
    """The stand-in tower outputs are drawn where the JAX package draws them:
    every array of the batch equal."""
    ref = jax_synthetic_2d3d_batch(batch_size=B, img_hw=HW, n_points=N_POINTS, seed=0,
                                   coarse_stride=14, with_full_gt=True, with_dino=True,
                                   dino_dim=DINO_DIM, with_mono_depth=True)
    got = model_setup["batch"]
    assert got.dino_feats.shape == (B, 4, 4, DINO_DIM) and got.mono_depth.shape == (B, *HW)
    for name, val in ref._asdict().items():
        g = getattr(got, name)
        if val is None:
            assert g is None, name
            continue
        for a, r in (zip(g, val) if isinstance(val, tuple) else [(g, val)]):
            np.testing.assert_array_equal(_np(a), np.asarray(r), err_msg=name)


def test_dino_encode_and_centres(model_setup):
    """The encoder with the DINO injection (fine image features), the fused
    coarse tokens of both sides, the real and the DepthAnything-lifted patch
    centres (affine (1.1, 0.05))."""
    s = model_setup
    with torch.no_grad():
        enc = s["port"].encode(s["batch"])
        out = s["port"](s["batch"], mode="backbone")
    ref = s["ref"]["backbone"]
    assert enc["dino_tokens"].shape == (B, 16, DINO_DIM)
    _close(enc["img_feats_f"], ref["img_feats_f"], FEAT_TOL, "fine image features")
    _close(out["img_feats_c"], ref["img_feats_c"], FEAT_TOL, "fused image tokens")
    pad = _np(s["batch"].masks[-1])
    _close(_np(out["pcd_feats_c"])[pad], np.asarray(ref["pcd_feats_c"])[pad], FEAT_TOL,
           "fused node tokens")
    _close(out["patch_centers"], ref["patch_centers"], CENTER_TOL, "patch centres")
    _close(out["patch_centers_da"], ref["patch_centers_da"], CENTER_TOL, "lifted centres")
    assert float(np.abs(_np(out["patch_centers_da"]) - _np(out["patch_centers"])).max()) > 0.05


@pytest.mark.parametrize("mode", ["backbone", "ddim"])
def test_dino_model_matches_jax(model_setup, mode):
    """Confidences and the top-1 masks in backbone mode and after the DDIM
    (JAX's start passed in), whose node warp targets the lifted centres."""
    s = model_setup
    with torch.no_grad():
        got = s["port"](s["batch"], mode=mode, x_init=s["x_init"] if mode == "ddim" else None)
    ref = s["ref"][mode]
    for key in ("node_masks", "img_valid_c"):
        np.testing.assert_array_equal(_np(got[key]), np.asarray(ref[key]), err_msg=key)
    valid = _valid(ref)
    conf, ref_conf = _np(got["conf_matrix_pred"]), np.asarray(ref["conf_matrix_pred"])
    assert np.abs(conf - ref_conf)[valid].max() <= CONF_TOL
    _mask_agrees(_np(got["corr_mask"]), np.asarray(ref["corr_mask"]), ref_conf, valid,
                 2 * CONF_TOL)
    assert int(ref["corr_mask"].sum()) > 0


def test_dino_train_step_matches_jax(model_setup):
    """One Adam step of ``make_train_step_2d3d`` on ``train_forward`` with JAX's
    draws: the loss terms, every parameter's gradient against ``jax.grad``
    (dino_proj, both fusions' img_in_proj_dino / img_in_proj_all, depth_coffa
    and depth_coffb among them, each non-zero), and the parameters after the
    step."""
    s = model_setup
    model = pp.DiffReg2D3D(_port_cfg(), device="cpu", seed=9)
    model.load_state_dict(s["sd"], strict=True)
    out = model.train_forward(s["batch"], **s["draws"])
    loss, _ = pl.loss_2d3d(out, pl.CircleLossConfig(), LossConfig(), batch=s["batch"],
                           fine_cfg=pl.FineLossConfig())
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    model = pp.DiffReg2D3D(_port_cfg(), device="cpu", seed=9)
    model.load_state_dict(s["sd"], strict=True)
    state = create_train_state_2d3d(model, OptimConfig(optimizer="adam", lr=LR))
    step = make_train_step_2d3d(pl.CircleLossConfig(), LossConfig(), pl.FineLossConfig())
    state, info = step(state, s["batch"], s["draws"])
    ref_info = s["ref"]["info"]
    assert bool(info["grads_finite"])
    for key in ("circle", "gt_hat", "fine", "loss"):
        np.testing.assert_allclose(float(info[key]), float(ref_info[key]), rtol=LOSS_TOL,
                                   err_msg=key)
    ref_grads = convert.state_dict_2d3d_from_flax(_flat(s["ref"]["grads"]), {})
    new = ("dino_proj.weight", "dino_proj.bias", "depth_coffa", "depth_coffb",
           "transformer.img_in_proj_dino.weight", "transformer.img_in_proj_all.weight",
           "denoising_transformer.img_in_proj_dino.weight",
           "denoising_transformer.img_in_proj_all.weight")
    assert set(new) <= set(ref_grads) == set(dict(model.named_parameters()))
    largest = max(float(g.abs().max()) for g in ref_grads.values())
    for name, ref in ref_grads.items():
        if name.startswith("coarse_matching."):
            assert name not in grads and not ref.any(), name
            continue
        assert name in grads and float(ref.abs().max()) > 0, name
        if name.endswith("k_token_layer.bias"):
            assert max(float(ref.abs().max()), float(grads[name].abs().max())) < 1e-8 * largest
            continue
        np.testing.assert_allclose(_np(grads[name]), _np(ref), rtol=0,
                                   atol=GRAD_TOL * float(ref.abs().max()), err_msg=name)
    params = dict(model.named_parameters())
    for name, after in convert.state_dict_2d3d_from_flax(_flat(s["ref"]["after"]), {}).items():
        ref_step = _np(after) - _np(s["sd"][name])
        got_step = _np(params[name]) - _np(s["sd"][name])
        assert np.abs(got_step).max() <= LR * (1 + 1e-3), name
        g = np.abs(_np(ref_grads[name]))
        clear = (g > 1e-3 * g.max()) & (g > 1e-4)
        np.testing.assert_allclose(got_step[clear], ref_step[clear], rtol=0, atol=1e-3 * LR,
                                   err_msg=name)
    for name in ("depth_coffa", "depth_coffb"):
        assert float(params[name].detach()[0]) != float(s["sd"][name][0]), name


def test_dino_needs_the_tower_tokens(model_setup):
    """``use_dino`` without ``batch.dino_feats`` (the demo pairs carry no tower
    outputs) raises; ``use_mono_depth`` without a map warps onto the real
    depth's centres, as the JAX package does."""
    batch = pp.Batch2D3D(**{**vars(model_setup["batch"]), "dino_feats": None})
    with pytest.raises(ValueError, match="dino_feats"):
        model_setup["port"].encode(batch)
    batch = pp.Batch2D3D(**{**vars(model_setup["batch"]), "mono_depth": None})
    centres, valid = model_setup["port"].patch_centers_da(batch)
    real, real_valid = model_setup["port"].patch_centers(batch)
    assert torch.equal(centres, real) and torch.equal(valid, real_valid)


def test_dino_warps_are_active(model_setup, monkeypatch):
    """Every node warp of the DDIM and of the train forward above is accepted
    and well conditioned (condition below 1e3; the gate is 1e9), so the
    lifted centres, and through them depth_coffa / depth_coffb, move the
    outputs that the tests compare."""
    conditions = []

    def spy(*args, _orig=pp.soft_procrustes, **kwargs):
        res = _orig(*args, **kwargs)
        conditions.append(_np(res.condition))
        return res
    monkeypatch.setattr(pp, "soft_procrustes", spy)
    s = model_setup
    with torch.no_grad():
        s["port"](s["batch"], mode="ddim", x_init=s["x_init"])
        s["port"].train_forward(s["batch"], **s["draws"])
    assert len(conditions) == STEPS + 1
    assert all(bool(np.all(c < 1e3)) for c in conditions), conditions
