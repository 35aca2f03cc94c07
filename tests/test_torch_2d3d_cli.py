"""``diffreg_tpu_torch.main`` on 2D-3D YAMLs against ``diffreg_tpu.main``, on
the CPU: test mode on the demo pairs and on an on-disk RGB-D Scenes V2 split
(PNG depth and colour, .npy clouds, per-scene intrinsics, metadata pkl),
with the JAX weights converted into a checkpoint of the port's and JAX's
draws (the DDIM start, the PnP hypotheses of the tester and of
``eval_from_cache``) rebuilt from its keys. Both mains write the npz cache,
so ``eval_from_cache`` is held too. A third run asks for the host PnP
(``parity_eval``) with cv2 made to look missing, and for a fine threshold of
0.5: both mains fall back to the device PnP and match at the tester's 0.75.
A fourth runs the tower variant (``use_dino``, ``use_mono_depth``, stride 14,
as configs/test/rgbdv2_dino.yaml) on the on-disk split, with
``load_tower_runner`` patched in both packages to the same tiny towers (the
port's carrying the JAX towers' weights). Both mains exit alike when the
tower checkpoints are missing; the port refuses what it lacks.

The JAX main's initial weights have both matchers' projections scaled by
``SHARPEN``: with plain random weights the confidences are near-uniform, the
union top-1 masks tie over whole rows, and PIR would compare tie-breaking.

Tolerances: the test summaries and the cache evaluations agree to 1e-5
(relative and absolute): the same correspondences, IR, PIR, and PnP poses
from the same draws.
"""
import torch_native_guard  # noqa: F401  (makes the JAX native library whole first)
import os
import pickle

import cv2
import jax
import numpy as np
import pytest
import torch
import yaml
from flax.traverse_util import flatten_dict

from diffreg_tpu_torch.main import main

_TOWERS_OFF = {"use_dino": False, "use_mono_depth": False}
SHARPEN = 8.0


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, as tests/test_torch_cli.py uses for its CLI runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny_yaml(path, model=None, **extra):
    tree = {"dataset": "rgbdv2", "mode": "test", "exp_dir": "tiny2d3d", "batch_size": 2,
            "SAMPLE_STEP": 2, "eval": {"write_cache": True},
            "model_2d3d": {"img_out_dim": 32, "img_base_dim": 16, "pcd_init_dim": 16,
                           "pcd_output_dim": 32, "hidden_dim": 64, "output_dim": 64,
                           "num_heads": 2, "pcd_num_points_in_patch": 32, **_TOWERS_OFF,
                           **(model or {})}}
    tree.update(extra)
    with open(path, "w") as f:
        yaml.safe_dump(tree, f)
    return str(path)


def _write_split(root, rng, n_pairs=4, h=40, w=56):
    """An RGB-D Scenes V2 split: a smooth depth (16-bit mm) and a textured
    colour PNG per pair, a cloud of the scene in a world frame, two scenes."""
    from scipy.spatial.transform import Rotation

    k = np.array([[60.0, 0, (w - 1) / 2], [0, 60.0, (h - 1) / 2], [0, 0, 1]])
    meta = []
    for i in range(n_pairs):
        scene = f"scene_{i // 2}"
        d = root / "data" / scene
        os.makedirs(d, exist_ok=True)
        np.savetxt(d / "camera-intrinsics.txt", k)
        vv, uu = np.mgrid[0:h, 0:w].astype(np.float64)
        depth = 1.5 + 0.3 * np.sin(uu / 9.0 + i) + 0.2 * np.cos(vv / 7.0)
        cv2.imwrite(str(d / f"depth{i}.png"), np.round(depth * 1000).astype(np.uint16))
        cv2.imwrite(str(d / f"color{i}.png"), rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        u, v = rng.uniform(0.2 * w, 1.3 * w, 700), rng.uniform(0, h, 700)
        z = 1.5 + 0.3 * np.sin(u / 9.0 + i) + 0.2 * np.cos(v / 7.0)
        cam = np.stack([(u - k[0, 2]) * z / 60.0, (v - k[1, 2]) * z / 60.0, z], -1)
        rot = Rotation.from_euler("zyx", rng.rand(3)).as_matrix()
        trn = rng.randn(3) * 0.2
        tfm = np.eye(4)
        tfm[:3, :3], tfm[:3, 3] = rot, trn
        np.save(d / f"cloud{i}.npy", ((cam - trn) @ rot).astype(np.float32))
        meta.append({"scene_name": scene, "depth_file": f"{scene}/depth{i}.png",
                     "image_file": f"{scene}/color{i}.png", "cloud_file": f"{scene}/cloud{i}.npy",
                     "overlap": 0.5, "cloud_to_image": tfm.astype(np.float32)})
    os.makedirs(root / "metadata")
    with open(root / "metadata" / "test.pkl", "wb") as f:
        pickle.dump(meta, f)
    return str(root)


class _JaxDraws:
    """The JAX 2D-3D tester's keys (per batch ``rng, r1, r2 = split(rng, 3)``;
    the DDIM start from r1, pair i's PnP draws from ``split(r2, B)[i]``) and
    eval_from_cache's (``rng, k = split(rng)`` per cached pair), both from the
    config's seed."""

    def __init__(self, hypotheses, seed=0):
        self.rng = self.eval_rng = jax.random.PRNGKey(seed)
        self.h = hypotheses

    def start(self, tester, batch, n, m, generator):
        self.rng, r1, self.r2 = jax.random.split(self.rng, 3)
        return torch.from_numpy(np.array(jax.random.normal(r1, (batch.batch_size, n, m))))

    def pnp(self, tester, batch, generator):
        keys = jax.random.split(self.r2, batch.batch_size)
        return torch.from_numpy(np.stack([np.array(jax.random.uniform(k, (self.h, 6)))
                                          for k in keys]))

    def pnp_eval(self, generator, cfg, device):
        self.eval_rng, k = jax.random.split(self.eval_rng)
        return torch.from_numpy(np.array(jax.random.uniform(k, (self.h, 6))))


def _record_jax(monkeypatch):
    """The JAX tester's weights (its main's initial ones, sharpened) and summary,
    and eval_from_cache's summary, as the JAX main ran them."""
    from flax.core import unfreeze

    from diffreg_tpu.engine import tester2d3d as jt
    from diffreg_tpu.models import pipeline_2d3d as jp

    run = {}

    def init(self, model, variables, *args, _orig=jt.TwoDThreeDTester.__init__, **kwargs):
        _orig(self, model, variables, *args, **kwargs)
        run["variables"] = variables

    def test(self, *args, _orig=jt.TwoDThreeDTester.test, **kwargs):
        run["summary"] = _orig(self, *args, **kwargs)
        return run["summary"]

    def evaluate(*args, _orig=jt.eval_from_cache, **kwargs):
        run["eval"] = _orig(*args, **kwargs)
        return run["eval"]
    def model_init(self, *args, _orig=jp.DiffReg2D3D.init, **kwargs):
        variables = unfreeze(_orig(self, *args, **kwargs))
        for matcher in ("coarse_matching", "denoising_matching"):
            proj = variables["params"][matcher]["src_proj"]
            proj["kernel"] = proj["kernel"] * SHARPEN
        return variables
    monkeypatch.setattr(jp.DiffReg2D3D, "init", model_init)
    monkeypatch.setattr(jt.TwoDThreeDTester, "__init__", init)
    monkeypatch.setattr(jt.TwoDThreeDTester, "test", test)
    monkeypatch.setattr(jt, "eval_from_cache", evaluate)
    return run


def _port_checkpoint(directory, raw, variables):
    from diffreg_tpu_torch.convert import state_dict_2d3d_from_flax
    from diffreg_tpu_torch.engine.checkpoint import CheckpointManager
    from diffreg_tpu_torch.engine.train import OptimConfig, create_train_state
    from diffreg_tpu_torch.main import pipeline_2d3d_config
    from diffreg_tpu_torch.models.pipeline_2d3d import DiffReg2D3D

    flat = lambda tree: {"/".join(k): np.asarray(v)  # noqa: E731
                         for k, v in flatten_dict(dict(tree)).items()}
    model = DiffReg2D3D(pipeline_2d3d_config(raw), device="cpu", seed=99)
    model.load_state_dict(state_dict_2d3d_from_flax(flat(variables["params"]),
                                                    flat(variables["buffers"])), strict=True)
    CheckpointManager(str(directory)).save(1, create_train_state(model, OptimConfig()))
    return str(directory)


def _same(got, ref, what):
    for key, val in ref.items():
        if key == "scenes":
            assert set(got[key]) == set(val)
            for scene, row in val.items():
                _same(got[key][scene], row, f"{what} {scene}")
            continue
        assert got[key] == pytest.approx(float(val), rel=1e-5, abs=1e-5), f"{what} {key}"


def _tiny_towers(monkeypatch):
    """``load_tower_runner`` of both packages patched to the same tiny towers
    (DINOv2 embed 64, 2 blocks; DepthAnything embed 32, 4 blocks, DPT
    features 16), with weights drawn from a seed."""
    from flax.traverse_util import unflatten_dict

    from diffreg_tpu.models import towers as jtowers
    from diffreg_tpu.nn import depth_anything as jda
    from diffreg_tpu.nn import dinov2 as jdino
    from diffreg_tpu_torch.convert import (depth_anything_state_dict_from_flax,
                                           dinov2_state_dict_from_flax)
    from diffreg_tpu_torch.models import towers as ptowers
    from diffreg_tpu_torch.nn import depth_anything as pda
    from diffreg_tpu_torch.nn import dinov2 as pdino

    dino_cfg = dict(embed_dim=64, depth=2, num_heads=2, img_size=140)
    vit_cfg = dict(embed_dim=32, depth=4, num_heads=2, img_size=140)
    dpt_cfg = dict(features=16, out_channels=(8, 16, 32, 32))
    image = np.zeros((1, 28, 56, 3), np.float32)
    rs = np.random.RandomState(4)

    def draw(model):
        shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), image))["params"]
        return unflatten_dict({
            path: (rs.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
                   if path[-1] == "kernel" else 1.0 + 0.1 * rs.randn(*leaf.shape)
                   if path[-1] in ("scale", "gamma") else 0.1 * rs.randn(*leaf.shape)
                   ).astype(np.float32) for path, leaf in flatten_dict(dict(shapes)).items()})
    dino = draw(jdino.DinoVisionTransformer(jdino.DinoV2Config(**dino_cfg)))
    da = draw(jda.DepthAnything(jdino.DinoV2Config(**vit_cfg), jda.DPTConfig(**dpt_cfg)))
    jax_runner = jtowers.TowerRunner(
        dino_variables={"params": dino}, da_variables={"params": da},
        dino_cfg=jdino.DinoV2Config(**dino_cfg), da_vit_cfg=jdino.DinoV2Config(**vit_cfg),
        da_dpt_cfg=jda.DPTConfig(**dpt_cfg))
    flat = lambda tree: {"/".join(k): np.asarray(v)  # noqa: E731
                         for k, v in flatten_dict(dict(tree)).items()}
    port_dino = pdino.DinoVisionTransformer(pdino.DinoV2Config(**dino_cfg))
    port_dino.load_state_dict(dinov2_state_dict_from_flax(flat(dino)), strict=True)
    port_da = pda.DepthAnything(pdino.DinoV2Config(**vit_cfg), pda.DPTConfig(**dpt_cfg))
    port_da.load_state_dict(depth_anything_state_dict_from_flax(flat(da)), strict=True)
    calls = []

    def port_runner(dino_ckpt, da_ckpt, device=None):
        calls.append((dino_ckpt, da_ckpt))
        return ptowers.TowerRunner(port_dino, port_da, device=device)
    monkeypatch.setattr(jtowers, "load_tower_runner", lambda *args, **kwargs: jax_runner)
    monkeypatch.setattr(ptowers, "load_tower_runner", port_runner)
    return calls


@pytest.mark.parametrize("case", ["demo", "disk", "parity-without-cv2", "dino-disk"])
def test_main_2d3d_matches_jax(tmp_path, monkeypatch, rng, case):
    """``main`` on a 2D-3D YAML against ``diffreg_tpu.main`` (test mode, two
    batches of two pairs): the tester's summary and ``eval_from_cache``'s. The
    parity case asks for the host estimators (``parity_eval``) on a machine
    without cv2 (the availability check patched in both packages) and for a
    fine threshold of 0.5: both mains run the device PnP and fine matching at
    the tester's 0.75 and top 2."""
    import diffreg_tpu.main as jax_main
    from diffreg_tpu.eval import host_estimators as jhe
    from diffreg_tpu.ops import topk as jtopk
    from diffreg_tpu.utils import precision as jprec
    from diffreg_tpu_torch.engine import tester2d3d as pt
    from diffreg_tpu_torch.eval import host_estimators as phe
    from diffreg_tpu_torch.utils.config import load_yaml

    monkeypatch.chdir(tmp_path)
    extra, argv = {}, ["--demo", "--num-pairs", "4"]
    if case in ("disk", "dino-disk"):
        argv = []
        extra["data_root"] = _write_split(tmp_path / "rgbdv2", rng)
    if case == "dino-disk":
        for name in ("dino.pth", "da.pth"):
            (tmp_path / name).touch()
        extra.update(towers={"dinov2": str(tmp_path / "dino.pth"),
                             "depth_anything": str(tmp_path / "da.pth")},
                     model={"use_dino": True, "use_mono_depth": True, "coarse_stride": 14,
                            "dino_dim": 64})
        tower_calls = _tiny_towers(monkeypatch)
    elif case == "parity-without-cv2":
        extra.update(parity_eval=True, model={"fine_threshold": 0.5, "fine_topk": 3})
        monkeypatch.setattr(jhe, "has_opencv", lambda: False)
        monkeypatch.setattr(phe, "has_module",
                            lambda name, real=phe.has_module: name != "cv2" and real(name))
        # parity_eval sets these switches of the JAX package: put them back after
        monkeypatch.setattr(jtopk, "_EXACT", jtopk._EXACT)
        monkeypatch.setattr(jprec, "_PRECISION", jprec._PRECISION)
        testers = []

        def init(self, model, cfg, *args, _orig=pt.TwoDThreeDTester.__init__, **kwargs):
            _orig(self, model, cfg, *args, **kwargs)
            testers.append(self.cfg)
        monkeypatch.setattr(pt.TwoDThreeDTester, "__init__", init)
    run = _record_jax(monkeypatch)
    os.makedirs(tmp_path / "empty")
    jax_main.main(["--config", _tiny_yaml(tmp_path / "jax.yaml", exp_dir="jax",
                                          pretrain=str(tmp_path / "empty"), **extra), *argv])
    ckpt = _port_checkpoint(tmp_path / "ckpt", load_yaml(str(tmp_path / "jax.yaml")),
                            run["variables"])
    draws = _JaxDraws(8192)
    monkeypatch.setattr(pt.TwoDThreeDTester, "draw_start",
                        lambda self, b, n, m, g: draws.start(self, b, n, m, g))
    monkeypatch.setattr(pt.TwoDThreeDTester, "draw_pnp", lambda self, b, g: draws.pnp(self, b, g))
    monkeypatch.setattr(pt, "draw_pnp_eval", draws.pnp_eval)
    got = main(["--config", _tiny_yaml(tmp_path / "port.yaml", exp_dir="port", pretrain=ckpt,
                                       **extra), *argv, "--device", "cpu"])
    assert got["pairs"] == run["summary"]["pairs"] == 4
    if case == "parity-without-cv2":
        (cfg,) = testers
        assert (cfg.pnp_backend, cfg.fine_topk, cfg.fine_threshold) == ("device", 2, 0.75)
    _same({k: v for k, v in got.items() if k != "eval"}, run["summary"], "test")
    _same(got["eval"], run["eval"], "eval")
    if case == "dino-disk":
        assert tower_calls == [(str(tmp_path / "dino.pth"), str(tmp_path / "da.pth"))]
    if case in ("disk", "dino-disk"):
        assert sorted(got["eval"]["scenes"]) == ["scene_0", "scene_1"]
        assert len(os.listdir(tmp_path / "snapshot" / "port" / "cache" / "scene_0")) == 2


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("kind", ["rgbdv2", "7scenes"])
def test_dataset_readers_match_jax(tmp_path, rng, kind, augment):
    """The port's readers (its own PNG decoding) against the JAX package's
    (OpenCV's) on one split: every field of every pair, with the 30k-style
    point cap and the augmentation drawn from the same seed."""
    from diffreg_tpu.data import datasets2d3d as jds
    from diffreg_tpu_torch.data import datasets2d3d as pds

    root = _write_split(tmp_path / "split", rng)
    name = "RGBDScenes2D3DPairDataset" if kind == "rgbdv2" else "SevenScenes2D3DPairDataset"
    if kind == "7scenes":
        os.rename(os.path.join(root, "metadata", "test.pkl"),
                  os.path.join(root, "metadata", "test-full.pkl"))
    kw = dict(max_points=500, use_augmentation=augment, seed=3)
    got, ref = getattr(pds, name)(root, "test", **kw), getattr(jds, name)(root, "test", **kw)
    assert len(got) == len(ref) == 4 and got.scene_names() == ref.scene_names()
    for i in range(4):
        g, r = got[i], ref[i]
        assert set(g) == set(r) and g["scene_name"] == r["scene_name"]
        for key in r:
            if isinstance(r[key], np.ndarray):
                np.testing.assert_array_equal(g[key], r[key], err_msg=key)
        assert len(g["points"]) == 500


def test_main_2d3d_rejects_what_is_not_ported(tmp_path, monkeypatch, rng):
    """The tower variant on real data without its checkpoints exits as the
    JAX package's main does (the same SystemExit); the demo pairs carry no
    tower outputs, so ``use_dino`` with --demo fails in both (JAX at its
    model's init). A metric run on real data with random weights is refused.
    The host PnP (``eval.pnp_backend: opencv``, ``parity_eval``) runs OpenCV's
    where cv2 imports (it does here)."""
    import diffreg_tpu.main as jax_main

    monkeypatch.chdir(tmp_path)
    towers = {"dinov2": str(tmp_path / "missing.pth"), "depth_anything": str(tmp_path)}
    cfg = _tiny_yaml(tmp_path / "b.yaml", model={"use_dino": True, "use_mono_depth": True},
                     towers=towers, data_root=_write_split(tmp_path / "rgbdv2", rng))
    exits = []
    for run in (jax_main.main, lambda argv: main([*argv, "--device", "cpu"])):
        with pytest.raises(SystemExit) as info:
            run(["--config", cfg])
        exits.append(str(info.value))
    assert exits[0] == exits[1]
    assert exits[0].startswith("use_dino/use_mono_depth need converted tower checkpoints: "
                               "towers={") and "missing.pth" in exits[0]
    cfg = _tiny_yaml(tmp_path / "d.yaml", model={"use_dino": True})
    with pytest.raises(IndexError):
        jax_main.main(["--config", cfg, "--demo"])
    with pytest.raises(ValueError, match="dino_feats"):
        main(["--config", cfg, "--demo", "--device", "cpu"])
    # the host PnP runs where cv2 imports: OpenCV's solvePnPRansac for every pair
    from diffreg_tpu_torch.engine import tester2d3d

    solves = []
    host = tester2d3d.pnp_pose_opencv
    monkeypatch.setattr(tester2d3d, "pnp_pose_opencv",
                        lambda *a, **k: solves.append(1) or host(*a, **k))
    for change in ({"eval": {"pnp_backend": "opencv"}}, {"parity_eval": True}):
        solves.clear()
        summary = main(["--config", _tiny_yaml(tmp_path / "c.yaml", **change), "--demo",
                        "--device", "cpu"])
        assert len(solves) >= summary["pairs"] > 0 and np.isfinite(summary["RR"])
    with pytest.raises(SystemExit, match="random weights"):
        main(["--config", _tiny_yaml(tmp_path / "d.yaml", data_root=str(tmp_path)),
              "--device", "cpu"])
