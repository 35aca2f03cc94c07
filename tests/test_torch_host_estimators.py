"""The port's host PnP backend (OpenCV's solvePnPRansac) against the JAX
package's, on the CPU: ``pnp_pose_opencv`` on the same float64
correspondences (a known pose with 30% outliers, both pixel orders, too few
points), ``resolve_backend`` (the OpenCV backend where cv2 imports, the
device fallback with the JAX package's warning where it does not, Open3D
still refused where it imports), and ``TwoDThreeDTester`` with ``pnp_backend:
opencv`` on the tiny 2D-3D YAML of ``tests/test_torch_2d3d_cli.py``: each
pair's pose against the JAX tester's ``_host_pnp_batch`` on the same fine
matches, and RR, RRE and RTE of both packages' ``eval_from_cache`` on the
same cache.

Tolerances: both packages make the same cv2 call on the same float64 input
(OpenCV's RANSAC draws from a fixed seed), so the transforms agree to 1e-9
and the testers' float32 poses exactly; the cache evaluations' RR is equal
and RTE within 1e-6, RRE within ``RRE_TOL`` (float32 arccos near a perfect
pose).
"""
import torch_native_guard  # noqa: F401  (makes the JAX native library whole first)
import types

import numpy as np
import pytest
import torch

from diffreg_tpu.engine import tester2d3d as jt
from diffreg_tpu.eval import host_estimators as jhe
from diffreg_tpu_torch.data.synthetic2d3d import synthetic_2d3d_batch
from diffreg_tpu_torch.engine import tester2d3d as pt
from diffreg_tpu_torch.eval import host_estimators as phe
from diffreg_tpu_torch.main import pipeline_2d3d_config
from diffreg_tpu_torch.models.pipeline_2d3d import DiffReg2D3D
from diffreg_tpu_torch.utils.config import load_yaml
from diffreg_tpu_torch.utils.logging import Logger
from test_torch_2d3d_cli import SHARPEN, _tiny_yaml

# RRE is arccos((trace - 1) / 2) of float32 rotations, with the trace summed in
# each package's order: near a perfect pose a few float32 ulps of the trace
# (2.4e-7 each at 3) move the angle by up to sqrt(2 * 4.8e-7) rad = 0.056
# degrees (measured 0.0093 degrees between the packages on the same poses)
RRE_TOL = 0.06
K = np.array([[585.0, 0.0, 320.0], [0.0, 585.0, 240.0], [0.0, 0.0, 1.0]])


def _pose(rng):
    from scipy.spatial.transform import Rotation

    tfm = np.eye(4)
    tfm[:3, :3] = Rotation.from_euler("zyx", rng.uniform(-0.4, 0.4, 3)).as_matrix()
    tfm[:3, 3] = rng.uniform(-0.3, 0.3, 3)
    return tfm


def _correspondences(rng, tfm, n=200, outliers=0.3):
    """Cloud points in front of the camera of ``tfm`` (camera from cloud), their
    (u, v) pixels under it, a share of them replaced by random pixels."""
    cam = np.stack([rng.uniform(-1.0, 1.0, n), rng.uniform(-0.8, 0.8, n),
                    rng.uniform(1.5, 4.0, n)], -1)
    points = (cam - tfm[:3, 3]) @ tfm[:3, :3]
    pix = cam @ K.T
    pix = pix[:, :2] / pix[:, 2:]
    bad = rng.rand(n) < outliers
    pix[bad] = rng.uniform([0, 0], [640, 480], (int(bad.sum()), 2))
    return points, pix, cam


@pytest.mark.parametrize("transposed", [False, True])
def test_pnp_pose_opencv_matches_jax(rng, transposed):
    tfm = _pose(rng)
    points, pix, _ = _correspondences(rng, tfm)
    pix_in = pix[:, ::-1].copy() if transposed else pix           # (v, u) when transposed
    got = phe.pnp_pose_opencv(points, pix_in, K, transposed=transposed)
    ref = jhe.pnp_pose_opencv(points, pix_in, K, transposed=transposed)
    assert got.dtype == np.float64 and got.shape == (4, 4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
    # it solves the pose: near the known one, through the outliers (RANSAC's
    # P3P estimate of noise-free inliers, measured 5.9e-4 away)
    np.testing.assert_allclose(got, tfm, atol=5e-3)


def test_pnp_pose_opencv_too_few_points(rng):
    tfm = _pose(rng)
    points, pix, _ = _correspondences(rng, tfm, n=3, outliers=0.0)
    assert phe.pnp_pose_opencv(points, pix, K) is None
    assert jhe.pnp_pose_opencv(points, pix, K) is None


def test_resolve_backend(monkeypatch):
    """opencv where cv2 imports; the device PnP with the JAX package's warning
    where it does not; open3d refused where it imports (patched in: it does
    not here), and the device RANSAC with a warning where it does not."""
    class Recorder:
        def __init__(self):
            self.warnings = []

        def warning(self, msg):
            self.warnings.append(msg)

    assert phe.resolve_backend("opencv") == "opencv"
    assert phe.resolve_backend("device") == "device"
    with pytest.raises(ValueError):
        phe.resolve_backend("ransac")
    log = Recorder()
    monkeypatch.setattr(phe, "has_module", lambda name: False)
    assert phe.resolve_backend("opencv", log) == "device"
    assert phe.resolve_backend("open3d", log) == "device"
    assert log.warnings == [
        "eval.pnp_backend=opencv but cv2 is not installed — falling back to the device PnP",
        "eval.pose_backend=open3d but open3d is not installed — falling back to the device "
        "RANSAC"]
    monkeypatch.setattr(phe, "has_module", lambda name: True)
    assert phe.resolve_backend("opencv") == "opencv"
    with pytest.raises(NotImplementedError, match="host_estimators"):
        phe.resolve_backend("open3d")


def _known_pose_cache(directory, rng, n_pairs=3):
    """A scene of the npz cache whose correspondences come from known poses
    (30% outliers), so that the host PnP registers them."""
    scene = directory / "known_pose"
    scene.mkdir(parents=True)
    for i in range(n_pairs):
        tfm = _pose(rng)
        points, pix, cam = _correspondences(rng, tfm, n=150)
        np.savez_compressed(
            scene / f"{i:06d}.npz", pcd_points=points.astype(np.float32),
            img_corr_points=cam.astype(np.float32), pcd_corr_points=points.astype(np.float32),
            img_corr_pixels=pix.astype(np.float32),
            corr_scores=rng.rand(len(points)).astype(np.float32),
            pcd_num_nodes=8, img_num_nodes=8, pcd_node_corr_indices=np.arange(4),
            img_node_corr_indices=np.arange(4), gt_pcd_node_corr_indices=np.arange(4),
            gt_img_node_corr_indices=np.arange(4),
            gt_node_corr_min_overlaps=np.ones(4, np.float32),
            transform=tfm.astype(np.float32), intrinsics=K.astype(np.float32))


@pytest.fixture(scope="module")
def tester_run(tmp_path_factory):
    """The port's TwoDThreeDTester with ``pnp_backend: opencv`` on the tiny
    YAML's model (its matchers sharpened by SHARPEN, as the CLI test's JAX
    weights are) over two demo batches, writing the npz cache; then a
    known-pose scene added to it."""
    tmp = tmp_path_factory.mktemp("host_pnp")
    raw = load_yaml(_tiny_yaml(tmp / "tiny.yaml", eval={"pnp_backend": "opencv"}))
    model = DiffReg2D3D(pipeline_2d3d_config(raw), device="cpu", seed=0)
    with torch.no_grad():
        for matcher in (model.coarse_matching, model.denoising_coarse_matching):
            matcher.src_proj.weight.mul_(SHARPEN)
    # fine matching at threshold 0: random weights leave every fine score under
    # the protocol's 0.75, and the PnP needs correspondences to solve
    cfg = pt.Test2D3DConfig(pnp_backend=raw["eval"]["pnp_backend"], fine_threshold=0.0)
    tester = pt.TwoDThreeDTester(model, cfg, Logger(None), device="cpu")
    batches = [synthetic_2d3d_batch(batch_size=2, img_hw=(64, 96), n_points=512, seed=i)
               for i in range(2)]
    with torch.no_grad():
        forwards = [tester.forward(b, torch.Generator().manual_seed(i))
                    for i, b in enumerate(batches)]
        summary = tester.test(lambda: ((b, [{}] * 2) for b in batches),
                              torch.Generator().manual_seed(0), cache_dir=str(tmp / "cache"))
    _known_pose_cache(tmp / "cache", np.random.RandomState(3))
    return {"tester": tester, "batches": batches, "forwards": forwards, "summary": summary,
            "cache": str(tmp / "cache")}


def test_tester_host_pnp_matches_jax(tester_run):
    """Each pair's pose from the port's tester against the JAX tester's
    ``_host_pnp_batch`` on the same fine matches: equal float32 poses."""
    assert tester_run["tester"].cfg.pnp_backend == "opencv"
    solved = 0
    for batch, (_, _, pairs) in zip(tester_run["batches"], tester_run["forwards"]):
        fm = {k: np.stack([p["fm"][k].numpy() for p in pairs])
              for k in ("corr_valid", "pcd_corr_points", "img_corr_pixels")}
        rot, trn = jt._host_pnp_batch(fm, types.SimpleNamespace(
            intrinsics=batch.intrinsics.numpy()), jt.Test2D3DConfig())
        for i, pair in enumerate(pairs):
            np.testing.assert_allclose(pair["rotation"].numpy(), np.asarray(rot[i]), rtol=0,
                                       atol=1e-9)
            np.testing.assert_allclose(pair["translation"].numpy(), np.asarray(trn[i]), rtol=0,
                                       atol=1e-9)
            solved += int(fm["corr_valid"][i].sum() >= 4
                          and not np.allclose(np.asarray(rot[i]), np.eye(3)))
    assert solved >= 1, "no pair reached cv2 with 4 or more correspondences"
    assert np.isfinite([tester_run["summary"][k] for k in ("RR", "RRE", "RTE")]).all()


def test_eval_from_cache_host_pnp_matches_jax(tester_run):
    """RR, RRE and RTE of both packages' eval_from_cache with the OpenCV PnP
    on the same cache (the tester's pairs and the known-pose scene)."""
    got = pt.eval_from_cache(tester_run["cache"], pt.Test2D3DConfig(pnp_backend="opencv"),
                             device="cpu")
    ref = jt.eval_from_cache(tester_run["cache"], jt.Test2D3DConfig(pnp_backend="opencv"))
    assert set(got["scenes"]) == set(ref["scenes"]) and "known_pose" in got["scenes"]
    assert got["scenes"]["known_pose"]["RR"] == 1.0
    for key, tol in (("RR", 0.0), ("RRE", RRE_TOL), ("RTE", 1e-6)):
        assert got[key] == pytest.approx(float(ref[key]), rel=0, abs=tol), key
        for scene, row in ref["scenes"].items():
            if key in row:
                assert got["scenes"][scene][key] == pytest.approx(float(row[key]), rel=0,
                                                                  abs=tol), (scene, key)


def test_eval_from_cache_host_pnp_draws_nothing(tester_run):
    """With the OpenCV PnP the cache evaluation draws no PnP hypotheses (as
    the JAX package's splits no key): the generator is left as it was."""
    generator = torch.Generator().manual_seed(4)
    state = generator.get_state()
    pt.eval_from_cache(tester_run["cache"], pt.Test2D3DConfig(pnp_backend="opencv"),
                       generator=generator, device="cpu")
    assert torch.equal(generator.get_state(), state)
