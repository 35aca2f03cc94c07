"""The port's library data and utilities against the JAX package's, on the CPU:
the deformation-graph C++ bindings, the library dataset readers, PLY in both
directions, the context registry and the profiling helpers.

Limit: identical. The graph functions run the same C++ (the port's own build
of both native sources); the readers are numpy, fed the same files and the
same seeded RandomState, so every array must match exactly.
"""
import torch_native_guard  # noqa: F401  (makes the JAX native library whole first)

import os
import pickle

import numpy as np
import pytest
import torch

import test_library_datasets as jax_dataset_tests
from diffreg_tpu.data import graph as jax_graph
from diffreg_tpu.data import library_datasets as jax_lib
from diffreg_tpu.utils import context as jax_context
from diffreg_tpu.utils import ply as jax_ply
from diffreg_tpu_torch.data import graph, library_datasets
from diffreg_tpu_torch.utils import context, ply, profiling
from diffreg_tpu_torch.utils.logging import Timers


def assert_same(got, ref):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref)
        for key in ref:
            assert_same(got[key], ref[key])
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert_same(g, r)
    elif isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == ref.dtype
    else:
        assert got == ref


# ---------------------------------------------------------------- graph


@pytest.fixture(scope="module")
def mesh():
    """A smooth depth map with a hole, back-projected (the JAX package's
    tests/test_graph_proc.py point image), meshed, eroded and sampled."""
    rng = np.random.RandomState(0)
    h, w = 32, 40
    depth = np.kron(rng.rand(4, 5) * 0.3 + 1.0, np.ones((8, 8))).astype(np.float32)
    depth[10:16, 12:20] = 0.0
    vv, uu = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    image = np.stack([(uu - w / 2) * depth / 40.0, (vv - h / 2) * depth / 40.0, depth],
                     -1).astype(np.float32)
    verts, faces, pixels = jax_graph.depth_to_mesh(image, 0.5)
    mask = jax_graph.erode_mesh(verts, faces, 1, 4)
    _, idx = jax_graph.sample_nodes(verts, mask, 0.08, use_only_non_eroded=False, seed=0)
    return image, verts, faces, pixels, mask, idx


GRAPH_CASES = {
    "depth_to_mesh": lambda g, image, v, f, px, m, idx: g.depth_to_mesh(image, 0.08),
    "erode_mesh": lambda g, image, v, f, px, m, idx: g.erode_mesh(v, f, 2, 4),
    "sample_nodes": lambda g, image, v, f, px, m, idx: (
        g.sample_nodes(v, m, 0.1, seed=3), g.sample_nodes(v, None, 0.1, seed=None)),
    "compute_edges_geodesic": lambda g, image, v, f, px, m, idx: g.compute_edges_geodesic(
        v, m, f, idx, 4, 0.08),
    "compute_edges_euclidean": lambda g, image, v, f, px, m, idx: g.compute_edges_euclidean(
        v[idx], 4, 0.3),
    "node_and_edge_clean_up": lambda g, image, v, f, px, m, idx: g.node_and_edge_clean_up(
        g.compute_edges_euclidean(v[idx], 2, 0.05), np.ones(len(idx), bool)),
    "compute_clusters": lambda g, image, v, f, px, m, idx: g.compute_clusters(
        g.compute_edges_euclidean(v[idx], 2, 0.1)),
    "compute_pixel_anchors_geodesic": lambda g, image, v, f, px, m, idx:
        g.compute_pixel_anchors_geodesic(g.compute_edges_geodesic(v, m, f, idx, 4, 0.08)[3],
                                         np.ones(len(idx), bool), v, px, 40, 32, 4, 0.08),
    "compute_pixel_anchors_euclidean": lambda g, image, v, f, px, m, idx:
        g.compute_pixel_anchors_euclidean(v[idx], image, 4, 0.08),
    "update_pixel_anchors": lambda g, image, v, f, px, m, idx: g.update_pixel_anchors(
        {0: 2, 1: 0, 3: 1}, np.array([[[0, 1, -1], [3, 2, 1]]], np.int32)),
    "sample_nodes_with_fps": lambda g, image, v, f, px, m, idx: g.sample_nodes_with_fps(
        v, 0.05, 40),
    "build_deformation_graph_from_point_cloud": lambda g, image, v, f, px, m, idx:
        g.build_deformation_graph_from_point_cloud(v, g.sample_nodes_with_fps(v, 0.08), 8, 4,
                                                   0.1, 0.08),
}


@pytest.mark.parametrize("name", sorted(GRAPH_CASES))
def test_graph(mesh, name):
    ref = GRAPH_CASES[name](jax_graph, *mesh)
    got = GRAPH_CASES[name](graph, *mesh)
    assert_same(got, ref)


# ---------------------------------------------------------------- datasets


def _kitti(root, rng):
    jax_dataset_tests.TestOdometryKitti()._write(root, rng)
    return [dict(subset="test", max_points=400),
            dict(subset="test", use_augmentation=True, return_corr_indices=True,
                 matching_radius=0.3)], "OdometryKittiPairDataset"


def _modelnet(root, rng):
    jax_dataset_tests.TestModelNet()._write(root, rng)
    return [dict(subset="test", num_points=512, keep_ratio=0.7, deterministic=True,
                 return_corr_indices=True, matching_radius=0.08),
            dict(subset="test", num_points=256, keep_ratio=0.7, class_indices="all",
                 asymmetric=True)], "ModelNetPairDataset"


def _shapenet(root, rng):
    os.makedirs(root / "metadata", exist_ok=True)
    os.makedirs(root / "data" / "chair", exist_ok=True)
    pts = rng.randn(1200, 3).astype(np.float32)
    np.savez(root / "data" / "chair" / "m0.npz", points=pts,
             normals=pts / np.linalg.norm(pts, axis=1, keepdims=True))
    (root / "metadata" / "test.txt").write_text("chair/m0.npz\n")
    return [dict(subset="test", num_points=256, deterministic=True),
            dict(subset="test", num_points=256)], "ShapeNetPairDataset"


def _deformable(cls):
    def write(root, rng):
        jax_dataset_tests.TestDeformableNpz()._write(root, rng)
        return [dict(subset="train")], cls             # these readers draw nothing
    return write


def _redwood(root, rng):
    frag = root / "fragments"
    os.makedirs(frag, exist_ok=True)
    base = rng.rand(400, 3).astype(np.float32)
    for i in range(3):
        tfm = jax_lib.random_sample_transform(rng, 20.0, 0.5)
        local = jax_lib.apply_transform(base, np.linalg.inv(tfm)).astype(np.float32)
        jax_ply.write_ply(str(frag / f"f{i:02d}.ply"), [local[:, 0], local[:, 1], local[:, 2]],
                          ["x", "y", "z"])
        np.save(frag / f"f{i:02d}.npy", tfm)
    return [dict(frame_gap=1)], "RedwoodPairDataset"


def _scannet(root, rng):
    import cv2

    scene = root / "data" / "scene0"
    for sub in ("depth", "pose"):
        os.makedirs(scene / sub, exist_ok=True)
    np.savetxt(scene / "intrinsics.txt", np.array([[120.0, 0, 64], [0, 120.0, 48], [0, 0, 1]]))
    for fi in range(2):
        depth = (1.2 + 0.4 * rng.rand(96, 128)) * 1000
        cv2.imwrite(str(scene / "depth" / f"{fi}.png"), depth.astype(np.uint16))
        pose = np.eye(4)
        pose[:3, 3] = [0.1 * fi, 0, 0]
        np.savetxt(scene / "pose" / f"{fi}.txt", pose)
    os.makedirs(root / "metadata", exist_ok=True)
    with open(root / "metadata" / "test.pkl", "wb") as f:
        pickle.dump([{"scene_name": "scene0", "src_frame": 0, "tgt_frame": 1}], f)
    return [dict(subset="test", max_points=2000)], "ScanNetURRPairDataset"


DATASETS = {"kitti": _kitti, "modelnet": _modelnet, "shapenet": _shapenet,
            "cape": _deformable("CapePairDataset"),
            "deepdeform": _deformable("DeepDeformPairDataset"), "redwood": _redwood,
            "scannet_urr": _scannet}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_library_dataset(tmp_path, name):
    """Both packages' readers on one on-disk fixture and one seed: the same
    samples, augmentation included."""
    settings, cls = DATASETS[name](tmp_path, np.random.RandomState(0))
    seeded = cls not in ("CapePairDataset", "DeepDeformPairDataset")
    for kw in settings:
        if seeded:
            kw = dict(kw, rng=np.random.RandomState(5))
        ref_ds = getattr(jax_lib, cls)(str(tmp_path), **kw)
        if seeded:
            kw = dict(kw, rng=np.random.RandomState(5))
        got_ds = getattr(library_datasets, cls)(str(tmp_path), **kw)
        assert len(got_ds) == len(ref_ds) > 0
        for i in range(len(ref_ds)):
            assert_same(got_ds[i], ref_ds[i])


def test_dataset_helpers():
    a, b = np.random.RandomState(1), np.random.RandomState(1)
    assert_same(library_datasets.random_sample_transform(a, 30.0, 1.0),
                jax_lib.random_sample_transform(b, 30.0, 1.0))
    pts = a.rand(300, 3).astype(np.float32)
    tfm = jax_lib.random_sample_transform(b, 30.0, 1.0)
    assert_same(library_datasets.point_cloud_overlap(pts, pts + 0.01, tfm, 0.1),
                jax_lib.point_cloud_overlap(pts, pts + 0.01, tfm, 0.1))


# ---------------------------------------------------------------- utils


@pytest.mark.parametrize("binary", [True, False])
def test_ply_both_ways(tmp_path, binary):
    rng = np.random.RandomState(2)
    cols = [rng.rand(50, 3).astype(np.float32), rng.rand(50).astype(np.float64),
            rng.randint(0, 9, 50).astype(np.int32), rng.randint(0, 255, 50).astype(np.uint8)]
    names = ["x", "y", "z", "w", "label", "red"]
    ply.write_ply(str(tmp_path / "port.ply"), cols, names, binary)
    jax_ply.write_ply(str(tmp_path / "jax.ply"), cols, names, binary)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    assert_same(jax_ply.read_ply(str(tmp_path / "port.ply")),
                ply.read_ply(str(tmp_path / "jax.ply")))


def test_context_manager():
    ops = [("register", "a", 1), ("set_scope", "s"), ("register", "a", 2), ("get", "a"),
           ("exists", "b"), ("set_scope", "default"), ("get", "a"), ("delete_scope", "s"),
           ("get_scope",), ("remove", "a"), ("exists", "a")]

    def trace(mod):
        cm = mod.ContextManager()
        out = [getattr(cm, op)(*args) for op, *args in ops]
        return out + [sorted(cm.scopes()), mod.get_context_manager() is mod.get_context_manager()]

    assert trace(context) == trace(jax_context)


def test_profiling(tmp_path):
    x = torch.randn(64, 64)
    with profiling.DeviceTimer("mm", sync_value=x) as timer:
        (x @ x).sum()
    assert timer.elapsed > 0.0
    timers = Timers()
    with profiling.runtime_profiler("mm", timers):
        x @ x
    assert timers.meters["mm"].count == 1
    with profiling.trace(str(tmp_path)):
        x @ x
    assert any(name.endswith(".json") or name.endswith(".json.gz")
               for name in os.listdir(tmp_path))
