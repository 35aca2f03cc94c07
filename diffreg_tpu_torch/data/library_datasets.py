"""The reference's registration dataset library: numpy readers beyond the live path.

Counterpart of the JAX package's data/library_datasets.py, the port's own
copy: the readers of vision3d/datasets/registration/ (kitti, modelnet,
shapenet, cape, deepdeform, redwood, scannet_urr) that downstream models rely
on. All readers emit the raw-sample schema the graph-pyramid collate
consumes (src_points/tgt_points/src_feats/tgt_feats/transform [+
scene_flows]), are pure numpy on the host, and take an optional seeded
RandomState used draw for draw as the JAX package uses it, so that the same
seed gives the same samples in both packages. ``cv2`` is imported where a
reader decodes a depth PNG, not at import.

Reference files:
  kitti/odometry_kitti.py:17-162, modelnet/modelnet.py:26-238,
  shapenet/shapenet.py:25-202, cape/cape.py:23-80, deepdeform/
  deepdeform.py:11-67, redwood/redwood.py:14-90, scannet_urr/
  scannet_urr.py:16-166, array_ops/point_cloud_utils.py (crop/sample/SE3
  helpers).
"""
from __future__ import annotations

import os
import pickle
from typing import List, Optional, Sequence

import numpy as np

# --------------------------------------------------------------------- #
# point-cloud / SE(3) helpers (array_ops/point_cloud_utils.py twins)
# --------------------------------------------------------------------- #


def normalize_points(points: np.ndarray) -> np.ndarray:
    """Center on the mean and scale into the unit sphere."""
    points = points - points.mean(axis=0)
    return points / np.max(np.linalg.norm(points, axis=1))


def random_sample_points(rng, points, num_samples, normals=None):
    """Random subset; shorter clouds are tiled up to ``num_samples``."""
    n = points.shape[0]
    sel = rng.permutation(n)
    if n > num_samples:
        sel = sel[:num_samples]
    elif n < num_samples:
        reps = [sel] * (num_samples // n)
        if num_samples % n:
            reps.append(sel[: num_samples % n])
        sel = np.concatenate(reps)
    if normals is None:
        return points[sel]
    return points[sel], normals[sel]


def random_jitter_points(rng, points, sigma=0.01, clip=0.05):
    return points + np.clip(rng.normal(scale=sigma, size=points.shape),
                            -clip, clip)


def random_crop_plane(rng, points, keep_ratio, normals=None, p_normal=None):
    """Keep the ``keep_ratio`` fraction on one side of a random plane."""
    k = int(np.floor(points.shape[0] * keep_ratio + 0.5))
    if p_normal is None:
        v = rng.randn(3)
        p_normal = v / np.linalg.norm(v)
    sel = np.argsort(-(points @ p_normal))[:k]
    if normals is None:
        return points[sel]
    return points[sel], normals[sel]


def random_sample_viewpoint(rng, radius=500.0):
    return rng.rand(3) + radius * rng.choice([1.0, -1.0], size=3)


def random_crop_viewpoint(rng, points, keep_ratio, viewpoint=None, normals=None):
    """Keep the ``keep_ratio`` fraction nearest a random viewpoint."""
    k = int(np.floor(points.shape[0] * keep_ratio + 0.5))
    if viewpoint is None:
        viewpoint = random_sample_viewpoint(rng)
    sel = np.argsort(np.linalg.norm(points - viewpoint, axis=1))[:k]
    if normals is None:
        return points[sel]
    return points[sel], normals[sel]


def _euler_zyx(euler):
    cz, sz = np.cos(euler[0]), np.sin(euler[0])
    cy, sy = np.cos(euler[1]), np.sin(euler[1])
    cx, sx = np.cos(euler[2]), np.sin(euler[2])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    return rz @ ry @ rx


def random_sample_rotation(rng, rotation_factor: float = 1.0) -> np.ndarray:
    """Euler angles uniform in [0, 2pi/factor] (point_cloud_utils.py:216)."""
    euler = rng.rand(3) * 2.0 * np.pi / rotation_factor
    return _euler_zyx(euler)


def random_sample_transform(rng, rotation_magnitude_deg, translation_magnitude):
    """Euler in [0, pi*mag/180] + uniform translation (pcu.py:238-244)."""
    euler = rng.rand(3) * np.pi * rotation_magnitude_deg / 180.0
    t = rng.uniform(-translation_magnitude, translation_magnitude, 3)
    tfm = np.eye(4)
    tfm[:3, :3] = _euler_zyx(euler)
    tfm[:3, 3] = t
    return tfm


def apply_transform(points, transform, normals=None):
    out = points @ transform[:3, :3].T + transform[:3, 3]
    if normals is None:
        return out
    return out, normals @ transform[:3, :3].T


def inverse_transform(transform):
    inv = np.eye(4)
    r = transform[:3, :3]
    inv[:3, :3] = r.T
    inv[:3, 3] = -r.T @ transform[:3, 3]
    return inv


def point_cloud_overlap(src_points, tgt_points, transform=None, positive_radius=0.1):
    """Fraction of src points with a tgt point within radius (metrics.py:160)."""
    from scipy.spatial import cKDTree

    if transform is not None:
        src_points = apply_transform(src_points, transform)
    d, _ = cKDTree(tgt_points).query(src_points, k=1)
    return float((d < positive_radius).mean())


def radius_correspondences(src_points, tgt_points, transform, radius):
    """All (src, tgt) index pairs within ``radius`` under the GT transform."""
    from scipy.spatial import cKDTree

    src_t = apply_transform(src_points, transform)
    tree = cKDTree(tgt_points)
    pairs = [(i, j) for i, lst in enumerate(tree.query_ball_point(src_t, radius))
             for j in lst]
    return np.asarray(pairs, np.int64).reshape(-1, 2)


def _load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


# --------------------------------------------------------------------- #
# Odometry KITTI (kitti/odometry_kitti.py:17-162)
# --------------------------------------------------------------------- #


class OdometryKittiPairDataset:
    """LiDAR fragment pairs with ICP-refined GT poses.

    ``metadata/{subset}.pkl`` lists dicts with seq_id/frame0/frame1/pcd0/
    pcd1/transform; clouds are ``.npy`` [N, 3] (the downsampled release).
    """

    SPLIT = {"train": ["00", "01", "02", "03", "04", "05"],
             "val": ["06", "07"],
             "test": ["08", "09", "10"]}

    def __init__(self, dataset_dir, subset, max_points=None,
                 use_augmentation=False, augmentation_noise=0.005,
                 augmentation_min_scale=0.8, augmentation_max_scale=1.2,
                 augmentation_shift=2.0, augmentation_rotation=1.0,
                 return_corr_indices=False, matching_radius=None,
                 scaling_factor=None, min_range=None, max_range=None,
                 rng: Optional[np.random.RandomState] = None):
        self.dataset_dir = dataset_dir
        self.max_points = max_points
        self.use_augmentation = use_augmentation
        self.noise = augmentation_noise
        self.min_scale = augmentation_min_scale
        self.max_scale = augmentation_max_scale
        self.shift = augmentation_shift
        self.rotation = augmentation_rotation
        self.return_corr_indices = return_corr_indices
        if return_corr_indices and matching_radius is None:
            raise ValueError("matching_radius required with return_corr_indices")
        self.matching_radius = matching_radius
        self.scaling_factor = scaling_factor
        self.min_range = min_range
        self.max_range = max_range
        self.rng = rng or np.random.RandomState()
        self.metadata = _load_pickle(
            os.path.join(dataset_dir, "metadata", f"{subset}.pkl"))

    def __len__(self):
        return len(self.metadata)

    def _load_cloud(self, rel):
        points = np.load(os.path.join(self.dataset_dir, rel))
        if self.min_range is not None:
            points = points[np.amin(points, axis=1) >= self.min_range]
        if self.max_range is not None:
            points = points[np.amax(points, axis=1) <= self.max_range]
        if self.max_points is not None and len(points) > self.max_points:
            points = points[self.rng.permutation(len(points))[: self.max_points]]
        return points

    def _augment(self, src, tgt, transform):
        """Noise + one-sided random SO(3) with pose recomposition + uniform
        scale + per-side shift (odometry_kitti.py:71-99)."""
        rng = self.rng
        rot, trn = transform[:3, :3], transform[:3, 3]
        src = src + (rng.rand(*src.shape) - 0.5) * self.noise
        tgt = tgt + (rng.rand(*tgt.shape) - 0.5) * self.noise
        aug = random_sample_rotation(rng, self.rotation)
        if rng.rand() > 0.5:
            tgt = tgt @ aug.T
            rot = aug @ rot
            trn = aug @ trn
        else:
            src = src @ aug.T
            rot = rot @ aug.T
        scale = self.min_scale + (self.max_scale - self.min_scale) * rng.rand()
        src, tgt, trn = src * scale, tgt * scale, trn * scale
        s_shift = rng.uniform(-self.shift, self.shift, 3)
        t_shift = rng.uniform(-self.shift, self.shift, 3)
        src = src + s_shift
        tgt = tgt + t_shift
        trn = -rot @ s_shift + trn + t_shift
        tfm = np.eye(4)
        tfm[:3, :3], tfm[:3, 3] = rot, trn
        return src, tgt, tfm

    def __getitem__(self, index):
        meta = self.metadata[index]
        src = self._load_cloud(meta["pcd1"])
        tgt = self._load_cloud(meta["pcd0"])
        transform = np.asarray(meta["transform"], np.float64)
        if self.use_augmentation:
            src, tgt, transform = self._augment(src, tgt, transform)
        out = {"seq_id": meta["seq_id"], "src_frame": meta["frame1"],
               "tgt_frame": meta["frame0"]}
        if self.return_corr_indices:
            pairs = radius_correspondences(src, tgt, transform,
                                           self.matching_radius)
            out["src_corr_indices"] = pairs[:, 0]
            out["tgt_corr_indices"] = pairs[:, 1]
        if self.scaling_factor is not None:
            src = src * self.scaling_factor
            tgt = tgt * self.scaling_factor
            transform = transform.copy()
            transform[:3, 3] *= self.scaling_factor
        out.update(
            src_points=src.astype(np.float32),
            tgt_points=tgt.astype(np.float32),
            src_feats=np.ones((len(src), 1), np.float32),
            tgt_feats=np.ones((len(tgt), 1), np.float32),
            transform=transform.astype(np.float32))
        return out


# --------------------------------------------------------------------- #
# Synthetic CAD pairs: ModelNet / ShapeNet (modelnet.py:26-238,
# shapenet.py:25-202 — one shared crop/overlap engine)
# --------------------------------------------------------------------- #


class _SyntheticCADPairDataset:
    def __init__(self, num_points=1024, rotation_magnitude=45.0,
                 translation_magnitude=0.5, noise_magnitude=None,
                 keep_ratio=0.7, crop_method="plane", deterministic=False,
                 twice_sample=False, twice_transform=False,
                 return_normals=True, return_corr_indices=False,
                 matching_radius=0.05, min_overlap=None, max_overlap=None,
                 rng: Optional[np.random.RandomState] = None):
        assert crop_method in ("plane", "point")
        self.num_points = num_points
        self.rotation_magnitude = rotation_magnitude
        self.translation_magnitude = translation_magnitude
        self.noise_magnitude = noise_magnitude
        self.keep_ratio = keep_ratio
        self.crop_method = crop_method
        self.deterministic = deterministic
        self.twice_sample = twice_sample
        self.twice_transform = twice_transform
        self.return_normals = return_normals
        self.return_corr_indices = return_corr_indices
        self.matching_radius = matching_radius
        self.min_overlap = min_overlap
        self.max_overlap = max_overlap
        self.rng = rng or np.random.RandomState()

    def _make_pair(self, raw_points, raw_normals, label):
        rng = self.rng
        raw_points = normalize_points(raw_points)
        if not self.twice_sample:
            raw_points, raw_normals = random_sample_points(
                rng, raw_points, self.num_points, raw_normals)

        tgt_points, tgt_normals = raw_points.copy(), raw_normals.copy()
        if self.twice_transform:
            tfm = random_sample_transform(rng, self.rotation_magnitude,
                                          self.translation_magnitude)
            tgt_points, tgt_normals = apply_transform(tgt_points, tfm, tgt_normals)

        transform = random_sample_transform(rng, self.rotation_magnitude,
                                            self.translation_magnitude)
        src_points, src_normals = apply_transform(
            tgt_points.copy(), inverse_transform(transform),
            tgt_normals.copy())

        # crop until the overlap constraint is met (modelnet.py:168-199);
        # bounded retries keep a pathological sample from spinning forever
        for _ in range(64):
            sp, sn, tp, tn = src_points, src_normals, tgt_points, tgt_normals
            if self.keep_ratio is not None:
                if self.crop_method == "plane":
                    sp, sn = random_crop_plane(rng, sp, self.keep_ratio, sn)
                    tp, tn = random_crop_plane(rng, tp, self.keep_ratio, tn)
                else:
                    vp = random_sample_viewpoint(rng)
                    sp, sn = random_crop_viewpoint(rng, sp, self.keep_ratio, vp, sn)
                    tp, tn = random_crop_viewpoint(rng, tp, self.keep_ratio, vp, tn)
            ov = point_cloud_overlap(sp, tp, transform, self.matching_radius)
            ok = ov > (self.min_overlap if self.min_overlap is not None else 0.0)
            if self.min_overlap is not None:
                ok = ov >= self.min_overlap
            if self.max_overlap is not None:
                ok = ok and ov <= self.max_overlap
            if ok:
                break
        src_points, src_normals = sp, sn
        tgt_points, tgt_normals = tp, tn

        if self.twice_sample:
            src_points, src_normals = random_sample_points(
                rng, src_points, self.num_points, src_normals)
            tgt_points, tgt_normals = random_sample_points(
                rng, tgt_points, self.num_points, tgt_normals)
        if self.noise_magnitude is not None:
            src_points = random_jitter_points(rng, src_points,
                                              sigma=0.01,
                                              clip=self.noise_magnitude)
            tgt_points = random_jitter_points(rng, tgt_points,
                                              sigma=0.01,
                                              clip=self.noise_magnitude)

        out = {
            "raw_points": raw_points.astype(np.float32),
            "src_points": src_points.astype(np.float32),
            "tgt_points": tgt_points.astype(np.float32),
            "src_feats": np.ones((len(src_points), 1), np.float32),
            "tgt_feats": np.ones((len(tgt_points), 1), np.float32),
            "transform": transform.astype(np.float32),
            "label": label,
        }
        if self.return_normals:
            out["src_normals"] = src_normals.astype(np.float32)
            out["tgt_normals"] = tgt_normals.astype(np.float32)
        if self.return_corr_indices:
            pairs = radius_correspondences(src_points, tgt_points, transform,
                                           self.matching_radius)
            out["src_corr_indices"] = pairs[:, 0]
            out["tgt_corr_indices"] = pairs[:, 1]
        return out


class ModelNetPairDataset(_SyntheticCADPairDataset):
    """ModelNet40 partial-overlap pairs (modelnet.py:26-238): pkl entries
    {points, normals, label}, class filtering (all/seen/unseen +
    asymmetric-only), random SE(3) split + crop with overlap rejection."""

    # fmt: off
    ALL_CATEGORIES = [
        'airplane', 'bathtub', 'bed', 'bench', 'bookshelf', 'bottle', 'bowl',
        'car', 'chair', 'cone', 'cup', 'curtain', 'desk', 'door', 'dresser',
        'flower_pot', 'glass_box', 'guitar', 'keyboard', 'lamp', 'laptop',
        'mantel', 'monitor', 'night_stand', 'person', 'piano', 'plant',
        'radio', 'range_hood', 'sink', 'sofa', 'stairs', 'stool', 'table',
        'tent', 'toilet', 'tv_stand', 'vase', 'wardrobe', 'xbox']
    ASYMMETRIC_INDICES = [
        0, 1, 2, 3, 4, 7, 8, 11, 12, 13, 14, 16, 17, 18, 20, 21, 22, 23, 24,
        25, 26, 27, 28, 29, 30, 31, 32, 33, 35, 36, 38, 39]
    # fmt: on

    def __init__(self, dataset_dir, subset, class_indices="all",
                 asymmetric=True, overfitting_index=None, **kwargs):
        super().__init__(**kwargs)
        assert subset in ("trainval", "train", "val", "test")
        idx = self._class_indices(class_indices, asymmetric)
        data = _load_pickle(os.path.join(dataset_dir, f"{subset}.pkl"))
        data = [x for x in data if x["label"] in idx]
        if overfitting_index is not None:
            data = [data[overfitting_index]]
        self.data_list = data

    @classmethod
    def _class_indices(cls, spec, asymmetric):
        if isinstance(spec, str):
            spec = {"all": list(range(40)), "seen": list(range(20)),
                    "unseen": list(range(20, 40))}[spec]
        if asymmetric:
            spec = [i for i in spec if i in cls.ASYMMETRIC_INDICES]
        return set(spec)

    def __len__(self):
        return len(self.data_list)

    def __getitem__(self, index):
        d = self.data_list[index]
        if self.deterministic:
            self.rng = np.random.RandomState(index)
        return self._make_pair(d["points"].copy(), d["normals"].copy(),
                               d["label"])


class ShapeNetPairDataset(_SyntheticCADPairDataset):
    """ShapeNet pairs (shapenet.py:25-202): metadata/{subset}.txt filename
    list, per-file npz {points, normals}, axis permutation
    (x,y,z) <- (-z, -x, y) before the shared pair machinery."""

    def __init__(self, dataset_dir, subset, **kwargs):
        super().__init__(**kwargs)
        assert subset in ("train", "val", "test")
        self.dataset_dir = dataset_dir
        with open(os.path.join(dataset_dir, "metadata", f"{subset}.txt")) as f:
            self.filenames = [l.strip() for l in f if l.strip()]

    def __len__(self):
        return len(self.filenames)

    def __getitem__(self, index):
        name = self.filenames[index]
        d = np.load(os.path.join(self.dataset_dir, "data", name))
        p, n = d["points"].copy(), d["normals"].copy()
        p = np.stack([-p[:, 2], -p[:, 0], p[:, 1]], axis=1)
        n = np.stack([-n[:, 2], -n[:, 0], n[:, 1]], axis=1)
        if self.deterministic:
            self.rng = np.random.RandomState(index)
        return self._make_pair(p, n, name.split("/")[0])


# --------------------------------------------------------------------- #
# Deformable npz pairs: CAPE / DeepDeform (cape.py:23-80, deepdeform.py:11-67)
# --------------------------------------------------------------------- #


class _DeformableNpzPairDataset:
    """npz entries {src_points, tgt_points, scene_flows}; identity rigid
    transform (the motion is the flow)."""

    def __init__(self, dataset_dir, file_list: Sequence[str], transform_fn=None):
        self.dataset_dir = dataset_dir
        self.file_list = list(file_list)
        self.transform_fn = transform_fn

    def __len__(self):
        return len(self.file_list)

    def __getitem__(self, index):
        path = self.file_list[index]
        d = np.load(os.path.join(self.dataset_dir, path))
        src, tgt = d["src_points"], d["tgt_points"]
        flows = d["scene_flows"]
        norms = np.linalg.norm(flows, axis=1)
        out = {
            "filename": os.path.basename(path),
            "src_points": src.astype(np.float32),
            "tgt_points": tgt.astype(np.float32),
            "src_feats": np.ones((len(src), 1), np.float32),
            "tgt_feats": np.ones((len(tgt), 1), np.float32),
            "scene_flows": flows.astype(np.float32),
            "mean_flow": float(norms.mean()),
            "max_flow": float(norms.max()),
            "transform": np.eye(4, dtype=np.float32),
        }
        if self.transform_fn is not None:
            out = self.transform_fn(out)
        return out


class CapePairDataset(_DeformableNpzPairDataset):
    """CAPE clothed-human pairs (cape.py): metadata/{subset}.pkl file list."""

    def __init__(self, dataset_dir, subset, transform_fn=None):
        files = _load_pickle(os.path.join(dataset_dir, "metadata",
                                          f"{subset}.pkl"))
        super().__init__(dataset_dir, files, transform_fn)


class DeepDeformPairDataset(_DeformableNpzPairDataset):
    """DeepDeform RGB-D deformable pairs (deepdeform.py)."""

    def __init__(self, dataset_dir, subset, transform_fn=None):
        files = _load_pickle(os.path.join(dataset_dir, "metadata",
                                          f"{subset}.pkl"))
        super().__init__(dataset_dir, files, transform_fn)


# --------------------------------------------------------------------- #
# Redwood fragments (redwood/redwood.py:14-90) — our PLY reader, no open3d
# --------------------------------------------------------------------- #


class RedwoodPairDataset:
    """Consecutive-fragment pairs from a Redwood scan: ``fragments/*.ply``
    clouds + per-fragment ``.npy`` poses; GT transform = inv(pose_j) @
    pose_i mapping fragment i into fragment j's frame."""

    def __init__(self, dataset_dir, frame_gap=1, max_points=None,
                 rng: Optional[np.random.RandomState] = None):
        self.fragment_dir = os.path.join(dataset_dir, "fragments")
        self.max_points = max_points
        self.rng = rng or np.random.RandomState()
        names = sorted(f for f in os.listdir(self.fragment_dir)
                       if f.endswith(".ply"))
        self.pairs = []
        for i in range(len(names) - frame_gap):
            j = i + frame_gap
            self.pairs.append((names[i], names[j]))

    def __len__(self):
        return len(self.pairs)

    def _load(self, name):
        from ..utils.ply import read_ply

        data = read_ply(os.path.join(self.fragment_dir, name))
        pts = np.stack([data["x"], data["y"], data["z"]], axis=1)
        if self.max_points is not None and len(pts) > self.max_points:
            pts = pts[self.rng.permutation(len(pts))[: self.max_points]]
        return pts.astype(np.float32)

    def __getitem__(self, index):
        src_name, tgt_name = self.pairs[index]
        src = self._load(src_name)
        tgt = self._load(tgt_name)
        src_pose = np.load(os.path.join(
            self.fragment_dir, src_name.replace("ply", "npy")))
        tgt_pose = np.load(os.path.join(
            self.fragment_dir, tgt_name.replace("ply", "npy")))
        transform = inverse_transform(tgt_pose) @ src_pose
        return {
            "src_frame": src_name, "tgt_frame": tgt_name,
            "src_points": src, "tgt_points": tgt,
            "src_feats": np.ones((len(src), 1), np.float32),
            "tgt_feats": np.ones((len(tgt), 1), np.float32),
            "transform": transform.astype(np.float32),
        }


# --------------------------------------------------------------------- #
# ScanNet URR (scannet_urr/scannet_urr.py:16-166) — depth-frame pairs
# --------------------------------------------------------------------- #


class ScanNetURRPairDataset:
    """Unsupervised RGB-D pairs: metadata/{subset}.pkl entries with
    scene_name/src_frame/tgt_frame; per-scene intrinsics txt, per-frame
    16-bit depth png (mm) + pose txt. Emits back-projected clouds with the
    relative camera transform as GT."""

    def __init__(self, dataset_dir, subset, max_points=None,
                 depth_scale=1000.0, depth_limit=6.0,
                 rng: Optional[np.random.RandomState] = None):
        self.dataset_dir = dataset_dir
        self.max_points = max_points
        self.depth_scale = depth_scale
        self.depth_limit = depth_limit
        self.rng = rng or np.random.RandomState()
        self.metadata = _load_pickle(
            os.path.join(dataset_dir, "metadata", f"{subset}.pkl"))

    def __len__(self):
        return len(self.metadata)

    def _frame_cloud(self, scene_dir, frame_id, intrinsics):
        import cv2

        depth = cv2.imread(
            os.path.join(scene_dir, "depth", f"{frame_id}.png"),
            cv2.IMREAD_UNCHANGED).astype(np.float32) / self.depth_scale
        pose = np.loadtxt(os.path.join(scene_dir, "pose", f"{frame_id}.txt"))
        h, w = depth.shape
        vv, uu = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        z = depth.reshape(-1)
        good = (z > 0) & (z < self.depth_limit)
        fx, fy = intrinsics[0, 0], intrinsics[1, 1]
        cx, cy = intrinsics[0, 2], intrinsics[1, 2]
        pts = np.stack([(uu.reshape(-1) - cx) * z / fx,
                        (vv.reshape(-1) - cy) * z / fy, z], axis=1)[good]
        if self.max_points is not None and len(pts) > self.max_points:
            pts = pts[self.rng.permutation(len(pts))[: self.max_points]]
        return pts.astype(np.float32), pose

    def __getitem__(self, index):
        meta = self.metadata[index]
        scene_dir = os.path.join(self.dataset_dir, "data", meta["scene_name"])
        intr = np.loadtxt(os.path.join(scene_dir, "intrinsics.txt"))
        src, src_pose = self._frame_cloud(scene_dir, meta["src_frame"], intr)
        tgt, tgt_pose = self._frame_cloud(scene_dir, meta["tgt_frame"], intr)
        transform = inverse_transform(tgt_pose) @ src_pose
        return {
            "scene_name": meta["scene_name"],
            "src_frame": meta["src_frame"], "tgt_frame": meta["tgt_frame"],
            "src_points": src, "tgt_points": tgt,
            "src_feats": np.ones((len(src), 1), np.float32),
            "tgt_feats": np.ones((len(tgt), 1), np.float32),
            "transform": transform.astype(np.float32),
            "intrinsics": intr.astype(np.float32),
        }
