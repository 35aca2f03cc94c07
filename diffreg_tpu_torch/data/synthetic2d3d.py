"""Synthetic image <-> cloud pairs for the 2D-3D pipeline (tests, demo runs).

A smooth random depth map (8 x 8 blocks), its back-projection for the image
side, a cloud sampled from the same camera points in a world frame under a
known rigid transform, the 3-level pyramid, nearest-patch coarse GT, and
(for training) the overlap and fine GT pairs. Same draws and arrays as the JAX package's data/synthetic2d3d.py at the same
seed.
"""
from __future__ import annotations

import numpy as np

from .batch import pad_to
from .native import grid_subsample_native, radius_neighbors_native


def random_rotation(rng: np.random.RandomState) -> np.ndarray:
    a = rng.randn(3, 3)
    q, _ = np.linalg.qr(a)
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q.astype(np.float32)


def _pyramid_3lvl(points, caps, ks, radius0):
    """3-level pyramid arrays of one cloud, padded to ``caps``."""
    levels = [points]
    r = radius0
    radii = [r]
    for _ in range(2):
        levels.append(grid_subsample_native(levels[-1], 2 * r / 2.5))
        r *= 2
        radii.append(r)
    pts, masks, neigh, pools, ups = [], [], [], [], []
    for l in range(3):
        n_real = len(levels[l])
        if n_real > caps[l]:
            raise ValueError(f"2d3d bucket too small at level {l}")
        pts.append(pad_to(levels[l].astype(np.float32), caps[l]))
        masks.append(np.arange(caps[l]) < n_real)
        idx = radius_neighbors_native(levels[l], levels[l], radii[l], ks[l])
        neigh.append(pad_to(np.where(idx >= n_real, caps[l], idx), caps[l], fill=caps[l]))
        if l < 2:
            pi = radius_neighbors_native(levels[l + 1], levels[l], radii[l], ks[l])
            pi = np.where(pi >= len(levels[l]), caps[l], pi)
            pools.append(pad_to(pi, caps[l + 1], fill=caps[l]))
            ui = radius_neighbors_native(levels[l], levels[l + 1], 2 * radii[l], 4)
            ui = np.where(ui >= len(levels[l + 1]), caps[l + 1], ui)
            ups.append(pad_to(ui, caps[l], fill=caps[l + 1]))
    return pts, masks, neigh, pools, ups


def synthetic_2d3d_batch(batch_size=1, img_hw=(64, 96), n_points=512, seed=0,
                         coarse_stride=8, n_gt=64, with_full_gt=False, n_overlap=256,
                         n_fine_gt=64, gt_radius_3d=0.05):
    """A ``Batch2D3D`` of CPU tensors: ``batch_size`` synthetic pairs.
    ``with_full_gt`` adds the training losses' ground truth through the
    collate helpers: the node <-> patch overlap pairs (up to ``n_overlap``)
    and the fine pixel <-> point pairs (up to ``n_fine_gt``), both within
    ``gt_radius_3d`` and 8 px."""
    from ..models.pipeline_2d3d import Batch2D3D
    from .collate2d3d import fine_gt_correspondences, node_patch_overlaps

    rng = np.random.RandomState(seed)
    h, w = img_hw
    fx = fy = 0.8 * w
    cx, cy = w / 2.0, h / 2.0
    intrinsics = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    caps, ks = (n_points,) * 3, (16,) * 3
    full_gt = ("ov_src", "ov_tgt", "ov_min", "ov_max", "ov_valid", "fine_pixels",
               "fine_pcd_idx", "fine_valid") if with_full_gt else ()
    cols = {k: [] for k in ("image", "img_points", "img_valid", "pcd_feats", "transform",
                            "gt_src", "gt_tgt", "gt_valid") + full_gt}
    pyrs = []
    for _ in range(batch_size):
        base = rng.rand(-(-h // 8), -(-w // 8)).astype(np.float32)
        depth = (np.kron(base, np.ones((8, 8), np.float32)) * 1.5 + 1.0)[:h, :w]
        img = (depth - depth.min()) / (np.ptp(depth) + 1e-6)
        vv, uu = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        z = depth.reshape(-1)
        cam_pts = np.stack([(uu.reshape(-1) - cx) * z / fx, (vv.reshape(-1) - cy) * z / fy, z],
                           -1).astype(np.float32)

        # the cloud: a subset of the camera points in a world frame, cam = R world + t
        sel = rng.permutation(h * w)[:n_points]
        rot = random_rotation(rng)
        trn = rng.randn(3, 1).astype(np.float32) * 0.2
        world_pts = (cam_pts[sel] - trn.T) @ rot
        tfm = np.eye(4, dtype=np.float32)
        tfm[:3, :3], tfm[:3, 3] = rot, trn[:, 0]
        pyr = _pyramid_3lvl(world_pts, caps, ks, 0.3)

        # coarse GT: each node's nearest patch centre, within 0.4
        nodes = pyr[0][2][pyr[1][2]]
        nodes_cam = nodes @ rot.T + trn.T
        hc, wc = h // coarse_stride, w // coarse_stride
        centers = cam_pts.reshape(hc, coarse_stride, wc, coarse_stride, 3)
        centers = centers.transpose(0, 2, 1, 3, 4).reshape(hc * wc, -1, 3).mean(axis=1)
        d = np.linalg.norm(nodes_cam[:, None] - centers[None], axis=-1)
        ok = d.min(1) < 0.4
        m = min(int(ok.sum()), n_gt)
        rows = np.nonzero(ok)[0][:m]
        gt = np.zeros((3, n_gt), np.int32)
        gt[0, :m], gt[1, :m], gt[2, :m] = rows, d.argmin(1)[rows], 1

        pyrs.append(pyr)
        cols["image"].append(img[..., None])
        cols["img_points"].append(cam_pts)
        cols["img_valid"].append(z > 0)
        cols["pcd_feats"].append(pad_to(np.ones((len(world_pts), 1), np.float32), caps[0]))
        cols["transform"].append(tfm)
        cols["gt_src"].append(gt[0])
        cols["gt_tgt"].append(gt[1])
        cols["gt_valid"].append(gt[2].astype(bool))
        if with_full_gt:
            valid = z > 0
            ov = node_patch_overlaps(world_pts, nodes, cam_pts, valid, tfm, intrinsics, (h, w),
                                     coarse_stride, matching_radius_3d=gt_radius_3d,
                                     matching_radius_2d=8.0, num_points_in_patch=32,
                                     max_pairs=n_overlap)
            fine = fine_gt_correspondences(cam_pts, valid, world_pts, tfm, intrinsics, (h, w),
                                           n_fine_gt, matching_radius_3d=gt_radius_3d,
                                           matching_radius_2d=8.0, rng=rng)
            for key, arr in zip(full_gt, ov + fine):
                cols[key].append(arr)

    arrays = {k: np.stack(v) for k, v in cols.items()}
    arrays["intrinsics"] = np.stack([intrinsics] * batch_size)
    for name, part, n in (("points", 0, 3), ("masks", 1, 3), ("neighbors", 2, 3),
                          ("pools", 3, 2), ("upsamples", 4, 2)):
        arrays[name] = tuple(np.stack([p[part][i] for p in pyrs]) for i in range(n))
    return Batch2D3D.from_numpy(arrays)
