"""2D-3D collate: raw sample dicts -> padded ``Batch2D3D``.

Counterpart of the JAX package's data/collate2d3d.py (vision3d's
GraphPyramid2D3DRegistrationCollateFn), host numpy: back-project the depth
map, build the 3-level cloud pyramid with the native library, and compute
the coarse ground truth (the escalated binary GT and the node <-> patch
overlap pairs) and the fine pixel <-> point pairs, padded to a ``Spec2D3D``.
The arrays equal the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from .batch import pad_to, stack_pairs
from .native import grid_subsample_native, radius_neighbors_native


@dataclasses.dataclass(frozen=True)
class Spec2D3D:
    n_points: Tuple[int, int, int]
    k_neighbors: Tuple[int, int, int] = (32, 32, 32)
    k_pools: Tuple[int, int] = (32, 32)
    k_upsamples: Tuple[int, int] = (4, 4)
    n_gt: int = 256                 # escalated binary-GT pair buffer
    n_overlap: int = 1024           # overlap-ratio pair buffer (circle loss GT)
    n_fine_gt: int = 256            # fine GT pixel<->point buffer (loss.py:136 max_correspondences)
    init_radius: float = 0.0625     # 2.5 * 2.5cm voxel (config.py KPConv)
    # GT radii (reference config.py:82-83)
    matching_radius_3d: float = 0.0375
    matching_radius_2d: float = 8.0
    num_points_in_patch: int = 128  # config.py:84 pcd_num_points_in_patch


def _back_project_np(depth, intrinsics, depth_limit=6.0):
    h, w = depth.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    vv, uu = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    z = depth.reshape(-1)
    x = (uu.reshape(-1) - cx) * z / fx
    y = (vv.reshape(-1) - cy) * z / fy
    pts = np.stack([x, y, z], -1).astype(np.float32)
    valid = (z > 0) & (z <= depth_limit)
    return pts, valid


def _render_np(points_cam: np.ndarray, intrinsics: np.ndarray) -> np.ndarray:
    """Project camera-frame points to (v, u) float pixels."""
    z = np.clip(points_cam[:, 2], 1e-8, None)
    u = points_cam[:, 0] * intrinsics[0, 0] / z + intrinsics[0, 2]
    v = points_cam[:, 1] * intrinsics[1, 1] / z + intrinsics[1, 2]
    return np.stack([v, u], -1).astype(np.float32)


def _node_knn(points: np.ndarray, nodes: np.ndarray, k: int,
              return_sizes: bool = False):
    """Per-node k nearest member points (point_to_node partition semantics,
    vision3d/ops/point_cloud_partition.py:41-105): each fine point belongs to
    its nearest node; each node keeps its k nearest members. ``return_sizes``
    additionally returns the FULL (uncapped) member count per node — the
    reference's node_sizes used by the min-size validity gate."""
    from scipy.spatial import cKDTree

    n = len(nodes)
    _, p2n = cKDTree(nodes).query(points, k=1)
    knn_idx = np.zeros((n, k), np.int64)
    knn_mask = np.zeros((n, k), bool)
    sizes = np.zeros(n, np.int64)
    for ni in range(n):
        members = np.nonzero(p2n == ni)[0]
        sizes[ni] = len(members)
        if len(members) == 0:
            continue
        d = np.linalg.norm(points[members] - nodes[ni], axis=-1)
        order = np.argsort(d)[:k]
        m = len(order)
        knn_idx[ni, :m] = members[order]
        knn_mask[ni, :m] = True
    if return_sizes:
        return knn_idx, knn_mask, sizes
    return knn_idx, knn_mask


def node_patch_overlaps(
    points: np.ndarray,          # [N0, 3] cloud points (cloud frame)
    nodes: np.ndarray,           # [Nc, 3] coarse nodes
    img_points: np.ndarray,      # [H*W, 3] back-projected depth (cam frame)
    img_valid: np.ndarray,       # [H*W]
    transform: np.ndarray,       # [4, 4] cam-from-cloud
    intrinsics: np.ndarray,
    hw: Tuple[int, int],
    stride: int,
    matching_radius_3d: float = 0.0375,
    matching_radius_2d: float = 8.0,
    num_points_in_patch: int = 128,
    patch_subsample: int = 2,
    max_pairs: int = 1024,
    min_node_size: int = 5,
):
    """GT node<->patch dual overlap ratios — host twin of the reference
    get_2d3d_node_correspondences (experiments utils.py:59-173):

    * pcd side: per-node k nearest member points, mapped to camera frame and
      rendered to pixels;
    * img side: patchify with a stride-``patch_subsample`` pixel subset
      (utils.py patchify, stride=2 at model.py:458);
    * candidates pruned by enclosing spheres (utils.py:108-118);
    * a point of one side "overlaps" when its 1-NN on the other side is
      within BOTH the 3D and the 2D radius (utils.py:131-160);
    * kept pairs need both ratios > 0; min/max ratios returned per pair
      (model.py gt_node_corr_min/max_overlaps).

    Returns padded (node_idx, patch_idx, min_overlap, max_overlap, valid),
    sorted by descending max overlap when truncation is needed.
    """
    h, w = hw
    hp, wp = h // stride, w // stride
    empty = (np.zeros(max_pairs, np.int32), np.zeros(max_pairs, np.int32),
             np.zeros(max_pairs, np.float32), np.zeros(max_pairs, np.float32),
             np.zeros(max_pairs, bool))
    if not img_valid.any() or len(points) == 0 or len(nodes) == 0:
        return empty

    FAR = 1e6

    # --- pcd side: node knn in camera frame + rendered pixels ---
    knn_idx, pcd_knn_masks, node_sizes = _node_knn(
        points, nodes, num_points_in_patch, return_sizes=True)
    cam_pts = points @ transform[:3, :3].T + transform[:3, 3]
    pcd_knn_points = cam_pts[knn_idx]                         # [N, Kc, 3]
    pcd_knn_points[~pcd_knn_masks] = FAR
    pcd_knn_pixels = _render_np(
        pcd_knn_points.reshape(-1, 3), intrinsics).reshape(len(nodes), -1, 2)
    # node validity mirrors the model: any member AND the min-size gate
    # (reference model.py:403-412 filters pcd_node_masks by
    # node_sizes > pcd_min_node_size BEFORE the GT machinery)
    pcd_masks = pcd_knn_masks.any(-1) & (node_sizes > min_node_size)

    # --- img side: patchify with a stride-subsample pixel subset ---
    vv, uu = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix_idx = (vv * w + uu).reshape(hp, stride, wp, stride)
    pix_idx = pix_idx.transpose(0, 2, 1, 3)[..., ::patch_subsample, ::patch_subsample]
    pix_idx = pix_idx.reshape(hp * wp, -1)                     # [M, Ki]
    img_knn_points = img_points[pix_idx].astype(np.float32)   # [M, Ki, 3]
    img_knn_masks = img_valid[pix_idx]                        # [M, Ki]
    img_knn_points[~img_knn_masks] = -FAR
    img_knn_pixels = np.stack(
        [pix_idx // w, pix_idx % w], -1).astype(np.float32)    # [M, Ki, 2] (v, u)
    img_masks = img_knn_masks.any(-1)

    # --- candidate pruning via enclosing spheres (utils.py:108-118) ---
    def masked_center(p, m):
        cnt = np.maximum(m.sum(-1, keepdims=True), 1)
        return np.where(m[..., None], p, 0.0).sum(1) / cnt

    img_centers = masked_center(img_knn_points, img_knn_masks)
    pcd_centers = masked_center(pcd_knn_points, pcd_knn_masks)
    img_r = np.where(img_knn_masks,
                     np.linalg.norm(img_knn_points - img_centers[:, None], axis=-1),
                     0.0).max(-1)
    pcd_r = np.where(pcd_knn_masks,
                     np.linalg.norm(pcd_knn_points - pcd_centers[:, None], axis=-1),
                     0.0).max(-1)
    dist = np.linalg.norm(img_centers[:, None] - pcd_centers[None, :], axis=-1)
    intersect = (img_r[:, None] + pcd_r[None, :] + matching_radius_3d - dist) > 0
    intersect &= img_masks[:, None] & pcd_masks[None, :]
    cand_img, cand_pcd = np.nonzero(intersect)
    if len(cand_img) == 0:
        return empty

    # --- dual overlap ratios, chunked over candidates ---
    pairs = []
    CHUNK = 4096
    for s in range(0, len(cand_img), CHUNK):
        ci = cand_img[s:s + CHUNK]
        cp = cand_pcd[s:s + CHUNK]
        ip = img_knn_points[ci]          # [B, Ki, 3]
        ix = img_knn_pixels[ci]          # [B, Ki, 2]
        im = img_knn_masks[ci]           # [B, Ki]
        pp = pcd_knn_points[cp]          # [B, Kc, 3]
        px = pcd_knn_pixels[cp]          # [B, Kc, 2]
        pm = pcd_knn_masks[cp]           # [B, Kc]

        d3 = np.linalg.norm(ip[:, :, None] - pp[:, None, :], axis=-1)  # [B, Ki, Kc]

        # img -> pcd: 1-NN in 3D, conditioned on 3D AND 2D radii + masks
        nn = d3.argmin(-1)                                             # [B, Ki]
        bidx = np.arange(len(ci))[:, None]
        d3_min = np.take_along_axis(d3, nn[..., None], -1)[..., 0]
        d2_min = np.linalg.norm(ix - px[bidx, nn], axis=-1)
        ok = (d3_min < matching_radius_3d) & (d2_min < matching_radius_2d)
        ok &= pm[bidx, nn] & im
        img_ratio = ok.sum(-1) / np.maximum(im.sum(-1), 1)

        # pcd -> img
        nn2 = d3.argmin(1)                                             # [B, Kc]
        d3_min2 = np.take_along_axis(d3, nn2[:, None, :], 1)[:, 0]
        d2_min2 = np.linalg.norm(px - ix[bidx, nn2], axis=-1)
        ok2 = (d3_min2 < matching_radius_3d) & (d2_min2 < matching_radius_2d)
        ok2 &= im[bidx, nn2] & pm
        pcd_ratio = ok2.sum(-1) / np.maximum(pm.sum(-1), 1)

        keep = (img_ratio > 0) & (pcd_ratio > 0)
        for k in np.nonzero(keep)[0]:
            lo = min(img_ratio[k], pcd_ratio[k])
            hi = max(img_ratio[k], pcd_ratio[k])
            pairs.append((int(cp[k]), int(ci[k]), float(lo), float(hi)))

    pairs.sort(key=lambda t: -t[3])
    n = min(len(pairs), max_pairs)
    node_idx = np.zeros(max_pairs, np.int32)
    patch_idx = np.zeros(max_pairs, np.int32)
    min_ov = np.zeros(max_pairs, np.float32)
    max_ov = np.zeros(max_pairs, np.float32)
    valid = np.zeros(max_pairs, bool)
    for i in range(n):
        node_idx[i], patch_idx[i], min_ov[i], max_ov[i] = pairs[i]
        valid[i] = True
    return node_idx, patch_idx, min_ov, max_ov, valid


def _kabsch_np(src: np.ndarray, tgt: np.ndarray):
    """Equal-weight Kabsch src->tgt (host twin of SoftProcrustesLayer with a
    binary GT matrix, reference procrustes.py:17-44)."""
    sc, tc = src.mean(0), tgt.mean(0)
    h = (src - sc).T @ (tgt - tc)
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    t = tc - r @ sc
    return r, t


def _isotropic_error_np(gt: np.ndarray, est: np.ndarray):
    """(RRE deg, RTE m) — vision3d compute_isotropic_transform_error."""
    cos = np.clip((np.trace(est[:3, :3].T @ gt[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
    rre = float(np.degrees(np.arccos(cos)))
    rte = float(np.linalg.norm(gt[:3, 3] - est[:3, 3]))
    return rre, rte


# reference escalation ladder (model.py:564)
GT_THRESHOLDS = (0.06, 0.07, 0.08, 0.09, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)


def escalated_gt(nodes: np.ndarray, centers: np.ndarray, centers_valid: np.ndarray,
                 transform: np.ndarray, max_pairs: int,
                 thresholds=GT_THRESHOLDS, rre_limit=5.0, rte_limit=1.0):
    """Coarse binary GT via threshold escalation (reference model.py:564-597).

    For each threshold: all (node, valid patch-center) pairs within it
    (get_correspondences / KDTree_corr, utils.py:427-446); accept when >5
    pairs AND the Kabsch pose they imply is within RRE<5deg / RTE<1m of the
    GT transform; escalate otherwise. Returns padded (src, tgt, valid,
    not_val) where ``not_val`` flags a pair whose GT never validated.
    """
    from scipy.spatial import cKDTree

    src = np.zeros(max_pairs, np.int32)
    tgt = np.zeros(max_pairs, np.int32)
    val = np.zeros(max_pairs, bool)
    if not centers_valid.any() or len(nodes) == 0:
        return src, tgt, val, 1.0

    nodes_cam = nodes @ transform[:3, :3].T + transform[:3, 3]
    center_ids = np.nonzero(centers_valid)[0]
    tree = cKDTree(centers[center_ids])

    best = None
    not_val = 1.0
    for thr in thresholds:
        lists = tree.query_ball_point(nodes_cam, thr)
        pairs = [(ni, int(center_ids[j])) for ni, lst in enumerate(lists) for j in lst]
        if len(pairs) <= 5:
            continue
        best = pairs
        arr = np.asarray(pairs)
        r, t = _kabsch_np(nodes[arr[:, 0]], centers[arr[:, 1]])
        est = np.eye(4)
        est[:3, :3], est[:3, 3] = r, t
        rre, rte = _isotropic_error_np(transform, est)
        if rre < rre_limit and rte < rte_limit:
            not_val = 0.0
            break
    if best is None:
        return src, tgt, val, 1.0

    n = min(len(best), max_pairs)
    for i in range(n):
        src[i], tgt[i] = best[i]
        val[i] = True
    return src, tgt, val, not_val


def fine_gt_correspondences(img_points: np.ndarray, img_valid: np.ndarray,
                            points: np.ndarray, transform: np.ndarray,
                            intrinsics: np.ndarray, hw: Tuple[int, int],
                            max_pairs: int,
                            matching_radius_3d: float = 0.0375,
                            matching_radius_2d: float = 8.0,
                            rng: Optional[np.random.RandomState] = None):
    """Fine GT pixel<->point pairs: mutual 3D NN filtered by both radii
    (vision3d get_2d3d_correspondences_mutual, array_ops/
    registration_utils.py:30-61). Returns padded ((v,u) int32 pixels,
    point indices, valid)."""
    from scipy.spatial import cKDTree

    h, w = hw
    pixels = np.zeros((max_pairs, 2), np.int32)
    pcd_idx = np.zeros(max_pairs, np.int32)
    val = np.zeros(max_pairs, bool)
    if not img_valid.any() or len(points) == 0:
        return pixels, pcd_idx, val

    img_ids = np.nonzero(img_valid)[0]
    ipts = img_points[img_ids]
    ppts = points @ transform[:3, :3].T + transform[:3, 3]

    ti, tp = cKDTree(ipts), cKDTree(ppts)
    _, i2p = tp.query(ipts, k=1)
    _, p2i = ti.query(ppts, k=1)
    mutual = p2i[i2p] == np.arange(len(ipts))

    ic = np.nonzero(mutual)[0]
    pc = i2p[ic]
    d3 = np.linalg.norm(ipts[ic] - ppts[pc], axis=-1)
    pix = np.stack([img_ids[ic] // w, img_ids[ic] % w], -1)
    rend = _render_np(ppts[pc], intrinsics)
    d2 = np.linalg.norm(pix - rend, axis=-1)
    ok = (d3 < matching_radius_3d) & (d2 < matching_radius_2d)
    ic, pc = ic[ok], pc[ok]

    n = len(ic)
    if n > max_pairs:
        sel = (rng.permutation(n) if rng is not None else np.arange(n))[:max_pairs]
        ic, pc = ic[sel], pc[sel]
        n = max_pairs
    pixels[:n, 0] = img_ids[ic] // w
    pixels[:n, 1] = img_ids[ic] % w
    pcd_idx[:n] = pc
    val[:n] = True
    return pixels, pcd_idx, val


def build_2d3d_sample(raw: dict, spec: Spec2D3D, coarse_stride: int = 8) -> dict:
    """One raw dataset dict -> padded arrays for Batch2D3D."""
    points = raw["points"]
    depth = raw["depth"]
    intrinsics = raw["intrinsics"]
    transform = raw["transform"]
    h, w = depth.shape
    assert h % coarse_stride == 0 and w % coarse_stride == 0, \
        f"crop {h}x{w} must divide stride {coarse_stride}"

    img_points, img_valid = _back_project_np(depth, intrinsics)

    # --- cloud pyramid (3 levels) ---
    levels = [points]
    r = spec.init_radius
    radii = [r]
    for _ in range(2):
        dl = 2 * r / 2.5
        levels.append(grid_subsample_native(levels[-1], dl))
        r *= 2
        radii.append(r)

    pts_l, masks_l, neigh_l, pools_l, ups_l = [], [], [], [], []
    for l in range(3):
        n_real = len(levels[l])
        cap = spec.n_points[l]
        if n_real > cap:
            raise ValueError(f"2d3d bucket too small at level {l}: {n_real} > {cap}")
        pts_l.append(pad_to(levels[l].astype(np.float32), cap))
        masks_l.append(np.arange(cap) < n_real)
        idx = radius_neighbors_native(levels[l], levels[l], radii[l], spec.k_neighbors[l])
        idx = np.where(idx >= n_real, cap, idx)
        neigh_l.append(pad_to(idx, cap, fill=cap))
        if l < 2:
            pi = radius_neighbors_native(levels[l + 1], levels[l], radii[l], spec.k_pools[l])
            pi = np.where(pi >= n_real, spec.n_points[l], pi)
            pools_l.append(pad_to(pi, spec.n_points[l + 1], fill=spec.n_points[l]))
            ui = radius_neighbors_native(levels[l], levels[l + 1], 2 * radii[l],
                                         spec.k_upsamples[l])
            ui = np.where(ui >= len(levels[l + 1]), spec.n_points[l + 1], ui)
            ups_l.append(pad_to(ui, cap, fill=spec.n_points[l + 1]))

    # --- patch centers (real depth) for the escalated coarse GT ---
    # stride-2 pixel subset per patch like the reference patchify
    # (model.py patchify(..., stride=2)); the escalation compares nodes
    # against img_pcd_centers_c, which are means over that subset
    nodes = levels[2]
    hc, wc = h // coarse_stride, w // coarse_stride
    centers = img_points.reshape(hc, coarse_stride, wc, coarse_stride, 3)[:, ::2, :, ::2]
    val = img_valid.reshape(hc, coarse_stride, wc, coarse_stride)[:, ::2, :, ::2]
    cnt = np.maximum(val.sum((1, 3)), 1)[..., None]
    centers = (centers * val[..., None]).sum((1, 3)) / cnt
    centers = centers.reshape(hc * wc, 3)
    centers_valid = val.any((1, 3)).reshape(hc * wc)

    # coarse binary GT: threshold escalation validated by Kabsch RRE/RTE
    # (reference model.py:564-597)
    gt_src, gt_tgt, gt_val, not_val = escalated_gt(
        nodes, centers, centers_valid, transform, spec.n_gt)

    # coarse overlap-ratio GT for the circle loss (utils.py:59-173)
    ov_src, ov_tgt, ov_min, ov_max, ov_valid = node_patch_overlaps(
        levels[0], nodes, img_points, img_valid, transform, intrinsics,
        (h, w), coarse_stride,
        matching_radius_3d=spec.matching_radius_3d,
        matching_radius_2d=spec.matching_radius_2d,
        num_points_in_patch=spec.num_points_in_patch,
        max_pairs=spec.n_overlap)

    # fine GT pixel<->point pairs for the fine circle loss
    fine_pixels, fine_pcd_idx, fine_valid = fine_gt_correspondences(
        img_points, img_valid, levels[0], transform, intrinsics, (h, w),
        spec.n_fine_gt,
        matching_radius_3d=spec.matching_radius_3d,
        matching_radius_2d=spec.matching_radius_2d)

    feats = pad_to(raw["feats"].astype(np.float32), spec.n_points[0])

    return {
        "image": raw["image_gray"][..., None].astype(np.float32),
        "img_points": img_points,
        "img_valid": img_valid,
        "points": tuple(pts_l),
        "masks": tuple(masks_l),
        "neighbors": tuple(neigh_l),
        "pools": tuple(pools_l),
        "upsamples": tuple(ups_l),
        "pcd_feats": feats,
        "transform": transform.astype(np.float32),
        "intrinsics": intrinsics.astype(np.float32),
        "gt_src": gt_src,
        "gt_tgt": gt_tgt,
        "gt_valid": gt_val,
        "gt_not_val": np.float32(not_val),
        "ov_src": ov_src,
        "ov_tgt": ov_tgt,
        "ov_min": ov_min,
        "ov_max": ov_max,
        "ov_valid": ov_valid,
        "fine_pixels": fine_pixels,
        "fine_pcd_idx": fine_pcd_idx,
        "fine_valid": fine_valid,
    }


def batch_2d3d(samples: Sequence[dict]):
    """Stack ``build_2d3d_sample`` dicts into a ``Batch2D3D`` of CPU tensors."""
    from ..models.pipeline_2d3d import Batch2D3D

    return Batch2D3D.from_numpy(stack_pairs(list(samples)))
