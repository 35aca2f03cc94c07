"""2D-3D benchmark tester: PIR / PMR / IR / OR / FMR / RR (RMSE) / RRE / RTE.

Counterpart of the JAX package's engine/tester2d3d.py (the reference's
test.py and eval.py), in two stages:

  * ``TwoDThreeDTester.test``: the model's forward (``ddim`` from a start
    drawn with the tester's generator, or ``backbone``), coarse
    correspondences from its mask, then per pair fine matching, IR and the
    device PnP-RANSAC (draws from the same generator); when ``cache_dir`` is
    given each pair's predictions go to ``cache_dir/<scene>/<idx>.npz``;
  * ``eval_from_cache``: re-scores the cache with the reference's metric
    table, per scene and as means of the scene means.

Each draw is one method (``draw_start``, ``draw_pnp``; ``eval_from_cache``
takes ``draw_pnp``), in the order the JAX tester splits its keys. The host
estimator (``pnp_backend: opencv``) is not ported: without cv2 the device
PnP runs instead, with a warning; with cv2 the config is refused
(``eval/host_estimators.py``). In a process group the model's forward goes
through ``parallel.mesh.make_parallel_eval_step``, as in ``engine.tester``.
"""
from __future__ import annotations

import dataclasses
import glob
import os
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..eval.host_estimators import resolve_backend
from ..eval.pnp import pnp_ransac
from ..geometry.se3 import rotation_error_deg, translation_error
from ..models.pipeline_2d3d import fine_matching, patch_pixel_table
from ..ops.select import extract_correspondences
from ..ops.vision import create_meshgrid
from ..parallel.mesh import make_parallel_eval_step
from ..utils.device import resolve_device
from ..utils.logging import Logger, SummaryBoard


@dataclasses.dataclass
class Test2D3DConfig:
    acceptance_radius: float = 0.05
    ir_threshold: float = 0.1       # FMR threshold on IR
    rmse_threshold: float = 0.1     # RR threshold
    pnp_tolerance_px: float = 8.0
    pnp_hypotheses: int = 8192
    max_fine_corr: int = 2048
    acceptance_overlap: float = 0.3  # PIR GT: overlap pairs with min overlap above it
    pnp_backend: str = "device"
    fine_topk: int = 2
    fine_threshold: float = 0.75


PMR_TIERS = (0.0, 0.1, 0.3, 0.5)


def patch_inlier_ratio(corr_mask, gt_src, gt_tgt, gt_valid):
    """PIR: the share of predicted node <-> patch correspondences (mask
    [N, M]) that are in the GT set (padded index lists)."""
    n, m = corr_mask.shape
    gt = torch.zeros(n * m + 1, dtype=torch.bool, device=corr_mask.device)
    flat = torch.where(gt_valid, gt_src.long() * m + gt_tgt.long(),
                       torch.full_like(gt_src, n * m, dtype=torch.long))
    gt[flat] = True
    hits = (corr_mask & gt[:n * m].reshape(n, m)).sum()
    return hits / corr_mask.sum().clamp_min(1)


def correspondence_inlier_ratio(pcd_corr_points, img_corr_points, corr_valid, transform,
                                radius):
    """IR: the share of fine correspondences whose cloud point, under the GT
    camera-from-cloud transform, lies within ``radius`` of its image point;
    and the number of correspondences."""
    cam = pcd_corr_points @ transform[:3, :3].T + transform[:3, 3]
    inl = (torch.linalg.norm(cam - img_corr_points, dim=-1) < radius) & corr_valid
    return inl.sum() / corr_valid.sum().clamp_min(1), corr_valid.sum()


def correspondence_overlap_np(pcd_corr_points, img_corr_points, transform, radius):
    """OR: the share of transformed cloud points with an image point within
    ``radius``."""
    if len(pcd_corr_points) == 0:
        return 0.0
    from scipy.spatial import cKDTree

    cam = pcd_corr_points @ transform[:3, :3].T + transform[:3, 3]
    d, _ = cKDTree(img_corr_points).query(cam, k=1)
    return float((d < radius).mean())


def registration_rmse(pcd_points, valid, est_rot, est_trn, transform):
    """RMSE between the estimated and GT camera-frame positions of the cloud."""
    est = pcd_points @ est_rot.T + est_trn.reshape(1, 3)
    gt = pcd_points @ transform[:3, :3].T + transform[:3, 3]
    d2 = torch.sum((est - gt) ** 2, dim=-1)
    return torch.sqrt(torch.where(valid, d2, torch.zeros_like(d2)).sum()
                      / valid.sum().clamp_min(1))


def _scene_of(meta_entry) -> str:
    if isinstance(meta_entry, str):
        return meta_entry
    if isinstance(meta_entry, dict):
        return str(meta_entry.get("scene_name", "scene"))
    return "scene"


class TwoDThreeDTester:
    """A ``DiffReg2D3D`` (which holds its weights) tested on ``device``
    (default "cuda"; raises when CUDA is missing)."""

    def __init__(self, model, cfg: Test2D3DConfig = Test2D3DConfig(),
                 logger: Optional[Logger] = None, mode: str = "ddim", device=None):
        self.device = resolve_device(device)
        self.logger = logger or Logger(None)
        self.model = model
        self.cfg = dataclasses.replace(
            cfg, pnp_backend=resolve_backend(cfg.pnp_backend, self.logger))
        self.mode = mode
        self._tables = {}

    def draw_start(self, batch, node_count: int, patch_count: int, generator):
        """The DDIM start [B, N, M], N(0, 1)."""
        return torch.randn((batch.batch_size, node_count, patch_count), generator=generator,
                           device=self.device)

    def draw_pnp(self, batch, generator):
        """Each pair's PnP hypothesis draws [B, H, 6], U[0, 1)."""
        return torch.rand((batch.batch_size, self.cfg.pnp_hypotheses, 6), generator=generator,
                          device=self.device)

    def _pixel_tables(self, h, w, stride):
        key = (h, w, stride)
        if key not in self._tables:
            table = torch.from_numpy(patch_pixel_table(h, w, stride)).to(self.device)
            pix = create_meshgrid(h, w, flatten=True, device=self.device).flip(-1)  # (u, v)
            self._tables[key] = (table, pix.contiguous())
        return self._tables[key]

    def forward(self, batch, generator):
        """The model's output, the coarse correspondences, and per pair the
        fine matches, IR, correspondence count and PnP pose."""
        cfg = self.cfg
        model = self.model
        x_init = None
        if self.mode == "ddim":
            n = batch.points[-1].shape[1]
            m = (batch.image.shape[1] // model.cfg.coarse_stride) \
                * (batch.image.shape[2] // model.cfg.coarse_stride)
            x_init = self.draw_start(batch, n, m, generator)
        out = make_parallel_eval_step(model, self.mode)(batch, x_init=x_init)
        corrs = extract_correspondences(out["corr_mask"], out["conf_matrix_pred"],
                                        cfg.max_fine_corr // 4)
        u = self.draw_pnp(batch, generator)
        b, h, w, _ = batch.image.shape
        table, pix = self._pixel_tables(h, w, model.cfg.coarse_stride)
        part = out["partition"]
        pairs = []
        for i in range(b):
            fm = fine_matching(out["img_feats_f"][i], batch.img_points[i], pix,
                               out["pcd_feats_f"][i], batch.points[0][i], corrs.src_idx[i],
                               corrs.tgt_idx[i], corrs.valid[i], part.node_knn_indices[i],
                               part.node_knn_masks[i], table, cfg.max_fine_corr,
                               topk=cfg.fine_topk, threshold=cfg.fine_threshold)
            ir, n_corr = correspondence_inlier_ratio(fm["pcd_corr_points"],
                                                     fm["img_corr_points"], fm["corr_valid"],
                                                     batch.transform[i], cfg.acceptance_radius)
            res = pnp_ransac(u[i], fm["pcd_corr_points"], fm["img_corr_pixels"],
                             fm["corr_valid"], batch.intrinsics[i],
                             distance_tolerance=cfg.pnp_tolerance_px)
            pairs.append({"fm": fm, "IR": ir, "n_corr": n_corr, "rotation": res.rotation,
                          "translation": res.translation})
        return out, corrs, pairs

    def pair_row(self, batch, out, pair, i) -> dict:
        """One pair's metrics: IR, PIR (against the overlap GT above
        ``acceptance_overlap``, or the escalated GT without overlaps), RMSE,
        RR, RRE, RTE and the correspondence count."""
        cfg = self.cfg
        rot, trn = pair["rotation"], pair["translation"]
        tfm = batch.transform[i]
        rmse = registration_rmse(batch.points[0][i], batch.masks[0][i], rot, trn, tfm)
        if batch.ov_valid is not None:
            pir = patch_inlier_ratio(out["corr_mask"][i], batch.ov_src[i], batch.ov_tgt[i],
                                     batch.ov_valid[i] & (batch.ov_min[i] > cfg.acceptance_overlap))
        else:
            pir = patch_inlier_ratio(out["corr_mask"][i], batch.gt_src[i], batch.gt_tgt[i],
                                     batch.gt_valid[i])
        return {"IR": float(pair["IR"]), "PIR": float(pir), "RMSE": float(rmse),
                "RR": float(rmse < cfg.rmse_threshold),
                "RRE": float(rotation_error_deg(rot, tfm[:3, :3])),
                "RTE": float(translation_error(trn[:, 0], tfm[:3, 3])),
                "n_corr": float(pair["n_corr"])}

    def test(self, make_iter: Callable[[], Iterable], generator: Optional[torch.Generator] = None,
             cache_dir: Optional[str] = None) -> dict:
        """Draws come from ``generator`` (on the tester's device; default seed 0)."""
        cfg = self.cfg
        generator = generator or torch.Generator(self.device).manual_seed(0)
        board = SummaryBoard()
        irs, pirs = [], []
        pair_idx = 0
        for batch, meta in make_iter():
            batch = batch.to(self.device)
            out, corrs, pairs = self.forward(batch, generator)
            for i, pair in enumerate(pairs):
                row = self.pair_row(batch, out, pair, i)
                irs.append(row["IR"])
                pirs.append(row["PIR"])
                board.update(row)
                if cache_dir is not None:
                    self._write_cache(cache_dir, _scene_of(meta[i] if meta else None), pair_idx,
                                      batch, out, pair["fm"], i)
                pair_idx += 1
        irs, pirs = np.asarray(irs), np.asarray(pirs)
        summary = board.summary()
        summary["FMR"] = float((irs > cfg.ir_threshold).mean()) if len(irs) else 0.0
        for tier in PMR_TIERS:
            key = "PMR>0" if tier == 0.0 else f"PMR>={tier}"
            summary[key] = float((pirs > tier).mean() if tier == 0.0
                                 else (pirs >= tier).mean()) if len(pirs) else 0.0
        summary["pairs"] = len(irs)
        self.logger.info(f"2D-3D test: {summary}")
        return summary

    def _write_cache(self, cache_dir, scene, pair_idx, batch, out, fm, i):
        """One pair's npz prediction cache: the predictions, the overlap GT
        pairs with their min overlaps (or the escalated GT, with overlap 1)."""
        os.makedirs(os.path.join(cache_dir, scene), exist_ok=True)
        np_ = lambda t: t.detach().cpu().numpy()  # noqa: E731
        val = np_(fm["corr_valid"])
        cmask = np_(out["corr_mask"][i])
        pred_src, pred_tgt = np.nonzero(cmask)
        if batch.ov_valid is not None:
            keep = np_(batch.ov_valid[i])
            gt_src, gt_tgt = np_(batch.ov_src[i])[keep], np_(batch.ov_tgt[i])[keep]
            gt_min_ov = np_(batch.ov_min[i])[keep]
        else:
            keep = np_(batch.gt_valid[i])
            gt_src, gt_tgt = np_(batch.gt_src[i])[keep], np_(batch.gt_tgt[i])[keep]
            gt_min_ov = np.ones(len(gt_src), np.float32)
        np.savez_compressed(
            os.path.join(cache_dir, scene, f"{pair_idx:06d}.npz"),
            pcd_points=np_(batch.points[0][i])[np_(batch.masks[0][i])],
            img_corr_points=np_(fm["img_corr_points"])[val],
            pcd_corr_points=np_(fm["pcd_corr_points"])[val],
            img_corr_pixels=np_(fm["img_corr_pixels"])[val],
            corr_scores=np_(fm["corr_scores"])[val],
            pcd_num_nodes=cmask.shape[0], img_num_nodes=cmask.shape[1],
            pcd_node_corr_indices=pred_src, img_node_corr_indices=pred_tgt,
            gt_pcd_node_corr_indices=gt_src, gt_img_node_corr_indices=gt_tgt,
            gt_node_corr_min_overlaps=gt_min_ov,
            transform=np_(batch.transform[i]), intrinsics=np_(batch.intrinsics[i]))


def draw_pnp_eval(generator, cfg: Test2D3DConfig, device):
    """One cached pair's PnP hypothesis draws [H, 6], U[0, 1) (eval_from_cache)."""
    return torch.rand((cfg.pnp_hypotheses, 6), generator=generator, device=device)


def eval_from_cache(cache_dir: str, cfg: Test2D3DConfig = Test2D3DConfig(),
                    logger: Optional[Logger] = None, num_corr: Optional[int] = None,
                    generator: Optional[torch.Generator] = None, device=None) -> dict:
    """The reference eval.py on the npz cache: per-scene PIR and PMR tiers,
    IR, OR, FMR, RR (device PnP on the cached correspondences, best
    ``max_fine_corr`` by score), mean and median RRE / RTE of the registered
    pairs; overall means of the scene means, and ``scenes``."""
    device = resolve_device(device)
    logger = logger or Logger(None)
    cfg = dataclasses.replace(cfg, pnp_backend=resolve_backend(cfg.pnp_backend, logger))
    generator = generator or torch.Generator(device).manual_seed(0)
    scene_rows = {}
    overall = SummaryBoard()
    for scene_dir in sorted(d for d in glob.glob(os.path.join(cache_dir, "*"))
                            if os.path.isdir(d)):
        scene = os.path.basename(scene_dir)
        sb = SummaryBoard()
        rres, rtes = [], []
        for fname in sorted(glob.glob(os.path.join(scene_dir, "*.npz"))):
            d = np.load(fname)
            gt_src, gt_tgt = d["gt_pcd_node_corr_indices"], d["gt_img_node_corr_indices"]
            if "gt_node_corr_min_overlaps" in d:
                keep = d["gt_node_corr_min_overlaps"] > cfg.acceptance_overlap
                gt_src, gt_tgt = gt_src[keep], gt_tgt[keep]
            pir = _sparse_precision(int(d["pcd_num_nodes"]), int(d["img_num_nodes"]),
                                    d["pcd_node_corr_indices"], d["img_node_corr_indices"],
                                    gt_src, gt_tgt)
            sb.update({"PIR": pir})
            for tier in PMR_TIERS:
                key = "PMR>0" if tier == 0.0 else f"PMR>={tier}"
                sb.update({key: float(pir > tier if tier == 0.0 else pir >= tier)})

            pcd_c, img_c, pix_c = d["pcd_corr_points"], d["img_corr_points"], d["img_corr_pixels"]
            scores = d["corr_scores"]
            if num_corr is not None and len(scores) > num_corr:
                sel = np.argsort(-scores)[:num_corr]
                pcd_c, img_c, pix_c, scores = pcd_c[sel], img_c[sel], pix_c[sel], scores[sel]
            tfm = d["transform"]
            if len(pcd_c) > 0:
                cam = pcd_c @ tfm[:3, :3].T + tfm[:3, 3]
                ir = float((np.linalg.norm(cam - img_c, axis=-1) < cfg.acceptance_radius).mean())
                ov = correspondence_overlap_np(pcd_c, img_c, tfm, cfg.acceptance_radius)
            else:
                ir, ov = 0.0, 0.0
            sb.update({"IR": ir, "OR": ov, "FMR": float(ir >= cfg.ir_threshold)})

            rr = 0.0
            if len(pcd_c) >= 4:
                buf = cfg.max_fine_corr
                p3 = np.zeros((buf, 3), np.float32)
                px = np.zeros((buf, 2), np.float32)
                vv = np.zeros(buf, bool)
                n = min(len(pcd_c), buf)
                order = np.argsort(-scores)[:n]
                p3[:n], px[:n], vv[:n] = pcd_c[order], pix_c[order], True
                t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
                res = pnp_ransac(draw_pnp_eval(generator, cfg, device), t(p3), t(px), t(vv),
                                 t(d["intrinsics"]), distance_tolerance=cfg.pnp_tolerance_px)
                rot = res.rotation.cpu().numpy()
                trn = res.translation.cpu().numpy()
                pts = d["pcd_points"]
                est = pts @ rot.T + trn.reshape(1, 3)
                gt = pts @ tfm[:3, :3].T + tfm[:3, 3]
                rmse = float(np.sqrt(np.mean(np.sum((est - gt) ** 2, -1))))
                rr = float(rmse < cfg.rmse_threshold)
                if rr > 0:
                    rres.append(float(rotation_error_deg(torch.from_numpy(rot),
                                                         torch.from_numpy(tfm[:3, :3]))))
                    rtes.append(float(translation_error(torch.from_numpy(trn[:, 0]),
                                                        torch.from_numpy(tfm[:3, 3]))))
            sb.update({"RR": rr})
        row = sb.summary()
        if rres:
            row.update(RRE=float(np.mean(rres)), RTE=float(np.mean(rtes)),
                       median_RRE=float(np.median(rres)), median_RTE=float(np.median(rtes)))
        scene_rows[scene] = row
        overall.update(row)
        logger.info(f"scene {scene}: " + ", ".join(f"{k}={v:.4f}" for k, v in row.items()))
    summary = overall.summary()
    logger.info("2D-3D eval (means of scene means): "
                + ", ".join(f"{k}={v:.4f}" for k, v in summary.items()))
    summary["scenes"] = scene_rows
    return summary


def _sparse_precision(n, m, src, tgt, gt_src, gt_tgt):
    """Precision of the predicted sparse correspondences against the GT set."""
    gt = np.zeros((n, m), bool)
    gt[gt_src, gt_tgt] = True
    pred = np.zeros((n, m), bool)
    pred[src, tgt] = True
    return float((gt & pred).sum() / max(pred.sum(), 1))
