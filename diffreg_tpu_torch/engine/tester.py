"""Benchmark testers: 3DMatch (IR / FMR / RR) and 4DMatch (IR / NFMR).

Counterpart of the JAX package's engine/tester.py (the reference testers,
Diff-Reg-3dmatch/lib/tester.py:9-124 and Diff-Reg-4dmatch/lib/tester.py:
212-285), built on ``engine.trainer.BatchTester``, with the per-pair metrics
on the device:

  * forward: ``ddim_sample`` from a DDIM start (and, for 4DMatch, the DDIM
    noise) drawn from the tester's ``torch.Generator``;
  * 3DMatch: IR over every extracted match, then device RANSAC on the
    score-ordered correspondence buffer and the covariance recall criterion;
    the reference's 3 repeats re-run only the pose estimation, with fresh
    RANSAC draws from the same generator;
  * 4DMatch: matches by thr-mutual extraction from the sigmoid prediction, IR
    with the source deformed by the GT coarse flow, and NFMR when a
    ``metric_points_fn`` gives a pair's raw metric points and flow.

Each draw is one method (``draw_start``, ``draw_noise``, ``draw_ransac``), in
the order the JAX testers split their keys. The host pose estimators
(``eval/host_estimators.py``) are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..eval.metrics import inlier_ratio, masked_inlier_ratio, nfmr, registration_recall_success
from ..eval.ransac import ransac_pose
from ..ops.select import extract_correspondences, thresholded_mutual_argmax_mask
from ..utils.logging import Logger
from .trainer import BatchTester


@dataclasses.dataclass
class TestConfig:
    inlier_thr: float = 0.1          # 3DMatch (lib/tester.py:83); 4DMatch: 0.04
    fmr_thr: float = 0.05
    registration_thr: float = 0.2    # RR threshold (m)
    ransac_distance_thr: float = 0.05
    ransac_hypotheses: int = 65536   # the JAX package's default budget
    num_repeats: int = 3             # reference 3DMatch protocol (lib/tester.py:19-34)
    match_thr: float = 0.55          # 4DMatch get_match threshold
    max_corr: int = 1024
    nfmr_recall_thr: float = 0.04


def _rows(pts, idx):
    """pts [B, N, C] at idx [B, K] -> [B, K, C]."""
    return torch.gather(pts, 1, idx[..., None].expand(-1, -1, pts.shape[-1]))


def pair_metrics_3dmatch(out, batch, cfg: TestConfig, u):
    """Per-pair (IR, success, n_corr, rotation, translation) of a ``ddim_sample``
    output: IR over every match of ``corr_mask``, RANSAC (draws u [B, H, 3]) on
    the ``max_corr`` best correspondences, the covariance recall criterion."""
    s_pcd, t_pcd = out["s_pcd"], out["t_pcd"]
    ir = masked_inlier_ratio(out["corr_mask"], s_pcd, t_pcd, batch.rot_gt, batch.trn_gt,
                             inlier_thr=cfg.inlier_thr)
    corrs = extract_correspondences(out["corr_mask"], out["conf_matrix_pred"], cfg.max_corr)
    res = ransac_pose(u, _rows(s_pcd, corrs.src_idx), _rows(t_pcd, corrs.tgt_idx), corrs.valid,
                      distance_threshold=cfg.ransac_distance_thr)
    n_corr = corrs.valid.sum(dim=1)
    ok = registration_recall_success(res.rotation, res.translation, batch.rot_gt, batch.trn_gt,
                                     batch.gt_cov, thr=cfg.registration_thr) & (n_corr >= 3)
    return ir, ok.to(torch.float32), n_corr, res.rotation, res.translation


def match_mask_4dmatch(out, batch, cfg: TestConfig):
    """Reference get_match(thr, mutual=True) on the sigmoid prediction."""
    valid = batch.src_mask[:, :, None] & batch.tgt_mask[:, None, :]
    return thresholded_mutual_argmax_mask(out["conf_matrix_pred"], cfg.match_thr) & valid


def pair_metrics_4dmatch(out, batch, cfg: TestConfig):
    """Per-pair (IR, n_corr) of a 4DMatch ``ddim_sample`` output: the
    ``max_corr`` best thr-mutual matches, IR with the GT coarse flow."""
    mask = match_mask_4dmatch(out, batch, cfg)
    corrs = extract_correspondences(mask, out["conf_matrix_pred"], cfg.max_corr)
    ir = inlier_ratio(_rows(out["s_pcd"], corrs.src_idx), _rows(out["t_pcd"], corrs.tgt_idx),
                      corrs.valid, batch.rot_gt, batch.trn_gt, inlier_thr=cfg.inlier_thr,
                      coarse_flow_corr=_rows(batch.coarse_flow, corrs.src_idx))
    return ir, corrs.valid.sum(dim=1)


class _Tester(BatchTester):
    """A model (which holds its weights) tested on ``device`` (default "cuda";
    raises when CUDA is missing) with the device pose estimation."""

    def __init__(self, model, cfg: TestConfig = TestConfig(), logger: Optional[Logger] = None,
                 device=None):
        super().__init__(logger=logger, device=device)
        self.model = model
        self.cfg = cfg

    def draw_start(self, batch, generator: torch.Generator):
        """The DDIM start [B, S, T], N(0, 1)."""
        b, s = batch.src_mask.shape
        return torch.randn((b, s, batch.tgt_mask.shape[1]), generator=generator,
                           device=self.device)


class ThreeDMatchTester(_Tester):
    """IR / FMR / RR over a test loader (lib/tester.py:37-124)."""

    def draw_ransac(self, batch, generator: torch.Generator):
        """One repeat's RANSAC draws [B, H, 3], U[0, 1)."""
        return torch.rand((batch.batch_size, self.cfg.ransac_hypotheses, 3),
                          generator=generator, device=self.device)

    def forward(self, batch, generator: torch.Generator):
        """One ``ddim_sample`` per batch; the ``num_repeats`` averaging re-runs
        only the pose estimation. Returns each pair's IR and recall."""
        out = self.model.ddim_sample(batch, self.draw_start(batch, generator))
        oks = []
        for _ in range(self.cfg.num_repeats):       # IR does not depend on the draws
            ir, ok, _, _, _ = pair_metrics_3dmatch(out, batch, self.cfg,
                                                   self.draw_ransac(batch, generator))
            oks.append(ok)
        return {"IR": ir.tolist(), "RR": torch.stack(oks).mean(dim=0).tolist()}

    def eval_sample(self, i, batch, out, meta):
        ir = out["IR"][i]
        return {"IR": ir, "FMR": float(ir > self.cfg.fmr_thr), "RR": out["RR"][i]}

    def test(self, make_iter: Callable[[], Iterable], generator: Optional[torch.Generator] = None):
        """Draws come from ``generator`` (on the tester's device; default seed 0)."""
        rows = super().test(make_iter, generator)
        summary = {k: rows.get(k, 0.0) for k in ("IR", "FMR", "RR")}
        summary["pairs"] = rows["samples"]
        self.logger.info(f"3DMatch test: RR={summary['RR']:.4f} IR={summary['IR']:.4f} "
                         f"FMR={summary['FMR']:.4f} over {summary['pairs']} pairs")
        return summary


def make_metric_points_fn(max_points: int = 2048):
    """metric_points_fn for ``FourDMatchTester`` from raw sample dicts: the
    dataset's ``metric_index`` subset of the raw source cloud and its flow
    (4dmatch lib/tester.py:127-210), or a uniform subset when the entry has
    none. Returns padded (metric_pcd [M, 3], metric_flow [M, 3], valid [M]),
    or None when the entry has no raw cloud or flow."""

    def fn(meta: dict):
        src, flow = meta.get("src_pcd"), meta.get("scene_flow")
        if src is None or flow is None:
            return None
        idx = meta.get("metric_index")
        if idx is None:
            idx = np.linspace(0, len(src) - 1, min(len(src), max_points)).astype(np.int64)
        idx = np.asarray(idx)[:max_points]
        n = len(idx)
        pcd = np.zeros((max_points, 3), np.float32)
        fl = np.zeros((max_points, 3), np.float32)
        valid = np.zeros(max_points, bool)
        pcd[:n], fl[:n], valid[:n] = src[idx], flow[idx], True
        return pcd, fl, valid

    return fn


class FourDMatchTester(_Tester):
    """IR / NFMR for deformable pairs (4dmatch lib/tester.py:212-285)."""

    def __init__(self, model, cfg: TestConfig = TestConfig(inlier_thr=0.04),
                 logger: Optional[Logger] = None, device=None):
        super().__init__(model, cfg, logger, device)
        self.metric_points_fn = None

    def draw_noise(self, batch, generator: torch.Generator):
        """The stochastic DDIM term's draws [steps, B, S, T], N(0, 1)."""
        b, s = batch.src_mask.shape
        return torch.randn((self.model.cfg.sample_steps, b, s, batch.tgt_mask.shape[1]),
                           generator=generator, device=self.device)

    def forward(self, batch, generator: torch.Generator):
        """``ddim_sample`` from ``draw_start`` with ``draw_noise``, then each
        pair's IR and number of matches, and the thr-mutual match mask."""
        out = self.model.ddim_sample(batch, self.draw_start(batch, generator),
                                     ddim_noise=self.draw_noise(batch, generator))
        ir, n_corr = pair_metrics_4dmatch(out, batch, self.cfg)
        out.update(IR=ir.tolist(), matches=n_corr.tolist(),
                   match_mask=match_mask_4dmatch(out, batch, self.cfg))
        return out

    def eval_sample(self, i, batch, out, meta):
        row = {"IR": out["IR"][i], "matches": out["matches"][i]}
        mp = self.metric_points_fn(meta) if self.metric_points_fn is not None else None
        if mp is not None:
            row["NFMR"] = self.pair_nfmr(out, batch, out["match_mask"], i, mp)
        return row

    def test(self, make_iter: Callable[[], Iterable], generator: Optional[torch.Generator] = None,
             metric_points_fn=None):
        """Draws come from ``generator`` (on the tester's device; default seed
        0). ``metric_points_fn(meta)`` may return (metric_pcd, metric_flow,
        valid) per pair to enable NFMR (it needs the raw clouds). The summary
        holds IR, the mean matches per pair, pairs and, where measured, NFMR."""
        self.metric_points_fn = metric_points_fn
        rows = super().test(make_iter, generator)
        summary = {"IR": rows.get("IR", 0.0), "matches": rows.get("matches", 0.0),
                   "pairs": rows["samples"]}
        if "NFMR" in rows:
            summary["NFMR"] = rows["NFMR"]
        self.logger.info(f"4DMatch test: {summary}")
        return summary

    def nfmr_for_batch(self, out, batch, meta, metric_points_fn):
        """NFMR of each pair whose ``meta`` gives metric points."""
        mask = match_mask_4dmatch(out, batch, self.cfg)
        vals = []
        for i, m in enumerate(meta):
            mp = metric_points_fn(m)
            if mp is not None:
                vals.append(self.pair_nfmr(out, batch, mask, i, mp))
        return vals

    def pair_nfmr(self, out, batch, mask, i, metric_points):
        """NFMR of pair ``i`` on its (metric_pcd, metric_flow, valid); the
        anchors are its thr-mutual matches in ``mask`` (the ``max_corr`` most
        confident)."""
        rows, cols = np.nonzero(mask[i].cpu().numpy())
        conf = out["conf_matrix_pred"][i].cpu().numpy()
        s_pcd, t_pcd = out["s_pcd"][i].cpu().numpy(), out["t_pcd"][i].cpu().numpy()
        a = self.cfg.max_corr
        if len(rows) > a:
            order = np.argsort(-conf[rows, cols])[:a]
            rows, cols = rows[order], cols[order]
        n = len(rows)
        anchor_src = np.zeros((a, 3), np.float32)
        anchor_tgt = np.zeros((a, 3), np.float32)
        anchor_valid = np.zeros(a, bool)
        anchor_src[:n], anchor_tgt[:n], anchor_valid[:n] = s_pcd[rows], t_pcd[cols], True
        t = lambda x: torch.as_tensor(x, device=self.device)
        return float(nfmr(t(metric_points[0]), t(metric_points[1]), batch.rot_gt[i],
                          batch.trn_gt[i][:, 0], t(anchor_src), t(anchor_tgt), t(anchor_valid),
                          t(metric_points[2]), recall_thr=self.cfg.nfmr_recall_thr))
