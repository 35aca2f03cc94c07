"""Match selection: top-k masks and fixed-size correspondence lists (batched)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.draws import as_draws
from .masked import NEG_INF
from .topk import stable_top_k, top_k


class Correspondences(NamedTuple):
    src_idx: torch.Tensor  # [B, K] int64
    tgt_idx: torch.Tensor  # [B, K] int64
    scores: torch.Tensor   # [B, K]
    valid: torch.Tensor    # [B, K] bool


def mutual_topk_mask(score_mat, k, largest=True, threshold=None, mutual=True):
    """Entries of score_mat [B, N, M] in the row top-k and/or the column top-k,
    optionally thresholded (reference mutual_topk_select, reduce_result=False)."""
    s = score_mat if largest else -score_mat
    row_kth = top_k(s, k)[0][..., -1:]                              # [B, N, 1]
    col_kth = top_k(s.transpose(1, 2), k)[0][..., -1:].transpose(1, 2)  # [B, 1, M]
    row_in = s >= row_kth
    col_in = s >= col_kth
    corr = (row_in & col_in) if mutual else (row_in | col_in)
    if threshold is not None:
        corr = corr & ((score_mat > threshold) if largest else (score_mat < threshold))
    return corr


def extract_correspondences(corr_mat, score_mat, max_corr):
    """Boolean [B, N, M] correspondences -> fixed-size lists in decreasing score
    order; slots beyond the selected entries have valid=False."""
    b, _, m = score_mat.shape
    masked = torch.where(corr_mat, score_mat, torch.full_like(score_mat, NEG_INF))
    scores, idx = top_k(masked.reshape(b, -1), max_corr)
    valid = torch.gather(corr_mat.reshape(b, -1), 1, idx)
    return Correspondences(idx // m, idx % m,
                           torch.where(valid, scores, torch.zeros_like(scores)), valid)


def mutual_topk_correspondences(score_mat, k, max_corr, largest=True, threshold=None,
                                mutual=True):
    """``mutual_topk_mask`` of score_mat [B, N, M] as a fixed-size list of at
    most ``max_corr`` correspondences (``extract_correspondences``)."""
    corr = mutual_topk_mask(score_mat, k, largest, threshold, mutual)
    return extract_correspondences(corr, score_mat, max_corr)


def thresholded_mutual_argmax_mask(conf_matrix, thr=0.0, mutual=True):
    """Reference ``Matching.get_match``: conf > thr, and optionally the row
    argmax and the column argmax. conf_matrix [B, N, M]."""
    mask = conf_matrix > thr
    if mutual:
        row_max = conf_matrix.amax(dim=2, keepdim=True)
        col_max = conf_matrix.amax(dim=1, keepdim=True)
        mask = mask & (conf_matrix == row_max) & (conf_matrix == col_max)
    return mask


def superpoint_proposals(src_idx, tgt_idx, overlaps, valid, num_proposals, rng,
                         overlap_threshold=0.3, decay_step=0.05, probabilistic=False):
    """Ground-truth superpoint proposals (vision3d SuperPointProposalGenerator):
    the overlap threshold decays by ``decay_step`` until a candidate passes
    it (strictly), then ``num_proposals`` candidates are drawn without
    replacement (Gumbel top-k), uniformly or, with ``probabilistic``, by
    overlap. src_idx, tgt_idx, overlaps, valid [N]; ``rng``: a
    ``torch.Generator`` on their device or a draw source (``utils/draws.py``),
    drawn once, as JAX draws its key. Returns (src [P], tgt [P], overlaps [P],
    valid [P])."""
    inf = torch.tensor(float("inf"), dtype=overlaps.dtype, device=overlaps.device)
    ov = torch.where(valid, overlaps, -inf)
    max_ov = ov.max()
    k = torch.where(max_ov > overlap_threshold, torch.zeros_like(max_ov),
                    torch.floor((overlap_threshold - max_ov) / decay_step) + 1.0)
    mask = ov > overlap_threshold - k * decay_step
    if probabilistic:
        logw = torch.where(mask, torch.log(ov.clamp_min(1e-12)), -inf)
    else:
        logw = torch.where(mask, torch.zeros_like(ov), -inf)
    scores = logw + as_draws(rng).gumbel(logw.shape, logw.dtype)
    _, sel = stable_top_k(scores, num_proposals)
    return src_idx[sel], tgt_idx[sel], overlaps[sel], mask[sel]
