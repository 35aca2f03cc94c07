"""Match selection: top-k masks and fixed-size correspondence lists (batched)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .masked import NEG_INF
from .topk import top_k


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


def thresholded_mutual_argmax_mask(conf_matrix, thr=0.0, mutual=True):
    """Reference ``Matching.get_match``: conf > thr, and optionally the row
    argmax and the column argmax. conf_matrix [B, N, M]."""
    mask = conf_matrix > thr
    if mutual:
        row_max = conf_matrix.amax(dim=2, keepdim=True)
        col_max = conf_matrix.amax(dim=1, keepdim=True)
        mask = mask & (conf_matrix == row_max) & (conf_matrix == col_max)
    return mask
