"""Point-to-node partition, kNN interpolation over a table, batched mutual top-k.

Counterpart of the JAX package's ops/partition.py, batched over a leading
pair axis. The partition runs one pair at a time, so that one [N, M]
distance table (about 160 MB at 40k points and 1k nodes) is live at once.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .kpconv import _gather_rows
from .masked import NEG_INF
from .topk import stable_top_k, top_k
from .vision import pairwise_distance


class Partition(NamedTuple):
    point_to_node: torch.Tensor     # [B, N] int64 node of each point (-1 invalid)
    node_sizes: torch.Tensor        # [B, M] int64
    node_masks: torch.Tensor        # [B, M] bool (node valid and has >= 1 point)
    node_knn_indices: torch.Tensor  # [B, M, K] int64 member points (sentinel N)
    node_knn_masks: torch.Tensor    # [B, M, K] bool


def _partition_one(points, nodes, point_valid, node_valid, k):
    n, m = points.shape[0], nodes.shape[0]
    # nearest node of each point, from the a^2 - 2ab + b^2 table as the JAX
    # package forms it (a different form moves near-ties between nodes)
    d2 = pairwise_distance(points, nodes)
    d2 = torch.where(node_valid[None, :], d2, torch.full_like(d2, float("inf")))
    p2n = torch.argmin(d2, dim=1)
    del d2
    p2n = torch.where(point_valid, p2n, torch.full_like(p2n, -1))
    sizes = torch.bincount(p2n + 1, minlength=m + 1)[1:]
    node_masks = (sizes > 0) & node_valid

    # each node's k nearest members, from the node-major table
    nd2 = pairwise_distance(nodes, points)
    member = (p2n[None, :] == torch.arange(m, device=p2n.device)[:, None]) & point_valid[None, :]
    nd2 = torch.where(member, nd2, torch.full_like(nd2, float("inf")))
    del member
    neg, idx = stable_top_k(-nd2, k)
    knn_masks = torch.isfinite(neg)
    knn_indices = torch.where(knn_masks, idx, torch.full_like(idx, n))
    return p2n, sizes, node_masks, knn_indices, knn_masks


def point_to_node_partition(points, nodes, point_valid, node_valid, k: int) -> Partition:
    """Assign each point [B, N, 3] to its nearest valid node [B, M, 3]; gather
    each node's k nearest member points (vision3d point_cloud_partition)."""
    parts = [_partition_one(points[i], nodes[i], point_valid[i], node_valid[i], k)
             for i in range(points.shape[0])]
    return Partition(*(torch.stack(t) for t in zip(*parts)))


def knn_interpolate_from_table(q_pts, s_pts, s_feats, table, eps=1e-8):
    """Inverse-squared-distance interpolation over a neighbour table (vision3d
    knn_interpolate_pack_mode): w = mask / (d^2 + eps), normalised with + eps,
    over every entry of the table. q_pts [B, Nq, 3], s_pts [B, Ns, 3], s_feats
    [B, Ns, C], table [B, Nq, K] with sentinel >= Ns -> [B, Nq, C]."""
    ns = s_pts.shape[1]
    safe = table.clamp_max(ns - 1)
    knn_pts = _gather_rows(s_pts, safe)
    knn_feats = _gather_rows(s_feats, safe)
    d2 = torch.sum((q_pts[:, :, None, :] - knn_pts) ** 2, dim=-1)
    w = (table < ns).to(s_feats.dtype) / (d2 + eps)
    w = w / (torch.sum(w, dim=2, keepdim=True) + eps)
    return torch.sum(knn_feats * w[..., None], dim=2)


def batch_mutual_topk_select(score_mat, k, valid_row=None, valid_col=None, threshold=None,
                             largest=True, mutual=True):
    """Mutual (or union) top-k of score_mat [..., N, M] over valid rows and
    columns, optionally thresholded -> bool mask [..., N, M]."""
    s = score_mat if largest else -score_mat
    neg = torch.full_like(s, NEG_INF)
    if valid_row is not None:
        s = torch.where(valid_row[..., :, None], s, neg)
    if valid_col is not None:
        s = torch.where(valid_col[..., None, :], s, neg)
    row_kth = top_k(s, k)[0][..., -1:]
    col_kth = top_k(s.transpose(-1, -2), k)[0][..., -1:].transpose(-1, -2)
    row_in, col_in = s >= row_kth, s >= col_kth
    corr = (row_in & col_in) if mutual else (row_in | col_in)
    if threshold is not None:
        corr = corr & ((score_mat > threshold) if largest else (score_mat < threshold))
    if valid_row is not None:
        corr = corr & valid_row[..., :, None]
    if valid_col is not None:
        corr = corr & valid_col[..., None, :]
    return corr
