"""Weighted Kabsch / soft Procrustes — on the device, batched.

The reference solves the weighted Procrustes problem with a host float64
SVD every DDIM step. As in the JAX package, the port stays on the device:
Horn's quaternion method (a batched symmetric 4x4 eigh, accurate in f32 and
always det(R) = +1), a 3x3 eigvalsh for the condition number, and a
condition gate with an identity fallback instead of try/except.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.topk import stable_top_k


class ProcrustesResult(NamedTuple):
    rotation: torch.Tensor         # [B, 3, 3] raw solution
    translation: torch.Tensor      # [B, 3, 1]
    rotation_fwd: torch.Tensor     # [B, 3, 3] gated solution (identity if rejected)
    translation_fwd: torch.Tensor  # [B, 3, 1]
    condition: torch.Tensor        # [B] singular-value condition number
    solution_mask: torch.Tensor    # [B] bool, True where the solution is accepted


def quaternion_to_matrix(q):
    """Unit quaternion [..., 4] (scalar first) -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def _horn_rotation(b_mat):
    """Proper rotation maximizing tr(R^T B) (Davenport q-method)."""
    b11, b12, b13 = b_mat[..., 0, 0], b_mat[..., 0, 1], b_mat[..., 0, 2]
    b21, b22, b23 = b_mat[..., 1, 0], b_mat[..., 1, 1], b_mat[..., 1, 2]
    b31, b32, b33 = b_mat[..., 2, 0], b_mat[..., 2, 1], b_mat[..., 2, 2]
    k = torch.stack([
        b11 + b22 + b33, b23 - b32, b31 - b13, b12 - b21,
        b23 - b32, b11 - b22 - b33, b12 + b21, b31 + b13,
        b31 - b13, b12 + b21, b22 - b11 - b33, b23 + b32,
        b12 - b21, b31 + b13, b23 + b32, b33 - b11 - b22,
    ], dim=-1).reshape(b_mat.shape[:-2] + (4, 4))
    # torch's eigh raises on a non-finite matrix where JAX's returns NaN: solve
    # a harmless stand-in instead and give those entries a NaN rotation, which
    # soft_procrustes replaces by the identity
    finite = torch.isfinite(k).all(dim=-1).all(dim=-1)[..., None, None]
    stand_in = torch.diag(torch.arange(4, dtype=k.dtype, device=k.device))
    _, vecs = torch.linalg.eigh(torch.where(finite, k, stand_in))   # ascending eigenvalues
    q = vecs[..., :, -1]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    # this K convention yields R^T of the map y ~ R x; transpose back
    r = quaternion_to_matrix(q).transpose(-1, -2)
    return torch.where(finite, r, torch.full_like(r, float("nan")))


def weighted_kabsch(x, y, w, eps=1e-4):
    """Weighted rigid alignment x -> y. x, y [B, N, 3], w [B, N, 1] >= 0 ->
    (R [B, 3, 3], t [B, 3, 1], condition [B])."""
    w1 = torch.sum(torch.abs(w), dim=1, keepdim=True)
    wn = w / (w1 + eps)
    mean_x = torch.sum(wn * x, dim=1, keepdim=True)        # [B, 1, 3]
    mean_y = torch.sum(wn * y, dim=1, keepdim=True)
    sxy = (y - mean_y).transpose(1, 2) @ (wn * (x - mean_x))  # [B, 3, 3]
    r = _horn_rotation(sxy)
    # singular values of Sxy from eigvalsh(Sxy^T Sxy); a degenerate covariance
    # (smallest singular value 0) gives an infinite condition, which fails the gate
    gram = sxy.transpose(1, 2) @ sxy
    gram = torch.where(torch.isfinite(gram), gram, torch.zeros_like(gram))  # (see above)
    evals = torch.linalg.eigvalsh(gram)
    d = torch.sqrt(torch.clamp(evals, min=0.0))
    pos = d[:, 0] > 0.0
    condition = torch.where(pos, d[:, -1] / torch.where(pos, d[:, 0], torch.ones_like(d[:, 0])),
                            torch.full_like(d[:, 0], float("inf")))
    t = mean_y.transpose(1, 2) - r @ mean_x.transpose(1, 2)
    return r, t, condition


def soft_procrustes(conf_matrix, src_pcd, tgt_pcd, src_mask, tgt_mask, *,
                    sample_rate=1.0, max_condition_num=0.0, use_masked_lengths=False):
    """Pose from a soft matching matrix via top-confidence weighted Kabsch.

    Keeps the top ``sample_rate * max(len_src, len_tgt)`` confidences as
    correspondence weights (a static top-k of ``round(sample_rate * max(N, M))``
    with the weights past the per-pair budget zeroed), solves weighted Kabsch,
    replaces non-finite solutions by the identity, and gates the forward pose
    on ``condition < max_condition_num`` (a gate of 0 rejects every solution).
    """
    b, n, m = conf_matrix.shape
    k = int(max(1, round(sample_rate * max(n, m))))
    dtype = conf_matrix.dtype
    if use_masked_lengths:
        src_len = src_mask.sum(dim=1).to(dtype)
        tgt_len = tgt_mask.sum(dim=1).to(dtype)
    else:
        src_len = torch.full((b,), float(n), dtype=dtype, device=conf_matrix.device)
        tgt_len = torch.full((b,), float(m), dtype=dtype, device=conf_matrix.device)
    entry_max = torch.floor(torch.maximum(src_len, tgt_len) * sample_rate).to(torch.int64)

    w, idx = stable_top_k(conf_matrix.reshape(b, n * m), k)
    src_sampled = torch.gather(src_pcd, 1, (idx // m)[..., None].expand(b, k, 3))
    tgt_sampled = torch.gather(tgt_pcd, 1, (idx % m)[..., None].expand(b, k, 3))
    w_mask = torch.arange(k, device=w.device)[None, :] < entry_max[:, None]
    w = torch.where(w_mask, w, torch.zeros_like(w))

    r, t, condition = weighted_kabsch(src_sampled, tgt_sampled, w[..., None])

    finite = torch.isfinite(r).all(dim=2).all(dim=1) & torch.isfinite(t).all(dim=2).all(dim=1)
    eye = torch.eye(3, dtype=dtype, device=r.device).expand(b, 3, 3)
    zero = torch.zeros((b, 3, 1), dtype=dtype, device=r.device)
    r = torch.where(finite[:, None, None], r, eye)
    t = torch.where(finite[:, None, None], t, zero)
    condition = torch.where(finite, condition, torch.zeros_like(condition))

    solution_mask = condition < max_condition_num
    r_fwd = torch.where(solution_mask[:, None, None], r, eye)
    t_fwd = torch.where(solution_mask[:, None, None], t, zero)
    return ProcrustesResult(r, t, r_fwd, t_fwd, condition, solution_mask)
