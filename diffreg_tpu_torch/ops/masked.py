"""Masked statistics for padded, static-shape tensors."""
from __future__ import annotations

import torch

NEG_INF = -1.0e9  # finite stand-in for -inf: exp() underflows to exactly 0


def masked_mean(x, mask, dim, keepdim=False, eps=1e-12):
    """Mean of ``x`` over ``dim`` counting only entries where ``mask`` is True."""
    m = mask.to(x.dtype)
    while m.ndim < x.ndim:
        m = m[..., None]
    num = (x * m).sum(dim=dim, keepdim=keepdim)
    den = m.sum(dim=dim, keepdim=keepdim)
    return num / den.clamp_min(eps)


def masked_instance_norm(x, mask, eps=1e-5):
    """Per-channel normalization over the point axis, valid points only.

    The reference ``BatchNormBlock`` is an affine-free InstanceNorm1d over
    the packed point axis: biased variance over the valid rows, eps 1e-5;
    padded rows are zeroed on output.

    x: [B, N, C]; mask: [B, N].
    """
    dim = x.ndim - 2
    mu = masked_mean(x, mask, dim, keepdim=True)
    var = masked_mean((x - mu) ** 2, mask, dim, keepdim=True)
    y = (x - mu) * (1.0 / torch.sqrt(var + eps))
    return y * mask.to(x.dtype)[..., None]


def mask_matrix(scores, src_mask, tgt_mask, fill=NEG_INF):
    """Fill entries of [B, N, M] scores where either side is padding."""
    valid = src_mask[..., :, None] & tgt_mask[..., None, :]
    return torch.where(valid, scores, torch.full_like(scores, fill))


def scatter_pairs(src, tgt, values, valid, n: int, m: int):
    """Padded pair lists src, tgt, values [B, Q] -> dense [B, n, m] (zeros
    elsewhere); invalid entries are dropped (written to a slot past the end).
    Where a valid (src, tgt) pair repeats, one of its values is kept."""
    flat = torch.where(valid, src.long() * m + tgt.long(),
                       torch.full_like(src, n * m, dtype=torch.long))
    out = values.new_zeros((src.shape[0], n * m + 1))
    out.scatter_(1, flat, values)
    return out[:, :n * m].reshape(src.shape[0], n, m)
