"""Log-space Sinkhorn optimal transport with a learned dustbin.

The reference ``log_optimal_transport``: an (N+1)x(M+1) augmented score
matrix with one dustbin score ``alpha``, marginals that give each real row
and column mass 1/(ms+ns) and the dustbins ns/(ms+ns) resp. ms/(ms+ns), and
``iters`` alternating log-domain normalizations. Padded rows and columns get
-1e9 scores and -1e9 marginals, so their mass is exactly zero.

The masks are validity masks. Where a side's padding differs from its
validity (the 2D-3D matcher: nodes that are real but too small, patches
without depth), ``src_pad`` / ``tgt_pad`` name the real rows and columns: a
real but invalid row keeps its marginal mass and a finite dustbin score, so
all of its mass drains into the dustbin, as in the reference; only rows
outside the pad mask are removed. They default to the validity masks.

``dual_softmax_conf_matrix`` is the other matcher's confidence: the product
of the similarity's softmax over rows and over columns.
"""
from __future__ import annotations

import torch

from .masked import NEG_INF, mask_matrix


def log_sinkhorn(scores, alpha, iters, src_mask, tgt_mask, src_pad=None, tgt_pad=None):
    """scores [B, N, M], alpha scalar, masks [B, N] / [B, M] (pads likewise,
    default the masks) -> [B, N+1, M+1] log assignment with the
    ``-log(ms+ns)`` normalization removed, so ``exp(Z)[:, :-1, :-1]`` are the
    match confidences."""
    b, n, m = scores.shape
    src_pad = src_mask if src_pad is None else src_pad
    tgt_pad = tgt_mask if tgt_pad is None else tgt_pad
    dtype = scores.dtype
    scores = mask_matrix(scores, src_mask, tgt_mask)
    # a fully masked side would give log(0); its outputs are masked downstream
    ms = src_mask.sum(dim=1, keepdim=True).to(dtype).clamp_min(1.0)   # [B, 1]
    ns = tgt_mask.sum(dim=1, keepdim=True).to(dtype).clamp_min(1.0)

    alpha = alpha.to(dtype)
    neg = torch.tensor(NEG_INF, dtype=dtype, device=scores.device)
    bins0 = torch.where(src_pad[:, :, None], alpha, neg)                # [B, N, 1]
    bins1 = torch.where(tgt_pad[:, None, :], alpha, neg)                # [B, 1, M]
    corner = alpha.expand(b, 1, 1)
    z = torch.cat([torch.cat([scores, bins0], dim=2),
                   torch.cat([bins1, corner], dim=2)], dim=1)          # [B, N+1, M+1]

    norm = -torch.log(ms + ns)                                          # [B, 1]
    log_mu = torch.cat([norm.expand(b, n), torch.log(ns) + norm], dim=1)
    log_nu = torch.cat([norm.expand(b, m), torch.log(ms) + norm], dim=1)
    ones = src_mask.new_ones((b, 1))
    log_mu = torch.where(torch.cat([src_pad, ones], dim=1), log_mu, neg)
    log_nu = torch.where(torch.cat([tgt_pad, ones], dim=1), log_nu, neg)

    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(int(iters)):
        u = log_mu - torch.logsumexp(z + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(z + u[:, :, None], dim=1)
    z = z + u[:, :, None] + v[:, None, :]
    return z - norm[:, :, None]


def dual_softmax_conf_matrix(sim, temperature, src_mask=None, tgt_mask=None):
    """softmax over sources x softmax over targets of sim [B, N, M] /
    temperature; with masks, invalid sources get -1e9 in the first and
    invalid targets in the second (the reference's dual-softmax matcher)."""
    sim = sim / temperature
    if src_mask is None:
        s1 = s2 = sim
    else:
        neg = torch.tensor(NEG_INF, dtype=sim.dtype, device=sim.device)
        s1 = torch.where(src_mask[:, :, None], sim, neg)
        s2 = torch.where(tgt_mask[:, None, :], sim, neg)
    return torch.softmax(s1, dim=1) * torch.softmax(s2, dim=2)
