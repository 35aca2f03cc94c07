"""Embedded-deformation warping and non-rigid ICP (Gauss-Newton and Adam).

Counterpart of the JAX package's geometry/deformation.py (the reference's
vision3d/ops/embedded_deformation.py, nonrigid_icp_adam.py and
layers/nonrigid_icp.py): the reference's ragged skinning is a dense masked
gather-and-sum over each point's K anchors (anchor index -1 weighs nothing),
and both solvers run a fixed number of iterations on the device with no read
back to the host. Poses are (rotations [M, 3, 3], translations [M, 3]).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch.func import jacfwd

from .so3 import skew_symmetric_matrix


def _rows(table, idx):
    """table[idx] as ``index_select`` on the flattened indices: its backward adds
    rows with ``index_add_``, where advanced indexing's sorts them first on
    CUDA (the Adam solver's 500 backward passes)."""
    return table.index_select(0, idx.reshape(-1)).reshape(idx.shape + table.shape[1:])


def apply_embedded_deformation_dense(points, nodes, rotations, translations,
                                     weights, eps: float = 1e-6):
    """Dense-weight variant: points [N, 3], nodes [M, 3], rotations
    [M, 3, 3], translations [M, 3], weights [N, M] (unnormalized)."""
    w = weights / (weights.sum(dim=1, keepdim=True) + eps)         # [N, M]
    rel = points[None, :, :] - nodes[:, None, :]                   # [M, N, 3]
    warped = torch.einsum("mij,mnj->mni", rotations, rel) \
        + nodes[:, None, :] + translations[:, None, :]             # [M, N, 3]
    return torch.einsum("mn,mni->ni", w.T, warped)


def apply_embedded_deformation(points, nodes, rotations, translations,
                               anchor_indices, anchor_weights, eps: float = 1e-6):
    """Anchor-list variant: anchor_indices [N, K] int (-1 = absent anchor),
    anchor_weights [N, K]."""
    w = anchor_weights / (anchor_weights.sum(dim=1, keepdim=True) + eps)
    valid = anchor_indices >= 0
    idx = torch.where(valid, anchor_indices, torch.zeros_like(anchor_indices)).long()
    anc_nodes = _rows(nodes, idx)                                  # [N, K, 3]
    anc_rot = _rows(rotations, idx)                                # [N, K, 3, 3]
    anc_trn = _rows(translations, idx)                             # [N, K, 3]
    rel = points[:, None, :] - anc_nodes
    warped = torch.einsum("nkij,nkj->nki", anc_rot, rel) + anc_nodes + anc_trn
    w = torch.where(valid, w, torch.zeros_like(w))
    return torch.sum(warped * w[..., None], dim=1)


def _icp_cost(rotations, translations, src_nodes, src_corr, tgt_corr,
              anchor_indices, anchor_weights, node_edges, node_edge_weights,
              corr_mask, edge_mask):
    # landmark term
    warped = apply_embedded_deformation(src_corr, src_nodes, rotations, translations,
                                        anchor_indices, anchor_weights)
    res = torch.sum((warped - tgt_corr) ** 2, dim=1)
    landmark = torch.sum(torch.where(corr_mask, res, torch.zeros_like(res))) \
        / torch.clamp(corr_mask.sum(), min=1)

    # ARAP term
    anc, nbr = node_edges[:, 0].long(), node_edges[:, 1].long()
    disp = src_nodes[nbr] - src_nodes[anc]
    warped_nbr = torch.einsum("eij,ej->ei", _rows(rotations, anc), disp) \
        + src_nodes[anc] + _rows(translations, anc)
    tgt_nbr = src_nodes[nbr] + _rows(translations, nbr)
    arap_vals = torch.sum((warped_nbr - tgt_nbr) ** 2, dim=1) * node_edge_weights
    arap = torch.sum(torch.where(edge_mask, arap_vals, torch.zeros_like(arap_vals))) \
        / torch.clamp(edge_mask.sum(), min=1)

    # soft orthogonality of the free 3x3 rotations
    gram = torch.einsum("mji,mjk->mik", rotations, rotations)      # R^T R
    eye = torch.eye(3, dtype=rotations.dtype, device=rotations.device)
    ortho = torch.mean(torch.sum((gram - eye) ** 2, dim=(1, 2)))

    return landmark + 0.1 * arap + 0.1 * ortho


def _exp_so3(phi):
    """Rodrigues through coefficients of theta^2, differentiable at phi = 0 (the
    Gauss-Newton linearization point, where the |phi| form has a NaN
    gradient); the square root's branch is guarded twice, as in JAX."""
    t2 = torch.sum(phi * phi, dim=-1)
    small = t2 < 1e-12
    safe = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(safe)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / safe)
    k = skew_symmetric_matrix(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + a[..., None, None] * k + b[..., None, None] * (k @ k)


def non_rigid_icp_gauss_newton(src_nodes, src_corr_points, tgt_corr_points,
                               anchor_indices, anchor_weights, edge_indices,
                               corr_weights=None, edge_weights=None,
                               corr_lambda: float = 1.0,
                               arap_lambda: float = 0.1,
                               lm_lambda: float = 0.1,
                               num_iterations: int = 5,
                               corr_mask=None, edge_mask=None):
    """Gauss-Newton/LM embedded-deformation ICP.

    The residual vector (weighted correspondence residuals and ARAP edge
    residuals, square-root weights) is differentiated with
    ``torch.func.jacfwd`` at the zero increment and the damped system
    (J^T J + lm I) delta = -J^T r solved densely (6M unknowns). Updates are
    R <- exp(phi) R, t <- t + dt. Returns (rotations [M, 3, 3], translations
    [M, 3]).
    """
    m = src_nodes.shape[0]
    n = anchor_indices.shape[0]
    e = edge_indices.shape[0]
    dev, dt = src_nodes.device, src_nodes.dtype
    if corr_mask is None:
        corr_mask = torch.ones(n, dtype=torch.bool, device=dev)
    if edge_mask is None:
        edge_mask = torch.ones(e, dtype=torch.bool, device=dev)
    edge_mask = edge_mask & (edge_indices[:, 0] != edge_indices[:, 1])   # no self-edges
    cw = torch.ones(n, dtype=dt, device=dev) if corr_weights is None else corr_weights
    cw = torch.sqrt(torch.clamp(cw, min=0.0)) * corr_mask
    ew = torch.ones(e, dtype=dt, device=dev) if edge_weights is None else edge_weights
    ew = torch.sqrt(torch.clamp(ew, min=0.0)) * edge_mask

    anc_valid = (anchor_indices >= 0) & (anchor_weights > 0.0)
    aidx = torch.where(anc_valid, anchor_indices, torch.zeros_like(anchor_indices)).long()
    aw = torch.where(anc_valid, anchor_weights, torch.zeros_like(anchor_weights))
    aw = aw / (aw.sum(dim=1, keepdim=True) + 1e-6)

    uidx, vidx = edge_indices[:, 0].long(), edge_indices[:, 1].long()
    deltas = src_nodes[vidx] - src_nodes[uidx]
    anc_nodes = src_nodes[aidx]                                    # [N, K, 3]
    rel = src_corr_points[:, None, :] - anc_nodes

    def residuals(rot, trn):
        warped = torch.einsum("nkij,nkj->nki", _rows(rot, aidx), rel) + anc_nodes \
            + _rows(trn, aidx)
        warped = torch.sum(warped * aw[..., None], dim=1)          # [N, 3]
        r_corr = (warped - tgt_corr_points) * (corr_lambda * cw)[:, None]
        warped_v = torch.einsum("eij,ej->ei", _rows(rot, uidx), deltas) \
            + src_nodes[uidx] + _rows(trn, uidx)
        r_arap = (warped_v - (src_nodes[vidx] + _rows(trn, vidx))) * (arap_lambda * ew)[:, None]
        return torch.cat([r_corr.reshape(-1), r_arap.reshape(-1)])

    rot = torch.eye(3, dtype=dt, device=dev).repeat(m, 1, 1)
    trn = torch.zeros(m, 3, dtype=dt, device=dev)
    damping = lm_lambda * torch.eye(m * 6, dtype=dt, device=dev)
    zero = torch.zeros(m * 6, dtype=dt, device=dev)
    for _ in range(num_iterations):
        def res_inc(x, rot=rot, trn=trn):
            inc = x.reshape(m, 6)
            return residuals(_exp_so3(inc[:, :3]) @ rot, trn + inc[:, 3:])

        r0 = res_inc(zero)
        jac = jacfwd(res_inc)(zero)                                # [R, 6M]
        # solve_ex: no check of the factorization on the host between iterations
        x = torch.linalg.solve_ex(jac.T @ jac + damping, -(jac.T @ r0))[0]
        inc = x.reshape(m, 6)
        rot, trn = _exp_so3(inc[:, :3]) @ rot, trn + inc[:, 3:]
    return rot, trn


def non_rigid_icp_adam(src_nodes, src_corr_points, tgt_corr_points,
                       anchor_indices, anchor_weights, node_edges,
                       node_edge_weights, num_iterations: int = 500,
                       lr: float = 1e-2, corr_mask=None, edge_mask=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embedded-deformation non-rigid ICP with an Adam solver: free 3x3
    rotations with the soft orthogonality penalty (weights 1.0 landmark, 0.1
    ARAP, 0.1 orthogonality). Adam is optax.adam's update, in its order (the
    moments, then the bias corrections in f32, then -lr times the step), as
    ``engine/train.py:Optimizer`` writes it. Returns per-node (rotations
    [M, 3, 3], translations [M, 3])."""
    m = src_nodes.shape[0]
    dev, dt = src_nodes.device, src_nodes.dtype
    if corr_mask is None:
        corr_mask = torch.ones(src_corr_points.shape[0], dtype=torch.bool, device=dev)
    if edge_mask is None:
        edge_mask = torch.ones(node_edges.shape[0], dtype=torch.bool, device=dev)
    b1, b2, eps = 0.9, 0.999, 1e-8
    f32 = np.float32
    params = [torch.eye(3, dtype=dt, device=dev).repeat(m, 1, 1), torch.zeros(m, 3, dtype=dt, device=dev)]
    mus = [torch.zeros_like(p) for p in params]
    nus = [torch.zeros_like(p) for p in params]
    for step in range(1, num_iterations + 1):
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True) for p in params]
            cost = _icp_cost(leaves[0], leaves[1], src_nodes, src_corr_points, tgt_corr_points,
                             anchor_indices, anchor_weights, node_edges, node_edge_weights,
                             corr_mask, edge_mask)
            grads = torch.autograd.grad(cost, leaves)
        corr1 = float(f32(1.0) - np.power(f32(b1), f32(step), dtype=f32))
        corr2 = float(f32(1.0) - np.power(f32(b2), f32(step), dtype=f32))
        for i, g in enumerate(grads):
            mus[i] = (1 - b1) * g + b1 * mus[i]
            nus[i] = (1 - b2) * (g * g) + b2 * nus[i]
            u = (mus[i] / corr1) / (torch.sqrt(nus[i] / corr2) + eps)
            params[i] = params[i] + (-lr) * u
    return params[0], params[1]
