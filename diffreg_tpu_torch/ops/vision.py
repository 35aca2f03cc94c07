"""2D<->3D geometry ops: meshgrid, align-corners resize, back-projection,
rendering, patchify, pairwise distances.

Counterpart of the JAX package's ops/vision.py. Pixels are (row, col) =
(v, u) ordered; intrinsics K = [[fx, 0, cx], [0, fy, cy], [0, 0, 1]].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def create_meshgrid(height, width, normalized=False, flatten=False, centered=False,
                    device=None):
    """Pixel coordinate grid [H, W, 2] in (v, u) order. Normalized, not
    centered coordinates are an inclusive linspace over [0, 1] (the
    reference's torch.linspace(0, 1, steps=H)), which the fusion module's
    Fourier embedding reads. It is formed as i * float32(1 / (n - 1)) with the
    last entry 1, as the JAX package's compiled linspace forms it, so that both
    packages embed the same numbers."""
    if normalized and not centered:
        v, u = _unit_linspace(height, device), _unit_linspace(width, device)
    else:
        v = torch.arange(height, dtype=torch.float32, device=device)
        u = torch.arange(width, dtype=torch.float32, device=device)
        if centered:
            v, u = v + 0.5, u + 0.5
        if normalized:
            v, u = v / height, u / width
    grid = torch.stack(torch.meshgrid(v, u, indexing="ij"), dim=-1)
    return grid.reshape(-1, 2) if flatten else grid


def _unit_linspace(n, device):
    out = torch.arange(n, dtype=torch.float32, device=device) \
        * torch.tensor(1.0 / max(n - 1, 1), dtype=torch.float32, device=device)
    if n > 1:
        out[-1] = 1.0
    return out


def resize_align_corners(x, hw):
    """Bilinear resize of x [B, C, H, W] to ``hw`` with align_corners=True."""
    if tuple(hw) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=True)


def back_project(depth, intrinsics, depth_limit=6.0, depth_min=0.0):
    """Depth map [H, W] (0 = invalid), intrinsics [3, 3] -> camera-space points
    [H*W, 3] and validity [H*W] (depth_min < d <= depth_limit)."""
    h, w = depth.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    grid = create_meshgrid(h, w, flatten=True, device=depth.device)
    d = depth.reshape(-1)
    pts = torch.stack([(grid[:, 1] - cx) * d / fx, (grid[:, 0] - cy) * d / fy, d], dim=-1)
    return pts, (d > depth_min) & (d <= depth_limit)


def render(points, intrinsics):
    """Project camera-frame points [N, 3] to unrounded pixels -> (pixels
    [N, 2] (v, u), depth [N], in front [N]): the JAX package's render with
    ``rounding=False``. A point at depth <= 1e-6 is divided by 1 instead."""
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    z = points[:, 2]
    in_front = z > 1e-6
    zs = torch.where(in_front, z, torch.ones_like(z))
    u = points[:, 0] / zs * fx + cx
    v = points[:, 1] / zs * fy + cy
    return torch.stack([v, u], dim=-1), z, in_front


def patchify(height, width, stride, device=None):
    """Flat pixel indices [P, stride^2] of each stride x stride patch and the
    patch centres [P, 2] (v, u)."""
    hp, wp = height // stride, width // stride
    pi = torch.arange(hp, device=device) * stride
    pj = torch.arange(wp, device=device) * stride
    d = torch.arange(stride, device=device)
    v = pi[:, None, None, None] + d[None, None, :, None]
    u = pj[None, :, None, None] + d[None, None, None, :]
    flat = (v * width + u).reshape(hp * wp, stride * stride)
    cv = (pi[:, None] + (stride - 1) / 2.0).expand(hp, wp)
    cu = (pj[None, :] + (stride - 1) / 2.0).expand(hp, wp)
    return flat.to(torch.int32), torch.stack([cv, cu], dim=-1).reshape(-1, 2)


def pairwise_distance(a, b, squared=True):
    """[..., N, C] x [..., M, C] -> [..., N, M] Euclidean distances, in the
    JAX package's form a^2 - 2 a.b + b^2, clipped at 0."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    d2 = (a2 - 2.0 * (a @ b.transpose(-1, -2)) + b2.transpose(-1, -2)).clamp_min(0.0)
    return d2 if squared else torch.sqrt(d2)


def l2_normalize(x, eps=1e-8):
    """x / max(||x||, eps) along the last axis."""
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(eps)


def pairwise_cosine_similarity(a, b, eps=1e-8):
    return l2_normalize(a, eps) @ l2_normalize(b, eps).transpose(-1, -2)
