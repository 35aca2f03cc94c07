"""Volumetric position encoding over voxelized coordinates, rotary or sinusoidal.

Coordinates are voxelized against a volume origin and each axis gets
feature_dim // 6 sin/cos frequencies. ``rotary``: each frequency duplicated
into an interleaved pair, and the code rotates feature pairs RoFormer-style
(``embed_rotary``); ``sinusoidal``: per axis [sin, cos] concatenated, and the
code is added to the features. The code is a constant of the coordinates: no
gradient flows back into them (the JAX package's ``stop_gradient``), so a warp
that moved the points, such as the positioning layer's, passes no gradient to
what computed it.
"""
from __future__ import annotations

import math

import torch


def embed_rotary(x, cos, sin):
    """x * cos + rot90(x) * sin, interleaved pairs; x, cos, sin: [..., d]."""
    x2 = torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)
    return x * cos + x2 * sin


PE_TYPES = ("rotary", "sinusoidal")


def embed_pos(pe_type, x, pe):
    """Features x combined with their position code: rotated (rotary) or
    added (sinusoidal)."""
    if pe_type == "rotary":
        return embed_rotary(x, pe[..., 0], pe[..., 1])
    if pe_type == "sinusoidal":
        return x + pe
    raise KeyError(pe_type)


def volumetric_pe(xyz, feature_dim, vol_origin, voxel_size, pe_type="rotary"):
    """Position code of xyz [B, N, 3], detached from xyz's graph: rotary
    [B, N, feature_dim, 2] stacked (cos, sin), or sinusoidal [B, N,
    feature_dim] ordered [sin x, cos x, sin y, cos y, sin z, cos z]."""
    if pe_type not in PE_TYPES:
        raise KeyError(pe_type)
    xyz = xyz.detach()
    b, n, _ = xyz.shape
    origin = torch.as_tensor(vol_origin, dtype=xyz.dtype, device=xyz.device).reshape(1, 1, 3)
    vox = (xyz - origin) / voxel_size
    d3 = feature_dim // 3
    freq_idx = torch.arange(0, d3, 2, dtype=xyz.dtype, device=xyz.device)
    div = torch.exp(freq_idx * (-math.log(10000.0) / d3)).reshape(1, 1, -1)
    phases = vox[..., :, None] * div[..., None, :]            # [B, N, 3, d/6]
    sin, cos = torch.sin(phases), torch.cos(phases)
    if pe_type == "sinusoidal":
        return torch.cat([t for ax in range(3) for t in (sin[..., ax, :], cos[..., ax, :])],
                         dim=-1)

    def dup(a):  # [B, N, d/6] -> [B, N, d/3], each frequency twice
        return torch.stack([a, a], dim=-1).reshape(b, n, -1)

    sin_pos = torch.cat([dup(sin[..., ax, :]) for ax in range(3)], dim=-1)
    cos_pos = torch.cat([dup(cos[..., ax, :]) for ax in range(3)], dim=-1)
    return torch.stack([cos_pos, sin_pos], dim=-1)
