"""Point backbone of the 2D-3D branch: a 3-stage KPConv encoder and a
kNN-interpolation decoder (the 2D-3D experiment's PointBackbone).

Counterpart of the JAX package's nn/point_backbone.py on vision3d layer
semantics: the KPConv carries a bias, normalization is the masked affine
GroupNorm over the packed points (``GroupNormPack``), unary blocks are a
Linear with bias, and the leaky ReLU's slope is 0.2. Its 8 KPConv layers go
through ``ops.kpconv.kpconv_batched`` (on CUDA tensors the hand-written
kernel). Module names follow the reference state_dict (encoder1_1 ..
encoder3_3, decoder2, decoder1, out_proj).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.kernel_points import load_kernel_points
from ..ops.kpconv import kpconv_batched, max_pool
from ..ops.partition import knn_interpolate_from_table
from .layers2d3d import GroupNormPack, leaky2d3d


@dataclasses.dataclass(frozen=True)
class PointBackboneConfig:
    input_dim: int = 1
    output_dim: int = 128
    init_dim: int = 64
    kernel_size: int = 15
    init_radius: float = 0.0625    # 2.5 * 0.025 voxel
    init_sigma: float = 0.05


class KPConvBias(nn.Module):
    """vision3d KPConv: influence-weighted kernel-point convolution plus a bias;
    ``sigma`` is the kernel points' influence extent, ``n_points`` their count."""

    def __init__(self, in_dim: int, out_dim: int, radius: float, sigma: float,
                 n_points: int = 15):
        super().__init__()
        self.sigma = float(sigma)
        self.weights = nn.Parameter(torch.empty(n_points, in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        self.register_buffer("kernel_points", torch.from_numpy(load_kernel_points(
            radius, n_points, 3, "center")))

    def forward(self, q_pts, s_pts, feats, inds):
        return kpconv_batched(q_pts, s_pts, inds, feats, self.kernel_points, self.weights,
                              self.sigma) + self.bias


class UnaryBlock2D3D(nn.Module):
    """vision3d UnaryBlockPackMode: Linear (with bias) -> GroupNorm -> LeakyReLU."""

    def __init__(self, in_dim: int, out_dim: int, use_act: bool = True):
        super().__init__()
        self.mlp = nn.Linear(in_dim, out_dim)
        self.norm = GroupNormPack(out_dim)
        self.use_act = use_act

    def forward(self, x, mask):
        h = self.norm(self.mlp(x), mask)
        return leaky2d3d(h) if self.use_act else h


class KPBlock(nn.Module):
    """vision3d KPConvBlock: KPConv (with bias) + GroupNorm + LeakyReLU."""

    def __init__(self, in_dim, out_dim, radius, sigma, n_points=15):
        super().__init__()
        self.conv = KPConvBias(in_dim, out_dim, radius, sigma, n_points)
        self.norm = GroupNormPack(out_dim)

    def forward(self, q_pts, s_pts, feats, inds, q_mask):
        return leaky2d3d(self.norm(self.conv(q_pts, s_pts, feats, inds), q_mask))


class KPResidual(nn.Module):
    """vision3d KPResidualBlock: unary1 -> KPConvBlock -> unary2 (no act) plus
    the (max-pooled when strided, projected when in != out) shortcut -> leaky."""

    def __init__(self, in_dim, out_dim, radius, sigma, strided=False, n_points=15):
        super().__init__()
        mid = out_dim // 4
        self.strided = strided
        self.unary1 = UnaryBlock2D3D(in_dim, mid)
        self.conv = KPBlock(mid, mid, radius, sigma, n_points)
        self.unary2 = UnaryBlock2D3D(mid, out_dim, use_act=False)
        self.unary_shortcut = (UnaryBlock2D3D(in_dim, out_dim, use_act=False)
                               if in_dim != out_dim else None)

    def forward(self, q_pts, s_pts, feats, inds, q_mask, s_mask):
        h = self.unary1(feats, s_mask)
        h = self.conv(q_pts, s_pts, h, inds, q_mask)
        h = self.unary2(h, q_mask)
        shortcut = max_pool(feats, inds) if self.strided else feats
        if self.unary_shortcut is not None:
            shortcut = self.unary_shortcut(shortcut, q_mask)
        return leaky2d3d(h + shortcut)


class PointBackbone(nn.Module):
    """A 3-level pyramid batch -> [level-0 features [B, N0, output_dim],
    level-1 [B, N1, 4 init_dim], level-2 (the nodes) [B, N2, 8 init_dim]]; each
    KPConv has ``kernel_size`` kernel points (any count, as JAX's builds)."""

    def __init__(self, cfg: PointBackboneConfig):
        super().__init__()
        self.cfg = cfg
        d, r, s, p = cfg.init_dim, cfg.init_radius, cfg.init_sigma, cfg.kernel_size
        self.encoder1_1 = KPBlock(cfg.input_dim, d, r, s, p)
        self.encoder1_2 = KPResidual(d, 2 * d, r, s, n_points=p)
        self.encoder2_1 = KPResidual(2 * d, 2 * d, r, s, strided=True, n_points=p)
        self.encoder2_2 = KPResidual(2 * d, 4 * d, 2 * r, 2 * s, n_points=p)
        self.encoder2_3 = KPResidual(4 * d, 4 * d, 2 * r, 2 * s, n_points=p)
        self.encoder3_1 = KPResidual(4 * d, 4 * d, 2 * r, 2 * s, strided=True, n_points=p)
        self.encoder3_2 = KPResidual(4 * d, 8 * d, 4 * r, 4 * s, n_points=p)
        self.encoder3_3 = KPResidual(8 * d, 8 * d, 4 * r, 4 * s, n_points=p)
        self.decoder2 = UnaryBlock2D3D(12 * d, 4 * d)
        self.decoder1 = UnaryBlock2D3D(6 * d, 2 * d)
        self.out_proj = nn.Linear(2 * d, cfg.output_dim)

    def forward(self, batch):
        pts, masks, neigh, pools = batch.points, batch.masks, batch.neighbors, batch.pools
        f1 = self.encoder1_1(pts[0], pts[0], batch.pcd_feats, neigh[0], masks[0])
        f1 = self.encoder1_2(pts[0], pts[0], f1, neigh[0], masks[0], masks[0])
        f2 = self.encoder2_1(pts[1], pts[0], f1, pools[0], masks[1], masks[0])
        f2 = self.encoder2_2(pts[1], pts[1], f2, neigh[1], masks[1], masks[1])
        f2 = self.encoder2_3(pts[1], pts[1], f2, neigh[1], masks[1], masks[1])
        f3 = self.encoder3_1(pts[2], pts[1], f2, pools[1], masks[2], masks[1])
        f3 = self.encoder3_2(pts[2], pts[2], f3, neigh[2], masks[2], masks[2])
        f3 = self.encoder3_3(pts[2], pts[2], f3, neigh[2], masks[2], masks[2])

        # the decoder interpolates over the pyramid's upsampling tables
        ups = batch.upsamples
        l2 = knn_interpolate_from_table(pts[1], pts[2], f3, ups[1])
        l2 = self.decoder2(torch.cat([l2, f2], dim=-1), masks[1])
        l1 = knn_interpolate_from_table(pts[0], pts[1], l2, ups[0])
        l1 = self.decoder1(torch.cat([l1, f1], dim=-1), masks[0])
        return [self.out_proj(l1), l2, f3]
