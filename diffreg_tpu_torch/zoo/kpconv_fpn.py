"""Generic KPConv-FPN backbone (vision3d/models/backbone/kpconv_fpn.py).

Counterpart of the JAX package's zoo/kpconv_fpn.py, on the port's 2D-3D
point-backbone blocks (nn/point_backbone.py: KPConv with a bias, GroupNorm
over the packed points, LeakyReLU 0.2): encoder stage 1 is a KPConv block and
a residual block; stages 2..E a strided residual block and two residual
blocks at twice the radius and width; the decoder interpolates over the
pyramid's upsampling tables, concatenates the skip and applies a unary
block (the last decoder layer a plain Linear unless ``norm_act_last``).
Every KPConv goes through ``ops.kpconv.kpconv_batched``: on CUDA tensors the
hand-written kernel (``csrc/kpconv.cu``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..nn.point_backbone import KPBlock, KPConvBias, KPResidual, UnaryBlock2D3D
from ..ops.partition import knn_interpolate_from_table


@dataclasses.dataclass(frozen=True)
class KPConvFPNConfig:
    input_dim: int = 1
    output_dim: int = 256
    first_dim: int = 64
    kernel_size: int = 15
    voxel_size: float = 0.025
    kpconv_radius: float = 2.5
    kpconv_sigma: float = 2.0
    encoder_stages: int = 4
    decoder_stages: int = 2
    norm_act_last: bool = False


class KPConvFPN(nn.Module):
    """A pyramid dict (``points``, ``masks``, ``neighbors``, ``pools``,
    ``upsamples``: per-level batched lists; ``features`` [B, N0, input_dim])
    -> the decoder's features, finest level first (``decoder_stages`` - 1
    levels decoded below the coarsest, which comes last)."""

    def __init__(self, cfg: KPConvFPNConfig):
        super().__init__()
        c = cfg
        if not (c.encoder_stages >= 2 and 1 <= c.decoder_stages <= c.encoder_stages):
            raise ValueError(f"encoder_stages {c.encoder_stages}, decoder_stages "
                             f"{c.decoder_stages}")
        self.cfg = cfg
        r, s, p = c.voxel_size * c.kpconv_radius, c.voxel_size * c.kpconv_sigma, c.kernel_size
        self.encoder1_1 = KPBlock(c.input_dim, c.first_dim, r, s, p)
        self.encoder1_2 = KPResidual(c.first_dim, c.first_dim * 2, r, s, n_points=p)
        dim = c.first_dim * 2
        for i in range(1, c.encoder_stages):
            self.add_module(f"encoder{i + 1}_1", KPResidual(dim, dim, r, s, strided=True,
                                                            n_points=p))
            self.add_module(f"encoder{i + 1}_2", KPResidual(dim, dim * 2, r * 2, s * 2,
                                                            n_points=p))
            self.add_module(f"encoder{i + 1}_3", KPResidual(dim * 2, dim * 2, r * 2, s * 2,
                                                            n_points=p))
            dim, r, s = dim * 2, r * 2, s * 2
        e = c.encoder_stages
        enc_dims = [c.first_dim * 2 * 2 ** i for i in range(e)]
        for i in range(e - 1, e - c.decoder_stages, -1):
            in_dim = dim + enc_dims[i - 1]
            if (not c.norm_act_last) and i == e - c.decoder_stages + 1:
                self.add_module(f"decoder{i}", nn.Linear(in_dim, c.output_dim))
            else:
                self.add_module(f"decoder{i}", UnaryBlock2D3D(in_dim, dim // 2))
            dim //= 2
        for mod in self.modules():          # the JAX layer's variance_scaling(2 / P, fan_in)
            if isinstance(mod, KPConvBias):
                p_, cin, _ = mod.weights.shape
                bound = math.sqrt(3.0 * (2.0 / p_) / (p_ * cin))
                nn.init.uniform_(mod.weights, -bound, bound)

    def forward(self, pyr):
        c = self.cfg
        pts, masks = pyr["points"], pyr["masks"]
        neigh, pools, ups = pyr["neighbors"], pyr["pools"], pyr["upsamples"]
        feats = self.encoder1_1(pts[0], pts[0], pyr["features"], neigh[0], masks[0])
        feats = self.encoder1_2(pts[0], pts[0], feats, neigh[0], masks[0], masks[0])
        enc = [feats]
        for i in range(1, c.encoder_stages):
            feats = getattr(self, f"encoder{i + 1}_1")(pts[i], pts[i - 1], feats, pools[i - 1],
                                                       masks[i], masks[i - 1])
            feats = getattr(self, f"encoder{i + 1}_2")(pts[i], pts[i], feats, neigh[i],
                                                       masks[i], masks[i])
            feats = getattr(self, f"encoder{i + 1}_3")(pts[i], pts[i], feats, neigh[i],
                                                       masks[i], masks[i])
            enc.append(feats)
        dec = [feats]
        e = c.encoder_stages
        for i in range(e - 1, e - c.decoder_stages, -1):
            feats = knn_interpolate_from_table(pts[i - 1], pts[i], feats, ups[i - 1])
            feats = torch.cat([feats, enc[i - 1]], dim=-1)
            layer = getattr(self, f"decoder{i}")
            feats = layer(feats) if isinstance(layer, nn.Linear) else layer(feats, masks[i - 1])
            dec.append(feats)
        return dec[::-1]
