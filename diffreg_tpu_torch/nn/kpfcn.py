"""KPFCN — kernel-point feature pyramid backbone (torch).

Counterpart of the JAX package's nn/kpfcn.py, on padded static-shape
pyramids, with the reference's module names (backbone.py, blocks.py) so
that state_dict keys follow the released checkpoints:

  * the architecture list drives block construction (simple halves out_dim,
    strided doubles it, the decoder concatenates a skip after each upsample);
  * normalization is the reference's InstanceNorm-as-"BatchNorm" quirk,
    computed under the validity mask, or with ``use_batch_norm`` False a bias
    (``NormBlock``); leaky ReLU slope 0.1;
  * every KPConv runs in the configured influence and aggregation modes;
    blocks whose name contains "deform" run the deformable KPConv
    (``ops.kpconv.kpconv_deformable``, modulated under ``modulated``), whose
    module keeps the last forward's ``deform_aux`` for
    ``engine.loss_library.p2p_fitting_regularizer``;
  * ``compute_dtype`` "bfloat16" runs every KPConv on the bf16 path
    (``ops.kpconv``), as the JAX package's does; the unary blocks stay f32;
  * ``forward(batch)`` (the coarse phase) returns level ``coarse_level``
    features through the 1x1 ``coarse_out`` head after decoder block 1. The
    remaining decoder blocks and the ``coarse_in``/``fine_out`` heads exist so
    that reference weights carry over whole; the fine phase is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernel_points import load_kernel_points
from ..ops.kpconv import (check_modes, closest_pool, kpconv_batched, kpconv_deformable,
                          max_pool)
from ..ops.masked import masked_instance_norm


@dataclasses.dataclass(frozen=True)
class KPFCNConfig:
    architecture: Tuple[str, ...]
    num_kernel_points: int = 15
    in_points_dim: int = 3
    first_feats_dim: int = 256
    in_feats_dim: int = 1
    first_subsampling_dl: float = 0.025
    conv_radius: float = 2.5
    kp_extent: float = 2.0
    kp_influence: str = "linear"           # linear | constant | gaussian
    aggregation_mode: str = "sum"          # sum | closest
    fixed_kernel_points: str = "center"
    use_batch_norm: bool = True            # False: each norm is a bias
    coarse_feature_dim: int = 432
    fine_feature_dim: int = 264
    modulated: bool = False                # deformable blocks' per-point gains
    compute_dtype: Optional[str] = None    # "bfloat16": the KPConvs' bf16 path
    coarse_level: int = -2


def _leaky(x):
    return F.leaky_relu(x, negative_slope=0.1)


class KPConv(nn.Module):
    """One kernel-point convolution with its fixed dispositions: rigid, or
    (``deformable``) the deformable KPConv, whose rigid ``offset_conv`` (its
    own ``weights`` and ``kernel_points``) and ``offset_bias`` predict the
    per-query kernel offsets, as the reference's deformable KPConv names them.
    After a deformable forward, ``deform_aux`` holds that forward's ``min_d2``
    [B, Nq, P], ``deformed_kp`` [B, Nq, P, 3], ``kp_extent`` (an f32 scalar)
    and ``q_mask`` [B, Nq]: what the reference keeps on the module for the
    fitting regularizer, and the JAX package sows."""

    def __init__(self, in_dim: int, out_dim: int, radius: float, extent: float,
                 cfg: KPFCNConfig, deformable: bool = False):
        super().__init__()
        check_modes(cfg.kp_influence, cfg.aggregation_mode)
        p = cfg.num_kernel_points
        self.extent = float(extent)
        self.compute_dtype = cfg.compute_dtype
        self.modes = (cfg.kp_influence, cfg.aggregation_mode)
        self.modulated = cfg.modulated
        self.weights = nn.Parameter(torch.empty(p, in_dim, out_dim))
        self.register_buffer("kernel_points", torch.from_numpy(load_kernel_points(
            radius, p, cfg.in_points_dim, cfg.fixed_kernel_points)))
        self.offset_conv = None
        self.deform_aux = None
        if deformable:
            offset_dim = (4 if cfg.modulated else 3) * p
            self.offset_conv = KPConv(in_dim, offset_dim, radius, extent, cfg)
            self.offset_bias = nn.Parameter(torch.zeros(offset_dim))

    def forward(self, q_pts, s_pts, neighb_inds, x, q_mask=None):
        if self.offset_conv is None:
            return kpconv_batched(q_pts, s_pts, neighb_inds, x, self.kernel_points,
                                  self.weights, self.extent, self.compute_dtype, *self.modes)
        out, aux = kpconv_deformable(
            q_pts, s_pts, neighb_inds, x, self.kernel_points, self.weights,
            self.offset_conv.weights, self.offset_bias, self.extent, *self.modes,
            self.modulated, self.compute_dtype, self.offset_conv.kernel_points)
        if q_mask is None:
            q_mask = torch.ones(out.shape[:-1], dtype=torch.bool, device=out.device)
        self.deform_aux = {"min_d2": aux["min_d2"], "deformed_kp": aux["deformed_kp"],
                           "kp_extent": torch.tensor(self.extent, dtype=torch.float32,
                                                     device=out.device),
                           "q_mask": q_mask}
        return out


class NormBlock(nn.Module):
    """The reference's BatchNormBlock: the masked instance norm, or with
    ``use_bn`` False a bias (zero at initialisation)."""

    def __init__(self, dim: int, use_bn: bool):
        super().__init__()
        self.use_bn = use_bn
        if not use_bn:
            self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, mask):
        return masked_instance_norm(x, mask) if self.use_bn else x + self.bias


class UnaryBlock(nn.Module):
    """Linear (no bias) -> norm -> leaky ReLU (unless no_relu).

    ``level`` is the pyramid level whose mask it uses when it stands alone
    in the decoder."""

    def __init__(self, in_dim: int, out_dim: int, no_relu: bool = False, level: int = 0,
                 use_bn: bool = True):
        super().__init__()
        self.mlp = nn.Linear(in_dim, out_dim, bias=False)
        self.batch_norm = NormBlock(out_dim, use_bn)
        self.no_relu = no_relu
        self.level = level

    def forward(self, x, mask):
        x = self.batch_norm(self.mlp(x), mask)
        return x if self.no_relu else _leaky(x)


def _conv_io(batch, layer_ind: int, strided: bool):
    if strided:
        q_pts, q_mask = batch.points[layer_ind + 1], batch.masks[layer_ind + 1]
        inds = batch.pools[layer_ind]
    else:
        q_pts, q_mask = batch.points[layer_ind], batch.masks[layer_ind]
        inds = batch.neighbors[layer_ind]
    return q_pts, batch.points[layer_ind], inds, q_mask


class SimpleBlock(nn.Module):
    """KPConv (out_dim // 2 channels, like the reference) -> norm -> leaky."""

    def __init__(self, in_dim, out_dim, radius, layer_ind, strided, cfg: KPFCNConfig,
                 deformable: bool = False):
        super().__init__()
        self.layer_ind, self.strided = layer_ind, strided
        extent = radius * cfg.kp_extent / cfg.conv_radius
        self.KPConv = KPConv(in_dim, out_dim // 2, radius, extent, cfg, deformable)
        self.batch_norm = NormBlock(out_dim // 2, cfg.use_batch_norm)

    def forward(self, x, batch):
        q_pts, s_pts, inds, q_mask = _conv_io(batch, self.layer_ind, self.strided)
        x = self.KPConv(q_pts, s_pts, inds, x, q_mask)
        return _leaky(self.batch_norm(x, q_mask))


class ResnetBottleneckBlock(nn.Module):
    """unary(in -> out/4) -> KPConv -> norm -> leaky -> unary(out/4 -> out),
    plus a (max-pooled when strided, projected when in != out) shortcut."""

    def __init__(self, in_dim, out_dim, radius, layer_ind, strided, cfg: KPFCNConfig,
                 deformable: bool = False):
        super().__init__()
        self.layer_ind, self.strided = layer_ind, strided
        extent = radius * cfg.kp_extent / cfg.conv_radius
        mid = out_dim // 4
        bn = cfg.use_batch_norm
        self.unary1 = UnaryBlock(in_dim, mid, use_bn=bn) if in_dim != mid else None
        self.KPConv = KPConv(mid, mid, radius, extent, cfg, deformable)
        self.batch_norm_conv = NormBlock(mid, bn)
        self.unary2 = UnaryBlock(mid, out_dim, no_relu=True, use_bn=bn)
        self.unary_shortcut = (UnaryBlock(in_dim, out_dim, no_relu=True, use_bn=bn)
                               if in_dim != out_dim else None)

    def forward(self, x, batch):
        q_pts, s_pts, inds, q_mask = _conv_io(batch, self.layer_ind, self.strided)
        h = x if self.unary1 is None else self.unary1(x, batch.masks[self.layer_ind])
        h = self.KPConv(q_pts, s_pts, inds, h, q_mask)
        h = _leaky(self.batch_norm_conv(h, q_mask))
        h = self.unary2(h, q_mask)
        shortcut = max_pool(x, inds) if self.strided else x
        if self.unary_shortcut is not None:
            shortcut = self.unary_shortcut(shortcut, q_mask)
        return _leaky(h + shortcut)


class NearestUpsampleBlock(nn.Module):
    """Copy each level-(l-1) point's nearest level-l feature."""

    def __init__(self, layer_ind: int):
        super().__init__()
        self.layer_ind = layer_ind

    def forward(self, x, batch):
        return closest_pool(x, batch.upsamples[self.layer_ind - 1])


class KPFCN(nn.Module):
    """Encoder/decoder kernel-point FCN; ``forward`` returns coarse features."""

    def __init__(self, cfg: KPFCNConfig):
        super().__init__()
        self.cfg = cfg
        arch = cfg.architecture
        layer = 0
        r = cfg.first_subsampling_dl * cfg.conv_radius
        in_dim, out_dim = cfg.in_feats_dim, cfg.first_feats_dim

        encoder, skip_dims, skips = [], [], []
        for bi, block in enumerate(arch):
            if any(k in block for k in ("pool", "strided", "upsample", "global")):
                skips.append(bi)
                skip_dims.append(in_dim)
            if "upsample" in block:
                break
            strided, deform = "strided" in block, "deform" in block
            if "simple" in block:
                encoder.append(SimpleBlock(in_dim, out_dim, r, layer, strided, cfg, deform))
            elif "resnetb" in block:
                encoder.append(ResnetBottleneckBlock(in_dim, out_dim, r, layer, strided, cfg,
                                                     deform))
            else:
                raise ValueError(block)
            in_dim = out_dim // 2 if "simple" in block else out_dim
            if "pool" in block or "strided" in block:
                layer += 1
                r *= 2
                out_dim *= 2
        self.encoder_blocks = nn.ModuleList(encoder)
        self.encoder_skips = tuple(skips)
        bottleneck_dim = in_dim

        decoder, concats = [], []
        start = next(i for i, b in enumerate(arch) if "upsample" in b)
        coarse_dim = None
        for bi, block in enumerate(arch[start:]):
            if bi > 0 and "upsample" in arch[start + bi - 1]:
                in_dim += skip_dims[layer]
                concats.append(bi)
            if block == "unary":
                decoder.append(UnaryBlock(in_dim, out_dim, level=layer,
                                          use_bn=cfg.use_batch_norm))
            elif "upsample" in block:
                decoder.append(NearestUpsampleBlock(layer))
            else:
                raise ValueError(block)
            in_dim = out_dim
            if bi == 1:
                coarse_dim = out_dim
            if "upsample" in block:
                layer -= 1
                out_dim //= 2
        self.decoder_blocks = nn.ModuleList(decoder)
        self.decoder_concats = tuple(concats)

        # 1x1 Conv1d heads (weight [out, in, 1]) as in the reference checkpoints
        self.coarse_out = nn.Conv1d(coarse_dim, cfg.coarse_feature_dim, 1, bias=True)
        self.coarse_in = nn.Conv1d(cfg.coarse_feature_dim, bottleneck_dim // 2, 1, bias=True)
        self.fine_out = nn.Conv1d(in_dim, cfg.fine_feature_dim, 1, bias=True)

    def forward(self, batch):
        """Coarse phase: a PairBatch on the model's device -> [B, N_coarse,
        coarse_feature_dim]. (The fine phase is not ported.)"""
        x = batch.features
        skips = []
        for bi, block in enumerate(self.encoder_blocks):
            if bi in self.encoder_skips:
                skips.append(x)
            x = block(x, batch)
        for bi, block in enumerate(self.decoder_blocks[:2]):
            if bi in self.decoder_concats:
                x = torch.cat([x, skips.pop()], dim=-1)
            if isinstance(block, UnaryBlock):
                x = block(x, batch.masks[block.level])
            else:
                x = block(x, batch)
        w = self.coarse_out.weight[:, :, 0]
        return F.linear(x, w, self.coarse_out.bias)
