"""The rest of vision3d's layer library: Vector Neurons, PointNet / PointNet++
convolutions, a residual conv block, EdgeConv, feature propagation and
X-Conv (vision3d/layers/{vector_neurons,pointnet,pointnet2,residual_block,
edge_conv,feature_propagate,xconv}.py).

Counterpart of the JAX package's zoo/layers_library.py, in its layouts:
ordinary features are channel-last [B, N, C]; Vector-Neuron features are
[B, N, C, 3], the 3-vector axis last, and their linear maps act on the
channel axis only (SO(3) equivariance exact); the VN batch norm takes its
statistics over the batch and points (no running statistics). The residual
conv block is NCHW, as the port's image layers are. Submodules and
parameters carry the JAX package's names.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers2d3d import leaky2d3d, optimal_groups
from ..ops.topk import stable_top_k
from ..utils.precision import pin_float32
from .pointnets import _linear_stack, _run_linear_stack, group_gather

EPS = 1e-6


class VNLinear(nn.Module):
    """Channel-mixing linear map of VN features [..., C_in, 3] -> [..., C_out,
    3]; ``kernel`` [C_in, C_out] (the JAX package's layout)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.randn(in_channels, out_channels) / math.sqrt(in_channels))

    def forward(self, x):
        return torch.einsum("...cv,cd->...dv", x, self.kernel)


def _vn_leaky(p, d, negative_slope):
    """Direction-gated leaky ReLU: the part of p anti-aligned with the learned
    direction d is reflected."""
    dot = torch.sum(p * d, dim=-1, keepdim=True)
    d_norm_sq = torch.sum(d * d, dim=-1, keepdim=True)
    mask = (dot >= 0).to(p.dtype)
    reflected = p - (dot / (d_norm_sq + EPS)) * d
    return negative_slope * p + (1 - negative_slope) * (mask * p + (1 - mask) * reflected)


class VNLeakyReLU(nn.Module):
    def __init__(self, in_channels: int, share_nonlinearity: bool = False,
                 negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope
        self.map_to_dir = VNLinear(in_channels, 1 if share_nonlinearity else in_channels)

    def forward(self, x):
        return _vn_leaky(x, self.map_to_dir(x), self.negative_slope)


class VNBatchNorm(nn.Module):
    """Normalises each channel's vector length over the batch and point axes
    (biased variance, eps 1e-5, affine ``scale`` / ``bias``), keeping its
    direction."""

    def __init__(self, num_features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        norm = torch.linalg.norm(x, dim=-1) + EPS                      # [B, N, C]
        dims = tuple(range(norm.ndim - 1))
        mu = norm.mean(dim=dims, keepdim=True)
        var = norm.var(dim=dims, keepdim=True, unbiased=False)
        norm_bn = (norm - mu) / torch.sqrt(var + 1e-5) * self.scale + self.bias
        return x / norm[..., None] * norm_bn[..., None]


class VNLinearLeakyReLU(nn.Module):
    """VN linear map, VN batch norm, direction-gated leaky ReLU."""

    def __init__(self, in_channels: int, out_channels: int, share_nonlinearity: bool = False,
                 negative_slope: float = 0.2, use_norm: bool = True):
        super().__init__()
        self.negative_slope = negative_slope
        self.map_to_feat = VNLinear(in_channels, out_channels)
        self.batch_norm = VNBatchNorm(out_channels) if use_norm else None
        self.map_to_dir = VNLinear(in_channels, 1 if share_nonlinearity else out_channels)

    def forward(self, x):
        p = self.map_to_feat(x)
        if self.batch_norm is not None:
            p = self.batch_norm(p)
        return _vn_leaky(p, self.map_to_dir(x), self.negative_slope)


class VNMaxPool(nn.Module):
    """Per channel, the neighbour whose vector lies furthest along a learned
    direction: [B, N, K, C, 3] -> [B, N, C, 3]."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.map_to_dir = VNLinear(in_channels, in_channels)

    def forward(self, x):
        dot = torch.sum(x * self.map_to_dir(x), dim=-1)                # [B, N, K, C]
        idx = dot.argmax(dim=-2)                                       # [B, N, C]
        index = idx[..., None, :, None].expand(*idx.shape[:-1], 1, idx.shape[-1], x.shape[-1])
        return torch.gather(x, -3, index)[..., 0, :, :]


class VNStdFeature(nn.Module):
    """Equivariant-to-invariant head: a frame z0 learned from the features and
    x expressed in it. Returns (x_std, z0)."""

    def __init__(self, in_channels: int, normalize_frame: bool = False,
                 share_nonlinearity: bool = False, negative_slope: float = 0.2):
        super().__init__()
        self.normalize_frame = normalize_frame
        self.vn1 = VNLinearLeakyReLU(in_channels, in_channels // 2, share_nonlinearity,
                                     negative_slope)
        self.vn2 = VNLinearLeakyReLU(in_channels // 2, in_channels // 4, share_nonlinearity,
                                     negative_slope)
        self.vn_lin = VNLinear(in_channels // 4, 2 if normalize_frame else 3)

    def forward(self, x):
        z0 = self.vn_lin(self.vn2(self.vn1(x)))                        # [..., frame, 3]
        if self.normalize_frame:
            v1 = z0[..., 0, :]
            u1 = v1 / (torch.linalg.norm(v1, dim=-1, keepdim=True) + EPS)
            v2 = z0[..., 1, :]
            v2 = v2 - torch.sum(v2 * u1, dim=-1, keepdim=True) * u1
            u2 = v2 / (torch.linalg.norm(v2, dim=-1, keepdim=True) + EPS)
            z0 = torch.stack([u1, u2, torch.linalg.cross(u1, u2, dim=-1)], dim=-2)
        return torch.einsum("...cv,...kv->...ck", x, z0), z0


class PNConv(nn.Module):
    """PointNet conv: a local shared MLP over [B, N, K, C], max over K, a
    global shared MLP, optionally L2-normalised."""

    def __init__(self, input_dim: int, local_dims: Sequence[int], global_dims: Sequence[int],
                 normalize: bool = False):
        super().__init__()
        self.n_local, self.n_global, self.normalize = len(local_dims), len(global_dims), normalize
        d = _linear_stack(self, "local", "local_norm", input_dim, local_dims)
        _linear_stack(self, "global", "global_norm", d, global_dims)

    def forward(self, group_feats):
        x = _run_linear_stack(self, "local", "local_norm", self.n_local, group_feats)
        x = _run_linear_stack(self, "global", "global_norm", self.n_global, x.amax(dim=-2))
        if self.normalize:
            x = x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-12)
        return x


class SAConv(nn.Module):
    """PointNet++ set-abstraction conv: shared MLP over [neighbour features ++
    centred offsets], max over K. q_points [B, M, 3], s_points / s_feats
    [B, N, 3 / input_dim] (``input_dim`` 0 without features), neighbour
    indices [B, M, K]."""

    def __init__(self, input_dim: int, output_dims: Sequence[int]):
        super().__init__()
        self.n = len(output_dims)
        _linear_stack(self, "mlp", "norm", input_dim + 3, output_dims)

    def forward(self, q_points, s_points, s_feats, neighbor_indices):
        x = group_gather(s_points, neighbor_indices) - q_points[:, :, None, :]
        if s_feats is not None:
            x = torch.cat([group_gather(s_feats, neighbor_indices), x], dim=-1)
        return _run_linear_stack(self, "mlp", "norm", self.n, x).amax(dim=2)


class GSAConv(nn.Module):
    """Global set abstraction: shared MLP over [features ++ points], global
    max -> [B, C]."""

    def __init__(self, input_dim: int, output_dims: Sequence[int]):
        super().__init__()
        self.n = len(output_dims)
        _linear_stack(self, "mlp", "norm", input_dim + 3, output_dims)

    def forward(self, points, feats, mask=None):
        x = points if feats is None else torch.cat([feats, points], dim=-1)
        x = _run_linear_stack(self, "mlp", "norm", self.n, x)
        if mask is not None:
            x = torch.where(mask[..., None], x, torch.full_like(x, -1e10))
        return x.amax(dim=1)


class BasicConvResBlock(nn.Module):
    """Two-conv residual block (conv with bias, GroupNorm with vision3d's
    groups, LeakyReLU 0.2), the shortcut projected by a strided conv where the
    stride or width changes; NCHW."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1):
        super().__init__()
        pin_float32()
        p, g = kernel_size // 2, optimal_groups(out_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, kernel_size, stride, p)
        self.conv1_norm = nn.GroupNorm(g, out_channels, eps=1e-5)
        self.conv2 = nn.Conv2d(out_channels, out_channels, kernel_size, 1, p)
        self.conv2_norm = nn.GroupNorm(g, out_channels, eps=1e-5)
        if stride > 1 or in_channels != out_channels:
            self.identity = nn.Conv2d(in_channels, out_channels, kernel_size, stride, p)
            self.identity_norm = nn.GroupNorm(g, out_channels, eps=1e-5)
        else:
            self.identity = None

    def forward(self, x):
        res = leaky2d3d(self.conv1_norm(self.conv1(x)))
        res = self.conv2_norm(self.conv2(res))
        identity = x if self.identity is None else self.identity_norm(self.identity(x))
        return leaky2d3d(identity + res)


class EdgeConv(nn.Module):
    """DGCNN edge conv: shared MLP over [x ++ (neighbour - x)], max over the
    neighbours (masked neighbours left out). ``input_dim``: the features'
    width."""

    def __init__(self, input_dim: int, output_dims: Sequence[int]):
        super().__init__()
        self.n = len(output_dims)
        _linear_stack(self, "mlp", "norm", 2 * input_dim, output_dims)

    def forward(self, q_feats, s_feats, neighbor_indices, neighbor_masks=None):
        nbr = group_gather(s_feats, neighbor_indices)                   # [B, M, K, C]
        q = q_feats[:, :, None, :].expand_as(nbr)
        x = _run_linear_stack(self, "mlp", "norm", self.n, torch.cat([q, nbr - q], dim=-1))
        if neighbor_masks is not None:
            x = torch.where(neighbor_masks[..., None], x, torch.full_like(x, -1e10))
        return x.amax(dim=2)


class FeaturePropagate(nn.Module):
    """PointNet++ feature propagation: 3-NN inverse-distance interpolation of
    the support features at the queries, [query features ++ interpolated],
    shared MLP. ``input_dim``: the MLP's input width."""

    def __init__(self, input_dim: int, output_dims: Sequence[int]):
        super().__init__()
        self.n = len(output_dims)
        _linear_stack(self, "mlp", "norm", input_dim, output_dims)

    def forward(self, q_points, s_points, q_feats, s_feats):
        d2 = torch.sum((q_points[:, :, None, :] - s_points[:, None, :, :]) ** 2, dim=-1)
        negd, idx = stable_top_k(-d2, 3)
        w = 1.0 / (torch.sqrt((-negd).clamp_min(1e-12)) + 1e-5)
        w = w / torch.sum(w, dim=-1, keepdim=True)
        interp = torch.sum(group_gather(s_feats, idx) * w[..., None], dim=2)
        x = interp if q_feats is None else torch.cat([q_feats, interp], dim=-1)
        return _run_linear_stack(self, "mlp", "norm", self.n, x)


class XConv(nn.Module):
    """PointCNN X-Conv as the JAX package builds it: lifted neighbour offsets
    (two Linear / ELU / LayerNorm layers) joined to the neighbour features, a
    K x K transform from the flattened offsets, a Linear over the mixed K
    rows, optionally a global branch on the query points. ``input_dim``: the
    width of ``s_feats`` (0 without)."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int, kernel_size: int,
                 with_global: bool = False):
        super().__init__()
        k = kernel_size
        self.kernel_size, self.with_global = k, with_global
        self._mlp2_layers("f_mlp", 3, (hidden_dim, hidden_dim))
        self._mlp2_layers("x_mlp", 3 * k, (k * k, k * k))
        self.x_out = nn.Linear(k * k, k * k, bias=False)
        self.conv = nn.Linear(k * (hidden_dim + input_dim), output_dim, bias=False)
        self.conv_norm = nn.LayerNorm(output_dim, eps=1e-5)
        if with_global:
            self._mlp2_layers("g_mlp", 3, (output_dim // 4,) * 2)

    def _mlp2_layers(self, name, in_dim, dims):
        for i, d in enumerate(dims):
            self.add_module(f"{name}{i}", nn.Linear(in_dim, d))
            self.add_module(f"{name}_norm{i}", nn.LayerNorm(d, eps=1e-5))
            in_dim = d

    def _mlp2(self, x, name):
        for i in range(2):
            x = getattr(self, f"{name}_norm{i}")(F.elu(getattr(self, f"{name}{i}")(x)))
        return x

    def forward(self, q_points, s_points, s_feats, neighbor_indices):
        k = self.kernel_size
        aligned = group_gather(s_points, neighbor_indices) - q_points[:, :, None, :]
        feats = self._mlp2(aligned, "f_mlp")                           # [B, M, K, H]
        if s_feats is not None:
            feats = torch.cat([group_gather(s_feats, neighbor_indices), feats], dim=-1)
        b, m = aligned.shape[:2]
        xt = self.x_out(self._mlp2(aligned.reshape(b, m, k * 3), "x_mlp")).reshape(b, m, k, k)
        mixed = torch.einsum("bmkj,bmjc->bmkc", xt, feats)
        out = self.conv_norm(F.elu(self.conv(mixed.reshape(b, m, -1))))
        if self.with_global:
            out = torch.cat([out, self._mlp2(q_points, "g_mlp")], dim=-1)
        return out
