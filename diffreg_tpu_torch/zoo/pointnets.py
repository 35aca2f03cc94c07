"""PointNet, PointNet++, PointTransformer, PAT and FoldingNet families
(vision3d/models/{pointnet,pointnet2,point_transformer,pat,foldingnet}).

Counterpart of the JAX package's zoo/pointnets.py, in its layout: features
are channel-last [B, N, C], the reference's kernel-size-1 Conv1d stacks are
Linear layers, neighbourhoods are dense batched kNN / ball queries over one
distance table, and the reference's BatchNorm1d has the JAX package's
normalisation twins (LayerNorm over the channels; GroupNorm in PAT).
Submodules carry the JAX package's names (``local0``, ``local_norm0``,
``set_abstract``, ``mlp0``, ``norm0``, ...), so that its weights map by name
(``convert.zoo_state_dict_from_flax``). PyTorch needs each layer's input
width at construction, so the constructors take it where JAX infers it.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.sampling import farthest_point_sampling
from ..ops.topk import stable_top_k
from ..ops.vision import pairwise_distance
from ..utils.draws import as_draws


# ---------------------------------------------------------------------------
# shared batched neighbourhood helpers


def batched_knn(queries, supports, k: int, exclude_self: bool = False):
    """[B, N, 3] x [B, M, 3] -> neighbour indices [B, N, k], nearest first
    (ties to the lower index, as ``jax.lax.top_k``)."""
    d = pairwise_distance(queries, supports, squared=True)
    if exclude_self:
        n, m = d.shape[-2:]
        d = d + torch.eye(n, m, dtype=d.dtype, device=d.device) * 1e10
    return stable_top_k(-d, k)[1]


def batched_ball_query(queries, supports, k: int, radius: float):
    """The k nearest supports within ``radius``; slots past the ball repeat
    the nearest index (pointnet2's ball_query, the same set)."""
    d = pairwise_distance(queries, supports, squared=True)
    negd, idx = stable_top_k(-d, k)
    within = (-negd) <= radius * radius
    return torch.where(within, idx, idx[..., :1])


def group_gather(feats, indices):
    """feats [B, M, C] gathered by indices [B, N, k] -> [B, N, k, C] (one
    ``index_select`` over the flattened batch)."""
    b, m, c = feats.shape
    rows = indices.long() + torch.arange(b, device=feats.device).reshape(
        (b,) + (1,) * (indices.ndim - 1)) * m
    return feats.reshape(b * m, c).index_select(0, rows.reshape(-1)).reshape(*indices.shape, c)


def batched_fps(points, num_samples: int, valid=None):
    """Farthest point sampling of each cloud of points [B, N, 3] ->
    indices [B, S] (``ops.sampling.farthest_point_sampling`` per cloud)."""
    if valid is None:
        valid = torch.ones(points.shape[:2], dtype=torch.bool, device=points.device)
    return torch.stack([farthest_point_sampling(p, v, num_samples)[0]
                        for p, v in zip(points, valid)]).long()


def _linear_stack(module, prefix, norm_prefix, in_dim, dims):
    """Register ``{prefix}{i}`` Linear (no bias) and ``{norm_prefix}{i}``
    LayerNorm (eps 1e-5) layers on ``module``; returns the last width."""
    for i, d in enumerate(dims):
        module.add_module(f"{prefix}{i}", nn.Linear(in_dim, d, bias=False))
        module.add_module(f"{norm_prefix}{i}", nn.LayerNorm(d, eps=1e-5))
        in_dim = d
    return in_dim


def _run_linear_stack(module, prefix, norm_prefix, n, x):
    """Linear -> LayerNorm -> ReLU through the layers ``_linear_stack`` made."""
    for i in range(n):
        x = F.relu(getattr(module, f"{norm_prefix}{i}")(getattr(module, f"{prefix}{i}")(x)))
    return x


# ---------------------------------------------------------------------------
# PointNet (vision3d/models/pointnet/modules.py)


class TNet(nn.Module):
    """Spatial / feature transform regressor: points [B, N, input_dim] ->
    transforms [B, input_dim, input_dim]; the last affine map starts at a
    zero weight and an identity bias, as the reference's."""

    def __init__(self, input_dim: int, local_dims: Sequence[int], global_dims: Sequence[int]):
        super().__init__()
        self.input_dim = input_dim
        self.n_local, self.n_global = len(local_dims), len(global_dims)
        d = _linear_stack(self, "local", "local_norm", input_dim, local_dims)
        d = _linear_stack(self, "global", "global_norm", d, global_dims)
        self.weight = nn.Parameter(torch.zeros(d, input_dim * input_dim))
        self.bias = nn.Parameter(torch.eye(input_dim).reshape(-1))

    def forward(self, points, mask=None):
        x = _run_linear_stack(self, "local", "local_norm", self.n_local, points)
        if mask is not None:
            x = torch.where(mask[..., None], x, torch.full_like(x, -1e10))
        x = x.amax(dim=1)
        x = _run_linear_stack(self, "global", "global_norm", self.n_global, x)
        t = x @ self.weight + self.bias
        return t.reshape(-1, self.input_dim, self.input_dim)


def tnet_loss(transforms):
    """|| I - T T^T ||^2 / 2 summed over the batch."""
    eye = torch.eye(transforms.shape[-1], dtype=transforms.dtype, device=transforms.device)
    delta = eye - transforms @ transforms.transpose(-1, -2)
    return torch.sum(delta ** 2) / 2.0


def pointnet_loss(outputs, labels, transforms, alpha: float = 0.001,
                  label_smoothing_eps: Optional[float] = None):
    """Classification (cross-entropy, or label-smoothed) plus ``alpha`` times
    the TNet regulariser; outputs [B, C] or [B, C, *] logits. Returns (total,
    classification, regulariser)."""
    from ..engine.loss_library import smooth_cross_entropy_loss

    if outputs.ndim == 2:
        outputs, labels = outputs[..., None], labels[..., None]
    if label_smoothing_eps is None:
        logp = F.log_softmax(outputs, dim=1)
        one_hot = F.one_hot(labels.long(), outputs.shape[1]).movedim(-1, 1).to(logp.dtype)
        cls = -torch.mean(torch.sum(one_hot * logp, dim=1))
    else:
        cls = smooth_cross_entropy_loss(outputs, labels, eps=label_smoothing_eps)
    reg = alpha * tnet_loss(transforms)
    return cls + reg, cls, reg


# ---------------------------------------------------------------------------
# PointNet++ (vision3d/models/pointnet2/modules.py, layers SAConv / GSAConv)


class _SharedMLP(nn.Module):
    """Linear (no bias) -> LayerNorm -> ReLU per width of ``dims``."""

    def __init__(self, in_dim: int, dims: Sequence[int]):
        super().__init__()
        self.n = len(dims)
        _linear_stack(self, "mlp", "norm", in_dim, dims)

    def forward(self, x):
        return _run_linear_stack(self, "mlp", "norm", self.n, x)


class SetAbstractionModule(nn.Module):
    """FPS -> ball query -> shared MLP over [centred offsets ++ features] ->
    max pool. ``input_dim``: the width of ``s_feats`` (0 when none)."""

    def __init__(self, input_dim: int, output_dims: Sequence[int], num_centroids: int,
                 num_samples: int, radius: float):
        super().__init__()
        self.num_centroids, self.num_samples, self.radius = num_centroids, num_samples, radius
        self.set_abstract = _SharedMLP(3 + input_dim, output_dims)

    def forward(self, s_points, s_feats=None):
        idx = batched_fps(s_points, self.num_centroids)
        q_points = group_gather(s_points, idx[..., None])[:, :, 0]          # [B, S, 3]
        nbr = batched_ball_query(q_points, s_points, self.num_samples, self.radius)
        x = group_gather(s_points, nbr) - q_points[:, :, None, :]
        if s_feats is not None:
            x = torch.cat([x, group_gather(s_feats, nbr)], dim=-1)
        return q_points, self.set_abstract(x).amax(dim=2)


class MultiScaleSetAbstractionModule(nn.Module):
    """Multi-scale grouping: one (radius, num_samples, output_dims) branch per
    entry of ``ssg_cfgs`` over the same centroids, concatenated."""

    def __init__(self, input_dim: int, num_centroids: int, ssg_cfgs: Tuple[dict, ...]):
        super().__init__()
        self.num_centroids, self.ssg_cfgs = num_centroids, tuple(ssg_cfgs)
        for i, cfg in enumerate(self.ssg_cfgs):
            self.add_module(f"ssg{i}", _SharedMLP(3 + input_dim, cfg["output_dims"]))

    def forward(self, s_points, s_feats=None):
        idx = batched_fps(s_points, self.num_centroids)
        q_points = group_gather(s_points, idx[..., None])[:, :, 0]
        outs = []
        for i, cfg in enumerate(self.ssg_cfgs):
            nbr = batched_ball_query(q_points, s_points, cfg["num_samples"], cfg["radius"])
            x = group_gather(s_points, nbr) - q_points[:, :, None, :]
            if s_feats is not None:
                x = torch.cat([x, group_gather(s_feats, nbr)], dim=-1)
            outs.append(getattr(self, f"ssg{i}")(x).amax(dim=2))
        return q_points, torch.cat(outs, dim=-1)


class GlobalAbstractionModule(nn.Module):
    """Shared MLP over [points ++ features], then the global max -> [B, 1, C]."""

    def __init__(self, input_dim: int, output_dims: Sequence[int]):
        super().__init__()
        self.global_abstract = _SharedMLP(3 + input_dim, output_dims)

    def forward(self, points, feats=None, mask=None):
        x = points if feats is None else torch.cat([points, feats], dim=-1)
        x = self.global_abstract(x)
        if mask is not None:
            x = torch.where(mask[..., None], x, torch.full_like(x, -1e10))
        return x.amax(dim=1, keepdim=True)


# ---------------------------------------------------------------------------
# PointTransformer (vision3d/models/point_transformer/modules.py)


class PointTransformerLayer(nn.Module):
    """Vector attention over kNN neighbourhoods: softmax over the neighbours
    of an MLP of (k - q + delta), values v + delta, delta an MLP of the
    relative positions. ``input_dim``: the features' width (default
    ``feature_dim``)."""

    def __init__(self, feature_dim: int, input_dim: Optional[int] = None):
        super().__init__()
        c = feature_dim if input_dim is None else input_dim
        self.position_encoding0 = nn.Linear(3, feature_dim)
        self.position_encoding1 = nn.Linear(feature_dim, feature_dim)
        self.k_layer = nn.Linear(c, feature_dim)
        self.q_layer = nn.Linear(c, feature_dim)
        self.v_layer = nn.Linear(c, feature_dim)
        self.attention_encoding0 = nn.Linear(feature_dim, feature_dim)
        self.attention_encoding1 = nn.Linear(feature_dim, feature_dim)

    def forward(self, feats, grouped_feats, points, grouped_points):
        delta = self.position_encoding1(F.relu(self.position_encoding0(
            points[:, :, None, :] - grouped_points)))
        k = self.k_layer(feats)[:, :, None, :]
        q = self.q_layer(grouped_feats)
        v = self.v_layer(grouped_feats) + delta
        scores = torch.softmax(self.attention_encoding1(F.relu(self.attention_encoding0(
            k - q + delta))), dim=2)
        return torch.sum(scores * v, dim=2)


class PointTransformerBlock(nn.Module):
    """Residual PointTransformer block over ``num_neighbors``-NN; features
    [B, N, output_dim] in and out."""

    def __init__(self, output_dim: int, hidden_dim: int, num_neighbors: int):
        super().__init__()
        self.num_neighbors = num_neighbors
        self.r_layer = nn.Linear(output_dim, hidden_dim)
        self.point_transformer = PointTransformerLayer(hidden_dim)
        self.e_layer = nn.Linear(hidden_dim, output_dim)

    def forward(self, feats, points):
        x = self.r_layer(feats)
        idx = batched_knn(points, points, self.num_neighbors)
        x = self.point_transformer(x, group_gather(x, idx), points, group_gather(points, idx))
        return self.e_layer(x) + feats, points


class TransitionDownBlock(nn.Module):
    """Two Linear/LayerNorm/ReLU layers -> FPS of ceil(N / ratio) centroids ->
    mean over each centroid's kNN."""

    def __init__(self, input_dim: int, output_dim: int, downsample_ratio: int,
                 num_neighbors: int):
        super().__init__()
        self.downsample_ratio, self.num_neighbors = downsample_ratio, num_neighbors
        _linear_stack(self, "transition", "norm", input_dim, (output_dim, output_dim))

    def forward(self, feats, points):
        x = _run_linear_stack(self, "transition", "norm", 2, feats)
        num_sample = -(-points.shape[1] // self.downsample_ratio)
        idx = batched_fps(points, num_sample)
        centroids = group_gather(points, idx[..., None])[:, :, 0]
        nbr = batched_knn(centroids, points, self.num_neighbors)
        return group_gather(x, nbr).mean(dim=2), centroids


# ---------------------------------------------------------------------------
# PAT (vision3d/models/pat/modules.py)


def _group_norm_last(x, norm: nn.GroupNorm):
    """GroupNorm of channel-last x [B, ..., C] (statistics over every
    non-batch axis of a group, as flax's GroupNorm takes them)."""
    return norm(x.movedim(-1, 1)).movedim(1, -1)


class _PATBlocks(nn.Module):
    """Linear (no bias) -> GroupNorm(groups) -> ELU per width of ``dims``."""

    def __init__(self, in_dim: int, dims: Sequence[int], groups: int = 8):
        super().__init__()
        self.n = len(dims)
        for i, d in enumerate(dims):
            self.add_module(f"fc{i + 1}", nn.Linear(in_dim, d, bias=False))
            self.add_module(f"gn{i + 1}", nn.GroupNorm(groups, d, eps=1e-5))
            in_dim = d

    def forward(self, x):
        for i in range(1, self.n + 1):
            x = F.elu(_group_norm_last(getattr(self, f"fc{i}")(x), getattr(self, f"gn{i}")))
        return x


class AbsoluteRelativePositionEmbedding(nn.Module):
    """ARPE: the kNN graph's [x ++ (neighbour - x)] -> ``pointnet1`` -> max
    over the neighbours -> ``pointnet2``. In training every ``dilation``-th
    neighbour is kept, at eval all past the nearest."""

    def __init__(self, output_dims1: Sequence[int], output_dims2: Sequence[int],
                 num_neighbor: int, dilation: int = 1, ignore_nearest: bool = True):
        super().__init__()
        self.num_neighbor, self.dilation, self.ignore_nearest = (num_neighbor, dilation,
                                                                 ignore_nearest)
        self.pointnet1 = _PATBlocks(6, output_dims1)
        self.pointnet2 = _PATBlocks(output_dims1[-1], output_dims2)

    def forward(self, points, training: bool = True):
        k_dilated = self.num_neighbor * self.dilation + int(self.ignore_nearest)
        idx = batched_knn(points, points, k_dilated)
        start = 1 if self.ignore_nearest else 0
        idx = idx[:, :, start::self.dilation] if training else idx[:, :, start:]
        nbrs = group_gather(points, idx)
        x = torch.cat([points[:, :, None, :].expand_as(nbrs), nbrs - points[:, :, None, :]],
                      dim=-1)
        return self.pointnet2(self.pointnet1(x).amax(dim=2))


class GroupShuffleAttention(nn.Module):
    """GSA: a grouped linear transform, scaled-dot attention inside each group
    (softmax over the query axis, values ELU(x)), the channel shuffle, the
    residual and a GroupNorm."""

    def __init__(self, feature_dim: int, groups: int):
        super().__init__()
        self.groups = groups
        cg = feature_dim // groups
        self.transform = nn.Parameter(torch.empty(groups, cg, cg))
        self.transform_bias = nn.Parameter(torch.zeros(groups, cg))
        nn.init.normal_(self.transform, std=cg ** -0.5)
        self.gn = nn.GroupNorm(groups, feature_dim, eps=1e-5)

    def forward(self, feats):
        b, n, c = feats.shape
        g = self.groups
        cg = c // g
        x = torch.einsum("bngc,gcd->bngd", feats.reshape(b, n, g, cg), self.transform) \
            + self.transform_bias
        x = x.permute(0, 2, 1, 3)                                     # [B, g, N, cg]
        att = torch.einsum("bgnc,bgmc->bgnm", x, x) / math.sqrt(cg)
        att = torch.softmax(att, dim=-2)
        out = torch.einsum("bgnm,bgnc->bgmc", att, F.elu(x))
        # the reference flattens (cg, g) in that order: the groups interleave
        out = out.permute(0, 2, 3, 1).reshape(b, n, c) + feats
        return _group_norm_last(out, self.gn)


class GumbelSubsetSampling(nn.Module):
    """GSS: soft Gumbel-softmax selection of ``num_sample`` points in
    training (``rng``: a ``torch.Generator`` or a draw source, drawn once),
    the hard argmax one-hot at eval."""

    def __init__(self, input_dim: int, num_sample: int, tau: float = 1.0):
        super().__init__()
        self.tau = tau
        self.layer = nn.Linear(input_dim, num_sample)

    def forward(self, feats, rng=None, training: bool = True):
        w = self.layer(feats).transpose(1, 2)                         # [B, S, N]
        if training:
            if rng is None:
                raise ValueError("GumbelSubsetSampling needs an rng in training")
            g = as_draws(rng).gumbel(w.shape, w.dtype)
            w = torch.softmax((w + g) / self.tau, dim=-1)
        else:
            w = F.one_hot(w.argmax(dim=-1), w.shape[-1]).to(w.dtype)
        return torch.einsum("bsn,bnc->bsc", w, feats)


class AttentionSubsetSampling(nn.Module):
    """Softmax pooling of the points into ``num_sample`` slots."""

    def __init__(self, input_dim: int, num_sample: int):
        super().__init__()
        self.layer = nn.Linear(input_dim, num_sample)

    def forward(self, feats):
        w = torch.softmax(self.layer(feats).transpose(1, 2), dim=-1)
        return torch.einsum("bsn,bnc->bsc", w, feats)


# ---------------------------------------------------------------------------
# FoldingNet (vision3d/models/foldingnet/foldingnet.py)


class FoldingNet(nn.Module):
    """Two folds of a steps x steps grid in [-1, 1]^2, each an MLP (Linear,
    LayerNorm, ReLU twice, then Linear to 3) conditioned on the global code
    [B, input_dim] -> points [B, steps^2, 3]."""

    def __init__(self, input_dim: int, hidden_dim: int, steps: int):
        super().__init__()
        self.input_dim, self.steps = input_dim, steps
        for name, seed_dim in (("grid_to_points", 2), ("refine_points", 3)):
            dims = ((seed_dim + input_dim, hidden_dim), (hidden_dim, hidden_dim // 2),
                    (hidden_dim // 2, 3))
            for i, (a, b) in enumerate(dims):
                self.add_module(f"{name}{i}", nn.Linear(a, b))
                if i < 2:
                    self.add_module(f"{name}_norm{i}", nn.LayerNorm(b, eps=1e-5))

    def _fold(self, x, name):
        for i in range(2):
            x = F.relu(getattr(self, f"{name}_norm{i}")(getattr(self, f"{name}{i}")(x)))
        return getattr(self, f"{name}2")(x)

    def forward(self, global_feats):
        b, f = global_feats.shape[0], self.steps * self.steps
        lin = torch.from_numpy(np.linspace(-1.0, 1.0, self.steps, dtype=np.float32)).to(
            device=global_feats.device, dtype=global_feats.dtype)
        seeds = torch.stack([lin.repeat_interleave(self.steps), lin.repeat(self.steps)], dim=-1)
        seeds = seeds.expand(b, f, 2)
        feats = global_feats[:, None, :].expand(b, f, self.input_dim)
        points = self._fold(torch.cat([seeds, feats], dim=-1), "grid_to_points")
        return self._fold(torch.cat([points, feats], dim=-1), "refine_points")
