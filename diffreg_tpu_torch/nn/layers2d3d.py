"""Layers of the 2D-3D branch: Fourier embedding, vision3d's GroupNorm and
transformer layer (post-norm attention + FFN), and the image ConvBlock.

Counterpart of the JAX package's nn/layers2d3d.py, with the reference's
module names (vision3d transformer.py, conv_block.py), so that reference
weights map by name. Masks are True where valid.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import masked_attention
from ..ops.masked import NEG_INF
from ..utils.precision import matmul_precision


def fourier_embedding(x, length: int):
    """[x, sin(2^k x), cos(2^k x) for k < length]: per frequency, the sines of
    every coordinate then their cosines. x [..., N] -> [..., (2L+1)N]."""
    n = x.shape[-1]
    factors = torch.from_numpy(2.0 ** np.arange(length, dtype=np.float32)).to(x.device)
    thetas = x.reshape(-1, 1, n) * factors.reshape(1, -1, 1)
    emb = torch.cat([torch.sin(thetas), torch.cos(thetas)], dim=-1)
    return torch.cat([x, emb.reshape(x.shape[:-1] + (2 * length * n,))], dim=-1)


def leaky2d3d(x):
    """vision3d's LeakyReLU (slope 0.2), not the 3DMatch KPFCN's 0.1."""
    return F.leaky_relu(x, negative_slope=0.2)


class _ReLU(torch.autograd.Function):
    """ReLU with jax.nn.relu's derivative: the gradient passes where x > 0 and
    is 0 elsewhere, at a NaN x too (torch's relu passes a NaN x's gradient
    on). A non-finite train step then zeroes the same gradient entries in both
    packages. relu(x) > 0 exactly where x > 0 (relu(NaN) is NaN), so the
    output is what the backward keeps, as torch's relu keeps it."""

    @staticmethod
    def forward(ctx, x):
        out = torch.relu(x)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        (out,) = ctx.saved_tensors
        return torch.where(out > 0, grad, torch.zeros_like(grad))


def optimal_groups(num_channels: int) -> int:
    """vision3d's GroupNorm groups: at most 32, at least 8 channels a group,
    dividing the channels; 1 when nothing fits (tiny test widths)."""
    g = 32
    while g > 1:
        if num_channels % g == 0 and num_channels // g >= 8:
            return g
        g //= 2
    return 1


class GroupNormPack(nn.Module):
    """Masked affine GroupNorm over packed points (vision3d GroupNormPackMode):
    the statistics pool a group's channels and every valid point of the pair;
    padded rows are left out of them and zeroed on output. The affine lives in
    ``norm`` (an nn.GroupNorm, the reference's parameter names)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.norm = nn.GroupNorm(optimal_groups(dim), dim, eps=eps)

    def forward(self, x, mask):
        """x [B, N, C], mask [B, N] bool."""
        b, n, c = x.shape
        g = self.norm.num_groups
        xg = x.reshape(b, n, g, c // g)
        m = mask[:, :, None, None].to(x.dtype)
        denom = (mask.sum(dim=1).clamp_min(1).to(x.dtype) * (c // g))[:, None]   # [B, 1]
        mu = torch.sum(xg * m, dim=(1, 3)) / denom                                # [B, g]
        var = torch.sum(((xg - mu[:, None, :, None]) ** 2) * m, dim=(1, 3)) / denom
        y = (xg - mu[:, None, :, None]) / torch.sqrt(var[:, None, :, None] + self.norm.eps)
        y = y.reshape(b, n, c) * self.norm.weight + self.norm.bias
        return y * mask[:, :, None].to(x.dtype)


class MultiHeadAttention(nn.Module):
    """vision3d MultiHeadAttention: softmax(where(k_valid, q.k^T / sqrt(d),
    -1e9)) v per head, through ``ops.attention.masked_attention`` (on CUDA
    tensors the hand-written kernel, whose plain recompute in the backward
    runs at ``precision``, as the JAX layer's einsums run at
    ``get_precision()``).

    The relative-position arguments take another route, chosen by argument:
    ``qk_embeds`` [B, N, M, C] adds a key per query pair (projected by
    ``qk_embed_layer`` when ``qk_embed_proj``), as ``q.k + q.qk``;
    ``qk_weights`` [B, N, M] and ``k_weights`` [B, M] scale the logits after
    the scale; ``k_valid`` and ``qk_valid`` [B, N, M] fill the masked logits
    with -1e9. With any of the four given the layer computes that in plain
    PyTorch, in the JAX layer's order, its einsums at ``precision`` (the
    projections are Linear layers, as JAX's are Dense); with none, the
    kernel's route above."""

    def __init__(self, d_model: int, num_heads: int, precision: str = "highest",
                 qk_embed_proj: bool = False):
        super().__init__()
        self.d_model, self.num_heads, self.precision = d_model, num_heads, precision
        self.q_token_layer = nn.Linear(d_model, d_model)
        self.k_token_layer = nn.Linear(d_model, d_model)
        self.v_token_layer = nn.Linear(d_model, d_model)
        self.qk_embed_layer = nn.Linear(d_model, d_model) if qk_embed_proj else None

    def forward(self, q_tokens, k_tokens, v_tokens, k_valid=None, qk_embeds=None,
                k_weights=None, qk_weights=None, qk_valid=None):
        h = self.num_heads
        d = self.d_model // h
        if any(a is not None for a in (qk_embeds, k_weights, qk_weights, qk_valid)):
            return self._relative(q_tokens, k_tokens, v_tokens, k_valid, qk_embeds, k_weights,
                                  qk_weights, qk_valid)

        def heads(x):
            return x.reshape(x.shape[0], x.shape[1], h, d).transpose(1, 2).contiguous()

        q = heads(self.q_token_layer(q_tokens))
        k = heads(self.k_token_layer(k_tokens))
        v = heads(self.v_token_layer(v_tokens))
        if k_valid is None:
            k_valid = torch.ones(k.shape[0], k.shape[2], dtype=torch.bool, device=k.device)
        out = masked_attention(q, k, v, k_valid, d ** -0.5, self.precision)   # [B, H, L, D]
        return out.transpose(1, 2).reshape(q_tokens.shape[0], q_tokens.shape[1], self.d_model)

    def _relative(self, q_tokens, k_tokens, v_tokens, k_valid, qk_embeds, k_weights,
                  qk_weights, qk_valid):
        h = self.num_heads
        d = self.d_model // h
        b, nq = q_tokens.shape[:2]
        q = self.q_token_layer(q_tokens).reshape(b, nq, h, d)
        k = self.k_token_layer(k_tokens).reshape(b, -1, h, d)
        v = self.v_token_layer(v_tokens).reshape(b, -1, h, d)
        if qk_embeds is not None and self.qk_embed_layer is not None:
            qk_embeds = self.qk_embed_layer(qk_embeds)
        with matmul_precision(self.precision):
            a = torch.einsum("bnhc,bmhc->bhnm", q, k)
            if qk_embeds is not None:
                qk = qk_embeds.reshape(*qk_embeds.shape[:3], h, d)
                a = a + torch.einsum("bnhc,bnmhc->bhnm", q, qk)
            a = a / math.sqrt(d)
            if qk_weights is not None:
                a = a * qk_weights[:, None, :, :]
            if k_weights is not None:
                a = a * k_weights[:, None, None, :]
            neg = torch.full_like(a, NEG_INF)
            if k_valid is not None:
                a = torch.where(k_valid[:, None, None, :], a, neg)
            if qk_valid is not None:
                a = torch.where(qk_valid[:, None, :, :], a, neg)
            out = torch.einsum("bhnm,bmhc->bnhc", torch.softmax(a, dim=-1), v)
        return out.reshape(b, nq, self.d_model)


class AttentionLayer(nn.Module):
    """Attention, output projection, residual, LayerNorm (eps 1e-5)."""

    def __init__(self, d_model: int, num_heads: int, precision: str = "highest",
                 qk_embed_proj: bool = False):
        super().__init__()
        self.attention = MultiHeadAttention(d_model, num_heads, precision, qk_embed_proj)
        self.linear = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, q_tokens, k_tokens, v_tokens, k_valid=None, **relative):
        hidden = self.linear(self.attention(q_tokens, k_tokens, v_tokens, k_valid, **relative))
        return self.norm(hidden + q_tokens)


class AttentionOutput(nn.Module):
    """FFN (expand x2, ReLU, squeeze), residual, LayerNorm (eps 1e-5)."""

    def __init__(self, d_model: int):
        super().__init__()
        self.expand = nn.Linear(d_model, 2 * d_model)
        self.squeeze = nn.Linear(2 * d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x):
        return self.norm(x + self.squeeze(_ReLU.apply(self.expand(x))))


class TransformerLayer(nn.Module):
    """vision3d TransformerLayer: AttentionLayer + AttentionOutput (post-norm).
    The keyword arguments ``qk_embeds``, ``k_weights``, ``qk_weights`` and
    ``qk_valid`` pass through to ``MultiHeadAttention``."""

    def __init__(self, d_model: int, num_heads: int, precision: str = "highest",
                 qk_embed_proj: bool = False):
        super().__init__()
        self.attention = AttentionLayer(d_model, num_heads, precision, qk_embed_proj)
        self.output = AttentionOutput(d_model)

    def forward(self, q_tokens, k_tokens, v_tokens, k_valid=None, **relative):
        return self.output(self.attention(q_tokens, k_tokens, v_tokens, k_valid, **relative))


class ConvBlock(nn.Module):
    """Conv2d (with bias, symmetric padding k // 2) + GroupNorm (optimal
    groups, eps 1e-5) + LeakyReLU 0.2, on NCHW (vision3d ConvBlock)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, use_norm: bool = True, use_act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                              padding=kernel_size // 2, bias=True)
        self.norm = (nn.GroupNorm(optimal_groups(out_channels), out_channels, eps=1e-5)
                     if use_norm else None)
        self.use_act = use_act

    def forward(self, x):
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return leaky2d3d(x) if self.use_act else x
