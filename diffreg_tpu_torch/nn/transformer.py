"""Repositioning transformer — self/cross geometry attention with volumetric PE.

Counterpart of the JAX package's nn/transformer.py (``GeometryAttentionLayer``,
``RepositioningTransformer``). Only the math is ported: the JAX package's
lane-layout switches (align_heads, rotary_half, fused_rotary_qkv,
logits_layout) give identical outputs. Attention goes through
``ops.attention.masked_attention``: the Hopper kernel for CUDA tensors, the
plain version on the CPU.

``pe_type`` "rotary" rotates q and k by the position code after their
projections; "sinusoidal" adds the code to x and source before them (v is
projected from the bare source either way). ``entangled`` adds (or applies)
the code to the features once, before the first layer; the layers then get
none, the 'positioning' layers are skipped (and hold no matcher), and the
initial codes are returned.

``compute_dtype="bfloat16"`` is the JAX layer's bf16 path: x and source are
cast to bf16, the projections, the rotary code, the merge and the MLP run in
bf16 (f32 weights cast at use, f32 accumulation), attention through its bf16
kernel, the LayerNorms in f32 with their outputs cast back to bf16, and the
residual is the bf16 x plus the block's output in the input dtype.

The 'positioning' layer re-derives both position codes from a warped source
cloud. Its warp is one of: 'procrustes' (its own Matching, ``layers.<i>.0``,
then soft Procrustes with the configured condition gate), 'randSO3' (a
random rotation about the masked centroid, from Euler angles passed in) or
'oracle' (the ground-truth pose). The codes are detached
(``ops.position_encoding``), so no gradient reaches the warp.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..geometry.procrustes import soft_procrustes
from ..geometry.se3 import apply_transform
from ..ops.attention import masked_attention
from ..ops.position_encoding import PE_TYPES, embed_pos, volumetric_pe
from .matching import Matching, MatchingConfig


@dataclasses.dataclass(frozen=True)
class ProcrustesConfig:
    sample_rate: float = 1.0
    max_condition_num: float = 0.0
    use_masked_lengths: bool = False


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    feature_dim: int = 432
    n_head: int = 4
    layer_types: Tuple[str, ...] = ("self", "cross", "positioning", "self", "cross")
    positioning_type: str = "procrustes"      # procrustes | randSO3 | oracle
    pe_type: str = "rotary"                   # rotary | sinusoidal
    vol_origin: Tuple[float, float, float] = (-3.6, -2.4, 1.14)
    voxel_size: float = 0.08
    entangled: bool = False                   # the code joins the features once, up front
    procrustes: ProcrustesConfig = ProcrustesConfig()
    feature_matching: MatchingConfig = MatchingConfig()
    compute_dtype: Optional[str] = None       # "bfloat16": the bf16 path


def torch_dtype(compute_dtype: Optional[str]):
    """The torch dtype of a config's ``compute_dtype``: bfloat16, or None for
    the f32 path (None or "float32")."""
    if compute_dtype in (None, "float32"):
        return None
    if compute_dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"compute_dtype {compute_dtype!r}: bfloat16, float32 or None")


def _linear(layer, x):
    """``layer`` (no bias) applied in x's dtype: f32 weights cast at use."""
    return F.linear(x, layer.weight.to(x.dtype))


class GeometryAttentionLayer(nn.Module):
    """Multi-head attention with the position code (rotary or sinusoidal) +
    gated-concat FFN (transformero.py:13-96)."""

    def __init__(self, d_model: int, n_head: int, compute_dtype: Optional[str] = None,
                 pe_type: str = "rotary"):
        super().__init__()
        if pe_type not in PE_TYPES:
            raise KeyError(pe_type)
        self.d_model, self.n_head, self.pe_type = d_model, n_head, pe_type
        self.dtype = torch_dtype(compute_dtype)
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.mlp = nn.Sequential(nn.Linear(2 * d_model, 2 * d_model, bias=False), nn.ReLU(),
                                 nn.Linear(2 * d_model, d_model, bias=False))
        # Flax's LayerNorm epsilon (1e-6), which the weights were trained with
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, x, source, x_pe, source_pe, source_mask):
        """x [B, L, C] attends to source [B, S, C]; pe: rotary [.., C, 2],
        sinusoidal [.., C], or None (no code); source_mask [B, S]."""
        b, h = x.shape[0], self.n_head
        dim = self.d_model // h
        in_dtype = x.dtype
        if self.dtype is not None:
            same = x is source
            x = x.to(self.dtype)
            source = x if same else source.to(self.dtype)
            if x_pe is not None:
                x_pe, source_pe = x_pe.to(self.dtype), source_pe.to(self.dtype)
        if self.pe_type == "sinusoidal":
            q = _linear(self.q_proj, x if x_pe is None else x + x_pe)
            k = _linear(self.k_proj, source if source_pe is None else source + source_pe)
        else:
            q, k = _linear(self.q_proj, x), _linear(self.k_proj, source)
            if x_pe is not None:
                q, k = embed_pos("rotary", q, x_pe), embed_pos("rotary", k, source_pe)
        v = _linear(self.v_proj, source)
        heads = lambda t: t.reshape(b, -1, h, dim).transpose(1, 2)   # [B, H, N, D]
        o = masked_attention(heads(q), heads(k), heads(v), source_mask, dim ** -0.5)
        message = _linear(self.merge, o.transpose(1, 2).reshape(b, -1, h * dim))
        message = self.norm1(message.float()).to(x.dtype)
        y = torch.cat([x, message], dim=-1)
        y = _linear(self.mlp[2], torch.relu(_linear(self.mlp[0], y)))
        y = self.norm2(y.float())
        return x.to(in_dtype) + y.to(in_dtype)


class RepositioningTransformer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        layers = []
        for lt in cfg.layer_types:
            if lt in ("self", "cross"):
                layers.append(GeometryAttentionLayer(cfg.feature_dim, cfg.n_head,
                                                     cfg.compute_dtype, cfg.pe_type))
            elif lt == "positioning":
                if cfg.positioning_type not in ("procrustes", "randSO3", "oracle"):
                    raise KeyError(cfg.positioning_type)
                # parameters only for the procrustes warp, at layers.<i>.0 (an
                # entangled transformer skips the layer: no parameters, as in JAX)
                procrustes = cfg.positioning_type == "procrustes" and not cfg.entangled
                layers.append(nn.ModuleList([Matching(cfg.feature_matching)]
                                            if procrustes else []))
            else:
                raise KeyError(lt)
        self.layers = nn.ModuleList(layers)

    def _pe(self, xyz):
        return volumetric_pe(xyz, self.cfg.feature_dim, self.cfg.vol_origin,
                             self.cfg.voxel_size, self.cfg.pe_type)

    def forward(self, src_feat, tgt_feat, s_pcd, t_pcd, src_mask, tgt_mask, rot_gt=None,
                trn_gt=None, transform=None, euler=None):
        """-> (src_feat, tgt_feat, src_pe, tgt_pe, aux). ``transform`` (R [B, 3, 3],
        t [B, 3, 1]) warps the source before the first code; ``rot_gt``/``trn_gt``
        feed the 'oracle' warp and ``euler`` [B, 3] (radians) the 'randSO3' one.
        aux["position_layers"] holds each procrustes positioning layer's
        conf_matrix, match_mask, rotation, translation, condition, solution_mask."""
        cfg = self.cfg
        src_wrapped = s_pcd if transform is None else apply_transform(s_pcd, *transform)
        src_pe, tgt_pe = self._pe(src_wrapped), self._pe(t_pcd)
        s_pe, t_pe = src_pe, tgt_pe
        if cfg.entangled:
            src_feat = embed_pos(cfg.pe_type, src_feat, src_pe)
            tgt_feat = embed_pos(cfg.pe_type, tgt_feat, tgt_pe)
            s_pe = t_pe = None
        aux = {"position_layers": []}
        for lt, layer in zip(cfg.layer_types, self.layers):
            if lt == "self":
                if src_feat.shape[1] == tgt_feat.shape[1]:
                    # src and tgt share the weights and are independent: one [2B] call
                    both = torch.cat([src_feat, tgt_feat], dim=0)
                    pe2 = None if s_pe is None else torch.cat([s_pe, t_pe], dim=0)
                    both = layer(both, both, pe2, pe2, torch.cat([src_mask, tgt_mask], dim=0))
                    src_feat, tgt_feat = both[:src_feat.shape[0]], both[src_feat.shape[0]:]
                else:
                    src_feat = layer(src_feat, src_feat, s_pe, s_pe, src_mask)
                    tgt_feat = layer(tgt_feat, tgt_feat, t_pe, t_pe, tgt_mask)
            elif lt == "cross":
                src_feat = layer(src_feat, tgt_feat, s_pe, t_pe, tgt_mask)
                # tgt attends to the updated src, as in the reference
                tgt_feat = layer(tgt_feat, src_feat, t_pe, s_pe, src_mask)
            elif cfg.entangled:
                continue
            elif cfg.positioning_type == "procrustes":
                conf, match_mask = layer[0](src_feat, tgt_feat, s_pe, t_pe, src_mask, tgt_mask,
                                            pe_type=cfg.pe_type)
                proc = cfg.procrustes
                res = soft_procrustes(conf, s_pcd, t_pcd, src_mask, tgt_mask,
                                      sample_rate=proc.sample_rate,
                                      max_condition_num=proc.max_condition_num,
                                      use_masked_lengths=proc.use_masked_lengths)
                aux["position_layers"].append({
                    "conf_matrix": conf, "match_mask": match_mask,
                    "rotation": res.rotation, "translation": res.translation,
                    "condition": res.condition, "solution_mask": res.solution_mask})
                s_pe = self._pe(apply_transform(s_pcd, res.rotation_fwd, res.translation_fwd))
                t_pe = self._pe(t_pcd)
            elif cfg.positioning_type == "randSO3":
                s_pe, t_pe = self._pe(rand_rot_pcd(euler, s_pcd, src_mask)), self._pe(t_pcd)
            else:  # oracle
                s_pe, t_pe = self._pe(apply_transform(s_pcd, rot_gt, trn_gt)), self._pe(t_pcd)
            if lt == "positioning":
                src_pe, tgt_pe = s_pe, t_pe
        return src_feat, tgt_feat, src_pe, tgt_pe, aux


def rand_rot_pcd(euler, pcd, mask):
    """Rotate pcd [B, N, 3] (padding zeroed) about its masked centroid by the
    z-y-x Euler angles ``euler`` [B, 3] (transformero.py:262-279)."""
    n = pcd.shape[1]
    pcd = pcd * mask[..., None].to(pcd.dtype)
    n_points = mask.sum(dim=1).reshape(-1, 1, 1).clamp_min(1).to(pcd.dtype)
    centroid = pcd.mean(dim=1, keepdim=True) * n / n_points
    return (pcd - centroid) @ euler_zyx_to_matrix(euler).transpose(1, 2) + centroid


def euler_zyx_to_matrix(euler):
    """Intrinsic z-y-x Euler angles [B, 3] -> rotation matrices [B, 3, 3]."""
    z, y, x = euler.unbind(-1)
    zero, one = torch.zeros_like(z), torch.ones_like(z)
    rz = torch.stack([z.cos(), -z.sin(), zero, z.sin(), z.cos(), zero,
                      zero, zero, one], -1).reshape(-1, 3, 3)
    ry = torch.stack([y.cos(), zero, y.sin(), zero, one, zero,
                      -y.sin(), zero, y.cos()], -1).reshape(-1, 3, 3)
    rx = torch.stack([one, zero, zero, zero, x.cos(), -x.sin(),
                      zero, x.sin(), x.cos()], -1).reshape(-1, 3, 3)
    return rz @ ry @ rx
