"""Diff-Reg pipeline (torch): KPFCN encode, training branch, DDIM loop, pose.

Counterpart of the JAX package's models/diffusion_matching.py, both variants
(``PipelineConfig.variant``: "3dmatch" rigid, "4dmatch" deformable). Three
branches share ``encode`` (the backbone and the coarse split):

  * ``train_forward``: the coarse transformer (with its positioning layer) and
    coarse matcher, soft Procrustes of their confidences; then the GT matching
    matrix noised at random timesteps (3dmatch: signed-fractional noise, NaN ->
    0, masked min-shift; 4dmatch: Gaussian noise, then a sigmoid), the gated
    warp from that noisy matrix and the denoising transformer and matcher.
    Timesteps, the normal draw and the randSO3 Euler angles come in as tensors
    (``draw_train_inputs`` makes them);
  * ``ddim_sample``: per DDIM step (3dmatch only) the masked min-shift, (when
    the condition gate is above 0) a Sinkhorn projection, soft Procrustes and a
    source warp, the 6-layer denoising transformer with its matcher, and the
    DDIM update (4dmatch adds sigma times a passed-in noise draw); finally the
    prediction (3dmatch: Sinkhorn; 4dmatch: the masked sigmoid), the top-1
    union correspondence mask and soft Procrustes;
  * ``backbone_forward``: the coarse transformer and matcher in one pass, the
    top-1 union mask and soft Procrustes.

The model variants of the config (the KPConv modes, deformable blocks and
batch norm off in ``kpfcn``; ``pe_type`` and ``entangled`` in the
transformers; ``match_type`` and ``entangled`` in the matchers) run in both
variants and every branch; a dual-softmax denoising matcher still projects
the DDIM's noisy matrix with its ``sinkhorn`` (``nn/matching.py``).

Module names follow the reference torch state_dict (pipeline.py), so that
``tools/convert_checkpoint.py`` and ``diffreg_tpu_torch.convert`` map the
weights.

``compute_dtype`` "bfloat16" in the KPFCN and transformer configs (the JAX
package's fast path, ``models.presets.with_fast_path``) runs the KPConvs
and the attention layers in bf16 with f32 accumulation; the parameters stay
f32 and are cast at use, so the same weights drive both dtypes. It trains
too (the JAX package's tools/bench_train.py setting): the gradients reach the
f32 parameters through those casts, and everything after the transformers
(matchers, soft Procrustes, the noisy-matrix warp, the losses) is f32, as in
JAX, whose layers return their input's dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
from torch import nn

from ..diffusion.schedule import (ddim_coefficients, ddim_time_pairs, make_schedule,
                                  predict_noise_from_start, q_sample, signed_fractional_noise)
from ..geometry.procrustes import soft_procrustes
from ..geometry.se3 import apply_transform
from ..nn.kpfcn import KPFCN, KPConv, KPFCNConfig
from ..nn.matching import Matching, MatchingConfig
from ..nn.point_backbone import KPConvBias
from ..nn.transformer import ProcrustesConfig, RepositioningTransformer, TransformerConfig
from ..ops.select import mutual_topk_mask
from ..utils.device import resolve_device
from ..utils.precision import pin_float32

# backbone modules outside the coarse phase: kept so that reference weights
# load whole, never run, and not part of the trained parameters
FINE_PHASE_PREFIXES = ("backbone.decoder_blocks.3.", "backbone.decoder_blocks.5.",
                       "backbone.coarse_in.", "backbone.fine_out.")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    kpfcn: KPFCNConfig
    coarse_transformer: TransformerConfig
    coarse_matching: MatchingConfig
    procrustes: ProcrustesConfig
    denoising_layer_types: Tuple[str, ...] = ("self", "cross") * 3
    timesteps: int = 1000
    sample_steps: int = 20
    ddim_eta: float = 1.0
    variant: str = "3dmatch"               # 3dmatch | 4dmatch
    coarse_level: int = -2


def masked_min(x, src_mask, tgt_mask):
    """Min of x [B, S, T] over valid entries only, keepdim [B, 1, 1]."""
    valid = src_mask[:, :, None] & tgt_mask[:, None, :]
    return torch.where(valid, x, torch.full_like(x, math.inf)).amin(dim=(1, 2), keepdim=True)


def _gather_rows(arr, idx):
    """arr [B, N, C], idx [B, S] with sentinel N -> [B, S, C] (sentinel rows 0)."""
    padded = torch.cat([arr, arr.new_zeros((arr.shape[0], 1, arr.shape[2]))], dim=1)
    return torch.gather(padded, 1, idx.long()[..., None].expand(-1, -1, arr.shape[2]))


def init_weights(model: nn.Module, seed: int) -> None:
    """Synthesise weights from ``seed`` on the CPU with the JAX package's
    initializer families: 1/sqrt(fan_in) normal for dense and convolution
    weights, zero biases, unit LayerNorms and GroupNorms, KPConv weights
    uniform with variance (2 / P) / (P * Cin), and the configured dustbin
    score."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                w = mod.weight
                fan_in = w[0].numel()
                w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(fan_in))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, (KPConv, KPConvBias)):
                p, cin, _ = mod.weights.shape
                limit = math.sqrt(3.0 * (2.0 / p) / (p * cin))
                mod.weights.copy_((torch.rand(mod.weights.shape, generator=gen) * 2 - 1) * limit)
            elif isinstance(mod, Matching) and hasattr(mod, "bin_score"):
                mod.bin_score.fill_(mod.cfg.skh_init_bin_score)


class DiffusionMatchingModel(nn.Module):
    """The Diff-Reg model (either variant). ``device`` defaults to "cuda" and raises when
    CUDA is missing; weights are synthesised from ``seed`` (load real or
    bridged weights with ``load_state_dict``)."""

    def __init__(self, cfg: PipelineConfig, device=None, seed: int = 0):
        super().__init__()
        if cfg.variant not in ("3dmatch", "4dmatch"):
            raise ValueError(f"unknown variant {cfg.variant!r}")
        device = resolve_device(device)
        pin_float32()
        self.cfg = cfg
        self.backbone = KPFCN(cfg.kpfcn)
        self.coarse_transformer = RepositioningTransformer(cfg.coarse_transformer)
        self.coarse_matching = Matching(cfg.coarse_matching)
        self.denoising_transformer = RepositioningTransformer(dataclasses.replace(
            cfg.coarse_transformer, layer_types=cfg.denoising_layer_types))
        self.denoising_coarse_matching = Matching(cfg.coarse_matching, projection=True)
        self.schedule = make_schedule(cfg.timesteps)
        init_weights(self, seed)
        self.to(device)

    def encode(self, batch):
        """Backbone + coarse split -> (src_feats, tgt_feats, s_pcd, t_pcd), [B, S|T, .]."""
        coarse_feats = self.backbone(batch)                       # [B, Nc, C]
        coarse_pts = batch.points[self.cfg.coarse_level % len(batch.points)]
        return (_gather_rows(coarse_feats, batch.src_idx_coarse),
                _gather_rows(coarse_feats, batch.tgt_idx_coarse),
                _gather_rows(coarse_pts, batch.src_idx_coarse),
                _gather_rows(coarse_pts, batch.tgt_idx_coarse))

    def named_trained_parameters(self):
        """(name, parameter) pairs that training updates: every parameter but
        the backbone's fine phase (``FINE_PHASE_PREFIXES``), the set the JAX
        package's train state holds."""
        return [(n, p) for n, p in self.named_parameters()
                if not n.startswith(FINE_PHASE_PREFIXES)]

    def _warp_from_noisy_matrix(self, x, s_pcd, t_pcd, src_mask, tgt_mask):
        """Sinkhorn-project a noisy matrix, extract a pose, warp the source.

        With ``max_condition_num <= 0`` the gate rejects every solution, so
        the warp is always the identity and the projection and pose solve are
        skipped (exact, not an approximation). The warp feeds only the
        denoiser's (detached) position code, so it is computed without a graph."""
        if self.cfg.procrustes.max_condition_num <= 0:
            return s_pcd, None
        with torch.no_grad():
            conf = self.denoising_coarse_matching.sinkhorn(x, src_mask, tgt_mask)
            res = self._pose(conf, s_pcd, t_pcd, src_mask, tgt_mask)
            return apply_transform(s_pcd, res.rotation_fwd, res.translation_fwd), res

    def _pose(self, conf, s_pcd, t_pcd, src_mask, tgt_mask):
        proc = self.cfg.procrustes
        return soft_procrustes(conf, s_pcd, t_pcd, src_mask, tgt_mask,
                               sample_rate=proc.sample_rate,
                               max_condition_num=proc.max_condition_num,
                               use_masked_lengths=proc.use_masked_lengths)

    def _denoise(self, src_feats, tgt_feats, src_warped, t_pcd, src_mask, tgt_mask):
        """Denoising transformer + matcher -> x0 prediction [B, S, T]."""
        sf, tf, spe, tpe, _ = self.denoising_transformer(
            src_feats, tgt_feats, src_warped, t_pcd, src_mask, tgt_mask)
        return self.denoising_coarse_matching(sf, tf, spe, tpe, src_mask, tgt_mask,
                                              pe_type=self.cfg.coarse_transformer.pe_type)

    def _coarse_pass(self, batch, src_feats, tgt_feats, s_pcd, t_pcd, euler):
        """Coarse transformer + coarse matcher -> (conf, match_mask, aux)."""
        src_mask, tgt_mask = batch.src_mask, batch.tgt_mask
        sf, tf, spe, tpe, aux = self.coarse_transformer(
            src_feats, tgt_feats, s_pcd, t_pcd, src_mask, tgt_mask,
            rot_gt=batch.rot_gt, trn_gt=batch.trn_gt, euler=euler)
        conf, match_mask = self.coarse_matching(sf, tf, spe, tpe, src_mask, tgt_mask,
                                                pe_type=self.cfg.coarse_transformer.pe_type)
        return conf, match_mask, aux

    def draw_train_inputs(self, batch, generator: torch.Generator):
        """The random draws of one training forward, made with ``generator`` on
        its device: t [B] timesteps in [0, timesteps), g [B, S, T] standard
        normal, euler [B, 3] Euler angles uniform in [0, 2 pi)."""
        b, s = batch.src_mask.shape
        t_len = batch.tgt_mask.shape[1]
        dev = generator.device
        return {"t": torch.randint(0, self.cfg.timesteps, (b,), generator=generator, device=dev),
                "g": torch.randn((b, s, t_len), generator=generator, device=dev),
                "euler": torch.rand((b, 3), generator=generator, device=dev) * 2.0 * math.pi}

    def train_forward(self, batch, t, g, euler=None):
        """Training branch (pipeline.py:182-219). t [B] timesteps, g [B, S, T]
        the standard-normal draw of the noise (3dmatch: its signed fraction;
        4dmatch: the noise itself), euler [B, 3] the randSO3 angles
        (used only by that positioning type). Returns the outputs the loss reads:
        s_pcd, t_pcd, conf_matrix_pred, match_mask_pred, rotation_pred,
        translation_pred, conf_matrix_gt_hat, match_mask_gt_hat, matrix_gt,
        position_layers and timesteps."""
        cfg = self.cfg
        src_feats, tgt_feats, s_pcd, t_pcd = self.encode(batch)
        src_mask, tgt_mask = batch.src_mask, batch.tgt_mask
        conf_pred, match_mask_pred, aux = self._coarse_pass(
            batch, src_feats, tgt_feats, s_pcd, t_pcd, euler)
        res = self._pose(conf_pred, s_pcd, t_pcd, src_mask, tgt_mask)

        # diffusion: noise the GT matrix, denoise it
        matrix_gt = batch.matrix_gt()
        if cfg.variant == "4dmatch":
            disturbed = torch.sigmoid(q_sample(self.schedule, matrix_gt, t, g))
        else:
            disturbed = q_sample(self.schedule, matrix_gt, t, signed_fractional_noise(g))
            disturbed = torch.nan_to_num(disturbed, nan=0.0)
            disturbed = disturbed - masked_min(disturbed, src_mask, tgt_mask)
        src_warped, _ = self._warp_from_noisy_matrix(disturbed, s_pcd, t_pcd, src_mask, tgt_mask)
        conf_gt_hat, match_mask_gt_hat = self._denoise(
            src_feats, tgt_feats, src_warped, t_pcd, src_mask, tgt_mask)
        return {"s_pcd": s_pcd, "t_pcd": t_pcd,
                "conf_matrix_pred": conf_pred, "match_mask_pred": match_mask_pred,
                "rotation_pred": res.rotation, "translation_pred": res.translation,
                "conf_matrix_gt_hat": conf_gt_hat, "match_mask_gt_hat": match_mask_gt_hat,
                "matrix_gt": matrix_gt, "position_layers": aux["position_layers"],
                "timesteps": t}

    def backbone_forward(self, batch, euler=None):
        """Single-pass branch: coarse transformer + matcher, the top-1 union
        mask and soft Procrustes. ``euler`` [B, 3] feeds a randSO3 positioning."""
        src_feats, tgt_feats, s_pcd, t_pcd = self.encode(batch)
        src_mask, tgt_mask = batch.src_mask, batch.tgt_mask
        conf_pred, _, _ = self._coarse_pass(batch, src_feats, tgt_feats, s_pcd, t_pcd, euler)
        corr_mask = mutual_topk_mask(conf_pred, 1, mutual=False)
        corr_mask = corr_mask & src_mask[:, :, None] & tgt_mask[:, None, :]
        res = self._pose(conf_pred, s_pcd, t_pcd, src_mask, tgt_mask)
        return {"s_pcd": s_pcd, "t_pcd": t_pcd, "conf_matrix_pred": conf_pred,
                "corr_mask": corr_mask, "rotation_pred": res.rotation,
                "translation_pred": res.translation}

    @torch.no_grad()
    def ddim_sample(self, batch, x_init, sample_steps=None, ddim_noise=None,
                    zero_ddim_noise: bool = False):
        """DDIM reverse loop from ``x_init`` [B, S, T] (the N(0, 1) start, passed
        in). The 4dmatch update adds sigma * ``ddim_noise[i]`` at step i
        (``ddim_noise`` [steps, B, S, T], N(0, 1)); ``zero_ddim_noise`` drops
        that term while sigma stays in the coefficient c, as in the JAX
        package. A 4dmatch call needs one of the two; a 3dmatch call takes
        neither. Returns s_pcd, t_pcd, conf_matrix_pred, corr_mask,
        rotation_pred, translation_pred and, when the condition gate is above
        0, step_condition [steps, B] (each step's Procrustes condition number)."""
        cfg = self.cfg
        steps = int(sample_steps if sample_steps is not None else cfg.sample_steps)
        deformable = cfg.variant == "4dmatch"
        if not deformable:
            if ddim_noise is not None or zero_ddim_noise:
                raise ValueError("the 3dmatch DDIM update is deterministic: it takes no noise")
        elif zero_ddim_noise:
            ddim_noise = None
        elif ddim_noise is None:
            raise ValueError("the 4dmatch DDIM update needs ddim_noise [steps, B, S, T] "
                             "or zero_ddim_noise=True")
        elif ddim_noise.shape != (steps,) + tuple(x_init.shape):
            raise ValueError(f"ddim_noise has shape {tuple(ddim_noise.shape)}, want "
                             f"{(steps,) + tuple(x_init.shape)}")
        src_feats, tgt_feats, s_pcd, t_pcd = self.encode(batch)
        src_mask, tgt_mask = batch.src_mask, batch.tgt_mask
        x = x_init
        conditions = []
        for i, (time, time_next) in enumerate(ddim_time_pairs(cfg.timesteps, steps)):
            if not deformable:
                x = x - masked_min(x, src_mask, tgt_mask)
            src_warped, res = self._warp_from_noisy_matrix(x, s_pcd, t_pcd, src_mask, tgt_mask)
            if res is not None:
                conditions.append(res.condition)
            x_start, _ = self._denoise(src_feats, tgt_feats, src_warped, t_pcd, src_mask,
                                       tgt_mask)
            pred_noise = predict_noise_from_start(self.schedule, x, int(time), x_start)
            sqrt_next, c, sigma = ddim_coefficients(self.schedule, int(time), int(time_next),
                                                    cfg.ddim_eta)
            x = x_start * sqrt_next + c * pred_noise
            if ddim_noise is not None:
                x = x + sigma * ddim_noise[i]

        valid = src_mask[:, :, None] & tgt_mask[:, None, :]
        if deformable:
            conf_pred = torch.sigmoid(x) * valid.to(x.dtype)
        else:
            sim = x - masked_min(x, src_mask, tgt_mask)
            conf_pred = self.denoising_coarse_matching.sinkhorn(sim, src_mask, tgt_mask)
        # top-1 from both sides, union
        corr_mask = mutual_topk_mask(conf_pred, 1, mutual=False) & valid
        res = self._pose(conf_pred, s_pcd, t_pcd, src_mask, tgt_mask)
        out = {"s_pcd": s_pcd, "t_pcd": t_pcd, "conf_matrix_pred": conf_pred,
               "corr_mask": corr_mask, "rotation_pred": res.rotation,
               "translation_pred": res.translation}
        if conditions:
            out["step_condition"] = torch.stack(conditions)
        return out

    def forward(self, batch, *args, mode: str = "ddim", **kwargs):
        """``mode`` "ddim" -> ddim_sample(batch, x_init, sample_steps, ...), "train" ->
        train_forward(batch, t, g, euler), "backbone" -> backbone_forward(batch, euler)."""
        if mode == "ddim":
            return self.ddim_sample(batch, *args, **kwargs)
        if mode == "train":
            return self.train_forward(batch, *args, **kwargs)
        if mode == "backbone":
            return self.backbone_forward(batch, *args, **kwargs)
        raise KeyError(mode)
