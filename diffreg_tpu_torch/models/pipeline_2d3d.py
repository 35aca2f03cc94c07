"""2D-3D registration pipeline (RGB-D Scenes V2 / 7Scenes): image and cloud
encoders, cross-modal fusion, coarse matcher, DDIM over the node x patch
matching matrix, and patch-level fine matching.

Counterpart of the JAX package's models/pipeline_2d3d.py (the reference
MATR2D3D). The frozen towers (``models/towers.py``) run outside the model;
their outputs ride the batch:

  * ``encode``: the image UNet (NCHW) and the KPConv point backbone; coarse
    image tokens on the ``coarse_stride`` grid with their normalised pixel
    positions. With ``use_dino`` the DINOv2 tokens (``batch.dino_feats``),
    projected by ``dino_proj``, are added to the UNet's 1/8 map, and the raw
    tokens on the coarse grid enter both fusion modules;
  * the point-to-node partition gates the nodes by their member count, and
    each image patch's centre is the mean of its valid stride-2 pixels. With
    ``use_mono_depth`` and ``batch.mono_depth`` the node warp targets the
    centres of the DepthAnything map lifted through the trainable affine
    ``depth_coffa`` / ``depth_coffb`` (the matchers keep the real depth's
    patch validity);
  * mode "backbone": the fusion transformer and coarse matcher once, then the
    top-1 union correspondence mask;
  * ``train_forward``: the same coarse pass; the GT matrix noised at passed-in
    timesteps with a passed-in normal draw, the node warp from it (Sinkhorn
    and soft Procrustes, differentiated) and the denoising fusion and matcher;
  * mode "ddim": the same coarse pass, then the deterministic DDIM loop from
    ``x_init`` [B, N, M] (passed in): per step a Sinkhorn projection of the
    noisy matrix, soft Procrustes of the nodes onto the patch centres, the
    node warp, the denoising fusion and matcher, the DDIM update; finally a
    Sinkhorn and the top-1 union mask over valid nodes and patches;
  * ``fine_matching``: per coarse correspondence, mutual top-k of the cosine
    similarities between the patch's stride-2 pixels and the node's member
    points, deduplicated into a fixed-size buffer.

Module names follow the reference state_dict (img_backbone, pcd_backbone,
transformer, denoising_transformer, coarse_matching,
denoising_coarse_matching), so ``diffreg_tpu_torch.convert`` maps the JAX
package's variables onto them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..diffusion.schedule import (ddim_coefficients, ddim_time_pairs, make_schedule,
                                  predict_noise_from_start, q_sample)
from ..geometry.procrustes import soft_procrustes
from ..geometry.se3 import apply_transform
from .diffusion_matching import init_weights
from ..nn.fusion import CrossModalFusionModule
from ..nn.image_backbone import ImageBackbone
from ..nn.matching import Matching, MatchingConfig
from ..nn.point_backbone import PointBackbone, PointBackboneConfig
from ..ops.masked import NEG_INF, scatter_pairs
from ..ops.partition import batch_mutual_topk_select, point_to_node_partition
from ..ops.select import mutual_topk_mask
from ..ops.topk import stable_top_k
from ..ops.vision import create_meshgrid, l2_normalize, resize_align_corners
from ..utils.device import resolve_device
from ..utils.precision import pin_float32

MONO_DEPTH_SCALE = 0.01   # the reference lifts image_depth_any / 100
DEPTH_LIMIT = 6.0         # lifted depths beyond it are dropped


@dataclasses.dataclass(frozen=True)
class Batch2D3D:
    """One padded batch of image <-> cloud pairs (torch tensors)."""

    image: torch.Tensor              # [B, H, W, 1] grayscale
    img_points: torch.Tensor         # [B, H*W, 3] back-projected depth (camera frame)
    img_valid: torch.Tensor          # [B, H*W] bool
    points: Tuple[torch.Tensor, ...]     # 3 x [B, N_l, 3] cloud pyramid
    masks: Tuple[torch.Tensor, ...]      # 3 x [B, N_l] bool
    neighbors: Tuple[torch.Tensor, ...]  # 3 x [B, N_l, K_l] int32 (sentinel N_l)
    pools: Tuple[torch.Tensor, ...]      # 2 x [B, N_{l+1}, Kp_l]
    upsamples: Tuple[torch.Tensor, ...]  # 2 x [B, N_l, Ku_l]
    pcd_feats: torch.Tensor          # [B, N0, 1]
    transform: torch.Tensor          # [B, 4, 4] camera-from-cloud ground truth
    intrinsics: torch.Tensor         # [B, 3, 3]
    dino_feats: Optional[torch.Tensor] = None  # [B, H/14, W/14, D] DINOv2 patch tokens
    mono_depth: Optional[torch.Tensor] = None  # [B, H, W] raw DepthAnything output
    gt_src: Optional[torch.Tensor] = None      # [B, G] escalated coarse GT (node)
    gt_tgt: Optional[torch.Tensor] = None      # [B, G] (patch)
    gt_valid: Optional[torch.Tensor] = None
    gt_not_val: Optional[torch.Tensor] = None  # [B] 1.0 when the GT never validated
    ov_src: Optional[torch.Tensor] = None      # [B, Q] overlap GT (node)
    ov_tgt: Optional[torch.Tensor] = None      # [B, Q] (patch)
    ov_min: Optional[torch.Tensor] = None      # [B, Q] min overlap ratio
    ov_max: Optional[torch.Tensor] = None
    ov_valid: Optional[torch.Tensor] = None
    fine_pixels: Optional[torch.Tensor] = None   # [B, F, 2] (v, u)
    fine_pcd_idx: Optional[torch.Tensor] = None  # [B, F]
    fine_valid: Optional[torch.Tensor] = None

    @property
    def batch_size(self) -> int:
        return self.image.shape[0]

    def map(self, fn) -> "Batch2D3D":
        def one(v):
            if v is None:
                return None
            return tuple(fn(t) for t in v) if isinstance(v, tuple) else fn(v)
        return Batch2D3D(**{f.name: one(getattr(self, f.name))
                            for f in dataclasses.fields(self)})

    def to(self, device) -> "Batch2D3D":
        return self.map(lambda t: t.to(device))

    def select(self, index: slice) -> "Batch2D3D":
        return self.map(lambda t: t[index])

    @classmethod
    def from_numpy(cls, arrays: dict) -> "Batch2D3D":
        """Wrap a dict of stacked numpy arrays (missing fields stay None)."""
        def conv(v):
            if v is None:
                return None
            if isinstance(v, tuple):
                return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in v)
            return torch.from_numpy(np.ascontiguousarray(v))
        return cls(**{f.name: conv(arrays.get(f.name)) for f in dataclasses.fields(cls)})


@dataclasses.dataclass(frozen=True)
class Pipeline2D3DConfig:
    img_out_dim: int = 128
    img_base_dim: int = 128
    pcd_backbone: PointBackboneConfig = PointBackboneConfig(output_dim=128)
    hidden_dim: int = 256
    output_dim: int = 256
    num_heads: int = 4
    fusion_blocks: Tuple[str, ...] = ("self", "cross") * 3
    matching: MatchingConfig = MatchingConfig(feature_dim=256, confidence_threshold=0.2)
    coarse_stride: int = 8
    pcd_num_points_in_patch: int = 128
    pcd_min_node_size: int = 5
    timesteps: int = 1000
    sample_steps: int = 10          # SAMPLE_STEP (50 rgbdv2, 10 7scenes)
    ddim_eta: float = 1.0
    procrustes_sample_rate: float = 1.0
    procrustes_max_condition: float = 200.0
    use_dino: bool = False
    use_mono_depth: bool = False
    dino_dim: int = 1024            # DINOv2 ViT-L patch-token width
    # "default": TF32 in the matchers' similarity product and the attention's
    # plain path on CUDA (the JAX package's get_precision() sites); the
    # attention kernel stays 3xTF32
    precision: str = "highest"


class DiffReg2D3D(nn.Module):
    """The 2D-3D model. ``device`` defaults to "cuda" and raises when CUDA is
    missing; weights are synthesised from ``seed`` (load real or bridged
    weights with ``load_state_dict``)."""

    def __init__(self, cfg: Pipeline2D3DConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        pin_float32()
        self.cfg = cfg
        self.img_backbone = ImageBackbone(cfg.img_out_dim, cfg.img_base_dim)
        self.pcd_backbone = PointBackbone(cfg.pcd_backbone)
        fusion = lambda: CrossModalFusionModule(  # noqa: E731
            4 * cfg.img_base_dim, 8 * cfg.pcd_backbone.init_dim, cfg.output_dim,
            cfg.hidden_dim, cfg.num_heads, cfg.fusion_blocks,
            dino_dim=cfg.dino_dim if cfg.use_dino else None, precision=cfg.precision)
        self.transformer = fusion()
        self.denoising_transformer = fusion()
        matching = dataclasses.replace(cfg.matching, precision=cfg.precision)
        self.coarse_matching = Matching(matching)
        self.denoising_coarse_matching = Matching(matching)
        if cfg.use_dino:
            # the reference's dino_2_u: DINO tokens to the UNet's 1/8 width
            self.dino_proj = nn.Linear(cfg.dino_dim, 4 * cfg.img_base_dim)
        if cfg.use_mono_depth:
            # the monocular depth's affine z = depth * scale * a + b, trained
            self.depth_coffa = nn.Parameter(torch.ones(1))
            self.depth_coffb = nn.Parameter(torch.zeros(1))
        self.schedule = make_schedule(cfg.timesteps)
        init_weights(self, seed)
        self.to(device)

    def named_trained_parameters(self):
        return list(self.named_parameters())

    # ------------------------------------------------------------------ #

    def encode(self, batch: Batch2D3D) -> dict:
        """Both encoders: fine image features [B, H, W, C], coarse image tokens
        [B, hc*wc, 4 base] with their normalised pixels, fine and node point
        features, and with ``use_dino`` the DINO tokens on the coarse grid
        [B, hc*wc, dino_dim] (else None)."""
        b, h, w, _ = batch.image.shape
        s = self.cfg.coarse_stride
        hc, wc = h // s, w // s
        dino = dino_tokens = None
        if self.cfg.use_dino:
            if batch.dino_feats is None:
                raise ValueError("use_dino needs batch.dino_feats, the DINOv2 tower's tokens "
                                 "(models/towers.py); the synthetic demo pairs carry none")
            dino = batch.dino_feats.permute(0, 3, 1, 2)                 # [B, D, h14, w14]
            dino_tokens = resize_align_corners(dino, (hc, wc)).flatten(2).transpose(1, 2)
            # the UNet gets the projected tokens, the fusion modules the raw ones
            dino = self.dino_proj(batch.dino_feats).permute(0, 3, 1, 2)
        feats = self.img_backbone(batch.image.permute(0, 3, 1, 2), dino)
        coarse = resize_align_corners(feats[-1], (hc, wc))
        pcd = self.pcd_backbone(batch)
        pix = create_meshgrid(hc, wc, normalized=True, flatten=True, device=coarse.device)
        return {"img_feats_f": feats[0].permute(0, 2, 3, 1),
                "img_feats_c": coarse.flatten(2).transpose(1, 2),
                "img_pixels_c": pix[None].expand(b, hc * wc, 2), "dino_tokens": dino_tokens,
                "pcd_feats_f": pcd[0], "pcd_feats_c": pcd[-1], "hc": hc, "wc": wc}

    def _centers_of(self, points, valid, shape):
        """Each patch's centre: the mean of its valid points [B, H*W, 3] over the
        stride-2 pixel subset (the reference's patchify(stride=2)) -> (centres
        [B, hc*wc, 3], valid [B, hc*wc])."""
        b, h, w, _ = shape
        s = self.cfg.coarse_stride
        hc, wc = h // s, w // s
        pts = points.reshape(b, hc, s, wc, s, 3)[:, :, ::2, :, ::2]
        ss = pts.shape[2] * pts.shape[4]
        pts = pts.permute(0, 1, 3, 2, 4, 5).reshape(b, hc * wc, ss, 3)
        val = valid.reshape(b, hc, s, wc, s)[:, :, ::2, :, ::2]
        val = val.permute(0, 1, 3, 2, 4).reshape(b, hc * wc, ss)
        cnt = val.sum(dim=-1, keepdim=True).clamp_min(1).to(pts.dtype)
        return torch.sum(pts * val[..., None].to(pts.dtype), dim=2) / cnt, val.any(dim=-1)

    def patch_centers(self, batch: Batch2D3D):
        """The patch centres of the back-projected depth -> (centres [B, hc*wc,
        3], valid [B, hc*wc])."""
        return self._centers_of(batch.img_points, batch.img_valid, batch.image.shape)

    def patch_centers_da(self, batch: Batch2D3D):
        """The centres the node warp targets: with ``use_mono_depth`` and a
        ``batch.mono_depth``, those of the lifted DepthAnything map; else the
        real depth's (``patch_centers``)."""
        if not (self.cfg.use_mono_depth and batch.mono_depth is not None):
            return self.patch_centers(batch)
        return self._centers_of(*self.lift_mono_depth(batch), batch.image.shape)

    def lift_mono_depth(self, batch: Batch2D3D):
        """The DepthAnything map to camera-frame points [B, H*W, 3] through the
        trainable affine (the reference's back_project_depth): z = depth *
        MONO_DEPTH_SCALE * depth_coffa + depth_coffb, zeroed beyond
        DEPTH_LIMIT; valid [B, H*W] where z > 0."""
        b, h, w, _ = batch.image.shape
        z = batch.mono_depth.reshape(b, h * w) * MONO_DEPTH_SCALE
        z = z * self.depth_coffa + self.depth_coffb
        z = torch.where(z > DEPTH_LIMIT, torch.zeros_like(z), z)
        k = batch.intrinsics
        fx, fy, cx, cy = (k[:, i, j][:, None] for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))
        grid = create_meshgrid(h, w, flatten=True, device=z.device)      # [HW, 2] (v, u)
        x = (grid[None, :, 1] - cx) * z / fx
        y = (grid[None, :, 0] - cy) * z / fy
        return torch.stack([x, y, z], dim=-1), z > 0.0

    def _warp_nodes(self, x, nodes, centers, node_masks, center_masks, node_pad):
        """Sinkhorn-project the noisy matrix, soft Procrustes of the nodes onto
        the patch centres (the top-k budgeted by the mask sums), warp."""
        conf = self.denoising_coarse_matching.sinkhorn(
            x, node_masks, center_masks, node_pad, torch.ones_like(center_masks))
        res = soft_procrustes(conf, nodes, centers, node_masks, center_masks,
                              sample_rate=self.cfg.procrustes_sample_rate,
                              max_condition_num=self.cfg.procrustes_max_condition,
                              use_masked_lengths=True)
        return apply_transform(nodes, res.rotation_fwd, res.translation_fwd)

    def _match(self, fusion, matcher, enc, batch, nodes, node_masks, img_valid_c):
        """Fusion (no image-token mask; the nodes' padding masked) and matcher
        (gated node masks, patch validity) -> confidences [B, N, M]."""
        img_t, pcd_t = fusion(enc["img_feats_c"], enc["img_pixels_c"], enc["pcd_feats_c"],
                              nodes, img_valid=None, pcd_valid=batch.masks[-1],
                              img_feats_dino=enc["dino_tokens"])
        conf, _ = matcher(pcd_t, img_t, None, None, node_masks, img_valid_c,
                          src_pad=batch.masks[-1], tgt_pad=torch.ones_like(img_valid_c))
        return conf, img_t, pcd_t

    def _coarse_pass(self, batch: Batch2D3D) -> Tuple[dict, dict]:
        """Both encoders, the partition (nodes gated by their member count), the
        patch centres (real, and the warp's), the fusion transformer and the
        coarse matcher -> (the outputs every mode returns, the encoder's)."""
        cfg = self.cfg
        enc = self.encode(batch)
        nodes, node_pad = batch.points[-1], batch.masks[-1]
        part = point_to_node_partition(batch.points[0], nodes, batch.masks[0], node_pad,
                                       cfg.pcd_num_points_in_patch)
        node_masks = part.node_masks & (part.node_sizes > cfg.pcd_min_node_size)
        centers, img_valid_c = self.patch_centers(batch)
        centers_da, valid_da = self.patch_centers_da(batch)
        conf, img_t, pcd_t = self._match(self.transformer, self.coarse_matching, enc, batch,
                                         nodes, node_masks, img_valid_c)
        out = {"conf_matrix_pred": conf, "node_masks": node_masks, "img_valid_c": img_valid_c,
               "nodes": nodes, "patch_centers": centers, "patch_centers_da": centers_da,
               "patch_valid_da": valid_da, "pcd_feats_c": pcd_t,
               "img_feats_c": img_t, "partition": part, "img_feats_f": enc["img_feats_f"],
               "pcd_feats_f": enc["pcd_feats_f"]}
        return out, enc

    def _denoise(self, enc, batch, x, out):
        """Warp the nodes by the noisy matrix ``x`` onto the warp's patch centres,
        then the denoising fusion and matcher -> the x0 prediction [B, N, M]."""
        nodes, masks, valid = out["nodes"], out["node_masks"], out["img_valid_c"]
        warped = self._warp_nodes(x, nodes, out["patch_centers_da"], masks, out["patch_valid_da"],
                                  batch.masks[-1])
        return self._match(self.denoising_transformer, self.denoising_coarse_matching, enc,
                           batch, warped, masks, valid)[0]

    def draw_train_inputs(self, batch: Batch2D3D, generator: torch.Generator) -> dict:
        """The random draws of one training forward, made with ``generator`` on
        its device: t [B] timesteps in [0, timesteps), noise [B, N, M] standard
        normal (N node slots, M image patches)."""
        b, h, w, _ = batch.image.shape
        s = self.cfg.coarse_stride
        dev = generator.device
        shape = (b, batch.points[-1].shape[1], (h // s) * (w // s))
        return {"t": torch.randint(0, self.cfg.timesteps, (b,), generator=generator, device=dev),
                "noise": torch.randn(shape, generator=generator, device=dev)}

    def train_forward(self, batch: Batch2D3D, t, noise) -> dict:
        """Training branch (the reference model.py:599-636): the coarse pass;
        the GT matrix of ``batch.gt_*``, noised at timesteps ``t`` [B] with the
        standard-normal ``noise`` [B, N, M]; the node warp from that matrix
        (its Sinkhorn and soft Procrustes stay in the graph) and the denoising
        pass. Returns the coarse pass's outputs with conf_matrix_gt_hat,
        matrix_gt and timesteps."""
        out, enc = self._coarse_pass(batch)
        n, m = out["node_masks"].shape[1], out["img_valid_c"].shape[1]
        matrix_gt = _matrix_from_indices(batch.gt_src, batch.gt_tgt, batch.gt_valid, n, m)
        disturbed = q_sample(self.schedule, matrix_gt, t, noise)
        out.update({"conf_matrix_gt_hat": self._denoise(enc, batch, disturbed, out),
                    "matrix_gt": matrix_gt, "timesteps": t})
        return out

    def forward(self, batch: Batch2D3D, mode: str = "ddim",
                x_init: Optional[torch.Tensor] = None) -> dict:
        """mode "ddim" (needs ``x_init`` [B, N, M], N(0, 1)) or "backbone",
        without a graph; training goes through ``train_forward``."""
        if mode not in ("ddim", "backbone"):
            raise KeyError(mode)
        if mode == "ddim" and x_init is None:
            raise ValueError("mode 'ddim' needs x_init [B, N, M]")
        with torch.no_grad():
            out, enc = self._coarse_pass(batch)
            node_masks, img_valid_c = out["node_masks"], out["img_valid_c"]
            if mode == "backbone":
                out["corr_mask"] = batch_mutual_topk_select(out["conf_matrix_pred"], 1,
                                                            node_masks, img_valid_c, mutual=False)
                return out
            cfg = self.cfg
            x = x_init
            for time, time_next in ddim_time_pairs(cfg.timesteps, cfg.sample_steps):
                x_start = self._denoise(enc, batch, x, out)
                eps = predict_noise_from_start(self.schedule, x, int(time), x_start)
                sqrt_next, c, _ = ddim_coefficients(self.schedule, int(time), int(time_next),
                                                    cfg.ddim_eta)
                x = x_start * sqrt_next + c * eps
            conf = self.denoising_coarse_matching.sinkhorn(x, node_masks, img_valid_c,
                                                           batch.masks[-1],
                                                           torch.ones_like(img_valid_c))
            out["conf_matrix_pred"] = conf
            out["corr_mask"] = mutual_topk_mask(conf, 1, mutual=False) \
                & node_masks[:, :, None] & img_valid_c[:, None, :]
            return out


def _matrix_from_indices(src, tgt, valid, n: int, m: int):
    """The binary GT matrix [B, n, m] (float32) of padded index lists [B, G]."""
    return scatter_pairs(src, tgt, torch.ones(src.shape, dtype=torch.float32, device=src.device),
                         valid, n, m)


def fine_matching(img_feats_f, img_points_f, img_pixels_f, pcd_feats_f, pcd_points_f,
                  corr_src, corr_tgt, corr_valid, node_knn_indices, node_knn_masks,
                  patch_pixel_indices, max_fine_corr: int, topk: int = 2,
                  threshold: float = 0.75) -> dict:
    """Patch-level fine matching of one pair (reference model.py:707-780).

    For each coarse correspondence (node corr_src, patch corr_tgt), the cosine
    similarities of the patch's pixels [Kp] and the node's member points [Kc],
    mutual top-k above ``threshold``; the ``max_fine_corr`` best, deduplicated
    on (pixel, point) and ordered by it, as a fixed-size buffer.
    img_feats_f [H, W, C], img_points_f [H*W, 3], img_pixels_f [H*W, 2],
    pcd_feats_f [N0, C], pcd_points_f [N0, 3], node_knn_* [M, Kc] (sentinel
    N0), patch_pixel_indices [P, Kp]."""
    c = img_feats_f.shape[-1]
    n0 = pcd_feats_f.shape[0]
    img_flat = img_feats_f.reshape(-1, c)
    img_idx = patch_pixel_indices[corr_tgt].long()                    # [C, Kp]
    pcd_idx = node_knn_indices[corr_src].long()                       # [C, Kc]
    pcd_m = node_knn_masks[corr_src] & corr_valid[:, None]
    img_f = img_flat[img_idx]
    pcd_f = torch.cat([pcd_feats_f, pcd_feats_f.new_zeros((1, c))])[pcd_idx]
    sim = torch.einsum("cpk,cqk->cpq", l2_normalize(img_f), l2_normalize(pcd_f))

    corr = batch_mutual_topk_select(sim, topk, valid_row=corr_valid[:, None].expand(img_idx.shape),
                                    valid_col=pcd_m, threshold=threshold, mutual=True)
    scores, order = stable_top_k(torch.where(corr, sim, torch.full_like(sim, NEG_INF)).reshape(-1),
                          max_fine_corr)
    valid = scores > NEG_INF / 2
    kp, kc = img_idx.shape[1], pcd_idx.shape[1]
    ci, pi, qi = order // (kp * kc), (order // kc) % kp, order % kc
    img_sel = img_idx[ci, pi]
    pcd_sel = pcd_idx[ci, qi].clamp_max(n0 - 1)

    # dedup on (pixel, point): a stable sort of one int64 key puts the pairs
    # in the (pixel, point) order of the JAX package's lexsort; keep each first
    big = 2 ** 30
    img_m = torch.where(valid, img_sel, torch.full_like(img_sel, big))
    pcd_m = torch.where(valid, pcd_sel, torch.full_like(pcd_sel, big))
    order2 = torch.sort(img_m * 2 ** 31 + pcd_m, stable=True).indices
    img_s, pcd_s, val_s = img_m[order2], pcd_m[order2], valid[order2]
    first = (img_s != torch.roll(img_s, 1)) | (pcd_s != torch.roll(pcd_s, 1))
    first[0] = True
    uvalid = val_s & first
    img_u = torch.where(uvalid, img_s, torch.zeros_like(img_s))
    pcd_u = torch.where(uvalid, pcd_s, torch.zeros_like(pcd_s))
    out_scores = torch.sum(l2_normalize(img_flat[img_u]) * l2_normalize(pcd_feats_f[pcd_u]),
                           dim=-1)
    return {"img_corr_pixels": img_pixels_f[img_u], "img_corr_points": img_points_f[img_u],
            "pcd_corr_points": pcd_points_f[pcd_u], "pcd_corr_indices": pcd_u,
            "img_corr_indices": img_u,
            "corr_scores": torch.where(uvalid, out_scores, torch.zeros_like(out_scores)),
            "corr_valid": uvalid}


def patch_pixel_table(height, width, stride, subsample=2) -> np.ndarray:
    """Flat pixel indices of each patch's stride-``subsample`` pixel subset
    [P, (stride / subsample)^2] (the reference's patchify)."""
    hp, wp = height // stride, width // stride
    vs = np.arange(hp)[:, None, None, None] * stride + np.arange(0, stride, subsample)[:, None]
    us = np.arange(wp)[None, :, None, None] * stride + np.arange(0, stride, subsample)[None, :]
    return (vs * width + us).reshape(hp * wp, -1).astype(np.int32)
