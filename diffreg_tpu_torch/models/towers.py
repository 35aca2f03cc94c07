"""Frozen-tower runner: DINOv2 patch tokens and DepthAnything depth, computed
once per sample outside the 2D-3D model.

Counterpart of the JAX package's models/towers.py. The towers are pure
functions of the image, so they run once per sample on the caller's device,
under ``torch.no_grad`` and outside the training graph, and their outputs
ride the batch (``Batch2D3D.dino_feats`` / ``mono_depth``). Preprocessing as
the reference's:

  * DINOv2 eats the raw RGB image in [0, 1] (no ImageNet normalisation) at a
    crop whose sides are multiples of 14;
  * DepthAnything eats the ImageNet-normalised image, resized bicubically so
    that both sides are multiples of 14 with the lower-bound rule; its depth
    is resized back bilinearly (both as ``jax.image.resize``).

Checkpoints are torch state_dicts with the reference modules' names
(``nn/dinov2.py``, ``nn/depth_anything.py``): the released
``dinov2_vitl14_pretrain.pth`` and ``depth_anything_vitl14.pth`` load as
they are. The JAX package's converted orbax directories are refused.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..nn.depth_anything import DepthAnything, DPTConfig
from ..nn.dinov2 import DinoV2Config, DinoVisionTransformer, vit_large_config
from ..ops.vision import resize
from ..utils.device import resolve_device
from ..utils.precision import pin_float32

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# entries of the released checkpoints that the forward pass does not read:
# DINOv2's mask token (masked-image training) and the reference DPT head's
# refinenet4.resConfUnit1, which it builds and never calls
UNUSED_KEYS = ("mask_token", "pretrained.mask_token")
UNUSED_PREFIXES = ("depth_head.scratch.refinenet4.resConfUnit1.",)


def _multiple_of_14_lower_bound(h: int, w: int, target_h: int, target_w: int):
    """The reference DepthAnything transform's size: scale so that both sides
    reach the target (lower bound), then round each side up to a multiple of
    14."""
    scale = max(target_h / h, target_w / w)
    return int(np.ceil(h * scale / 14) * 14), int(np.ceil(w * scale / 14) * 14)


def synthesise_tower_weights(module: torch.nn.Module, seed: int) -> None:
    """Random weights from ``seed`` for a tower (no released checkpoint is in
    the repository): 1/sqrt(fan_in) normal weights, small normal biases,
    unit LayerNorms with small offsets, LayerScale 1 (as the reference's
    tests build towers with init_values=1, so that every block moves the
    tokens), normal(0.02) cls token and position embeddings."""
    gen = torch.Generator().manual_seed(seed)
    normal = lambda shape, std: torch.randn(shape, generator=gen) * std  # noqa: E731
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "gamma":
                p.fill_(1.0)
            elif leaf in ("cls_token", "pos_embed"):
                p.copy_(normal(p.shape, 0.02))
            elif leaf == "bias":
                p.copy_(normal(p.shape, 0.02))
            elif p.dim() == 1:                               # LayerNorm scale
                p.copy_(1.0 + normal(p.shape, 0.02))
            else:
                fan_in = p.shape[0] if "resize_layers.0" in name or "resize_layers.1" in name \
                    else p[0].numel()                        # ConvTranspose: [I, O, k, k]
                p.copy_(normal(p.shape, fan_in ** -0.5))


class TowerRunner:
    """The frozen towers on ``device`` (default cuda): ``dino`` a
    DinoVisionTransformer, ``depth_anything`` a DepthAnything, either None."""

    def __init__(self, dino: Optional[DinoVisionTransformer] = None,
                 depth_anything: Optional[DepthAnything] = None, device=None):
        self.device = resolve_device(device)
        pin_float32()
        self.dino = None if dino is None else dino.eval().requires_grad_(False).to(self.device)
        self.depth_anything = None if depth_anything is None \
            else depth_anything.eval().requires_grad_(False).to(self.device)

    def _image(self, image_rgb: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(image_rgb, np.float32)).to(
            self.device).permute(0, 3, 1, 2)

    def dino_tokens(self, image_rgb: np.ndarray) -> Optional[np.ndarray]:
        """image_rgb [B, H, W, 3] in [0, 1], H and W multiples of 14 -> the
        final patch tokens [B, H/14, W/14, D] (x_norm_patchtokens)."""
        if self.dino is None:
            return None
        b, h, w, _ = image_rgb.shape
        p = self.dino.cfg.patch_size
        with torch.no_grad():
            tokens, _ = self.dino(self._image(image_rgb))
        return tokens.reshape(b, h // p, w // p, -1).cpu().numpy()

    def mono_depth(self, image_rgb: np.ndarray,
                   target_hw: Tuple[int, int] = (476, 630)) -> Optional[np.ndarray]:
        """image_rgb [B, H, W, 3] in [0, 1] -> DepthAnything's raw output
        [B, H, W], resized back to the input's size."""
        if self.depth_anything is None:
            return None
        b, h, w, _ = image_rgb.shape
        nh, nw = _multiple_of_14_lower_bound(h, w, *target_hw)
        with torch.no_grad():
            x = resize(self._image((image_rgb - IMAGENET_MEAN) / IMAGENET_STD), (nh, nw),
                       "bicubic")
            d = resize(self.depth_anything(x)[:, None], (h, w), "bilinear")
        return d[:, 0].cpu().numpy()


def _state_dict(path: str) -> dict:
    if os.path.isdir(path):
        raise ValueError(
            f"{path!r} is a directory (an orbax checkpoint of the JAX package's "
            "tools/convert_towers.py?): the port reads a torch state_dict file with the "
            "reference modules' names, e.g. the released dinov2_vitl14_pretrain.pth or "
            "depth_anything_vitl14.pth")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    return {k: v for k, v in sd.items()
            if k not in UNUSED_KEYS and not k.startswith(UNUSED_PREFIXES)}


def load_tower_runner(dino_ckpt: Optional[str] = None, da_ckpt: Optional[str] = None,
                      device=None, dino_cfg: Optional[DinoV2Config] = None,
                      da_vit_cfg: Optional[DinoV2Config] = None,
                      da_dpt_cfg: Optional[DPTConfig] = None) -> TowerRunner:
    """The towers of the given torch state_dict files (ViT-L/14 and the DPT
    head's default widths unless configs are given) on ``device``."""
    dino = da = None
    if dino_ckpt:
        dino = DinoVisionTransformer(dino_cfg or vit_large_config())
        dino.load_state_dict(_state_dict(dino_ckpt), strict=True)
    if da_ckpt:
        da = DepthAnything(da_vit_cfg or vit_large_config(), da_dpt_cfg or DPTConfig())
        da.load_state_dict(_state_dict(da_ckpt), strict=True)
    return TowerRunner(dino, da, device=device)
