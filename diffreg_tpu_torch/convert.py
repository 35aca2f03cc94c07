"""Weight bridge: the JAX package's flax variables -> the port's state_dict,
for the 3D model (``state_dict_from_flax``), the 2D-3D model
(``state_dict_2d3d_from_flax``) and its frozen towers
(``dinov2_state_dict_from_flax``, ``depth_anything_state_dict_from_flax``).

Input: flat numpy parameters and buffers with '/'-paths, as
``flax.traverse_util.flatten_dict`` joins them (e.g.
``backbone/enc1_resnetb/UnaryBlock_0/Dense_0/kernel``). Output: tensors
named like the reference torch state_dict (e.g.
``backbone.encoder_blocks.1.unary1.mlp.weight``). Rules:

  * a Dense ``kernel [in, out]`` becomes a Linear ``weight [out, in]``
    (``coarse_out``: a Conv1d ``weight [out, in, 1]``);
  * a LayerNorm ``scale`` becomes ``weight`` (the port keeps Flax's eps 1e-6);
  * KPConv ``weights [P, Cin, Cout]`` and ``kernel_points`` keep their layout;
    a deformable KPConv's ``offset_weights`` and ``offset_kernel_points``
    become its ``offset_conv.weights`` and ``offset_conv.kernel_points``, and
    ``offset_bias`` keeps its name (the reference's deformable KPConv); a
    ``NormBlock``'s bias (``use_batch_norm`` False) becomes the reference's
    ``batch_norm.bias`` (``batch_norm_conv.bias`` for a bottleneck's conv);
  * (2D-3D) a Conv ``kernel [H, W, I, O]`` becomes a Conv2d ``weight
    [O, I, H, W]``; a GroupNorm ``scale`` becomes ``weight``; the port's names
    are the reference's (tools/convert_checkpoint_2d3d.py lists them);
  * (towers) the names are the reference torch modules' (the inverse of
    tools/convert_towers.py's mapping). A flax ``ConvTranspose`` (DPT's
    ``resize0`` / ``resize1``) correlates the stride-dilated input with its
    kernel, which is torch's ConvTranspose2d with the kernel flipped in both
    spatial axes: ``kernel [H, W, I, O]`` becomes ``weight [I, O, H, W]`` of
    the flipped kernel.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_UNARY = {"UnaryBlock_0": "unary1", "UnaryBlock_1": "unary2", "UnaryBlock_2": "unary_shortcut"}
_KPCONV = {"weights": "weights", "kernel_points": "kernel_points",
           "offset_weights": "offset_conv.weights", "offset_bias": "offset_bias",
           "offset_kernel_points": "offset_conv.kernel_points"}
_ATTN = {"q_proj": "q_proj", "k_proj": "k_proj", "v_proj": "v_proj", "merge": "merge",
         "mlp0": "mlp.0", "mlp1": "mlp.2", "norm1": "norm1", "norm2": "norm2"}
_MATCHERS = {"coarse_matching": "coarse_matching",
             "denoising_matching": "denoising_coarse_matching"}


def _translate(path: str):
    """(port key, "T" | "conv" | None) for one flax path."""
    m = re.fullmatch(r"backbone/enc(\d+)_(?:simple|resnetb)/KPConvLayer_0/(\w+)", path)
    if m and m[2] in _KPCONV:
        return f"backbone.encoder_blocks.{m[1]}.KPConv.{_KPCONV[m[2]]}", None
    m = re.fullmatch(r"backbone/enc(\d+)_(simple|resnetb)/NormBlock_0/bias", path)
    if m:
        norm = "batch_norm" if m[2] == "simple" else "batch_norm_conv"
        return f"backbone.encoder_blocks.{m[1]}.{norm}.bias", None
    m = re.fullmatch(r"backbone/enc(\d+)_resnetb/(UnaryBlock_\d)/(Dense_0/kernel|"
                     r"NormBlock_0/bias)", path)
    if m:
        name = f"backbone.encoder_blocks.{m[1]}.{_UNARY[m[2]]}"
        return (f"{name}.mlp.weight", "T") if m[3] == "Dense_0/kernel" \
            else (f"{name}.batch_norm.bias", None)
    m = re.fullmatch(r"backbone/dec(\d+)_unary/UnaryBlock_0/(Dense_0/kernel|NormBlock_0/bias)",
                     path)
    if m:
        return (f"backbone.decoder_blocks.{m[1]}.mlp.weight", "T") if m[2] == "Dense_0/kernel" \
            else (f"backbone.decoder_blocks.{m[1]}.batch_norm.bias", None)
    m = re.fullmatch(r"backbone/(coarse_out|coarse_in|fine_out)/(kernel|bias)", path)
    if m:
        return (f"backbone.{m[1]}.weight", "conv") if m[2] == "kernel" \
            else (f"backbone.{m[1]}.bias", None)
    m = re.fullmatch(r"(coarse_transformer|denoising_transformer)/layer(\d+)_(self|cross)/"
                     r"(\w+)/(kernel|scale|bias)", path)
    if m:
        name = f"{m[1]}.layers.{m[2]}.{_ATTN[m[4]]}"
        return {"kernel": (f"{name}.weight", "T"), "scale": (f"{name}.weight", None),
                "bias": (f"{name}.bias", None)}[m[5]]
    m = re.fullmatch(r"coarse_transformer/layer(\d+)_matching/(src_proj/kernel|bin_score)", path)
    if m:
        prefix = f"coarse_transformer.layers.{m[1]}.0"
        return (f"{prefix}.src_proj.weight", "T") if m[2] != "bin_score" \
            else (f"{prefix}.bin_score", None)
    m = re.fullmatch(r"(coarse_matching|denoising_matching)/(src_proj/kernel|bin_score)", path)
    if m:
        prefix = _MATCHERS[m[1]]
        return (f"{prefix}.src_proj.weight", "T") if m[2] != "bin_score" \
            else (f"{prefix}.bin_score", None)
    raise KeyError(f"no port counterpart for flax path {path!r}")


_FUSIONS = {"fusion": "transformer", "denoising_fusion": "denoising_transformer"}
_FUSION_LAYER = {"linear": "attention.linear", "norm1": "attention.norm",
                 "expand": "output.expand", "squeeze": "output.squeeze", "norm2": "output.norm"}


def _translate_2d3d(path: str):
    """(port key, "T" | "conv2d" | None) for one flax path of ``DiffReg2D3D``."""
    m = re.fullmatch(r"img_backbone/(\w+)(/conv1|/conv2|/identity)?/(Conv_0|GroupNorm_0)/"
                     r"(kernel|scale|bias)", path)
    if m:
        # encoderN_i and decoderX_2_i are the i-th blocks of a Sequential
        block = re.sub(r"^(encoder[2-4]|decoder\d_2)_(\d)$", r"\1.\2", m[1])
        name = f"img_backbone.{block}{(m[2] or '').replace('/', '.')}." \
            + ("conv" if m[3] == "Conv_0" else "norm")
        if m[4] == "kernel":
            return f"{name}.weight", "conv2d"
        return f"{name}.{'weight' if m[4] == 'scale' else 'bias'}", None
    m = re.fullmatch(r"pcd_backbone/(.+?)/(kpconv/weights|kpconv/kernel_points|norm/scale|"
                     r"norm/bias|mlp/kernel|mlp/bias|bias)", path)
    if m:
        leaf = {"kpconv/weights": "weights", "kpconv/kernel_points": "kernel_points",
                "norm/scale": "norm.norm.weight", "norm/bias": "norm.norm.bias",
                "mlp/kernel": "mlp.weight", "mlp/bias": "mlp.bias", "bias": "bias"}[m[2]]
        return (f"pcd_backbone.{m[1].replace('/', '.')}.{leaf}",
                "T" if m[2] == "mlp/kernel" else None)
    m = re.fullmatch(r"pcd_backbone/out_proj/(kernel|bias)", path)
    if m:
        return ("pcd_backbone.out_proj.weight", "T") if m[1] == "kernel" \
            else ("pcd_backbone.out_proj.bias", None)
    m = re.fullmatch(r"(fusion|denoising_fusion)/(?:transformer(\d+)/)?"
                     r"(?:attention/)?(\w+)/(kernel|scale|bias)", path)
    if m:
        prefix, index, layer, leaf = _FUSIONS[m[1]], m[2], m[3], m[4]
        if index is None:
            name = f"{prefix}.{layer}"
        elif layer.endswith("_token_layer"):
            name = f"{prefix}.transformer.{index}.attention.attention.{layer}"
        else:
            name = f"{prefix}.transformer.{index}.{_FUSION_LAYER[layer]}"
        return {"kernel": (f"{name}.weight", "T"), "scale": (f"{name}.weight", None),
                "bias": (f"{name}.bias", None)}[leaf]
    m = re.fullmatch(r"(coarse_matching|denoising_matching)/(src_proj/kernel|bin_score)", path)
    if m:
        prefix = _MATCHERS[m[1]]
        return (f"{prefix}.src_proj.weight", "T") if m[2] != "bin_score" \
            else (f"{prefix}.bin_score", None)
    m = re.fullmatch(r"dino_proj/(kernel|bias)", path)
    if m:
        return ("dino_proj.weight", "T") if m[1] == "kernel" else ("dino_proj.bias", None)
    if path in ("depth_coffa", "depth_coffb"):
        return path, None
    raise KeyError(f"no port counterpart for flax path {path!r}")


_DINO_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "gamma": "gamma"}
_DINO_BLOCK = {"norm1": "norm1", "attn/qkv": "attn.qkv", "attn/proj": "attn.proj", "ls1": "ls1",
               "norm2": "norm2", "mlp_fc1": "mlp.fc1", "mlp_fc2": "mlp.fc2", "ls2": "ls2"}


def _translate_dinov2(path: str):
    """(port key, layout) for one flax path of ``DinoVisionTransformer``."""
    if path in ("cls_token", "pos_embed"):
        return path, None
    m = re.fullmatch(r"patch_embed/(kernel|bias)", path)
    if m:
        return f"patch_embed.proj.{_DINO_LEAF[m[1]]}", "conv2d" if m[1] == "kernel" else None
    m = re.fullmatch(r"block(\d+)/(norm1|attn/qkv|attn/proj|ls1|norm2|mlp_fc1|mlp_fc2|ls2)/"
                     r"(kernel|scale|bias|gamma)", path)
    if m:
        return f"blocks.{m[1]}.{_DINO_BLOCK[m[2]]}.{_DINO_LEAF[m[3]]}", \
            "T" if m[3] == "kernel" else None
    m = re.fullmatch(r"norm/(scale|bias)", path)
    if m:
        return f"norm.{_DINO_LEAF[m[1]]}", None
    raise KeyError(f"no port counterpart for flax path {path!r}")


def _translate_dpt_head(path: str):
    """(port key, layout) for one flax path of ``DPTHead``, under ``depth_head.``."""
    m = re.fullmatch(r"(project|rn|resize)(\d)/(kernel|bias)", path)
    if m:
        i, leaf = int(m[2]), _DINO_LEAF[m[3]]
        name = {"project": f"projects.{i}", "rn": f"scratch.layer{i + 1}_rn",
                "resize": f"resize_layers.{i}"}[m[1]]
        layout = None if m[3] == "bias" else "conv_t" if m[1] == "resize" and i < 2 else "conv2d"
        return f"depth_head.{name}.{leaf}", layout
    m = re.fullmatch(r"fusion(\d)/(?:(rcu[12])/)?(conv1|conv2|out_conv)/(kernel|bias)", path)
    if m:
        unit = f"resConfUnit{m[2][-1]}." if m[2] else ""
        return f"depth_head.scratch.refinenet{m[1]}.{unit}{m[3]}.{_DINO_LEAF[m[4]]}", \
            "conv2d" if m[4] == "kernel" else None
    m = re.fullmatch(r"head_conv([123])/(kernel|bias)", path)
    if m:
        name = {"1": "output_conv1", "2": "output_conv2.0", "3": "output_conv2.2"}[m[1]]
        return f"depth_head.scratch.{name}.{_DINO_LEAF[m[2]]}", \
            "conv2d" if m[2] == "kernel" else None
    raise KeyError(f"no port counterpart for flax path {path!r}")


def _translate_depth_anything(path: str):
    """(port key, layout) for one flax path of ``DepthAnything``."""
    if path.startswith("encoder/"):
        key, layout = _translate_dinov2(path[len("encoder/"):])
        return f"pretrained.{key}", layout
    if path.startswith("head/"):
        return _translate_dpt_head(path[len("head/"):])
    raise KeyError(f"no port counterpart for flax path {path!r}")


def _convert(params_flat, buffers_flat, translate) -> Dict[str, torch.Tensor]:
    out = {}
    for path, arr in {**params_flat, **buffers_flat}.items():
        key, layout = translate(path)
        a = np.asarray(arr, np.float32)
        if layout == "T":
            a = a.T
        elif layout == "conv":
            a = a.T[:, :, None]
        elif layout == "conv2d":
            a = a.transpose(3, 2, 0, 1)
        elif layout == "conv_t":
            a = a[::-1, ::-1].transpose(2, 3, 0, 1)
        out[key] = torch.from_numpy(np.array(a, order="C"))   # a 0-d copy stays 0-d
    return out


def state_dict_from_flax(params_flat: Mapping[str, np.ndarray],
                         buffers_flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Port state_dict entries for every flax parameter and buffer given."""
    return _convert(params_flat, buffers_flat, _translate)


def state_dict_2d3d_from_flax(params_flat: Mapping[str, np.ndarray],
                              buffers_flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``DiffReg2D3D`` state_dict entries for every flax parameter and buffer
    of the JAX package's DiffReg2D3D (with ``use_dino``: ``dino_proj`` and the
    fusions' ``img_in_proj_dino`` / ``img_in_proj_all``; with
    ``use_mono_depth``: ``depth_coffa`` / ``depth_coffb``)."""
    return _convert(params_flat, buffers_flat, _translate_2d3d)


def dinov2_state_dict_from_flax(params_flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``nn.dinov2.DinoVisionTransformer`` state_dict of the JAX package's
    DinoVisionTransformer params."""
    return _convert(params_flat, {}, _translate_dinov2)


def depth_anything_state_dict_from_flax(
        params_flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``nn.depth_anything.DepthAnything`` state_dict of the JAX package's
    DepthAnything params (``encoder/...``, ``head/...``)."""
    return _convert(params_flat, {}, _translate_depth_anything)
