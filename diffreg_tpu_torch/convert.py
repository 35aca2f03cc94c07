"""Weight bridge: the JAX package's flax variables -> the port's state_dict.

Input: flat numpy parameters and buffers with '/'-paths, as
``flax.traverse_util.flatten_dict`` joins them (e.g.
``backbone/enc1_resnetb/UnaryBlock_0/Dense_0/kernel``). Output: tensors
named like the reference torch state_dict (e.g.
``backbone.encoder_blocks.1.unary1.mlp.weight``). Rules:

  * a Dense ``kernel [in, out]`` becomes a Linear ``weight [out, in]``
    (``coarse_out``: a Conv1d ``weight [out, in, 1]``);
  * a LayerNorm ``scale`` becomes ``weight`` (the port keeps Flax's eps 1e-6);
  * KPConv ``weights [P, Cin, Cout]`` and ``kernel_points`` keep their layout.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_UNARY = {"UnaryBlock_0": "unary1", "UnaryBlock_1": "unary2", "UnaryBlock_2": "unary_shortcut"}
_ATTN = {"q_proj": "q_proj", "k_proj": "k_proj", "v_proj": "v_proj", "merge": "merge",
         "mlp0": "mlp.0", "mlp1": "mlp.2", "norm1": "norm1", "norm2": "norm2"}
_MATCHERS = {"coarse_matching": "coarse_matching",
             "denoising_matching": "denoising_coarse_matching"}


def _translate(path: str):
    """(port key, "T" | "conv" | None) for one flax path."""
    m = re.fullmatch(r"backbone/enc(\d+)_(?:simple|resnetb)/KPConvLayer_0/"
                     r"(weights|kernel_points)", path)
    if m:
        return f"backbone.encoder_blocks.{m[1]}.KPConv.{m[2]}", None
    m = re.fullmatch(r"backbone/enc(\d+)_resnetb/(UnaryBlock_\d)/Dense_0/kernel", path)
    if m:
        return f"backbone.encoder_blocks.{m[1]}.{_UNARY[m[2]]}.mlp.weight", "T"
    m = re.fullmatch(r"backbone/dec(\d+)_unary/UnaryBlock_0/Dense_0/kernel", path)
    if m:
        return f"backbone.decoder_blocks.{m[1]}.mlp.weight", "T"
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


def state_dict_from_flax(params_flat: Mapping[str, np.ndarray],
                         buffers_flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Port state_dict entries for every flax parameter and buffer given."""
    out = {}
    for path, arr in {**params_flat, **buffers_flat}.items():
        key, layout = _translate(path)
        a = np.asarray(arr, np.float32)
        if layout == "T":
            a = a.T
        elif layout == "conv":
            a = a.T[:, :, None]
        out[key] = torch.from_numpy(np.array(a, order="C"))   # a 0-d copy stays 0-d
    return out
