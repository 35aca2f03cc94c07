"""Batch <-> pack layout conversion (the reference's vision3d/ops/conversion.py).

Counterpart of the JAX package's ops/conversion.py, with its static shapes:
``batch_to_pack`` packs the valid rows to the front of a fixed-size buffer
(capacity B*N by default) and ``pack_to_batch`` takes a fixed ``max_length``,
so neither reads a count back to the host. Round trips are exact on the
valid region.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def batch_to_pack(batch_tensor, masks=None, capacity: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[B, N, C] (+ masks [B, N]) -> (packed [M, C], lengths [B], pack_valid
    [M]) with M = capacity (default B*N). Valid rows come first, batch-major,
    as the reference's boolean indexing orders them; the tail is zero."""
    b, n = batch_tensor.shape[:2]
    m = capacity or b * n
    flat = batch_tensor.reshape((b * n,) + batch_tensor.shape[2:])
    if masks is None:
        lengths = torch.full((b,), n, dtype=torch.int32, device=batch_tensor.device)
        valid = torch.ones(b * n, dtype=torch.bool, device=batch_tensor.device)
    else:
        lengths = masks.sum(dim=1).to(torch.int32)
        valid = masks.reshape(-1)
    order = torch.argsort((~valid).to(torch.int32), stable=True)[:m]
    packed = flat[order]
    pack_valid = valid[order]
    packed = torch.where(pack_valid.reshape((-1,) + (1,) * (packed.ndim - 1)), packed,
                         torch.zeros_like(packed))
    return packed, lengths, pack_valid


def pack_to_batch(pack_tensor, lengths, max_length: int, fill_value=0.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(packed [M, C], lengths [B]) -> ([B, max_length, C], masks
    [B, max_length]); rows past each sample's length hold ``fill_value``."""
    b = lengths.shape[0]
    starts = torch.cumsum(lengths, dim=0) - lengths
    col = torch.arange(max_length, device=pack_tensor.device)
    masks = col[None, :] < lengths[:, None]
    src = torch.clamp(starts[:, None] + col[None, :], 0, pack_tensor.shape[0] - 1)
    batch = pack_tensor[src.reshape(-1)].reshape((b, max_length) + pack_tensor.shape[1:])
    fill = torch.full_like(batch, fill_value)
    batch = torch.where(masks.reshape(b, max_length, *([1] * (batch.ndim - 2))), batch, fill)
    return batch, masks
