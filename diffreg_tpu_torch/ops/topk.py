"""Top-k: exact ``torch.topk``, the exact branch of the JAX package's ops/topk.py."""
from __future__ import annotations

import torch


def top_k(x, k: int):
    """(values, indices) of the k largest entries along the last axis, descending."""
    return torch.topk(x, k, dim=-1, largest=True, sorted=True)


def stable_top_k(x, k: int):
    """``top_k`` with ties broken by the lower index, as jax.lax.top_k breaks
    them: the same entries on the CPU and the card where values repeat (the
    distances of points on a regular grid, for one)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
