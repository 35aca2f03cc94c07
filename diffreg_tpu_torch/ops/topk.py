"""Top-k: exact ``torch.topk``, the exact branch of the JAX package's ops/topk.py."""
from __future__ import annotations

import torch


def top_k(x, k: int):
    """(values, indices) of the k largest entries along the last axis, descending."""
    return torch.topk(x, k, dim=-1, largest=True, sorted=True)
