"""SE(3) helpers (batched)."""
from __future__ import annotations


def apply_transform(points, rotation, translation):
    """R p + t for points [B, N, 3], rotation [B, 3, 3], translation [B, 3, 1]."""
    return points @ rotation.transpose(-1, -2) + translation.transpose(-1, -2)
