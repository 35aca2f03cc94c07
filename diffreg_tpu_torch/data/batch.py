"""Static-shape batch structures (torch counterpart of the JAX package's data/batch.py).

A ``ShapeSpec`` pins every padded dimension of a bucket; a ``PairBatch``
holds one padded batch of registration pairs as torch tensors:

  * per level l: points [B, N_l, 3], validity mask [B, N_l], fixed-K neighbor
    tables [B, N_l, K_l] int32 with sentinel index N_l;
  * pools[l]: queries at level l+1 into level l; upsamples[l]: queries at
    level l into level l+1 (column 0 is the nearest neighbor);
  * coarse split indices [B, S] / [B, T] into the packed coarse level
    (sentinel N_c) with their masks;
  * ground truth pose and coarse matches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """Static shapes for one bucket of registration pairs.

    n_points[l]    — padded packed point count (src+tgt) at pyramid level l.
    k_neighbors[l] — neighbor K at level l.
    k_pools[l]     — pooling K from level l to l+1 (len L-1).
    k_upsamples[l] — upsample K from level l+1 to l (len L-1).
    n_src/n_tgt    — padded coarse src/tgt token counts (S, T).
    n_gt_matches   — padded GT coarse correspondence count.
    """
    n_points: Tuple[int, ...]
    k_neighbors: Tuple[int, ...]
    k_pools: Tuple[int, ...]
    k_upsamples: Tuple[int, ...]
    n_src: int
    n_tgt: int
    n_gt_matches: int

    @property
    def num_levels(self) -> int:
        return len(self.n_points)


@dataclasses.dataclass(frozen=True)
class PairBatch:
    """A batch of registration pairs padded to a ShapeSpec (torch tensors)."""

    points: Tuple[torch.Tensor, ...]       # L x [B, N_l, 3] float32
    masks: Tuple[torch.Tensor, ...]        # L x [B, N_l] bool
    neighbors: Tuple[torch.Tensor, ...]    # L x [B, N_l, K_l] int32 (sentinel N_l)
    pools: Tuple[torch.Tensor, ...]        # (L-1) x [B, N_{l+1}, Kp_l] int32
    upsamples: Tuple[torch.Tensor, ...]    # (L-1) x [B, N_l, Ku_l] int32
    features: torch.Tensor                 # [B, N_0, C_in]
    src_idx_coarse: torch.Tensor           # [B, S] int32 (sentinel N_c)
    tgt_idx_coarse: torch.Tensor           # [B, T] int32
    src_mask: torch.Tensor                 # [B, S] bool
    tgt_mask: torch.Tensor                 # [B, T] bool
    rot_gt: torch.Tensor                   # [B, 3, 3]
    trn_gt: torch.Tensor                   # [B, 3, 1]
    gt_src: torch.Tensor                   # [B, G] int32
    gt_tgt: torch.Tensor                   # [B, G] int32
    gt_valid: torch.Tensor                 # [B, G] bool
    coarse_flow: torch.Tensor              # [B, S, 3]
    gt_cov: Optional[torch.Tensor] = None  # [B, 6, 6]

    @property
    def batch_size(self) -> int:
        return self.features.shape[0]

    def matrix_gt(self) -> torch.Tensor:
        """Dense GT matching matrix [B, S, T] float32: ones at the valid GT
        correspondences; invalid slots (and indices out of range) are dropped."""
        b, s = self.src_mask.shape
        t = self.tgt_mask.shape[1]
        src, tgt = self.gt_src.long(), self.gt_tgt.long()
        keep = self.gt_valid & (src >= 0) & (src < s) & (tgt >= 0) & (tgt < t)
        flat = torch.where(keep, src * t + tgt, torch.full_like(src, s * t))
        m = torch.zeros((b, s * t + 1), dtype=torch.float32, device=src.device)
        m.scatter_(1, flat, 1.0)
        return m[:, :s * t].reshape(b, s, t)

    def map(self, fn) -> "PairBatch":
        """Apply ``fn`` to every tensor (tuples element-wise)."""
        def one(v):
            if v is None:
                return None
            if isinstance(v, tuple):
                return tuple(fn(t) for t in v)
            return fn(v)
        return PairBatch(**{f.name: one(getattr(self, f.name))
                            for f in dataclasses.fields(self)})

    def to(self, device) -> "PairBatch":
        return self.map(lambda t: t.to(device))

    def select(self, index: slice) -> "PairBatch":
        """The pairs ``index`` (a slice over the batch axis)."""
        return self.map(lambda t: t[index])

    @classmethod
    def from_numpy(cls, stacked: dict) -> "PairBatch":
        """Wrap a dict of stacked numpy arrays (see ``stack_pairs``)."""
        def conv(v):
            if v is None:
                return None
            if isinstance(v, tuple):
                return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in v)
            return torch.from_numpy(np.ascontiguousarray(v))
        return cls(**{f.name: conv(stacked.get(f.name)) for f in dataclasses.fields(cls)})


def pad_to(arr: np.ndarray, size: int, axis: int = 0, fill=0):
    """Pad ``arr`` with ``fill`` along ``axis`` up to ``size`` (host-side)."""
    pad = size - arr.shape[axis]
    if pad < 0:
        raise ValueError(f"bucket too small: have {arr.shape[axis]}, need <= {size}")
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=fill)


def stack_pairs(samples: Sequence[dict]) -> dict:
    """Stack a list of per-pair dicts of numpy arrays along a new batch axis."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if vals[0] is None:
            out[key] = None
        elif isinstance(vals[0], (list, tuple)):
            out[key] = tuple(np.stack([v[i] for v in vals]) for i in range(len(vals[0])))
        else:
            out[key] = np.stack(vals)
    return out
