"""Point sampling ops: farthest point sampling, random choice.

Counterpart of the JAX package's ops/sampling.py (the reference's pointops
sampling kernel and vision3d's samplers). FPS is a loop over the sample
count whose every step is one masked distance update and an argmax on the
device, with no read back to the host.
"""
from __future__ import annotations

import torch

from ..utils.draws import as_draws
from .neighbors import squared_distances


def farthest_point_sampling(points, valid, num_samples: int):
    """FPS over a padded cloud.

    Args:
      points: [N, 3]; valid: [N] bool.
      num_samples: sample count.

    Returns:
      indices [num_samples] int32 (the first index repeated past the number of
      valid points), mask [num_samples] bool. Invalid points are never picked;
      ties go to the lower index.
    """
    dists = torch.where(valid, torch.full_like(points[:, 0], 1.0e10),
                        torch.full_like(points[:, 0], -1.0))
    idxs = torch.zeros(num_samples, dtype=torch.int64, device=points.device)
    idxs[0] = torch.argmax(valid.to(torch.int32))        # the first valid index
    for i in range(1, num_samples):
        last = points.index_select(0, idxs[i - 1:i])        # [1, 3], no host read
        nd = squared_distances(points, last)
        dists = torch.minimum(dists, torch.where(valid, nd, torch.full_like(nd, -1.0)))
        idxs[i] = torch.argmax(dists)
    mask = torch.arange(num_samples, device=points.device) < valid.sum()
    return torch.where(mask, idxs, idxs[:1]).to(torch.int32), mask


def random_choice(rng, n: int, num_samples: int, valid=None):
    """Uniform random indices over [0, n), or over the valid subset of a padded
    set. ``rng``: a ``torch.Generator`` on the wanted device, or a draw source
    (``utils/draws.py``)."""
    rng = as_draws(rng)
    if valid is None:
        return rng.randint((num_samples,), 0, n)
    n_valid = torch.clamp(valid.sum(), min=1)
    u = rng.uniform((num_samples,))
    ranks = (u * n_valid).to(torch.int64)
    order = torch.argsort((~valid).to(torch.int32), stable=True)   # valid indices first
    return order[torch.clamp(ranks, 0, n - 1)]
