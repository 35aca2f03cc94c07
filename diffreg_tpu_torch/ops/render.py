"""NeRF-style rendering ops: CDF bin sampling and volumetric compositing.

Counterpart of the JAX package's ops/render.py (the reference's vision3d/ops/
{sample_pdf,volume_render}.py, the URR model family's rendering utilities).
The random draws come in through ``rng``: a ``torch.Generator`` on the
tensors' device or a draw source (``utils/draws.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils.draws import as_draws


def sample_pdf(rng, locations, weights, num_samples: int,
               deterministic: bool = False, eps: float = 1e-5):
    """Inverse-CDF sampling from weighted bins: locations [N, B+1] bin
    boundaries, weights [N, B]. ``rng`` may be None when deterministic."""
    n, b = weights.shape
    w = weights + eps
    pdf = w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)      # [N, B+1]

    if deterministic:
        t = torch.linspace(0.0, 1.0, num_samples, dtype=weights.dtype,
                           device=weights.device).expand(n, num_samples).contiguous()
    else:
        t = as_draws(rng).uniform((n, num_samples), weights.dtype)

    idx = torch.searchsorted(cdf.detach().contiguous(), t, right=True)
    lo = torch.clamp(idx - 1, min=0)
    hi = torch.clamp(idx, max=b)

    cdf_lo = torch.gather(cdf, -1, lo)
    cdf_hi = torch.gather(cdf, -1, hi)
    loc_lo = torch.gather(locations, -1, lo)
    loc_hi = torch.gather(locations, -1, hi)

    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    frac = (t - cdf_lo) / denom
    return loc_lo + frac * (loc_hi - loc_lo)


def volume_render(ray_directions, z_values, point_sigmas,
                  point_colors: Optional[torch.Tensor] = None,
                  sigma_noise: Optional[float] = None, rng=None,
                  opacity_only: bool = False, white_background: bool = False,
                  deterministic: bool = False, eps: float = 1e-10):
    """Volumetric compositing along rays: ray_directions [N, 3], z_values
    [N, M], point_sigmas [N, M], point_colors optional [N, M, 3]. Returns
    (colors, depths, opacities), (depths, opacities) or opacities, as the
    reference does."""
    deltas = z_values[..., 1:] - z_values[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], 1e10)], dim=-1)
    deltas = deltas * torch.linalg.norm(ray_directions, dim=-1)[..., None]

    if (not deterministic) and sigma_noise is not None and sigma_noise > 0.0:
        point_sigmas = point_sigmas + sigma_noise * as_draws(rng).normal(
            point_sigmas.shape, point_sigmas.dtype)

    alphas = 1.0 - torch.exp(-deltas * torch.relu(point_sigmas))
    shifted = torch.cat([torch.ones_like(alphas[..., :1]), 1.0 - alphas + eps], dim=-1)
    opacities = alphas * torch.cumprod(shifted, dim=-1)[..., :-1]
    if opacity_only:
        return opacities

    ray_opacity = opacities.sum(dim=-1)
    depths = torch.sum(opacities * z_values, dim=-1)
    if point_colors is not None:
        colors = torch.sum(opacities[..., None] * point_colors, dim=-2)
        if white_background:
            colors = colors + 1.0 - ray_opacity[..., None]
        return colors, depths, opacities
    return depths, opacities
