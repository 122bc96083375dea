"""Alpha-composited volume integration, forward (port of
``avr_tpu/ops/integrate.py``).

Every constant is the JAX package's: ``1e10`` delta tail, ``alpha = 1 -
exp(-sigma * delta)``, transmittance the shifted cumulative product of
``1 - alpha + 1e-10``, the distance map against shifted z-values whose tail
is ``infinity``, white background ``+ (1 - sum(weights))``.  Plain PyTorch:
the serving path computes it outside any kernel in both packages.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["volume_integral"]

_EPS = 1e-10


def volume_integral(
    z_vals: torch.Tensor,  # (SB, R, n)
    sigmas: torch.Tensor,  # (SB, R, n, 1)
    radiances: torch.Tensor,  # (SB, R, n, 3)
    white_back: bool = True,
    infinity: float = 1.8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``rgb (SB, R, 3)``, ``distance (SB, R, 1)``, ``weights (SB, R, n, 1)``."""
    dists = torch.cat(
        [z_vals[..., 1:] - z_vals[..., :-1], torch.full_like(z_vals[..., :1], 1e10)],
        dim=-1,
    )
    alpha = 1.0 - torch.exp(-sigmas * dists[..., None])
    trans = torch.cumprod(1.0 - alpha + _EPS, dim=-2)
    trans = torch.cat([torch.ones_like(alpha[..., :1, :]), trans[..., :-1, :]], dim=-2)
    weights = alpha * trans
    rgb = torch.sum(weights * radiances, dim=-2)
    zz = torch.cat([z_vals[..., 1:], torch.full_like(z_vals[..., :1], infinity)], dim=-1)
    distance = torch.sum(weights * zz[..., None], dim=-2)
    if white_back:
        rgb = rgb + (1.0 - torch.sum(weights, dim=-2))
    return rgb, distance, weights
