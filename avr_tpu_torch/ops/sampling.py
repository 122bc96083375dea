"""Depth samplers along rays (port of ``avr_tpu/ops/sampling.py``).

Only the per-ray hash stream (:class:`~avr_tpu_torch.ops.hashrng.RaySeeds`)
is ported: it gives the JAX package's random numbers bit for bit.  The
legacy ``jax.random`` key stream is not.
"""

from __future__ import annotations

import torch

from avr_tpu_torch.ops.hashrng import RaySeeds, hash_normal, hash_uniform

__all__ = ["sample_coarse"]


def _uniform_2d(key: RaySeeds, shape, dtype=torch.float32) -> torch.Tensor:
    return hash_uniform(key, shape).to(dtype)


def _normal_2d(key: RaySeeds, shape, dtype=torch.float32) -> torch.Tensor:
    return hash_normal(key, shape).to(dtype)


def sample_coarse(
    key: RaySeeds,
    near: torch.Tensor,  # (SB, R)
    far: torch.Tensor,  # (SB, R)
    num_samples: int,
) -> torch.Tensor:
    """Stratified z-values: ``n`` bins in [near, far], uniform jitter per bin.

    Returns ``(SB, R, num_samples)``, monotone along the last axis by
    construction (sample k jitters inside bin k).
    """
    steps = torch.arange(num_samples, dtype=torch.float32, device=near.device) / num_samples
    span = far - near
    z_vals = near[..., None] + span[..., None] * steps
    jitter = _uniform_2d(key, z_vals.shape, z_vals.dtype)
    return z_vals + jitter * span[..., None] / num_samples
