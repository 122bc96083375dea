"""Depth samplers along rays (port of ``avr_tpu/ops/sampling.py``):
stratified (:func:`sample_coarse`), bucket-level inverse-CDF importance
(:func:`sample_fine`) and depth-guided (:func:`sample_depth`).

Every draw takes either kind of key, as in JAX: a per-ray hash seed map
(:class:`~avr_tpu_torch.ops.hashrng.RaySeeds`, ``rng_mode="per_ray"``) or a
threefry key (:class:`~avr_tpu_torch.ops.threefry.Key`, the legacy stream
that JAX's ``render_full_image`` and ``rng_mode="legacy"`` pass).  Both
give the JAX package's random numbers bit for bit (the threefry normal up to
``erfinv``'s last bits).  A threefry draw is made flat, ``(shape[0],
prod(shape[1:]))``, through K7 (:mod:`avr_tpu_torch.ops.kernels.rng`): the
kernel on a CUDA device, its plain version on the CPU.
"""

from __future__ import annotations

import torch

from avr_tpu_torch.ops import threefry
from avr_tpu_torch.ops.hashrng import (KeyBlock, KeyLike, RaySeeds, hash_normal, hash_uniform,
                                       split_any)

__all__ = ["sample_coarse", "sample_fine", "sample_depth"]


def _uniform_2d(key: KeyLike, shape, device, dtype=torch.float32) -> torch.Tensor:
    """A uniform draw of ``shape`` on ``device``: the per-ray hash for a
    :class:`RaySeeds`, K7's threefry draw for a threefry key (for a
    :class:`KeyBlock`, the global draw's block)."""
    if isinstance(key, RaySeeds):
        return hash_uniform(key, shape).to(dtype)
    if isinstance(key, KeyBlock):
        return key.take(lambda k, s, d: threefry.uniform(k, s, d, dtype), shape, device)
    return threefry.uniform(key, shape, device, dtype)


def _normal_2d(key: KeyLike, shape, device, dtype=torch.float32) -> torch.Tensor:
    """A standard normal draw of ``shape`` (see :func:`_uniform_2d`)."""
    if isinstance(key, RaySeeds):
        return hash_normal(key, shape).to(dtype)
    if isinstance(key, KeyBlock):
        return key.take(lambda k, s, d: threefry.normal(k, s, d, dtype), shape, device)
    return threefry.normal(key, shape, device, dtype)


def sample_coarse(
    key: KeyLike,
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
    jitter = _uniform_2d(key, z_vals.shape, near.device, z_vals.dtype)
    return z_vals + jitter * span[..., None] / num_samples


def sample_fine(
    key: KeyLike,
    near: torch.Tensor,  # (SB, R)
    far: torch.Tensor,  # (SB, R)
    num_samples: int,
    weights: torch.Tensor,  # (SB, R, n_coarse) or (SB, R, n_coarse, 1)
) -> torch.Tensor:
    """Bucket-level inverse-CDF importance sampling over coarse weights
    (reference ``renderers.py:27-54``): the weights detached and floored by
    ``1e-5``, a 0 prepended to the CDF, the bin ``searchsorted(cdf, u,
    right) - 1`` clamped at 0, and the sample a fresh uniform draw inside
    that coarse bin.  Returns ``(SB, R, num_samples)``."""
    if weights.ndim == 4:
        weights = weights[..., 0]
    n_coarse = weights.shape[-1]
    w = weights.detach() + 1e-5
    pdf = w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (SB, R, n + 1)
    k_u, k_jitter = split_any(key)
    u_shape = tuple(weights.shape[:-1]) + (num_samples,)
    u = _uniform_2d(k_u, u_shape, weights.device)
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    inds = torch.clamp(inds.to(torch.float32) - 1.0, min=0.0)
    z_steps = (inds + _uniform_2d(k_jitter, u_shape, weights.device)) / n_coarse
    return near[..., None] + (far - near)[..., None] * z_steps


def sample_depth(
    key: KeyLike,
    depth: torch.Tensor,  # (SB, R, 1)
    num_samples: int,
    depth_std: float,
    mode: str = "reference",
) -> torch.Tensor:
    """Depth-guided gaussian samples ``(SB, R, num_samples)``.

    ``mode="reference"`` is the reference as written (``renderers.py:56-66``):
    ``N(0, depth_std)`` with the depth mean dropped, so once the renderer
    clips to ``[near, far]`` every sample sits at ``near``.  ``"intended"``
    adds the mean.
    """
    SB, R, _ = depth.shape
    noise = _normal_2d(key, (SB, R, num_samples), depth.device) * depth_std
    if mode == "reference":
        return noise
    if mode == "intended":
        return depth + noise
    raise ValueError(f"unknown sample_depth mode: {mode!r}")
