"""Sharding-invariant per-ray RNG: counter-based hashing on global ray ids.

Bit-exact port of ``avr_tpu/ops/hashrng.py``: every sampler draw is a
murmur3-finalizer hash of ``(step key, global ray id, static salt,
counter)``, so the same rays give the same random numbers in both packages
and under any chunking of the ray batch.

The hashes are uint32 arithmetic.  PyTorch's uint32 dtype lacks most
operators, so the words live in int64 tensors holding values in
``[0, 2**32)``: every shift and add is masked back to 32 bits, and the
multiply is split into 16-bit halves so no intermediate leaves int64's
range (a plain int64 product of two 32-bit words can overflow).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Sequence, Union

import numpy as np
import torch

from avr_tpu_torch.ops import threefry

__all__ = [
    "RaySeeds", "KeyBlock", "KeyLike", "derive", "split_any", "hash_uniform", "hash_normal",
    "global_ray_ids", "shard_ray_ids",
]

_MASK = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
# 2*pi rounded to float32 exactly as the JAX package computes it
_TWO_PI_F32 = float(np.float32(2.0) * np.float32(np.pi))


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """``a * m mod 2**32`` for words ``a`` in [0, 2**32) and a constant ``m``."""
    lo, hi = m & 0xFFFF, m >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer."""
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def _mix(a: torch.Tensor, b: int) -> torch.Tensor:
    """Combine two u32 words with avalanche (order-sensitive)."""
    t = ((b + _GOLDEN) + ((a << 6) & _MASK) + (a >> 2)) & _MASK
    return _fmix32(a ^ t)


@dataclass(frozen=True)
class RaySeeds:
    """Per-ray RNG state: ``seeds`` is ``(SB, R)`` int64 holding u32 words;
    ``salt`` is a static stream discriminator folded by :func:`split_any`."""

    seeds: torch.Tensor
    salt: int = 0

    def fold(self, s: int) -> "RaySeeds":
        return replace(self, salt=(self.salt * 1000003 + s) & _MASK)


def derive(k0: int, k1: int, gids: torch.Tensor) -> RaySeeds:
    """Per-ray seeds from the two key words and ``(SB, R)`` global ray ids.

    ``k0``/``k1`` are the first and last words of the JAX key data that
    ``avr_tpu.ops.hashrng.derive`` reads: ``(0, i)`` for a threefry
    ``jax.random.PRNGKey(i)``.
    """
    h = _mix(gids.to(torch.int64) & _MASK, 0)
    h = _fmix32(h ^ (int(k0) & _MASK))
    return RaySeeds(seeds=_fmix32(h ^ (int(k1) & _MASK)))


@dataclass(frozen=True)
class KeyBlock:
    """A threefry key whose draws are a block of the global batch's: a draw
    of shape ``(SB, R, ...)`` is the draw of ``(SB_global, R_global, ...)``
    with this key, sliced at ``(sb0, r0)``.  This is what a step that
    partitions the single-device program (JAX's GSPMD step) draws with the
    legacy key: every rank draws the global stream and keeps its block."""

    key: threefry.Key
    global_shape: tuple  # (SB_global, R_global)
    offset: tuple  # (sb0, r0)

    def take(self, draw, shape: Sequence[int], device) -> torch.Tensor:
        """``draw(key, global shape, device)`` sliced to this block's ``shape``."""
        (SB, R), (s0, r0) = self.global_shape, self.offset
        full = draw(self.key, (SB, R, *shape[2:]), device)
        return full[s0:s0 + shape[0], r0:r0 + shape[1]]


KeyLike = Union[RaySeeds, threefry.Key, KeyBlock]


def split_any(key: KeyLike, n: int = 2) -> list:
    """``n`` independent streams: static salt folds of a seed map, or
    ``threefry.split`` of a threefry key (as JAX's ``split_any``); a
    :class:`KeyBlock`'s keys split and keep the block."""
    if isinstance(key, RaySeeds):
        return [key.fold(i + 1) for i in range(n)]
    if isinstance(key, KeyBlock):
        return [replace(key, key=k) for k in threefry.split(key.key, n)]
    return threefry.split(key, n)


def _bits(rs: RaySeeds, n: int) -> torch.Tensor:
    """(SB, R, n) u32 counter-hash lanes for draw ``salt``."""
    base = _fmix32(rs.seeds ^ (rs.salt & _MASK))
    ctr = _mul32(torch.arange(1, n + 1, dtype=torch.int64, device=rs.seeds.device),
                 _GOLDEN)
    return _fmix32(base[..., None] ^ ctr)


def _check_shape(rs: RaySeeds, shape: Sequence[int]) -> int:
    if tuple(shape[:2]) != tuple(rs.seeds.shape):
        raise ValueError(f"shape {tuple(shape)} vs seeds {tuple(rs.seeds.shape)}")
    return 1 if len(shape) == 2 else int(np.prod(shape[2:]))


def hash_uniform(rs: RaySeeds, shape: Sequence[int]) -> torch.Tensor:
    """Uniform [0, 1) float32 on a 24-bit grid; ``shape`` is ``(SB, R)`` or
    ``(SB, R, ...)`` with ``(SB, R) == rs.seeds.shape``."""
    n = _check_shape(rs, shape)
    u = (_bits(rs, n) >> 8).to(torch.float32) * (2.0 ** -24)
    return u.reshape(tuple(shape))


def hash_normal(rs: RaySeeds, shape: Sequence[int]) -> torch.Tensor:
    """Standard normals via Box-Muller on two independent uniform lanes."""
    n = _check_shape(rs, shape)
    lanes = (shape[0], shape[1], n)
    u1 = hash_uniform(rs.fold(7919), lanes)
    u2 = hash_uniform(rs.fold(104729), lanes)
    r = torch.sqrt(-2.0 * torch.log1p(-u1))  # u1 in [0,1) -> 1-u1 in (0,1]
    return (r * torch.cos(_TWO_PI_F32 * u2)).reshape(tuple(shape))


def global_ray_ids(SB: int, R: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """``(SB, R)`` u32 global ids ``s * R + r`` (the JAX ``global_ray_ids``)."""
    s = torch.arange(SB, dtype=torch.int64, device=device)[:, None]
    r = torch.arange(R, dtype=torch.int64, device=device)[None, :]
    return (s * R + r) & _MASK


def shard_ray_ids(SB_local: int, R_local: int, data_index: int, rays_index: int,
                  rays_size: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """``(SB_local, R_local)`` global ids of the block at mesh coordinates
    ``(data_index, rays_index)`` of a ``(data, rays)`` mesh whose rays axis
    has ``rays_size`` ranks: the matching block of ``global_ray_ids(SB_local
    * data_size, R_local * rays_size)`` (JAX's ``shard_ray_ids``, with the
    axis indices given)."""
    R_global = R_local * rays_size
    s = data_index * SB_local + torch.arange(SB_local, dtype=torch.int64, device=device)
    r = rays_index * R_local + torch.arange(R_local, dtype=torch.int64, device=device)
    return (s[:, None] * R_global + r[None, :]) & _MASK
