"""The threefry key stream: the port's copy of what it needs from ``jax.random``.

A key is two 32-bit words, :class:`Key` ``(k0, k1)``, the data of a raw JAX
``uint32[2]`` key.  Key arithmetic (:func:`PRNGKey`, :func:`split`,
:func:`fold_in`) runs on the host in Python ints: no device work, no sync.
Draws (:func:`random_bits`, :func:`uniform`, :func:`normal`,
:func:`randint`) go through K7 (:mod:`avr_tpu_torch.ops.kernels.rng`): the
kernel on a CUDA device, its plain version on the CPU.

Bit for bit the stream of JAX with ``jax_threefry_partitionable`` on (the
default since JAX 0.5), from ``jax/_src/prng.py`` and ``jax/_src/random.py``
(JAX 0.9):

* the bits of a draw (``_threefry_random_bits_partitionable`` ``:1184``,
  counters from ``iota_2x32_shape`` ``:989``): element ``i``, flat and
  row-major over the whole shape, is ``x0 ^ x1`` of ``threefry2x32(key,
  (i >> 32, i & 0xffffffff))``, so any reshape of a draw's shape gives the
  same values at the same flat index;
* ``split(key, n)[j] = threefry2x32(key, (0, j))``
  (``_threefry_split_foldlike`` ``:1156``), ``fold_in(key, d) =
  threefry2x32(key, (0, d))`` (``_threefry_fold_in`` ``:1168``);
* ``uniform`` (``_uniform`` ``:435``): ``bitcast((bits >> 9) | 0x3f800000) -
  1``, float32 only (JAX's bfloat16 uniform keeps other bits: another
  function, which raises here);
* ``normal`` (``_normal_real`` ``:867``): ``sqrt(2) * erfinv(u)`` with ``u``
  the uniform scaled to ``[lo, 1)``, ``lo = nextafter(-1, 0)``;
* ``randint`` (``_randint`` ``:581``): two draws of bits from ``split(key,
  2)`` combined modulo the span, every product wrapping modulo ``2**32``,
  the multiplier's square ``(2**16 mod span)**2`` included (at a span of
  819,200 it is ``2**32``, which wraps to 0).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Union

import numpy as np
import torch

from avr_tpu_torch.ops.kernels import rng as K7

__all__ = ["Key", "PRNGKey", "split", "fold_in", "random_bits", "uniform", "normal", "randint"]

_MASK = 0xFFFFFFFF
# normal's lower end: the float32 after -1 towards 0; the span 1 - lo rounds to 2
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_NORMAL_SPAN = float(np.float32(1.0) - np.float32(_NORMAL_LO))
_SQRT2 = float(np.float32(np.sqrt(2)))

Device = Union[str, torch.device]


class Key(NamedTuple):
    """A threefry key: the two 32-bit words of JAX's raw key data."""

    k0: int
    k1: int


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` as JAX computes it without 64-bit mode
    (its default): ``(0, seed mod 2**32)``."""
    return Key(0, int(seed) & _MASK)


def _key(key) -> Key:
    if not isinstance(key, Key):
        raise TypeError(f"expected a threefry Key, got {type(key).__name__}")
    return key


def split(key: Key, n: int = 2) -> List[Key]:
    """``jax.random.split(key, n)`` as a list of keys."""
    k = _key(key)
    return [Key(*K7.threefry2x32(k.k0, k.k1, 0, j)) for j in range(n)]


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    k = _key(key)
    return Key(*K7.threefry2x32(k.k0, k.k1, 0, int(data) & _MASK))


def _flat(shape: Sequence[int]):
    """A draw's shape as K7's 2-D ``(rows, cols)``; the stream does not
    depend on the shape, only on the flat index."""
    return (int(shape[0]), int(math.prod(shape[1:])))


def random_bits(key: Key, shape: Sequence[int], device: Device) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 in ``[0, 2**32)``."""
    return K7.bits(_key(key), _flat(shape), device).reshape(tuple(shape))


def uniform(key: Key, shape: Sequence[int], device: Device,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in ``[0, 1)``."""
    if dtype != torch.float32:
        raise TypeError(f"the threefry uniform draws float32 (JAX's {dtype} uniform keeps "
                        f"other bits), got {dtype}")
    return K7.uniform_2d(_key(key), _flat(shape), device).reshape(tuple(shape))


def normal(key: Key, shape: Sequence[int], device: Device,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape)``: ``sqrt(2) * erfinv`` of a uniform on
    ``[nextafter(-1, 0), 1)``; JAX's and PyTorch's ``erfinv`` differ in the
    last bits (up to ~2e-5 absolute in the tails)."""
    u = uniform(key, shape, device, dtype) * _NORMAL_SPAN + _NORMAL_LO
    return _SQRT2 * torch.erfinv(torch.clamp(u, min=_NORMAL_LO))


def randint(key: Key, shape: Sequence[int], minval: int, maxval: int,
            device: Device) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) as int64."""
    span = max(maxval - minval, 1)  # JAX returns minval where maxval <= minval
    if span >= 2 ** 31:
        raise ValueError(f"randint: span {span} does not fit int32")
    k1, k2 = split(_key(key), 2)
    hi, lo = random_bits(k1, shape, device), random_bits(k2, shape, device)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _MASK) % span
    # each product is of two values below span < 2**31: it fits int64, then wraps
    offset = ((((hi % span) * mult) & _MASK) + lo % span) & _MASK
    return minval + offset % span
