"""K7: the threefry key stream's uniform draw — CUDA kernel and plain version.

Replaces ``avr_tpu/ops/pallas/rng.py:54 pallas_uniform_2d`` (call ``:67``).
The TPU kernel's values come from the TPU core's hardware generator, which
has no lowering on any other backend; there the JAX package computes the
same call with ``jax.random.uniform`` (``avr_tpu/ops/sampling.py:55-63``),
and so does this kernel, bit for bit (``csrc/rng.cu``): element ``i`` of a
draw (flat, row-major) is ``x0 ^ x1`` of ``threefry2x32(key, (i >> 32, i &
0xffffffff))``, the uniform ``bitcast((bits >> 9) | 0x3f800000) - 1``.
:func:`bits` is the same kernel with the float epilogue off
(``jax.random.randint``'s raw words).

What bounds it on Hopper: integer operations (~75 a 4-byte element; at
``(4, 81,920)`` ~1.5 us at ~16.7 T int32 operations/s against ~0.4 us of
writes).  One thread an element, grid-stride over the 64-bit flat index, the
key words as kernel arguments, no shared memory.

The plain version (:func:`threefry2x32` on int64 tensors holding words in
``[0, 2**32)``, as ``ops/hashrng.py`` holds its words) runs for CPU devices
only; a CUDA device launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple, Union

import torch

from avr_tpu_torch.ops.kernels import _build

__all__ = ["threefry2x32", "uniform_2d", "uniform_2d_plain", "bits", "bits_plain"]

NAME = "uniform_2d"
NAME_BITS = "uniform_2d_bits"
_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Word = Union[int, torch.Tensor]
Device = Union[str, torch.device]


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0: int, k1: int, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """Threefry-2x32 with 20 rounds (``jax/_src/prng.py``
    ``_threefry2x32_lowering``) on 32-bit words held in Python ints or in
    int64 tensors: ``(x0, x1)`` encrypted under the key ``(k0, k1)``."""
    ks = (k0 & _MASK, k1 & _MASK, (k0 ^ k1 ^ 0x1BD11BDA) & _MASK)
    x0, x1 = (x0 + ks[0]) & _MASK, (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _count(shape: Sequence[int]) -> int:
    if len(shape) != 2 or min(shape) < 0:
        raise ValueError(f"{NAME}: shape must be 2-D (rows, cols), got {tuple(shape)}")
    return int(math.prod(shape))


def bits_plain(key, shape: Sequence[int], device: Device = "cpu") -> torch.Tensor:
    """The words ``x0 ^ x1`` of a 2-D draw as int64 in ``[0, 2**32)``."""
    n = _count(shape)
    i = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(int(key[0]), int(key[1]), i >> 32, i & _MASK)
    return (x0 ^ x1).reshape(tuple(shape))


def uniform_2d_plain(key, shape: Sequence[int], device: Device = "cpu") -> torch.Tensor:
    """Uniform ``[0, 1)`` float32 of a 2-D ``shape`` from ``key = (k0, k1)``:
    ``jax.random.uniform(key, shape)``."""
    b = bits_plain(key, shape, device)
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _launch(key, shape: Sequence[int], device: torch.device, name: str) -> torch.Tensor:
    n = _count(shape)
    uniform = name == NAME
    out = torch.empty(tuple(shape), dtype=torch.float32 if uniform else torch.int64,
                      device=device)
    if n:
        fn = _build.kernel_fn("avr_threefry", [ctypes.c_uint, ctypes.c_uint, ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
        err = fn(int(key[0]) & _MASK, int(key[1]) & _MASK, n, 0 if uniform else 1,
                 _build.ptr(out), ctypes.c_void_p(_build.stream_ptr(device)))
        _build.check(name, err)
    return out


def _device(device: Device, name: str) -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: the draw runs on a CUDA device or the CPU, got {dev}")
    return dev


def uniform_2d(key, shape: Sequence[int], device: Device) -> torch.Tensor:
    """Uniform ``[0, 1)`` float32 of a 2-D ``shape = (rows, cols)`` from the
    threefry key ``(k0, k1)``, on ``device``: the kernel on a CUDA device,
    the plain version on the CPU."""
    dev = _device(device, NAME)
    if dev.type == "cpu":
        return uniform_2d_plain(key, shape, dev)
    return _launch(key, shape, dev, NAME)


def bits(key, shape: Sequence[int], device: Device) -> torch.Tensor:
    """The raw words of a 2-D draw, int64 in ``[0, 2**32)``: the kernel with
    its float epilogue off on a CUDA device, the plain version on the CPU."""
    dev = _device(device, NAME_BITS)
    if dev.type == "cpu":
        return bits_plain(key, shape, dev)
    return _launch(key, shape, dev, NAME_BITS)
