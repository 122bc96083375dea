"""Resizes as separable interpolation by two small dense matrices, applied
along H then W in float32: bilinear with align_corners=True semantics (port
of ``avr_tpu/ops/resize.py``), and ``jax.image.resize``'s ``"linear"``
(half-pixel centres, a triangle filter widened when it shrinks: the
antialiased resize of the encoder's ``feature_scale``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["resize_bilinear_align_corners", "interp_matrix", "resize_linear",
           "linear_resize_matrix"]


def interp_matrix(out_size: int, in_size: int) -> np.ndarray:
    """Dense ``(out_size, in_size)`` align-corners interpolation matrix."""
    m = np.zeros((out_size, in_size), np.float32)
    if in_size == 1 or out_size == 1:
        m[:, 0] = 1.0
        return m
    pos = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w = (pos - lo).astype(np.float32)
    m[np.arange(out_size), lo] += 1.0 - w
    m[np.arange(out_size), hi] += w
    return m


def resize_bilinear_align_corners(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Resize ``(B, H, W, C)`` (NHWC) to ``(B, H', W', C)`` in float32."""
    H2, W2 = out_hw
    _, H, W, _ = x.shape
    x = x.float()
    if (H, W) == (H2, W2):
        return x
    wy = torch.from_numpy(interp_matrix(H2, H)).to(x.device)
    wx = torch.from_numpy(interp_matrix(W2, W)).to(x.device)
    x = torch.einsum("bhwc,Hh->bHwc", x, wy)
    return torch.einsum("bhwc,Ww->bhWc", x, wx)


def linear_resize_matrix(out_size: int, in_size: int) -> np.ndarray:
    """Dense ``(out_size, in_size)`` weights of ``jax.image.resize``'s
    ``"linear"`` method with its default ``antialias=True``
    (``jax._src.image.scale.compute_weight_mat``, scale ``out / in``, no
    translation), in float32 as JAX computes them."""
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(out_size) / f32(in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32).T


def resize_linear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, (B, H', W', C), "linear")`` of ``(B, H, W, C)``
    (NHWC), in float32."""
    H2, W2 = out_hw
    _, H, W, _ = x.shape
    x = x.float()
    wy = torch.from_numpy(linear_resize_matrix(H2, H)).to(x.device)
    wx = torch.from_numpy(linear_resize_matrix(W2, W)).to(x.device)
    x = torch.einsum("bhwc,Hh->bHwc", x, wy)
    return torch.einsum("bhwc,Ww->bhWc", x, wx)
