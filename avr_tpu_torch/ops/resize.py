"""Bilinear resize with align_corners=True semantics (port of
``avr_tpu/ops/resize.py``): separable interpolation as two small dense
matrices, applied along H then W in float32."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["resize_bilinear_align_corners", "interp_matrix"]


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
