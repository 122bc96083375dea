"""Bilinear feature-map sampling, the pixel-aligned "index" gather (port of
``avr_tpu/ops/grid_sample.py``): ``F.grid_sample(align_corners=True,
padding_mode="border")`` semantics on NHWC maps, through the K1 kernel
wrapper (its plain version for CPU tensors)."""

from __future__ import annotations

import torch

from avr_tpu_torch.ops.kernels.gather import gather_bilinear

__all__ = ["grid_sample_2d"]


def grid_sample_2d(features: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``features (B, H, W, C)`` at ``coords (B, N, 2)`` (``(x, y)`` in [-1, 1])
    -> ``(B, N, C)`` in the features' dtype."""
    return gather_bilinear(features, coords.float().contiguous())
