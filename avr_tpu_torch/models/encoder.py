"""Pixel-aligned spatial encoder (port of ``avr_tpu/models/encoder.py``
``SpatialEncoder``; the global and custom encoders are not ported)."""

from __future__ import annotations

import torch
from torch import nn

from avr_tpu_torch.models.resnet import ResNetTrunk
from avr_tpu_torch.ops.resize import resize_bilinear_align_corners

__all__ = ["SpatialEncoder"]


class SpatialEncoder(nn.Module):
    """``(B, H, W, 3)`` NHWC images -> ``(latent, latent_scaling)``.

    ``latent`` is ``(B, H', W', latent_size)`` in the compute dtype: the
    trunk stages upsampled (align corners) to the stem's resolution and
    concatenated.  ``latent_scaling = [2W'/(W'-1), 2H'/(H'-1)]`` maps pixel
    uv to grid coordinates as ``uv * latent_scaling / image_size - 1``.
    """

    def __init__(self, backbone: str = "resnet34", num_layers: int = 4,
                 use_first_pool: bool = True, dtype: torch.dtype = torch.float32,
                 norm_type: str = "batch"):
        super().__init__()
        self.model = ResNetTrunk(backbone, num_layers, use_first_pool, norm_type)
        self.latent_size = ResNetTrunk.latent_size(backbone, num_layers)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, train: bool = False):
        """``train`` runs BatchNorm on batch statistics and updates the
        running ones (the other norms use the input's statistics always)."""
        feats = self.model(x.permute(0, 3, 1, 2).to(self.dtype), train)
        hw = feats[0].shape[2:]
        feats = [resize_bilinear_align_corners(f.permute(0, 2, 3, 1), hw) for f in feats]
        latent = torch.cat(feats, dim=-1).to(self.dtype).contiguous()
        Hl, Wl = latent.shape[1:3]
        scaling = torch.tensor([2.0 * Wl / (Wl - 1), 2.0 * Hl / (Hl - 1)],
                               dtype=torch.float32, device=latent.device)
        return latent, scaling
