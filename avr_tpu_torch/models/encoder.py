"""Image encoders producing the conditioning latents (port of
``avr_tpu/models/encoder.py``).

* :class:`SpatialEncoder`: the pixel-aligned latent, the ResNet trunk's
  stages upsampled (bilinear, align corners) to the stem's resolution and
  concatenated, or with ``backbone = custom`` the :class:`ConvEncoder`'s
  map; ``feature_scale`` resizes the input first (``jax.image.resize``'s
  ``"linear"``, antialiased when it shrinks: ``ops/resize.py
  resize_linear``).
* :class:`ImageEncoder`: the global latent, the whole trunk's last stage
  mean-pooled, then ``fc`` to ``latent_size`` (unless 512).
* :class:`ConvEncoder`: the custom U-Net-style backbone, reflect
  same-padding, group norm, a global bottleneck broadcast over the deepest
  grid, skip-connected transposed convolutions.  Its ``deconv*`` weights
  are ``nn.ConvTranspose2d``'s ``(in, out, kh, kw)``; Flax's
  ``ConvTranspose`` (HWIO) does not flip its kernel and PyTorch's does, so
  the weight carry (``models/flax_import.py``) flips the kernel spatially.

NHWC in and out; NCHW inside (PyTorch's convolution layout).  The
convolutions stay cuDNN's: the JAX package has no Pallas kernel here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from avr_tpu_torch.models.resnet import Conv, ResNetTrunk, make_norm
from avr_tpu_torch.ops.resize import resize_bilinear_align_corners, resize_linear

__all__ = ["SpatialEncoder", "ImageEncoder", "ConvEncoder", "CUSTOM_LATENT"]

CUSTOM_LATENT = 128  # the ConvEncoder's channels


class SpatialEncoder(nn.Module):
    """``(B, H, W, 3)`` NHWC images -> ``(latent, latent_scaling)``.

    ``latent`` is ``(B, H', W', latent_size)`` in the compute dtype.
    ``latent_scaling = [2W'/(W'-1), 2H'/(H'-1)]`` maps pixel uv to grid
    coordinates as ``uv * latent_scaling / image_size - 1``.
    """

    def __init__(self, backbone: str = "resnet34", num_layers: int = 4,
                 use_first_pool: bool = True, dtype: torch.dtype = torch.float32,
                 norm_type: str = "batch", feature_scale: float = 1.0):
        super().__init__()
        self.custom = backbone == "custom"
        if self.custom:
            self.model = ConvEncoder(norm_type="group")
            self.latent_size = CUSTOM_LATENT
        else:
            self.model = ResNetTrunk(backbone, num_layers, use_first_pool, norm_type)
            self.latent_size = ResNetTrunk.latent_size(backbone, num_layers)
        self.dtype, self.feature_scale = dtype, feature_scale

    def forward(self, x: torch.Tensor, train: bool = False):
        """``train`` runs BatchNorm on batch statistics and updates the
        running ones (the other norms use the input's statistics always)."""
        if self.feature_scale != 1.0:
            _, H, W, _ = x.shape
            x = resize_linear(x, (int(H * self.feature_scale), int(W * self.feature_scale)))
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        if self.custom:
            latent = self.model(x, train).permute(0, 2, 3, 1)
        else:
            feats = self.model(x, train)
            hw = feats[0].shape[2:]
            latent = torch.cat([resize_bilinear_align_corners(f.permute(0, 2, 3, 1), hw)
                                for f in feats], dim=-1)
        latent = latent.to(self.dtype).contiguous()
        Hl, Wl = latent.shape[1:3]
        scaling = torch.tensor([2.0 * Wl / (Wl - 1), 2.0 * Hl / (Hl - 1)],
                               dtype=torch.float32, device=latent.device)
        return latent, scaling


class ImageEncoder(nn.Module):
    """Global image encoder: the whole trunk (``num_layers=5``, BatchNorm as
    JAX's) -> mean over the last stage's grid -> ``fc`` -> ``(B,
    latent_size)`` in the compute dtype."""

    def __init__(self, backbone: str = "resnet34", latent_size: int = 128,
                 norm_type: str = "batch", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.model = ResNetTrunk(backbone, 5, True, norm_type)
        if latent_size != 512:
            self.fc = nn.Linear(512, latent_size)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        feats = self.model(x.permute(0, 3, 1, 2).to(self.dtype), train)
        h = feats[-1].mean(dim=(2, 3))
        if hasattr(self, "fc"):
            h = F.linear(h, self.fc.weight.to(h.dtype), self.fc.bias.to(h.dtype))
        return h


def _same_pad(x: torch.Tensor, kernel_size: int, stride: int) -> torch.Tensor:
    """TF-style SAME padding by reflection before a VALID convolution (NCHW)."""
    H, W = x.shape[2:]
    pad_h = max((math.ceil(H / stride) - 1) * stride + kernel_size - H, 0)
    pad_w = max((math.ceil(W / stride) - 1) * stride + kernel_size - W, 0)
    top, left = pad_h // 2, pad_w // 2
    return F.pad(x, (left, pad_w - left, top, pad_h - top), mode="reflect")


def _same_unpad_deconv(x: torch.Tensor, kernel_size: int, stride: int) -> torch.Tensor:
    """Crop a VALID transposed convolution's output back to SAME geometry."""
    h_scaled = (x.shape[2] - 1) * stride
    w_scaled = (x.shape[3] - 1) * stride
    pad_h = max((math.ceil(h_scaled / stride) - 1) * stride + kernel_size - h_scaled, 0)
    pad_w = max((math.ceil(w_scaled / stride) - 1) * stride + kernel_size - w_scaled, 0)
    top, left = pad_h // 2, pad_w // 2
    return x[:, :, top:x.shape[2] - (pad_h - top), left:x.shape[3] - (pad_w - left)]


class ConvTranspose(nn.Module):
    """A VALID transposed convolution, ``weight`` ``(in, out, k, k)``
    float32 (``nn.ConvTranspose2d``'s layout), run in the input's dtype."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_in, c_out, k, k))
        self.bias: Optional[nn.Parameter] = nn.Parameter(torch.zeros(c_out)) if bias else None
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), b, stride=self.stride)


class ConvEncoder(nn.Module):
    """The custom backbone (JAX's ``ConvEncoder``): 128 channels at the input's
    resolution, NCHW in and out."""

    def __init__(self, dim_in: int = 3, norm_type: str = "group", use_leaky_relu: bool = True,
                 use_skip_conn: bool = True, n_down_layers: int = 3):
        super().__init__()
        norm = make_norm(norm_type)
        first, mid, last = 64, 128, 128
        self.n_down_layers, self.use_skip_conn = n_down_layers, use_skip_conn
        self.act = (lambda t: F.leaky_relu(t, 0.01)) if use_leaky_relu else torch.relu
        self.conv_in, self.norm_in = Conv(dim_in, first, 7, 2), norm(first)
        inters = []
        chnls = first
        for i in range(n_down_layers):
            setattr(self, f"conv{i}", Conv(chnls, 2 * chnls, 3, 2))
            setattr(self, f"norm{i}", norm(2 * chnls))
            chnls *= 2
            inters.append(chnls)
        self.conv_mid, self.norm_mid = Conv(chnls, mid, 4, 4), norm(mid)
        c = mid
        for i in reversed(range(n_down_layers)):
            c_in = c + inters[i] if use_skip_conn else c
            c = inters[i] // 2 if i > 0 else first
            setattr(self, f"deconv{i}", ConvTranspose(c_in, c, 3, 2))
            setattr(self, f"denorm{i}", norm(c))
        self.deconv_last = ConvTranspose(c, last, 3, 2, bias=True)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        act = self.act
        x = act(self.norm_in(self.conv_in(_same_pad(x, 7, 2)), train))
        inters = []
        for i in range(self.n_down_layers):
            x = getattr(self, f"conv{i}")(_same_pad(x, 3, 2))
            x = act(getattr(self, f"norm{i}")(x, train))
            inters.append(x)
        x = act(self.norm_mid(self.conv_mid(_same_pad(x, 4, 4)), train))
        # the global bottleneck, broadcast over the deepest grid
        x = x.mean(dim=(2, 3), keepdim=True).expand(-1, -1, *inters[-1].shape[2:])
        for i in reversed(range(self.n_down_layers)):
            if self.use_skip_conn:
                x = torch.cat([x, inters[i]], dim=1)
            x = _same_unpad_deconv(getattr(self, f"deconv{i}")(x), 3, 2)
            x = act(getattr(self, f"denorm{i}")(x, train))
        return _same_unpad_deconv(self.deconv_last(x), 3, 2)
