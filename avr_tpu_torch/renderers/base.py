"""Renderer output and config types (port of ``avr_tpu/renderers/base.py``).

The output layout is the reference renderers' contract:

  * VolumeRenderer   -> (rgb_coarse, rgb_fine, depth_fine,   depth_fine)
  * Raymarcher       -> (rgb,        None,     depth,        depth)
  * AdaptiveRenderer -> (rgb_coarse, rgb_fine, depth_coarse, depth_fine, acc)

:func:`renderer_config_from_conf` picks the config by the experiment
name's prefix, as the JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Union

import torch

__all__ = ["RenderOutput", "VolumeRendererConfig", "RaymarcherConfig",
           "AdaptiveRendererConfig", "RendererConfig", "renderer_config_from_conf"]


class RenderOutput(NamedTuple):
    rgb_coarse: torch.Tensor  # (SB, R, 3)
    rgb_fine: Optional[torch.Tensor]  # (SB, R, 3)
    depth_coarse: torch.Tensor  # (SB, R, 1)
    depth_fine: torch.Tensor  # (SB, R, 1)
    acc: Optional[torch.Tensor] = None  # (SB, R, 1) total band opacity


@dataclass(frozen=True)
class VolumeRendererConfig:
    """Classic coarse/fine NeRF renderer (reference renderers.py:121-289)."""

    near: float = 0.8
    far: float = 1.8
    n_coarse: int = 64
    n_fine: int = 32
    n_fine_depth: int = 16
    depth_std: float = 0.01
    white_back: bool = True
    # "reference": the depth-guided sampler as the reference wrote it (the
    # mean dropped); "intended": centred on the coarse depth
    depth_sample_mode: str = "reference"

    @classmethod
    def from_conf(cls, conf, white_back: bool = True):
        return cls(
            near=conf.get_float("near", 0.8),
            far=conf.get_float("far", 1.8),
            n_coarse=conf.get_int("n_coarse", 32),
            n_fine=conf.get_int("n_fine", 16),
            n_fine_depth=conf.get_int("n_fine_depth", 8),
            depth_std=conf.get_float("depth_std", 0.01),
            white_back=conf.get_bool("white_back", white_back),
        )


@dataclass(frozen=True)
class RaymarcherConfig:
    """SRN-style LSTM ray-marcher (reference renderers.py:292-358)."""

    num_feature_channels: int = 512
    raymarch_steps: int = 10
    hidden_size: int = 16
    init_distance_mean: float = 0.8
    init_distance_std: float = 5e-2
    grad_clamp: float = 10.0
    # per-ray early termination threshold on |predicted step|; 0 = off
    early_stop_eps: float = 0.0

    @classmethod
    def from_conf(cls, conf, raymarch_steps: int = 10):
        return cls(
            num_feature_channels=conf.get_int("num_feature_channels", 512),
            raymarch_steps=raymarch_steps,
        )


@dataclass(frozen=True)
class AdaptiveRendererConfig:
    """LSTM march + epsilon-band integral (reference renderers.py:360-557)."""

    raymarch_steps: int = 10
    epsilon: float = 0.15
    n_coarse: int = 20
    white_back: bool = True
    hidden_size: int = 16
    grad_clamp: float = 10.0
    init_distance_mean: float = 0.8
    init_distance_std: float = 5e-2
    # per-ray early termination threshold on |predicted step|; 0 = off
    early_stop_eps: float = 0.0

    @classmethod
    def from_conf(cls, conf):
        return cls(
            raymarch_steps=conf.get_int("raymarch_steps", 10),
            epsilon=conf.get_float("epsilon", 0.05),
            n_coarse=conf.get_int("n_coarse", 20),
            white_back=conf.get_bool("white_back", False),
        )


RendererConfig = Union[VolumeRendererConfig, RaymarcherConfig, AdaptiveRendererConfig]


def renderer_config_from_conf(conf, renderer_name: str, raymarch_steps: int = 10):
    """The renderer config by experiment-name prefix (reference
    train.py:268-273): ``"Raymarcher*"`` the raymarcher, ``"VR*"`` the
    classic volume renderer, anything else the adaptive renderer."""
    if "Raymarcher" in renderer_name:
        return RaymarcherConfig.from_conf(conf["raymarcher"], raymarch_steps)
    if renderer_name[:2] == "VR":
        return VolumeRendererConfig.from_conf(conf["normal_renderer"])
    return AdaptiveRendererConfig.from_conf(conf["adaptive_renderer"])
