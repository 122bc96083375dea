"""Renderer output and config types (port of ``avr_tpu/renderers/base.py``,
the adaptive renderer only)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

__all__ = ["RenderOutput", "AdaptiveRendererConfig"]


class RenderOutput(NamedTuple):
    rgb_coarse: torch.Tensor  # (SB, R, 3)
    rgb_fine: Optional[torch.Tensor]  # (SB, R, 3)
    depth_coarse: torch.Tensor  # (SB, R, 1)
    depth_fine: torch.Tensor  # (SB, R, 1)
    acc: Optional[torch.Tensor] = None  # (SB, R, 1) total band opacity


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
