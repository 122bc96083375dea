"""LSTM ray-march and the SRN-style Raymarcher (port of
``avr_tpu/renderers/raymarch.py`` ``lstm_march`` and ``render_raymarcher``).

:func:`lstm_march` draws the gaussian initial distance from its key (the
per-ray hash, or the threefry stream through K7), then runs the whole march
in the K3 kernel wrapper (:func:`avr_tpu_torch.ops.kernels.march.fused_lstm_march`;
its plain version for CPU tensors).  :func:`render_raymarcher` marches with the
unsplit key, then queries the coarse decoder once at the marched point.
"""

from __future__ import annotations

from typing import Callable, Union

import torch
from torch import nn

from avr_tpu_torch.models.pixelnerf import Conditioning
from avr_tpu_torch.ops.hashrng import KeyLike
from avr_tpu_torch.ops.kernels.march import fused_lstm_march, pack_projection
from avr_tpu_torch.ops.sampling import _normal_2d
from avr_tpu_torch.renderers.base import (AdaptiveRendererConfig, RaymarcherConfig,
                                          RenderOutput)
from avr_tpu_torch.renderers.lstm import MarchLSTMCell
from avr_tpu_torch.utils.geometry import depth_from_world, get_world_rays

__all__ = ["lstm_march", "render_raymarcher"]


def lstm_march(cfg: Union[AdaptiveRendererConfig, RaymarcherConfig], key: KeyLike,
               cond: Conditioning, cell: MarchLSTMCell, step_head: nn.Linear, ros: torch.Tensor,
               rds: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """March from ``ro + rd * N(mean, std)``; returns final world points ``(SB, R, 3)``."""
    init = cfg.init_distance_mean + cfg.init_distance_std * _normal_2d(key, ros.shape[:2],
                                                                       ros.device)
    coords0 = ros + rds * init[..., None]
    NS = cond.num_views
    proj = pack_projection(cond.poses, cond.focal, cond.c, cond.latent_scaling,
                           cond.image_shape).reshape(-1, NS, 16)
    latent = cond.latent.reshape((-1, NS) + tuple(cond.latent.shape[1:]))
    return fused_lstm_march(
        proj, coords0, rds, latent, cell.w_ih, cell.w_hh, cell.fused_bias(),
        step_head.weight.T, step_head.bias, steps=cfg.raymarch_steps,
        early_stop_eps=cfg.early_stop_eps, grad_clamp=cfg.grad_clamp,
        compute_dtype=compute_dtype)


def render_raymarcher(key: KeyLike, field: Callable, march_fn: Callable,
                      xy_pix: torch.Tensor, intrinsics: torch.Tensor,
                      cam2world: torch.Tensor) -> RenderOutput:
    """``field(xyz, viewdirs, coarse) -> (SB, N, 4)``, ``march_fn(key, ros,
    rds) -> (SB, R, 3)`` (given the key as it is: the JAX path hands the
    fused march the unsplit key); returns ``(rgb, None, depth, depth)``."""
    ros, rds = get_world_rays(xy_pix, intrinsics, cam2world)
    coords = march_fn(key, ros, rds)
    rgb = field(coords, rds, True)[..., :3]
    depth = depth_from_world(coords, cam2world)[..., None]
    return RenderOutput(rgb, None, depth, depth)
