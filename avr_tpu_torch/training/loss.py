"""Training loss (port of ``avr_tpu/training/loss.py``).

MSE on the coarse and/or fine image per ``loss_mode`` in {coarse, fine,
both}, a NaN -> 1e-6 guard (``torch.where``: like the JAX guard it does not
stop a NaN gradient, the optimizer's non-finite skip does), an optional
opacity-weighted depth-consistency term (marched depth towards the band's
depth, both weights detached) and an optional depth-range hinge penalty.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from avr_tpu_torch.renderers.base import RenderOutput

__all__ = ["LossParams", "loss_fn"]


@dataclass(frozen=True)
class LossParams:
    loss_mode: str = "both"  # coarse | fine | both
    depth_regularization: bool = False
    near: float = 0.5
    far: float = 2.0
    depth_penalty_scale: float = 10000.0
    depth_consistency: float = 0.0


def loss_fn(out: RenderOutput, gt: torch.Tensor, params: LossParams) -> torch.Tensor:
    """Scalar training loss for a render against ``(SB, R, 3)`` ground truth."""
    loss = torch.zeros((), dtype=torch.float32, device=gt.device)
    if params.loss_mode != "fine":
        loss = loss + torch.mean((out.rgb_coarse - gt) ** 2)
    if params.loss_mode != "coarse":
        if out.rgb_fine is None:
            raise ValueError(f"loss_mode={params.loss_mode!r} needs a fine image but the "
                             "renderer produced none")
        loss = loss + torch.mean((out.rgb_fine - gt) ** 2)
    loss = torch.where(torch.isnan(loss), torch.full_like(loss, 1e-6), loss)
    if params.depth_consistency:
        if out.acc is None:
            raise ValueError("depth_consistency needs the renderer's band opacity "
                             "(RenderOutput.acc)")
        w = out.acc.detach()
        target = out.depth_fine.detach()
        loss = loss + params.depth_consistency * torch.mean(w * (out.depth_coarse - target) ** 2)
    if params.depth_regularization:
        depth = out.depth_coarse
        penalty = torch.clamp(params.near - depth, min=0.0) + torch.clamp(depth - params.far,
                                                                           min=0.0)
        loss = loss + torch.mean(penalty) * params.depth_penalty_scale
    return loss
