"""Adaptive volume renderer, forward (port of ``avr_tpu/renderers/adaptive.py``).

Pipeline: LSTM march -> coarse output (one field query at the marched
point) -> distance along the ray ``<coords - ro, rd>`` -> stratified band
``[d - eps, d + eps]`` (monotone by construction: no sort) -> fine field
query -> volume integral -> camera-z depth.  The TPU path's optional ray
sort only serves its windowed gather; per-ray results do not depend on it,
so the port has none.

``fused_integral`` (``"never"``, ``"auto"``, ``"always"``, the JAX
package's values, ``avr_tpu/renderers/adaptive.py:105-131``): ``"never"``
composites the band with the plain volume integral and returns the band
opacity ``acc``; ``"always"`` with the K4 wrapper on the decoder's rows as
they come (:func:`~avr_tpu_torch.ops.kernels.integrate.fused_volume_integral`:
the kernel on CUDA tensors, its plain version on CPU tensors), which gives
no band opacity (``acc`` is None); ``"auto"`` fuses where JAX does, on the
accelerator (the card here, the TPU there), and composites plainly, with
``acc``, on the CPU.
"""

from __future__ import annotations

from typing import Callable

import torch

from avr_tpu_torch.ops.hashrng import KeyLike, split_any
from avr_tpu_torch.ops.integrate import volume_integral
from avr_tpu_torch.ops.kernels.integrate import fused_volume_integral
from avr_tpu_torch.ops.sampling import sample_coarse
from avr_tpu_torch.renderers.base import AdaptiveRendererConfig, RenderOutput
from avr_tpu_torch.utils.geometry import depth_from_world, get_world_rays

__all__ = ["render_adaptive", "FUSED_INTEGRAL"]

FUSED_INTEGRAL = ("never", "auto", "always")

# field(xyz (SB, N, 3), viewdirs (SB, N, 3), coarse) -> (SB, N, 4)
FieldFn = Callable[[torch.Tensor, torch.Tensor, bool], torch.Tensor]
# march_fn(key, ros, rds) -> final world points (SB, R, 3)
MarchFn = Callable[[KeyLike, torch.Tensor, torch.Tensor], torch.Tensor]


def render_adaptive(cfg: AdaptiveRendererConfig, key: KeyLike, field: FieldFn,
                    march_fn: MarchFn, xy_pix: torch.Tensor, intrinsics: torch.Tensor,
                    cam2world: torch.Tensor, fused_integral: str = "never") -> RenderOutput:
    ros, rds = get_world_rays(xy_pix, intrinsics, cam2world)
    k_march, k_band = split_any(key)
    coords = march_fn(k_march, ros, rds)

    rgb_coarse = field(coords, rds, True)[..., :3]
    depth_coarse = depth_from_world(coords, cam2world)[..., None]

    d = torch.sum((coords - ros) * rds, dim=-1)
    z = sample_coarse(k_band, d - cfg.epsilon, d + cfg.epsilon, cfg.n_coarse)
    SB, R, n = z.shape
    pts = ros[..., None, :] + rds[..., None, :] * z[..., None]
    vd = rds[..., None, :].expand(SB, R, n, 3)
    out = field(pts.reshape(SB, R * n, 3), vd.reshape(SB, R * n, 3), False)
    fused = fused_integral == "always" or (fused_integral == "auto"
                                           and out.device.type != "cpu")
    if not fused:
        out = out.reshape(SB, R, n, 4)
        rgb, distance, weights = volume_integral(z, out[..., 3:4], out[..., :3],
                                                 white_back=cfg.white_back)
        acc = torch.sum(weights, dim=-2)
    else:
        rgb, distance = fused_volume_integral(z.contiguous(), out.contiguous(),
                                              white_back=cfg.white_back)
        acc = None
    depth = depth_from_world(ros + rds * distance, cam2world)[..., None]
    return RenderOutput(rgb_coarse, rgb, depth_coarse, depth, acc)
