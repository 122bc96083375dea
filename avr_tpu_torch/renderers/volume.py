"""Classic coarse/fine hierarchical volume renderer (port of
``avr_tpu/renderers/volume.py`` ``render_volume``).

Pipeline: stratified coarse z in ``[near, far]`` -> field (coarse decoder)
-> integral -> the sorted union of the coarse, bucket-CDF importance and
depth-guided z -> field (fine decoder) -> integral -> camera-z depth
(ray directions are unit-norm).  The fine pass re-queries all three sample
sets (96 a ray at the default 64 + 16 + 16).  The TPU path's optional point
sort only serves its windowed gather; per-point results do not depend on
it, so the port has none.
"""

from __future__ import annotations

from typing import Callable

import torch

from avr_tpu_torch.ops.hashrng import KeyLike, split_any
from avr_tpu_torch.ops.integrate import volume_integral
from avr_tpu_torch.ops.sampling import sample_coarse, sample_depth, sample_fine
from avr_tpu_torch.renderers.base import RenderOutput, VolumeRendererConfig
from avr_tpu_torch.utils.geometry import depth_from_world, get_world_rays

__all__ = ["render_volume"]

# field(xyz (SB, N, 3), viewdirs (SB, N, 3), coarse) -> (SB, N, 4)
FieldFn = Callable[[torch.Tensor, torch.Tensor, bool], torch.Tensor]


def _query(field: FieldFn, ros, rds, z_vals, coarse: bool):
    """The field at ``ro + rd * z`` for every sample: ``(sigma (SB, R, n,
    1), rgb (SB, R, n, 3))``."""
    SB, R, n = z_vals.shape
    pts = ros[..., None, :] + rds[..., None, :] * z_vals[..., None]
    vd = rds[..., None, :].expand(SB, R, n, 3)
    out = field(pts.reshape(SB, R * n, 3), vd.reshape(SB, R * n, 3), coarse)
    out = out.reshape(SB, R, n, 4)
    return out[..., 3:4], out[..., :3]


def render_volume(cfg: VolumeRendererConfig, key: KeyLike, field: FieldFn,
                  xy_pix: torch.Tensor, intrinsics: torch.Tensor,
                  cam2world: torch.Tensor) -> RenderOutput:
    """``xy_pix (SB, R, 2)``, ``intrinsics (SB, 3, 3)``, ``cam2world (SB, R,
    4, 4)``, ``key`` per-ray seeds ``(SB, R)`` or a threefry key."""
    SB, R, _ = xy_pix.shape
    ros, rds = get_world_rays(xy_pix, intrinsics, cam2world)
    near = torch.full((SB, R), cfg.near, dtype=torch.float32, device=ros.device)
    far = torch.full((SB, R), cfg.far, dtype=torch.float32, device=ros.device)
    k_coarse, k_fine, k_depth = split_any(key, 3)

    z_coarse = sample_coarse(k_coarse, near, far, cfg.n_coarse)
    sigma, rad = _query(field, ros, rds, z_coarse, coarse=True)
    rgb_coarse, dist_coarse, w_coarse = volume_integral(
        z_coarse, sigma, rad, white_back=cfg.white_back, infinity=cfg.far)

    z_fine = sample_fine(k_fine, near, far, cfg.n_fine - cfg.n_fine_depth, w_coarse)
    z_depth = sample_depth(k_depth, dist_coarse, cfg.n_fine_depth, cfg.depth_std,
                           mode=cfg.depth_sample_mode)
    z_depth = torch.clamp(z_depth, cfg.near, cfg.far)
    z_all = torch.sort(torch.cat([z_coarse, z_fine, z_depth], dim=-1), dim=-1).values
    sigma, rad = _query(field, ros, rds, z_all, coarse=False)
    rgb_fine, dist_fine, _ = volume_integral(z_all, sigma, rad, white_back=cfg.white_back,
                                             infinity=cfg.far)

    depth_fine = depth_from_world(ros + rds * dist_fine, cam2world)[..., None]
    return RenderOutput(rgb_coarse, rgb_fine, depth_fine, depth_fine)
