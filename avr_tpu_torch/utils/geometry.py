"""Camera geometry and ray generation (port of ``avr_tpu/utils/geometry.py``).

The same deliberately nonstandard conventions, pinned for parity:
pixel coordinates in [0, 1) with both axes stepped by ``1/x_resolution``;
``unproject`` applies ``K^-1``, flips x and scales by ``z``; ray directions
are unit-norm, so camera depth is recomputed by :func:`depth_from_world`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "get_world_rays", "depth_from_world", "pixel_grid", "look_at_rotation",
    "orbit_cam2world",
]


def _unproject_dirs(xy_pix: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Unit camera-space ray directions: unproject at ``z = -1``, normalize."""
    xy_hom = torch.cat([xy_pix, torch.ones_like(xy_pix[..., :1])], dim=-1)
    k_inv = torch.linalg.inv_ex(intrinsics).inverse  # inv_ex: no error check, no host sync
    xyz = torch.einsum("...ij,...kj->...ki", k_inv, xy_hom)
    xyz = torch.cat([-xyz[..., :1], xyz[..., 1:]], dim=-1) * -1.0
    return xyz / torch.linalg.norm(xyz, dim=-1, keepdim=True)


def get_world_rays(
    xy_pix: torch.Tensor,  # (SB, N, 2) in [0, 1]
    intrinsics: torch.Tensor,  # (SB, 3, 3)
    cam2world: torch.Tensor,  # (SB, N, 4, 4)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """World ray origins and unit directions, each ``(SB, N, 3)``."""
    dirs_cam = _unproject_dirs(xy_pix, intrinsics)
    rot = cam2world[..., :3, :3]
    rd = torch.einsum("...ij,...j->...i", rot, dirs_cam)
    return cam2world[..., :3, 3], rd


def depth_from_world(world: torch.Tensor, cam2world: torch.Tensor) -> torch.Tensor:
    """Camera-space depth (``-z``) of world points under per-ray poses."""
    hom = torch.cat([world, torch.ones_like(world[..., :1])], dim=-1)
    cam = torch.einsum("...ij,...j->...i", torch.linalg.inv_ex(cam2world).inverse, hom)
    return -cam[..., 2]


def pixel_grid(y_resolution: int, x_resolution: int) -> np.ndarray:
    """``(y, x, 2)`` float32 pixel-centre grid in [0, 1), ``[r, c] = (x_c, y_r)``;
    both linspaces end at ``1 - 1/x_resolution`` like the reference."""
    end = 1.0 - 1.0 / x_resolution
    xs = np.linspace(0.0, end, x_resolution, dtype=np.float32)
    ys = np.linspace(0.0, end, y_resolution, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx, gy], axis=-1)


def look_at_rotation(x: float, y: float, z: float) -> np.ndarray:
    """Camera rotation looking from (x, y, z) at the origin, up = (0, 0, -1),
    with the reference's degenerate-x-axis fallback.  ``(3, 3)`` float32."""
    eps = np.float32(1e-5)

    def normalize(v):
        return v / np.maximum(np.linalg.norm(v), eps)

    cam = np.asarray([x, y, z], np.float32)
    up = np.asarray([0.0, 0.0, -1.0], np.float32)
    z_axis = normalize(-cam)
    x_axis = normalize(np.cross(up, z_axis))
    y_axis = normalize(np.cross(z_axis, x_axis))
    if np.all(np.isclose(x_axis, 0.0, atol=5e-3)):
        x_axis = normalize(np.cross(y_axis, z_axis))
    return np.stack([x_axis, y_axis, z_axis], axis=1).astype(np.float32)


def orbit_cam2world(num_frames: int, radius: float, z_height: float = 0.4) -> torch.Tensor:
    """``(num_frames, 4, 4)`` float32 poses orbiting the origin, flipped into
    the OpenCV convention by ``diag(1, -1, -1, 1)``."""
    angles = (
        np.linspace(0.0, 2.0 * np.pi * (num_frames - 1) / num_frames, num_frames)
        + np.pi / num_frames
    )
    rr = float(np.sqrt(radius * radius - z_height * z_height))
    flip = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    poses = []
    for angle in angles:
        t = np.asarray([rr * np.sin(angle), rr * np.cos(angle), z_height], np.float32)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = look_at_rotation(*t)
        c2w[:3, 3] = t
        poses.append(c2w @ flip)
    return torch.from_numpy(np.stack(poses))
