"""Synthetic SRN-schema scenes (port of ``avr_tpu/data/synthetic.py``).

:func:`orbit_pose` and :func:`render_sphere_view` render shaded spheres
analytically on an orbit ring of cameras, white background.
:func:`write_synthetic_hdf5` writes such a set in the SRN HDF5 schema (it
needs ``h5py``, an optional import as in JAX); :func:`synthetic_scene_mapping`
returns the same arrays in a mapping with the file's layout, which
``data/dataset.py`` reads without ``h5py``; :func:`synthetic_scene_set`
builds the same set in memory, each view as the observation dict JAX's
``SceneInstanceDataset`` reads back from that file (``images`` in [-1, 1],
the pose flipped to OpenCV, normalized intrinsics, pixel-unit focal and
principal point), so the device dataset can be built without ``h5py``.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Iterator, List, Tuple

import numpy as np

from avr_tpu_torch.utils.geometry import pixel_grid

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None

__all__ = ["orbit_pose", "render_sphere_view", "write_synthetic_hdf5", "synthetic_scene_mapping",
           "synthetic_scene_set"]

_POSE_FLIP = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


def orbit_pose(angle: float, radius: float = 1.3, z_height: float = 0.4) -> np.ndarray:
    """On-disk-convention cam2world on an orbit ring looking at the origin:
    camera axes ``[x, y, z towards the target]`` as columns (the loader
    right-multiplies ``diag(1, -1, -1, 1)``)."""
    rr = np.sqrt(radius * radius - z_height * z_height)
    eye = np.array([rr * np.sin(angle), rr * np.cos(angle), z_height])
    z_axis = -eye / np.linalg.norm(eye)
    x_axis = np.cross(np.array([0.0, 0.0, -1.0]), z_axis)
    x_axis /= np.linalg.norm(x_axis)
    y_axis = np.cross(z_axis, x_axis)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.stack([x_axis, y_axis, z_axis], axis=1)
    pose[:3, 3] = eye
    return pose


def render_sphere_view(c2w_cv: np.ndarray, side: int, focal_pix: float,
                       sphere_radius: float = 0.35, color: np.ndarray = None) -> np.ndarray:
    """uint8 ``(side, side, 3)`` render of a shaded sphere at the origin on
    white, through the framework's rays (z = -1 unprojection, unit
    directions) from the OpenCV-convention ``c2w_cv``."""
    if color is None:
        color = np.array([0.8, 0.2, 0.2])
    xs = np.linspace(0.0, 1.0 - 1.0 / side, side)
    gx, gy = np.meshgrid(xs, xs)
    f = focal_pix / side  # normalized focal
    d = np.stack([(gx - 0.5) / f, -(gy - 0.5) / f, -np.ones_like(gx)], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = d @ c2w_cv[:3, :3].T
    o = c2w_cv[:3, 3]
    # ray-sphere intersection |o + t d| = r
    b = 2.0 * (d @ o)
    disc = b * b - 4 * (float(o @ o) - sphere_radius ** 2)
    hit = disc > 0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0, 0.0)
    p = o + t[..., None] * d
    n = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-8)
    light = np.array([0.5, 0.5, 0.8])
    shade = np.clip(n @ (light / np.linalg.norm(light)), 0.1, 1.0)
    img = np.where(hit[..., None], color[None, None, :] * shade[..., None], 1.0)
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def _views(num_instances: int, num_views: int, side: int,
           seed: int) -> Iterator[Tuple[int, int, np.ndarray, np.ndarray]]:
    """``(instance, view, uint8 image, on-disk pose)`` of the synthetic set,
    in the order and from the random draws of JAX's ``write_synthetic_hdf5``."""
    rng = np.random.default_rng(seed)
    focal_pix = 1.09375 * side
    for i in range(num_instances):
        color = rng.uniform(0.2, 0.9, size=3)
        radius = rng.uniform(0.25, 0.4)
        for v in range(num_views):
            pose_gl = orbit_pose(2 * np.pi * v / num_views + rng.uniform(0, 0.3))
            img = render_sphere_view(pose_gl @ _POSE_FLIP, side, focal_pix,
                                     sphere_radius=radius, color=color)
            yield i, v, img, pose_gl


def _intrinsics_record(side: int) -> np.ndarray:
    return np.array([1.09375 * side, side / 2, side / 2, side, side], np.float64)


def write_synthetic_hdf5(path: str, num_instances: int = 2, num_views: int = 8,
                         side: int = 64, seed: int = 0) -> str:
    """Write the synthetic set in the SRN HDF5 schema (``rgb/<k>``,
    ``pose/<k>``, ``intrinsics``); returns ``path``."""
    if h5py is None:
        raise ImportError("h5py is required")
    with h5py.File(path, "w") as f:
        for i, v, img, pose_gl in _views(num_instances, num_views, side, seed):
            if v == 0:
                grp = f.create_group(f"instance_{i:04d}")
                grp.create_dataset("intrinsics", data=_intrinsics_record(side))
                rgb_grp, pose_grp = grp.create_group("rgb"), grp.create_group("pose")
            rgb_grp.create_dataset(f"{v:06d}", data=img)
            pose_grp.create_dataset(f"{v:06d}", data=pose_gl.astype(np.float64))
    return path


def synthetic_scene_mapping(num_instances: int = 2, num_views: int = 8, side: int = 64,
                            seed: int = 0) -> Dict[str, Dict]:
    """The arrays :func:`write_synthetic_hdf5` writes, in a mapping with the
    file's layout: ``{instance_key: {"rgb": {view_key: uint8}, "pose":
    {view_key: float64}, "intrinsics": float64 (5,)}}``."""
    out: Dict[str, Dict] = {}
    for i, v, img, pose_gl in _views(num_instances, num_views, side, seed):
        if v == 0:
            grp = out[f"instance_{i:04d}"] = {"intrinsics": _intrinsics_record(side),
                                               "rgb": {}, "pose": {}}
        grp["rgb"][f"{v:06d}"] = img
        grp["pose"][f"{v:06d}"] = pose_gl.astype(np.float64)
    return out


def synthetic_scene_set(num_instances: int = 2, num_views: int = 8, side: int = 64,
                        seed: int = 0) -> SimpleNamespace:
    """The set :func:`write_synthetic_hdf5` writes, in memory: an object
    whose ``all_instances`` holds each instance's list of observation dicts
    (``cam2world``, ``intrinsics``, ``focal``, ``c``, ``x_pix``, ``images``),
    the values JAX's ``SceneInstanceDataset`` reads from the file.  Every
    view shares one ``x_pix`` array."""
    focal, cx, cy, width, height = _intrinsics_record(side)
    cx, cy, focal = cx / width, cy / height, focal / height
    intrinsics = np.asarray([[focal, 0.0, cx], [0.0, focal, cy], [0.0, 0.0, 1.0]], np.float32)
    x_pix = pixel_grid(side, side).reshape(side * side, 2)
    c = np.asarray([intrinsics[0, 2] * side, intrinsics[1, 2] * side], np.float32)
    insts: List[List[Dict[str, np.ndarray]]] = [[] for _ in range(num_instances)]
    for i, _, img, pose_gl in _views(num_instances, num_views, side, seed):
        rgb = (img.astype(np.float32) / 255.0 - 0.5) / 0.5
        insts[i].append({
            "cam2world": pose_gl @ _POSE_FLIP,
            "intrinsics": intrinsics,
            "focal": np.float32(intrinsics[0, 0] * side),
            "c": c,
            "x_pix": x_pix,
            "images": rgb.reshape(side * side, 3).astype(np.float32),
        })
    return SimpleNamespace(all_instances=insts)
