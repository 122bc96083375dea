"""Device-resident dataset: the train step draws its batch on the card
(port of ``avr_tpu/data/device.py``).

:func:`build_device_dataset` uploads a whole scene set once (a 4 GiB guard
refuses larger sets); :func:`make_device_sampler` returns ``sample(key)``,
which draws a step's batch from it with the threefry key, as JAX's sampler
does:

* instances uniform with replacement, ``randint(k_inst, (SB,), 0, Ni)``;
* source views uniform with replacement over all ``NV`` views,
  ``randint(k_src, (SB, NS), 0, NV)``;
* rays uniform over the ``NV * sl**2`` (view, pixel) pairs of the instance,
  ``randint(k_ray, (SB, R), 0, NV * sl**2)``;
* ground truth ``0.5 * image + 0.5``,

with ``(k_inst, k_src, k_ray) = split(key, 3)``.  The three ``randint``
draws go through K7's raw bits (two launches each on the card); the rest is
plain indexing.  A step then needs nothing from the host but its key.

JAX takes ``focal`` and ``c`` from the first view of the first scene; the
port checks that every view of the set has those values and raises if not,
so a set whose views differ cannot be trained on one view's intrinsics.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from avr_tpu_torch.ops import threefry
from avr_tpu_torch.utils.device import resolve_device

__all__ = ["DeviceDataset", "build_device_dataset", "make_device_sampler"]

_BUDGET_BYTES = 4 * 1024 ** 3


class DeviceDataset(NamedTuple):
    """All scenes on the device: ``images (Ni, NV, sl**2, 3)`` float32 in
    [-1, 1], ``poses (Ni, NV, 4, 4)`` cam2world (OpenCV), ``intrinsics (Ni,
    3, 3)`` normalized, ``x_pix (sl**2, 2)`` the [0, 1) pixel grid,
    ``focal`` a scalar and ``c (2,)`` in pixels (the same for every view)."""

    images: torch.Tensor
    poses: torch.Tensor
    intrinsics: torch.Tensor
    x_pix: torch.Tensor
    focal: torch.Tensor
    c: torch.Tensor

    @property
    def num_instances(self) -> int:
        return self.images.shape[0]

    @property
    def num_views(self) -> int:
        return self.images.shape[1]

    @property
    def sidelength(self) -> int:
        return int(round(float(np.sqrt(self.images.shape[2]))))


def build_device_dataset(dset, device: Optional[Union[str, torch.device]] = None
                         ) -> DeviceDataset:
    """Read every (instance, view) of ``dset.all_instances`` (lists of
    observation dicts, as JAX's ``SceneClassDataset`` holds) once and upload
    them to ``device`` (the card unless the caller asks).  Ragged view counts
    truncate to the smallest."""
    dev = resolve_device(device)
    insts = dset.all_instances
    nv = min(len(inst) for inst in insts)
    first = insts[0][0]
    sl2 = first["images"].shape[0]
    n_bytes = len(insts) * nv * sl2 * 3 * 4
    if n_bytes > _BUDGET_BYTES:
        raise ValueError(f"device_data: dataset needs {n_bytes / 1e9:.1f} GB on device "
                         f"(> {_BUDGET_BYTES / 1e9:.0f} GB budget): use the host pipeline")
    images = np.empty((len(insts), nv, sl2, 3), np.float32)
    poses = np.empty((len(insts), nv, 4, 4), np.float32)
    intrinsics = np.empty((len(insts), 3, 3), np.float32)
    for i, inst in enumerate(insts):
        for v in range(nv):
            obs = inst[v]
            if not (np.array_equal(obs["focal"], first["focal"])
                    and np.array_equal(obs["c"], first["c"])):
                raise ValueError(f"device_data: instance {i} view {v} has focal {obs['focal']} "
                                 f"and c {obs['c']}, the first view {first['focal']} and "
                                 f"{first['c']}; the sampler takes one focal and c for the set")
            images[i, v] = obs["images"]
            poses[i, v] = obs["cam2world"]
        intrinsics[i] = obs["intrinsics"]
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    return DeviceDataset(images=t(images), poses=t(poses), intrinsics=t(intrinsics),
                         x_pix=t(first["x_pix"]), focal=t(first["focal"]), c=t(first["c"]))


def make_device_sampler(data: DeviceDataset, batch_size: int, ray_batch_size: int,
                        num_source_views: int = 1) -> Callable[[threefry.Key], Tuple]:
    """``sample(key) -> (src_images, src_poses, focal, c, model_input, gt)``,
    the train step's inputs, drawn on ``data``'s device."""
    Ni, NV, sl = data.num_instances, data.num_views, data.sidelength
    sl2 = sl * sl
    SB, R, NS = batch_size, ray_batch_size, num_source_views
    dev = data.images.device

    def sample(key: threefry.Key) -> Tuple:
        k_inst, k_src, k_ray = threefry.split(key, 3)
        inst = threefry.randint(k_inst, (SB,), 0, Ni, dev)
        src_idx = threefry.randint(k_src, (SB, NS), 0, NV, dev)
        flat = threefry.randint(k_ray, (SB, R), 0, NV * sl2, dev)
        view, pix = flat // sl2, flat % sl2
        src_images = data.images[inst[:, None], src_idx].reshape(SB, NS, sl, sl, 3)
        src_poses = data.poses[inst[:, None], src_idx]
        model_input = {"x_pix": data.x_pix[pix], "cam2world": data.poses[inst[:, None], view],
                       "intrinsics": data.intrinsics[inst]}
        gt = data.images[inst[:, None], view, pix] * 0.5 + 0.5
        return src_images, src_poses, data.focal, data.c, model_input, gt

    return sample
