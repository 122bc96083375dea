"""SRN-style scene datasets (host-side, numpy; port of
``avr_tpu/data/dataset.py``, the same per-item arrays and the same
deterministic batch stream).

The source is an HDF5 file in the SRN layout, read through ``h5py`` (an
optional import), or **a mapping with the file's layout**::

    {instance_key: {"rgb": {view_key: uint8 (H, W, 3)},
                    "pose": {view_key: float64 (4, 4)},
                    "intrinsics": float64 (5,)}}

(``avr_tpu_torch.data.synthetic.synthetic_scene_mapping`` builds the
synthetic set so), read with no ``h5py`` at all.  Per item:

  * intrinsics ``(focal, cx, cy, width, height)`` normalized by image size,
  * RGB mapped to [-1, 1],
  * the [0,1) pixel-center grid flattened to ``(sl*sl, 2)``,
  * foreground bbox from the ``img != 255`` mask as
    ``[cmin, rmin, cmax, rmax]`` with a center fallback,
  * OpenGL -> OpenCV pose flip ``c2w @ diag(1,-1,-1,1)``,
  * item dict keys: cam2world, intrinsics, focal, c, x_pix, idx, images,
    bbox.

Per-host sharding is a stride over instance keys
(``SceneClassDataset(shard_index=..., num_shards=...)``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np

__all__ = ["SceneInstanceDataset", "SceneClassDataset", "collate_observations",
           "pixel_grid"]

Source = Union[str, Mapping[str, Any]]


def _open(source: Source):
    """The file's root group, or the mapping itself."""
    if isinstance(source, Mapping):
        return source
    try:
        import h5py
    except ImportError:
        raise ImportError("h5py is required for HDF5 datasets; pass a mapping with the "
                          "file's layout instead") from None
    return h5py.File(source, "r")


def pixel_grid(y_resolution: int, x_resolution: int) -> np.ndarray:
    """[0,1) pixel grid, numpy twin of geometry.get_opencv_pixel_coordinates."""
    end = 1.0 - 1.0 / x_resolution
    xs = np.linspace(0.0, end, x_resolution, dtype=np.float32)
    ys = np.linspace(0.0, end, y_resolution, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx, gy], axis=-1)


def _resize_bilinear_u8(img: np.ndarray, side: int) -> np.ndarray:
    """Half-pixel bilinear resize of an (H, W, 3) uint8 image (torch Resize)."""
    H, W, _ = img.shape
    ys = (np.arange(side) + 0.5) * H / side - 0.5
    xs = (np.arange(side) + 0.5) * W / side - 0.5
    y0 = np.clip(np.floor(ys), 0, H - 1).astype(np.int64)
    x0 = np.clip(np.floor(xs), 0, W - 1).astype(np.int64)
    y1 = np.minimum(y0 + 1, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    img = img.astype(np.float32)
    out = (
        img[y0][:, x0] * (1 - wy) * (1 - wx)
        + img[y0][:, x1] * (1 - wy) * wx
        + img[y1][:, x0] * wy * (1 - wx)
        + img[y1][:, x1] * wy * wx
    )
    return out


_POSE_FLIP = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


class SceneInstanceDataset:
    """All observations of a single object instance; ``filename`` is the
    HDF5 path or a mapping with its layout."""

    def __init__(
        self,
        filename: Source,
        instance_idx: int,
        instance_key: str,
        img_sidelength: Optional[int] = None,
        num_images: int = -1,
    ):
        self.f = _open(filename)
        self.instance_idx = instance_idx
        self.instance_key = instance_key
        self.img_sidelength = img_sidelength

        self.color_keys = sorted(self.f[instance_key]["rgb"].keys())
        self.pose_keys = sorted(self.f[instance_key]["pose"].keys())
        if num_images != -1:
            idcs = np.linspace(
                0, len(self.color_keys), num=num_images, endpoint=False, dtype=int
            )
            self.color_keys = [self.color_keys[i] for i in idcs]
            self.pose_keys = [self.pose_keys[i] for i in idcs]

    def set_img_sidelength(self, side: int) -> None:
        self.img_sidelength = side

    def __len__(self) -> int:
        return len(self.pose_keys)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        grp = self.f[self.instance_key]
        focal, cx, cy, width, height = np.asarray(grp["intrinsics"][...], np.float64)
        cx, cy, focal = cx / width, cy / height, focal / height
        intrinsics = np.asarray(
            [[focal, 0.0, cx], [0.0, focal, cy], [0.0, 0.0, 1.0]], np.float32
        )

        img = np.asarray(grp["rgb"][self.color_keys[idx]][...])
        mask = (img != 255).all(axis=-1)
        sl = self.img_sidelength or img.shape[0]
        if img.shape[0] != sl:
            imgf = _resize_bilinear_u8(img, sl) / 255.0
        else:
            imgf = img.astype(np.float32) / 255.0
        rgb = (imgf - 0.5) / 0.5  # [-1, 1]
        rgb = rgb.reshape(sl * sl, 3).astype(np.float32)

        x_pix = pixel_grid(sl, sl).reshape(sl * sl, 2)

        # foreground bbox in the *native* mask resolution scaled to sl
        rows = np.any(mask, axis=1)
        cols = np.any(mask, axis=0)
        rnz = np.where(rows)[0]
        cnz = np.where(cols)[0]
        if len(rnz) == 0:
            rmin, rmax = sl / 2 - 1, sl / 2 + 1
            cmin, cmax = sl / 2 - 1, sl / 2 + 1
        else:
            scale = sl / img.shape[0]
            rmin, rmax = rnz[0] * scale, rnz[-1] * scale
            cmin, cmax = cnz[0] * scale, cnz[-1] * scale
        bbox = np.asarray([cmin, rmin, cmax, rmax], np.float32)

        c2w = np.asarray(grp["pose"][self.pose_keys[idx]][...], np.float32) @ _POSE_FLIP

        return {
            "cam2world": c2w,
            "intrinsics": intrinsics,
            "focal": np.float32(intrinsics[0, 0] * sl),
            "c": np.asarray(
                [intrinsics[0, 2] * sl, intrinsics[1, 2] * sl], np.float32
            ),
            "x_pix": x_pix,
            "idx": np.asarray([self.instance_idx], np.int64),
            "images": rgb,
            "bbox": bbox,
        }


def collate_observations(
    batch_list: Sequence[Sequence[Dict[str, np.ndarray]]]
) -> Dict[str, np.ndarray]:
    """Stack a list of scenes (each a list of observation dicts) -> (SB, NV, ...)."""
    out = {}
    for key in batch_list[0][0].keys():
        out[key] = np.stack(
            [np.stack([obs[key] for obs in scene]) for scene in batch_list]
        )
    return out


class SceneClassDataset:
    """Category-level dataset; each item = ``samples_per_instance`` random
    observations of one instance, with optional multi-host sharding over
    instances.  ``filename`` is the HDF5 path or a mapping with its
    layout."""

    def __init__(
        self,
        filename: Source,
        img_sidelength: Optional[int] = None,
        max_num_instances: int = -1,
        max_observations_per_instance: int = -1,
        specific_observation_idcs: Optional[List[int]] = None,
        samples_per_instance: int = 10,
        shard_index: int = 0,
        num_shards: int = 1,
        seed: int = 0,
    ):
        self.f = _open(filename)
        self.samples_per_instance = samples_per_instance
        self.specific_observation_idcs = specific_observation_idcs
        self.seed = seed
        self.shard_index = shard_index
        self.rng = np.random.default_rng(seed + shard_index)

        keys = sorted(self.f.keys())
        assert len(keys) != 0, "No objects in the data directory"
        if max_num_instances != -1:
            keys = keys[:max_num_instances]
        keys = keys[shard_index::num_shards]  # per-host shard
        self.instance_keys = keys

        self.all_instances = [
            SceneInstanceDataset(
                self.f if isinstance(filename, Mapping) else filename,
                instance_idx=i,
                instance_key=k,
                img_sidelength=img_sidelength,
                num_images=max_observations_per_instance,
            )
            for i, k in enumerate(keys)
        ]
        self.num_instances = len(self.all_instances)

    def set_img_sidelength(self, side: int) -> None:
        for inst in self.all_instances:
            inst.set_img_sidelength(side)

    def __len__(self) -> int:
        return self.num_instances

    def __getitem__(self, obj_idx: int) -> List[Dict[str, np.ndarray]]:
        return self._observations(obj_idx, self.rng)

    def _observations(
        self, obj_idx: int, rng: np.random.Generator
    ) -> List[Dict[str, np.ndarray]]:
        inst = self.all_instances[obj_idx]
        order = rng.permutation(len(inst))
        obs = [inst[order[i % len(inst)]] for i in range(self.samples_per_instance)]
        if self.specific_observation_idcs is not None:
            for i, s in enumerate(self.specific_observation_idcs):
                obs[i] = inst[s]
        return obs

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        epoch_seed: Optional[int] = None,
        skip: int = 0,
    ):
        """Yield collated ``(SB, NV, ...)`` dict batches over the epoch.

        With ``epoch_seed`` given, the epoch is fully deterministic: the
        instance order derives from ``(dataset seed, shard, epoch_seed)``
        and each instance's view selection from
        ``(dataset seed, epoch_seed, instance index)`` — independent of
        iteration position, so resuming with ``skip=k`` reproduces batches
        ``k, k+1, ...`` bitwise without loading the skipped ones.
        """
        if epoch_seed is not None:
            order_rng = np.random.default_rng(
                np.random.SeedSequence((self.seed, self.shard_index, epoch_seed))
            )
        else:
            order_rng = self.rng
        order = (
            order_rng.permutation(self.num_instances)
            if shuffle
            else np.arange(self.num_instances)
        )

        def item(i):
            if epoch_seed is None:
                return self._observations(int(i), self.rng)
            item_rng = np.random.default_rng(
                np.random.SeedSequence((self.seed, epoch_seed, int(i)))
            )
            return self._observations(int(i), item_rng)

        for bi, start in enumerate(range(0, len(order), batch_size)):
            idxs = order[start : start + batch_size]
            if drop_last and len(idxs) < batch_size:
                return
            if bi < skip:
                if epoch_seed is None:
                    # legacy stream: keep RNG consumption identical
                    for i in idxs:
                        item(i)
                continue
            yield collate_observations([item(i) for i in idxs])
