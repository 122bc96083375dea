"""Host-side ray subsampling for training batches (port of
``avr_tpu/data/sampling.py``: the same numpy code, so the same generator
state gives the same indices and arrays bit for bit).

Counterpart of the reference's per-step ray selection
(``/root/reference/utils.py:34-60`` and ``train.py:71-85``): either uniform
random pixels over all views, or pixels restricted to each view's
foreground bbox.  Runs on host numpy (it is data-dependent control flow),
producing fixed-shape arrays the jitted train step consumes.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

__all__ = ["bbox_sample", "sample_ray_indices", "gather_rays"]


def bbox_sample(rng: np.random.Generator, bboxes: np.ndarray, num_pix: int) -> np.ndarray:
    """Sample pixel ids inside per-view foreground bboxes.

    Args:
      bboxes: ``(NV, 4)`` as ``[cmin, rmin, cmax, rmax]``.
    Returns:
      ``(num_pix, 3)`` int array of ``(view, row, col)``.
    """
    image_ids = rng.integers(0, bboxes.shape[0], size=num_pix)
    pb = bboxes[image_ids]
    x = (rng.random(num_pix) * (pb[:, 2] + 1 - pb[:, 0]) + pb[:, 0]).astype(np.int64)
    y = (rng.random(num_pix) * (pb[:, 3] + 1 - pb[:, 1]) + pb[:, 1]).astype(np.int64)
    return np.stack([image_ids, y, x], axis=-1)


def sample_ray_indices(
    rng: np.random.Generator,
    batch: Dict[str, np.ndarray],
    ray_batch_size: int,
    with_bbox: bool = False,
) -> np.ndarray:
    """Per-scene flat ray indices over ``NV * sl^2`` pixels (train.py:71-78).

    Kept in numpy regardless of the gather implementation so the native and
    numpy paths consume bit-identical indices for the same RNG state.
    """
    images = batch["images"]
    SB, NV, sl2, _ = images.shape
    sl = int(np.sqrt(sl2))
    if with_bbox:
        rays_idx = []
        for sb in range(SB):
            pix = bbox_sample(rng, batch["bbox"][sb], ray_batch_size)
            pix[:, 1:] = np.clip(pix[:, 1:], 0, sl - 1)
            rays_idx.append(pix[:, 0] * sl2 + pix[:, 1] * sl + pix[:, 2])
        return np.stack(rays_idx)
    return rng.integers(0, NV * sl2, size=(SB, ray_batch_size))


def gather_rays(
    rng: np.random.Generator,
    batch: Dict[str, np.ndarray],
    ray_batch_size: int,
    with_bbox: bool = False,
    impl: str = "auto",
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Assemble a per-ray training input from a collated ``(SB, NV, ...)`` batch.

    Mirrors reference train.py:71-85: flat ray indices over ``NV * sl^2``
    pixels, gathered x_pix / per-ray cam2world / gt colours.

    ``impl``: "auto" and "native" take the C++ gather
    (``avr_tpu_torch/csrc/ray_gather.cpp``, on the calling thread, built at
    first use by :mod:`avr_tpu_torch.data.native`; a failed build raises);
    "numpy" the numpy gather, its plain twin.  The indices are sampled in
    numpy either way, so both give the same arrays bit for bit.

    Returns:
      (model_input dict with x_pix (SB,R,2), cam2world (SB,R,4,4),
       intrinsics (SB,3,3); ground truth (SB,R,3) in [0,1]).
    """
    images = batch["images"]  # (SB, NV, sl2, 3) in [-1, 1]
    SB, NV, sl2, _ = images.shape

    rays_idx = sample_ray_indices(rng, batch, ray_batch_size, with_bbox)

    if impl in ("auto", "native"):
        from avr_tpu_torch.data.native import gather_rays_native

        return gather_rays_native(batch, rays_idx.astype(np.int64))
    if impl != "numpy":
        raise ValueError(f"unknown gather impl {impl!r}")

    def take(flat: np.ndarray) -> np.ndarray:
        # flat: (SB, NV*sl2, ...) -> (SB, R, ...)
        return np.take_along_axis(
            flat,
            rays_idx.reshape(SB, ray_batch_size, *([1] * (flat.ndim - 2))),
            axis=1,
        )

    x_pix = take(batch["x_pix"].reshape(SB, NV * sl2, 2))
    c2w = np.broadcast_to(
        batch["cam2world"][:, :, None], (SB, NV, sl2, 4, 4)
    ).reshape(SB, NV * sl2, 4, 4)
    c2w = take(c2w)
    gt = 0.5 * take(images.reshape(SB, NV * sl2, 3)) + 0.5

    model_input = {
        "x_pix": x_pix.astype(np.float32),
        "cam2world": c2w.astype(np.float32),
        "intrinsics": batch["intrinsics"][:, 0].astype(np.float32),
    }
    return model_input, gt.astype(np.float32)
