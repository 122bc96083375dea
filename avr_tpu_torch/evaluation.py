"""Offline evaluation and novel-view rendering (ports of
``avr_tpu/evaluation.py`` ``test_approximate`` and ``generate_video``, and of
``avr_tpu/training/loop.py:158 render_full_image``).

The renders run under ``torch.inference_mode()`` on the model's device; the
device defaults to the card (:func:`~avr_tpu_torch.utils.device.resolve_device`).
Randomness is JAX's: every chunk of an image renders with the same threefry
key (``avr_tpu/training/loop.py:188``), and the last chunk is edge-padded to
the full chunk size (``:185-187``), so its draws have the full chunk's shape
and the padded rays' outputs are cut off.  Frame ``i`` of a video renders
with ``PRNGKey(i)``.  The samplers draw the key's stream through K7.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from avr_tpu_torch.models.wrapper import RadFieldRenderer
from avr_tpu_torch.ops.threefry import Key, PRNGKey
from avr_tpu_torch.renderers.base import RaymarcherConfig, RenderOutput
from avr_tpu_torch.utils.device import resolve_device
from avr_tpu_torch.utils.geometry import orbit_cam2world, pixel_grid
from avr_tpu_torch.utils.metrics import get_metrics

__all__ = ["render_full_image", "generate_video", "test_approximate"]

Device = Optional[Union[str, torch.device]]


def render_full_image(model: RadFieldRenderer, cond, intrinsics: torch.Tensor,
                      cam2world: torch.Tensor, sl: int, key: Key,
                      chunk: int = 4096, device: Device = None) -> RenderOutput:
    """Render full ``sl x sl`` images in ``chunk``-ray pieces, each with the
    threefry ``key``; the last piece is edge-padded to ``chunk`` rays.

    ``intrinsics (SB, 3, 3)``, ``cam2world (SB, 4, 4)`` (one pose per
    scene).  Returns a :class:`RenderOutput` of ``(SB, sl*sl, ...)`` tensors
    (``None`` where the renderer gives none).
    """
    dev = resolve_device(device)
    SB = intrinsics.shape[0]
    total = sl * sl
    xy = torch.from_numpy(pixel_grid(sl, sl).reshape(1, total, 2)).to(dev).expand(SB, -1, -1)
    intrinsics = intrinsics.to(dev, torch.float32)
    c2w = cam2world.to(dev, torch.float32)[:, None].expand(SB, chunk, 4, 4)
    pieces = []
    with torch.inference_mode():
        for start in range(0, total, chunk):
            n = min(chunk, total - start)
            xy_c = xy[:, start:start + n]
            if n < chunk:
                xy_c = torch.cat([xy_c, xy_c[:, -1:].expand(SB, chunk - n, 2)], dim=1)
            out = model.render(cond, xy_c, intrinsics, c2w, key)
            pieces.append([None if o is None else o[:, :n] for o in out])
    return RenderOutput(*(None if parts[0] is None else torch.cat(parts, dim=1)
                          for parts in zip(*pieces)))


def generate_video(model: RadFieldRenderer, batch: Dict[str, np.ndarray], num_frames: int,
                   radius: float, fine: bool = True, render_chunk: int = 4096,
                   z_height: float = 0.4, device: Device = None) -> List[np.ndarray]:
    """Orbit-camera render of ``num_frames`` full images of one scene.

    ``batch`` is one collated scene in the dataset's layout (``images
    (SB, NV, sl*sl, 3)`` in [-1, 1], ``cam2world (SB, NV, 4, 4)``,
    ``focal (SB, NV)``, ``c (SB, NV, 2)``, ``intrinsics (SB, NV, 3, 3)``);
    view 0 of scene 0 conditions the field.  Frames show ``rgb_fine``, or
    ``rgb_coarse`` with ``fine=False`` or a renderer that has no fine image
    (the Raymarcher).  Returns uint8 ``(sl, sl, 3)`` frames.
    """
    dev = resolve_device(device)
    images = batch["images"]
    sl = int(np.sqrt(images.shape[2]))
    src = torch.as_tensor(images[:1, :1]).reshape(1, 1, sl, sl, 3).to(dev)
    src_pose = torch.as_tensor(batch["cam2world"][:1, :1]).to(dev)
    focal = float(batch["focal"][0, 0])
    c = torch.as_tensor(batch["c"][0, 0], dtype=torch.float32)
    intr = torch.as_tensor(batch["intrinsics"][:1, 0])
    poses = orbit_cam2world(num_frames, radius, z_height)

    frames = []
    with torch.inference_mode():
        cond = model.encode(src.float(), src_pose.float(), focal, c.to(dev))
        start = time.time()
        for i in range(num_frames):
            out = render_full_image(model, cond, intr, poses[i][None], sl, PRNGKey(i),
                                    render_chunk, dev)
            rgb = out.rgb_fine if fine and out.rgb_fine is not None else out.rgb_coarse
            img = rgb[0].reshape(sl, sl, 3).float().cpu().numpy()
            frames.append(np.clip(img * 255.0, 0, 255).astype(np.uint8))
    print(f"it takes {time.time() - start} seconds to render a video")
    return frames


def test_approximate(model: RadFieldRenderer, state, test_dset, loss_params,
                     lpips_weights: Optional[str] = None, render_chunk: int = 4096,
                     seed: int = 0, max_instances: Optional[int] = None,
                     use_ema: bool = False, num_source_views: int = 1,
                     device: Device = None) -> Dict[str, float]:
    """Mean PSNR / SSIM / (LPIPS) / loss over the test split.

    Each instance conditions on its first ``num_source_views`` views and
    renders one target view drawn from the rest (``default_rng(seed)``),
    instance ``i`` with the threefry key ``PRNGKey(seed + i)``.
    ``use_ema`` evaluates the state's EMA parameters (when kept).  The
    Raymarcher renders no fine image and is scored coarse-only.  With
    ``lpips_weights`` (a local archive, :mod:`avr_tpu_torch.utils.lpips`)
    the result has ``lpips``, or ``lpips_rand`` for an uncalibrated
    (random-VGG) archive."""
    # the training package imports this module (render_full_image)
    from avr_tpu_torch.training.loop import select_source_views
    from avr_tpu_torch.training.loss import loss_fn

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    fine = loss_params.loss_mode != "coarse"
    if isinstance(model.renderer_cfg, RaymarcherConfig) and fine:
        fine = False
        loss_params = dataclasses.replace(loss_params, loss_mode="coarse")

    lpips = None
    if lpips_weights is not None:
        from avr_tpu_torch.utils.lpips import LPIPS

        lpips = LPIPS(lpips_weights, device=dev)

    psnrs, ssims, lpipss, losses = [], [], [], []
    count = 0
    weights = state.eval_variables() if use_ema else contextlib.nullcontext()
    with weights:
        for batch in test_dset.batches(1, shuffle=True, drop_last=True):
            images = batch["images"]
            SB, NV, sl2, _ = images.shape
            sl = int(np.sqrt(sl2))
            ns = min(num_source_views, NV)
            src_images, src_poses, focal, c = select_source_views(
                rng, batch, ns, fixed_idx=list(range(ns)), device=dev)
            with torch.inference_mode():
                cond = model.encode(src_images, src_poses, focal, c, train=False)
            nv = int(rng.integers(ns, NV)) if NV > ns else 0
            intr = torch.from_numpy(np.asarray(batch["intrinsics"][:, nv], np.float32))
            c2w = torch.from_numpy(np.asarray(batch["cam2world"][:, nv], np.float32))
            out = render_full_image(model, cond, intr, c2w, sl, PRNGKey(seed + count),
                                    render_chunk, dev)
            gt = 0.5 * images[:, nv] + 0.5
            p, s = get_metrics(out, gt, fine=fine)
            psnrs.append(p)
            ssims.append(s)
            losses.append(float(loss_fn(out, torch.from_numpy(np.asarray(gt, np.float32))
                                        .to(dev), loss_params)))
            if lpips is not None:
                rgb = out.rgb_fine if (fine and out.rgb_fine is not None) else out.rgb_coarse
                pred = rgb.float().cpu().numpy().reshape(1, sl, sl, 3)
                gti = gt.reshape(1, sl, sl, 3)
                lpipss.append(float(lpips(pred * 2 - 1, gti * 2 - 1)[0]))
            count += 1
            if max_instances is not None and count >= max_instances:
                break

    result = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
              "loss": float(np.mean(losses)), "count": count}
    if lpipss:
        # an uncalibrated (random-VGG) archive reports under its own key
        key = "lpips" if lpips.calibrated else "lpips_rand"
        result[key] = float(np.mean(lpipss))
    print("Test: psnr = {psnr:.5f}, ssim = {ssim:.5f}, loss = {loss:.5f}".format(**result)
          + (f", lpips = {result['lpips']:.5f}" if "lpips" in result else "")
          + (f", lpips_rand = {result['lpips_rand']:.3e}" if "lpips_rand" in result else ""))
    return result
