"""Training driver: the ``fit`` loop (port of ``avr_tpu/training/loop.py``).

Per step: pick the source views of each scene, sample a ray batch (uniform
or foreground-bbox), one optimizer step; periodic loss lines, full-image
validation renders with PSNR/SSIM (the EMA parameters when the state keeps
them), best-val and epoch-tagged checkpoints.

* **Two data paths**, as in JAX.  ``device_data=True`` uploads the whole
  training set to the card once (:mod:`avr_tpu_torch.data.device`) and the
  step draws its own batch from ``fold_in(PRNGKey(seed), step)``; the host
  path assembles each step's batch in numpy, ``prefetch`` steps ahead on a
  worker thread (:class:`~avr_tpu_torch.data.prefetch.PrefetchPipeline`) or
  synchronously with ``prefetch=0``, and renders with ``fold_in(PRNGKey(seed),
  step)``.
* **Deterministic resume**: every step's randomness derives from ``(seed,
  global step)`` and each epoch's data order from ``(seed, epoch index)``;
  a restored checkpoint carries its step, and ``fit`` skips to it inside
  its epoch, so a resumed run reproduces the uninterrupted one.
* **A mesh of ranks.** With ``mesh`` (``parallel/mesh.py``) the loop runs
  the sharded step that ``cfg.step_impl`` picks (``"shardmap"`` or
  ``"gspmd"``, ``parallel/sharded_step.py``): the state is replicated from
  rank 0 once, every process assembles the global-batch-shaped step from
  its own dataset shard and keeps its block (``shard_train_inputs``), and
  the gradients are averaged over the ranks.  Logs come from the primary
  process only; a checkpoint is written by the primary, and every rank
  waits for it (a barrier) before it goes on.

The loop runs on the card unless ``device`` says otherwise; the model must
be on that device.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from avr_tpu_torch.data.dataset import SceneClassDataset
from avr_tpu_torch.data.sampling import gather_rays
from avr_tpu_torch.evaluation import render_full_image
from avr_tpu_torch.ops import threefry
from avr_tpu_torch.parallel import multihost
from avr_tpu_torch.training.checkpoint import save_checkpoint
from avr_tpu_torch.training.loss import LossParams, loss_fn
from avr_tpu_torch.training.state import Optimizer, TrainState
from avr_tpu_torch.training.step import make_train_step
from avr_tpu_torch.utils.device import resolve_device
from avr_tpu_torch.utils.logging import MetricsLogger
from avr_tpu_torch.utils.metrics import get_metrics

__all__ = [
    "FitConfig",
    "fit",
    "render_full_image",
    "validate",
    "validate_scenes",
    "select_source_views",
    "step_rng",
    "assemble_step_inputs",
]

Device = Optional[Union[str, torch.device]]


@dataclasses.dataclass
class FitConfig:
    """JAX's ``FitConfig``: the same fields and defaults, but one that
    ``fit`` does not read (``starting_epoch``, which the CLI reads for its
    restore and its losses file)."""

    epochs: int = 50
    batch_size: int = 4
    ray_batch_size: int = 512
    with_bbox: bool = False
    steps_print: int = 5
    steps_val: int = 50
    epochs_save: int = 10
    num_source_views: int = 1
    render_chunk: int = 4096
    save_root: Optional[str] = None
    run_name: str = "run"
    seed: int = 0
    # host batches assembled ahead on a worker thread; 0 = synchronous
    prefetch: int = 2
    # params-EMA decay used by the train step when the state carries
    # ema_params (create_train_state(ema=True)); no-op otherwise
    ema_decay: float = 0.999
    # the render keys: 'per_ray' (a counter hash on global ray ids) or
    # 'legacy' (the threefry key's own stream)
    rng_mode: str = "per_ray"
    # save {run_name}_best whenever the val PSNR improves (needs save_root
    # and a val set)
    save_best: bool = True
    # validation renders average over this many fixed scenes
    val_scenes: int = 4
    # minimum val-PSNR improvement (dB) before {run}_best is re-saved
    best_margin: float = 0.1
    # the whole training set on the card, each step drawing its batch there
    # (data/device.py); uniform ray sampling only (no bbox)
    device_data: bool = False
    # the sharded step's flavour under a mesh: 'shardmap' or 'gspmd'
    step_impl: str = "shardmap"


def step_rng(seed: int, step: int) -> np.random.Generator:
    """Host RNG for one global step, independent of execution history."""
    return np.random.default_rng(np.random.SeedSequence((seed, step)))


def select_source_views(rng: np.random.Generator, batch: Dict[str, np.ndarray], ns: int,
                        fixed_idx: Optional[List[int]] = None, device: Device = None):
    """Pick ``ns`` source views per scene; returns ``encode`` inputs
    ``(src_images (SB, ns, sl, sl, 3), src_poses (SB, ns, 4, 4), focal, c)``
    as float32 tensors on ``device`` (the card unless the caller asks).
    ``focal`` and ``c`` are the first scene's first selected view's."""
    dev = resolve_device(device)
    images = batch["images"]  # (SB, NV, sl2, 3)
    SB, NV, sl2, _ = images.shape
    sl = int(np.sqrt(sl2))
    if fixed_idx is not None:
        src_idx = np.broadcast_to(np.asarray(fixed_idx)[None, :], (SB, ns))
    else:
        src_idx = rng.integers(0, NV, size=(SB, ns))

    def take(arr):
        return np.take_along_axis(arr, src_idx.reshape(SB, ns, *([1] * (arr.ndim - 2))),
                                  axis=1)

    src_images = take(images).reshape(SB, ns, sl, sl, 3)
    src_poses = take(batch["cam2world"])  # (SB, ns, 4, 4)
    focal = batch["focal"][0, src_idx[0, 0]]
    c = batch["c"][0, src_idx[0, 0]]
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(dev)
    return t(src_images), t(src_poses), t(focal), t(c)


def assemble_step_inputs(rng: np.random.Generator, batch: Dict[str, np.ndarray],
                         ray_batch_size: int, num_source_views: int = 1,
                         with_bbox: bool = False, device: Device = None) -> Tuple:
    """One train step's inputs from a collated scene batch, as tensors on
    ``device``: ``(src_images, src_poses, focal, c, model_input, gt)``."""
    dev = resolve_device(device)
    src_images, src_poses, focal, c = select_source_views(rng, batch, num_source_views,
                                                          device=dev)
    model_input, gt = gather_rays(rng, batch, ray_batch_size, with_bbox=with_bbox)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return src_images, src_poses, focal, c, {k: t(v) for k, v in model_input.items()}, t(gt)


def _epoch_inputs(train_dset: SceneClassDataset, cfg: FitConfig, epoch_idx: int,
                  start_step: int, skip: int, dev: torch.device):
    """Synchronous (step, inputs) stream for one epoch."""
    for i, batch in enumerate(train_dset.batches(cfg.batch_size, shuffle=True,
                                                 epoch_seed=epoch_idx, skip=skip)):
        gstep = start_step + i
        yield gstep, assemble_step_inputs(step_rng(cfg.seed, gstep), batch,
                                          cfg.ray_batch_size, cfg.num_source_views,
                                          cfg.with_bbox, device=dev)


def fit(model, state: TrainState, optimizer: Optimizer, train_dset: SceneClassDataset,
        val_dset: Optional[SceneClassDataset], loss_params: LossParams, cfg: FitConfig,
        logger: Optional[MetricsLogger] = None, mesh=None,
        device: Device = None) -> Tuple[TrainState, List[float]]:
    """Train; returns ``(state, mean epoch losses)``.  The state's
    parameters are the model's own and train in place; the returned state
    is the last step's.  With ``mesh`` (a ``(data, rays)`` mesh of ranks,
    ``parallel/mesh.py``) the loop runs the sharded step on every rank
    (module docstring); ``cfg.batch_size`` and ``cfg.ray_batch_size`` are
    the global batch's."""
    from avr_tpu_torch.data.prefetch import PrefetchPipeline

    dev = resolve_device(device)
    logger = logger or MetricsLogger()
    base_key = threefry.PRNGKey(cfg.seed)

    if mesh is not None:
        from avr_tpu_torch.parallel.mesh import shard_train_inputs
        from avr_tpu_torch.parallel.sharded_step import (make_sharded_train_step,
                                                         make_shardmap_train_step,
                                                         replicate_state)

        if cfg.device_data:
            raise ValueError("device_data is single-device only for now (the sharded step "
                             "samples per-shard batches host-side)")
        data_dim, rays_dim = (mesh.shape[a] for a in mesh.axis_names)
        if cfg.batch_size % data_dim:
            raise ValueError(f"batch_size {cfg.batch_size} not divisible by the mesh data "
                             f"axis ({data_dim})")
        if cfg.ray_batch_size % rays_dim:
            raise ValueError(f"ray_batch_size {cfg.ray_batch_size} not divisible by the mesh "
                             f"rays axis ({rays_dim})")
        if cfg.step_impl not in ("shardmap", "gspmd"):
            raise ValueError(f"unknown step_impl {cfg.step_impl!r}")
        maker = make_sharded_train_step if cfg.step_impl == "gspmd" else make_shardmap_train_step
        train_step = maker(model, optimizer, loss_params, mesh, ema_decay=cfg.ema_decay,
                           rng_mode=cfg.rng_mode)
        state = replicate_state(state, mesh)
    elif cfg.device_data:
        if cfg.with_bbox:
            raise ValueError("device_data supports uniform ray sampling only (bbox sampling "
                             "is host-side)")
        from avr_tpu_torch.data.device import build_device_dataset, make_device_sampler

        dd = build_device_dataset(train_dset, dev)
        sampler = make_device_sampler(dd, cfg.batch_size, cfg.ray_batch_size,
                                      num_source_views=cfg.num_source_views)
        train_step = make_train_step(model, optimizer, loss_params, ema_decay=cfg.ema_decay,
                                     rng_mode=cfg.rng_mode, sampler=sampler,
                                     sampler_key=base_key)
    else:
        train_step = make_train_step(model, optimizer, loss_params, ema_decay=cfg.ema_decay,
                                     rng_mode=cfg.rng_mode)

    spe = max(train_dset.num_instances // cfg.batch_size, 1)  # steps/epoch
    start_step = int(state.step)
    epoch_idx0 = start_step // spe
    primary = multihost.is_primary()

    mean_losses = []
    step = start_step
    t_last = time.time()
    rays_done = 0
    # a notfinite count that grows over consecutive logging intervals means
    # every batch is bad: say so loudly
    last_notfinite = None
    notfinite_growth_streak = 0
    best_psnr = -float("inf")

    for epoch_idx in range(epoch_idx0, epoch_idx0 + cfg.epochs):
        epoch = epoch_idx + 1
        epoch_start = epoch_idx * spe
        skip = step - epoch_start  # mid-epoch resume skip (0 normally)
        losses = []

        if cfg.device_data:
            # batches are drawn on the card inside the step: the stream is
            # just the global-step counter
            stream = ((gs, None) for gs in range(epoch_start + skip, epoch_start + spe))
        elif cfg.prefetch > 0:
            pipe = PrefetchPipeline(train_dset, cfg.batch_size, cfg.ray_batch_size,
                                    num_source_views=cfg.num_source_views,
                                    with_bbox=cfg.with_bbox, depth=cfg.prefetch,
                                    seed=cfg.seed, device=dev)
            stream = pipe.epoch(epoch_seed=epoch_idx, start_step=epoch_start, skip=skip)
        else:
            stream = _epoch_inputs(train_dset, cfg, epoch_idx, epoch_start + skip, skip, dev)

        for gstep, inputs in stream:
            if inputs is None:
                state, metrics = train_step(state)
                rays_done += cfg.batch_size * cfg.ray_batch_size
            else:
                sub = threefry.fold_in(base_key, gstep)
                args = inputs if mesh is None else shard_train_inputs(mesh, *inputs)
                state, metrics = train_step(state, *args, sub)
                gt = inputs[-1]
                rays_done += int(gt.shape[0]) * int(gt.shape[1])
            step = gstep + 1

            if step % cfg.steps_print == 0:
                scal = multihost.gather_metrics({"loss": metrics["loss"],
                                                 "grad_norm": metrics["grad_norm"]})
                dt = time.time() - t_last
                if primary:
                    logger.log("train", epoch=epoch, step=step, loss=scal["loss"],
                               grad_norm=scal["grad_norm"],
                               rays_per_s=rays_done * multihost.process_count()
                               / max(dt, 1e-9))
                t_last = time.time()
                rays_done = 0
                losses.append(scal["loss"])
                nf = metrics.get("notfinite")
                if nf is not None:
                    nf = int(nf)
                    if last_notfinite is not None and nf > last_notfinite:
                        notfinite_growth_streak += 1
                        if notfinite_growth_streak >= 3 and primary:
                            warnings.warn(
                                f"step {step}: non-finite updates skipped in "
                                f"{notfinite_growth_streak} consecutive logging intervals "
                                f"(total {nf}) — training is producing NaN/inf gradients "
                                "persistently; each such update is skipped, parameters "
                                "and Adam moments alike.")
                    else:
                        notfinite_growth_streak = 0
                    last_notfinite = nf

            if val_dset is not None and step % cfg.steps_val == 0:
                psnr_v, ssim_v, val_loss = validate_scenes(
                    model, state, val_dset, loss_params, cfg.render_chunk,
                    num_scenes=cfg.val_scenes, num_source_views=cfg.num_source_views,
                    device=dev)
                if primary:
                    logger.log("val", epoch=epoch, step=step, loss=val_loss, psnr=psnr_v,
                               ssim=ssim_v)
                if psnr_v > best_psnr + cfg.best_margin:
                    best_psnr = psnr_v
                    if cfg.save_root is not None and cfg.save_best and primary:
                        path = save_checkpoint(cfg.save_root, cfg.run_name, "best", state)
                        logger.log("checkpoint", epoch=epoch, step=step, path=path,
                                   best_psnr=psnr_v)
                multihost.barrier()  # the primary's checkpoint is in place

        if losses:
            mean_losses.append(float(np.mean(losses)))
        # the run's last epoch always checkpoints, whatever the cadence
        last = epoch == epoch_idx0 + cfg.epochs
        if cfg.save_root is not None and (epoch % cfg.epochs_save == 0 or last):
            if primary:
                path = save_checkpoint(cfg.save_root, cfg.run_name, epoch, state)
                logger.log("checkpoint", epoch=epoch, path=path)
            multihost.barrier()

    return state, mean_losses


def validate_scenes(model, state: TrainState, val_dset: SceneClassDataset,
                    loss_params: LossParams, chunk: int = 4096, num_scenes: int = 4,
                    num_source_views: int = 1, device: Device = None):
    """Deterministic validation: mean (PSNR, SSIM, loss) over a fixed scene
    set, the scene order pinned by ``epoch_seed=0``."""
    ps, ss, ls = [], [], []
    for i, batch in enumerate(val_dset.batches(1, shuffle=True, epoch_seed=0,
                                               drop_last=False)):
        if i >= num_scenes:
            break
        p, s, l = validate(model, state, batch, loss_params, chunk,
                           num_source_views=num_source_views, device=device)
        ps.append(p)
        ss.append(s)
        ls.append(l)
    return float(np.mean(ps)), float(np.mean(ss)), float(np.mean(ls))


def validate(model, state: TrainState, val_batch, loss_params: LossParams,
             chunk: int = 4096, src_view: int = 0, target_view: int = 1,
             num_source_views: int = 1, device: Device = None):
    """Full-image validation render of one held-out view with the EMA
    parameters when the state keeps them; returns ``(psnr, ssim, loss)``.
    ``num_source_views > 1`` conditions on views ``src_view, src_view + 1,
    ...`` and targets the first view after them."""
    dev = resolve_device(device)
    images = val_batch["images"]
    SB, NV, sl2, _ = images.shape
    sl = int(np.sqrt(sl2))
    rng = np.random.default_rng(0)
    ns = min(num_source_views, NV - 1)
    src_images, src_poses, focal, c = select_source_views(
        rng, val_batch, ns, fixed_idx=[src_view + i for i in range(ns)], device=dev)
    target_view = max(target_view, src_view + ns)
    tv = min(target_view, NV - 1)
    intr = torch.from_numpy(np.asarray(val_batch["intrinsics"][:, tv], np.float32))
    c2w = torch.from_numpy(np.asarray(val_batch["cam2world"][:, tv], np.float32))
    with state.eval_variables(), torch.inference_mode():
        cond = model.encode(src_images, src_poses, focal, c, train=False)
        out = render_full_image(model, cond, intr, c2w, sl, threefry.PRNGKey(0), chunk, dev)
    gt = 0.5 * images[:, tv] + 0.5
    psnr_v, ssim_v = get_metrics(out, gt, fine=loss_params.loss_mode != "coarse")
    val_loss = float(loss_fn(out, torch.from_numpy(np.asarray(gt, np.float32)).to(dev),
                             loss_params))
    return psnr_v, ssim_v, val_loss
