"""Training CLI (port of ``avr_tpu/cli/train.py``).

Flag-compatible with the JAX package's CLI, which is flag-compatible with
the reference training script (its ``train.py:175-320``): the same
options, choices and defaults.  Runs on the card; ``main(argv,
device="cpu")`` runs the plain versions of the kernels on the host.

The model options come from ``--conf`` (JAX's ``model`` subtree: the
global and custom encoders, ``feature_scale``, the point-feature and
encoding variants, SPADE, softplus ``beta``, ``combine_type``, ``type =
mlp``, ``mlp_fine { type = empty }``) and ``--bn``.  Three values select
JAX's XLA path beside a kernel that computes the same function, and the
port runs one implementation on the card, so they raise (one table,
``models/pixelnerf.py XLA_ONLY``): ``--fused_mlp never``, ``--fused_march
never`` and ``--gather_impl xla``.

Several processes, one a device (``parallel/``): a launcher's environment
or ``--multihost`` joins the process group (NCCL on the cards, gloo on the
CPU), each process reads its own shard of the instances, and ``--mesh
D,R`` trains one model over a ``(data, rays)`` mesh of the ranks with the
``--step_impl`` flavour.  ``--multihost`` without a launcher runs one
process.

Example::

    python -m avr_tpu_torch.cli.train --root_dir ./runs --loss_mode both \\
        --renderer AVR_run1 --starting_epoch 0 --data ./data/cars_train.hdf5 \\
        --val_data ./data/cars_val.hdf5

    python -m torch.distributed.run --nproc_per_node 4 -m avr_tpu_torch.cli.train \\
        --mesh 2,2 --root_dir ./runs --loss_mode both --renderer AVR_run1 \\
        --starting_epoch 0 --data ./data/cars_train.hdf5
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from avr_tpu_torch.data.dataset import SceneClassDataset
from avr_tpu_torch.models.resnet import RESNET_STAGES
from avr_tpu_torch.models.wrapper import DEFAULT_CONF, add_sigma_bias, make_model
from avr_tpu_torch.parallel import make_mesh, multihost
from avr_tpu_torch.training import (FitConfig, LossParams, create_train_state, fit,
                                    make_optimizer, restore_checkpoint)
from avr_tpu_torch.utils.device import resolve_device
from avr_tpu_torch.utils.logging import MetricsLogger

__all__ = ["build_parser", "main", "run"]

Source = Union[str, Mapping[str, Any]]
Device = Optional[Union[str, torch.device]]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    # reference-compatible knobs (train.py:176-222)
    p.add_argument("--root_dir", type=str, required=True, help="Run/checkpoint root")
    p.add_argument("--loss_mode", type=str, required=True,
                   choices=["coarse", "fine", "both"], help="Loss mode")
    p.add_argument("--depth_regularization", action="store_true",
                   help="Apply the depth-range hinge penalty")
    p.add_argument("--renderer", type=str, required=True,
                   help="Experiment name; prefix picks the renderer "
                        "(Raymarcher*/VR*/else adaptive)")
    p.add_argument("--starting_epoch", type=int, required=True,
                   help="Epoch to resume from (0 = fresh)")
    p.add_argument("--sl", type=int, default=128, help="Image sidelength")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--schedule_total_epochs", type=int, default=0,
                   help="cosine-horizon override in epochs (default: --epochs). A "
                        "resumed run passes the ORIGINAL total here so the restored "
                        "optimizer step count continues the same decay")
    p.add_argument("--lr_schedule", type=str, default="constant",
                   choices=["constant", "cosine"],
                   help="constant (reference parity) or warmup+cosine decay")
    p.add_argument("--sigma_bias_init", type=float, default=0.0,
                   help="added to the decoders' raw-density output bias at init; a "
                        "small positive value (e.g. 0.5) starts the field 'foggy'. "
                        "0 = reference parity.")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="params-EMA decay for validation/eval (0 = off); saved in "
                        "checkpoints as ema_params")
    p.add_argument("--depth_consistency", type=float, default=0.0,
                   help="opacity-weighted marcher<-integral depth-consistency loss "
                        "weight (adaptive renderer only; 0 = off = reference parity)")
    p.add_argument("--no_save_best", action="store_true",
                   help="disable saving {renderer}_best at every new best val PSNR")
    p.add_argument("--encoder_weights", type=str, default=None,
                   help="npz of a torchvision resnet18/34 state dict "
                        "(np.savez(path, **{k: v.numpy() for k, v in sd.items()})) to "
                        "warm-start the spatial encoder. Requires --norm_type batch "
                        "(the weights carry BatchNorm statistics).")
    p.add_argument("--max_num_instances", type=int, default=-1)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--with_bbox", action="store_true")
    p.add_argument("--samples_per_instance", type=int, default=50)
    p.add_argument("--ray_batch_size", type=int, default=512)
    p.add_argument("--raymarch_steps", type=int, default=10)
    p.add_argument("--stop_encoder_grad", action="store_true")
    p.add_argument("--anomaly_detection", action="store_true",
                   help="Enable autograd's anomaly detection for the run "
                        "(torch.autograd.set_detect_anomaly)")
    p.add_argument("--bn", action="store_true",
                   help="BatchNorm in the decoder MLP")
    p.add_argument("--no_visualization", action="store_true", default=True)
    p.add_argument("--steps_print", type=int, default=5)
    p.add_argument("--steps_val", type=int, default=50)
    p.add_argument("--epochs_save", type=int, default=10)
    # data paths (the reference hardcodes {root}/data/cars_*.hdf5)
    p.add_argument("--data", type=str, default=None,
                   help="Train HDF5 (default {root_dir}/data/cars_train.hdf5)")
    p.add_argument("--val_data", type=str, default=None,
                   help="Val HDF5 (default {root_dir}/data/cars_val.hdf5)")
    p.add_argument("--conf", type=str, default=None,
                   help="Config file (default conf/default_mv.conf)")
    # the JAX package's additions
    p.add_argument("--mesh", type=str, default=None,
                   help="Mesh shape 'data,rays' over the ranks, e.g. '2,4'; default "
                        "one process, one device")
    p.add_argument("--step_impl", type=str, default="shardmap",
                   choices=["shardmap", "gspmd"],
                   help="Mesh step flavour: each rank's own batch statistics and "
                        "decorrelated legacy draws (shardmap, default), or the "
                        "single-device step partitioned (gspmd)")
    p.add_argument("--multihost", action="store_true",
                   help="Join the process group (torch.distributed; also done when a "
                        "launcher's environment is present) and shard instances per "
                        "process")
    p.add_argument("--device_data", action="store_true",
                   help="upload the whole scene set to the card once and draw batches "
                        "inside the train step (uniform sampling)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="Host input batches assembled ahead on a worker thread; "
                        "0 = synchronous")
    p.add_argument("--num_source_views", type=int, default=1)
    p.add_argument("--norm_type", type=str, default="batch",
                   choices=["batch", "group", "instance", "none"],
                   help="Encoder norm (group recommended without pretrained weights)")
    p.add_argument("--dtype", type=str, default="f32", choices=["f32", "bf16"],
                   help="Compute dtype (params stay f32; integration/geometry f32)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="Trace the training run with torch.profiler into this "
                        "directory as a chrome trace (read it with python -m "
                        "avr_tpu_torch.profiling.analyze DIR)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rng_mode", type=str, default="per_ray",
                   choices=["legacy", "per_ray"],
                   help="sampler randomness: 'per_ray' hashes global ray ids; 'legacy' "
                        "draws from the per-step threefry key")
    p.add_argument("--prng_impl", type=str, default="rbg",
                   choices=["rbg", "threefry2x32"],
                   help="JAX's PRNG implementation. The port's keys are threefry2x32 "
                        "under both: an rbg key holds two copies of the threefry key, "
                        "so the per_ray draws are JAX's under either; the draws JAX "
                        "takes from lax.rng_bit_generator under rbg (--rng_mode legacy, "
                        "the --device_data sampler) come from threefry in the port")
    p.add_argument("--gather_impl", type=str, default="auto",
                   choices=["auto", "pallas", "pallas_proj", "xla"],
                   help="Pixel-aligned feature gather: 'auto'/'pallas' the K1 kernel, "
                        "'pallas_proj' the K5 kernel (projection in-kernel); 'xla' "
                        "(JAX's XLA gather) raises: one implementation on the card")
    p.add_argument("--fused_mlp", type=str, default="auto",
                   choices=["auto", "never", "always", "stash", "always_stash"],
                   help="Decoder kernel backward: 'stash' keeps the forward's "
                        "activations; 'never' (JAX's XLA decoder) raises: one "
                        "implementation on the card")
    p.add_argument("--fused_march", type=str, default="auto",
                   choices=["auto", "never", "always"],
                   help="LSTM ray-march kernel ('never', JAX's lax.scan march, raises: one "
                        "implementation on the card)")
    return p


def warm_start_encoder(model, path: str) -> None:
    """Load a torchvision ResNet ``.npz`` into the encoder's trunk; raises
    ``SystemExit`` when the archive is not the configured encoder (JAX's
    CLI, ``avr_tpu/cli/train.py:243-274``)."""
    from avr_tpu_torch.models.torch_import import import_torchvision_resnet

    enc = model.net.cfg.encoder
    trunk = model.net.encoder.model
    with np.load(path) as f:
        sd = dict(f)
    try:
        imported = import_torchvision_resnet(sd, RESNET_STAGES[enc.backbone][0], enc.num_layers)
    except KeyError as e:
        raise SystemExit(f"{path} does not match the configured encoder ({enc.backbone}, "
                         f"num_layers={enc.num_layers}): missing {e}") from None
    have = {k: tuple(v.shape) for k, v in trunk.state_dict().items()}
    want = {k: tuple(v.shape) for k, v in imported.items()}
    if have != want:
        raise SystemExit(f"{path} does not match the configured encoder ({enc.backbone}, "
                         f"num_layers={enc.num_layers}): {sorted(set(want) ^ set(have))[:8]} "
                         f"or shapes differ")
    trunk.load_state_dict(imported)


def _losses_file(losses, start_epoch: int, png: str) -> str:
    """``plot_losses``, or where matplotlib is absent the losses as JSON
    beside where the PNG would go."""
    try:
        from avr_tpu_torch.utils.viz import plot_losses

        return plot_losses(losses, start_epoch, png)
    except ImportError as e:
        alt = os.path.splitext(png)[0] + ".json"
        with open(alt, "w") as f:
            json.dump({"start_epoch": start_epoch, "mean_losses": list(losses)}, f)
        print(f"matplotlib unavailable ({e}); wrote the epoch losses to {alt}")
        return alt


def run(opt: argparse.Namespace, *, device: Device = None,
        train_source: Optional[Source] = None, val_source: Optional[Source] = None):
    """Train as ``opt`` (the parsed flags) says; returns the final
    :class:`~avr_tpu_torch.training.TrainState`.  ``train_source`` and
    ``val_source`` replace ``--data`` and ``--val_data`` with a path or a
    mapping in the SRN layout (``data/dataset.py``), for a machine without
    ``h5py``."""
    dev = resolve_device(device)
    mesh_shape = None
    if opt.mesh:
        mesh_shape = tuple(int(x) for x in opt.mesh.split(","))
        if len(mesh_shape) != 2:
            raise SystemExit(f"--mesh wants 'data,rays', got {opt.mesh!r}")
    if opt.multihost or multihost.launched():
        multihost.initialize(device=dev)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(mesh_shape) if mesh_shape else None
    primary = multihost.is_primary()
    model = make_model(opt.conf or DEFAULT_CONF,
                       dtype=torch.bfloat16 if opt.dtype == "bf16" else torch.float32,
                       seed=opt.seed, device=dev, renderer=opt.renderer,
                       gather_impl=opt.gather_impl, norm_type=opt.norm_type,
                       stop_encoder_grad=opt.stop_encoder_grad,
                       raymarch_steps=opt.raymarch_steps, fused_mlp=opt.fused_mlp,
                       fused_march=opt.fused_march, bn=opt.bn)

    if train_source is None:
        train_source = opt.data or os.path.join(opt.root_dir, "data", "cars_train.hdf5")
    if val_source is None:
        val_source = opt.val_data or os.path.join(opt.root_dir, "data", "cars_val.hdf5")
    train_dset = SceneClassDataset(
        train_source, img_sidelength=opt.sl, max_num_instances=opt.max_num_instances,
        samples_per_instance=opt.samples_per_instance, seed=opt.seed,
        shard_index=multihost.process_index(), num_shards=multihost.process_count())
    val_dset = None
    if not isinstance(val_source, str) or os.path.exists(val_source):
        val_dset = SceneClassDataset(
            val_source, img_sidelength=opt.sl, max_num_instances=opt.max_num_instances,
            specific_observation_idcs=[0], samples_per_instance=2, seed=opt.seed)

    if opt.encoder_weights:
        # warm-start the encoder trunk (reference models.py:227 pretrained=True)
        if opt.norm_type != "batch":
            raise SystemExit("--encoder_weights carries BatchNorm statistics; run with "
                             "--norm_type batch (the reference's pretrained configuration)")
        warm_start_encoder(model, opt.encoder_weights)
        if primary:
            print(f"[train] encoder warm-started from {opt.encoder_weights}")
    if opt.sigma_bias_init:
        add_sigma_bias(model, opt.sigma_bias_init)

    # Adam + non-finite-update skip; optional warmup+cosine decay over the
    # run's total step budget
    steps_per_epoch = max(len(train_dset) // max(opt.batch_size, 1), 1)
    tx = make_optimizer(opt.lr, schedule=opt.lr_schedule,
                        total_steps=(opt.schedule_total_epochs or opt.epochs) * steps_per_epoch)
    state = create_train_state(model, tx, ema=opt.ema_decay > 0)
    if opt.starting_epoch > 0:
        state = restore_checkpoint(opt.root_dir, opt.renderer, opt.starting_epoch, state)

    fit_cfg = FitConfig(
        epochs=opt.epochs, batch_size=opt.batch_size, ray_batch_size=opt.ray_batch_size,
        with_bbox=opt.with_bbox, steps_print=opt.steps_print, steps_val=opt.steps_val,
        epochs_save=opt.epochs_save, num_source_views=opt.num_source_views,
        save_root=opt.root_dir, run_name=opt.renderer, seed=opt.seed, prefetch=opt.prefetch,
        ema_decay=opt.ema_decay, save_best=not opt.no_save_best, rng_mode=opt.rng_mode,
        device_data=opt.device_data, step_impl=opt.step_impl)
    loss_params = LossParams(loss_mode=opt.loss_mode,
                             depth_regularization=opt.depth_regularization,
                             depth_consistency=opt.depth_consistency)

    trace = contextlib.nullcontext()
    profile = opt.profile_dir and primary
    if profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        trace = profile(activities=acts)
    # the primary process logs; the others keep quiet
    logger = MetricsLogger(os.path.join(opt.root_dir, "logs") if primary else None,
                           name=opt.renderer, stdout=primary)
    anomaly = torch.is_anomaly_enabled()
    try:
        if opt.anomaly_detection:
            from avr_tpu_torch.utils.debug import enable_nan_debugging

            enable_nan_debugging(True)
        with trace as prof:
            state, mean_losses = fit(model, state, tx, train_dset, val_dset, loss_params,
                                     fit_cfg, logger, mesh=mesh, device=dev)
    finally:
        torch.autograd.set_detect_anomaly(anomaly)
        logger.close()
    if profile:
        os.makedirs(opt.profile_dir, exist_ok=True)
        path = os.path.join(opt.profile_dir, f"{opt.renderer}.pt.trace.json")
        prof.export_chrome_trace(path)
        print(f"[train] torch.profiler trace: {path}")
    if primary:
        os.makedirs(os.path.join(opt.root_dir, "logs"), exist_ok=True)
        _losses_file(mean_losses, opt.starting_epoch,
                     os.path.join(opt.root_dir, "logs",
                                  f"losses_{opt.renderer}_epoch{opt.starting_epoch}.png"))
    return state


def main(argv=None, *, device: Device = None, train_source: Optional[Source] = None,
         val_source: Optional[Source] = None):
    """Parse ``argv`` (default ``sys.argv[1:]``) and :func:`run` with the
    given sources."""
    return run(build_parser().parse_args(argv), device=device, train_source=train_source,
               val_source=val_source)


if __name__ == "__main__":
    main()
