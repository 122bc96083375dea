"""Evaluation CLI (port of ``avr_tpu/cli/test.py``): PSNR, SSIM, (LPIPS)
and loss means over a test split, from a checkpoint the training CLI saved.
The JAX CLI's flags and defaults; runs on the card unless ``device`` says
otherwise.

Example::

    python -m avr_tpu_torch.cli.test --root_dir ./runs --renderer AVR_run1 \\
        --epoch 50 --loss_mode both --data ./data/cars_val.hdf5
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Mapping, Optional, Union

import torch

from avr_tpu_torch.data.dataset import SceneClassDataset
from avr_tpu_torch.evaluation import test_approximate
from avr_tpu_torch.models.wrapper import DEFAULT_CONF, make_model
from avr_tpu_torch.renderers.base import AdaptiveRendererConfig
from avr_tpu_torch.training import (LossParams, create_train_state, make_optimizer,
                                    restore_checkpoint)
from avr_tpu_torch.utils.device import resolve_device

__all__ = ["build_parser", "main", "run"]

Source = Union[str, Mapping[str, Any]]
Device = Optional[Union[str, torch.device]]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root_dir", type=str, required=True)
    p.add_argument("--renderer", type=str, required=True)
    p.add_argument("--epoch", type=str, required=True,
                   help="checkpoint epoch number, or 'best' for the best-val-PSNR "
                        "checkpoint fit saves")
    p.add_argument("--loss_mode", type=str, default="both")
    p.add_argument("--data", type=str, required=True, help="Test HDF5")
    p.add_argument("--sl", type=int, default=128)
    p.add_argument("--raymarch_steps", type=int, default=10)
    p.add_argument("--norm_type", type=str, default="batch")
    p.add_argument("--conf", type=str, default=None)
    p.add_argument("--lpips_weights", type=str, default=None,
                   help="a local LPIPS .npz (scripts/make_lpips_weights.py)")
    p.add_argument("--max_instances", type=int, default=None)
    p.add_argument("--num_source_views", type=int, default=1,
                   help="condition on the first NS views (multi-view pooling)")
    p.add_argument("--use_ema", action="store_true",
                   help="evaluate the checkpoint's EMA parameters (runs trained with "
                        "--ema_decay)")
    p.add_argument("--eps_scale", type=float, default=1.0,
                   help="adaptive renderer only: widen the eval-time epsilon-band by "
                        "this factor (1.0 = training band)")
    p.add_argument("--band_samples", type=int, default=None,
                   help="adaptive renderer only: override the band sample count at eval")
    return p


def run(opt: argparse.Namespace, *, device: Device = None,
        data_source: Optional[Source] = None):
    """Restore ``{root_dir}/checkpoints/experiments/{renderer}_{epoch}``
    strictly and score it with ``evaluation.test_approximate``; returns its
    dict.  ``data_source`` replaces ``--data`` with a path or a mapping in
    the SRN layout."""
    dev = resolve_device(device)
    epoch = int(opt.epoch) if opt.epoch.lstrip("-").isdigit() else opt.epoch
    model = make_model(opt.conf or DEFAULT_CONF, dtype=torch.float32, seed=0, device=dev,
                       renderer=opt.renderer, norm_type=opt.norm_type,
                       raymarch_steps=opt.raymarch_steps)
    cfg = model.renderer_cfg
    if isinstance(cfg, AdaptiveRendererConfig) and (opt.eps_scale != 1.0 or opt.band_samples):
        model.renderer_cfg = dataclasses.replace(
            cfg, epsilon=cfg.epsilon * opt.eps_scale,
            n_coarse=opt.band_samples or cfg.n_coarse)
    dset = SceneClassDataset(opt.data if data_source is None else data_source,
                             img_sidelength=opt.sl, samples_per_instance=2)
    state = create_train_state(model, make_optimizer(1e-4), ema=opt.use_ema)
    state = restore_checkpoint(opt.root_dir, opt.renderer, epoch, state, strict=True)
    return test_approximate(model, state, dset, LossParams(loss_mode=opt.loss_mode),
                            lpips_weights=opt.lpips_weights, max_instances=opt.max_instances,
                            use_ema=opt.use_ema, num_source_views=opt.num_source_views,
                            device=dev)


def main(argv=None, *, device: Device = None, data_source: Optional[Source] = None):
    """Parse ``argv`` (default ``sys.argv[1:]``) and :func:`run` on
    ``data_source`` where given."""
    return run(build_parser().parse_args(argv), device=device, data_source=data_source)


if __name__ == "__main__":
    main()
