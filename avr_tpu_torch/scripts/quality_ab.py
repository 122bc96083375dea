"""Quality A/B at matched budgets (port of ``scripts/quality_ab.py``).

Trains each arm through the port's ``cli.train`` on the same synthetic
sets, seeds, optimizer and step budget, and scores it with ``cli.test``:
the final and the best-val checkpoint, each with the raw and the EMA
parameters, and on the adaptive arms the ``--eps_scales`` sweep of the
best checkpoint.  The flags and the arms' settings are JAX's script's:
the per-arm ``--loss_mode``, ``--sigma_bias_init 0.5`` for the VR arms,
group norm, bf16, the cosine schedule, the EMA, ``--rng_mode legacy``,
``--seed 0``.  Runs on the card.

Where it departs from JAX's script:

* the sets (train ``--instances`` x ``--train_views`` views of
  ``--side``\\ :sup:`2`, seed 0; val 8 x 6, seed 9) are built in memory by
  ``data/synthetic.py synthetic_scene_mapping`` and handed to the CLIs as
  sources, so no ``h5py`` is needed; ``--data`` and ``--val_data`` still
  name the files JAX's script would write;
* ``--lpips_weights auto_rand`` writes ``utils/lpips.py random_state(0)``;
* ``--stop_epoch E`` trains the arm's whole schedule (its cosine horizon
  through ``--schedule_total_epochs``) but stops after epoch ``E``; a rerun
  with the same workdir resumes from the arm's newest epoch checkpoint
  (``--starting_epoch``), so a long run spans several calls.  The resume is
  bit for bit the uninterrupted run;
* ``--dtype f32`` (a probe; JAX's script always trains in bf16) trains the
  arms in float32, to split a bf16 effect on the curve from the rest.

Each arm's result also carries its skipped (non-finite) updates and its
ms a step (wall, validation included).

    python -m avr_tpu_torch.scripts.quality_ab --workdir runs/q --steps 10000 \\
        --renderers VR_dd10k --ray_batch_size 1024 --device_data --stop_epoch 313

Artifacts: ``<workdir>/logs/{ARM}.jsonl`` training and val curves,
``<workdir>/eval_{ARM}.json`` test metrics, checkpoints under
``<workdir>/checkpoints/experiments/``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import time
from typing import Optional, Union

import numpy as np
import torch

__all__ = ["build_parser", "main", "make_sets", "newest_epoch"]

Device = Optional[Union[str, torch.device]]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", required=True)
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--side", type=int, default=128)
    p.add_argument("--instances", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--ray_batch_size", type=int, default=512)
    p.add_argument("--renderers", type=str, default="AVR_q,VR_q",
                   help="comma-separated run names (prefix selects renderer)")
    p.add_argument("--steps_val", type=int, default=250)
    p.add_argument("--ema_decay", type=float, default=0.999)
    p.add_argument("--depth_consistency", type=float, default=0.0,
                   help="applied to the adaptive arms only")
    p.add_argument("--num_source_views", type=int, default=1,
                   help=">1 trains/evaluates multi-view conditioning "
                        "(cross-view pooling at combine_layer)")
    p.add_argument("--eps_scales", type=str, default="",
                   help="comma-separated band-widening factors to sweep at eval on the "
                        "adaptive arms' best checkpoint, e.g. '1.5,2,3'")
    p.add_argument("--lpips_weights", type=str, default="auto_rand",
                   help="LPIPS archive path; 'auto_rand' writes the deterministic "
                        "random-VGG archive (reported as lpips_rand); '' disables")
    p.add_argument("--train_views", type=int, default=12)
    p.add_argument("--device_data", action="store_true",
                   help="train with the device-resident dataset")
    p.add_argument("--epochs_save", type=int, default=0,
                   help="save a checkpoint every N epochs (0 = final only)")
    p.add_argument("--stop_epoch", type=int, default=0,
                   help="stop each arm after this epoch of its full schedule (0 = run it "
                        "all); a rerun with the same workdir resumes from the arm's "
                        "newest epoch checkpoint")
    p.add_argument("--dtype", type=str, default="bf16", choices=("bf16", "f32"),
                   help="the arms' training dtype; f32 is a probe against the bf16 curve")
    return p


def make_sets(opt):
    """``(train, val)``: the sets JAX's script writes as HDF5, in memory."""
    from avr_tpu_torch.data.synthetic import synthetic_scene_mapping

    return (synthetic_scene_mapping(num_instances=opt.instances, num_views=opt.train_views,
                                    side=opt.side, seed=0),
            synthetic_scene_mapping(num_instances=8, num_views=6, side=opt.side, seed=9))


def newest_epoch(workdir: str, name: str) -> int:
    """The highest ``E`` with a ``{name}_epoch{E}`` checkpoint, or 0."""
    pattern = os.path.join(os.path.abspath(workdir), "checkpoints", "experiments",
                           f"{name}_epoch*")
    found = [re.fullmatch(rf"{re.escape(name)}_epoch(\d+)", os.path.basename(p))
             for p in glob.glob(pattern)]
    return max((int(m.group(1)) for m in found if m), default=0)


def main(argv=None, *, device: Device = None):
    from avr_tpu_torch.cli import test as cli_test
    from avr_tpu_torch.cli import train as cli_train
    from avr_tpu_torch.renderers.base import AdaptiveRendererConfig
    from avr_tpu_torch.utils.device import resolve_device
    from avr_tpu_torch.utils.lpips import random_state

    opt = build_parser().parse_args(argv)
    dev = resolve_device(device)
    os.makedirs(os.path.join(opt.workdir, "data"), exist_ok=True)
    os.makedirs(os.path.join(opt.workdir, "logs"), exist_ok=True)
    train_h5 = os.path.join(opt.workdir, "data", "train.hdf5")
    val_h5 = os.path.join(opt.workdir, "data", "val.hdf5")
    train_set, val_set = make_sets(opt)

    if opt.lpips_weights == "auto_rand":
        opt.lpips_weights = os.path.join(opt.workdir, "lpips_rand.npz")
        if not os.path.exists(opt.lpips_weights):
            np.savez(opt.lpips_weights, **random_state(0))

    spe = max(opt.instances // opt.batch_size, 1)
    epochs = max((opt.steps + spe - 1) // spe, 1)
    stop = min(opt.stop_epoch, epochs) if opt.stop_epoch else epochs

    def train_main(args):
        return cli_train.main(args, device=dev, train_source=train_set, val_source=val_set)

    def test_main(args):
        return cli_test.main(args, device=dev, data_source=val_set)

    def eval_args(name, epoch, use_ema=False, extra=()):
        args = ["--root_dir", opt.workdir, "--renderer", name, "--epoch", str(epoch),
                "--data", val_h5, "--sl", str(opt.side), "--norm_type", "group",
                "--num_source_views", str(opt.num_source_views)]
        if use_ema:
            args.append("--use_ema")
        if opt.lpips_weights:
            args += ["--lpips_weights", opt.lpips_weights]
        return args + list(extra)

    summary = {}
    for name in opt.renderers.split(","):
        adaptive = not (name.startswith("VR") or "Raymarcher" in name)
        start = min(newest_epoch(opt.workdir, name), stop) if opt.stop_epoch else 0
        t0 = time.time()
        train_args = [
            "--root_dir", opt.workdir,
            # the raymarcher renders coarse only: 'both' would raise
            "--loss_mode", "coarse" if "Raymarcher" in name else "both",
            "--renderer", name,
            "--starting_epoch", str(start),
            "--sl", str(opt.side),
            "--batch_size", str(opt.batch_size),
            "--ray_batch_size", str(opt.ray_batch_size),
            "--epochs", str(stop - start),
            "--epochs_save", str(opt.epochs_save or epochs),
            "--samples_per_instance", "8",
            "--steps_print", "50",
            "--steps_val", str(opt.steps_val),
            "--norm_type", "group",
            "--dtype", opt.dtype,
            "--num_source_views", str(opt.num_source_views),
            "--lr_schedule", "cosine",
            # each arm's density init at its trainable best
            "--sigma_bias_init", "0.5" if name.startswith("VR") else "0.0",
            "--ema_decay", str(opt.ema_decay),
            "--rng_mode", "legacy",
            "--seed", "0",
            "--data", train_h5,
            "--val_data", val_h5,
        ]
        if opt.stop_epoch:
            train_args += ["--schedule_total_epochs", str(epochs)]
        if adaptive and opt.depth_consistency:
            train_args += ["--depth_consistency", str(opt.depth_consistency)]
        if opt.device_data:
            train_args += ["--device_data"]
        entry = {"steps": stop * spe}
        if start < stop:
            state = train_main(train_args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            train_s = time.time() - t0
            steps_run = (stop - start) * spe
            entry.update(
                train_seconds=round(train_s, 1),
                rays_per_s_train=round(
                    steps_run * opt.batch_size * opt.ray_batch_size / train_s, 1),
                resumed_from_epoch=start, steps_this_call=steps_run,
                ms_per_step=1e3 * train_s / steps_run)
            if state is not None:
                entry["skipped_updates"] = int(state.opt_state.total_notfinite)
        # final x best, raw x EMA: the table reports each arm at its honest best
        for tag, epoch in (("final", stop), ("best", "best")):
            for ema_tag, use_ema in (("raw", False), ("ema", True)):
                if opt.ema_decay <= 0 and use_ema:
                    continue
                m = test_main(eval_args(name, epoch, use_ema))
                if isinstance(m, dict):
                    entry[f"{tag}_{ema_tag}"] = {k: float(v) for k, v in m.items()}
        entry.update(entry.get("final_raw", {}))
        if adaptive and opt.eps_scales:
            entry["eps_sweep"] = {}
            n0 = AdaptiveRendererConfig().n_coarse
            for s in opt.eps_scales.split(","):
                s = float(s)
                m = test_main(eval_args(name, "best", False,
                                        ["--eps_scale", str(s),
                                         "--band_samples", str(int(round(n0 * s)))]))
                if isinstance(m, dict):
                    entry["eps_sweep"][s] = {k: float(v) for k, v in m.items()}
        summary[name] = entry
        with open(os.path.join(opt.workdir, f"eval_{name}.json"), "w") as f:
            json.dump(entry, f, indent=1)
        print(f"[quality_ab] {name}: {entry}", flush=True)

    with open(os.path.join(opt.workdir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
