"""Video CLI (port of ``avr_tpu/cli/video.py``): an orbit-camera render of
a trained model, written as mp4 through ``imageio`` where it can, else as
the raw uint8 frames in an ``.npz`` beside ``--out``.  The JAX CLI's flags
and defaults; runs on the card unless ``device`` says otherwise.

Example::

    python -m avr_tpu_torch.cli.video --root_dir ./runs --renderer AVR_run1 \\
        --epoch 50 --data ./data/cars_val.hdf5 --num_frames 60 --radius 1.3 \\
        --out ./video.mp4
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from avr_tpu_torch.data.dataset import SceneClassDataset, collate_observations
from avr_tpu_torch.evaluation import generate_video
from avr_tpu_torch.models.wrapper import DEFAULT_CONF, make_model
from avr_tpu_torch.training import create_train_state, make_optimizer, restore_checkpoint
from avr_tpu_torch.utils.device import resolve_device

__all__ = ["build_parser", "main", "run", "write_frames"]

Source = Union[str, Mapping[str, Any]]
Device = Optional[Union[str, torch.device]]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root_dir", type=str, required=True)
    p.add_argument("--renderer", type=str, required=True)
    p.add_argument("--epoch", type=int, required=True)
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--instance", type=int, default=0)
    p.add_argument("--num_frames", type=int, default=60)
    p.add_argument("--radius", type=float, default=1.3)
    p.add_argument("--sl", type=int, default=128)
    p.add_argument("--raymarch_steps", type=int, default=10)
    p.add_argument("--norm_type", type=str, default="batch")
    p.add_argument("--conf", type=str, default=None)
    p.add_argument("--out", type=str, default="video.mp4")
    p.add_argument("--fps", type=int, default=15)
    return p


def write_frames(frames, out: str, fps: int) -> str:
    """The frames as a video at ``out`` through ``imageio``; where imageio
    is absent or has no writer for the format (mp4 needs its ffmpeg
    plugin), the frames as ``frames`` in an ``.npz`` beside it.  Returns the
    path written."""
    try:
        import imageio

        imageio.mimsave(out, frames, fps=fps)
        print(f"wrote {out} ({len(frames)} frames)")
        return out
    except (ImportError, ValueError, OSError, RuntimeError) as e:
        alt = os.path.splitext(out)[0] + ".npz"
        np.savez_compressed(alt, frames=np.stack(frames))
        print(f"imageio failed ({type(e).__name__}: {str(e).splitlines()[0]}); wrote raw "
              f"frames to {alt}")
        return alt


def run(opt: argparse.Namespace, *, device: Device = None,
        data_source: Optional[Source] = None):
    """Restore ``{renderer}_epoch{epoch}`` strictly, render ``--num_frames``
    orbit frames of ``--instance`` (its view 0 conditions the field) and
    write them; returns the uint8 frames.  ``data_source`` replaces
    ``--data`` with a path or a mapping in the SRN layout."""
    dev = resolve_device(device)
    model = make_model(opt.conf or DEFAULT_CONF, dtype=torch.float32, seed=0, device=dev,
                       renderer=opt.renderer, norm_type=opt.norm_type,
                       raymarch_steps=opt.raymarch_steps)
    dset = SceneClassDataset(opt.data if data_source is None else data_source,
                             img_sidelength=opt.sl, samples_per_instance=2,
                             specific_observation_idcs=[0])
    batch = collate_observations([dset[opt.instance]])
    state = create_train_state(model, make_optimizer(1e-4))
    restore_checkpoint(opt.root_dir, opt.renderer, opt.epoch, state, strict=True)
    frames = generate_video(model, batch, opt.num_frames, opt.radius, device=dev)
    write_frames(frames, opt.out, opt.fps)
    return frames


def main(argv=None, *, device: Device = None):
    return run(build_parser().parse_args(argv), device=device)


if __name__ == "__main__":
    main()
