"""End-to-end demo (port of ``examples/train_synthetic.py``): train the
adaptive renderer on synthetic scenes through the CLIs.

Makes a synthetic multi-view set in the SRN layout, trains the adaptive
renderer for a few epochs (``cli.train``: validation renders with
PSNR/SSIM, checkpoints), and renders a small orbit video of the last
checkpoint (``cli.video``).  Where ``h5py`` imports, the sets are written as
HDF5 files under ``--workdir/data`` and the CLIs read them; without it they
are built in memory as mappings with the files' layout and handed to the
CLIs' ``run`` functions.  Runs on the card.

    python -m avr_tpu_torch.examples.train_synthetic --workdir /tmp/avr_demo --epochs 4
"""

from __future__ import annotations

import argparse
import os

from avr_tpu_torch.cli import train as cli_train
from avr_tpu_torch.cli import video as cli_video
from avr_tpu_torch.data import synthetic
from avr_tpu_torch.utils.device import resolve_device


def _sets(opt):
    """``(train, val)`` sources: HDF5 paths where h5py imports, else
    mappings in the SRN layout."""
    train = dict(num_instances=opt.num_instances, num_views=12, side=opt.side)
    val = dict(num_instances=2, num_views=6, side=opt.side, seed=9)
    try:
        import h5py  # noqa: F401
    except ImportError:
        print("h5py unavailable: the synthetic sets stay in memory")
        return synthetic.synthetic_scene_mapping(**train), synthetic.synthetic_scene_mapping(**val)
    os.makedirs(os.path.join(opt.workdir, "data"), exist_ok=True)
    train_h5 = os.path.join(opt.workdir, "data", "cars_train.hdf5")
    val_h5 = os.path.join(opt.workdir, "data", "cars_val.hdf5")
    if not os.path.exists(train_h5):
        synthetic.write_synthetic_hdf5(train_h5, **train)
        synthetic.write_synthetic_hdf5(val_h5, **val)
    return train_h5, val_h5


def main(argv=None, *, device=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", type=str, required=True)
    p.add_argument("--side", type=int, default=64)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--num_instances", type=int, default=6)
    p.add_argument("--ray_batch_size", type=int, default=512)
    p.add_argument("--dtype", type=str, default="bf16", choices=["f32", "bf16"])
    p.add_argument("--renderer", type=str, default="AVR_demo")
    p.add_argument("--video_frames", type=int, default=8)
    opt = p.parse_args(argv)
    device = resolve_device(device)  # the card unless the caller asks, before any work

    train_src, val_src = _sets(opt)
    # a path is what --data names; a mapping goes in as the source itself
    paths = isinstance(train_src, str)
    train_args = [
        "--root_dir", opt.workdir,
        "--loss_mode", "both",
        "--renderer", opt.renderer,
        "--starting_epoch", "0",
        "--sl", str(opt.side),
        "--batch_size", "2",
        "--epochs", str(opt.epochs),
        "--epochs_save", str(opt.epochs),
        "--ray_batch_size", str(opt.ray_batch_size),
        "--samples_per_instance", "8",
        "--steps_print", "5",
        "--steps_val", "20",
        "--norm_type", "group",
        "--dtype", opt.dtype,
    ] + (["--data", train_src, "--val_data", val_src] if paths else [])
    state = cli_train.run(cli_train.build_parser().parse_args(train_args), device=device,
                          train_source=None if paths else train_src,
                          val_source=None if paths else val_src)

    video_args = [
        "--root_dir", opt.workdir,
        "--renderer", opt.renderer,
        "--epoch", str(opt.epochs),
        "--sl", str(opt.side),
        "--norm_type", "group",
        "--data", val_src if paths else "<in memory>",
        "--num_frames", str(opt.video_frames),
        "--radius", "1.3",
        "--out", os.path.join(opt.workdir, "orbit.mp4"),
    ]
    cli_video.run(cli_video.build_parser().parse_args(video_args), device=device,
                  data_source=None if paths else val_src)
    print(f"demo complete; artifacts in {opt.workdir}")
    return state


if __name__ == "__main__":
    main()
