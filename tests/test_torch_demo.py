"""The port's demo (``python -m avr_tpu_torch.examples.train_synthetic``,
the port of ``examples/train_synthetic.py``) on the CPU: it trains the
full-width adaptive renderer for one step on 16x16 synthetic scenes,
checkpoints and renders a 2-frame orbit video (mp4, or the frames in an
``.npz`` where imageio has no mp4 writer), with ``h5py`` blocked (the sets
stay in memory and go through ``cli.train.run``'s sources) and with it (the
sets written as HDF5 files under ``--workdir/data``).  Nothing launches a
kernel.
"""

import os
import sys

import numpy as np
import pytest
import torch

from avr_tpu_torch.ops.kernels import _build

torch.set_num_threads(2)


@pytest.mark.parametrize("h5", ["blocked", "present"])
def test_demo_runs_on_the_cpu(h5, tmp_path, monkeypatch, capsys):
    from avr_tpu_torch.examples import train_synthetic

    if h5 == "blocked":
        monkeypatch.setitem(sys.modules, "h5py", None)
    else:
        pytest.importorskip("h5py")
    _build.reset_launches()
    state = train_synthetic.main(["--workdir", str(tmp_path), "--side", "16", "--epochs", "1",
                                  "--num_instances", "2", "--ray_batch_size", "32",
                                  "--video_frames", "2", "--dtype", "f32"], device="cpu")
    out = capsys.readouterr().out
    assert int(state.step) == 1 and "demo complete" in out and not _build.launches
    assert ("h5py unavailable" in out) == (h5 == "blocked")
    assert os.path.isdir(tmp_path / "data") == (h5 == "present")
    # one step (2 scenes, SB 2): no validation at steps_val 20, so no _best
    assert os.listdir(tmp_path / "checkpoints" / "experiments") == ["AVR_demo_epoch1"]
    video = [f for f in os.listdir(tmp_path) if f.startswith("orbit")]
    assert video in (["orbit.mp4"], ["orbit.npz"])
    if video == ["orbit.npz"]:
        frames = np.load(tmp_path / "orbit.npz")["frames"]
        assert frames.shape == (2, 16, 16, 3) and frames.dtype == np.uint8
