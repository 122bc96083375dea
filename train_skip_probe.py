#!/usr/bin/env python3
"""Probe of the updates the optimizer skips in the adaptive train step (one
NVIDIA Hopper GPU).

    python3 train_skip_probe.py [SECONDS] [--out=DIR]

Repeats ``chip_smoke.py``'s adaptive train phase (the full-width
``conf/default_mv.conf`` model from seed 0, bf16, per-ray keys ``(0, i)``,
12 steps) from fresh weights, for SECONDS (default 240) on each of two
batches: ``bench.py``'s (``bench``: the target camera is the source camera,
so every target ray starts at the source camera's centre), then the same
batch with the target camera moved 0.5 along its viewing direction
(``moved``).  For every update the optimizer skips (a non-finite gradient)
it redoes the step on the same weights and batch and prints one JSON line:
the number of non-finite parameter gradients through the kernels and
through the plain versions on the card; for each projection into the
source view, the points with a camera depth of exactly 0 and the least
nonzero |depth|; and, through the kernels, the backward nodes where a
non-finite value first appears (finite incoming gradients, non-finite
outgoing ones, in the order autograd ran them; ``chip_smoke.py``'s
``first_nonfinite``), whether each is a kernel's, and the largest incoming
gradient there.  One line a batch counts runs, steps and skips.
Everything also goes to ``DIR/train_skip_probe.jsonl`` (default
``traces/``).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import torch

import chip_smoke as cs
from avr_tpu_torch.models.pixelnerf import PixelNeRFNet
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.training import LossParams
from avr_tpu_torch.training.step import loss_and_grads
from avr_tpu_torch.utils.geometry import get_world_rays

LOSS = LossParams(loss_mode="both")
STEPS = 12
MOVE = 0.5


@contextlib.contextmanager
def camera_depths(seen):
    """Inside: every projection into the source view (``PixelNeRFNet.grid``)
    appends to ``seen`` its point count, the points at a camera depth of
    exactly 0 and the least nonzero |depth|."""
    grid = PixelNeRFNet.grid

    def recorded(self, cond, xyz_rot, t):
        z = (xyz_rot + t[:, :, None, :])[..., 2].detach().abs()
        nonzero = z[z > 0]
        seen.append({"points": z.numel(), "zero": int((z == 0).sum()),
                     "least_nonzero": float(nonzero.min()) if nonzero.numel() else None})
        return grid(self, cond, xyz_rot, t)

    PixelNeRFNet.grid = recorded
    try:
        yield
    finally:
        PixelNeRFNet.grid = grid


def redo(model, batch, key, plain):
    """One step's gradients on the model's current weights (the running
    BatchNorm statistics restored after): the count of non-finite ones, the
    loss, the projections' camera depths and, through the kernels, where
    the first non-finite value appeared."""
    stats = {k: v.clone() for k, v in model.named_buffers()}
    found, seen = [], []
    with cs.plain_kernels() if plain else cs.first_nonfinite(found), camera_depths(seen):
        loss, g = loss_and_grads(model, dict(model.named_parameters()), LOSS, *batch, key)
    with torch.no_grad():
        for k, v in model.named_buffers():
            v.copy_(stats[k])
    bad = [k for k, v in g.items() if not bool(torch.isfinite(v).all())]
    out = {"loss": float(loss), "nonfinite": len(bad), "projections": seen}
    return out if plain else {**out, "first_nonfinite_nodes": found}


def moved(batch):
    """``batch`` with the target camera moved MOVE along its viewing
    direction (the direction of its central ray)."""
    *head, model_input, gt = batch
    c2w = model_input["cam2world"]
    centre = torch.full_like(model_input["x_pix"][:, :1], 0.5)
    _, rd = get_world_rays(centre, model_input["intrinsics"], c2w[:, :1])
    c2w = c2w.clone()
    c2w[..., :3, 3] += MOVE * rd
    return (*head, {**model_input, "cam2world": c2w}, gt)


def probe(name, batch, seconds, out):
    """Fresh weights, STEPS steps, again, for ``seconds``; a line for each
    skipped update and one for the batch."""
    t0 = time.perf_counter()
    runs = steps = skips = 0
    while time.perf_counter() - t0 < seconds:
        model = cs.path_model("adaptive", torch.bfloat16, cs.DEV)
        opt = cs.make_optimizer(1e-4)
        state = cs.create_train_state(model, opt)
        step = cs.make_train_step(model, opt, LOSS)
        for i in range(STEPS):
            state, metrics = step(state, *batch, (0, i))
            steps += 1
            if int(metrics["notfinite"]) > 0:  # skipped: the weights are the step's own
                out({"batch": name, "run": runs, "step": i,
                     "kernels": redo(model, batch, (0, i), plain=False),
                     "plain": redo(model, batch, (0, i), plain=True)})
                skips += 1
                break  # start again from fresh weights
        runs += 1
    out({"batch": name, "runs": runs, "steps": steps, "skips": skips,
         "seconds": time.perf_counter() - t0})


def main() -> int:
    if not torch.cuda.is_available():
        print("train_skip_probe: no CUDA device", file=sys.stderr)
        return 1
    args = [a for a in sys.argv[1:] if not a.startswith("--out=")]
    seconds = float(args[0]) if args else 240.0
    out_dir = next((a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--out=")),
                   "traces")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    os.makedirs(out_dir, exist_ok=True)
    batch = cs.train_batch(cs.DEV)
    with open(os.path.join(out_dir, "train_skip_probe.jsonl"), "w") as f:
        def out(line):
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")

        probe("bench", batch, seconds, out)
        probe("moved", moved(batch), seconds, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
