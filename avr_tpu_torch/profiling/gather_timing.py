"""The host's ray gather, timed per step: numpy against the native (C++) gather.

    python -m avr_tpu_torch.profiling.gather_timing [--out=DIR] [--reps=N]

Every step of ``fit``'s host path assembles its rays with
``data.sampling.gather_rays`` (through ``training.loop.assemble_step_inputs``)
from a collated batch of 4 scenes x 50 views of 128^2 pixels, the shape of
the CLI's default run.  This times that call at 1,024 and 4,096 rays a
scene (the CLI's ``--ray_batch_size`` in ``chip_smoke.py``'s runs) for:

- ``numpy``: ``gather_rays(impl="numpy")``;
- ``native``: ``gather_rays(impl="native")``, the C++ gather on the
  calling thread (its default);
- ``native_threads``: the index sampling and the C++ gather with a thread
  started for each scene.

Each call gets a fresh copy of the batch (as each step's collation makes a
new one), made outside the timed span; the variants take turns, and each
reading is the median of ``--reps`` calls (default 30).  The library's
build is timed once, before the readings.  It is a host measurement: no
kernel runs on the card, whose name and power limit are printed beside it
to say which machine's host it was.  Prints one JSON object a reading and
writes all of them to ``DIR/gather_timing.json`` (default ``traces/``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

from avr_tpu_torch.data import native
from avr_tpu_torch.data.sampling import gather_rays, sample_ray_indices

SB, NV, SIDE = 4, 50, 128
RAYS = (1024, 4096)


def make_batch(seed: int = 0) -> dict:
    """A collated ``(SB, NV, ...)`` batch of random values at the CLI's shape."""
    rng = np.random.default_rng(seed)
    sl2 = SIDE * SIDE
    return {
        "images": rng.uniform(-1, 1, (SB, NV, sl2, 3)).astype(np.float32),
        "x_pix": rng.uniform(0, SIDE, (SB, NV, sl2, 2)).astype(np.float32),
        "cam2world": rng.standard_normal((SB, NV, 4, 4)).astype(np.float32),
        "intrinsics": rng.standard_normal((SB, NV, 3, 3)).astype(np.float32),
    }


def _native_threads(rng, batch, rays):
    idx = sample_ray_indices(rng, batch, rays)
    return native.gather_rays_native(batch, idx.astype(np.int64), num_threads=SB)


VARIANTS = {
    "numpy": lambda rng, batch, rays: gather_rays(rng, batch, rays, impl="numpy"),
    "native": lambda rng, batch, rays: gather_rays(rng, batch, rays, impl="native"),
    "native_threads": _native_threads,
}


def time_variants(batch: dict, rays: int, reps: int) -> dict:
    """Median ms a call of each variant, the variants in turns."""
    times = {name: [] for name in VARIANTS}
    for rep in range(reps):
        for name, fn in VARIANTS.items():
            fresh = {k: v.copy() for k, v in batch.items()}
            rng = np.random.default_rng(rep)
            t0 = time.perf_counter()
            fn(rng, fresh, rays)
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: float(np.median(ts)) for name, ts in times.items()}


def main() -> int:
    args = dict(a[2:].split("=", 1) for a in sys.argv[1:] if a.startswith("--") and "=" in a)
    out_dir, reps = args.get("out", "traces"), int(args.get("reps", 30))
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True).stdout
    except FileNotFoundError:
        card = ""
    card = card.strip() or "no card"
    t0 = time.perf_counter()
    native.load_native()
    build_s = time.perf_counter() - t0
    batch = make_batch()
    for rays in RAYS:  # the variants agree before they are timed
        want = VARIANTS["numpy"](np.random.default_rng(1), batch, rays)
        for name in ("native", "native_threads"):
            got = VARIANTS[name](np.random.default_rng(1), batch, rays)
            for a, b in zip((*want[0].values(), want[1]), (*got[0].values(), got[1])):
                np.testing.assert_array_equal(a, b)
    readings = []
    for rays in RAYS:
        ms = time_variants(batch, rays, reps)
        readings.append({"scenes": SB, "rays_a_scene": rays, "views": NV, "side": SIDE,
                         "reps": reps, "ms": ms, "cpu_count": os.cpu_count(),
                         "library_build_s": build_s, "card": card})
        print(json.dumps(readings[-1]), flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "gather_timing.json"), "w") as f:
        json.dump(readings, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
