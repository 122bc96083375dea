"""K1's and K5's forward, and the served frames that gather, in checkouts of
the repo, in turns.

    python3 gather_turns.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT is a tree of the repo (a ``git archive`` of a commit) with its
own ``chip_smoke.py``.  In each, in the order given and then in reverse, a
process of its own (``march_turns.main``, the runner both scripts share)
builds that tree's kernels and, from that tree's ``chip_smoke``:

- times K1's forward (``gather_bilinear``) and K5's
  (``gather_bilinear_projected``) on a 64 x 64 x 512 bf16 latent at the
  serving band's 81,920 points, at the same points three ways: ray-shaped
  (``proj_inputs``' band points; K1 at their projection), uniform grid
  coordinates in [-1.1, 1.1] (K5 at their unprojection at camera depths
  0.8 to 1.8), and every point at one pixel (K5: one world point), where
  every tap hits L1; and at a served chunk's coarse query (4,096 points,
  one a ray).  Each reading: the device time of the call's kernel
  (``chip_smoke.kernel_device_ms``), the call back to back (CUDA events,
  the measure of K1's ``ms`` in ``chip_smoke.py``'s kernels line), whether
  it equals the plain version bit for bit, and at the band a loop of about
  a second with the SM clock and power that ``nvidia-smi`` read;
- the floor for the band's output bytes: ``Tensor.fill_`` of a tensor of
  its size (84 MB, a store-only kernel);
- the call sites in each gather forward kernel's SASS (``cuobjdump``, where
  the toolkit has it): a division routine shows as one;
- serves three frames of each renderer path that gathers (the adaptive
  renderer, its fused path, the VR; ``chip_smoke.run_slice``): ms a frame
  (median and range), and the device time of one frame's gather forward
  kernels.

Every tree gets the same inputs (the generators are seeded here).  The SM
clock moves under the card's power cap between runs, so trees compare only
within one such call.  Prints the card's name and power limit, then one
JSON object a reading.
"""

from __future__ import annotations

import sys

import march_turns

# run inside a checkout: its own chip_smoke and kernels, whatever its commit
_TURN = r"""
import json, os, re, shutil, subprocess, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.profiling.wgrad_timing import SMI_FIELDS, sustained

# the gather forward kernels of any tree: the two before the tiled one, and it
FWD_NAMES = ("gather_bilinear_kernel", "gather_projected_kernel", "gather_fwd_tile_kernel")


def device_ms(fn, names=FWD_NAMES, iters=20):
    return sum(cs.kernel_device_ms(fn, names, iters).values())


info = _build.load_library()
res = {"checkout": sys.argv[1]}
gen = torch.Generator(device=cs.DEV).manual_seed(11)
feat, pts, proj = cs.proj_inputs(gen, 1, 1, torch.bfloat16, cs.BAND)
grid = cs.project_packed(proj, pts).contiguous()
grid_u = (torch.rand(1, cs.BAND, 2, generator=gen, device=cs.DEV) * 2.2 - 1.1).contiguous()
pts_u = cs.unproject(proj, grid_u, -0.8 - torch.rand(1, cs.BAND, generator=gen, device=cs.DEV))
grid_1 = torch.tensor([0.1234, -0.2345], device=cs.DEV).expand(1, cs.BAND, 2).contiguous()
pts_1 = pts[:, :1].expand(1, cs.BAND, 3).contiguous()
feat_c, pts_c, proj_c = cs.proj_inputs(gen, 1, 1, torch.bfloat16, cs.CHUNK)
grid_c = cs.project_packed(proj_c, pts_c).contiguous()
K1 = (cs.gather_bilinear, cs.gather_bilinear_plain)
K5 = (cs.gather_bilinear_projected, cs.gather_bilinear_projected_plain)
calls = {"K1 ray": (K1, (feat, grid)), "K1 uniform": (K1, (feat, grid_u)),
         "K1 one pixel": (K1, (feat, grid_1)), "K1 coarse": (K1, (feat_c, grid_c)),
         "K5 ray": (K5, (feat, pts, proj)), "K5 uniform": (K5, (feat, pts_u, proj)),
         "K5 one point": (K5, (feat, pts_1, proj)), "K5 coarse": (K5, (feat_c, pts_c, proj_c))}
for name, ((fn, plain), args) in calls.items():
    run = lambda: fn(*args)
    res[name] = dict(device_ms=device_ms(run), call_ms=cs.time_ms(run, iters=100),
                     bitwise=bool(torch.equal(run(), plain(*args))))
    if "coarse" not in name:
        loop = sustained(run, 1.0, SMI_FIELDS)
        res[name].update(loop_ms=loop["ms"], sm_mhz=loop["clocks.sm"],
                         power_w=loop["power.draw"])
out = torch.empty(1, cs.BAND, cs.C, dtype=torch.bfloat16, device=cs.DEV)
res["store floor"] = dict(device_ms=device_ms(lambda: out.fill_(1.0), ("",)))
tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
if os.path.exists(tool):
    sass = subprocess.run([tool, "-sass", info["path"]], capture_output=True, text=True).stdout
    res["sass call sites"] = {
        f.split()[2]: sum("CALL" in line for line in f.splitlines())
        for f in re.split(r"\n\s*(?=Function : )", sass)
        if f.startswith("Function : ") and any(n in f.split()[2] for n in FWD_NAMES)}
del feat, pts, proj, grid, grid_u, pts_u, grid_1, pts_1, out
for path in ("adaptive", "adaptive_fused", "VR"):
    r, render = cs.run_slice(path)
    res[path] = dict(frame_ms=[r["ms_per_frame"], min(r["frame_ms"]), max(r["frame_ms"])],
                     gather_fwd_device_ms=device_ms(lambda: render(0), iters=1))
    del render
print(json.dumps(res), flush=True)
"""


if __name__ == "__main__":
    sys.exit(march_turns.main(_TURN, __doc__))
