"""K3's bf16 forward call and the served frames that march, in checkouts of
the repo, in turns.

    python3 march_turns.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT is a tree of the repo (a ``git archive`` of a commit) with its
own ``chip_smoke.py``.  In each, in the order given and then in reverse, a
process of its own builds that tree's kernels, serves three frames of the
Raymarcher and of the adaptive renderer (``chip_smoke.run_slice``) and
times K3's forward at ``chip_smoke.py``'s serving inputs (4,096 rays x 10
steps, bf16): the device time of its march kernels (``torch.profiler``),
the call back to back (CUDA events) and its host time (wall time until it
returns, on an idle card).  Host-bound paths drift between runs, so trees
compare only within one such call.  Prints one JSON object a reading.
"""

from __future__ import annotations

import os
import subprocess
import sys

# run inside a checkout: its own chip_smoke and kernels, whatever its commit
_TURN = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from avr_tpu_torch.ops.kernels import _build
_build.load_library()
res = {"checkout": sys.argv[1]}
for path in ("Raymarcher", "adaptive"):
    r, _ = cs.run_slice(path)
    res[path + "_frame_ms"] = [r["ms_per_frame"], min(r["frame_ms"]), max(r["frame_ms"])]
inp = cs.march_inputs(torch.Generator(device=cs.DEV).manual_seed(0), 1)
call = lambda: cs.fused_lstm_march(**inp, steps=cs.STEPS, compute_dtype=torch.bfloat16)
res["k3_device_ms"] = cs.kernel_device_ms(call, ("lstm_march",))["lstm_march"]
res["k3_call_ms"], res["k3_host_ms"] = cs.time_ms(call), cs.host_ms(call)
print(json.dumps(res), flush=True)
"""


def main() -> int:
    checkouts = [os.path.abspath(a) for a in sys.argv[1:]]
    if not checkouts:
        print(__doc__, file=sys.stderr)
        return 2
    for path in checkouts + checkouts[::-1]:
        r = subprocess.run([sys.executable, "-c", _TURN, path], cwd=path, capture_output=True,
                           text=True)
        if r.returncode:
            print(f"{path}: exit {r.returncode}\n{r.stderr[-4000:]}", file=sys.stderr)
            return 1
        print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
