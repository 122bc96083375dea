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
compare only within one such call.  Prints the card's name and power
limit, then one JSON object a reading.

``main(turn, usage)`` is the runner that ``gather_turns.py`` shares: it runs
the snippet ``turn`` in each checkout in turns (``run``, which the turns
scripts' ``--probe`` also takes, once a checkout).
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


def run(snippet: str, checkouts, both_orders: bool = True) -> int:
    """Runs ``snippet`` (Python source, given the checkout as ``sys.argv[1]``)
    in a process of its own in each checkout, in the order given and, with
    ``both_orders``, then in reverse; prints the card's name and power limit
    and each run's last line."""
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    paths = [os.path.abspath(c) for c in checkouts]
    for path in paths + (paths[::-1] if both_orders else []):
        r = subprocess.run([sys.executable, "-c", snippet, path], cwd=path, capture_output=True,
                           text=True)
        if r.returncode:
            print(f"{path}: exit {r.returncode}\n{r.stderr[-4000:]}", file=sys.stderr)
            return 1
        print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


def main(turn: str = _TURN, usage: str = __doc__) -> int:
    """Runs ``turn`` in each checkout of the command line in turns
    (:func:`run`)."""
    if not sys.argv[1:]:
        print(usage, file=sys.stderr)
        return 2
    return run(turn, sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
