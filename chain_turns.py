"""K2's chain (``avr_tpu_torch/csrc/resnetfc_chain.cu``) in checkouts of the
repo, in turns.

    python3 chain_turns.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT is a tree of the repo (a ``git archive`` of a commit, or a
copy with a trial of the chain's kernels) with its own ``chip_smoke.py``.
In each, in the order given and then in reverse, a process of its own
builds that tree's kernels and times the chain at the band chunk (81,920
points, NS 1, a latent of 1,152, 64 encoded lanes): the forward (no stash,
as served) and the dgrad on the stash forward's activations, bf16 at
d_hidden 1,280 and 2,048 and float32 at 1,920, by CUDA events, each
forward held to the plain version first (its error relative to the largest
output).  Trees compare only within one call.  Prints the card's name and
power limit, then one JSON object a reading.

    python3 chain_turns.py --bins CHECKOUT [CHECKOUT ...]

times instead K1's and K5's binned backward (``chip_smoke.check_gather_bwd``
and ``check_gather_proj_bwd``: 4 x 81,920 points of a 64 x 64 x 512 bf16
map, their checks run first): call ms and device ms by kernel, the bins'
sort among them.
"""

from __future__ import annotations

import sys

from march_turns import main, run

_TURN = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from avr_tpu_torch.ops.kernels import _build, resnetfc as K2
torch.backends.cuda.matmul.allow_tf32 = False
_build.load_library()
gen = torch.Generator(device="cuda").manual_seed(3)
kw = dict(n_blocks=5, n_lin_z=3, activate_out=True)
res = {"checkout": sys.argv[1]}
for cd, dh in ((torch.bfloat16, 1280), (torch.bfloat16, 2048), (torch.float32, 1920)):
    w = cs.decoder_weights(gen, dh=dh, dl=1152)
    x, z, g = cs.wide_inputs(gen, cs.BAND, 1, 1152, cs.CODE, cd)
    a = K2._prepare(x, z, w, cs.CODE, cd)
    d = K2._dims(a, 5, 3, True)
    o = K2._forward(a, d, cd, False)[0]
    want = cs.resnetfc_plain(x, z, w, compute_dtype=cd, code=cs.CODE, **kw)
    err = cs.max_err(o, want) / max(1.0, float(want.abs().max()))
    it = 3 if cd == torch.bfloat16 else 1
    f = cs.time_ms(lambda: K2._forward(a, d, cd, False), iters=it, warmup=1)
    st = K2._forward(a, d, cd, True)[1]
    gs, wd, _ = K2._bwd_operands(a, d, g, K2.NAME_DGRAD)
    b = cs.time_ms(lambda: K2._dgrad(a, d, st, gs, wd, cd), iters=it, warmup=1)
    res[f"{str(cd)[6:]} {dh}"] = dict(fwd_ms=f, dgrad_ms=b, rel_err=err)
    del a, st, gs, wd, x, z, g, want
    torch.cuda.empty_cache()
print(json.dumps(res), flush=True)
"""

_BINS = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from avr_tpu_torch.ops.kernels import _build
_build.load_library()
res = {"checkout": sys.argv[1]}
gen = torch.Generator(device=cs.DEV).manual_seed(2)
for name, check in (("K1", cs.check_gather_bwd), ("K5", cs.check_gather_proj_bwd)):
    r = check(gen)
    res[name] = {k: r[k] for k in ("ms", "device_ms", "device_ms_by_kernel") if k in r}
print(json.dumps(res), flush=True)
"""

if __name__ == "__main__":
    if sys.argv[1:2] == ["--bins"]:
        sys.exit(run(_BINS, sys.argv[2:]) if sys.argv[2:] else 2)
    sys.exit(main(_TURN, __doc__))
