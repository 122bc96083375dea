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
output; a digest of its bits beside: equal digests, equal bits), and a
digest of the dgrad's outputs (dx, dz, the cotangent slots, gout and enc,
in that order) beside its time.  Trees compare only within one call.  Prints the card's name and
power limit, then one JSON object a reading.

    python3 chain_turns.py --bins CHECKOUT [CHECKOUT ...]

times instead K1's and K5's binned backward (``chip_smoke.check_gather_bwd``
and ``check_gather_proj_bwd``: 4 x 81,920 points of a 64 x 64 x 512 bf16
map, their checks run first): call ms and device ms by kernel, the bins'
sort among them.

    python3 chain_turns.py --records CHECKOUT [CHECKOUT ...]

times instead one chain call record by record (CUDA events around each
record's launch, in ``chain_plan``'s order), the forward (no stash) and
dgrad at the band chunk, bf16 at d_hidden 1,280 and 2,048 and float32 at
1,920, grouped by kind and epilogue (``gemm/in``, ``gemm/z``,
``gemm/fc0``, ``gemm/fc1``, ``gemm/c0``, ``gemm/gh``, ``gemm/f32``,
``gemm/dz``, ``head``, ``linout``, ``enc``): ms a call, records, the
products' TFLOP/s and the epilogue's bytes a call by group (``EPI_BYTES``,
by dtype), beside the whole call's ms without the events between records.
For float32 it also runs each call in a loop of about three seconds with
the card's SM clock and power draw sampled by ``nvidia-smi``
(``avr_tpu_torch.profiling.wgrad_timing.sustained``), and it prints the
chain kernels' registers, spills and shared memory from the tree's build
log (``ptxas -v``, ``avr_tpu_torch/_build/*.log``).
"""

from __future__ import annotations

import sys

from march_turns import main, run

_TURN = """
import hashlib, json, sys
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
    digest = hashlib.sha256(o.float().cpu().numpy().tobytes()).hexdigest()[:16]
    # the dgrad's outputs, in 256 MB pieces through the host
    h = hashlib.sha256()
    for t in K2._dgrad(a, d, st, gs, wd, cd):
        flat = t.contiguous().view(-1).view(torch.uint8)
        for i in range(0, flat.numel(), 1 << 28):
            h.update(flat[i:i + (1 << 28)].cpu().numpy().tobytes())
    res[f"{str(cd)[6:]} {dh}"] = dict(fwd_ms=f, dgrad_ms=b, rel_err=err, fwd_digest=digest,
                                      dgrad_digest=h.hexdigest()[:16])
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

# one chain call launched record by record (the library's entry point
# wrapped), CUDA events around each record
_RECORDS = """
import collections, ctypes, json, re, sys
from pathlib import Path
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from avr_tpu_torch.ops.kernels import _build, resnetfc as K2
from avr_tpu_torch.profiling.wgrad_timing import sustained
torch.backends.cuda.matmul.allow_tf32 = False
info = _build.load_library()
real_fn = _build.kernel_fn
real = real_fn("avr_resnetfc_chain", [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
EPI = {v: k for k, v in K2.CHAIN_EPI.items()}
KIND = {v: k for k, v in K2.CHAIN_KINDS.items()}
# epilogue bytes an output element by dtype: reads and writes of H, pool,
# the operand written, the mask read
EPI_BYTES = {
    torch.bfloat16: {"in": 4, "z": 10, "fc0": 2, "fc1": 10, "c0": 4, "gh": 12, "f32": 4, "t": 2,
                     "dz": 2},
    torch.float32: {"in": 4, "z": 12, "fc0": 4, "fc1": 12, "c0": 8, "gh": 16, "f32": 4, "t": 4,
                    "dz": 4}}
SIZE = ctypes.sizeof(K2.ChainOp)
timed = []
epi_bytes = EPI_BYTES[torch.bfloat16]


# the chain kernels' ptxas lines: registers, spills, shared memory
def ptxas(log):
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\\w+)", line)
        if m:
            name = m.group(1) if "chain_" in m.group(1) else None
        elif name and ("spill" in line or "Used" in line):
            out.setdefault(name, []).append(" ".join(line.split()))
    return out


def label(r):
    if KIND[r.kind] != "gemm":
        return KIND[r.kind]
    e = EPI[r.epi]
    return "gemm/" + ("dz" if e == "t" and r.nseg > 1 else e)


def by_record(ops, n, dtype, stream):
    base = ops.value
    for i in range(n):
        r = K2.ChainOp.from_address(base + i * SIZE)
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        err = real(ctypes.c_void_p(base + i * SIZE), 1, dtype, stream)
        ev[1].record()
        if err:
            return err
        lb = label(r)
        flop = 2.0 * r.M * r.Ncols * r.K * r.nseg if lb.startswith("gemm") else 0.0
        nbytes = epi_bytes[lb[5:]] * r.M * r.Ncols if lb.startswith("gemm") else 0
        timed.append((lb, ev, flop, nbytes))
    return 0


def split(call, iters=3):
    call()
    torch.cuda.synchronize()
    whole = cs.time_ms(call, iters=iters, warmup=0)
    _build.kernel_fn = lambda name, argtypes: by_record if name == "avr_resnetfc_chain" else \\
        real_fn(name, argtypes)
    try:
        timed.clear()
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    finally:
        _build.kernel_fn = real_fn
    g = collections.defaultdict(lambda: dict(ms=0.0, records=0, flop=0.0, epi_bytes=0))
    for lb, ev, flop, nbytes in timed:
        row = g[lb]
        row["ms"] += ev[0].elapsed_time(ev[1]) / iters
        row["records"] += 1
        row["flop"] += flop / iters
        row["epi_bytes"] += nbytes // iters
    for row in g.values():
        row["records"] //= iters
        row["tflops"] = row["flop"] / row["ms"] / 1e9 if row["flop"] else None
    return dict(call_ms=whole, records_ms=sum(r["ms"] for r in g.values()), by=dict(g))


gen = torch.Generator(device="cuda").manual_seed(3)
res = {"checkout": sys.argv[1]}
log = Path(info["path"]).with_suffix(".log")
res["ptxas"] = ptxas(log.read_text()) if log.exists() else "no build log"
for cd, dh in ((torch.bfloat16, 1280), (torch.bfloat16, 2048), (torch.float32, 1920)):
    epi_bytes = EPI_BYTES[cd]
    w = cs.decoder_weights(gen, dh=dh, dl=1152)
    x, z, g = cs.wide_inputs(gen, cs.BAND, 1, 1152, cs.CODE, cd)
    a = K2._prepare(x, z, w, cs.CODE, cd)
    d = K2._dims(a, 5, 3, True)
    st = K2._forward(a, d, cd, True)[1]
    gs, wd, _ = K2._bwd_operands(a, d, g, K2.NAME_DGRAD)
    fwd, dgrad = lambda: K2._forward(a, d, cd, False), lambda: K2._dgrad(a, d, st, gs, wd, cd)
    row = dict(fwd=split(fwd), dgrad=split(dgrad))
    if cd == torch.float32:
        fields = "clocks.sm,clocks.mem,power.draw,temperature.gpu"
        row["fwd_sustained"] = sustained(fwd, 3.0, fields)
        row["dgrad_sustained"] = sustained(dgrad, 3.0, fields)
    res[f"{str(cd)[6:]} {dh}"] = row
    del a, st, gs, wd, x, z, g
    torch.cuda.empty_cache()
print(json.dumps(res), flush=True)
"""

if __name__ == "__main__":
    if sys.argv[1:2] == ["--bins"]:
        sys.exit(run(_BINS, sys.argv[2:]) if sys.argv[2:] else 2)
    if sys.argv[1:2] == ["--records"]:
        sys.exit(run(_RECORDS, sys.argv[2:]) if sys.argv[2:] else 2)
    sys.exit(main(_TURN, __doc__))
