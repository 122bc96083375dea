"""K2's wide kernels (the forward and the dgrad past d_hidden 512), in
checkouts of the repo, in turns, and with ``--probe`` (the bf16 pair) or
``--probe-f32`` (the float32 pair) what bounds them; with ``--slice`` the
float32 slice of ``chip_smoke.py --wide`` profiled; with
``--probe-mma-sync`` and ``--sweep-pieces`` the bf16 forward at d_hidden
512 and below past 512 latent or encoded lanes (``resnetfc_kernel``, the
wgmma forward's pieces).

    python3 wide_turns.py CHECKOUT [CHECKOUT ...]
    python3 wide_turns.py --probe CHECKOUT [CHECKOUT ...]
    python3 wide_turns.py --probe-f32 CHECKOUT [CHECKOUT ...]
    python3 wide_turns.py --probe-mma-sync CHECKOUT [CHECKOUT ...]
    python3 wide_turns.py --slice CHECKOUT [CHECKOUT ...]
    python3 wide_turns.py --sweep CHECKOUT
    python3 wide_turns.py --sweep-pieces CHECKOUT

Each CHECKOUT is a tree of the repo (a ``git archive`` of a commit) with its
own ``chip_smoke.py``.  In each, in the order given and then in reverse, a
process of its own (``march_turns.main``, the runner the turns scripts
share) builds that tree's kernels and, from that tree's ``chip_smoke``, at
the band chunk of ``chip_smoke.py --wide`` (81,920 points, NS 1, d_hidden
1,024, a latent of 1,152, 6 frequencies):

- times K2's bf16 wide forward (``resnetfc._forward`` without the stash, as
  served) and its bf16 wide dgrad (``resnetfc._dgrad`` on the stash the
  forward wrote): device ms of the wide kernels (``torch.profiler``), ms
  back to back (CUDA events), a digest of the outputs (exact integer sums of
  their bits, taken on the card), the largest difference of the forward
  from the plain version, the launch counters the calls moved, and for each
  a loop of about a second with the SM clock and power ``nvidia-smi`` read;
- times the float32 wide forward and dgrad the same way (on a tree that
  has them, the float32 cluster kernels: their digests equal the first
  version's), and the narrow bf16 K2 forward and dgrad at d_hidden 512 (the
  band's 81,920 points, the shipped decoder, which must not move): device
  ms and digests.

``--probe`` runs once in each checkout, not in turns: the tree's bf16 wide
forward and dgrad at the band beside probe kernels compiled from this file
into a temporary directory (not into the kernel library): (a) the decoder's
bf16 weights at the band's shape (wi, wz, w0, w1: 28.2 MB) streamed once a
32-point tile (2,560 CTAs, one a streaming multiprocessor as the first
version runs) through registers by ``__ldg``, 8 loads of 16 bytes a lane in
flight in the first version's pattern (a warp's 64 weight rows, a lane's
16 bytes of 8 of them a step); (b) the same bytes once a CTA by bulk copies
(``cp.async.bulk``) through a ring of shared stages that eight warps wait
on and release (3 stages of 32 KB, 4 of 16 KB); (c) the same through the
same rings in clusters of 2 and 4 CTAs, each stage's pieces issued by the
cluster's CTAs and multicast to all (``.multicast::cluster``), so L2 reads
each byte once a cluster, a stage reissued when every CTA's consumers
released it: their arrivals a release at cluster scope, at the default
(CTA) scope as CUTLASS's cluster barriers arrive, or one arrival a CTA
after a named barrier: the floors of the first version's weight feed and
of the redesign's; and (d)
the first version's cycles by phase: a copy of the checkout's port, its
``resnetfc_wide.cu`` stamped (``STAMPS``: ``clock64()`` sums a warp, kept by
one CTA of a later wave, 1,000 of the band's 2,560), built and run in a
directory of its own.  The phases of the bf16 ``kloop`` (a warp's 32-wide k
step of a 64-column group) are the A operand's shared loads and conversion
(the trunk relu'd and rounded where it is the operand), the wait for the
eight 16-byte B loads from L2, and the 32 ``mma.sync``; each product's
epilogue is a fourth; the stamps serialise the three phases of a step and
cost part of the kernel's time (its stamped time is printed beside).  A
tree whose kernel lacks a stamp site (a redesigned one) prints
``{"stamps": "source does not match"}`` and is not run.

``--probe-f32`` does the same for the float32 pair: the tree's float32 wide
forward and dgrad at the band, then the 56.4 MB of float32 weights
streamed once a 16-point tile (5,120 CTAs, one an SM) by ``__ldg`` in
``kloop<float>``'s pattern (16 warps, a lane's two 16-byte loads of each of
four k rows in flight), by bulk copies through 3 x 30 KB (the room beside
the first version's trunk and tile) and 3 x 32 KB rings, the same
multicast over 2- and 4-CTA clusters, and the first 40 MB alone (inside
L2), each with its L2 read rate (above HBM's 3.35 TB/s the reads cannot all
come from HBM); then the first version's float32 cycles by phase
(``STAMPS_F32``: its 16 warps) and, where the tree has them, the float32
cluster kernels' (``STAMPS_WF``: their four consumer warps).

``--probe-mma-sync`` runs once in each checkout: at the band chunk
(81,920 points, NS 1, d_hidden 512) with latents of 512, 640 and 1,024
lanes, ``resnetfc_kernel`` (``csrc/resnetfc.cu``, its C entry called
directly) beside the wgmma forward where the tree routes the shape there
(device ms; at 512 both in turns with ``chip_smoke.alternate``), the weight
bytes the products stream and what 32- and 64-point tiles read from L2;
the floors of the two weight feeds at latent 640 (``__ldg`` in
``resnetfc_kernel``'s pattern once a 32-point tile, one CTA an SM; bulk
copies through the wgmma forward's 4 x 32 KB ring once a 64-point tile);
then ``resnetfc_kernel``'s cycles by phase at latent 640 from a stamped
copy (``STAMPS_MMA``) and, in a tree whose wgmma forward takes pieces,
that forward's at 512 and 640 (``STAMPS_PIECES``).

``--sweep-pieces`` runs once in a checkout whose wgmma forward takes
pieces: the snippet's ``SHAPES`` at NS 1 and 2, both bf16 forwards held
to the plain version and timed in turns beside the cuBLAS chain and the
bound (what ``forward_route`` routes by), then phase 9's
``global_coarse_only`` frame profiled on either route in turns.

``--sweep`` runs once in a checkout that has the float32 cluster kernels:
their forward and dgrad against the first version (the routes forced to
each, in turns: cluster, first, first, cluster; CUDA events) at the band
chunk with the slice's latent of 1,152 lanes, d_hidden 576 to 1,024: what
``ops/kernels/resnetfc.py wide_f32_fits`` routes by.

``--slice`` runs in each checkout in turns: the d_hidden 1,024 model of
``chip_smoke.py`` WIDE_CONF in float32, a served frame and a train step on
the stash backward, each once under ``torch.profiler`` after a warm-up call
(wall ms, device busy ms and share, the largest kernels, the wide launches).

Every tree gets the same inputs (the generators are seeded here).  The SM
clock moves under the card's power cap between runs, so trees compare only
within one such call.  Prints the card's name and power limit, then one
JSON object a reading.
"""

from __future__ import annotations

import json
import os
import sys

import march_turns

# run inside a checkout: its own chip_smoke and kernels, whatever its commit
_TURN = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.ops.kernels import resnetfc as K2
from avr_tpu_torch.profiling.wgrad_timing import SMI_FIELDS, sustained

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
WIDE = ("resnetfc_wide",)  # every wide kernel of either tree
NARROW_FWD = ("resnetfc_fwd_wgmma_kernel",)
NARROW_DGRAD = ("resnetfc_dgrad_walk_kernel", "resnetfc_dgrad_tail_kernel")


def digest_dev(ts, chunk=1 << 26):
    import hashlib
    h = hashlib.sha256()
    for t in ts:
        bits = t.detach().contiguous().view(-1)
        bits = bits.view(torch.int16 if bits.element_size() == 2 else torch.int32)
        s1 = s2 = 0
        for i in range(0, bits.numel(), chunk):
            b = bits[i:i + chunk].to(torch.int64)
            w = torch.arange(i, i + b.numel(), device=b.device, dtype=torch.int64) % 65521
            s1 += int(b.sum())
            s2 += int((b * w).sum())
        h.update(f"{t.shape} {s1} {s2}".encode())
    return h.hexdigest()[:16]


def device_ms(fn, names, iters=5):
    return sum(cs.kernel_device_ms(fn, names, iters).values())


def loop(fn):
    r = sustained(fn, 1.0, SMI_FIELDS)
    return dict(loop_ms=r["ms"], sm_mhz=r["clocks.sm"], power_w=r["power.draw"])


def moved(fn):
    before = dict(_build.launches)
    fn()
    torch.cuda.synchronize()
    return {k: v - before.get(k, 0) for k, v in _build.launches.items() if v != before.get(k, 0)}


_build.load_library()
res = {"checkout": sys.argv[1]}
kw = dict(n_blocks=5, n_lin_z=3, activate_out=True)
for cd, iters in ((torch.bfloat16, 5), (torch.float32, 2)):
    kind = str(cd)[6:]
    gen = torch.Generator(device=cs.DEV).manual_seed(21)
    w = cs.decoder_weights(gen, dl=cs.WIDE_DL, dh=cs.WIDE_DH)
    x, z, g = cs.wide_inputs(gen, cs.BAND, 1, cs.WIDE_DL, cs.CODE, cd)
    args = K2._prepare(x, z, w, cs.CODE, cd)
    dims = K2._dims(args, 5, 3, True)
    fwd = lambda: K2._forward(args, dims, cd, False)
    out = fwd()[0]
    want = cs.resnetfc_plain(x, z, w, compute_dtype=cd, code=cs.CODE, **kw)
    res[f"wide fwd {kind}"] = dict(device_ms=device_ms(fwd, WIDE, iters),
                                   call_ms=cs.time_ms(fwd, iters=iters, warmup=1),
                                   max_abs_err=cs.max_err(out, want), digest=digest_dev([out]),
                                   launches=moved(fwd), **loop(fwd))
    st = K2._forward(args, dims, cd, True)[1]
    gs, wd, _ = K2._bwd_operands(args, dims, g, K2.NAME_DGRAD)
    dgrad = lambda: K2._dgrad(args, dims, st, gs, wd, cd)
    res[f"wide dgrad {kind}"] = dict(device_ms=device_ms(dgrad, WIDE, iters),
                                     call_ms=cs.time_ms(dgrad, iters=iters, warmup=1),
                                     digest=digest_dev(list(dgrad()) + [st]),
                                     launches=moved(dgrad), **loop(dgrad))
    del w, x, z, g, args, st, gs, wd, out, want
    torch.cuda.empty_cache()
# the shipped bf16 decoder (d_hidden 512) at the band: the narrow kernels
gen = torch.Generator(device=cs.DEV).manual_seed(22)
w = cs.decoder_weights(gen)
x, z, g = cs.wide_inputs(gen, cs.BAND, 1, cs.C, cs.CODE, torch.bfloat16)
args = K2._prepare(x, z, w, cs.CODE, torch.bfloat16)
dims = K2._dims(args, 5, 3, True)
fwd = lambda: K2._forward(args, dims, torch.bfloat16, False)
res["narrow fwd bf16"] = dict(device_ms=device_ms(fwd, NARROW_FWD, 10),
                              digest=digest_dev([fwd()[0]]), launches=moved(fwd))
st = K2._forward(args, dims, torch.bfloat16, True)[1]
gs, wd, _ = K2._bwd_operands(args, dims, g, K2.NAME_DGRAD)
dgrad = lambda: K2._dgrad(args, dims, st, gs, wd, torch.bfloat16)
res["narrow dgrad bf16"] = dict(device_ms=device_ms(dgrad, NARROW_DGRAD, 10),
                                digest=digest_dev(list(dgrad())), launches=moved(dgrad))
print(json.dumps(res), flush=True)
"""

# --slice, run in a checkout: phase 11's float32 slice (chip_smoke.py
# WIDE_CONF: conf/default_mv.conf's model at d_hidden 1,024 with the 5-stage
# and global encoders) profiled: a served 128x128 frame and a train step on
# the stash backward, each once under torch.profiler after a warm-up call:
# wall ms, device busy ms and share, the largest kernels, the wide launches
_SLICE = r"""
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from torch.profiler import ProfilerActivity, profile
from avr_tpu_torch.evaluation import render_full_image
from avr_tpu_torch.ops import threefry
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.training import LossParams, create_train_state, make_optimizer, make_train_step

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.load_library()
f32 = torch.float32
batch, tb = cs.scene_batch(), cs.train_batch(cs.DEV)
intr = torch.as_tensor(batch["intrinsics"][:, 0])
c2w = cs.orbit_cam2world(1, 1.3)[:1]
res = {"checkout": sys.argv[1]}


def profiled(name, call):
    call(0)
    torch.cuda.synchronize()
    before = dict(_build.launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        call(1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    res[name] = dict(wall_ms=wall, device_busy_ms=busy, busy_share=busy / wall,
                     top=[[k[:90], ms, c] for k, ms, c in rows[:6]],
                     wide_launches={k: v - before.get(k, 0) for k, v in _build.launches.items()
                                    if "wide" in k and v != before.get(k, 0)})


model = cs.conf_model(cs.WIDE_CONF, f32, cs.DEV)
with torch.inference_mode():
    cond = cs.encode_scene(model, batch, cs.DEV)
    profiled("frame", lambda i: render_full_image(model, cond, intr, c2w, cs.SIDE,
                                                  threefry.PRNGKey(i), cs.CHUNK, cs.DEV))
del model, cond
model = cs.conf_model(cs.WIDE_CONF, f32, cs.DEV, fused_mlp="stash")
opt = make_optimizer(1e-4)
state = [create_train_state(model, opt)]
step = make_train_step(model, opt, LossParams(loss_mode="both"))


def train(i):
    state[0], m = step(state[0], *tb, (0, i))


profiled("stash step", train)
print(json.dumps(res), flush=True)
"""

# --sweep, run once in a checkout: the float32 cluster kernels against the
# first version over d_hidden, the routes forced to each in turns
_SWEEP = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.ops.kernels import resnetfc as K2

torch.backends.cuda.matmul.allow_tf32 = False
_build.load_library()
f32 = torch.float32
gen = torch.Generator(device=cs.DEV).manual_seed(3)
res = {"checkout": sys.argv[1], "rows": []}
saved = K2.forward_route, K2.backward_route
for dh in range(576, 1025, 64):
    w = cs.decoder_weights(gen, dl=cs.WIDE_DL, dh=dh)
    x, z, g = cs.wide_inputs(gen, cs.BAND, 1, cs.WIDE_DL, cs.CODE, f32)
    args = K2._prepare(x, z, w, cs.CODE, f32)
    dims = K2._dims(args, 5, 3, True)
    fwd = lambda: K2._forward(args, dims, f32, False)
    st = K2._forward(args, dims, f32, True)[1]
    gs, wd, _ = K2._bwd_operands(args, dims, g, K2.NAME_DGRAD)
    dgrad = lambda: K2._dgrad(args, dims, st, gs, wd, f32)
    row = {"d_hidden": dh}
    for name, fn in (("forward", fwd), ("dgrad", dgrad)):
        t = {"wide_f32": [], "wide": []}
        for route in ("wide_f32", "wide", "wide", "wide_f32"):
            K2.forward_route = K2.backward_route = lambda *a, **k: route
            try:
                t[route].append(cs.time_ms(fn, iters=2, warmup=1))
            finally:
                K2.forward_route, K2.backward_route = saved
        row[name] = dict(cluster_ms=t["wide_f32"], first_version_ms=t["wide"])
    res["rows"].append(row)
    del args, st, gs, wd
    torch.cuda.empty_cache()
print(json.dumps(res), flush=True)
"""

# --sweep-pieces, run once in a checkout whose wgmma forward takes pieces:
# at the band chunk, each shape of PIECES_SWEEP at NS 1 and 2 on both bf16
# forwards (the routes forced: the wgmma forward's pieces, resnetfc_kernel),
# each held to the plain version (2^-7 of the largest output), in turns
# (chip_smoke.alternate: pieces, resnetfc_kernel, resnetfc_kernel, pieces,
# pieces, resnetfc_kernel; loops of about a second with the SM clock), beside
# the cuBLAS chain of the products (NS 1) and the bound; then phase 9's
# global_coarse_only frame (the global encoder's 640 lanes) profiled on
# either route in turns (device ms of the frame's K2 forwards, wall ms)
_SWEEP_PIECES = r"""
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from torch.profiler import ProfilerActivity, profile
from avr_tpu_torch.evaluation import render_full_image
from avr_tpu_torch.ops import threefry
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.ops.kernels import resnetfc as K2

_build.load_library()
bf = torch.bfloat16
gen = torch.Generator(device=cs.DEV).manual_seed(24)
kw = dict(n_blocks=5, n_lin_z=3, activate_out=True)
res = {"checkout": sys.argv[1], "rows": []}
ROUTES = {"pieces": "wgmma", "resnetfc_kernel": "mma_sync"}
# (d_hidden, latent, 576 encoded lanes): the latents past 512 at d_hidden
# 512, WIDE_CODE's 576 encoded lanes, d_hidden 256 with a latent of 1,024
SHAPES = ((512, 576, False), (512, 640, False), (512, 768, False), (512, 1024, False),
          (512, 1152, False), (512, 512, True), (256, 1024, False))
for dh, dl, wide_code in SHAPES:
    code = cs.WIDE_CODE if wide_code else cs.CODE
    for ns in (1, 2):
        w = cs.decoder_weights(gen, dh=dh, dl=dl, code=code)
        x, z, _ = cs.wide_inputs(gen, cs.BAND, ns, dl, code, bf)
        args = K2._prepare(x, z, w, code, bf)
        dims = K2._dims(args, 5, 3, True)
        want = cs.resnetfc_plain(x, z, w, compute_dtype=bf, code=code, **kw)
        tol = 2.0 ** -7 * max(1.0, float(want.abs().max()))
        calls = {name: (lambda r=r: cs.forward_on(r, args, dims)) for name, r in ROUTES.items()}
        errs = {name: cs.max_err(call()[0], want) for name, call in calls.items()}
        if not all(e <= tol for e in errs.values()):
            raise AssertionError(f"d_hidden {dh} d_latent {dl} NS={ns}: {errs} > {tol}")
        t = cs.alternate(calls)
        wbytes = sum(v.numel() for v in w) * 2
        b_ms, b_by = cs.bound(x.numel() * 4 + z.numel() * 2 + wbytes + cs.BAND * 4 * 4,
                              cs.wide_flops(cs.BAND, ns, dh, dl, code.d_enc), cs.BF16_FLOPS)
        chain = (cs.time_ms(cs.product_chain(gen, cs.BAND, dh, dl, dims["k_in"], bf, False),
                            iters=5, warmup=1) if ns == 1 else None)
        res["rows"].append(dict(
            d_hidden=dh, d_latent=dl, k_in=dims["k_in"], ns=ns,
            route=K2.forward_route(bf, dims["d_latent"], dims["k_in"], dh), max_abs_err=errs,
            tol=tol, median=t["median"],
            ms={lab: [r["ms"] for r in t["readings"] if r["label"] == lab] for lab in calls},
            chain_ms=chain, bound_ms=b_ms, bound_by=b_by))
        print(json.dumps(res["rows"][-1]), file=sys.stderr, flush=True)
        del w, x, z, args, want
        torch.cuda.empty_cache()

# phase 9's global_coarse_only frame on either route, in turns
batch = cs.scene_batch()
intr = torch.as_tensor(batch["intrinsics"][:, 0])
c2w = cs.orbit_cam2world(1, 1.3)[:1]
model = cs.option_model("global_coarse_only", bf, cs.DEV)
frames = {name: [] for name in ROUTES}
with torch.inference_mode():
    cond = cs.encode_scene(model, batch, cs.DEV)
    for i, name in enumerate(("pieces", "resnetfc_kernel", "resnetfc_kernel", "pieces")):
        with cs.forward_route_forced(ROUTES[name]):
            render_full_image(model, cond, intr, c2w, cs.SIDE, threefry.PRNGKey(0), cs.CHUNK,
                              cs.DEV)
            torch.cuda.synchronize()
            before = dict(_build.launches)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                render_full_image(model, cond, intr, c2w, cs.SIDE, threefry.PRNGKey(1),
                                  cs.CHUNK, cs.DEV)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        frames[name].append(dict(
            wall_ms=wall, device_busy_ms=sum(ms for _, ms in rows),
            k2_forward_ms=sum(ms for k, ms in rows if "resnetfc_fwd_wgmma_kernel" in k
                              or "resnetfc_kernel" in k),
            launches={k: v - before.get(k, 0) for k, v in _build.launches.items()
                      if "resnetfc" in k and v != before.get(k, 0)}))
res["global_coarse_only_frame"] = frames
print(json.dumps(res), flush=True)
"""

# --probe, run once in a checkout: its bf16 wide kernels beside the floors
_PROBE = r"""
import ctypes, json, os, shutil, subprocess, sys, tempfile
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.ops.kernels import resnetfc as K2

SRC = '''
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// SEM 1: the arrival a release and the wait an acquire at cluster scope;
// SEM 0: both at their default (CTA) scope, as CUTLASS's cluster barriers
template <int SEM>
__device__ __forceinline__ void mbar_arrive_cta(uint64_t* bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_u32(bar)), "r"(rank));
  if (SEM)
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" :: "r"(remote)
                 : "memory");
  else
    asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" :: "r"(remote) : "memory");
}
template <int SEM>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    if (SEM)
      asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
                   "[%1], %2; selp.u32 %0, 1, 0, p; }" : "=r"(done) : "r"(smem_u32(bar)),
                   "r"(parity) : "memory");
    else
      asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, "
                   "[%1], %2; selp.u32 %0, 1, 0, p; }" : "=r"(done) : "r"(smem_u32(bar)),
                   "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}
__device__ __forceinline__ void bulk_load_mc(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* bar, uint16_t mask) {
  if (mask)
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                 ".multicast::cluster [%0], [%1], %2, [%3], %4;" :: "r"(smem_u32(dst)), "l"(src),
                 "r"(bytes), "r"(smem_u32(bar)), "h"(mask) : "memory");
  else
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1], %2, [%3];" :: "r"(smem_u32(dst)), "l"(src), "r"(bytes),
                 "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\\nbarrier.cluster.wait.acquire.aligned;"
               ::: "memory");
}

// (a) rows x (kvec x 16 bytes) of weights once a CTA, the first version's
// pattern: warps take 64-row groups in turn; per 32-wide k step a lane loads
// 16 bytes of 8 rows (col0 + 8 nt + g, k 8 t)
__global__ void __launch_bounds__(256, 1) probe_ldg_kernel(const uint4* w, int rows, int kvec,
                                                         uint32_t* sink) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, warp = threadIdx.x >> 5;
  uint32_t acc = 0;
  for (int col0 = 64 * warp; col0 < rows; col0 += 64 * 8)
    for (int k0 = 0; k0 < kvec; k0 += 4) {
      uint4 b[8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) b[nt] = __ldg(w + (size_t)(col0 + nt * 8 + g) * kvec + k0 + t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) acc ^= b[nt].x ^ b[nt].y ^ b[nt].z ^ b[nt].w;
    }
  if (acc == 0x12345678u) sink[blockIdx.x] = acc;
}

// (b), (c) n stages of `stage` bytes once a CTA through a ring of `stages`
// shared stages: warp 8 issues, warps 0-7 wait, read a word each, release.
// With CL > 1 the cluster's CTAs each issue a 1/CL piece of every stage,
// multicast to all CL, and a stage is reissued when all CL CTAs released it:
// ONE 0, every consumer warp arrives on every CTA's barrier; ONE 1, the
// consumers meet at a named barrier and one warp arrives for the CTA.
template <int CL, int SEM, int ONE>
__global__ void __launch_bounds__(288, 1) probe_bulk_kernel(const unsigned char* w, int n,
                                                          int stage, int stages, uint32_t* sink) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * stage);
  uint64_t* empty = full + stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t rank = CL > 1 ? cluster_rank() : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], (ONE ? 1 : 8) * CL);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (CL > 1) cluster_sync(); else __syncthreads();
  uint32_t acc = 0;
  if (warp == 8) {
    if (lane == 0) {
      const uint32_t piece = stage / CL;
      for (int i = 0; i < n; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait<SEM>(&empty[s], ((i / stages) - 1) & 1);
        mbar_expect_tx(&full[s], stage);
        bulk_load_mc(smem + s * stage + rank * piece, w + (size_t)i * stage + rank * piece, piece,
                     &full[s], CL > 1 ? (uint16_t)((1 << CL) - 1) : (uint16_t)0);
      }
    }
  } else {
    for (int i = 0; i < n; ++i) {
      const int s = i % stages;
      mbar_wait<0>(&full[s], (i / stages) & 1);
      acc ^= reinterpret_cast<const uint32_t*>(smem + s * stage)[threadIdx.x];
      if (ONE) {
        asm volatile("bar.sync 1, 256;" ::: "memory");
        if (warp == 0 && lane < CL) mbar_arrive_cta<SEM>(&empty[s], lane);
      } else {
        __syncwarp();
        if (lane < CL) mbar_arrive_cta<SEM>(&empty[s], lane);
      }
    }
  }
  if (CL > 1) cluster_sync();
  if (acc == 0x12345678u) sink[blockIdx.x] = acc;
}

// (a) float32: krows k rows of `width` floats once a CTA in kloop<float>'s
// pattern: 16 warps take 64-column groups in turn; a lane (tc = lane % 8)
// loads 16 bytes at columns col0 + 4 tc and col0 + 32 + 4 tc of each k row,
// four k rows (8 loads) in flight
__global__ void __launch_bounds__(512, 1) probe_ldg_f32_kernel(const float* w, int krows,
                                                             int width, uint32_t* sink) {
  const int lane = threadIdx.x & 31, tc = lane & 7, warp = threadIdx.x >> 5;
  uint32_t acc = 0;
  for (int col0 = 64 * warp; col0 < width; col0 += 64 * 16) {
    const int c0 = col0 + 4 * tc, c1 = col0 + 32 + 4 * tc;
    for (int k4 = 0; k4 < krows; k4 += 4) {
      float4 b[8];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        b[2 * kk] = __ldg(reinterpret_cast<const float4*>(w + (size_t)(k4 + kk) * width + c0));
        b[2 * kk + 1] = __ldg(reinterpret_cast<const float4*>(w + (size_t)(k4 + kk) * width + c1));
      }
#pragma unroll
      for (int q = 0; q < 8; ++q)
        acc ^= __float_as_uint(b[q].x) ^ __float_as_uint(b[q].y) ^ __float_as_uint(b[q].z) ^
               __float_as_uint(b[q].w);
    }
  }
  if (acc == 0x12345678u) sink[blockIdx.x] = acc;
}

extern "C" int probe_ldg_f32(const void* w, int krows, int width, int blocks, int smem,
                             void* sink, void* stream) {
  cudaFuncSetAttribute(probe_ldg_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  probe_ldg_f32_kernel<<<blocks, 512, smem, (cudaStream_t)stream>>>((const float*)w, krows, width,
                                                                    (uint32_t*)sink);
  return (int)cudaGetLastError();
}

extern "C" int probe_ldg(const void* w, int rows, int kvec, int blocks, int smem, void* sink,
                         void* stream) {
  cudaFuncSetAttribute(probe_ldg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  probe_ldg_kernel<<<blocks, 256, smem, (cudaStream_t)stream>>>((const uint4*)w, rows, kvec,
                                                                (uint32_t*)sink);
  return (int)cudaGetLastError();
}

template <int CL, int SEM, int ONE>
int launch_bulk(const void* w, int n, int stage, int stages, int blocks, int smem, void* sink,
                void* stream) {
  cudaError_t e = cudaFuncSetAttribute(probe_bulk_kernel<CL, SEM, ONE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(288);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = CL;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, probe_bulk_kernel<CL, SEM, ONE>, (const unsigned char*)w, n,
                         stage, stages, (uint32_t*)sink);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// mode: 0 cluster-scope arrivals, every warp; 1 CTA-scope, every warp; 2
// CTA-scope, one warp a CTA
extern "C" int probe_bulk(const void* w, int n, int stage, int stages, int cl, int mode,
                          int blocks, int smem, void* sink, void* stream) {
#define PB(C, S, O) launch_bulk<C, S, O>(w, n, stage, stages, blocks, smem, sink, stream)
  if (cl == 1) return PB(1, 1, 0);
  if (cl == 2) return mode == 0 ? PB(2, 1, 0) : mode == 1 ? PB(2, 0, 0) : PB(2, 0, 1);
  return mode == 0 ? PB(4, 1, 0) : mode == 1 ? PB(4, 0, 0) : PB(4, 0, 1);
#undef PB
}
'''

nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
tmp = tempfile.mkdtemp()
open(os.path.join(tmp, "probe.cu"), "w").write(SRC)
so = os.path.join(tmp, "probe.so")
subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared", "-Xcompiler",
                "-fPIC", "-Xptxas", "-v", "-o", so, os.path.join(tmp, "probe.cu")], check=True)
lib = ctypes.CDLL(so)
V, I = ctypes.c_void_p, ctypes.c_int
lib.probe_ldg.argtypes = [V, I, I, I, I, V, V]
lib.probe_bulk.argtypes = [V, I, I, I, I, I, I, I, V, V]
lib.probe_ldg_f32.argtypes = [V, I, I, I, I, V, V]
stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
sink = torch.zeros(1 << 16, dtype=torch.int32, device=cs.DEV)


def dev(fn, names, iters=5):
    return sum(cs.kernel_device_ms(fn, names, iters).values())


def call(fn, *a):
    err = fn(*a, ctypes.c_void_p(sink.data_ptr()), stream())
    if err:
        raise RuntimeError(f"probe launch failed: cudaError {err}")


_build.load_library()
res = {"checkout": sys.argv[1]}
if sys.argv[2:] == ["float32"]:
    f32 = torch.float32
    gen = torch.Generator(device=cs.DEV).manual_seed(21)
    w = cs.decoder_weights(gen, dl=cs.WIDE_DL, dh=cs.WIDE_DH)
    x, z, g = cs.wide_inputs(gen, cs.BAND, 1, cs.WIDE_DL, cs.CODE, f32)
    args = K2._prepare(x, z, w, cs.CODE, f32)
    dims = K2._dims(args, 5, 3, True)
    fwd = lambda: K2._forward(args, dims, f32, False)
    st = K2._forward(args, dims, f32, True)[1]
    gs, wd, _ = K2._bwd_operands(args, dims, g, K2.NAME_DGRAD)
    dgrad = lambda: K2._dgrad(args, dims, st, gs, wd, f32)
    res["forward f32"] = dict(device_ms=dev(fwd, ("resnetfc_wide",), 2))
    res["dgrad f32"] = dict(device_ms=dev(dgrad, ("resnetfc_wide",), 2))
    # the float32 weights the products stream once a tile: wi, wz, w0, w1
    wbytes = sum(args[k].numel() * 4 for k in ("wi", "wz", "w0", "w1"))
    WIDTH = 1024
    krows = -(-wbytes // (4 * WIDTH)) // 4 * 4 + 4
    buf = torch.randn(krows * WIDTH, device=cs.DEV)
    tiles = -(-cs.BAND // 16)  # the first version's 16-point tiles
    res["weights f32"] = dict(bytes=wbytes, streamed=krows * WIDTH * 4, tiles=tiles)
    FIRST_SMEM = 139_776  # the first version's float32 trunk and operand tile: one CTA an SM
    floors = {"ldg f32, first version's pattern": (lambda: call(
        lib.probe_ldg_f32, buf.data_ptr(), krows, WIDTH, tiles, FIRST_SMEM), 1, krows * WIDTH * 4)}
    MODES = ("cluster-scope arrivals", "CTA-scope arrivals", "one CTA-scope arrival a CTA")
    # 3 x 30 KB: the ring that fits beside the first version's 140 KB; 3 x
    # 32 KB; and the first 40 MB alone (inside L2) for contrast
    for stage, stages, total in ((30720, 3, wbytes), (32768, 3, wbytes), (32768, 3, 40 << 20)):
        n = -(-total // stage)
        for cl, mode in ((1, 0), (2, 1), (2, 2), (4, 1), (4, 2)):
            if total != wbytes and mode == 1:
                continue
            name = (f"bulk f32 {stages} x {stage // 1024} KB stages, cluster {cl}"
                    + (f", {MODES[mode]}" if cl > 1 else "")
                    + ("" if total == wbytes else f", {total >> 20} MB"))
            floors[name] = (lambda n=n, stage=stage, stages=stages, cl=cl, mode=mode: call(
                lib.probe_bulk, buf.data_ptr(), n, stage, stages, cl, mode, tiles, 227 * 1024),
                cl, n * stage)
    for name, (fn, cl, nbytes) in floors.items():
        ms = dev(fn, ("probe_",), 3)
        delivered = tiles * nbytes / ms / 1e9
        # L2 reads each byte once a cluster; above 3.35 TB/s (HBM) the
        # reads cannot all come from HBM
        res["floor " + name] = dict(device_ms=ms, l2_to_sm_tb_s=delivered,
                                    l2_read_tb_s=delivered / cl)
    shutil.rmtree(tmp)
    print(json.dumps(res), flush=True)
    sys.exit(0)
if sys.argv[2:] == ["mma_sync"]:
    # the bf16 forward at d_hidden 512 past 512 latent lanes: resnetfc_kernel
    # (its C entry called directly, whatever the route) beside the wgmma
    # forward where the tree routes the shape there; at 512 lanes both in
    # turns (chip_smoke.alternate)
    bf = torch.bfloat16
    gen = torch.Generator(device=cs.DEV).manual_seed(23)
    MMA, WG = ("resnetfc_kernel",), ("resnetfc_fwd_wgmma_kernel",)
    for dl in (512, 640, 1024):
        w = cs.decoder_weights(gen, dl=dl)
        x, z, _ = cs.wide_inputs(gen, cs.BAND, 1, dl, cs.CODE, bf)
        args = K2._prepare(x, z, w, cs.CODE, bf)
        dims = K2._dims(args, 5, 3, True)
        mma = lambda: cs.mma_sync_forward(args, dims, False)
        wbytes = sum(args[k].numel() * 2 for k in ("wi", "wz", "w0", "w1"))
        row = dict(mma_sync_device_ms=dev(mma, MMA), weight_bytes=wbytes,
                   l2_bytes_32_point_tiles=-(-cs.BAND // 32) * wbytes,
                   l2_bytes_64_point_tiles=-(-cs.BAND // 64) * wbytes,
                   flops=cs.wide_flops(cs.BAND, 1, 512, dl, cs.CODE.d_enc))
        route = K2.forward_route(bf, dims["d_latent"], dims["k_in"], 512)
        if route == "wgmma":
            wg = lambda: K2._forward(args, dims, bf, False)
            row["wgmma_device_ms"] = dev(wg, WG)
            want = cs.resnetfc_plain(x, z, w, compute_dtype=bf, code=cs.CODE, n_blocks=5,
                                     n_lin_z=3, activate_out=True)
            row["wgmma_max_abs_err"] = cs.max_err(wg()[0], want)
            row["mma_sync_max_abs_err"] = cs.max_err(mma()[0], want)
            row["tol"] = 2.0 ** -7 * max(1.0, float(want.abs().max()))
            t = cs.alternate({"wgmma": wg, "mma_sync": mma})
            row["turns"] = t["median"]
            row["turns_ms"] = {lab: [r["ms"] for r in t["readings"] if r["label"] == lab]
                               for lab in ("wgmma", "mma_sync")}
        res[f"latent {dl}"] = row
        del w, x, z, args
        torch.cuda.empty_cache()
    # the weight feeds at latent 640 (7.27 MB of bf16 weights): by __ldg in
    # resnetfc_kernel's pattern once a 32-point tile (2,560 CTAs, one an SM),
    # and by bulk copies through the wgmma forward's 4 x 32 KB ring once a
    # 64-point tile (1,280 CTAs)
    wbytes = res["latent 640"]["weight_bytes"]
    rows = -(-wbytes // 1024) // 64 * 64 + 64  # rows of 512 bf16
    buf = torch.randn(rows * 512, device=cs.DEV).to(bf)
    for name, fn, tiles, nbytes in (
            ("ldg, resnetfc_kernel's pattern, 32-point tiles",
             lambda: call(lib.probe_ldg, buf.data_ptr(), rows, 64, 2560, 120 * 1024), 2560,
             rows * 1024),
            ("bulk 4 x 32 KB stages, 64-point tiles",
             lambda: call(lib.probe_bulk, buf.data_ptr(), rows * 1024 // 32768, 32768, 4, 1, 0,
                          1280, 227 * 1024), 1280, rows * 1024 // 32768 * 32768)):
        ms = dev(fn, ("probe_",), 3)
        res["floor " + name] = dict(device_ms=ms, l2_to_sm_tb_s=tiles * nbytes / ms / 1e9)
    shutil.rmtree(tmp)
    print(json.dumps(res), flush=True)
    sys.exit(0)
bf = torch.bfloat16
gen = torch.Generator(device=cs.DEV).manual_seed(21)
w = cs.decoder_weights(gen, dl=cs.WIDE_DL, dh=cs.WIDE_DH)
x, z, g = cs.wide_inputs(gen, cs.BAND, 1, cs.WIDE_DL, cs.CODE, bf)
args = K2._prepare(x, z, w, cs.CODE, bf)
dims = K2._dims(args, 5, 3, True)
fwd = lambda: K2._forward(args, dims, bf, False)
st = K2._forward(args, dims, bf, True)[1]
gs, wd, _ = K2._bwd_operands(args, dims, g, K2.NAME_DGRAD)
dgrad = lambda: K2._dgrad(args, dims, st, gs, wd, bf)
res["forward"] = dict(device_ms=dev(fwd, ("resnetfc_wide",)))
res["dgrad"] = dict(device_ms=dev(dgrad, ("resnetfc_wide",)))
# the weights the products stream once a tile: wi, wz, w0, w1 in bf16
wbytes = sum(args[k].numel() * 2 for k in ("wi", "wz", "w0", "w1"))
KVEC = 1024 * 2 // 16  # rows of 1,024 bf16
rows = -(-wbytes // 2048) // 64 * 64 + 64
buf = torch.randn(rows * 1024, device=cs.DEV).to(bf)
tiles = -(-cs.BAND // 32)
res["weights"] = dict(bytes=wbytes, streamed=rows * 2048, tiles=tiles)
PARENT_SMEM = 207_360  # one CTA an SM, as the first version at these shapes
floors = {}
floors["ldg, first version's pattern"] = lambda: call(lib.probe_ldg, buf.data_ptr(), rows, KVEC,
                                                      tiles, PARENT_SMEM)
MODES = ("cluster-scope arrivals", "CTA-scope arrivals", "one CTA-scope arrival a CTA")
for stage, stages in ((16384, 4), (32768, 3)):
    n = rows * 2048 // stage
    for cl, mode in ((1, 0), (2, 0), (2, 1), (2, 2), (4, 0), (4, 1), (4, 2)):
        floors[f"bulk {stages} x {stage // 1024} KB stages, cluster {cl}"
               + (f", {MODES[mode]}" if cl > 1 else "")] = (
            lambda n=n, stage=stage, stages=stages, cl=cl, mode=mode: call(
                lib.probe_bulk, buf.data_ptr(), n, stage, stages, cl, mode, tiles, 227 * 1024))
for name, fn in floors.items():
    ms = dev(fn, ("probe_",), 3)
    res["floor " + name] = dict(device_ms=ms, l2_to_sm_tb_s=tiles * rows * 2048 / ms / 1e9)
shutil.rmtree(tmp)
print(json.dumps(res), flush=True)
"""


# (d): exact edits of csrc/resnetfc_wide.cu that stamp the first version's
# bf16 kloop and product (the probe's copy only; a source they do not match
# is refused)
STAMPS = [
    ("template <typename T> struct Wide;", """__shared__ unsigned long long wd_t[16][4];
__device__ long long wd_stamps[2 * 8 * 8];
#define WD_T(k, t0) if ((threadIdx.x & 31) == 0) wd_t[threadIdx.x >> 5][k] += clock64() - (t0)
#define WD_DUMP(kind) if (std::is_same<T, bf16>::value && blockIdx.x == 1000 && \\
    (threadIdx.x & 31) == 0) { long long* o = wd_stamps + ((kind) * 8 + (threadIdx.x >> 5)) * 8; \\
    o[0] = clock64() - wd_start; for (int q = 0; q < 4; ++q) o[q + 1] = wd_t[threadIdx.x >> 5][q]; }
template <typename T> struct Wide;"""),
    ("""  for (int k0 = 0; k0 < K; k0 += 32) {
    uint4 a[2][2], b[8];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      a[mt][0] = a_bf16<AM>(A, lda, mt * 16 + g, k0 + 8 * t, nv);
      a[mt][1] = a_bf16<AM>(A, lda, mt * 16 + g + 8, k0 + 8 * t, nv);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      b[nt] = __ldg(
          reinterpret_cast<const uint4*>(W + (size_t)(col0 + nt * 8 + g) * ldw + k0 + 8 * t));
""", """  for (int k0 = 0; k0 < K; k0 += 32) {
    uint4 a[2][2], b[8];
    long long t0 = clock64();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      a[mt][0] = a_bf16<AM>(A, lda, mt * 16 + g, k0 + 8 * t, nv);
      a[mt][1] = a_bf16<AM>(A, lda, mt * 16 + g + 8, k0 + 8 * t, nv);
    }
    uint32_t dep = a[0][0].x ^ a[0][1].w ^ a[1][0].y ^ a[1][1].z;
    asm volatile("mov.b32 %0, %0;" : "+r"(dep));
    WD_T(0, t0); t0 = clock64();
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      b[nt] = __ldg(
          reinterpret_cast<const uint4*>(W + (size_t)(col0 + nt * 8 + g) * ldw + k0 + 8 * t));
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) dep ^= b[nt].x ^ b[nt].w;
    asm volatile("mov.b32 %0, %0;" : "+r"(dep));
    WD_T(1, t0); t0 = clock64();
    if (dep == 0x9e3779b9u) acc[0] += 1.f;
"""),
    ("""        mma_m16n8k16(acc + mt * 32 + nt * 4, hi, b[nt].z, b[nt].w);
      }
  }
}""", """        mma_m16n8k16(acc + mt * 32 + nt * 4, hi, b[nt].z, b[nt].w);
      }
    float fdep = acc[63] + acc[0];
    asm volatile("mov.b32 %0, %0;" : "+f"(fdep));
    WD_T(2, t0);
    if (fdep == 1234.5f) acc[1] += 1.f;
  }
}"""),
    ("""    kloop<AM>(acc, A, lda, nv, W, ldw, K, col0);
    epi(acc, col0);""", """    kloop<AM>(acc, A, lda, nv, W, ldw, K, col0);
    const long long te = clock64();
    epi(acc, col0);
    __syncwarp();
    WD_T(3, te);"""),
    ("""  const int r0 = blockIdx.x * TM, nv = min(TM, N - r0), tid = threadIdx.x, nt = blockDim.x;
  const T* wi = static_cast<const T*>(a.wi);
  const T* wz = static_cast<const T*>(a.wz);
  const T* w0 = static_cast<const T*>(a.w0);
  const T* w1 = static_cast<const T*>(a.w1);
  T* stash = static_cast<T*>(a.stash);""", """  const int r0 = blockIdx.x * TM, nv = min(TM, N - r0), tid = threadIdx.x, nt = blockDim.x;
  const long long wd_start = clock64();
  if (tid < 64) (&wd_t[0][0])[tid] = 0;
  __syncthreads();
  const T* wi = static_cast<const T*>(a.wi);
  const T* wz = static_cast<const T*>(a.wz);
  const T* w0 = static_cast<const T*>(a.w0);
  const T* w1 = static_cast<const T*>(a.w1);
  T* stash = static_cast<T*>(a.stash);"""),
    ("""    a.out[(size_t)(r0 + r) * a.d_out + o] = s;
  }
}""", """    a.out[(size_t)(r0 + r) * a.d_out + o] = s;
  }
  WD_DUMP(0);
}"""),
    ("""  const int r0 = blockIdx.x * TM, nv = min(TM, N - r0), tid = threadIdx.x, nt = blockDim.x;
  const T* wi = static_cast<const T*>(a.wi);
  const T* wz = static_cast<const T*>(a.wz);
  const T* w0 = static_cast<const T*>(a.w0);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* stash = static_cast<const T*>(a.stash);""", """  const int r0 = blockIdx.x * TM, nv = min(TM, N - r0), tid = threadIdx.x, nt = blockDim.x;
  const long long wd_start = clock64();
  if (tid < 64) (&wd_t[0][0])[tid] = 0;
  __syncthreads();
  const T* wi = static_cast<const T*>(a.wi);
  const T* wz = static_cast<const T*>(a.wz);
  const T* w0 = static_cast<const T*>(a.w0);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* stash = static_cast<const T*>(a.stash);"""),
    ("""    tail(0);
    return;""", """    tail(0);
    WD_DUMP(1);
    return;"""),
    ("""// The forward, dtype 0 float32""", """extern "C" int avr_wd_stamps(void* out) {
  return (int)cudaMemcpyFromSymbol(out, wd_stamps, sizeof(wd_stamps));
}

// The forward, dtype 0 float32"""),
]
STAMP_PHASES = ("A loads and conversion", "B wait (L2)", "mma.sync", "epilogues")

# (e): exact edits of csrc/resnetfc_wide.cu that stamp the bf16 TMA cluster
# kernels (resnetfc_wide_tma_*): a consumer warp's cycles waiting for a
# stage, in its products (the mma.sync of a stage, forced complete), in the
# products' epilogues and at the consumers' named barriers; (old, new,
# occurrences, None for any)
STAMPS_TMA = [
    ("constexpr int WT_TM = 32;", """__shared__ unsigned long long wts_t[8][4];
__device__ long long wts_out[2 * 8 * 8];
#define WTS(k, t0) if ((threadIdx.x & 31) == 0 && threadIdx.x < 256) \\
    wts_t[threadIdx.x >> 5][k] += clock64() - (t0)
constexpr int WT_TM = 32;""", 1),
    ("""    mbar_wait(&r.full[s], (it / WT_STAGES) & 1);
    if (on) {""", """    long long t0 = clock64();
    mbar_wait(&r.full[s], (it / WT_STAGES) & 1);
    WTS(0, t0);
    t0 = clock64();
    if (on) {""", 1),
    ("""      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&r.consumed[s]);""", """      }
      float dep = acc[0][0][0] + acc[1][7][3];
      asm volatile("mov.b32 %0, %0;" : "+f"(dep));
      if (dep == 1234.5f) acc[0][0][1] += 1.f;
    }
    WTS(1, t0);
    __syncwarp();
    if (lane == 0) mbar_arrive(&r.consumed[s]);""", 1),
    ("if (on[0]) epi(h[0], 64 * warp);",
     "{ long long te = clock64(); if (on[0]) epi(h[0], 64 * warp); WTS(2, te); }", 2),
    ("if (on[1]) epi(h[1], WT_PASS + 64 * warp);",
     "{ long long te = clock64(); if (on[1]) epi(h[1], WT_PASS + 64 * warp); WTS(2, te); }", 2),
    ("named_sync(WT_BAR, WT_CONSUMERS);",
     "{ long long tn = clock64(); named_sync(WT_BAR, WT_CONSUMERS); WTS(3, tn); }", None),
    ("""  const WtRing r{wt_shared, bars, bars + WT_STAGES, bars + 2 * WT_STAGES};
  const int tid = threadIdx.x, warp = tid >> 5;""", """  const WtRing r{wt_shared, bars, bars + WT_STAGES, bars + 2 * WT_STAGES};
  const int tid = threadIdx.x, warp = tid >> 5;
  if (tid < 32) (&wts_t[0][0])[tid] = 0;
  const long long wts0 = clock64();""", 2),
    ("""  cluster_sync();  // no CTA leaves while the cluster's arrivals may still reach it
}""", """  if (blockIdx.x == 1000 && (tid & 31) == 0 && warp < 8) {
    long long* o = wts_out + warp * 8;
    o[0] = clock64() - wts0;
    for (int q = 0; q < 4; ++q) o[q + 1] = wts_t[warp][q];
  }
  cluster_sync();  // no CTA leaves while the cluster's arrivals may still reach it
}""", 1),
    ("""  cluster_sync();
}

#undef WT_EACH""", """  if (blockIdx.x == 1000 && (tid & 31) == 0 && warp < 8) {
    long long* o = wts_out + (8 + warp) * 8;
    o[0] = clock64() - wts0;
    for (int q = 0; q < 4; ++q) o[q + 1] = wts_t[warp][q];
  }
  cluster_sync();
}

#undef WT_EACH""", 1),
    ("""// The forward, dtype 0 float32""", """extern "C" int avr_wd_stamps(void* out) {
  return (int)cudaMemcpyFromSymbol(out, wts_out, sizeof(wts_out));
}

// The forward, dtype 0 float32""", 1),
]
STAMP_PHASES_TMA = ("stage wait", "products (mma.sync)", "epilogues", "named barriers")

# (d) float32: exact edits of csrc/resnetfc_wide.cu that stamp the first
# version's float32 kloop (a warp's 4-wide k step of a 64-column group: the
# A rows' shared (or, for dz, global) loads, the wait for the eight 16-byte
# weight loads from L2, the 128 FMAs), its products' epilogues (the dgrad's
# ReLU masks read there), the dgrad's cotangent stores, its tail's dx sums
# and encoded input, and its lin_out backward (g_epi and the first gh);
# (old, new) each once
STAMPS_F32 = [
    ("template <typename T> struct Wide;", """__shared__ unsigned long long wf_t[16][8];
__device__ long long wf_stamps[2 * 16 * 8];
#define WF_T(k, t0) if ((threadIdx.x & 31) == 0) wf_t[threadIdx.x >> 5][k] += clock64() - (t0)
#define WF_DUMP(kind) if (std::is_same<T, float>::value && blockIdx.x == 1000 && \\
    (threadIdx.x & 31) == 0) { long long* o = wf_stamps + ((kind) * 16 + (threadIdx.x >> 5)) * 8; \\
    o[0] = clock64() - wf_start; for (int q = 0; q < 7; ++q) o[q + 1] = wf_t[threadIdx.x >> 5][q]; }
template <typename T> struct Wide;"""),
    ("""  for (int k4 = 0; k4 < K; k4 += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = a_f32<AM>(A, lda, tp + 4 * i, k4, nv);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(W + (size_t)(k4 + kk) * ldw + c0));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(W + (size_t)(k4 + kk) * ldw + c1));
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};""",
     """  for (int k4 = 0; k4 < K; k4 += 4) {
    float4 a[4];
    long long t0 = clock64();
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = a_f32<AM>(A, lda, tp + 4 * i, k4, nv);
    float dep = a[0].x + a[1].y + a[2].z + a[3].w;
    asm volatile("mov.b32 %0, %0;" : "+f"(dep));
    WF_T(0, t0);
    t0 = clock64();
    float4 bq[8];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      bq[2 * kk] = __ldg(reinterpret_cast<const float4*>(W + (size_t)(k4 + kk) * ldw + c0));
      bq[2 * kk + 1] = __ldg(reinterpret_cast<const float4*>(W + (size_t)(k4 + kk) * ldw + c1));
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) dep += bq[q].x + bq[q].w;
    asm volatile("mov.b32 %0, %0;" : "+f"(dep));
    WF_T(1, t0);
    t0 = clock64();
    if (dep == 1234.5f) acc[0] += 1.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 = bq[2 * kk], b1 = bq[2 * kk + 1];
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};"""),
    ("""        for (int j = 0; j < 8; ++j) acc[8 * i + j] = fmaf(av, bv[j], acc[8 * i + j]);
      }
    }
  }
}""", """        for (int j = 0; j < 8; ++j) acc[8 * i + j] = fmaf(av, bv[j], acc[8 * i + j]);
      }
    }
    float fdep = acc[31] + acc[0];
    asm volatile("mov.b32 %0, %0;" : "+f"(fdep));
    WF_T(2, t0);
    if (fdep == 1234.5f) acc[1] += 1.f;
  }
}"""),
    ("""    kloop<AM>(acc, A, lda, nv, W, ldw, K, col0);
    epi(acc, col0);""", """    kloop<AM>(acc, A, lda, nv, W, ldw, K, col0);
    const long long te = clock64();
    epi(acc, col0);
    __syncwarp();
    WF_T(3, te);"""),
    ("""    trunk_out<T, false>(Hs, ldh, cot + stash_slot(k, 1, v, ns, nlz) * slot, r0, nv, dh);""",
     """    { const long long ts = clock64();
    trunk_out<T, false>(Hs, ldh, cot + stash_slot(k, 1, v, ns, nlz) * slot, r0, nv, dh);
    __syncwarp(); WF_T(4, ts); }"""),
    ("""    rows_out(As, lda, cot + stash_slot(k, 0, v, ns, nlz) * slot, r0, nv, dh);""",
     """    { const long long ts = clock64();
    rows_out(As, lda, cot + stash_slot(k, 0, v, ns, nlz) * slot, r0, nv, dh);
    __syncwarp(); WF_T(4, ts); }"""),
    ("""    rows_out(As, lda, ci, r0, nv, dh);""", """    { const long long ts = clock64();
    rows_out(As, lda, ci, r0, nv, dh);
    __syncwarp(); WF_T(4, ts); }"""),
    ("""      __syncthreads();
      for (int idx = tid; idx < TM * a.d_in; idx += nt) {""", """      __syncthreads();
      const long long tx = clock64();
      for (int idx = tid; idx < TM * a.d_in; idx += nt) {"""),
    ("""        a.dx[at] = sum;
      }
      __syncthreads();  // the chunk is read before the next one is written""",
     """        a.dx[at] = sum;
      }
      __syncwarp();
      WF_T(5, tx);
      __syncthreads();  // the chunk is read before the next one is written"""),
    ("""    T* enc = static_cast<T*>(a.enc) + (size_t)v * N * k_in;""",
     """    const long long t5 = clock64();
    T* enc = static_cast<T*>(a.enc) + (size_t)v * N * k_in;"""),
    ("""      enc[(size_t)row * k_in + j] = from_f<T>(val);
    }
""", """      enc[(size_t)row * k_in + j] = from_f<T>(val);
    }
    __syncwarp();
    WF_T(5, t5);
"""),
    ("""    Hs[r * ldh + c] = v;
  }

  // block k of view v, backward""", """    Hs[r * ldh + c] = v;
  }
  __syncwarp();
  WF_T(6, wf_start);

  // block k of view v, backward"""),
    ("""  const int r0 = blockIdx.x * TM, nv = min(TM, N - r0), tid = threadIdx.x, nt = blockDim.x;
  const T* wi = static_cast<const T*>(a.wi);
  const T* wz = static_cast<const T*>(a.wz);
  const T* w0 = static_cast<const T*>(a.w0);
  const T* w1 = static_cast<const T*>(a.w1);
  T* stash = static_cast<T*>(a.stash);""", """  const int r0 = blockIdx.x * TM, nv = min(TM, N - r0), tid = threadIdx.x, nt = blockDim.x;
  if (tid < 128) (&wf_t[0][0])[tid] = 0;
  __syncthreads();
  const long long wf_start = clock64();
  const T* wi = static_cast<const T*>(a.wi);
  const T* wz = static_cast<const T*>(a.wz);
  const T* w0 = static_cast<const T*>(a.w0);
  const T* w1 = static_cast<const T*>(a.w1);
  T* stash = static_cast<T*>(a.stash);"""),
    ("""    a.out[(size_t)(r0 + r) * a.d_out + o] = s;
  }
}""", """    a.out[(size_t)(r0 + r) * a.d_out + o] = s;
  }
  WF_DUMP(0);
}"""),
    ("""  const int r0 = blockIdx.x * TM, nv = min(TM, N - r0), tid = threadIdx.x, nt = blockDim.x;
  const T* wi = static_cast<const T*>(a.wi);
  const T* wz = static_cast<const T*>(a.wz);
  const T* w0 = static_cast<const T*>(a.w0);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* stash = static_cast<const T*>(a.stash);""", """  const int r0 = blockIdx.x * TM, nv = min(TM, N - r0), tid = threadIdx.x, nt = blockDim.x;
  if (tid < 128) (&wf_t[0][0])[tid] = 0;
  __syncthreads();
  const long long wf_start = clock64();
  const T* wi = static_cast<const T*>(a.wi);
  const T* wz = static_cast<const T*>(a.wz);
  const T* w0 = static_cast<const T*>(a.w0);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* stash = static_cast<const T*>(a.stash);"""),
    ("""    tail(0);
    return;""", """    tail(0);
    WF_DUMP(1);
    return;"""),
    ("""// The forward, dtype 0 float32""", """extern "C" int avr_wd_stamps(void* out) {
  return (int)cudaMemcpyFromSymbol(out, wf_stamps, sizeof(wf_stamps));
}

// The forward, dtype 0 float32"""),
]
STAMP_PHASES_F32 = ("A loads", "B wait (L2)", "FMA", "epilogues (the dgrad's masks)",
                    "cotangent stores", "tail: dx and enc", "lin_out backward")

# exact edits of csrc/resnetfc_wide.cu that stamp the float32 cluster
# kernels (resnetfc_wide_f32_*): each of the four consumer warps' cycles
# waiting for a slab,
# in its FMAs (a slab's, forced complete), in the products' epilogues (the
# dgrad's masks read there), at the consumers' named barriers and in the
# tile's row copies (the stash, the cotangents, relu(h) into the operand
# tile), summed in device memory by CTA 1,000 alone (the kernels' shared
# memory is full); (old, new, occurrences, None for any)
STAMPS_WF = [
    ("constexpr int WF_TM = 16;", """__device__ long long wfs_t[8][8];
__device__ long long wfs_out[2 * 4 * 8];
#define WFS(k, t0) if (blockIdx.x == 1000 && (threadIdx.x & 31) == 0 && threadIdx.x < 128) \\
    wfs_t[threadIdx.x >> 5][k] += clock64() - (t0)
constexpr int WF_TM = 16;""", 1),
    ("""    mbar_wait(&r.full[s], (it / r.stages) & 1);
    const float* st = r.ring + (size_t)s * r.stage;
    if (m.on) wf_fma<PT>(A + k0, lda, st, cw, m, acc);""",
     """    long long t0 = clock64();
    mbar_wait(&r.full[s], (it / r.stages) & 1);
    WFS(0, t0);
    t0 = clock64();
    const float* st = r.ring + (size_t)s * r.stage;
    if (m.on) wf_fma<PT>(A + k0, lda, st, cw, m, acc);
    float dep = acc[0][0] + acc[PT - 1][7];
    asm volatile("mov.b32 %0, %0;" : "+f"(dep));
    if (dep == 1234.5f) acc[0][1] += 1.f;
    WFS(1, t0);""", 1),
    ("""#define WF_OWN(body)                                                        \\
  {                                                                        \\""",
     """#define WF_OWN(body)                                                        \\
  { const long long te = clock64();                                        \\""", 1),
    ("""      const float* ac = acc[i] + q;                                        \\
      body                                                                 \\
    }                                                                      \\
  }""", """      const float* ac = acc[i] + q;                                        \\
      body                                                                 \\
    }                                                                      \\
    WFS(2, te);                                                            \\
  }""", 1),
    ("named_sync(WF_BAR, nc);", "{ const long long tn = clock64(); named_sync(WF_BAR, nc); WFS(3, tn); }",
     None),
    ("""  const int nvec = w / 4;
  for (int idx = threadIdx.x; idx < WF_TM * nvec; idx += nc) {
    const int rr = idx / nvec, c = 4 * (idx - rr * nvec);
    float4 v = *reinterpret_cast<const float4*>(src + rr * lds + c);
    if (RELU) v = relu4(v);
    if (dst2) *reinterpret_cast<float4*>(dst2 + rr * ld2 + c) = v;
    if (dst && rr < nv) *reinterpret_cast<float4*>(dst + (size_t)(r0 + rr) * w + c) = v;
  }""", """  const int nvec = w / 4;
  const long long tr = clock64();
  for (int idx = threadIdx.x; idx < WF_TM * nvec; idx += nc) {
    const int rr = idx / nvec, c = 4 * (idx - rr * nvec);
    float4 v = *reinterpret_cast<const float4*>(src + rr * lds + c);
    if (RELU) v = relu4(v);
    if (dst2) *reinterpret_cast<float4*>(dst2 + rr * ld2 + c) = v;
    if (dst && rr < nv) *reinterpret_cast<float4*>(dst + (size_t)(r0 + rr) * w + c) = v;
  }
  __syncwarp();
  WFS(4, tr);""", 1),
    ("""  wf_start(r);
  if (tid >= nc) {""", """  wf_start(r);
  const long long wfs0 = clock64();
  if (tid >= nc) {""", 2),
    ("""  cluster_sync();  // no CTA leaves while the cluster's copies and arrivals may still reach it
}""", """  if (blockIdx.x == 1000 && (tid & 31) == 0 && tid < nc) {
    long long* o = wfs_out + (tid >> 5) * 8;
    o[0] = clock64() - wfs0;
    for (int q = 0; q < 5; ++q) {
      o[q + 1] = wfs_t[tid >> 5][q];
      wfs_t[tid >> 5][q] = 0;
    }
  }
  cluster_sync();  // no CTA leaves while the cluster's copies and arrivals may still reach it
}""", 1),
    ("""  cluster_sync();
}

#undef WF_OWN""", """  if (blockIdx.x == 1000 && (tid & 31) == 0 && tid < nc) {
    long long* o = wfs_out + (4 + (tid >> 5)) * 8;
    o[0] = clock64() - wfs0;
    for (int q = 0; q < 5; ++q) {
      o[q + 1] = wfs_t[tid >> 5][q];
      wfs_t[tid >> 5][q] = 0;
    }
  }
  cluster_sync();
}

#undef WF_OWN""", 1),
    ("""// The forward, dtype 0 float32""", """extern "C" int avr_wd_stamps(void* out) {
  return (int)cudaMemcpyFromSymbol(out, wfs_out, sizeof(wfs_out));
}

// The forward, dtype 0 float32""", 1),
]
STAMP_PHASES_WF = ("slab wait", "FMA", "epilogues", "named barriers", "row copies")

# exact edits of csrc/resnetfc.cu that stamp resnetfc_kernel (the bf16
# mma.sync forward): each warp's cycles in the per-view prologue (the
# encoded input written and the latent rows loaded into shared memory, with
# the barrier after them), in gemm_tile's A operand loads from shared
# memory, its wait for the eight 16-byte weight loads from L2 and its 32
# mma.sync (each forced complete), and in lin_out; the rest of a warp's
# cycles are the epilogues (biases, relu and the operand tile rewritten)
# and the barriers between products.  Kept by CTA 1,000 of the band's 2,560
# (one CTA an SM: a later wave); (old, new, occurrences)
STAMPS_MMA = [
    ("constexpr int TM = 32;  // points per CTA", """__shared__ unsigned long long ms_t[8][8];
__device__ long long ms_out[8 * 8];
#define MS_T(k, t0) if ((threadIdx.x & 31) == 0) ms_t[threadIdx.x >> 5][k] += clock64() - (t0)
constexpr int TM = 32;  // points per CTA""", 1),
    ("""    for (int mt = 0; mt < 2; ++mt) {
      a[mt][0] = *reinterpret_cast<const uint4*>(As + (mt * 16 + g) * lda + k0 + 8 * t);
      a[mt][1] = *reinterpret_cast<const uint4*>(As + (mt * 16 + g + 8) * lda + k0 + 8 * t);
    }
""", """    long long t0 = clock64();
    for (int mt = 0; mt < 2; ++mt) {
      a[mt][0] = *reinterpret_cast<const uint4*>(As + (mt * 16 + g) * lda + k0 + 8 * t);
      a[mt][1] = *reinterpret_cast<const uint4*>(As + (mt * 16 + g + 8) * lda + k0 + 8 * t);
    }
    uint32_t dep = a[0][0].x ^ a[0][1].w ^ a[1][0].y ^ a[1][1].z;
    asm volatile("mov.b32 %0, %0;" : "+r"(dep));
    MS_T(0, t0); t0 = clock64();
""", 1),
    ("""      b[nt] = __ldg(reinterpret_cast<const uint4*>(W + (size_t)(col0 + nt * 8 + g) * K + k0 + 8 * t));
""", """      b[nt] = __ldg(reinterpret_cast<const uint4*>(W + (size_t)(col0 + nt * 8 + g) * K + k0 + 8 * t));
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) dep ^= b[nt].x ^ b[nt].w;
    asm volatile("mov.b32 %0, %0;" : "+r"(dep));
    MS_T(1, t0); t0 = clock64();
    if (dep == 0x9e3779b9u) acc[0][0][0] += 1.f;
""", 1),
    ("""        mma_bf16(acc[mt][nt], a[mt][0].z, a[mt][1].z, a[mt][0].w, a[mt][1].w, b[nt].z, b[nt].w);
      }
  }
}""", """        mma_bf16(acc[mt][nt], a[mt][0].z, a[mt][1].z, a[mt][0].w, a[mt][1].w, b[nt].z, b[nt].w);
      }
    float fdep = acc[0][0][0] + acc[1][7][3];
    asm volatile("mov.b32 %0, %0;" : "+f"(fdep));
    MS_T(2, t0);
    if (fdep == 1234.5f) acc[0][0][1] += 1.f;
  }
}""", 1),
    ("  const int tid = threadIdx.x, col0 = (tid >> 5) * 64;",
     """  const int tid = threadIdx.x, col0 = (tid >> 5) * 64;
  if (tid < 64) (&ms_t[0][0])[tid] = 0;
  __syncthreads();
  const long long ms_start = clock64();""", 1),
    ("    __syncthreads();  // the previous view is done with both tiles",
     """    __syncthreads();  // the previous view is done with both tiles
    const long long ms_p = clock64();""", 1),
    ("""      *reinterpret_cast<uint4*>(Zs + r * ldz + cv * V) = val;
    }
    __syncthreads();
""", """      *reinterpret_cast<uint4*>(Zs + r * ldz + cv * V) = val;
    }
    __syncthreads();
    MS_T(3, ms_p);
""", 1),
    ("""  const T* wo = static_cast<const T*>(a.wo);
  for (int idx = tid; idx < TM * a.d_out; idx += blockDim.x) {""",
     """  const long long ms_o = clock64();
  const T* wo = static_cast<const T*>(a.wo);
  for (int idx = tid; idx < TM * a.d_out; idx += blockDim.x) {""", 1),
    ("""    a.out[(size_t)row * a.d_out + o] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(256, 1) resnetfc_kernel(FcArgs a) {""",
     """    a.out[(size_t)row * a.d_out + o] = s;
  }
  __syncwarp();
  MS_T(4, ms_o);
  if (blockIdx.x == 1000 && (tid & 31) == 0 && tid < 256) {
    long long* o = ms_out + (tid >> 5) * 8;
    o[0] = clock64() - ms_start;
    for (int q = 0; q < 5; ++q) o[q + 1] = ms_t[tid >> 5][q];
  }
}

template <typename T>
__global__ void __launch_bounds__(256, 1) resnetfc_kernel(FcArgs a) {""", 1),
    ("// bf16 operands only (float32 takes avr_resnetfc_fwd_f32 below).",
     """extern "C" int avr_wd_stamps(void* out) {
  return (int)cudaMemcpyFromSymbol(out, ms_out, sizeof(ms_out));
}

// bf16 operands only (float32 takes avr_resnetfc_fwd_f32 below).""", 1),
]
STAMP_PHASES_MMA = ("A loads (shared)", "B wait (L2)", "mma.sync",
                    "prologue: encoding and latent rows", "lin_out")

# exact edits of csrc/resnetfc_hopper.cu that stamp the wgmma forward (a
# tree whose forward takes operands past 512 lanes in pieces): the cycles
# of each consumer warpgroup's first thread waiting for a weight stage,
# waiting on its wgmma groups (walk_kloop, the forward's 4-stage
# instantiations only), in each latent load (the barrier before it and the
# TMA wait) and in each encoded-input write (the barrier, the writes and
# the fence), kept by
# CTA 600 of the band's 1,280; the rest is the epilogues (biases, relu(h)
# and fc_0's output into A, the park tiles), their barriers and lin_out;
# (old, new, occurrences)
STAMPS_PIECES = [
    ("// Before A is rewritten: the last TMA store has read it and every product",
     """__shared__ long long fp_t[2][8];
__device__ long long fp_out[2 * 8];
#define FP_T(k, t0) if ((threadIdx.x & 127) == 0 && threadIdx.x < 256) \\
    fp_t[threadIdx.x >> 7][k] += clock64() - (t0)
// Before A is rewritten: the last TMA store has read it and every product""", 1),
    ("""    const int st = c.ws % S;
    mbar_wait(walk_bar(st), (c.ws / S) & 1);""", """    const int st = c.ws % S;
    long long t0 = clock64();
    mbar_wait(walk_bar(st), (c.ws / S) & 1);
    if (S == 4) FP_T(0, t0);""", 1),
    ("""    if (kc > 0) {
      wgmma_wait<1>();""", """    if (kc > 0) {
      long long t1 = clock64();
      wgmma_wait<1>();
      if (S == 4) FP_T(1, t1);""", 1),
    ("""  wgmma_wait<0>();
  mbar_arrive(walk_bar(S + (c.ws - 1) % S));
}""", """  long long t1 = clock64();
  wgmma_wait<0>();
  if (S == 4) FP_T(1, t1);
  mbar_arrive(walk_bar(S + (c.ws - 1) % S));
}""", 1),
    ("""        // the latent tile into A by TMA (rows past N read as zeros)
        walk_begin_write(c);""", """        // the latent tile into A by TMA (rows past N read as zeros)
        const long long tz = clock64();
        walk_begin_write(c);""", 1),
    ("        mbar_wait(zfull, (v * nlz + k) & 1);", """        mbar_wait(zfull, (v * nlz + k) & 1);
        FP_T(2, tz);""", 1),
    ("""          const int kch = min(FWD_K_EXT, dl - l0) / 64;
          walk_begin_write(c);""", """          const int kch = min(FWD_K_EXT, dl - l0) / 64;
          const long long tz = clock64();
          walk_begin_write(c);""", 1),
    ("          mbar_wait(zfull, zloads++ & 1);", """          mbar_wait(zfull, zloads++ & 1);
          FP_T(2, tz);""", 1),
    ("""      // the encoded input into A: one thread an element, a compact loop
      walk_begin_write(c);""", """      // the encoded input into A: one thread an element, a compact loop
      const long long te = clock64();
      walk_begin_write(c);""", 1),
    ("""      fwd_end_write(c, -1);
      fwd_trunk(c, acc, h, a.k_in / 64, a.bi, false);""", """      fwd_end_write(c, -1);
      FP_T(3, te);
      fwd_trunk(c, acc, h, a.k_in / 64, a.bi, false);""", 1),
    ("""      auto encode = [&](int j0, int kw) {
        walk_begin_write(c);""", """      auto encode = [&](int j0, int kw) {
        const long long te = clock64();
        walk_begin_write(c);""", 1),
    ("""        fwd_end_write(c, -1);
      };""", """        fwd_end_write(c, -1);
        FP_T(3, te);
      };""", 1),
    ("""  setmaxnreg_inc<232>();
  const int t = tid & 127;
  float h[H][64];""", """  setmaxnreg_inc<232>();
  if ((tid & 127) == 0)
    for (int q = 0; q < 8; ++q) fp_t[tid >> 7][q] = 0;
  const long long fp0 = clock64();
  const int t = tid & 127;
  float h[H][64];""", 1),
    ("""  if (tid == 0) tma_store_wait_read();  // the tile stays until the last store has read it
}

extern "C" int avr_resnetfc_fwd_bf16(""", """  if (tid == 0) tma_store_wait_read();  // the tile stays until the last store has read it
  if (blockIdx.x == 600 && (tid & 127) == 0) {
    long long* o = fp_out + (tid >> 7) * 8;
    o[0] = clock64() - fp0;
    for (int q = 0; q < 4; ++q) o[q + 1] = fp_t[tid >> 7][q];
  }
}

extern "C" int avr_wd_stamps(void* out) {
  return (int)cudaMemcpyFromSymbol(out, fp_out, sizeof(fp_out));
}

extern "C" int avr_resnetfc_fwd_bf16(""", 1),
]
STAMP_PHASES_PIECES = ("stage wait", "wgmma wait", "latent loads", "encoded input writes")

# run in a stamped copy: the band's forward and dgrad, their cycles by phase;
# argv[1] "first": the routes patched to the first version (a redesigned
# tree keeps it for other shapes), "tma": the tree's own
_STAMPED = r"""
import ctypes, json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.ops.kernels import resnetfc as K2
if sys.argv[1] in ("first", "first_f32"):
    K2.forward_route = lambda *a, **k: "wide"
    K2.backward_route = lambda *a, **k: "wide"
WARPS = {"first_f32": 16, "new_f32": 4}.get(sys.argv[1], 8)
F32 = sys.argv[1] in ("first_f32", "new_f32")
info = _build.load_library()
log = str(info.get("log", "")).splitlines()
build = [" ".join(log[i:i + 3]) for i, l in enumerate(log)
         if "resnetfc_wide" in l and "Function properties" in l]
bf = torch.float32 if F32 else torch.bfloat16
gen = torch.Generator(device=cs.DEV).manual_seed(21)
w = cs.decoder_weights(gen, dl=cs.WIDE_DL, dh=cs.WIDE_DH)
x, z, g = cs.wide_inputs(gen, cs.BAND, 1, cs.WIDE_DL, cs.CODE, bf)
args = K2._prepare(x, z, w, cs.CODE, bf)
dims = K2._dims(args, 5, 3, True)
fwd = lambda: K2._forward(args, dims, bf, False)
st = K2._forward(args, dims, bf, True)[1]
gs, wd, _ = K2._bwd_operands(args, dims, g, K2.NAME_DGRAD)
dgrad = lambda: K2._dgrad(args, dims, st, gs, wd, bf)
ms = {k: sum(cs.kernel_device_ms(f, ("resnetfc_wide",), 1 if F32 else 3).values())
      for k, f in (("forward", fwd), ("dgrad", dgrad))}
fwd()
dgrad()
torch.cuda.synchronize()
buf = (ctypes.c_longlong * (16 * WARPS))()
err = _build.kernel_fn("avr_wd_stamps", [ctypes.c_void_p])(ctypes.cast(buf, ctypes.c_void_p))
print(json.dumps(dict(stamped_device_ms=ms, build=build, err=err,
                      warps=[list(buf[8 * k:8 * k + 8]) for k in range(2 * WARPS)])), flush=True)
"""


# run in a copy with resnetfc_kernel stamped: the bf16 forward at the band,
# d_hidden 512, a latent of 640 lanes, through resnetfc_kernel's C entry
_STAMPED_MMA = r"""
import ctypes, json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.ops.kernels import resnetfc as K2
info = _build.load_library()
log = str(info.get("log", "")).splitlines()
build = [" ".join(log[i:i + 3]) for i, l in enumerate(log)
         if "resnetfc_kernel" in l and "Function properties" in l]
bf = torch.bfloat16
out = dict(build=build, stamped_device_ms={}, warps={})
for dl in ((512, 640) if sys.argv[1] == "pieces" else (640,)):
    gen = torch.Generator(device=cs.DEV).manual_seed(23)
    w = cs.decoder_weights(gen, dl=dl)
    x, z, _ = cs.wide_inputs(gen, cs.BAND, 1, dl, cs.CODE, bf)
    args = K2._prepare(x, z, w, cs.CODE, bf)
    dims = K2._dims(args, 5, 3, True)
    if sys.argv[1] == "pieces":
        fwd, names = (lambda: K2._forward(args, dims, bf, False)), ("resnetfc_fwd_wgmma_kernel",)
    else:
        fwd, names = (lambda: cs.mma_sync_forward(args, dims, False)), ("resnetfc_kernel",)
    out["stamped_device_ms"][dl] = sum(cs.kernel_device_ms(fwd, names, 3).values())
    fwd()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * 64)()
    out["err"] = _build.kernel_fn("avr_wd_stamps", [ctypes.c_void_p])(
        ctypes.cast(buf, ctypes.c_void_p))
    out["warps"][dl] = [list(buf[8 * k:8 * k + 8]) for k in range(8 if dl == 640 and sys.argv[1]
                                                                   != "pieces" else 2)]
print(json.dumps(out), flush=True)
"""


def stamped(checkout, kernels="first"):
    """The checkout's port copied, its wide kernels stamped (``STAMPS`` for
    the first version, the routes patched to it; ``STAMPS_TMA`` for the TMA
    cluster kernels), built and run at the band in a directory of its own:
    device ms of the stamped kernels and each phase's share of a warp's
    cycles (mean over the eight warps; of the first version's 16 float32
    warps the bf16 kernels use 8), for the forward and the dgrad.  With
    ``kernels`` "mma_sync" (``STAMPS_MMA``) the bf16 forward
    ``resnetfc_kernel`` at a latent of 640, with "pieces"
    (``STAMPS_PIECES``) the wgmma forward at 512 and 640 (its two consumer
    warpgroups).  A tree whose source lacks a stamp site is reported as
    such and not run."""
    import shutil
    import subprocess
    import tempfile

    mma = kernels in ("mma_sync", "pieces")
    fname = {"mma_sync": "resnetfc.cu", "pieces": "resnetfc_hopper.cu"}.get(kernels,
                                                                           "resnetfc_wide.cu")
    src = os.path.join(checkout, "avr_tpu_torch", "csrc", fname)
    text = open(src).read()
    edits = {"tma": STAMPS_TMA, "new_f32": STAMPS_WF, "mma_sync": STAMPS_MMA,
             "pieces": STAMPS_PIECES}.get(kernels) or \
        [(o, n, 1) for o, n in (STAMPS_F32 if kernels == "first_f32" else STAMPS)]
    for old, new, count in edits:
        if text.count(old) != count if count else not text.count(old):
            return {"stamps": "source does not match"}
        text = text.replace(old, new)
    tmp = tempfile.mkdtemp()
    try:
        shutil.copytree(os.path.join(checkout, "avr_tpu_torch"), os.path.join(tmp, "avr_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build"))
        shutil.copy(os.path.join(checkout, "chip_smoke.py"), tmp)
        open(os.path.join(tmp, "avr_tpu_torch", "csrc", fname), "w").write(text)
        r = subprocess.run([sys.executable, "-c", _STAMPED_MMA if mma else _STAMPED, kernels],
                           cwd=tmp, capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(f"stamps: exit {r.returncode}\n{r.stderr[-3000:]}")
        out = json.loads(r.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(tmp)
    warps = out.pop("warps")
    phases = {"tma": STAMP_PHASES_TMA, "first_f32": STAMP_PHASES_F32,
              "new_f32": STAMP_PHASES_WF, "mma_sync": STAMP_PHASES_MMA,
              "pieces": STAMP_PHASES_PIECES}.get(kernels, STAMP_PHASES)
    if mma:  # the forward alone, at each latent it ran
        kinds = [(f"forward latent {dl}", rows) for dl, rows in warps.items()]
    else:
        kinds = [("forward", warps[:len(warps) // 2]), ("dgrad", warps[len(warps) // 2:])]
    for kind, rows in kinds:
        total = sum(w[0] for w in rows) / len(rows)
        share = {name: sum(w[k + 1] for w in rows) / len(rows) / total
                 for k, name in enumerate(phases)}
        share["other"] = 1 - sum(share.values())
        out[kind] = dict(cycles_a_tile=total, share=share)
    return out


if __name__ == "__main__":
    if sys.argv[1:2] == ["--slice"]:
        sys.exit(march_turns.run(_SLICE, sys.argv[2:]))
    if sys.argv[1:2] == ["--sweep-pieces"]:
        sys.exit(march_turns.run(_SWEEP_PIECES, sys.argv[2:], both_orders=False))
    if sys.argv[1:2] == ["--sweep"]:
        sys.exit(march_turns.run(_SWEEP, sys.argv[2:], both_orders=False))
    if sys.argv[1:2] == ["--probe-mma-sync"]:
        rc = march_turns.run(_PROBE, sys.argv[2:], both_orders=False, extra=("mma_sync",))
        for c in sys.argv[2:]:
            for kernels in ("mma_sync", "pieces"):
                print(json.dumps({"checkout": c, "kernels": kernels,
                                  "stamps": stamped(os.path.abspath(c), kernels)}), flush=True)
        sys.exit(rc)
    if sys.argv[1:2] in (["--probe"], ["--probe-f32"]):
        f32 = sys.argv[1] == "--probe-f32"
        rc = march_turns.run(_PROBE, sys.argv[2:], both_orders=False,
                             extra=("float32",) if f32 else ())
        for c in sys.argv[2:]:
            for kernels in (("first_f32", "new_f32") if f32 else ("first", "tma")):
                print(json.dumps({"checkout": c, "kernels": kernels,
                                  "stamps": stamped(os.path.abspath(c), kernels)}), flush=True)
        sys.exit(rc)
    sys.exit(march_turns.main(_TURN, __doc__))
