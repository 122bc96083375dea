#!/usr/bin/env python3
"""On-card smoke test of the avr_tpu_torch port (one NVIDIA Hopper GPU).

    python3 chip_smoke.py [--profile] [--out=DIR]

Phases (any failure raises and exits non-zero):

1. The card (``nvidia-smi`` name and power limit), torch/CUDA versions, and
   the kernel library build from ``avr_tpu_torch/csrc`` (nvcc, sm_90a).
2. Kernels: each hand-written forward kernel against its plain PyTorch
   version on the same inputs at the serving path's shapes; then each
   backward kernel's gradients against the plain version's autograd at the
   train step's shapes (4 scenes x 4,096 rays), each with its tolerance and
   the reason for it; K1 and K2 forward and K1 backward also at the VR
   fine pass's shapes (96 x 4,096 points a scene); K2's bf16 forward (the
   wgmma kernel, ``csrc/resnetfc_hopper.cu``) also at a point count off its
   64-point tile, its stash slot by slot against the plain forward's
   activations (NS 1 and 2), the ``mma.sync`` forward that
   ``forward_route`` keeps for bf16 beyond 512 latent or encoded lanes at
   a latent of 1,024 and at 576 encoded lanes, and the wgmma forward timed
   in turns against the parent's
   ``mma.sync`` forward (``csrc/resnetfc.cu``, its C entry point called
   directly) at the band chunk (serving) and at the train step's band call
   with the stash, each loop beside the SM clock and power that
   ``nvidia-smi`` read; K2's bf16 wgrad (the
   wgmma kernel and its reduction) per job against torch.matmul and a
   column sum on the same rounded operands; K2's recompute backward
   also against the stash backward kernels (bit for bit where the
   arithmetic is the same) at the band call and at the VR fine pass
   (1,572,864 points), where it is held against the plain autograd too,
   and with its host loop cut to 1,000-point chunks; the integral's
   adjoint with a saturated lane; K4 (the band integral) at the train
   step's band (4 x 4,096 rays x 20 samples, and 40: two groups of 32
   samples a ray) and a serving chunk, with saturated samples and a ray of
   zero density, forward and backward, the forward also at 1, 32 and 33
   samples, at 1 and 1,000 rays (off its CTA's 32) and at none, and timed
   at the band and at a served chunk; K3 (``march_route``: bf16 on 16-ray
   tiles, float32 a warp a ray, each case's route counters checked) also
   at hidden 62, forward and backward, its forward and the timed
   backward's eight gradients bit for bit equal on a rerun (every float32
   case's too, early stop with frozen rays included), its forward also
   timed at the train step's call with the saved rows and its float32
   kernels timed beside; K5
   (the projected gather) at both of its calls on the fused path, the band
   query (81,920 points a scene) and the coarse query at the marched point
   (4,096), in 1 scene (serving) and 4 (the train step), bf16 and float32,
   1 and 2 views, forward and backward; K1's and K5's forward (one tiled
   kernel) also bit for bit in bf16 and float32 at 1, 3 and 8 maps, N = 0,
   1 and off the tile, C 512 and the smallest, points beyond the border,
   and timed at the band at ray-shaped and uniform coordinates; K1's and
   K5's backward (binned,
   no float atomics) also at the band's and the VR coarse pass's
   coordinates (K1, timed beside the uniform case), with every point in one
   map tile, on tile edges and the map border, N off any multiple and N =
   0, each case run twice and held bit for bit equal, and one backward of
   each under ``torch.cuda.set_sync_debug_mode("error")`` (no copy to the
   host); K7 (the threefry uniform draw) bit
   for bit against its plain version at the serving and train draws'
   shapes and its raw bits at the sampler's, and held to the TPU kernel's
   contract (range, moments, determinism, key sensitivity, decorrelated
   column blocks).  float32 (the JAX CLI's default dtype): K2's stash and
   recompute backward, K3's backward and the float32 wgrad (K2's 15 jobs,
   K3's dW_ih and dW_hh) bit for bit on a rerun, the wgrad's jobs against
   torch.matmul; K2's float32 forward (``resnetfc_fwd_f32_kernel``) held
   to the plain version at d_hidden 64, 256 and 512, NS 1 and 2, 576
   encoded lanes and a latent of 1,024, on and off its 32-point tile, with
   and without the stash (``check_f32_forward``); K2's float32 forward (at
   the band and a served chunk's coarse query), dgrad and wgrad, K3's
   dW_ih and dW_hh and a served float32 frame timed (the ``float32`` rows,
   beside their float32 bounds); the served float32 frames and a float32
   adaptive step launch every float32 K2 forward on the float32 kernel
   (``fused_resnetfc_f32``) and every float32 wgrad on
   ``resnetfc_wgrad_f32``, the two kernels' rows in the kernel table.
   Times (CUDA events) of the kernel, the plain version and, where one
   PyTorch call computes the same function, that call (K4
   and K5 also the kernel's own device time, from the profiler); the least
   time the card could take (bytes over 3.35 TB/s or operations over the
   type's peak).
3. Serve: the full-width ``conf/default_mv.conf`` model (bf16, seeded
   benchmark weights, ``bench_weights``: every matrix N(0, 1/fan_in),
   ``fc_1`` too, so the backward kernels meet nonzero cotangents) of each
   renderer (adaptive, VR, Raymarcher, and the adaptive
   renderer's fused path: ``gather_impl="pallas_proj"``,
   ``fused_integral="always"``) encodes one 128x128 source view and
   renders 3 orbit frames of 128x128 through ``evaluation.generate_video``
   (frame i with ``PRNGKey(i)``, JAX's key stream: every draw through K7);
   the launch counters are reset just before and read just after, and must
   show each kernel's launches per chunk, every bf16 K2 forward on the wgmma
   route (``fused_resnetfc_wgmma``; so too in phase 4, the stash forwards
   and the recompute's reruns included).
4. Train: 2 warm-up and 10 (adaptive) or 5 timed train steps of the same
   models (Adam, bf16, SB 4 x 4,096 rays on ``bench.py``'s synthetic
   batch): the adaptive renderer, the VR in one chunk (K2's recompute
   backward), the VR in 8 chunks (``make_chunked_call_train_step``, the
   stash backward), the Raymarcher (``loss_mode="coarse"``), the
   adaptive renderer's fused path, and the adaptive renderer's
   device-data step (``make_train_step(sampler=..., rng_mode="legacy")``
   on a 64-instance x 50-view synthetic set of 128x128 on the card: the
   batch drawn by three ``randint``s through K7's bits, the render's
   jitter through K7); the
   counters, reset before the timed steps, must show each kernel's expected
   launches per step; the loss is finite, and every parameter and
   BatchNorm statistic moved but those the loss gives no gradient, which
   must not.  An update the optimizer skips (a non-finite gradient, the
   JAX package's non-finite skip) is redone on the same weights and batch
   through the plain versions on the card, whose loss must agree and whose
   gradient must be non-finite too, or else, redone through the kernels,
   the first non-finite value must appear in the backward of an op that is
   not a kernel's: with random weights the bf16 adaptive step meets a
   non-finite gradient now and then on ``bench.py``'s batch, where a point
   lands at a source-view camera depth of exactly 0 (``-xy / z``), on one
   side or on both (``train_skip_probe.py`` counts such steps).  The
   one-chunk and 8-chunk VR steps from the same weights give the same loss
   and gradients up to summation order; the bf16 adaptive step run twice on
   one batch is reported (the worst relative L2 of the encoder's, the
   decoders' and the march's gradients), and the float32 one held to it:
   its decoders' and march's gradients bit for bit (cuDNN's encoder
   backward reported), with its kernel launches.
   ``--profile`` traces a frame of every renderer and a train step of
   every path.
5. Reference: small float32 renders of every renderer and train steps
   (adaptive, its fused path, and VR; the adaptive one also with the legacy
   key stream) through the kernels on the card, against the plain path on
   the CPU (and, for the gradients, the plain versions on the card).

Prints the kernel table as one JSON line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``; every case in full
goes to ``DIR/chip_smoke_report.json`` (default ``traces/``), with the
profiles' chrome traces.

    python3 chip_smoke.py --march-draws=N

runs only K3's bf16 10-step backward over N input draws at two step heads
(``march_draws``: how the comparison depends on its draw) and prints one
JSON line per draw and head.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from avr_tpu_torch.data.device import build_device_dataset, make_device_sampler
from avr_tpu_torch.data.synthetic import synthetic_scene_set
from avr_tpu_torch.evaluation import generate_video, render_full_image
from avr_tpu_torch.models.wrapper import bench_weights, make_model
from avr_tpu_torch.ops import threefry
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.ops.kernels import integrate as K4
from avr_tpu_torch.ops.kernels import resnetfc as K2
from avr_tpu_torch.ops.kernels import rng as K7
from avr_tpu_torch.ops.kernels.gather import (gather_bilinear, gather_bilinear_plain,
                                              gather_bilinear_projected,
                                              gather_bilinear_projected_plain, project_packed)
from avr_tpu_torch.ops.kernels import march as K3
from avr_tpu_torch.ops.kernels.march import (fused_lstm_march, lstm_march_plain,
                                             pack_projection)
from avr_tpu_torch.ops.integrate import volume_integral
from avr_tpu_torch.ops.kernels.resnetfc import (CodeSpec, DecoderWeights, fused_resnetfc,
                                                resnetfc_plain)
from avr_tpu_torch.profiling.wgrad_timing import SMI_FIELDS, reasons_field, sustained
from avr_tpu_torch.training import (LossParams, create_train_state, make_optimizer,
                                    make_train_step)
from avr_tpu_torch.training.step import make_chunked_call_train_step
from avr_tpu_torch.training.step import loss_and_grads
from avr_tpu_torch.utils.geometry import get_world_rays, orbit_cam2world, pixel_grid

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12  # dense tensor-core peak
F32_FLOPS = 67e12  # outside the tensor cores
# int32 operations outside the tensor cores: 132 SMs x 64 INT32 lanes x
# 1.98 GHz, half the float32 lanes of the 67 TFLOP/s (which counts an FMA as 2)
INT32_OPS = 132 * 64 * 1.98e9
SIDE, LATENT, C = 128, 64, 512
BAND, CHUNK, STEPS, HIDDEN = 81_920, 4_096, 10, 16
FINE_CHUNK = 96 * CHUNK  # decoder points of the VR's fine pass over one 4,096-ray chunk
CODE = CodeSpec(num_freqs=6, freq_factor=1.5, include_input=True, d_coded=3, d_pass=3)
DEV = torch.device("cuda")


def time_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters=20):
    """Host ms of one call of ``fn``: the median wall time until it returns,
    each call on an idle card (its kernels are launched asynchronously, so
    this is the wrapper's Python, its ctypes call and the launches)."""
    fn()
    ts = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(ts))


def call_timing(fn, device_ms, iters=10):
    """A wrapper's host cost beside its kernels' device time: ``host_ms``
    (:func:`host_ms`), ``call_ms`` (back-to-back calls, CUDA events) and
    ``call_ms - device_ms``."""
    call = time_ms(fn, iters=iters)
    return dict(host_ms=host_ms(fn), call_ms=call, call_minus_device_ms=call - device_ms)


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def bound(bytes_, flops, peak):
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(name, err, tol, against="plain"):
    """One comparison of a kernel's output (``against`` its plain version,
    or a PyTorch library call computing the same function)."""
    if not err <= tol:  # also catches NaN
        raise AssertionError(f"{name}: max abs error {err} > tolerance {tol}")
    return {"case": name, "against": against, "max_abs_err": err, "tol": tol}


def randn(gen, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(*shape, generator=gen, device=DEV) * scale).to(dtype)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_gather(gen):
    feat = randn(gen, 1, LATENT, LATENT, C, dtype=torch.bfloat16)
    cases = []
    for n in (BAND, CHUNK, FINE_CHUNK):
        # [-1.1, 1.1]: interior taps, the border clamp and out-of-range points
        coords = (torch.rand(1, n, 2, generator=gen, device=DEV) * 2.2 - 1.1).contiguous()
        # bitwise equal by construction (same rounded ops in the same order);
        # the tolerance allows one bf16 rounding flip of a value of ~4
        got, want = gather_bilinear(feat, coords), gather_bilinear_plain(feat, coords)
        cases.append(dict(check(f"N={n} bf16", max_err(got, want), 2e-2),
                          bitwise=same_bits(got, want)))
    coords_band = (torch.rand(1, BAND, 2, generator=gen, device=DEV) * 2.2 - 1.1).contiguous()
    # ms: back-to-back calls (CUDA events), as every earlier slice timed K1;
    # device_ms beside it: the kernel's device time (torch.profiler)
    run = lambda: gather_bilinear(feat, coords_band)
    ms = time_ms(run)
    device_ms = kernel_device_ms(run, (K1_FWD_KERNEL,), iters=20)[K1_FWD_KERNEL]
    plain_ms = time_ms(lambda: gather_bilinear_plain(feat, coords_band))
    # grid_sample wants the map and grid in one dtype: the same bf16 values in f32
    nchw, grid = feat.permute(0, 3, 1, 2).float(), coords_band[:, None]
    lib = F.grid_sample(nchw, grid, mode="bilinear", padding_mode="border", align_corners=True)
    cases.append(check("F.grid_sample agrees", max_err(lib[:, :, 0].transpose(1, 2),
                                                       gather_bilinear(feat, coords_band)), 2e-2,
                       against="library"))
    library_ms = time_ms(lambda: F.grid_sample(nchw, grid, mode="bilinear",
                                               padding_mode="border", align_corners=True))
    b_ms, b_by = bound(feat.numel() * 2 + BAND * 2 * 4 + BAND * C * 2, 8 * BAND * C, F32_FLOPS)
    return dict(name="gather_bilinear", source="avr_tpu_torch/csrc/gather.cu",
                replaces="avr_tpu/ops/pallas/gather.py:395",
                also_replaces="avr_tpu/ops/pallas/gather.py:164",
                tpu_kernel="gather_bilinear_windowed (K1) and gather_bilinear (K6), one function",
                shape=f"latent 1x{LATENT}x{LATENT}x{C} bf16, N={BAND}", cases=cases,
                ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=b_ms, bound_by=b_by)


def decoder_weights(gen, dtype=torch.float32, dh=512, nb=5, nlz=3, code=CODE, dl=C):
    lin = lambda o, i: randn(gen, o, i, scale=i ** -0.5)
    return DecoderWeights(
        lin(dh, code.d_enc), randn(gen, dh, scale=0.1),
        torch.stack([lin(dh, dl) for _ in range(nlz)]), randn(gen, nlz, dh, scale=0.1),
        torch.stack([lin(dh, dh) for _ in range(nb)]), randn(gen, nb, dh, scale=0.1),
        torch.stack([lin(dh, dh) for _ in range(nb)]), randn(gen, nb, dh, scale=0.1),
        lin(4, dh), randn(gen, 4, scale=0.1))


def decoder_flops(n, ns, dh=512, nb=5, nlz=3):
    return 2 * n * (ns * (CODE.d_enc * dh + nlz * C * dh + 2 * nlz * dh * dh)
                    + 2 * (nb - nlz) * dh * dh + dh * 4)


def mma_sync_forward(args, dims, stash):
    """The parent's bf16 forward (``csrc/resnetfc.cu``'s 32-point
    ``mma.sync`` kernel, which forward_route keeps for bf16 shapes outside
    the wgmma kernel's envelope) through its C entry point: the wgmma
    forward's in-run timing reference, not counted as a launch."""
    n = dims["N"]
    out = torch.empty((n, dims["d_out"]), dtype=torch.float32, device=DEV)
    st = (torch.empty((K2.stash_slots(dims["ns"], dims["n_blocks"], dims["n_lin_z"]), n,
                       dims["d_hidden"]), dtype=torch.bfloat16, device=DEV) if stash else None)
    fn = _build.kernel_fn("avr_resnetfc", K2.FWD_ARGTYPES)
    err = fn(*(_build.ptr(args[k]) for k in K2._FWD_ORDER), _build.ptr(out),
             _build.ptr(st) if stash else None, *(dims[k] for k in K2._DIM_ORDER), 1,
             _build.stream_ptr(DEV))
    if err:
        raise RuntimeError(f"avr_resnetfc (mma.sync reference): cudaError {err}")
    return out, st


def alternate(calls, seconds=1.0):
    """Each of ``calls`` (label -> function) in loops of about ``seconds``,
    in turns (a b b a a b): per reading ms a call (CUDA events) with the SM
    clock, power draw and clock-event reasons that ``nvidia-smi`` sampled
    meanwhile (``profiling/wgrad_timing.py sustained``), and per label the
    median ms and clock.  Two kernels compare only within one such run: the
    700 W cap moves the SM clock between runs (PERF.md §6)."""
    reasons = reasons_field()
    fields = SMI_FIELDS + (f",{reasons}" if reasons else "")
    a, b = list(calls)
    readings = []
    for label in (a, b, b, a, a, b):
        readings.append(dict(label=label, **sustained(calls[label], seconds, fields)))
    med = {lab: {k: float(np.median([r[k] for r in readings
                                     if r["label"] == lab and r[k] is not None]))
                 for k in ("ms", "clocks.sm", "power.draw")} for lab in calls}
    return dict(readings=readings, median=med)


def check_resnetfc(gen, gen_new):
    """K2's forward; ``gen_new`` draws the inputs of the cases added with the
    wgmma forward, so that ``gen`` gives every other check the inputs it
    had before them."""
    w = decoder_weights(gen)
    kw = dict(n_blocks=5, n_lin_z=3, code=CODE, activate_out=True)
    cases = []
    # (points, views, operand dtype, tolerance and why)
    for n, ns, cd, rel in (
        # bf16 operands: 13 activations rounded to bf16 on both sides, and
        # sums in another order decide some roundings differently; an
        # output moves by up to ~1 bf16 ulp (2^-8) of its scale, and sigma
        # reaches ~7 with these weights: allow 2 ulps of the largest output
        (BAND, 1, torch.bfloat16, 2.0 ** -7),
        (FINE_CHUNK, 1, torch.bfloat16, 2.0 ** -7),
        (CHUNK, 2, torch.bfloat16, 2.0 ** -7),
        # f32 operands: FMA order against cuBLAS over 13 chained products
        (CHUNK, 1, torch.float32, 1e-4),
        # off the 64-point tile: the last CTA's rows past N
        (CHUNK + 37, 1, torch.bfloat16, 2.0 ** -7),
        (CHUNK + 37, 2, torch.bfloat16, 2.0 ** -7),
    ):
        gn = gen if n % 64 == 0 else gen_new
        x = (torch.rand(ns, n, CODE.d_raw, generator=gn, device=DEV) * 2 - 1).contiguous()
        z = randn(gn, ns, n, C, dtype=cd)
        got = fused_resnetfc(x, z, w, compute_dtype=cd, **kw)
        want = resnetfc_plain(x, z, w, compute_dtype=cd, **kw)
        tol = rel * max(1.0, float(want.abs().max()))
        cases.append(check(f"N={n} NS={ns} {str(cd)[6:]}", max_err(got, want), tol))
    cases += check_resnetfc_mma_sync(gen_new)
    bf = torch.bfloat16
    x = (torch.rand(1, BAND, CODE.d_raw, generator=gen, device=DEV) * 2 - 1).contiguous()
    z = randn(gen, 1, BAND, C, dtype=bf)
    run = lambda f: f(x, z, w, compute_dtype=bf, **kw)
    ms, plain_ms = time_ms(lambda: run(fused_resnetfc)), time_ms(lambda: run(resnetfc_plain))
    wbytes = sum(t.numel() for t in w) * 2
    b_ms, b_by = bound(x.numel() * 4 + z.numel() * 2 + wbytes + BAND * 4 * 4,
                       decoder_flops(BAND, 1), BF16_FLOPS)
    # the wgmma forward against the parent's mma.sync forward, in turns in
    # this run: serving at the band chunk, and the stash forward at the band
    # call of a train step
    args = K2._prepare(x, z, w, CODE, bf)
    dims = K2._dims(args, 5, 3, True)
    vs_parent = {"serve N=81920": alternate({
        "wgmma": lambda: K2._forward(args, dims, bf, False),
        "mma_sync": lambda: mma_sync_forward(args, dims, False)})}
    xs = torch.rand(1, BAND_TRAIN, CODE.d_raw, generator=gen_new, device=DEV) * 2 - 1
    sargs = K2._prepare(xs, randn(gen_new, 1, BAND_TRAIN, C, dtype=bf), w, CODE, bf)
    sdims = K2._dims(sargs, 5, 3, True)
    vs_parent["stash N=327680"] = alternate({
        "wgmma": lambda: K2._forward(sargs, sdims, bf, True),
        "mma_sync": lambda: mma_sync_forward(sargs, sdims, True)})
    stash_ms = kernel_device_ms(lambda: K2._forward(sargs, sdims, bf, True), (FWD_KERNEL,))
    del sargs
    # the stash forward's least time: its products, or its 11 stash rows of
    # 512 bf16 a point written with the inputs read
    act = BAND_TRAIN * 512 * 2
    sb_ms, sb_by = bound(xs.numel() * 4 + BAND_TRAIN * C * 2 + wbytes + BAND_TRAIN * 4 * 4
                         + K2.stash_slots(1, 5, 3) * act, decoder_flops(BAND_TRAIN, 1), BF16_FLOPS)
    for label, r in vs_parent.items():
        m = r["median"]
        print(f"K2 forward {label}: wgmma {m['wgmma']['ms']:.4f} ms, mma.sync "
              f"{m['mma_sync']['ms']:.4f} ms (medians of 3 loops each, in turns; SM clock "
              f"{m['wgmma']['clocks.sm']:.0f} / {m['mma_sync']['clocks.sm']:.0f} MHz, power "
              f"{m['wgmma']['power.draw']:.0f} / {m['mma_sync']['power.draw']:.0f} W)")
    return dict(name="fused_resnetfc", source="avr_tpu_torch/csrc/resnetfc_hopper.cu",
                replaces="avr_tpu/ops/pallas/resnetfc.py:896", tpu_kernel="fused_resnetfc",
                shape=f"N={BAND}, NS=1, d_hidden 512, 5 blocks, bf16", cases=cases,
                ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                stash_ms=stash_ms[FWD_KERNEL], stash_bound_ms=sb_ms, stash_bound_by=sb_by,
                vs_mma_sync=vs_parent)


# bf16 beyond the wgmma forward's 512 latent or encoded input lanes:
# forward_route keeps these on csrc/resnetfc.cu's mma.sync kernel.  A latent
# of 1,024 (an encoder of 5 stages: 64 + 64 + 128 + 256 + 512), and 547
# encoded lanes (8 frequencies of 32 coded lanes with the input, 3 passed
# through: padded to 576).
WIDE_CODE = CodeSpec(num_freqs=8, freq_factor=1.5, include_input=True, d_coded=32, d_pass=3)
MMA_SYNC_CASES = ((CODE, 1024, 2), (WIDE_CODE, C, 1))


def check_resnetfc_mma_sync(gen):
    """K2's bf16 mma.sync forward through fused_resnetfc at the shapes
    forward_route sends it, against the plain version at the bf16 cases'
    2^-7 of the largest output; the wgmma forward must not have run."""
    bf, kw, cases = torch.bfloat16, dict(n_blocks=5, n_lin_z=3, activate_out=True), []
    for code, dl, ns in MMA_SYNC_CASES:
        k_in = K2.d_enc_padded(code.d_enc)
        route = K2.forward_route(bf, dl, k_in)
        if route != "mma_sync":
            raise AssertionError(f"K2 d_latent {dl}, {k_in} encoded lanes: routed to {route}")
        w = decoder_weights(gen, code=code, dl=dl)
        x = (torch.rand(ns, CHUNK + 37, code.d_raw, generator=gen, device=DEV) * 2 - 1)
        z = randn(gen, ns, CHUNK + 37, dl, dtype=bf)
        before = dict(_build.launches)
        got = fused_resnetfc(x.contiguous(), z, w, compute_dtype=bf, code=code, **kw)
        ran = {k: _build.launches[k] - before.get(k, 0) for k in (K2.NAME, K2.NAME_WGMMA)}
        if ran != {K2.NAME: 1, K2.NAME_WGMMA: 0}:
            raise AssertionError(f"K2 d_latent {dl}, {k_in} encoded lanes: launches {ran}, "
                                 f"not the mma.sync forward once")
        want = resnetfc_plain(x, z, w, compute_dtype=bf, code=code, **kw)
        tol = 2.0 ** -7 * max(1.0, float(want.abs().max()))
        cases.append(check(f"mma.sync route d_latent {dl} k_in {k_in} N={CHUNK + 37} NS={ns} "
                           f"bf16", max_err(got, want), tol))
    return cases


# The stash of the wgmma forward against the plain forward's post-ReLU
# activations (decoder_plain_stash), slot by slot.  Each slot is a bf16
# rounding of an activation whose inputs both sides round at the same
# points but sum in other orders, so an element moves by a bf16 ulp or two
# of its slot's scale, as the output does: 2^-7 of the slot's largest value.
# A ReLU mask flips only where a pre-activation lies within that rounding
# noise of zero: "a fraction of a percent" (check_resnetfc_bwd): bounded at
# 1%.  A slot written to the wrong place, or rows written to the wrong
# points, moves whole rows by their full size.  N is off the 64-point tile.
STASH_REL, STASH_FLIPS = 2.0 ** -7, 1e-2


def check_resnetfc_stash(gen):
    w = decoder_weights(gen)
    cd, kw, cases = torch.bfloat16, dict(n_blocks=5, n_lin_z=3, code=CODE), []
    for n, ns in ((SB_TRAIN * CHUNK + 37, 1), (CHUNK + 37, 2)):
        x = (torch.rand(ns, n, CODE.d_raw, generator=gen, device=DEV) * 2 - 1).contiguous()
        z = randn(gen, ns, n, C, dtype=cd)
        args = K2._prepare(x, z, w, CODE, cd)
        st = K2._forward(args, K2._dims(args, 5, 3, True), cd, True)[1]
        pst = decoder_plain_stash(x, z, w, compute_dtype=cd, **kw)
        for i in range(len(pst)):
            scale = float(pst[i].abs().max())
            cases.append(check(f"stash slot {i} N={n} NS={ns}", max_err(st[i], pst[i]),
                               STASH_REL * max(scale, 1e-30), against="plain stash"))
        flips = float(((st > 0) != (pst > 0)).float().mean())
        if not flips <= STASH_FLIPS:
            raise AssertionError(f"K2 stash N={n} NS={ns}: {flips} of the ReLU masks flipped "
                                 f"> {STASH_FLIPS}")
        cases.append({"case": f"stash ReLU mask flips N={n} NS={ns}", "against": "plain forward",
                      "flip_fraction": flips, "bound": STASH_FLIPS})
        worst = max(c["max_abs_err"] / c["tol"] for c in cases if c["case"].endswith(f"NS={ns}")
                    and "slot" in c["case"])
        print(f"K2 stash N={n} NS={ns}: worst slot at {worst:.3f} of its bound, ReLU mask flips "
              f"{flips:.3e}")
        del st, pst
    return cases


def march_inputs(gen, ns, dtype=torch.bfloat16, sb=1, w_out_scale=0.05, hidden=HIDDEN):
    """Rays of a 128x128 camera at z = 1.3 looking at the origin (the same
    4,096 rays in each of ``sb`` scenes); the source views are that camera,
    rotated about its axis.  The rays are jittered off the pixel centres and
    no source view is the ray camera itself: otherwise every march point
    projects exactly onto a latent pixel, where the bilinear taps and the
    border mask switch, and two correct implementations round onto
    different sides of that edge.  ``w_out_scale`` sets the step head's
    size, and with it how far a step moves with the latent it reads;
    ``hidden`` the LSTM's width (the step head scaled by 1/sqrt(hidden / 16)
    so the step keeps its size)."""
    c2w = torch.diag(torch.tensor([1.0, -1.0, -1.0, 1.0]))
    c2w[2, 3] = 1.3
    K = torch.tensor([[1.09375, 0, 0.5], [0, 1.09375, 0.5], [0, 0, 1]])
    side = int(round(CHUNK ** 0.5))
    jitter = torch.rand(1, CHUNK, 2, generator=torch.Generator().manual_seed(2)) - 0.5
    xy = torch.from_numpy(pixel_grid(side, side).reshape(1, CHUNK, 2)) + 0.5 * jitter / side
    ros, rds = get_world_rays(xy, K[None], c2w.expand(1, CHUNK, 4, 4))
    d0 = 0.8 + 0.05 * torch.randn(1, CHUNK, 1, generator=torch.Generator().manual_seed(1))
    poses = []
    for v in range(ns):
        a = 0.05 + 0.1 * v
        rot = torch.tensor([[np.cos(a), -np.sin(a), 0, 0], [np.sin(a), np.cos(a), 0, 0],
                            [0, 0, 1, 0], [0, 0, 0, 1]], dtype=torch.float32)
        src = c2w @ rot
        w2c_rot = src[:3, :3].T
        poses.append(torch.cat([w2c_rot, (-w2c_rot @ src[:3, 3])[:, None]], dim=1))
    focal = torch.tensor([[1.09375 * SIDE, -1.09375 * SIDE]])
    proj = pack_projection(torch.stack(poses), focal, torch.tensor([[SIDE / 2, SIDE / 2]]),
                           torch.tensor([2 * LATENT / (LATENT - 1)] * 2),
                           torch.tensor([float(SIDE)] * 2)).reshape(1, ns, 16)
    H4 = 4 * hidden
    rep = lambda t: t.expand(sb, *t.shape[1:]).to(DEV).contiguous()
    return dict(proj=rep(proj), coords0=rep(ros + rds * d0), rds=rep(rds),
                feat=randn(gen, sb, ns, LATENT, LATENT, C, dtype=dtype),
                w_ih=randn(gen, C, H4, scale=C ** -0.5),
                w_hh=randn(gen, hidden, H4, scale=0.25 * (16 / hidden) ** 0.5),
                bias=randn(gen, H4, scale=0.1),
                w_out=randn(gen, hidden, 1, scale=w_out_scale * (16 / hidden) ** 0.5),
                b_out=randn(gen, 1, scale=0.01))


# K3's kernels by route (csrc/march.cu): bf16 marches 16-ray tiles on the
# tensor cores, its backward's latent cotangent through K5's bins (the
# march's own instantiation, <true, true>: projected points shared by the
# views); float32 keeps the warp-per-ray kernels, its backward's latent
# cotangent through the same bins' float32 accumulate
K3_FWD_KERNELS = ("lstm_march_tile_kernel",)
K3_BINS = ("gather_bin_count_kernel<true, true>", "gather_bin_scan_kernel",
           "gather_bin_plan_kernel", "gather_bin_scatter_kernel<true, true>",
           "gather_bin_reduce_kernel")
K3_BWD_KERNELS = ("lstm_march_tile_bwd_kernel", "lstm_march_partials_kernel",
                  "gather_bin_mma_kernel<true, true>") + K3_BINS
K3_F32_KERNELS = ("lstm_march_kernel", "lstm_march_bwd_kernel")
K3_F32_BWD_KERNELS = ("lstm_march_bwd_kernel", "lstm_march_partials_kernel",
                      "gather_bin_accum_kernel<true, true>") + K3_BINS
# the float32 wgrad (csrc/resnetfc.cu) and its reduction (the bf16 wgrad's)
WGRAD_F32_KERNELS = ("resnetfc_wgrad_f32_kernel", "resnetfc_wgrad_reduce_kernel")


@contextlib.contextmanager
def march_routed(cd, backward=False):
    """Runs one K3 call (and, with ``backward``, its backward) and fails
    unless the route's counters moved: bf16 the tile kernels'
    (``NAME_TILES``, ``NAME_BWD_TILES``) with the wrapper's, float32 the
    wrapper's alone."""
    names = (K3.NAME, K3.NAME_TILES) + ((K3.NAME_BWD, K3.NAME_BWD_TILES) if backward else ())
    before = {n: _build.launches.get(n, 0) for n in names}
    yield
    ran = {n: _build.launches.get(n, 0) - before[n] for n in names}
    tiles = int(cd == torch.bfloat16)
    want = {K3.NAME: 1, K3.NAME_TILES: tiles}
    if backward:
        want.update({K3.NAME_BWD: 1, K3.NAME_BWD_TILES: tiles})
    if ran != want:
        raise AssertionError(f"K3 {str(cd)[6:]}: launches {ran}, expected {want}")


def march_fwd_bytes(rays, steps, hid, feat_bytes, save):
    """The forward's own bytes: the latent, the rays' points and directions
    in, the final points out, the weights; with ``save`` the saved rows."""
    rows = rays * steps * K3.aux_width(hid) * 4 if save else 0
    return feat_bytes + rays * 3 * 4 * 3 + C * 4 * hid * 2 + rows


def check_march(gen):
    cases = []
    # (views, steps, early-stop eps, hidden, tolerance and why)
    for ns, steps, eps, hid, tol in (
        # 2 steps: gate sums in another order and one-ulp transcendental
        # differences, through a bf16-rounded hidden state (2^-8 relative)
        (1, 2, 0.0, HIDDEN, 1e-3), (2, 2, 0.0, HIDDEN, 1e-3), (1, 2, 0.02, HIDDEN, 1e-3),
        # hidden 62 (the widest the TPU kernel takes): four 16-unit groups,
        # W_ih's fragments read from L2; the same differences
        (1, 2, 0.0, 62, 1e-3),
        # 10 steps: the same differences carried through 8 more steps
        (1, STEPS, 0.0, HIDDEN, 5e-3),
    ):
        inp = march_inputs(gen, ns, hidden=hid)
        with march_routed(torch.bfloat16):
            got = fused_lstm_march(**inp, steps=steps, early_stop_eps=eps,
                                   compute_dtype=torch.bfloat16)
        want = lstm_march_plain(**inp, steps=steps, early_stop_eps=eps,
                                compute_dtype=torch.bfloat16)
        if not torch.isfinite(got).all():
            raise AssertionError(f"march NS={ns} steps={steps}: non-finite output")
        cases.append(check(f"R={CHUNK} NS={ns} steps={steps} eps={eps} hidden {hid}",
                           max_err(got, want), tol))
    inp = march_inputs(gen, 1)
    kw = dict(steps=STEPS, compute_dtype=torch.bfloat16)
    run = lambda: fused_lstm_march(**inp, **kw)
    cases.append(check_rerun("rerun forward", [run()], [run()]))
    ms = time_ms(run)
    plain_ms = time_ms(lambda: lstm_march_plain(**inp, **kw))
    device = kernel_device_ms(run, K3_FWD_KERNELS)
    host = host_ms(run)  # the wrapper's host time, its weight fragments kept
    # the wrapper keeps W_ih's and W_hh's fragments per weight: a weight
    # changed in place after a call reaches the next (its own generator, so
    # the later checks keep their inputs)
    ch = march_inputs(torch.Generator(device=DEV).manual_seed(5), 1)
    kw2 = dict(steps=2, compute_dtype=torch.bfloat16)
    fused_lstm_march(**ch, **kw2)
    for k in ("w_ih", "w_hh"):
        ch[k].neg_()
        cases.append(check(f"{k} changed in place after a call",
                           max_err(fused_lstm_march(**ch, **kw2), lstm_march_plain(**ch, **kw2)),
                           1e-3))
    smi = sustained(run, 1.0, SMI_FIELDS)  # the SM clock and power beside the time
    flops = CHUNK * STEPS * (8 * C + 2 * C * 4 * HIDDEN + 2 * HIDDEN * 4 * HIDDEN + 2 * HIDDEN)
    b_ms, b_by = bound(march_fwd_bytes(CHUNK, STEPS, HIDDEN, inp["feat"].numel() * 2, False),
                       flops, BF16_FLOPS)
    # the train step's call: 4 scenes, under autograd (the saved rows); drawn
    # from a generator of its own, so the later checks keep their inputs
    tr = march_inputs(torch.Generator(device=DEV).manual_seed(3), 1, sb=SB_TRAIN,
                      w_out_scale=TIMED_HEAD)
    leaves = {k: v.requires_grad_(True) if k != "proj" else v for k, v in tr.items()}
    run_saved = lambda: fused_lstm_march(**leaves, **kw)
    cases.append(check_rerun("rerun forward with the saved rows", [run_saved().detach()],
                             [run_saved().detach()]))
    saved = kernel_device_ms(run_saved, K3_FWD_KERNELS)
    saved_smi = sustained(run_saved, 1.0, SMI_FIELDS)
    saved_b = bound(march_fwd_bytes(SB_TRAIN * CHUNK, STEPS, HIDDEN, tr["feat"].numel() * 2,
                                    True), SB_TRAIN * flops, BF16_FLOPS)
    # the kept float32 route (warp per ray) at the serving shape
    f32 = {k: (v.float() if v.is_floating_point() else v) for k, v in inp.items()}
    kw32 = dict(steps=STEPS, compute_dtype=torch.float32)
    with march_routed(torch.float32):
        fused_lstm_march(**f32, **kw32)
    run32 = lambda: fused_lstm_march(**f32, **kw32)
    kept = dict(kernel=K3_F32_KERNELS[0], ms=time_ms(run32),
                device_ms=kernel_device_ms(run32, K3_F32_KERNELS[:1])[K3_F32_KERNELS[0]],
                plain_ms=time_ms(lambda: lstm_march_plain(**f32, **kw32)),
                bound_ms=bound(march_fwd_bytes(CHUNK, STEPS, HIDDEN, inp["feat"].numel() * 4,
                                               False), flops, F32_FLOPS)[0], library_ms=None)
    print(f"K3 forward: serve R={CHUNK} {device[K3_FWD_KERNELS[0]]:.4f} device ms (call {ms:.4f}, "
          f"host {host:.4f}, "
          f"SM {smi['clocks.sm']} MHz, {smi['power.draw']} W); train {SB_TRAIN}x{CHUNK} with "
          f"the saved rows {saved[K3_FWD_KERNELS[0]]:.4f} device ms (SM "
          f"{saved_smi['clocks.sm']} MHz); float32 warp kernel {kept['device_ms']:.4f}")
    return dict(name="fused_lstm_march", source="avr_tpu_torch/csrc/march.cu",
                replaces="avr_tpu/ops/pallas/march.py:703", tpu_kernel="fused_lstm_march",
                kernel=K3_FWD_KERNELS[0],
                shape=f"R={CHUNK} x {STEPS} steps, NS=1, C={C}, hidden {HIDDEN}, bf16",
                cases=cases, ms=device[K3_FWD_KERNELS[0]], call_ms=ms, host_ms=host, sustained=smi,
                plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                saved_rows=dict(shape=f"{SB_TRAIN}x{CHUNK} rays, under autograd",
                                device_ms=saved[K3_FWD_KERNELS[0]], sustained=saved_smi,
                                bound_ms=saved_b[0], bound_by=saved_b[1]),
                kept_f32=kept)


# ---------------------------------------------------------------------------
# phase 2b: backward kernels against the plain versions' autograd, at the
# train step's shapes (4 scenes x 4,096 rays, 20 band samples a ray)
# ---------------------------------------------------------------------------

SB_TRAIN = 4
BAND_TRAIN = SB_TRAIN * BAND  # decoder points of the band query in one step


def grads_of(fn, inputs, g, keep=False):
    """Gradients of ``<fn(*inputs), g>`` w.r.t. every input; with ``keep``
    also a closure that runs the same backward again (for timing)."""
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, g, retain_graph=keep)
    if not keep:
        return grads
    return grads, lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def check_rel(name, got, want, rel, against="plain"):
    """A gradient against the plain version's: max abs error within ``rel``
    of the plain gradient's largest magnitude."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel gradient")
    scale = float(want.float().abs().max())
    return check(name, max_err(got, want), rel * max(scale, 1e-30), against)


def check_l2(name, got, want, tol, against="plain"):
    """A gradient against the plain version's by relative L2 error
    ``|got - want| / |want|``.  Used where a ReLU mask or a bilinear tap can
    flip between two correct implementations (an activation within rounding
    of zero): one flipped element moves one point's gradient by its full
    size, which a max-abs bound cannot tell from a fault, while the L2 error
    stays at the rounding level.  The max abs error is reported beside it."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel gradient")
    a, b = got.float(), want.float()
    rel_l2 = float((a - b).norm() / b.norm().clamp_min(1e-30))
    if not rel_l2 <= tol:
        raise AssertionError(f"{name}: relative L2 error {rel_l2} > tolerance {tol}")
    return {"case": name, "against": against, "max_abs_err": max_err(a, b), "rel_l2": rel_l2,
            "tol": tol}


# K2's bf16 forward, and its backward kernels (csrc/resnetfc_hopper.cu): the
# dgrad's walk and tail, the wgrad's wgmma kernel and its reduction
FWD_KERNEL = "resnetfc_fwd_wgmma_kernel"  # K2's bf16 forward (csrc/resnetfc_hopper.cu)
DGRAD_KERNELS = ("resnetfc_dgrad_walk_kernel", "resnetfc_dgrad_tail_kernel")
WGRAD_KERNELS = ("resnetfc_wgrad_wgmma_kernel", "resnetfc_wgrad_reduce_kernel")
K2_BWD_KERNELS = DGRAD_KERNELS + WGRAD_KERNELS


def kernel_device_ms(fn, names, iters=5):
    """Device ms per call of each named CUDA kernel that ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in prof.key_averages() if e.device_type == cuda]
    return {n: sum(e.self_device_time_total for e in rows if n in e.key) / 1e3 / iters
            for n in names}


# K1's and K5's backward (csrc/gather.cu): the front pass (the coordinate
# cotangent) and the binned accumulation of dfeat: the sort's count, scan,
# plan and scatter, the accumulate (bf16: mma; float32: shared memory) and
# the reduce
GATHER_BIN_KERNELS = ("gather_bin_count_kernel", "gather_bin_scan_kernel",
                      "gather_bin_plan_kernel", "gather_bin_scatter_kernel",
                      "gather_bin_mma_kernel", "gather_bin_accum_kernel",
                      "gather_bin_reduce_kernel")
# K1's and K5's forward (csrc/gather.cu): one tiled kernel, K1's
# instantiation <false, ...>, K5's <true, ...>
GATHER_FWD_KERNEL = "gather_fwd_tile_kernel"
K1_FWD_KERNEL, K5_FWD_KERNEL = GATHER_FWD_KERNEL + "<false", GATHER_FWD_KERNEL + "<true"
K1_BWD_KERNELS = ("gather_bilinear_bwd_kernel",) + GATHER_BIN_KERNELS
K5_BWD_KERNELS = ("gather_projected_bwd_kernel",) + GATHER_BIN_KERNELS


def gather_bwd_bytes(pts, hwc, elt, pt_bytes):
    """The gather backward's own bytes: g and the map in, dfeat out in the
    map's dtype (``elt`` bytes), and ``pt_bytes`` a point of coordinates in
    and their cotangent out."""
    return pts * C * elt + 2 * hwc * elt + pts * pt_bytes


def bwd_device_ms(run, names):
    """Device ms per call of a backward, in all and by kernel."""
    by = kernel_device_ms(run, names)
    return sum(by.values()), by


def check_rerun(name, first, again):
    """A backward run twice on the same inputs: bit for bit equal outputs."""
    for a, b in zip(first, again):
        if not same_bits(a, b):
            raise AssertionError(f"{name}: a second backward differs (max abs "
                                 f"{max_err(a, b)})")
    return {"case": name, "against": "rerun", "max_abs_err": 0.0, "tol": 0.0}


def no_host_sync(fn):
    """``fn()`` with a copy to the host made an error."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def check_gather_bwd(gen):
    feat = randn(gen, SB_TRAIN, LATENT, LATENT, C, dtype=torch.bfloat16)
    cases = []
    for n in (BAND, CHUNK, FINE_CHUNK):  # per scene: the band, coarse and VR fine queries
        coords = torch.rand(SB_TRAIN, n, 2, generator=gen, device=DEV) * 2.2 - 1.1
        g = randn(gen, SB_TRAIN, n, C, dtype=torch.bfloat16)
        got = grads_of(gather_bilinear, (feat, coords), g)
        want = grads_of(gather_bilinear_plain, (feat, coords), g)
        # dfeat: the kernel rounds the tap weight to bf16 before w * g (as
        # the TPU kernel does), the plain version does not, and the float32
        # sums run in another order; both round the sum to bf16 once: 2 bf16
        # ulps of the largest value.  dcoords: float32 dots of 512 products
        # in another order, times 31.5: 1e-4 of the largest value.
        cases.append(check_rel(f"dfeat N={n} bf16", got[0], want[0], 2.0 ** -7))
        cases.append(check_rel(f"dcoords N={n} bf16", got[1], want[1], 1e-4))
        cases.append(check_rerun(f"rerun N={n} bf16", got,
                                 grads_of(gather_bilinear, (feat, coords), g)))
    coords = torch.rand(SB_TRAIN, BAND, 2, generator=gen, device=DEV) * 2.2 - 1.1
    g = randn(gen, SB_TRAIN, BAND, C, dtype=torch.bfloat16)
    _, run = grads_of(gather_bilinear, (feat, coords), g, keep=True)
    _, run_plain = grads_of(gather_bilinear_plain, (feat, coords), g, keep=True)
    nchw = feat.permute(0, 3, 1, 2).float()
    _, run_lib = grads_of(lambda f, c: F.grid_sample(f, c[:, None], mode="bilinear",
                                                     padding_mode="border", align_corners=True),
                          (nchw, coords), g.float().permute(0, 2, 1)[:, :, None], keep=True)
    ms, plain_ms, library_ms = time_ms(run), time_ms(run_plain), time_ms(run_lib)
    device_ms, by_kernel = bwd_device_ms(run, K1_BWD_KERNELS)
    smi = sustained(run, 1.0, SMI_FIELDS)  # the SM clock and power beside the time
    n_pts, hwc = SB_TRAIN * BAND, feat.numel()
    # the function's own bytes: dfeat written once in bf16 (the parent's
    # kernel also zeroed and wrote a float32 map: 2 * hwc * 4 more)
    b_ms, b_by = bound(gather_bwd_bytes(n_pts, hwc, 2, 16), 16 * n_pts * C, F32_FLOPS)
    return dict(name="gather_bilinear_bwd", source="avr_tpu_torch/csrc/gather.cu",
                replaces="avr_tpu/ops/pallas/gather.py:463",
                also_replaces="avr_tpu/ops/pallas/gather.py:221",
                tpu_kernel="_wbwd (K1) and _bwd (K6), one function",
                shape=f"latent {SB_TRAIN}x{LATENT}x{LATENT}x{C} bf16, N={BAND} per scene",
                cases=cases, ms=ms, device_ms=device_ms, device_ms_by_kernel=by_kernel,
                sustained=smi, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                bound_by=b_by)


def edge_grid(gen, b, n):
    """Grid points over and beyond the map, the first ones on tile edges (a
    pixel coordinate of 7, 7.5, 8, 15.5, 31.5), on the border and its
    corners, and beyond it."""
    grid = torch.rand(b, n, 2, generator=gen, device=DEV) * 2.2 - 1.1
    px = [(7.0, 3.0), (7.5, 3.2), (8.0, 7.5), (7.5, 7.5), (15.5, 8.0), (31.5, 31.5), (0.0, 5.0),
          (LATENT - 1, 4.0), (3.0, LATENT - 1), (LATENT - 1, LATENT - 1), (0.0, 0.0),
          (LATENT - 1.5, LATENT - 1.5), (-3.0, 9.5), (70.0, 70.0)]
    px = torch.tensor(px, device=DEV)[:n]
    grid[:, :len(px)] = px / (LATENT - 1) * 2 - 1
    return grid.contiguous()


def one_tile_grid(gen, b, n):
    """Every point inside one tile (pixels 8 to 15 of each axis): one bin a
    view, longer than one CTA's share."""
    u = torch.rand(b, n, 2, generator=gen, device=DEV) * 6.9 + 8.05
    return (u / (LATENT - 1) * 2 - 1).contiguous()


def band_grid(gen):
    """K1's grid at the band layout: ``proj_inputs``' band points (the train
    step's 4 x 81,920) projected into their source view."""
    feat, pts, proj = proj_inputs(gen, SB_TRAIN, 1, torch.bfloat16, BAND)
    return feat, project_packed(proj, pts).contiguous()


def vr_coarse_grid(gen):
    """K1's grid at the VR coarse pass's layout: 64 stratified samples a ray
    over the near-far range (0.8 to 1.8, from the marched depth ~0.8) on
    ``march_inputs``' 4,096 rays, 4 scenes, projected into the source view."""
    inp = march_inputs(gen, 1, sb=SB_TRAIN)
    s = (torch.arange(64, device=DEV)
         + torch.rand(SB_TRAIN, CHUNK, 64, generator=gen, device=DEV)) / 64
    pts = inp["coords0"][:, :, None] + inp["rds"][:, :, None] * s[..., None]
    grid = project_packed(inp["proj"].reshape(SB_TRAIN, 16), pts.reshape(SB_TRAIN, -1, 3))
    return inp["feat"].reshape(SB_TRAIN, LATENT, LATENT, C), grid.contiguous()


def check_gather_bwd_bins(gen, k1):
    """K1's binned backward at the layouts the paths give it and at the
    sort's hard cases, each run twice (bit for bit equal); added to ``k1``
    (its cases, and the band's and VR coarse pass's times beside the
    uniform case's).  Draws from a generator of its own."""
    bf, f32 = torch.bfloat16, torch.float32
    cases, times = [], {}

    def case(label, feat, coords, g):
        dt = feat.dtype
        got = grads_of(gather_bilinear, (feat, coords), g)
        cases.append(check_rerun(f"rerun {label}", got,
                                 grads_of(gather_bilinear, (feat, coords), g)))
        if coords.shape[1] == 0:
            cases.append(check(f"dfeat {label}", max_err(got[0], torch.zeros_like(feat)), 0.0))
            return
        want = grads_of(gather_bilinear_plain, (feat, coords), g)
        # as check_gather_bwd; float32: the same sums in another order
        cases.append(check_rel(f"dfeat {label}", got[0], want[0],
                               2.0 ** -7 if dt == bf else 1e-5))
        cases.append(check_rel(f"dcoords {label}", got[1], want[1], 1e-4))

    for label, grid_of in (("band", band_grid), ("VR coarse", vr_coarse_grid)):
        feat, coords = grid_of(gen)
        g = randn(gen, *coords.shape[:2], C, dtype=bf)
        case(f"{label} N={coords.shape[1]} bf16", feat, coords, g)
        _, run = grads_of(gather_bilinear, (feat, coords), g, keep=True)
        times[label] = dict(ms=time_ms(run), device_ms=bwd_device_ms(run, K1_BWD_KERNELS)[0],
                            sustained=sustained(run, 1.0, SMI_FIELDS))
        if label == "band":
            no_host_sync(run)
        del feat, coords, g, run
    for label, b, n, dt, grid_of in (
            ("one tile", SB_TRAIN, BAND, bf, one_tile_grid),
            ("one tile", 1, BAND, f32, one_tile_grid),
            ("edges", SB_TRAIN, 1_037, bf, edge_grid), ("edges", 1, 1_037, f32, edge_grid),
            ("edges", 1, BAND + 37, bf, edge_grid),
            ("empty", SB_TRAIN, 0, bf, edge_grid), ("empty", 1, 0, f32, edge_grid)):
        feat = randn(gen, b, LATENT, LATENT, C, dtype=dt)
        case(f"{label} B={b} N={n} {str(dt)[6:]}", feat, grid_of(gen, b, n),
             randn(gen, b, n, C, dtype=dt))
    k1["cases"] += cases
    k1.update(band=times["band"], vr_coarse=times["VR coarse"])
    clock = lambda t: (f"{t['sustained']['ms']:.4f} ms at {t['sustained']['clocks.sm']} MHz, "
                       f"{t['sustained']['power.draw']} W")
    print(f"K1 backward: {sum(c['against'] == 'rerun' for c in k1['cases'])} cases bit for "
          f"bit equal on a rerun; uniform {k1['ms']:.4f} ms (device {k1['device_ms']:.4f}; "
          f"1 s loop {clock(k1)}), band {times['band']['ms']:.4f} (device "
          f"{times['band']['device_ms']:.4f}; {clock(times['band'])}), VR coarse "
          f"{times['VR coarse']['ms']:.4f} (device {times['VR coarse']['device_ms']:.4f}; "
          f"{clock(times['VR coarse'])}); device ms by kernel at uniform "
          f"{k1['device_ms_by_kernel']}")


MATCHED_BF16_TOL = 3e-3
DECODER_GRADS = ("dx", "dz", "dwi", "dbi", "dwz", "dbz", "dw0", "db0", "dw1", "db1", "dwo", "dbo")


def decoder_plain_stash(x, z, w, *, n_blocks, n_lin_z, code, compute_dtype):
    """``resnetfc_plain``'s forward, keeping its post-ReLU activations in the
    kernel's stash layout (float32 holding compute-dtype values)."""
    c = lambda t: t.to(compute_dtype).float()
    wi, bi, wz, bz, w0, b0, w1, b1, wo, bo = (c(t) for t in w)
    ns = x.shape[0]
    st = [None] * K2.stash_slots(ns, n_blocks, n_lin_z)

    def block(h, k, v):
        a1 = c(torch.relu(h))
        a2 = c(torch.relu(a1 @ w0[k].T + b0[k]))
        st[K2.stash_slot(k, 0, v, ns, n_lin_z)], st[K2.stash_slot(k, 1, v, ns, n_lin_z)] = a1, a2
        return h + a2 @ w1[k].T + b1[k]

    h_sum = 0.0
    for v in range(ns):
        h = c(K2._encode(x[v].float(), code)) @ wi.T + bi
        zv = c(z[v])
        for k in range(n_lin_z):
            h = block(h + zv @ wz[k].T + bz[k], k, v)
        h_sum = h_sum + h
    h = h_sum if ns == 1 else h_sum * (1.0 / ns)
    for k in range(n_lin_z, n_blocks):
        h = block(h, k, 0)
    st[-1] = c(torch.relu(h))
    return torch.stack(st)


@torch.no_grad()
def decoder_bwd_matched(x, z, w, st, g, *, n_blocks, n_lin_z, code, compute_dtype):
    """The decoder's stash backward (``activate_out`` on) in plain PyTorch
    with the kernel's rounding points, from a given stash ``st``: each
    product's input cotangent is rounded to the compute dtype, the trunk
    cotangent stays float32, the ReLU masks are read from the stash.  Fed
    the kernel's own stash, its masks are the kernel's, so only float32
    summation order separates the two; fed ``decoder_plain_stash`` in
    float32, it is the plain version's autograd up to that order.  Returns
    the gradients in ``DECODER_GRADS`` order."""
    r = lambda t: t.to(compute_dtype).float()
    wi, bi, wz, bz, w0, b0, w1, b1, wo, bo = (r(t) for t in w)
    ns = x.shape[0]
    act = lambda k, j, v: st[K2.stash_slot(k, j, v, ns, n_lin_z)].float()
    gr = {k: torch.zeros_like(t) for k, t in zip(("wz", "bz", "w0", "b0", "w1", "b1"),
                                                  (wz, bz, w0, b0, w1, b1))}
    gr["wi"], gr["bi"] = 0.0, 0.0
    aout = st[-1].float()
    pre = aout @ wo.T + bo
    sg = torch.sigmoid(pre[:, :3])
    ge = r(torch.cat([g[:, :3] * sg * (1.0 - sg), torch.where(pre[:, 3:] > 0, g[:, 3:], 0.0)],
                     dim=-1))

    def block(gh, k, v):
        a1, a2 = act(k, 0, v), act(k, 1, v)
        c1 = r(gh)
        c0 = r(torch.where(a2 > 0, c1 @ w1[k], 0.0))
        gr["w1"][k] += c1.T @ a2
        gr["b1"][k] += c1.sum(0)
        gr["w0"][k] += c0.T @ a1
        gr["b0"][k] += c0.sum(0)
        return gh + torch.where(a1 > 0, c0 @ w0[k], 0.0)

    gh = torch.where(aout > 0, ge @ wo, 0.0)
    for k in range(n_blocks - 1, n_lin_z - 1, -1):
        gh = block(gh, k, 0)
    dx, dz = [], []
    for v in range(ns):
        ghv, dzv, zv = gh * (1.0 / ns) if ns > 1 else gh, 0.0, r(z[v])
        for k in range(n_lin_z - 1, -1, -1):
            ghv = block(ghv, k, v)
            ci = r(ghv)  # injection k's output cotangent (lin_in's for k = 0)
            dzv = dzv + ci @ wz[k]
            gr["wz"][k] += ci.T @ zv
            gr["bz"][k] += ci.sum(0)
        with torch.enable_grad():
            p = x[v].float().requires_grad_(True)
            enc = K2._encode(p, code)
            dx.append(torch.autograd.grad(enc, p, ci @ wi)[0])
        gr["wi"] = gr["wi"] + ci.T @ r(enc.detach())
        gr["bi"] = gr["bi"] + ci.sum(0)
        dz.append(r(dzv))
    return (torch.stack(dx), torch.stack(dz), gr["wi"], gr["bi"], gr["wz"], gr["bz"], gr["w0"],
            gr["b0"], gr["w1"], gr["b1"], ge.T @ aout, ge.sum(0))


def check_resnetfc_bwd(gen):
    w = decoder_weights(gen)
    kw = dict(n_blocks=5, n_lin_z=3, code=CODE, activate_out=True,
              compute_dtype=torch.bfloat16)
    kern = lambda x, z, *ws: fused_resnetfc(x, z, DecoderWeights(*ws), **kw)
    plain = lambda x, z, *ws: resnetfc_plain(x, z, DecoderWeights(*ws), **kw)
    cases, timing = [], {}
    # (points, views, operand dtype, tolerance on the relative L2 error):
    # float32 checks the algorithm: sums in other orders, and a ReLU mask
    # flips only where an activation is within float32 rounding of zero,
    # a handful per million, each moving a bias gradient's sum by one
    # point's term: 1e-2 (a fault of the algorithm is an error of order 1).
    # bf16: both sides round the same operands to bf16 but at slightly
    # different places (the plain version's autograd rounds each product's
    # output cotangent, the kernel its input, as the TPU kernel does), so
    # activations differ by a bf16 ulp here and there and a fraction of a
    # percent of the ReLU masks flip; each flip moves one gradient element
    # by its full size, an L2 error near the square root of the flip
    # fraction: 8e-2.  Shapes: the coarse query of a train step, a two-view
    # tile, and the band query.
    # Each case is also held against decoder_bwd_matched fed the kernel's
    # own stash: the same masks and rounding points, so what is left is
    # float32 summation order, and a cotangent whose float32 value lands
    # within that noise of a bf16 rounding boundary rounds the other way,
    # which perturbs every later product: 1e-4 in float32; in bf16 the
    # noise settles near a quarter of a bf16 ulp (9.4e-4 at all three
    # shapes), held at MATCHED_BF16_TOL = 3e-3.  Fed the plain forward's
    # stash, the matched reference must equal the plain version's autograd
    # in float32 (1e-5): that checks the reference itself; in bf16 its
    # distance from the autograd is what the rounding points alone move,
    # with no mask flipped (reported, not bounded).
    for n, ns, cd, tol in ((CHUNK, 1, torch.float32, 1e-2), (CHUNK, 2, torch.float32, 1e-2),
                           (SB_TRAIN * CHUNK, 1, torch.bfloat16, 8e-2),
                           (CHUNK, 2, torch.bfloat16, 8e-2), (BAND_TRAIN, 1, torch.bfloat16, 8e-2)):
        x = torch.rand(ns, n, CODE.d_raw, generator=gen, device=DEV) * 2 - 1
        z = randn(gen, ns, n, C, dtype=cd)
        # a cotangent with a mean: with zero-mean noise the bias gradients
        # (sums over the points) cancel to a few percent of their terms, and
        # a bf16 rounding of any term is then a large share of the sum
        g = randn(gen, n, 4) + 0.5
        kw["compute_dtype"] = cd
        label = f"N={n} NS={ns} {str(cd)[6:]}"
        mkw = dict(n_blocks=5, n_lin_z=3, code=CODE, compute_dtype=cd)
        # the forward kernel has no atomics: its stash is the one the
        # wrapper's forward writes below
        args = K2._prepare(x, z, DecoderWeights(*w), CODE, cd)
        dims = K2._dims(args, 5, 3, True)
        kst = K2._forward(args, dims, cd, True)[1]
        pst = decoder_plain_stash(x, z, w, **mkw)
        flips = float(((kst > 0) != (pst > 0)).float().mean())
        matched = decoder_bwd_matched(x, z, w, kst, g, **mkw)
        ref_plain = decoder_bwd_matched(x, z, w, pst, g, **mkw)
        del kst, pst
        keep = n == BAND_TRAIN
        got, run = grads_of(kern, (x, z, *w), g, keep=True) if keep else (
            grads_of(kern, (x, z, *w), g), None)
        want, run_plain = grads_of(plain, (x, z, *w), g, keep=True) if keep else (
            grads_of(plain, (x, z, *w), g), None)
        mtol = 1e-4 if cd == torch.float32 else MATCHED_BF16_TOL
        vs_plain = [check_l2(f"{nm} {label}", a, b, tol)
                    for nm, a, b in zip(DECODER_GRADS, got, want)]
        vs_matched = [check_l2(f"{nm} {label} vs matched rounding", a, m, mtol, against="matched")
                      for nm, a, m in zip(DECODER_GRADS, got, matched)]
        cases += vs_plain + vs_matched
        worst = lambda cs: max((c["rel_l2"], c["case"].split()[0]) for c in cs)
        if cd == torch.float32:  # no float atomics: every gradient bit for bit on a rerun
            cases.append(check_rerun(f"rerun every gradient {label}", got,
                                     grads_of(kern, (x, z, *w), g)))
            cases += [check_l2(f"{nm} {label} matched reference vs autograd", m, b, 1e-5,
                               against="autograd")
                      for nm, m, b in zip(DECODER_GRADS, ref_plain, want)]
            rounding = None
        else:
            rounding = max((float((m.float() - b.float()).norm() / b.float().norm()), nm)
                           for nm, m, b in zip(DECODER_GRADS, ref_plain, want))
        cases.append({"case": f"ReLU mask flips {label}", "against": "plain forward",
                      "flip_fraction": flips, "rounding_points_rel_l2": rounding})
        print(f"K2 backward {label}: ReLU mask flips {flips:.3e} of the stash; worst relative "
              f"L2 against the plain autograd {worst(vs_plain)}, against the matched rounding "
              f"{worst(vs_matched)}; rounding points alone (plain stash) {rounding}")
        if keep:
            timing = dict(ms=time_ms(run, iters=5), plain_ms=time_ms(run_plain, iters=3),
                          split=kernel_device_ms(run, K2_BWD_KERNELS))
            timing["stash_fwd_ms"] = time_ms(lambda: K2._forward(args, dims, cd, True), iters=5)
            # the yardstick: torch.matmul over the wgrad's 15 dW = G^T A jobs,
            # on the stash, cotangents and encoded input of this call
            kst = K2._forward(args, dims, cd, True)[1]
            gs, wT, grads = K2._bwd_operands(args, dims, g, K2.NAME_DGRAD)
            _, _, cot, gout, enc = K2._dgrad(args, dims, kst, gs, wT, cd)
            jobs = wgrad_matmul_jobs(kst, cot, gout, enc, args["z"], 5, 3)
            timing["library_ms"] = time_ms(lambda: [torch.matmul(a.t(), b) for a, b in jobs],
                                           iters=5)
            cases += check_wgrad_jobs(kst, cot, gout, enc, args, dims, jobs)
            # each wrapper's host cost (the wgrad's: its plan, 30 tensor
            # maps, two launches; the dgrad's: 6 tensor maps, two launches)
            split = timing["split"]
            timing["dgrad_host"] = call_timing(
                lambda: K2._dgrad(args, dims, kst, gs, wT, cd),
                sum(split[k] for k in DGRAD_KERNELS))
            timing["wgrad_host"] = call_timing(
                lambda: K2._wgrad(BAND_TRAIN, args["z"], kst, cot, gout, enc, grads, dims, cd),
                sum(split[k] for k in WGRAD_KERNELS))
            shapes = [(BAND_TRAIN, 512, 512, True)] * 13 + [(BAND_TRAIN, 512, dims["k_in"], True),
                                                             (BAND_TRAIN, 4, 512, True)]
            timing["wgrad_host"]["plan_ms"] = host_ms(lambda: K2.wgrad_plan(shapes))
            del jobs, kst, cot, gout, enc, grads
        del got, want, matched, ref_plain, run, run_plain
    flops = decoder_flops(BAND_TRAIN, 1)
    act = BAND_TRAIN * 512 * 2  # one (N, 512) bf16 activation
    wbytes = sum(t.numel() for t in w) * 2
    io = BAND_TRAIN * (CODE.d_raw * 4 * 2 + C * 2 * 2 + 4 * 4)  # x, dx, z, dz, g
    split = timing["split"]
    dg_ms, dg_by = bound(11 * act + 11 * act + io + wbytes, flops, BF16_FLOPS)
    wg_ms, wg_by = bound(11 * act + 11 * act + BAND_TRAIN * C * 2 + wbytes * 2, flops, BF16_FLOPS)
    common = dict(replaces="avr_tpu/ops/pallas/resnetfc.py:823", tpu_kernel="_bwd_stash_impl",
                  shape=f"N={BAND_TRAIN}, NS=1, d_hidden 512, 5 blocks, bf16", cases=cases,
                  plain_ms=timing["plain_ms"], pair_ms=timing["ms"],
                  stash_fwd_ms=timing["stash_fwd_ms"])
    dg_split = {k: split[k] for k in DGRAD_KERNELS}
    wg_split = {k: split[k] for k in WGRAD_KERNELS}
    return [dict(name="fused_resnetfc_bwd_dgrad", ms=sum(dg_split.values()), split=dg_split,
                 source="avr_tpu_torch/csrc/resnetfc_hopper.cu", bound_ms=dg_ms, bound_by=dg_by,
                 library_ms=None, **timing["dgrad_host"], **common),
            dict(name="fused_resnetfc_bwd_wgrad", ms=sum(wg_split.values()), split=wg_split,
                 source="avr_tpu_torch/csrc/resnetfc_hopper.cu", bound_ms=wg_ms, bound_by=wg_by,
                 library_ms=timing["library_ms"], library="torch.matmul over the 15 G^T A jobs",
                 **timing["wgrad_host"], **common)]


def wgrad_matmul_jobs(st, cot, gout, enc, z, nb, nlz):
    """The wgrad kernel's ``(G, A)`` pairs (``dW = G^T A``) of an NS = 1
    stash backward, as tensors: the fc_0 / fc_1 products, the latent
    injections, lin_in and lin_out."""
    jobs = [(cot[K2.stash_slot(k, j, 0, 1, nlz)], st[K2.stash_slot(k, j, 0, 1, nlz)])
            for k in range(nb) for j in (0, 1)]
    cot_in = cot[2 * nlz + 2 * (nb - nlz)]
    jobs += [(cot_in if k == 0 else cot[K2.stash_slot(k - 1, 1, 0, 1, nlz)], z[0])
             for k in range(nlz)]
    return jobs + [(cot_in, enc[0]), (gout, st[-1])]


# The wgrad against torch.matmul on the same rounded operands, per job:
# both sum exact float32 products of bf16 values over 327,680 rows in other
# orders (the kernel in 64-row wgmma steps, row splits and a reduction;
# cuBLAS in its own), a relative error near 2^-24 sqrt(rows) = 3.4e-5 of
# the sum of |terms| at worst: 1e-4 of each job's L2 norm.  float32
# operands (the float32 wgrad, check_float32) add one rounding of 2^-24 a
# product: the same order.
WGRAD_JOB_TOL = 1e-4


def check_wgrad_jobs(st, cot, gout, enc, args, dims, jobs, cd=torch.bfloat16):
    """The wgrad launch of the stash backward (``K2._wgrad``, the 15 jobs of
    an NS = 1 call) into fresh sums, each job's dW and db held against
    torch.matmul and a column sum of the same rounded operands (``cd``:
    the operands' dtype)."""
    f32 = dict(dtype=torch.float32, device=DEV)
    dh, nb, nlz = dims["d_hidden"], dims["n_blocks"], dims["n_lin_z"]
    grads = dict(wi=torch.zeros((dh, dims["k_in"]), **f32), bi=torch.zeros((dh,), **f32),
                 wz=torch.zeros((nlz, dh, dims["d_latent"]), **f32),
                 bz=torch.zeros((nlz, dh), **f32), w0=torch.zeros((nb, dh, dh), **f32),
                 b0=torch.zeros((nb, dh), **f32), w1=torch.zeros((nb, dh, dh), **f32),
                 b1=torch.zeros((nb, dh), **f32), wo=torch.zeros((dims["d_out"], dh), **f32),
                 bo=torch.zeros((dims["d_out"],), **f32))
    K2._wgrad(dims["N"], args["z"], st, cot, gout, enc, grads, dims, cd)
    # the same order as K2._wgrad's jobs
    outs = [(f"{w}[{k}]", grads[w][k], grads[b][k]) for k in range(nb)
            for w, b in (("w0", "b0"), ("w1", "b1"))]
    outs += [(f"wz[{k}]", grads["wz"][k], grads["bz"][k]) for k in range(nlz)]
    outs += [("wi", grads["wi"], grads["bi"]), ("wo", grads["wo"], grads["bo"])]
    cases = []
    for (label, dW, db), (G, A) in zip(outs, jobs):
        mg = dW.shape[0]
        want = torch.matmul(G[:, :mg].float().t(), A.float())
        cases.append(check_l2(f"wgrad {label} vs torch.matmul", dW, want, WGRAD_JOB_TOL,
                              against="torch.matmul"))
        cases.append(check_l2(f"wgrad {label} bias vs column sum", db, G[:, :mg].float().sum(0),
                              WGRAD_JOB_TOL, against="torch.sum"))
    print(f"K2 wgrad per job ({str(cd)[6:]}): worst relative L2 against torch.matmul "
          f"{max(c['rel_l2'] for c in cases):.3e} over {len(jobs)} jobs")
    return cases


# float32, the JAX CLI's default dtype (avr_tpu/cli/train.py --dtype f32):
# K2's forward and the float32 wgrad are register-tiled FMA kernels
# (csrc/resnetfc.cu resnetfc_fwd_f32_kernel, resnetfc_wgrad_f32_kernel);
# K2's float32 dgrad and K3's float32 kernels keep the first port's designs
F32_FWD_KERNEL = "resnetfc_fwd_f32_kernel"
F32_DGRAD_KERNEL = "resnetfc_dgrad_kernel"
K3_F32_JOB_ROWS = SB_TRAIN * CHUNK * STEPS  # K3's float32 dW_ih / dW_hh rows a train step
# the float32 forward's cases (d_hidden, code, d_latent, views): the widths
# of its thread layout, 576 encoded lanes (lin_in in two chunks of the A
# tile) and a latent of 1,024 at two views (beyond the parent kernel's
# shared memory); each at a point count on and off the 32-point tile, with
# and without the stash
F32_FWD_CASES = [(dh, CODE, C, ns) for dh in (64, 256, 512) for ns in (1, 2)] + [
    (512, WIDE_CODE, 1024, 2), (64, WIDE_CODE, 64, 1)]
# float32 operands: FMA order against cuBLAS over 13 chained products
F32_FWD_TOL = 1e-4


def f32_ran(before, names):
    """The launches of ``names`` since the counters read ``before``."""
    return {n: _build.launches.get(n, 0) - before.get(n, 0) for n in names}


def check_f32_forward(gen):
    """K2's float32 forward against the plain version at F32_FWD_CASES: the
    output within F32_FWD_TOL of its largest value, the stash slot by slot
    within F32_FWD_TOL of each slot's, each call on the float32 kernel
    (``fused_resnetfc_f32``) and never the wgmma one."""
    cases = []
    kw = dict(n_blocks=5, n_lin_z=3, activate_out=True)
    for dh, code, dl, ns in F32_FWD_CASES:
        w = decoder_weights(gen, dh=dh, code=code, dl=dl)
        for n in (CHUNK, CHUNK + 37):
            x = (torch.rand(ns, n, code.d_raw, generator=gen, device=DEV) * 2 - 1).contiguous()
            z = randn(gen, ns, n, dl)
            label = f"d_hidden {dh} k_in {K2.d_enc_padded(code.d_enc)} d_latent {dl} N={n} NS={ns}"
            want = resnetfc_plain(x, z, w, compute_dtype=torch.float32, code=code, **kw)
            tol = F32_FWD_TOL * max(1.0, float(want.abs().max()))
            before = dict(_build.launches)
            got = fused_resnetfc(x, z, w, compute_dtype=torch.float32, code=code, **kw)
            args = K2._prepare(x, z, w, code, torch.float32)
            out, st = K2._forward(args, K2._dims(args, 5, 3, True), torch.float32, True)
            ran = f32_ran(before, (K2.NAME, K2.NAME_STASH, K2.NAME_F32, K2.NAME_WGMMA))
            if ran != {K2.NAME: 1, K2.NAME_STASH: 1, K2.NAME_F32: 2, K2.NAME_WGMMA: 0}:
                raise AssertionError(f"K2 float32 forward {label}: launches {ran}")
            cases.append(check(f"float32 {label}", max_err(got, want), tol))
            cases.append(check(f"float32 {label} with the stash", max_err(out, want), tol))
            pst = decoder_plain_stash(x, z, w, n_blocks=5, n_lin_z=3, code=code,
                                      compute_dtype=torch.float32)
            worst = max(max_err(st[i], pst[i]) / max(float(pst[i].abs().max()), 1e-30)
                        for i in range(len(pst)))
            cases.append(check(f"float32 stash {label} (worst slot, relative)", worst,
                               F32_FWD_TOL, against="plain stash"))
            del x, z, got, want, args, out, st, pst
    worst = max(c["max_abs_err"] / c["tol"] for c in cases)
    print(f"K2 float32 forward: {len(cases)} cases within {F32_FWD_TOL} of the plain version "
          f"(worst at {worst:.3f} of its bound), every call on {K2.NAME_F32}")
    return cases


def check_float32(gen):
    """K2's float32 kernels at the main path's shapes (the forward at the
    band chunk and at a served chunk's coarse query, the stash backward's
    dgrad and wgrad at the train step's band call) and the float32 wgrad at
    K3's two jobs: times beside the float32 bounds and the plain versions
    (the wgrad also beside torch.matmul in float32, TF32 off), the
    forward's cases (check_f32_forward, a generator of their own), the
    wgrad's jobs against torch.matmul and K3's against the plain product in
    float64, and every wgrad output bit for bit on a rerun.  Returns the
    rows and the kernels-line entries of the float32 forward and wgrad."""
    f32 = torch.float32
    w = decoder_weights(gen)
    kw = dict(n_blocks=5, n_lin_z=3, code=CODE, activate_out=True, compute_dtype=f32)
    rows, cases = {}, []
    x = (torch.rand(1, BAND, CODE.d_raw, generator=gen, device=DEV) * 2 - 1).contiguous()
    z = randn(gen, 1, BAND, C)
    fwd = lambda: fused_resnetfc(x, z, w, **kw)
    wbytes = sum(t.numel() for t in w) * 4
    rows["K2 forward"] = dict(
        shape=f"N={BAND}, NS=1, f32", ms=kernel_device_ms(fwd, (F32_FWD_KERNEL,))[F32_FWD_KERNEL],
        call_ms=time_ms(fwd, iters=5), plain_ms=time_ms(lambda: resnetfc_plain(x, z, w, **kw),
                                                        iters=3), library_ms=None,
        bound_ms=bound(x.numel() * 4 + z.numel() * 4 + wbytes + BAND * 4 * 4,
                       decoder_flops(BAND, 1), F32_FLOPS)[0])
    rows["K2 forward"]["max_abs_err"] = max_err(fwd(), resnetfc_plain(x, z, w, **kw))
    del x, z
    # a served chunk's coarse query (its own generator: the draws above keep their inputs)
    sgen = torch.Generator(device=DEV).manual_seed(21)
    xs = (torch.rand(1, CHUNK, CODE.d_raw, generator=sgen, device=DEV) * 2 - 1).contiguous()
    zs = randn(sgen, 1, CHUNK, C)
    sfwd = lambda: fused_resnetfc(xs, zs, w, **kw)
    rows["K2 forward serve"] = dict(
        shape=f"N={CHUNK}, NS=1, f32 (a served chunk's coarse query)",
        ms=kernel_device_ms(sfwd, (F32_FWD_KERNEL,), iters=20)[F32_FWD_KERNEL],
        call_ms=time_ms(sfwd, iters=20),
        plain_ms=time_ms(lambda: resnetfc_plain(xs, zs, w, **kw), iters=5), library_ms=None,
        bound_ms=bound(xs.numel() * 4 + zs.numel() * 4 + wbytes + CHUNK * 4 * 4,
                       decoder_flops(CHUNK, 1), F32_FLOPS)[0])
    del xs, zs
    # the stash backward at the train step's band call
    x = (torch.rand(1, BAND_TRAIN, CODE.d_raw, generator=gen, device=DEV) * 2 - 1).contiguous()
    z = randn(gen, 1, BAND_TRAIN, C)
    g = randn(gen, BAND_TRAIN, 4) + 0.5
    args = K2._prepare(x, z, w, CODE, f32)
    dims = K2._dims(args, 5, 3, True)
    st = K2._forward(args, dims, f32, True)[1]
    run = lambda: K2._backward(args, dims, st, g, f32)
    split = kernel_device_ms(run, (F32_DGRAD_KERNEL,) + WGRAD_F32_KERNELS, iters=2)
    gs, wT, grads = K2._bwd_operands(args, dims, g, K2.NAME_DGRAD)
    _, _, cot, gout, enc = K2._dgrad(args, dims, st, gs, wT, f32)
    jobs = wgrad_matmul_jobs(st, cot, gout, enc, args["z"], 5, 3)
    library_ms = time_ms(lambda: [torch.matmul(a.t(), b) for a, b in jobs], iters=3)
    before = dict(_build.launches)
    wcases = check_wgrad_jobs(st, cot, gout, enc, args, dims, jobs, f32)
    wg = lambda: K2._wgrad(BAND_TRAIN, args["z"], st, cot, gout, enc, grads, dims, f32)
    again = {k: torch.zeros_like(v) for k, v in grads.items()}
    for sums in (grads, again):  # into zeroed sums, twice: bit for bit
        for v in sums.values():
            v.zero_()
        K2._wgrad(BAND_TRAIN, args["z"], st, cot, gout, enc, sums, dims, f32)
    wcases.append(check_rerun(f"rerun K2 float32 wgrad N={BAND_TRAIN}", list(grads.values()),
                              list(again.values())))
    if f32_ran(before, (K2.NAME_WGRAD_F32,))[K2.NAME_WGRAD_F32] != 3:
        raise AssertionError("K2's float32 wgrad did not run on the float32 wgrad kernel")
    act = BAND_TRAIN * 512 * 4  # one (N, 512) float32 activation
    io = BAND_TRAIN * (CODE.d_raw * 4 * 2 + C * 4 * 2 + 4 * 4)  # x, dx, z, dz, g
    flops = decoder_flops(BAND_TRAIN, 1)
    common = dict(shape=f"N={BAND_TRAIN}, NS=1, f32 (the train step's band call)")
    rows["K2 dgrad"] = dict(ms=split[F32_DGRAD_KERNEL], plain_ms=None, library_ms=None,
                            bound_ms=bound(22 * act + io + wbytes, flops, F32_FLOPS)[0], **common)
    rows["K2 wgrad"] = dict(ms=sum(split[k] for k in WGRAD_F32_KERNELS), split=split,
                            call_ms=time_ms(wg, iters=3), library_ms=library_ms,
                            library="torch.matmul over the 15 G^T A jobs, float32, TF32 off",
                            plain_ms=None, bound_ms=bound(22 * act + BAND_TRAIN * C * 4
                                                          + wbytes * 2, flops, F32_FLOPS)[0],
                            **common)
    rows["K2 stash backward"] = dict(ms=time_ms(run, iters=2), plain_ms=time_ms(
        lambda: grads_of(lambda x_, z_: resnetfc_plain(x_, z_, w, **kw), (x, z), g), iters=2),
        **common)
    del x, z, g, args, st, gs, wT, grads, again, cot, gout, enc, jobs
    # K3's dW_ih and dW_hh: one wgrad of two jobs over the walk's rows
    # (v_t | h_prev, the gate cotangents), as ops/kernels/march.py launches it
    vld, dgl = C + -(-HIDDEN // 4) * 4, K3.gate_row_width(HIDDEN)
    v = randn(gen, K3_F32_JOB_ROWS, vld)
    dg = randn(gen, K3_F32_JOB_ROWS, dgl)
    outs = [[torch.zeros((C, 4 * HIDDEN), device=DEV), torch.zeros((HIDDEN, 4 * HIDDEN),
                                                                   device=DEV)] for _ in range(2)]
    k3 = lambda o: K2.wgrad(K3.NAME_WGRAD, [
        (v.data_ptr(), dg.data_ptr(), o[0], None, K3_F32_JOB_ROWS, vld, dgl, C, 4 * HIDDEN),
        (v.data_ptr() + 4 * C, dg.data_ptr(), o[1], None, K3_F32_JOB_ROWS, vld, dgl, HIDDEN,
         4 * HIDDEN)], f32, DEV)
    for o in outs:
        k3(o)
    wcases.append(check_rerun("rerun K3 float32 dW_ih and dW_hh", outs[0], outs[1]))
    for name, got, a, b in (("dW_ih", outs[0][0], v[:, :C], dg[:, :4 * HIDDEN]),
                            ("dW_hh", outs[0][1], v[:, C:C + HIDDEN], dg[:, :4 * HIDDEN])):
        wcases.append(check_l2(f"K3 float32 {name} vs torch.matmul", got, a.t() @ b,
                               WGRAD_JOB_TOL, against="torch.matmul"))
        # the plain version: the same product in float64
        wcases.append(check_l2(f"K3 float32 {name} vs the plain product (float64)", got,
                               (a.double().t() @ b.double()).float(), WGRAD_JOB_TOL))
    k3_ms = sum(kernel_device_ms(lambda: k3(outs[1]), WGRAD_F32_KERNELS, iters=20).values())
    rows["K3 dW_ih + dW_hh"] = dict(
        shape=f"{K3_F32_JOB_ROWS} ray-steps, C={C}, hidden {HIDDEN}, f32", ms=k3_ms,
        library_ms=time_ms(lambda: torch.matmul(v.t(), dg), iters=20),
        library="torch.matmul(v^T, dgates), float32, TF32 off",
        plain_ms=time_ms(lambda: v.double().t() @ dg.double(), iters=3),
        bound_ms=bound(K3_F32_JOB_ROWS * (vld + dgl) * 4 + (C + HIDDEN) * 4 * HIDDEN * 4,
                       2 * K3_F32_JOB_ROWS * (C + HIDDEN) * 4 * HIDDEN, F32_FLOPS)[0])
    del v, dg, outs
    for name, r in rows.items():
        print(f"float32 {name} ({r['shape']}): {r['ms']:.4f} ms (bound {r.get('bound_ms')}, "
              f"plain {r.get('plain_ms')}, library {r.get('library_ms')})")
    fcases = check_f32_forward(torch.Generator(device=DEV).manual_seed(20))
    fwd_row, wg_row = rows["K2 forward"], rows["K2 wgrad"]
    src = "avr_tpu_torch/csrc/resnetfc.cu"
    kernels = [
        dict(name=K2.NAME_F32, source=src, replaces="avr_tpu/ops/pallas/resnetfc.py:896",
             tpu_kernel="fused_resnetfc (call :726), float32",
             shape=f"N={BAND}, NS=1, d_hidden 512, 5 blocks, f32", cases=fcases,
             ms=fwd_row["ms"], plain_ms=fwd_row["plain_ms"], library_ms=None,
             bound_ms=fwd_row["bound_ms"], bound_by="operations",
             serve_ms=rows["K2 forward serve"]["ms"],
             serve_bound_ms=rows["K2 forward serve"]["bound_ms"]),
        dict(name=K2.NAME_WGRAD_F32, source=src, replaces="avr_tpu/ops/pallas/resnetfc.py:823",
             tpu_kernel="_bwd_stash_impl's weight gradients, float32",
             shape=f"N={BAND_TRAIN}, 15 jobs, f32", cases=wcases, ms=wg_row["ms"],
             plain_ms=rows["K3 dW_ih + dW_hh"]["plain_ms"], plain="K3's two jobs in float64",
             library_ms=wg_row["library_ms"], bound_ms=wg_row["bound_ms"],
             bound_by="operations", k3_ms=rows["K3 dW_ih + dW_hh"]["ms"],
             k3_library_ms=rows["K3 dW_ih + dW_hh"]["library_ms"],
             k3_bound_ms=rows["K3 dW_ih + dW_hh"]["bound_ms"])]
    return dict(rows=rows, cases=cases + fcases + wcases, kernels=kernels)


# decoder points of a VR train step (4 x 4,096 rays in one chunk): the
# coarse pass's 64 samples a ray and the fine pass's 64 + 16 + 16
COARSE_VR, FINE_VR = 64 * SB_TRAIN * CHUNK, SB_TRAIN * FINE_CHUNK
# weight gradients of two backwards that sum the same rounded products
# G^T A over 10^5 to 10^6 points in other groupings (chunk launches, the
# wgrad kernel's row chunks, float32 atomics): float32 rounding grows like
# 2^-24 sqrt(rows) of the sum of |terms|, which exceeds |dW| where the
# terms cancel, and the atomics' order changes from run to run (bf16 read
# up to 9.5e-5 of the largest value at the band call): 5e-4 of each
# gradient's largest value.  A wrong chunk moves a gradient by its share.
SUM_ORDER_TOL = 5e-4


def same_bits(a, b):
    return bool(torch.equal(a, b))


def check_resnetfc_recompute(gen):
    """K2's recompute backward: (a) against the stash backward kernels on
    the same inputs at the band call, where both fit: the point cotangents
    and, for the call's second chunk, the workspace (stash, rounded
    cotangents, encoded input) bit for bit, the weight gradients to
    summation order; (b) against the plain autograd by relative L2, and in
    bf16 against the matched reference, in one chunk and with the chunk cut
    to RECUT points (the host loop: chunk offsets, partial tiles, dW added
    across launches, the per-chunk copies at NS 2); (c) at the VR fine
    pass's 1,572,864 points (6 chunks) against the stash backward kernels,
    the plain autograd and the matched reference, each run over
    327,680-point pieces with dW summed.  Times at the VR passes."""
    w = decoder_weights(gen)
    mkw = dict(n_blocks=5, n_lin_z=3, code=CODE)
    cases = []

    def inputs(n, ns, cd):
        x = torch.rand(ns, n, CODE.d_raw, generator=gen, device=DEV) * 2 - 1
        return x, randn(gen, ns, n, C, dtype=cd), randn(gen, n, 4) + 0.5

    def operands(x, z, cd):
        args = K2._prepare(x, z, w, CODE, cd)
        return args, K2._dims(args, 5, 3, True)

    for cd, ns in ((torch.bfloat16, 1), (torch.float32, 1), (torch.bfloat16, 2),
                   (torch.float32, 2)):
        label = f"N={BAND_TRAIN} NS={ns} {str(cd)[6:]}"
        x, z, g = inputs(BAND_TRAIN, ns, cd)
        args, dims = operands(x, z, cd)
        st = K2._forward(args, dims, cd, True)[1]
        want = K2._backward(args, dims, st, g, cd)
        got = K2._backward_recompute(args, dims, g, cd)
        if cd == torch.float32:  # no float atomics: both backwards bit for bit on a rerun
            cases.append(check_rerun(f"rerun stash backward {label}", want,
                                     K2._backward(args, dims, st, g, cd)))
            cases.append(check_rerun(f"rerun recompute backward {label}", got,
                                     K2._backward_recompute(args, dims, g, cd)))
        # the stash dgrad's rounded cotangents and encoded input, and the
        # recompute kernel's workspace after the call's second chunk
        gs, wT, _ = K2._bwd_operands(args, dims, g, K2.NAME_DGRAD)
        _, _, cot, gout, enc = K2._dgrad(args, dims, st, gs, wT, cd)
        s0 = K2.RECOMPUTE_CHUNK
        n0 = BAND_TRAIN - s0
        work = K2._recompute_workspace(dims, n0, cd, DEV)
        _, rst, rcot, rgout, renc = K2._recompute_chunk(
            args, dims, gs, wT, work, s0, n0, torch.empty_like(got[0]), torch.empty_like(got[1]),
            cd)
        # the same device code on the same inputs, tile by tile: bitwise
        bits = {"dx": same_bits(got[0], want[0]), "dz": same_bits(got[1], want[1]),
                "stash": same_bits(rst, st[:, s0:]), "cot": same_bits(rcot, cot[:, s0:]),
                "gout": same_bits(rgout, gout[s0:]), "enc": same_bits(renc, enc[:, s0:])}
        if not all(bits.values()):
            raise AssertionError(f"K2 recompute {label}: not bitwise equal to the stash "
                                 f"backward: {bits}")
        cases.append({"case": f"bitwise {label}", "against": "stash kernels", **bits})
        cases += [check_rel(f"{nm} {label} vs stash", a, b, SUM_ORDER_TOL, "stash kernels")
                  for nm, a, b in zip(DECODER_GRADS[2:], got[2:], want[2:])]
        del x, z, g, args, st, want, got, gs, wT, cot, gout, enc, work, rst, rcot, rgout, renc

    kern = lambda cd: (lambda x, z, *ws: fused_resnetfc(
        x, z, DecoderWeights(*ws), compute_dtype=cd, activate_out=True, stash=False, **mkw))
    plain = lambda cd: (lambda x, z, *ws: resnetfc_plain(
        x, z, DecoderWeights(*ws), compute_dtype=cd, activate_out=True, **mkw))

    def recompute_grads(cd, x, z, g, chunk):
        """The kernel's gradients under autograd, in chunks of ``chunk``
        points; the launches must be one per chunk."""
        saved, before = K2.RECOMPUTE_CHUNK, _build.launches.get(K2.NAME_RECOMPUTE, 0)
        K2.RECOMPUTE_CHUNK = chunk
        try:
            got = grads_of(kern(cd), (x, z, *w), g)
        finally:
            K2.RECOMPUTE_CHUNK = saved
        launched = _build.launches.get(K2.NAME_RECOMPUTE, 0) - before
        if launched != -(-x.shape[1] // chunk):
            raise AssertionError(f"K2 recompute: {launched} launches for {x.shape[1]} points "
                                 f"in chunks of {chunk}")
        return got

    # tolerances as for the stash backward (check_resnetfc_bwd): float32
    # 1e-2 (summation order; a rare mask flip within rounding of zero), bf16
    # 8e-2 (both sides round to bf16 at other places: mask flips), and bf16
    # against the matched reference fed the stash forward's activations
    # (bitwise the recomputed ones, part a): MATCHED_BF16_TOL.  RECUT is
    # not a multiple of the 64-point tile (nor of float32's 32), so every
    # chunk ends in a partial tile and starts off the tile grid of the
    # whole call.
    RECUT = 1_000
    for n, ns, cd, tol, chunk in (
            (CHUNK, 1, torch.float32, 1e-2, K2.RECOMPUTE_CHUNK),
            (CHUNK, 2, torch.float32, 1e-2, K2.RECOMPUTE_CHUNK),
            (SB_TRAIN * CHUNK, 1, torch.bfloat16, 8e-2, K2.RECOMPUTE_CHUNK),
            (CHUNK, 2, torch.bfloat16, 8e-2, K2.RECOMPUTE_CHUNK),
            (CHUNK, 1, torch.float32, 1e-2, RECUT), (CHUNK, 2, torch.float32, 1e-2, RECUT),
            (CHUNK, 1, torch.bfloat16, 8e-2, RECUT), (CHUNK, 2, torch.bfloat16, 8e-2, RECUT)):
        label = f"N={n} NS={ns} {str(cd)[6:]} in {min(n, chunk)}-point chunks"
        x, z, g = inputs(n, ns, cd)
        got = recompute_grads(cd, x, z, g, chunk)
        want = grads_of(plain(cd), (x, z, *w), g)
        cases += [check_l2(f"{nm} {label} recompute", a, b, tol)
                  for nm, a, b in zip(DECODER_GRADS, got, want)]
        if cd == torch.bfloat16:
            args, dims = operands(x, z, cd)
            matched = decoder_bwd_matched(x, z, w, K2._forward(args, dims, cd, True)[1], g,
                                          compute_dtype=cd, **mkw)
            cases += [check_l2(f"{nm} {label} recompute vs matched rounding", a, m,
                               MATCHED_BF16_TOL, against="matched")
                      for nm, a, m in zip(DECODER_GRADS, got, matched)]

    # (c) the VR fine pass: recompute (6 chunks) against the stash kernels,
    # the plain autograd and the matched reference (fed the stash forward's
    # activations), each over 327,680-point pieces
    cd = torch.bfloat16
    x, z, g = inputs(FINE_VR, 1, cd)
    args, dims = operands(x, z, cd)
    got = list(K2._backward_recompute(args, dims, g, cd))
    pieces = {"stash kernels": [], "plain": [], "matched": []}
    for s in range(0, FINE_VR, BAND_TRAIN):
        e = min(FINE_VR, s + BAND_TRAIN)
        xs, zs, gp = x[:, s:e], z[:, s:e], g[s:e]
        pa, pd = operands(xs, zs, cd)
        pst = K2._forward(pa, pd, cd, True)[1]
        pieces["stash kernels"].append(K2._backward(pa, pd, pst, gp, cd))
        pieces["matched"].append(decoder_bwd_matched(xs, zs, w, pst, gp, compute_dtype=cd,
                                                     **mkw))
        del pa, pst
        pieces["plain"].append(grads_of(plain(cd), (xs, zs, *w), gp))

    def joined(parts):  # point cotangents joined, weight gradients summed
        return ([torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1)]
                + [sum(p[i] for p in parts) for i in range(2, 12)])

    label = f"N={FINE_VR} NS=1 bf16 (VR fine pass)"
    want = joined(pieces.pop("stash kernels"))
    bits = {"dx": same_bits(got[0], want[0]), "dz": same_bits(got[1], want[1])}
    if not all(bits.values()):
        raise AssertionError(f"K2 recompute {label}: not bitwise equal to the pieces: {bits}")
    cases.append({"case": f"bitwise {label}", "against": "stash kernels", **bits})
    cases += [check_rel(f"{nm} {label} vs stash pieces", a, b, SUM_ORDER_TOL, "stash kernels")
              for nm, a, b in zip(DECODER_GRADS[2:], got[2:], want[2:])]
    got[2] = got[2][:, :CODE.d_enc]  # lin_in's zero-padded input lanes
    for part, tol, against in (("plain", 8e-2, "plain"),
                               ("matched", MATCHED_BF16_TOL, "matched")):
        want = joined(pieces.pop(part))
        cases += [check_l2(f"{nm} {label} recompute vs {part} pieces", a, b, tol, against)
                  for nm, a, b in zip(DECODER_GRADS, got, want)]
    del got, want

    run = lambda: K2._backward_recompute(args, dims, g, cd)
    call_ms = time_ms(run, iters=3, warmup=1)
    split = kernel_device_ms(run, (FWD_KERNEL,) + K2_BWD_KERNELS, iters=2)
    xc, zc, gc = inputs(COARSE_VR, 1, cd)
    ca, cdims = operands(xc, zc, cd)
    coarse_ms = time_ms(lambda: K2._backward_recompute(ca, cdims, gc, cd), iters=3, warmup=1)
    del xc, zc, gc, ca

    def plain_pieces():  # the plain version's forward and backward, in pieces that fit
        for s in range(0, FINE_VR, BAND_TRAIN):
            e = min(FINE_VR, s + BAND_TRAIN)
            grads_of(plain(cd), (x[:, s:e], z[:, s:e], *w), g[s:e])

    plain_ms = time_ms(plain_pieces, iters=1, warmup=0)  # warmed up by (c)
    wbytes = sum(t.numel() for t in w) * 2
    io = FINE_VR * (CODE.d_raw * 4 * 2 + C * 2 * 2 + 4 * 4)  # x, dx, z, dz, g
    act = FINE_VR * 512 * 2  # one (N, 512) bf16 activation
    # the kernel: the forward's and the dgrad's products; it writes the 11
    # stash and 11 cotangent rows a point that the wgrad reads
    b_ms, b_by = bound(io + wbytes + 22 * act, 2 * decoder_flops(FINE_VR, 1), BF16_FLOPS)
    call_b_ms, call_b_by = bound(io + wbytes * 3, 3 * decoder_flops(FINE_VR, 1), BF16_FLOPS)
    return dict(name=K2.NAME_RECOMPUTE, source="avr_tpu_torch/csrc/resnetfc_hopper.cu",
                replaces="avr_tpu/ops/pallas/resnetfc.py:853", tpu_kernel="_bwd_impl",
                shape=f"N={FINE_VR} (VR fine pass), NS=1, d_hidden 512, 5 blocks, bf16, "
                      f"{K2.RECOMPUTE_CHUNK}-point chunks",
                cases=cases, ms=split[FWD_KERNEL] + sum(split[k] for k in DGRAD_KERNELS),
                split=split, wgrad_ms=sum(split[k] for k in WGRAD_KERNELS), call_ms=call_ms,
                coarse_call_ms=coarse_ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, call_bound_ms=call_b_ms, call_bound_by=call_b_by)


MARCH_GRADS = ("dcoords0", "drds", "dfeat", "dw_ih", "dw_hh", "dbias", "dw_out", "db_out")
MARCH_KEYS = ("coords0", "rds", "feat", "w_ih", "w_hh", "bias", "w_out", "b_out")
TIMED_HEAD = 0.01  # the timed K3 backward's step head: contractive over 10 steps


def march_draws(draws):
    """K3's bf16 10-step backward at the train step's shape (4 scenes x
    4,096 rays) over ``draws`` draws of its inputs, each from its own seeded
    generator, at the timed case's step head and at 0.05: one JSON line per
    draw and head, the worst relative L2 error of the kernel's gradients
    against the plain autograd beside how far the plain version's own
    gradients move when every start coordinate is nudged by 1e-6."""
    rel = lambda a, b: float((a - b).norm() / b.norm().clamp_min(1e-30))
    for seed, head in itertools.product(range(draws), (TIMED_HEAD, 0.05)):
        gen = torch.Generator(device=DEV).manual_seed(seed)
        inp = march_inputs(gen, 1, sb=SB_TRAIN, w_out_scale=head)
        g = randn(gen, SB_TRAIN, CHUNK, 3)
        nudge = 1e-6 * torch.sign(torch.randn(inp["coords0"].shape, generator=gen, device=DEV))
        grads = lambda fn, coords0: dict(zip(MARCH_GRADS, grads_of(
            lambda *t: fn(inp["proj"], *t, steps=STEPS, compute_dtype=torch.bfloat16),
            (coords0,) + tuple(inp[k] for k in MARCH_KEYS[1:]), g)))
        want = grads(lstm_march_plain, inp["coords0"])
        err = {k: rel(v, want[k]) for k, v in grads(fused_lstm_march, inp["coords0"]).items()}
        moved = {k: rel(v, want[k]) for k, v in
                 grads(lstm_march_plain, inp["coords0"] + nudge).items()}
        worst = max(err, key=err.get)
        print(json.dumps({"draw": seed, "w_out": head, "kernel_worst_rel_l2": err[worst],
                          "worst": worst, "tol": 2e-2, "plain_nudged_worst": max(moved.values()),
                          "plain_nudged_dcoords0": moved["dcoords0"]}))


def check_march_bwd(gen):
    cases = []
    keys = MARCH_KEYS

    def run(fn, inp, g, **kw):
        f = lambda *t: fn(inp["proj"], *t, **kw)
        return grads_of(f, tuple(inp[k] for k in keys), g)

    rel_l2 = lambda got, want: max((float((a - b).norm() / b.norm()), nm)
                                   for nm, a, b in zip(MARCH_GRADS, got, want))

    def conditioning(inp, g, got, want, label, **kw):
        """The worst gradient's relative L2 error beside how far the plain
        version's own gradients move when every start coordinate is nudged
        by 1e-6: the comparison's noise floor."""
        nudged = dict(inp, coords0=inp["coords0"] + 1e-6 * torch.sign(
            torch.randn(inp["coords0"].shape, generator=gen, device=DEV)))
        worst, moved = rel_l2(got, want), rel_l2(run(lstm_march_plain, nudged, g, **kw), want)
        print(f"K3 backward {label}: worst relative L2 against the plain autograd {worst}; the "
              f"plain version against itself with the start points nudged by 1e-6 {moved}")
        cases.append({"case": f"conditioning {label}", "against": "plain, nudged 1e-6",
                      "kernel_rel_l2": worst[0], "nudged_rel_l2": moved[0], "worst": moved[1]})

    # (scenes, views, steps, early-stop eps, cotangent scale, step-head
    # scale, operand dtype, tolerance on the relative L2 error).  float32:
    # sums in other orders only (1e-3).  bf16: the two sides round the
    # cotangents at other places and the bins sum dfeat in another order; a
    # few tenths of a percent (2e-2).  With the step head at 0.05
    # every step multiplies a perturbation of the points by ~3: at 10 steps
    # a 1e-6 nudge moves the plain version's own float32 gradients by O(1)
    # (the conditioning line), so the bounded float32 10-step case takes a
    # step head of 0.01, where the march is contractive; at 0.05 the
    # float32 error is reported beside that floor (tolerance None).  The
    # train step's own case (4 scenes, 10 steps, bf16) follows on the inputs
    # that are then timed, at the contractive step head of 0.01 too: at
    # 0.05 the bf16 roundings alone move the plain version's gradients past
    # 2e-2 on some draws (python3 chip_smoke.py --march-draws=8).  Hidden
    # 62, the widest the TPU kernel takes (two units a lane, W_ih^T from
    # L2), at the same tolerances.
    for sb, ns, steps, eps, scale, wo, cd, tol, hid in (
            (1, 1, 2, 0.0, 1.0, 0.05, torch.float32, 1e-3, 62),
            (1, 1, 2, 0.0, 1.0, 0.05, torch.bfloat16, 2e-2, 62),
            (1, 1, 2, 0.0, 1.0, 0.05, torch.float32, 1e-3, HIDDEN),
            (1, 2, 2, 0.0, 1.0, 0.05, torch.float32, 1e-3, HIDDEN),
            (SB_TRAIN, 1, STEPS, 0.0, 1.0, 0.01, torch.float32, 1e-3, HIDDEN),
            (SB_TRAIN, 1, STEPS, 0.0, 1.0, 0.05, torch.float32, None, HIDDEN),
            (SB_TRAIN, 1, 2, 0.0, 1.0, 0.05, torch.bfloat16, 2e-2, HIDDEN),
            (1, 2, 2, 0.0, 1.0, 0.05, torch.bfloat16, 2e-2, HIDDEN),
            (1, 1, 2, 0.02, 1.0, 0.05, torch.bfloat16, 2e-2, HIDDEN),
            (1, 1, 2, 0.0, 300.0, 0.05, torch.bfloat16, 2e-2, HIDDEN)):
        inp = march_inputs(gen, ns, dtype=cd, sb=sb, w_out_scale=wo, hidden=hid)
        g = randn(gen, sb, CHUNK, 3, scale=scale)
        kw = dict(steps=steps, early_stop_eps=eps, compute_dtype=cd)
        with march_routed(cd, backward=True):
            got = run(fused_lstm_march, inp, g, **kw)
        want = run(lstm_march_plain, inp, g, **kw)
        label = (f"SB={sb} NS={ns} steps={steps} eps={eps} x{scale} w_out {wo} {str(cd)[6:]} "
                 f"hidden {hid}")
        if tol is not None:
            cases += [check_l2(f"{nm} {label}", a, b, tol)
                      for nm, a, b in zip(MARCH_GRADS, got, want)]
        if cd == torch.float32:  # no float atomics: every gradient bit for bit on a rerun
            cases.append(check_rerun(f"rerun all eight gradients {label}", got,
                                     run(fused_lstm_march, inp, g, **kw)))
        if steps == STEPS:
            conditioning(inp, g, got, want, label, **kw)
        if scale > 1.0:  # the +-10 clip must bite: without it the gradients differ
            free = run(fused_lstm_march, inp, g, grad_clamp=1e30, **kw)
            if torch.allclose(free[3], got[3]):
                raise AssertionError("march: the gradient clip did not bind")
            cases.append({"case": "clip binds", "against": "no clip", "ok": True})
    # a NaN in one ray's cotangent passes through the clip, as through the
    # plain version's torch.clamp (and the TPU kernel's jnp.clip): the same
    # gradients come out non-finite on both sides, so the optimizer skips
    # the same steps
    inp = march_inputs(gen, 1)
    g = randn(gen, 1, CHUNK, 3)
    g[0, 0, 0] = float("nan")
    kw = dict(steps=2, compute_dtype=torch.bfloat16)
    nonfinite = lambda grads: [nm for nm, a in zip(MARCH_GRADS, grads)
                               if not bool(torch.isfinite(a).all())]
    got, want = (nonfinite(run(fn, inp, g, **kw)) for fn in (fused_lstm_march, lstm_march_plain))
    if got != want:
        raise AssertionError(f"march: a NaN cotangent leaves {got} non-finite, the plain "
                             f"version {want}")
    cases.append({"case": "NaN cotangent of one ray", "against": "plain, non-finite set",
                  "nonfinite": got})
    # float32 with early stop (a generator of its own): a frozen ray-step
    # writes zero rows at the point the forward saved, which the bins read;
    # the rays that froze are those whose end point moves without it
    fgen = torch.Generator(device=DEV).manual_seed(8)
    for ns in (1, 2):
        inp = march_inputs(fgen, ns, dtype=torch.float32)
        g = randn(fgen, 1, CHUNK, 3)
        kw = dict(steps=2, early_stop_eps=0.02, compute_dtype=torch.float32)
        with march_routed(torch.float32, backward=True):
            got = run(fused_lstm_march, inp, g, **kw)
        want = run(lstm_march_plain, inp, g, **kw)
        frozen = int((lstm_march_plain(**inp, **kw) != lstm_march_plain(
            **inp, **dict(kw, early_stop_eps=0.0))).any(-1).sum())
        if not frozen:
            raise AssertionError("march: no ray froze in the float32 early-stop case")
        label = f"SB=1 NS={ns} steps=2 eps=0.02 w_out 0.05 float32 ({frozen} rays froze)"
        cases += [check_l2(f"{nm} {label}", a, b, 1e-3) for nm, a, b in zip(MARCH_GRADS, got, want)]
        cases.append(check_rerun(f"rerun all eight gradients {label}", got,
                                 run(fused_lstm_march, inp, g, **kw)))
    inp = march_inputs(gen, 1, sb=SB_TRAIN, w_out_scale=TIMED_HEAD)
    g = randn(gen, SB_TRAIN, CHUNK, 3)
    f = lambda fn: (lambda *t: fn(inp["proj"], *t, steps=STEPS, compute_dtype=torch.bfloat16))
    got, run_k = grads_of(f(fused_lstm_march), tuple(inp[k] for k in keys), g, keep=True)
    want, run_p = grads_of(f(lstm_march_plain), tuple(inp[k] for k in keys), g, keep=True)
    label = f"SB={SB_TRAIN} NS=1 steps={STEPS} eps=0.0 x1.0 w_out {TIMED_HEAD} bf16 (timed)"
    for nm, a, b in zip(MARCH_GRADS, got, want):
        cases.append(check_l2(f"{nm} {label}", a, b, 2e-2))
    # no float atomics: all eight gradients bit for bit the same on a rerun
    cases.append(check_rerun(f"rerun all eight gradients {label}", got,
                             grads_of(f(fused_lstm_march), tuple(inp[k] for k in keys), g)))
    conditioning(inp, g, got, want, label, steps=STEPS, compute_dtype=torch.bfloat16)
    del got, want
    pair_ms, plain_ms = time_ms(run_k), time_ms(run_p, iters=3)
    split = kernel_device_ms(run_k, K3_BWD_KERNELS + WGRAD_KERNELS)
    bwd_ms = sum(split[k] for k in K3_BWD_KERNELS)  # the walk, the bins, the reduce
    wg_dev = sum(split[k] for k in WGRAD_KERNELS)
    smi = sustained(run_k, 1.0, SMI_FIELDS)  # the SM clock and power beside the time
    rays = SB_TRAIN * CHUNK
    rows = rays * STEPS
    hp = K3.padded_hidden(HIDDEN)
    # dW_ih's and dW_hh's GEMM as the wrapper launches it (two jobs over the
    # walk's rows, v_t | round(h_prev) and the permuted gate cotangents);
    # its yardstick torch.matmul of the same bf16 operands
    v = randn(gen, rows, C + hp, dtype=torch.bfloat16)
    dg = randn(gen, rows, 4 * hp, dtype=torch.bfloat16)
    gemm_library_ms = time_ms(lambda: torch.matmul(v.t(), dg))
    dw_ih = torch.zeros((C, 4 * hp), dtype=torch.float32, device=DEV)
    dw_hh = torch.zeros((hp, 4 * hp), dtype=torch.float32, device=DEV)
    wgrad_host = call_timing(
        lambda: K2.wgrad(K3.NAME_WGRAD, [
            (v.data_ptr(), dg.data_ptr(), dw_ih, None, rows, C + hp, 4 * hp, C, 4 * hp),
            (v.data_ptr() + 2 * C, dg.data_ptr(), dw_hh, None, rows, C + hp, 4 * hp, hp, 4 * hp)],
            torch.bfloat16, DEV), wg_dev)
    del v, dg, dw_ih, dw_hh
    fmap = inp["feat"].numel()
    aw = K3.aux_width(HIDDEN)
    # the function's own operations: dv and gh, the gather's blend and
    # dots; the bins: a product per (ray-step, tap, channel)
    walk_flops = rows * (2 * 4 * HIDDEN * (C + HIDDEN) + 16 * C + 8 * C)
    # the function's own bytes: the latent and the saved rows read once,
    # dfeat written once in bf16, the rays' points, directions and
    # cotangents, the weights; the rows the walk writes for the wgrad are
    # the design's, counted in the wgrad's bound
    b_ms, b_by = bound(fmap * 2 + rows * aw * 4 + fmap * 2 + rays * 3 * 4 * 4
                       + (C + HIDDEN) * 4 * HIDDEN * 2, walk_flops, BF16_FLOPS)
    # the parent's figure: a zeroed float32 dfeat written and the rows, no saved rows
    old_b = bound(fmap * 2 + 2 * fmap * 4 + rays * 3 * 4 * 4 + C * 4 * HIDDEN * 2
                  + rows * (C + 4 * HIDDEN) * 2,
                  rows * (2 * C * 4 * HIDDEN + 16 * C + 6 * HIDDEN * 4 * HIDDEN), BF16_FLOPS)
    wg_ms, wg_by = bound(rows * (C + hp + 4 * hp) * 2 + (C + hp) * 4 * hp * 4,
                         2 * rows * (C + hp) * 4 * hp, BF16_FLOPS)
    # the float32 route (warp per ray, the bins' float32 accumulate, the
    # float32 wgrad) at the same shape: its eight gradients bit for bit on a
    # rerun, and its time
    f32 = {k: (v.float() if v.is_floating_point() else v) for k, v in inp.items()}
    f32_fn = lambda *t: fused_lstm_march(f32["proj"], *t, steps=STEPS, compute_dtype=torch.float32)
    got32, run32 = grads_of(f32_fn, tuple(f32[k] for k in keys), g, keep=True)
    cases.append(check_rerun(f"rerun all eight gradients {label[:-len('bf16 (timed)')]}float32",
                             got32, run32()))
    del got32
    _, plain32 = grads_of(lambda *t: lstm_march_plain(f32["proj"], *t, steps=STEPS,
                                                      compute_dtype=torch.float32),
                          tuple(f32[k] for k in keys), g, keep=True)
    split32 = kernel_device_ms(run32, K3_F32_BWD_KERNELS + WGRAD_F32_KERNELS, iters=2)
    # its own bytes: a float32 latent read and dfeat written once, the saved
    # rows, the rays, the weights (the rows it writes for the bins and the
    # wgrad are the design's, as in the bf16 bound)
    kept = dict(kernel=K3_F32_KERNELS[1], ms=time_ms(run32, iters=3),
                device_ms=sum(split32[k] for k in K3_F32_BWD_KERNELS),
                wgrad_device_ms=sum(split32[k] for k in WGRAD_F32_KERNELS),
                device_ms_by_kernel=split32, plain_ms=time_ms(plain32, iters=2), library_ms=None,
                bound_ms=bound(fmap * 4 * 2 + rows * aw * 4 + rays * 3 * 4 * 4
                               + (C + HIDDEN) * 4 * HIDDEN * 4, walk_flops, F32_FLOPS)[0])
    del run32, plain32
    print(f"K3 backward timed: walk + bins + reduce {bwd_ms:.4f} device ms ({split}), bound "
          f"{b_ms:.4f} by {b_by} (the parent's figure {old_b[0]:.4f} by {old_b[1]}); SM "
          f"{smi['clocks.sm']} MHz, {smi['power.draw']} W; float32 walk + bins + reduce "
          f"{kept['device_ms']:.4f}, its dW_ih + dW_hh {kept['wgrad_device_ms']:.4f}")
    shape = f"{SB_TRAIN}x{CHUNK} rays x {STEPS} steps, NS=1, C={C}, hidden {HIDDEN}, bf16"
    common = dict(replaces="avr_tpu/ops/pallas/march.py:621", tpu_kernel="_bwd_kernel",
                  shape=shape, cases=cases, plain_ms=plain_ms, pair_ms=pair_ms)
    return [dict(name="fused_lstm_march_bwd", source="avr_tpu_torch/csrc/march.cu",
                 kernel=K3_BWD_KERNELS[0], ms=bwd_ms, device_ms_by_kernel=split, sustained=smi,
                 bound_ms=b_ms, bound_by=b_by, parent_bound_ms=old_b[0], library_ms=None,
                 kept_f32=kept, **common),
            dict(name="fused_lstm_march_bwd_wgrad", source="avr_tpu_torch/csrc/resnetfc_hopper.cu",
                 ms=wg_dev, bound_ms=wg_ms, bound_by=wg_by,
                 library_ms=gemm_library_ms, library="torch.matmul(v^T, dgates)", **wgrad_host,
                 **common)]


def check_integral_saturated(gen):
    """The integral's adjoint (plain PyTorch) with a saturated lane: no NaN."""
    z = torch.sort(torch.rand(SB_TRAIN, 64, 20, generator=gen, device=DEV), dim=-1)[0] + 0.5
    sigma = torch.rand(SB_TRAIN, 64, 20, 1, generator=gen, device=DEV) * 5
    sigma[:, :, 5] = 1e4  # alpha == 1 in float32: 1 - alpha is exactly 0
    rad = torch.rand(SB_TRAIN, 64, 20, 3, generator=gen, device=DEV)
    leaves = [t.requires_grad_(True) for t in (z, sigma, rad)]
    rgb, dist, wts = volume_integral(*leaves, white_back=True)
    grads = torch.autograd.grad(rgb.sum() + dist.sum() + wts.sum(), leaves)
    if not all(torch.isfinite(t).all() for t in grads):
        raise AssertionError("integral: non-finite gradient at a saturated lane")
    return {"case": "saturated lane", "finite": True}


N_BAND = 20  # the adaptive renderer's band samples a ray (conf n_coarse)


def integral_inputs(gen, sb, n=N_BAND, rays=CHUNK):
    """K4's inputs: per ray of a chunk ``n`` stratified band samples over +-0.15
    around a surface distance in [0.8, 1.6] (``sample_coarse``'s layout),
    colours in [0, 1] and densities of a ReLU'd decoder (a fifth of them 0,
    the rest up to 30); in scene 0 sample 4 of every 97th ray saturates (e
    is exactly 0) and ray 7 has no density at all."""
    d = 0.8 + 0.8 * torch.rand(sb, rays, 1, generator=gen, device=DEV)
    u = (torch.arange(n, device=DEV) + torch.rand(sb, rays, n, generator=gen, device=DEV)) / n
    z = (d - 0.15 + 0.3 * u).contiguous()
    fo = torch.rand(sb, rays * n, 4, generator=gen, device=DEV)
    fo[..., 3] *= 30.0
    fo[:, ::5, 3] = 0.0
    fo[0, 4::97 * n, 3] = 1e6
    fo[0, 7 * n:8 * n, 3] = 0.0
    return z, fo


def integral_bound(rays, n, backward):
    """Bytes: z and the field rows read (and their cotangents written, and
    the ray cotangents read, backward), the ray outputs written; operations
    ~20 float32 a sample each way."""
    io = rays * n * (4 + 16) * (2 if backward else 1) + rays * 16
    return bound(io, rays * n * 20 * (2 if backward else 1), F32_FLOPS)


# band samples a ray beside the renderer's 20: the quality series' 2x
# epsilon sweep's 40, two groups of 32 for the kernel's warp
N_BAND_WIDE = 40


# K4's forward at the envelope's edges (a generator of their own): one
# sample a ray, a full group of 32 and one past it, ray counts off the CTA's
# 32 rays (one ray, and 1,000 in 2 scenes) and no ray at all
INTEGRAL_EDGES = ((1, 1, CHUNK), (1, 32, CHUNK), (SB_TRAIN, 33, CHUNK), (1, N_BAND, 1),
                  (2, N_BAND, 1_000), (1, 33, 1_000), (1, N_BAND, 0))


def check_integral(gen, gen_edges):
    cases = []
    # the train step's band and a serving chunk; at 20 and 40 samples a ray;
    # then the envelope's edges
    for i, (sb, n, rays) in enumerate(((SB_TRAIN, N_BAND, CHUNK), (1, N_BAND, CHUNK),
                                       (SB_TRAIN, N_BAND_WIDE, CHUNK), (1, N_BAND_WIDE, CHUNK))
                                      + INTEGRAL_EDGES):
        z, fo = integral_inputs(gen if i < 4 else gen_edges, sb, n, rays)
        got = K4.fused_volume_integral(z, fo)
        want = K4.fused_volume_integral_plain(z, fo)
        # float32 on both sides: the transmittance's prefix product is
        # associated as the TPU kernel's doubling against cumprod, the sums
        # in another order; colours and distances are O(1): 1e-5
        for nm, a, b in zip(("rgb", "distance"), got, want):
            if not torch.isfinite(a).all() or a.shape != b.shape:
                raise AssertionError(f"K4 {nm}: non-finite output or shape {tuple(a.shape)}")
            cases.append(check(f"{nm} SB={sb} R={rays} n={n}", max_err(a, b) if rays else 0.0,
                               1e-5))
        if sb == 1 and rays == CHUNK and max_err(got[0][0, 7], torch.ones(3, device=DEV)) > 1e-6:
            raise AssertionError("K4: the ray of zero density is not white background")
    z, fo = integral_inputs(gen, SB_TRAIN)
    run = lambda: K4.fused_volume_integral(z, fo)
    ms = kernel_device_ms(run, ("volume_integral_kernel",), iters=20)["volume_integral_kernel"]
    zs, fs = integral_inputs(gen_edges, 1)  # a served chunk: 1 x 4,096 rays
    serve = lambda: K4.fused_volume_integral(zs, fs)
    serve_ms = kernel_device_ms(serve, ("volume_integral_kernel",),
                                iters=20)["volume_integral_kernel"]
    b_ms, b_by = integral_bound(SB_TRAIN * CHUNK, N_BAND, False)
    call_ms, serve_call_ms = time_ms(run, iters=50), time_ms(serve, iters=50)
    print(f"K4 forward: band {SB_TRAIN}x{CHUNK}x{N_BAND} {ms:.4f} device ms (call {call_ms:.4f}), "
          f"served chunk 1x{CHUNK}x{N_BAND} {serve_ms:.4f} (call {serve_call_ms:.4f}); "
          f"{len(cases)} cases within 1e-5")
    return dict(name=K4.NAME, source="avr_tpu_torch/csrc/integrate.cu",
                replaces="avr_tpu/ops/pallas/integrate.py:302",
                tpu_kernel="fused_volume_integral (_run_fwd)",
                shape=f"{SB_TRAIN}x{CHUNK} rays x {N_BAND} samples, f32", cases=cases, ms=ms,
                call_ms=call_ms,
                plain_ms=time_ms(lambda: K4.fused_volume_integral_plain(z, fo), iters=20),
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                serve=dict(shape=f"1x{CHUNK} rays x {N_BAND} samples", device_ms=serve_ms,
                           call_ms=serve_call_ms,
                           bound_ms=integral_bound(CHUNK, N_BAND, False)[0]))


def check_integral_bwd(gen):
    cases = []
    for sb, n in ((SB_TRAIN, N_BAND), (1, N_BAND), (SB_TRAIN, N_BAND_WIDE), (1, N_BAND_WIDE)):
        z, fo = integral_inputs(gen, sb, n)
        g = (randn(gen, sb, CHUNK, 3), randn(gen, sb, CHUNK, 1))
        got = grads_of(K4.fused_volume_integral, (z, fo), g)
        want = grads_of(K4.fused_volume_integral_plain, (z, fo), g)
        # relative L2, float32 without atomics: the closed form divides by
        # q = 1 - alpha + 1e-10 (the TPU kernel's) where the plain adjoint
        # divides by exp(-sigma delta) + 1e-10, and the suffix sums and
        # products associate differently: 1e-5.  The empty ray's last
        # sample has sigma 0 under the constant 1e10 step, so its density
        # cotangent is ~1e10 on both sides: held on its own (relative to its
        # largest value) and masked out of the density channel's L2
        label = f"SB={sb} R={CHUNK} n={n}"
        keep = torch.ones_like(fo[..., 3])
        keep[0, 7 * n:8 * n] = 0.0
        cases += [check_l2(f"dz {label}", got[0], want[0], 1e-5),
                  check_l2(f"dfo rgb {label}", got[1][..., :3], want[1][..., :3], 1e-5),
                  check_l2(f"dfo sigma {label} (the empty ray apart)", got[1][..., 3] * keep,
                           want[1][..., 3] * keep, 1e-5),
                  check_rel(f"dfo sigma {label}, the empty ray", got[1][0, 7 * n:8 * n, 3],
                            want[1][0, 7 * n:8 * n, 3], 1e-5)]
    n = N_BAND
    z, fo = integral_inputs(gen, SB_TRAIN)
    g = (randn(gen, SB_TRAIN, CHUNK, 3), randn(gen, SB_TRAIN, CHUNK, 1))
    _, run = grads_of(K4.fused_volume_integral, (z, fo), g, keep=True)
    _, run_plain = grads_of(K4.fused_volume_integral_plain, (z, fo), g, keep=True)
    ms = kernel_device_ms(run, ("volume_integral_bwd_kernel",),
                          iters=20)["volume_integral_bwd_kernel"]
    b_ms, b_by = integral_bound(SB_TRAIN * CHUNK, n, True)
    return dict(name=K4.NAME_BWD, source="avr_tpu_torch/csrc/integrate.cu",
                replaces="avr_tpu/ops/pallas/integrate.py:276", tpu_kernel="fused_volume_integral "
                "VJP (bwd)", shape=f"{SB_TRAIN}x{CHUNK} rays x {n} samples, f32", cases=cases,
                ms=ms, call_ms=time_ms(run, iters=50), plain_ms=time_ms(run_plain, iters=20),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def proj_inputs(gen, sb, ns, dtype, n):
    """K5's inputs at a field query of ``sb`` scenes and ``ns`` views: the
    latent, the points broadcast over the views, and each view's packed
    projection.  The points lie on ``march_inputs``' rays, which are
    jittered off the pixel centres and seen by source views that are not
    the ray camera: at the band query (``n = BAND``) ``N_BAND`` a ray over
    +-0.15 about the marched point, at the coarse query (``n = CHUNK``) the
    marched point itself, one a ray."""
    inp = march_inputs(gen, ns, dtype=dtype, sb=sb)
    pts = inp["coords0"]
    if n == BAND:
        off = (torch.rand(sb, CHUNK, N_BAND, 1, generator=gen, device=DEV) - 0.5) * 0.3
        pts = pts[:, :, None] + inp["rds"][:, :, None] * off
    pts = pts.reshape(sb, 1, n, 3).expand(sb, ns, n, 3).reshape(sb * ns, n, 3)
    return (inp["feat"].reshape(sb * ns, LATENT, LATENT, C), pts.contiguous(),
            inp["proj"].reshape(sb * ns, 16).contiguous())


# every field query of the fused path goes through K5: the band (BAND
# points a scene) and the coarse query at the marched point (CHUNK)
PROJ_CASES = [(sb, ns, cd, n) for sb in (1, SB_TRAIN) for ns in (1, 2)
              for cd in (torch.bfloat16, torch.float32) for n in (BAND, CHUNK)]


def proj_bound(b, n, dtype, backward):
    """K1's bytes plus the points (12 B a point) and the 16 scalars a view;
    backward (``gather_bwd_bytes``) dfeat once in the map's dtype and the
    points' cotangent; operations: the projection (~20 a point) and 8
    (forward) or 16 (backward) a channel."""
    elt = torch.finfo(dtype).bits // 8
    hwc, pts = b * LATENT * LATENT * C, b * n
    if backward:
        io = gather_bwd_bytes(pts, hwc, elt, 24) + b * 64
    else:
        io = hwc * elt + pts * C * elt + pts * 12 + b * 64
    return bound(io, pts * (20 + (16 if backward else 8) * C), F32_FLOPS)


def check_gather_proj(gen):
    cases = []
    for sb, ns, cd, n in PROJ_CASES:
        feat, pts, proj = proj_inputs(gen, sb, ns, cd, n)
        got = gather_bilinear_projected(feat, pts, proj)
        want = gather_bilinear_projected_plain(feat, pts, proj)
        # bitwise equal by construction (the projection and K1's taps and
        # blend, each operation rounded on its own in the plain version's
        # order); the tolerance allows one rounding flip of a value of ~4:
        # a bf16 ulp (2e-2), a few float32 ulps (1e-5)
        tol = 2e-2 if cd == torch.bfloat16 else 1e-5
        label = f"SB={sb} NS={ns} N={n} {str(cd)[6:]}"
        cases.append(dict(check(label, max_err(got, want), tol), bitwise=same_bits(got, want)))
        del feat, pts, proj, got, want
    feat, pts, proj = proj_inputs(gen, 1, 1, torch.bfloat16, BAND)  # the serving band call
    run = lambda: gather_bilinear_projected(feat, pts, proj)
    ms = kernel_device_ms(run, (K5_FWD_KERNEL,), iters=20)[K5_FWD_KERNEL]
    b_ms, b_by = proj_bound(1, BAND, torch.bfloat16, False)
    bits = [c["bitwise"] for c in cases]
    print(f"K5 forward: bitwise equal to the plain version in {sum(bits)} of {len(bits)} cases")
    return dict(name="gather_bilinear_projected", source="avr_tpu_torch/csrc/gather.cu",
                replaces="avr_tpu/ops/pallas/gather.py:642",
                tpu_kernel="gather_bilinear_projected",
                shape=f"latent 1x{LATENT}x{LATENT}x{C} bf16, N={BAND}", cases=cases, ms=ms,
                call_ms=time_ms(run, iters=20),
                plain_ms=time_ms(lambda: gather_bilinear_projected_plain(feat, pts, proj)),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def check_gather_proj_bwd(gen):
    cases = []
    for sb, ns, cd, n in PROJ_CASES:
        feat, pts, proj = proj_inputs(gen, sb, ns, cd, n)
        g = randn(gen, sb * ns, n, C, dtype=cd)
        fk = lambda f, p: gather_bilinear_projected(f, p, proj)
        fp = lambda f, p: gather_bilinear_projected_plain(f, p, proj)
        got, want = grads_of(fk, (feat, pts), g), grads_of(fp, (feat, pts), g)
        # relative L2 (the plain version's float32 sums run in another
        # order).  dfeat: float32 1e-5 (order only); bf16 2^-7: the kernel
        # rounds the tap weight to bf16 before w * g (as the TPU kernel
        # does), the plain version does not, and both round the sum to bf16
        # once.  dpoints: float32 dots of C products in another order, times
        # (W - 1) / 2 and the focal, chained through the projection (the
        # kernel multiplies by 1 / cam_z where autograd divides): 1e-4
        label = f"SB={sb} NS={ns} N={n} {str(cd)[6:]}"
        cases += [check_l2(f"dfeat {label}", got[0], want[0],
                           2.0 ** -7 if cd == torch.bfloat16 else 1e-5),
                  check_l2(f"dpoints {label}", got[1], want[1], 1e-4),
                  check_rerun(f"rerun {label}", got, grads_of(fk, (feat, pts), g))]
        del feat, pts, proj, g, got, want
    feat, pts, proj = proj_inputs(gen, SB_TRAIN, 1, torch.bfloat16, BAND)  # the train step's
    g = randn(gen, SB_TRAIN, BAND, C, dtype=torch.bfloat16)
    _, run = grads_of(lambda f, p: gather_bilinear_projected(f, p, proj), (feat, pts), g,
                      keep=True)
    _, run_plain = grads_of(lambda f, p: gather_bilinear_projected_plain(f, p, proj),
                            (feat, pts), g, keep=True)
    ms, by_kernel = bwd_device_ms(run, K5_BWD_KERNELS)
    smi = sustained(run, 1.0, SMI_FIELDS)
    no_host_sync(run)
    b_ms, b_by = proj_bound(SB_TRAIN, BAND, torch.bfloat16, True)
    return dict(name="gather_bilinear_projected_bwd", source="avr_tpu_torch/csrc/gather.cu",
                replaces="avr_tpu/ops/pallas/gather.py:712", tpu_kernel="_pbwd",
                shape=f"latent {SB_TRAIN}x{LATENT}x{LATENT}x{C} bf16, N={BAND} per scene",
                cases=cases, ms=ms, device_ms_by_kernel=by_kernel, sustained=smi,
                call_ms=time_ms(run),
                plain_ms=time_ms(run_plain, iters=3), library_ms=None, bound_ms=b_ms,
                bound_by=b_by)


def unproject(proj, grid, depth):
    """World points that ``proj`` (B, 16) projects to ``grid`` (B, N, 2) at
    camera depth ``depth`` (B, N): cam_xy = (cg - grid) / fg * z, x = R^T
    (cam - t)."""
    R, t = proj[:, :9].reshape(-1, 3, 3), proj[:, 9:12]
    fg, cg = proj[:, None, 12:14], proj[:, None, 14:16]
    cam = torch.cat([(cg - grid) / fg * depth[..., None], depth[..., None]], -1)
    return torch.einsum("bij,bni->bnj", R, cam - t[:, None]).contiguous()


def check_gather_proj_bwd_bins(gen, k5):
    """K5's binned backward at the sort's hard cases, each run twice (bit
    for bit equal), added to ``k5``'s cases: every point projecting into
    one tile of its view, points on tile edges and the map border (from
    ``edge_grid``, unprojected at depths 0.8 to 1.8 through each view's
    camera), a point count off any multiple, none; bf16 and float32, 1 and
    4 scenes, NS 2.  Draws from a generator of its own."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    for label, sb, ns, n, dt in (("one tile", SB_TRAIN, 1, BAND, bf),
                                 ("one tile", 1, 2, BAND, f32),
                                 ("edges", SB_TRAIN, 2, 1_037, bf), ("edges", 1, 1, 1_037, f32),
                                 ("empty", SB_TRAIN, 2, 0, bf), ("empty", 1, 1, 0, f32)):
        feat, _, proj = proj_inputs(gen, sb, ns, dt, CHUNK)
        b = sb * ns
        grid = one_tile_grid(gen, b, n) if label == "one tile" else edge_grid(gen, b, n)
        # camera depth 0.8 to 1.8 in front (the cameras look down -z)
        depth = -0.8 - torch.rand(b, n, generator=gen, device=DEV)
        pts = unproject(proj, grid, depth)
        g = randn(gen, b, n, C, dtype=dt)
        fk = lambda f, p: gather_bilinear_projected(f, p, proj)
        got = grads_of(fk, (feat, pts), g)
        name = f"{label} SB={sb} NS={ns} N={n} {str(dt)[6:]}"
        cases.append(check_rerun(f"rerun {name}", got, grads_of(fk, (feat, pts), g)))
        if n == 0:
            cases.append(check(f"dfeat {name}", max_err(got[0], torch.zeros_like(feat)), 0.0))
            continue
        want = grads_of(lambda f, p: gather_bilinear_projected_plain(f, p, proj), (feat, pts), g)
        # as check_gather_proj_bwd
        cases += [check_l2(f"dfeat {name}", got[0], want[0], 2.0 ** -7 if dt == bf else 1e-5),
                  check_l2(f"dpoints {name}", got[1], want[1], 1e-4)]
    k5["cases"] += cases
    t = k5["sustained"]
    print(f"K5 backward: {sum(c['against'] == 'rerun' for c in k5['cases'])} cases bit for "
          f"bit equal on a rerun; device {k5['ms']:.4f} ms (1 s loop {t['ms']:.4f} ms at "
          f"{t['clocks.sm']} MHz, {t['power.draw']} W), by kernel {k5['device_ms_by_kernel']}")


def fwd_timed(run, kernel):
    """A forward's device ms (``torch.profiler``), its back-to-back call
    ms (CUDA events) and a 1 s loop with the SM clock and power."""
    return dict(device_ms=kernel_device_ms(run, (kernel,), iters=20)[kernel],
                call_ms=time_ms(run, iters=20), sustained=sustained(run, 1.0, SMI_FIELDS))


def check_gather_fwd_cases(gen, k1, k5):
    """K1's and K5's tiled forward at the edges of their envelope, each held
    bit for bit to its plain version (the same rounded operations in the
    same order), added to ``k1``'s and ``k5``'s cases: bf16 and float32; 1,
    3 and 8 maps (8: SB 4 x NS 2); N = 0, 1, a partial last tile, the band;
    C 512 and the smallest (16 bf16, 4 float32); points on and beyond the
    map border (``edge_grid``; K5's unprojected through each view's camera
    at depths 0.8 to 1.8).  Then both timed at the serving band (1 x 81,920
    points, bf16) at the same points twice: ray-shaped (``proj_inputs``'
    band points; K1 at their projection) and uniform grid coordinates in
    [-1.1, 1.1] (K5 at their unprojection).  Draws from a generator of its
    own."""
    bf, f32 = torch.bfloat16, torch.float32
    bits = {"K1": [], "K5": []}
    for dt in (bf, f32):
        small = 16 // (torch.finfo(dt).bits // 8)
        for b, n, c in ((1, BAND, C), (2 * SB_TRAIN, CHUNK, C), (2 * SB_TRAIN, 1, C),
                        (2 * SB_TRAIN, 0, C), (3, 1_037, C), (2, 333, small),
                        (2 * SB_TRAIN, 4_097, small)):
            feat = randn(gen, b, LATENT, LATENT, c, dtype=dt)
            grid = edge_grid(gen, b, n)
            sb, ns = (SB_TRAIN, 2) if b == 2 * SB_TRAIN else (b, 1)
            proj = march_inputs(gen, ns, sb=sb)["proj"].reshape(b, 16)
            pts = unproject(proj, grid, -0.8 - torch.rand(b, n, generator=gen, device=DEV))
            label = f"B={b} N={n} C={c} {str(dt)[6:]}"
            for k, kd, got, want in (
                    ("K1", k1, gather_bilinear(feat, grid), gather_bilinear_plain(feat, grid)),
                    ("K5", k5, gather_bilinear_projected(feat, pts, proj),
                     gather_bilinear_projected_plain(feat, pts, proj))):
                if got.shape != (b, n, c) or got.dtype != dt:
                    raise AssertionError(f"{k} forward {label}: {got.dtype} {tuple(got.shape)}")
                err = max_err(got, want) if n else 0.0
                kd["cases"].append(dict(check(f"edges {label}", err, 0.0),
                                        bitwise=same_bits(got, want)))
                bits[k].append(kd["cases"][-1]["bitwise"])
            del feat, grid, proj, pts
    feat, pts, proj = proj_inputs(gen, 1, 1, bf, BAND)
    grid = project_packed(proj, pts).contiguous()
    grid_u = (torch.rand(1, BAND, 2, generator=gen, device=DEV) * 2.2 - 1.1).contiguous()
    pts_u = unproject(proj, grid_u, -0.8 - torch.rand(1, BAND, generator=gen, device=DEV))
    if not same_bits(gather_bilinear(feat, grid), gather_bilinear_projected(feat, pts, proj)):
        raise AssertionError("K1 at the projected band points differs from K5 at the points")
    for kd, kernel, ray, uniform in (
            (k1, K1_FWD_KERNEL, lambda: gather_bilinear(feat, grid),
             lambda: gather_bilinear(feat, grid_u)),
            (k5, K5_FWD_KERNEL, lambda: gather_bilinear_projected(feat, pts, proj),
             lambda: gather_bilinear_projected(feat, pts_u, proj))):
        kd["band"] = dict(ray=fwd_timed(ray, kernel), uniform=fwd_timed(uniform, kernel))
    for k, kd in (("K1", k1), ("K5", k5)):
        b, t = [c.get("bitwise") for c in kd["cases"] if "bitwise" in c], kd["band"]
        clock = lambda r: f"{r['sustained']['clocks.sm']} MHz, {r['sustained']['power.draw']} W"
        print(f"{k} forward: bitwise equal to the plain version in {sum(b)} of {len(b)} cases "
              f"({sum(bits[k])} of {len(bits[k])} at the envelope's edges); band N={BAND} bf16 "
              f"device ms: ray-shaped {t['ray']['device_ms']:.4f} (call "
              f"{t['ray']['call_ms']:.4f}; 1 s loop {t['ray']['sustained']['ms']:.4f} at "
              f"{clock(t['ray'])}), uniform {t['uniform']['device_ms']:.4f} (call "
              f"{t['uniform']['call_ms']:.4f}; {t['uniform']['sustained']['ms']:.4f} at "
              f"{clock(t['uniform'])}); bound {kd['bound_ms']:.4f} by {kd['bound_by']}, plain "
              f"{kd['plain_ms']:.4f}, library {kd['library_ms']}")


# K7's draws on the main paths: a served adaptive chunk's band (1 x 81,920),
# the train step's band (4 x 81,920), the VR's coarse draw (4 x 262,144), and
# a ragged shape; several keys, split and folded ones among them
RNG_SHAPES = ((1, BAND), (SB_TRAIN, BAND), (SB_TRAIN, 64 * CHUNK), (3, 1_000))
RNG_KEYS = (threefry.PRNGKey(0), threefry.PRNGKey(7), threefry.split(threefry.PRNGKey(3))[1],
            threefry.fold_in(threefry.PRNGKey(5), 123))
# integer operations an element: 20 rounds of add, rotate and xor (60), the
# 12 key-injection adds, the epilogue's xor, shift, or and subtract (4)
THREEFRY_OPS = 76


def check_rng():
    """K7 against its plain version on the card at every shape and key, bit
    for bit (integer arithmetic and one exact subtraction: tolerance 0), its
    raw bits at the device sampler's (4, 4,096); then the TPU kernel's
    contract (``tests/test_pallas_rng.py``): range [0, 1), mean and
    variance, determinism, key sensitivity, decorrelated column blocks."""
    cases = []

    def bitwise(label, got, want):
        if not same_bits(got, want):
            raise AssertionError(f"K7 {label}: not bit for bit equal to the plain version")
        cases.append(dict(check(label, float((got.double() - want.double()).abs().max()), 0.0),
                          bitwise=True))

    for key in RNG_KEYS:
        for shape in RNG_SHAPES:
            bitwise(f"uniform {shape} key {tuple(key)}", K7.uniform_2d(key, shape, DEV),
                    K7.uniform_2d_plain(key, shape, DEV))
        shape = (SB_TRAIN, CHUNK)
        bitwise(f"bits {shape} key {tuple(key)}", K7.bits(key, shape, DEV),
                K7.bits_plain(key, shape, DEV))
    u = K7.uniform_2d(threefry.PRNGKey(0), (SB_TRAIN, BAND), DEV)
    if not (float(u.min()) >= 0.0 and float(u.max()) < 1.0):
        raise AssertionError(f"K7: values outside [0, 1): {float(u.min())}..{float(u.max())}")
    cases += [check("mean (4, 81,920)", abs(float(u.double().mean()) - 0.5), 5e-3, "contract"),
              check("variance (4, 81,920)", abs(float(u.double().var(unbiased=False)) - 1 / 12),
                    5e-3, "contract")]
    a, b = (K7.uniform_2d(threefry.PRNGKey(7), (2, 4096), DEV) for _ in range(2))
    c = K7.uniform_2d(threefry.PRNGKey(8), (2, 4096), DEV)
    if not same_bits(a, b) or not float((a - c).abs().max()) > 0.1:
        raise AssertionError("K7: not deterministic in the key, or not sensitive to it")
    u = K7.uniform_2d(threefry.PRNGKey(3), (2, 16_384), DEV)
    blocks = torch.stack([u[:, :8192].reshape(-1), u[:, 8192:].reshape(-1)]).double()
    cases.append(check("columns 0-8,191 against 8,192-16,383: |correlation|",
                       abs(float(torch.corrcoef(blocks)[0, 1])), 0.02, "contract"))
    u = K7.uniform_2d(threefry.PRNGKey(1), (3, 1_000), DEV)
    if u.shape != (3, 1_000) or not (float(u.min()) >= 0.0 and float(u.max()) < 1.0):
        raise AssertionError("K7: the ragged draw is wrong in shape or range")
    shape, key = (SB_TRAIN, BAND), threefry.PRNGKey(1)
    run = lambda: K7.uniform_2d(key, shape, DEV)
    n = SB_TRAIN * BAND
    b_ms, b_by = bound(n * 4, n * THREEFRY_OPS, INT32_OPS)
    bits_shape = (SB_TRAIN, CHUNK)
    return dict(name=K7.NAME, source="avr_tpu_torch/csrc/rng.cu",
                replaces="avr_tpu/ops/pallas/rng.py:54", tpu_kernel="pallas_uniform_2d",
                shape=f"{shape} float32 (the train band's draw)", cases=cases,
                ms=kernel_device_ms(run, ("threefry_kernel",), iters=20)["threefry_kernel"],
                call_ms=time_ms(run, iters=50),
                plain_ms=time_ms(lambda: K7.uniform_2d_plain(key, shape, DEV), iters=10),
                library_ms=time_ms(lambda: torch.rand(shape, device=DEV), iters=50),
                library="torch.rand (another stream)", bound_ms=b_ms, bound_by=b_by,
                bits_ms=kernel_device_ms(lambda: K7.bits(key, bits_shape, DEV),
                                         ("threefry_kernel",), iters=20)["threefry_kernel"],
                bits_shape=str(bits_shape))


# ---------------------------------------------------------------------------
# phase 3: the serving path
# ---------------------------------------------------------------------------


def scene_batch(seed=0):
    rng = np.random.default_rng(seed)
    c2w = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    c2w[2, 3] = 1.3
    K = np.asarray([[1.09375, 0, 0.5], [0, 1.09375, 0.5], [0, 0, 1]], np.float32)
    return dict(images=rng.uniform(-1, 1, (1, 1, SIDE * SIDE, 3)).astype(np.float32),
                cam2world=c2w[None, None], focal=np.full((1, 1), 1.09375 * SIDE, np.float32),
                c=np.full((1, 1, 2), SIDE / 2, np.float32), intrinsics=K[None, None])


def encode_scene(model, batch, dev):
    src = torch.as_tensor(batch["images"]).reshape(1, 1, SIDE, SIDE, 3).to(dev)
    return model.encode(src, torch.as_tensor(batch["cam2world"]).to(dev),
                        float(batch["focal"][0, 0]), torch.as_tensor(batch["c"][0, 0]).to(dev))


# the adaptive renderer's fused path: K5's gather, K4's band integral
FUSED = dict(gather_impl="pallas_proj", fused_integral="always")
# each path: make_model's renderer name and keywords
PATHS = {"adaptive": ("", {}), "VR": ("VR", {}), "Raymarcher": ("Raymarcher", {}),
         "adaptive_fused": ("", FUSED)}
# kernel launches per 4,096-ray chunk of a served frame, by path: the
# adaptive renderer marches and queries twice (coarse point, band), the VR
# queries its coarse and fine samples, the Raymarcher marches and queries
# once; the fused path queries through K5 and composites the band in K4.
# K7 draws the chunk's jitter: the march's initial distance (a normal) and
# the band; the VR's coarse samples, its two importance draws and its depth
# normal; the Raymarcher's initial distance
SERVE_LAUNCHES = {
    "adaptive": {"fused_lstm_march": 1, "gather_bilinear": 2, "fused_resnetfc": 2,
                 K7.NAME: 2},
    "VR": {"gather_bilinear": 2, "fused_resnetfc": 2, K7.NAME: 4},
    "Raymarcher": {"fused_lstm_march": 1, "gather_bilinear": 1, "fused_resnetfc": 1,
                   K7.NAME: 1},
    "adaptive_fused": {"fused_lstm_march": 1, "gather_bilinear_projected": 2,
                       "fused_resnetfc": 2, "fused_volume_integral": 1, K7.NAME: 2},
}


def path_model(path, dtype, dev):
    """The full-width model of ``path`` with the benchmark weights
    (``bench_weights``: every matrix live, fc_1 too, so the decoder's
    backward kernels are held to nonzero cotangents)."""
    renderer, kw = PATHS[path]
    model = make_model(dtype=dtype, seed=0, device=dev, renderer=renderer, **kw)
    bench_weights(model, 0)
    return model


def run_slice(path="adaptive", frames=3, dtype=torch.bfloat16):
    """Serve ``frames`` orbit frames of 128x128 through ``generate_video``
    with the full-width model of ``path`` (a key of PATHS) in ``dtype``; the
    launch counters are reset just before and read just after."""
    model = path_model(path, dtype, DEV)
    batch = scene_batch()
    generate_video(model, batch, 1, 1.3, render_chunk=CHUNK, device=DEV)  # warm-up: cuDNN/cuBLAS set-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    video = generate_video(model, batch, frames, 1.3, render_chunk=CHUNK, device=DEV)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(_build.launches)
    chunks = frames * SIDE * SIDE // CHUNK
    want = {k: v * chunks for k, v in SERVE_LAUNCHES[path].items()
            if dtype == torch.bfloat16 or k not in BF16_ROUTES}
    if dtype == torch.float32:  # every float32 K2 forward on the float32 kernel
        want[K2.NAME_F32] = want.get(K2.NAME, 0) + want.get(K2.NAME_STASH, 0)
    if counts != want:
        raise AssertionError(f"{path} serve: launch counts {counts} != expected {want}")
    if len(video) != frames or any(f.shape != (SIDE, SIDE, 3) for f in video):
        raise AssertionError("wrong frame count or shape")
    # outside the counted run: frame 0 as floats (finite, in [0, 1], the
    # image the video holds), then the time of one frame's render alone
    poses = orbit_cam2world(frames, 1.3)
    intr = torch.as_tensor(batch["intrinsics"][:, 0])
    with torch.inference_mode():
        cond = encode_scene(model, batch, DEV)
        out = render_full_image(model, cond, intr, poses[:1], SIDE, threefry.PRNGKey(0), CHUNK,
                                DEV)
    for name, value in out._asdict().items():
        if value is not None and not torch.isfinite(value).all():
            raise AssertionError(f"{name} has non-finite values")
    rgb = (out.rgb_coarse if out.rgb_fine is None else out.rgb_fine).float()
    if rgb.min() < 0 or rgb.max() > 1 + 1e-6:
        raise AssertionError(f"rgb outside [0, 1]: {float(rgb.min())}..{float(rgb.max())}")
    img = np.clip(rgb[0].reshape(SIDE, SIDE, 3).cpu().numpy() * 255.0, 0, 255).astype(np.uint8)
    if np.abs(img.astype(int) - video[0].astype(int)).max() > 1:
        raise AssertionError("video frame 0 differs from its float render")
    render = lambda i: render_full_image(model, cond, intr, poses[i % frames][None], SIDE,
                                         threefry.PRNGKey(i), CHUNK, DEV)
    frame_ms = []
    for i in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        render(i)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
    res = dict(path=path, frames=frames, video_seconds=seconds,
               frame_ms=frame_ms, ms_per_frame=float(np.median(frame_ms)),
               rays_per_s=SIDE * SIDE / float(np.median(frame_ms)) * 1e3, launches=counts,
               rgb_mean=float(rgb.mean()))
    if out.acc is not None:
        res["acc_mean"] = float(out.acc.mean())
    return res, render


def march_bins_us(events):
    """Device us of the bin kernels K3's bf16 backward launches.  They share
    the scan's, plan's and reduce's names with K1's and K5's bins; one C
    call launches them on one stream after its walk and before its partials
    kernel, so they are the bin kernels that run between those two."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted((e for e in events if e.device_type == cuda),
                     key=lambda e: e.time_range.start)
    us, inside = 0.0, False
    for e in kernels:
        if K3_BWD_KERNELS[0] in e.name:
            inside = True
        elif K3_BWD_KERNELS[1] in e.name:
            inside = False
        elif inside and any(k in e.name for k in GATHER_BIN_KERNELS):
            us += e.time_range.elapsed_us()
    return us


def profile_frame(render, label="frame", out_dir="traces"):
    """One call of ``render`` (a frame, or a train step) under
    ``torch.profiler``: device time by operation, the device's busy share of
    the call's wall time, and a chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    render(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        render(0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == cuda]
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    ours = (GATHER_FWD_KERNEL, "gather_bilinear_bwd_kernel", "resnetfc_kernel",
            FWD_KERNEL, *K2_BWD_KERNELS, F32_FWD_KERNEL, F32_DGRAD_KERNEL, *WGRAD_F32_KERNELS,
            *K3_FWD_KERNELS, *K3_BWD_KERNELS, *K3_F32_KERNELS,
            "gather_projected_bwd_kernel", *GATHER_BIN_KERNELS, "volume_integral_kernel",
            "volume_integral_bwd_kernel", "threefry_kernel")
    kernel_us = sum(r[1] for r in rows if any(o in r[0] for o in ours))
    # K3: its kernels and the bins its backward launches; K1's or K5's
    # backward: its front pass and the other bin launches
    k3_bins_us = march_bins_us(prof.events())
    k3_us = k3_bins_us + sum(r[1] for r in rows if any(
        o in r[0] for o in K3_FWD_KERNELS + K3_F32_KERNELS + K3_BWD_KERNELS[:2]))
    gather_bwd_us = sum(r[1] for r in rows if any(o in r[0] for o in K1_BWD_KERNELS
                                                  + K5_BWD_KERNELS[:1])) - k3_bins_us
    gather_fwd_us = sum(r[1] for r in rows if GATHER_FWD_KERNEL in r[0])
    print(f"profile {label}: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"({busy_us / wall_us:.3f} of wall), port kernels {kernel_us / 1e3:.3f} ms, gather "
          f"forward {gather_fwd_us / 1e3:.3f} ms, gather backward {gather_bwd_us / 1e3:.3f} ms, "
          f"K3 {k3_us / 1e3:.3f} ms")
    for key, us, count in rows[:25]:
        print(f"  {us / 1e3:9.3f} ms  x{count:<5d} {key[:100]}")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"{label}_trace.json"))
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
                busy_share=busy_us / wall_us, port_kernels_ms=kernel_us / 1e3,
                gather_fwd_ms=gather_fwd_us / 1e3, gather_bwd_ms=gather_bwd_us / 1e3,
                k3_ms=k3_us / 1e3,
                top=[dict(op=k[:100], ms=us / 1e3, count=c) for k, us, c in rows[:25]])


def small_model(dev, path):
    """The full-width model of ``path`` in float32; the marching renderers
    take 2 march steps."""
    model = path_model(path, torch.float32, dev)
    if model.has_marcher:
        model.renderer_cfg = dataclasses.replace(model.renderer_cfg, raymarch_steps=2)
    return model


def check_small_reference(path="adaptive", sl=16):
    """A 16x16 render in float32 with ``PRNGKey(7)``: kernels on the card
    against the same weights' plain path on the CPU (K7's draws are bit for
    bit the plain version's)."""
    outs = []
    for dev in (DEV, torch.device("cpu")):
        model = small_model(dev, path)
        batch = scene_batch()
        with torch.inference_mode():
            cond = encode_scene(model, batch, dev)
            c2w = torch.as_tensor(batch["cam2world"][:, 0])
            outs.append(render_full_image(model, cond, torch.as_tensor(batch["intrinsics"][:, 0]),
                                          c2w, sl, threefry.PRNGKey(7), 128, dev))
    label = f"{path} {sl}x{sl} f32 card vs CPU"
    names = [k for k, v in outs[1]._asdict().items() if v is not None]
    # f32 everywhere; the encoder's convolutions (cuDNN vs CPU) and the
    # decoder's FMA order differ in the last bits, and two march steps
    # amplify them a little: 2e-3.  The VR's fine samples are drawn by
    # inverse CDF from the coarse weights: a draw within those last bits of
    # a bin edge lands in the other bin on one device and moves its ray's
    # fine output, so there at most 1% of the rays may pass 2e-3
    fine = {"rgb_fine", "depth_fine", "depth_coarse"} if path == "VR" else set()
    cases = []
    for name in names:
        err = (getattr(outs[0], name).cpu() - getattr(outs[1], name)).abs().amax(-1)
        if name not in fine:
            cases.append(check(f"{name} {label}", float(err.max()), 2e-3, against="cpu"))
            continue
        frac = float((err > 2e-3).float().mean())
        if not frac <= 0.01:
            raise AssertionError(f"{name} {label}: {frac} of the rays beyond 2e-3")
        cases.append({"case": f"{name} {label}", "against": "cpu", "max_abs_err": float(err.max()),
                      "rays_beyond_2e-3": frac, "tol": 0.01})
    return cases


# ---------------------------------------------------------------------------
# phase 4: the training step
# ---------------------------------------------------------------------------

# kernel launches of one train step.  Adaptive: the coarse and band queries
# each run K1 and K2 (stash forward) both ways, the march runs K3 once each
# way.  VR, one chunk: K1 and K2 (no stash) forward on the coarse and fine
# passes, and K2's recompute backward in RECOMPUTE_CHUNK-point chunks, one
# wgrad per chunk.  VR, 8 chunks: each chunk runs K1 and the stash K2 both
# ways on both passes.  Raymarcher: K3 and one coarse query, both ways.
def _recompute_chunks(n):
    return -(-n // K2.RECOMPUTE_CHUNK)


TRAIN_LAUNCHES = {
    "adaptive": {"gather_bilinear": 2, "gather_bilinear_bwd": 2, "fused_resnetfc_stash": 2,
                 "fused_resnetfc_bwd_dgrad": 2, "fused_resnetfc_bwd_wgrad": 2,
                 "fused_lstm_march": 1, "fused_lstm_march_bwd": 1,
                 "fused_lstm_march_bwd_wgrad": 1},
    # the adaptive path's K2 and K3 launches; K5 in place of K1, and K4
    "adaptive_fused": {"gather_bilinear_projected": 2, "gather_bilinear_projected_bwd": 2,
                       "fused_volume_integral": 1, "fused_volume_integral_bwd": 1,
                       "fused_resnetfc_stash": 2, "fused_resnetfc_bwd_dgrad": 2,
                       "fused_resnetfc_bwd_wgrad": 2, "fused_lstm_march": 1,
                       "fused_lstm_march_bwd": 1, "fused_lstm_march_bwd_wgrad": 1},
    "vr": {"gather_bilinear": 2, "gather_bilinear_bwd": 2, "fused_resnetfc": 2,
           "fused_resnetfc_stash": _recompute_chunks(COARSE_VR) + _recompute_chunks(FINE_VR),
           "fused_resnetfc_bwd_recompute": _recompute_chunks(COARSE_VR)
           + _recompute_chunks(FINE_VR),
           "fused_resnetfc_bwd_wgrad": _recompute_chunks(COARSE_VR) + _recompute_chunks(FINE_VR)},
    "vr_chunked": {"gather_bilinear": 16, "gather_bilinear_bwd": 16, "fused_resnetfc_stash": 16,
                   "fused_resnetfc_bwd_dgrad": 16, "fused_resnetfc_bwd_wgrad": 16},
    "raymarcher": {"gather_bilinear": 1, "gather_bilinear_bwd": 1, "fused_resnetfc_stash": 1,
                   "fused_resnetfc_bwd_dgrad": 1, "fused_resnetfc_bwd_wgrad": 1,
                   "fused_lstm_march": 1, "fused_lstm_march_bwd": 1,
                   "fused_lstm_march_bwd_wgrad": 1},
}
# the adaptive step on the device set: the adaptive kernels, and K7 for the
# sampler's three randint draws (two raw-bit draws each) and the render's
# two legacy draws (the march's initial distance, the band)
TRAIN_LAUNCHES["adaptive_device_data"] = {**TRAIN_LAUNCHES["adaptive"], K7.NAME_BITS: 6,
                                          K7.NAME: 2}
# every bf16 K2 forward of these paths (the serving forwards, the stash
# forwards, the recompute's reruns) takes forward_route's wgmma kernel: its
# counter must equal theirs
for _table in (SERVE_LAUNCHES, TRAIN_LAUNCHES):
    for _want in _table.values():
        _want[K2.NAME_WGMMA] = _want.get(K2.NAME, 0) + _want.get(K2.NAME_STASH, 0)
        # and every bf16 march runs K3's tile kernels, forward and backward
        for _name, _tiles in ((K3.NAME, K3.NAME_TILES), (K3.NAME_BWD, K3.NAME_BWD_TILES)):
            if _name in _want:
                _want[_tiles] = _want[_name]
# the counters only bf16 moves (float32 takes csrc/resnetfc.cu's forward and
# K3's warp-per-ray kernels)
BF16_ROUTES = (K2.NAME_WGMMA, K3.NAME_TILES, K3.NAME_BWD_TILES)
# parameters the loss gives an exactly zero gradient, so Adam leaves them
# where they were: the coarse decoder's sigma row (the loss reads only its
# rgb) for the marching renderers, and the Raymarcher's unused fine decoder
SIGMA_ROW = [("net.mlp_coarse.lin_out.weight", 3), ("net.mlp_coarse.lin_out.bias", 3)]
FROZEN = {"adaptive": SIGMA_ROW, "adaptive_fused": SIGMA_ROW, "vr": [], "vr_chunked": [],
          "raymarcher": SIGMA_ROW + [("net.mlp_fine.", None)], "adaptive_device_data": SIGMA_ROW}
# the device set: instances x views of SIDE x SIDE synthetic scenes (629 MB
# of float32 images on the card)
DEVICE_SET = (64, 50)


def train_batch(dev, seed=0, sb=SB_TRAIN, rays=CHUNK, side=SIDE):
    """``bench.py``'s synthetic batch: normal images, one fixed pose,
    uniform pixels in [0.05, 0.95], uniform ground truth."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(sb, 1, side, side, 3)).astype(np.float32)
    c2w = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    c2w[2, 3] = 1.3
    xy = rng.uniform(0.05, 0.95, size=(sb, rays, 2)).astype(np.float32)
    K = np.asarray([[1.09375, 0, 0.5], [0, 1.09375, 0.5], [0, 0, 1]], np.float32)
    gt = rng.uniform(size=(sb, rays, 3)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.array(a)).to(dev)
    model_input = dict(x_pix=t(xy), cam2world=t(np.broadcast_to(c2w, (sb, rays, 4, 4))),
                       intrinsics=t(np.broadcast_to(K, (sb, 3, 3))))
    return (t(images), t(np.broadcast_to(c2w, (sb, 1, 4, 4))), 1.09375 * side,
            t(np.asarray([side / 2.0, side / 2.0], np.float32)), model_input, t(gt))


def device_set():
    """The synthetic set (``data/synthetic.py``, DEVICE_SET instances x views
    of SIDE x SIDE) uploaded to the card, and the seconds each part took."""
    t = time.perf_counter()
    dset = synthetic_scene_set(*DEVICE_SET, side=SIDE, seed=0)
    made = time.perf_counter() - t
    data = build_device_dataset(dset, DEV)
    torch.cuda.synchronize()
    return data, dict(generate_s=made, upload_s=time.perf_counter() - t - made,
                      gb=data.images.numel() * 4 / 1e9)


def run_train(path="adaptive", steps=10, warmup=2):
    """Full-width train steps (bf16, 4 scenes x 4,096 rays) of ``path``
    (a key of TRAIN_LAUNCHES): warm-up, then timed steps with the launch
    counters reset just before them.  The loss is finite, every skipped
    update is non-finite through the plain versions too (``confirm_skip``),
    every parameter and BatchNorm statistic moved but those the loss gives
    no gradient (FROZEN), which must not have moved.
    ``adaptive_device_data`` draws each step's batch on the card from the
    synthetic device set (legacy key stream) instead of ``bench.py``'s batch."""
    renderer = {"vr": "VR", "vr_chunked": "VR", "raymarcher": "Raymarcher",
                "adaptive_device_data": "adaptive"}.get(path, path)
    model = path_model(renderer, torch.bfloat16, DEV)
    opt = make_optimizer(1e-4)
    state = create_train_state(model, opt)
    loss_params = LossParams(loss_mode="coarse" if path == "raymarcher" else "both")
    chunks = 8 if path == "vr_chunked" else 1
    extra = {}
    replay = {}  # the batch and render key of the last step, to redo a skipped one
    if path == "adaptive_device_data":
        data, extra["device_set"] = device_set()
        sampler = make_device_sampler(data, SB_TRAIN, CHUNK)

        def recorded(k_batch):
            replay["batch"] = sampler(k_batch)
            return replay["batch"]

        dd_step = make_train_step(model, opt, loss_params, rng_mode="legacy",
                                  sampler=recorded, sampler_key=threefry.PRNGKey(0))
        rng_mode = "legacy"

        def step(state, i):  # state.step is i: the step's render key, as make_train_step's
            replay["key"] = threefry.split(threefry.fold_in(threefry.PRNGKey(0), i))[1]
            return dd_step(state)
    else:
        plain_step = (make_chunked_call_train_step(model, opt, loss_params, ray_chunks=chunks)
                      if path == "vr_chunked" else make_train_step(model, opt, loss_params))
        replay["batch"] = batch = train_batch(DEV)
        rng_mode = "per_ray"

        def step(state, i):
            replay["key"] = (0, i)
            return plain_step(state, *batch, (0, i))

    skipped = []

    def redo(plain, found=None):
        """Step ``i``'s loss and gradients again on the same weights, batch
        and key (the BatchNorm statistics restored after), through the
        plain versions or, recording where the first non-finite value
        appears, through the kernels (their launches not counted)."""
        stats = {k: v.clone() for k, v in model.named_buffers()}
        counted = dict(_build.launches)
        with plain_kernels() if plain else first_nonfinite(found):
            loss, g = loss_and_grads(model, state.params, loss_params, *replay["batch"],
                                     replay["key"], ray_chunks=chunks, rng_mode=rng_mode)
        _build.launches.clear()
        _build.launches.update(counted)
        with torch.no_grad():
            for k, v in model.named_buffers():
                v.copy_(stats[k])
        return float(loss), [k for k, v in g.items() if not bool(torch.isfinite(v).all())]

    def confirm_skip(i, metrics):
        """The optimizer skipped step ``i`` (a non-finite gradient; the
        weights did not move).  Redone through the plain versions on the
        card, the loss must agree; the gradient must be non-finite too, or
        else, redone through the kernels, the first non-finite value must
        appear in the backward of an op that is not a kernel's, from finite
        incoming gradients: the kernels' forward points differ from the
        plain versions' in the last bits, so a point at a camera depth of
        exactly 0 can come out on one side only (module docstring, phase 4).
        Otherwise a kernel made it."""
        if int(metrics["notfinite"]) == len(skipped):
            return
        loss, bad = redo(plain=True)
        # bf16 forward through the kernels and through the plain versions:
        # the probe's skips read up to 1.1e-5 apart
        if not abs(loss - float(metrics["loss"])) <= 1e-4:
            raise AssertionError(f"{path} train step {i}: loss {float(metrics['loss'])} through "
                                 f"the kernels, {loss} through the plain versions")
        entry = {"step": i, "plain_loss": loss, "plain_nonfinite": len(bad)}
        if not bad:
            found = []
            redo(plain=False, found=found)
            if not found or found[0]["kernel"]:
                raise AssertionError(f"{path} train step {i}: the kernels' gradient is not "
                                     f"finite, the plain versions' is; first non-finite at "
                                     f"{found[0] if found else 'no node'}")
            entry["first_nonfinite_node"] = found[0]
        skipped.append(entry)
        where = (f"{len(bad)} non-finite gradients" if bad else
                 f"a finite gradient, and the kernels' first non-finite value appears in "
                 f"{entry['first_nonfinite_node']['node']}, which is not a kernel")
        print(f"{path} train step {i}: update skipped; on the same weights and batch the plain "
              f"versions give {where}")

    tracked = {**state.params, **state.batch_stats}
    initial = {k: v.detach().clone() for k, v in tracked.items()}
    for i in range(warmup):
        state, metrics = step(state, i)
        confirm_skip(i, metrics)
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for i in range(warmup, warmup + steps):
        t = time.perf_counter()
        state, metrics = step(state, i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        confirm_skip(i, metrics)  # its redos' launches are not counted
    counts = dict(_build.launches)
    want = {k: steps * v for k, v in TRAIN_LAUNCHES[path].items()}
    if counts != want:
        raise AssertionError(f"{path} train launch counts {counts} != expected {want}")
    loss, notfinite = float(metrics["loss"]), int(metrics["notfinite"])
    if not np.isfinite(loss):
        raise AssertionError(f"{path} train step: loss {loss}")
    whole = [k for k in tracked for p, row in FROZEN[path] if row is None and k.startswith(p)]
    same = [k for k, v in tracked.items() if k not in whole and torch.equal(v, initial[k])]
    if same:
        raise AssertionError(f"{path} train step left these unchanged: {same}")
    for name, row in FROZEN[path]:
        for k in ([name] if row is not None else [k for k in whole if k.startswith(name)]):
            idx = slice(None) if row is None else row
            if not torch.equal(tracked[k][idx], initial[k][idx]):
                raise AssertionError(f"{path}: {k}[{row}] moved without a gradient")
    med = float(np.median(step_ms))
    rays = SB_TRAIN * CHUNK
    res = dict(path=path, steps=steps, step_ms=step_ms, ms_per_step=med,
               rays_per_s=rays / med * 1e3,
               max_memory_gb=torch.cuda.max_memory_allocated() / 1e9, loss=loss,
               grad_norm=float(metrics["grad_norm"]), notfinite=notfinite, skipped=skipped,
               launches=counts,
               **extra)
    return res, lambda i=0: step(state, i)


def check_vr_chunks():
    """The one-chunk VR step (K2's recompute backward) against the 8-chunk
    step (stash backward) from the same weights and batch: loss and every
    gradient.  Per point the two run the same arithmetic (the decoder's
    rows do not depend on their tile), and C = 8 is a power of two, so the
    1/C loss scaling is exact and the rounded bf16 cotangents are 8x each
    other exactly; what is left is summation order: the wgrad's split, the
    loss means.  The latent's cotangent is bf16: the one-chunk step rounds
    the sum of its coarse and fine gathers' bf16 cotangents, the 8-chunk
    step sums sixteen such in float32 and rounds once, so the encoder's
    gradients differ by bf16 roundings of their input cotangent.  K1's
    backward sums in a fixed order (no atomics), so the 8-chunk step
    against itself (the floor printed) moves only with cuDNN's encoder
    backward."""
    model = path_model("VR", torch.bfloat16, DEV)
    params = dict(model.named_parameters())
    batch = train_batch(DEV)
    (l1, g1), (l8, g8), (_, g8b) = (
        loss_and_grads(model, params, LossParams(loss_mode="both"), *batch, (0, 5),
                       ray_chunks=c) for c in (1, 8, 8))

    def worst(ga, gb, prefix):
        return max((float((ga[k].float() - gb[k].float()).norm()
                          / gb[k].float().norm().clamp_min(1e-30)), k)
                   for k in gb if k.startswith(prefix))

    dec, enc = worst(g1, g8, "net.mlp_"), worst(g1, g8, "net.encoder")
    floor = worst(g8b, g8, "net.encoder")  # the same step again: cuDNN only
    print(f"VR one chunk vs 8 chunks: loss {float(l1)} vs {float(l8)}; worst relative L2: "
          f"decoder {dec}, encoder {enc}; the 8-chunk step against itself, encoder {floor}")
    # loss: float32 means of 49,152 terms in two orders; decoder gradients:
    # float32 summation order (SUM_ORDER_TOL's reason, by relative L2);
    # encoder gradients: bf16 roundings of the latent cotangent (one bf16
    # ulp is 2^-8 relative), carried through the encoder's bf16 backward
    # (the floor printed, the 8-chunk step against itself, is what cuDNN's
    # backward alone moves them run to run): 5e-2
    cases = [check("VR loss one chunk vs 8 chunks", abs(float(l1) - float(l8)),
                   1e-6 * abs(float(l8)), against="8 chunks"),
             {"case": "VR encoder gradients, 8 chunks against itself", "against": "8 chunks",
              "worst_rel_l2": floor[0], "worst": floor[1]}]
    for part, (err, key), tol in (("decoder", dec, 1e-4), ("encoder", enc, 5e-2)):
        if not err <= tol:
            raise AssertionError(f"VR one chunk vs 8 chunks, {part}: {key} relative L2 {err} "
                                 f"> {tol}")
        cases.append({"case": f"VR {part} gradients one chunk vs 8 chunks",
                      "against": "8 chunks", "worst_rel_l2": err, "worst": key, "tol": tol})
    return cases


def check_adaptive_rerun(dtype=torch.bfloat16):
    """The adaptive train step's loss and gradients in ``dtype``, twice on
    the same weights and batch: with K1's, K5's, K2's and K3's backward
    free of float atomics, only cuDNN's encoder backward may move them
    (reported, not bounded).  float32 (the JAX CLI's default dtype) is held
    to it: the decoders' and the march's gradients bit for bit.  Also
    returns the second step's kernel launches."""
    model = path_model("adaptive", dtype, DEV)
    params = dict(model.named_parameters())
    batch = train_batch(DEV)
    step = lambda: loss_and_grads(model, params, LossParams(loss_mode="both"), *batch, (0, 5))
    l1, g1 = step()
    torch.cuda.synchronize()
    _build.reset_launches()
    l2, g2 = step()
    torch.cuda.synchronize()
    launches = dict(_build.launches)

    def worst(prefix):
        return max((float((g1[k].float() - g2[k].float()).norm()
                          / g2[k].float().norm().clamp_min(1e-30)), k)
                   for k in g2 if k.startswith(prefix))

    enc, rest = worst("net.encoder"), worst("net.mlp_")
    march = max(worst("lstm."), worst("out_layer."))  # the LSTM and its step head
    kind = str(dtype)[6:]
    print(f"adaptive step twice on one batch ({kind}): loss {float(l1)} vs {float(l2)}; worst "
          f"relative L2: encoder {enc}, decoders {rest}, march {march}")
    case = {"case": f"{kind} adaptive step twice on one batch", "against": "rerun",
            "loss_diff": abs(float(l1) - float(l2)), "encoder_worst_rel_l2": enc[0],
            "encoder_worst": enc[1], "decoder_worst_rel_l2": rest[0],
            "march_worst_rel_l2": march[0], "launches": launches}
    if dtype == torch.float32:
        # every float32 K2 forward and every float32 wgrad (K2's, K3's) on
        # the float32 kernels
        f32 = {K2.NAME_F32: launches.get(K2.NAME, 0) + launches.get(K2.NAME_STASH, 0),
               K2.NAME_WGRAD_F32: launches.get(K2.NAME_WGRAD, 0) + launches.get(K3.NAME_WGRAD, 0)}
        if any(launches.get(k, 0) != v or not v for k, v in f32.items()) or \
                K2.NAME_WGMMA in launches:
            raise AssertionError(f"float32 adaptive step: launches {launches}, expected {f32}")
        moved = [k for k in g2 if k.startswith(("net.mlp_", "lstm.", "out_layer."))
                 and not same_bits(g1[k], g2[k])]
        if moved:
            raise AssertionError(f"float32 adaptive step twice on one batch: {moved} differ")
        case.update(tol=0.0, bitwise=True)
    return [case]


@contextlib.contextmanager
def plain_kernels():
    """Inside: the model calls the kernels' plain versions on any device
    (module attributes swapped; for comparisons only)."""
    import avr_tpu_torch.models.mlp as mlp
    import avr_tpu_torch.models.pixelnerf as pixelnerf
    import avr_tpu_torch.ops.grid_sample as grid_sample
    import avr_tpu_torch.renderers.adaptive as adaptive
    import avr_tpu_torch.renderers.raymarch as raymarch

    swaps = [(grid_sample, "gather_bilinear", gather_bilinear_plain),
             (K7, "uniform_2d", K7.uniform_2d_plain), (K7, "bits", K7.bits_plain),
             (raymarch, "fused_lstm_march", lstm_march_plain),
             (mlp, "fused_resnetfc", lambda *a, stash=None, **kw: resnetfc_plain(*a, **kw)),
             (pixelnerf, "gather_bilinear_projected", gather_bilinear_projected_plain),
             (adaptive, "fused_volume_integral", K4.fused_volume_integral_plain)]
    saved = [getattr(m, n) for m, n, _ in swaps]
    for m, n, plain in swaps:
        setattr(m, n, plain)
    try:
        yield
    finally:
        for (m, n, _), kernel in zip(swaps, saved):
            setattr(m, n, kernel)


def _finite(ts):
    return all(bool(torch.isfinite(t).all()) for t in ts if t is not None)


def _largest(ts):
    return max((float(t.float().abs().nan_to_num(0.0, 0.0, 0.0).max()) for t in ts
                if t is not None and t.numel()), default=0.0)


@contextlib.contextmanager
def first_nonfinite(found):
    """Inside: every ``torch.autograd.grad`` call hooks each node of its
    graph and appends to ``found`` (up to 4) the nodes that turn finite
    incoming gradients into non-finite outgoing ones, in the order autograd
    runs them: the node's name, whether it is a kernel's backward (an
    autograd Function of ``avr_tpu_torch.ops.kernels``), the largest
    incoming gradient and the infs and NaNs going out."""
    grad = torch.autograd.grad

    def traced(outputs, inputs, *args, **kw):
        roots = [t.grad_fn for t in (outputs if isinstance(outputs, (list, tuple)) else [outputs])]
        seen, handles = set(), []
        while roots:
            node = roots.pop()
            if node is None or node in seen:
                continue
            seen.add(node)

            def hook(grad_in, grad_out, node=node):
                if len(found) < 4 and _finite(grad_out) and not _finite(grad_in):
                    fn = getattr(node, "_forward_cls", None)
                    found.append({
                        "node": node.name(),
                        "kernel": fn is not None
                        and fn.__module__.startswith("avr_tpu_torch.ops.kernels"),
                        "largest_incoming": _largest(grad_out),
                        "inf": sum(int(torch.isinf(t).sum()) for t in grad_in if t is not None),
                        "nan": sum(int(torch.isnan(t).sum()) for t in grad_in if t is not None)})

            handles.append(node.register_hook(hook))
            roots.extend(f for f, _ in node.next_functions)
        try:
            return grad(outputs, inputs, *args, **kw)
        finally:
            for h in handles:
                h.remove()

    torch.autograd.grad = traced
    try:
        yield
    finally:
        torch.autograd.grad = grad


def check_small_train(path="adaptive", rays=256, rng_mode="per_ray"):
    """One f32 step's loss and gradients (the full-width model, 2 march
    steps, one scene) from the same weights, batch and key (``rng_mode``'s
    stream): kernels on the card against the plain path on the CPU, and
    against the plain versions on the card."""
    def grads(dev, plain=False):
        model = small_model(dev, path)
        batch = train_batch(dev, seed=1, sb=1, rays=rays)
        with plain_kernels() if plain else contextlib.nullcontext():
            loss, g = loss_and_grads(model, dict(model.named_parameters()),
                                     LossParams(loss_mode="both"), *batch, threefry.PRNGKey(3),
                                     rng_mode=rng_mode)
        stats = {k: v.detach().cpu() for k, v in model.named_buffers()}
        return float(loss), {k: v.cpu() for k, v in g.items()}, stats

    (l_k, g_k, s_k), (l_p, g_p, _), (l_c, g_c, s_c) = (
        grads(DEV), grads(DEV, plain=True), grads(torch.device("cpu")))
    l2 = lambda a, b: float((a - b).norm() / b.norm().clamp_min(1e-30))
    worst = lambda ref: max((l2(g_k[k], ref[k]), k) for k in ref)
    # card kernels vs the same plain versions on the card: float32 sums in
    # other orders and atomics; 5e-3 relative L2 per gradient
    vs_plain, vs_cpu = worst(g_p), worst(g_c)
    # card vs CPU: the plain ops themselves differ between the devices in
    # the last bits (cuDNN against the CPU's convolutions through the
    # train-mode BatchNorm, reductions in other orders), the march points
    # move by ~1e-5 and the gradients follow by a few percent; the plain
    # path on the card differs from the CPU by as much as the kernels do.
    # 1e-4 on the loss, 5e-2 relative L2 per gradient, 1e-4 on the stats
    r = f"{path} {rng_mode}"
    cases = [check(f"{r} loss f32 card vs CPU", abs(l_k - l_c), 1e-4),
             check(f"{r} loss f32 kernels vs plain on the card", abs(l_k - l_p), 1e-5)]
    for name, (err, key), tol, against in (("kernels vs plain on the card", vs_plain, 5e-3,
                                             "plain"),
                                            ("card vs CPU", vs_cpu, 5e-2, "cpu")):
        if not err <= tol:
            raise AssertionError(f"{r} f32 gradients {name}: {key} relative L2 {err} > {tol}")
        cases.append({"case": f"{r} {len(g_c)} gradients f32 {name}", "against": against,
                      "worst_rel_l2": err, "worst": key, "tol": tol})
    stat_err = max(max_err(s_k[k], s_c[k]) for k in s_c)
    cases.append(check(f"{r} BatchNorm running stats f32 card vs CPU", stat_err, 1e-4))
    return cases


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    info = _build.load_library()
    print(f"kernel library: {info['path']} built={info['built']} in {info['seconds']:.1f} s")
    for line in str(info.get("log", "")).splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling entry")) or \
                line.startswith("=="):
            print("  " + line.strip())

    draws = next((int(a.split("=", 1)[1]) for a in sys.argv[1:]
                  if a.startswith("--march-draws=")), 0)
    if draws:
        march_draws(draws)
        return 0
    profile = "--profile" in sys.argv[1:]
    out_dir = next((a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--out=")),
                   "traces")
    gen = torch.Generator(device=DEV).manual_seed(0)
    # the wgmma forward's added cases draw from a generator of their own
    gen_new = torch.Generator(device=DEV).manual_seed(1)
    k1 = check_gather(gen)
    k2 = check_resnetfc(gen, gen_new)
    k2["cases"] += check_resnetfc_stash(gen_new)
    kernels = [k1, k2, check_march(gen),
               check_gather_bwd(gen), *check_resnetfc_bwd(gen), check_resnetfc_recompute(gen),
               *check_march_bwd(gen),
               check_integral(gen, torch.Generator(device=DEV).manual_seed(4)),
               check_integral_bwd(gen),
               check_gather_proj(gen), check_gather_proj_bwd(gen), check_rng()]
    # the binned gather backward's added cases draw from a generator of their own
    gen_bins = torch.Generator(device=DEV).manual_seed(2)
    by_name = {k["name"]: k for k in kernels}
    # float32, the JAX CLI's default dtype: its kernels' rows (a generator of
    # their own), K3's from its checks above, and a served float32 frame
    float32 = check_float32(torch.Generator(device=DEV).manual_seed(6))
    float32["rows"]["K3 forward"] = by_name["fused_lstm_march"]["kept_f32"]
    float32["rows"]["K3 walk + bins + reduce"] = by_name["fused_lstm_march_bwd"]["kept_f32"]
    float32["serve_adaptive"] = run_slice("adaptive", dtype=torch.float32)[0]
    print(f"serve adaptive float32: {float32['serve_adaptive']}")
    kernels += float32.pop("kernels")
    check_gather_bwd_bins(gen_bins, by_name["gather_bilinear_bwd"])
    check_gather_proj_bwd_bins(gen_bins, by_name["gather_bilinear_projected_bwd"])
    # the tiled forward's added cases draw from a generator of their own
    check_gather_fwd_cases(torch.Generator(device=DEV).manual_seed(3), k1,
                           by_name["gather_bilinear_projected"])
    print(f"integral: {check_integral_saturated(gen)}")
    for k in kernels:
        host = (f", host {k['host_ms']:.4f} ms, call {k['call_ms']:.4f} ms" if "host_ms" in k
                else "")
        if k["name"] == "gather_bilinear":  # ms back to back, the kernel's device time beside
            host += f", device {k['device_ms']:.4f} ms"
        print(f"kernel {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, bound "
              f"{k['bound_ms']:.4f} by {k['bound_by']}{host}) {len(k['cases'])} cases, all "
              f"within tolerance")

    serve, train, renders = {}, {}, {}
    for path in PATHS:
        serve[path], renders[path] = run_slice(path)
        print(f"serve {path}: {serve[path]}")
    if profile:
        for path, label in (("adaptive", "frame"), ("adaptive_fused", "frame_fused"),
                            ("VR", "frame_vr"), ("Raymarcher", "frame_raymarcher")):
            serve[path]["profile"] = profile_frame(renders[path], label=label, out_dir=out_dir)
    del renders
    # the adaptive step keeps its 10 timed steps; the others take 5
    for path, steps in (("adaptive", 10), ("adaptive_fused", 5), ("vr", 5), ("vr_chunked", 5),
                        ("raymarcher", 5), ("adaptive_device_data", 5)):
        train[path], run_step = run_train(path, steps=steps)
        print(f"train {path}: {train[path]}")
        if profile:
            train[path]["profile"] = profile_frame(run_step, label=f"train_step_{path}",
                                                   out_dir=out_dir)
        del run_step
    results = {"serve": serve, "train": train, "float32": float32,
               "vr_one_vs_8_chunks": check_vr_chunks(),
               "adaptive_rerun": check_adaptive_rerun() + check_adaptive_rerun(torch.float32),
               "reference": check_small_reference() + check_small_train()
               + check_small_train(rng_mode="legacy")
               + check_small_reference("adaptive_fused") + check_small_train("adaptive_fused")
               + check_small_reference("VR") + check_small_train("VR")
               + check_small_reference("Raymarcher")}
    for c in results["vr_one_vs_8_chunks"] + results["adaptive_rerun"] + results["reference"]:
        print(f"reference: {c}")
    # the main paths' launches: every serve and train path (bf16); the
    # float32 kernels' own: the served float32 frames and the float32
    # adaptive step
    launches = {**{f"serve_{k}": v["launches"] for k, v in serve.items()},
                **{f"train_{k}": v["launches"] for k, v in train.items()}}
    launches_f32 = {"serve_adaptive_float32": float32["serve_adaptive"]["launches"],
                    "train_adaptive_float32_step": results["adaptive_rerun"][1]["launches"]}

    for k in kernels:
        plain = [c for c in k["cases"] if c.get("against") == "plain"]
        err = max(c["max_abs_err"] for c in plain)
        # K2's forward counts under two names (without and with stash), K7
        # under two (the uniform draw and its raw bits)
        names = [k["name"]] + {K2.NAME: [K2.NAME_STASH], K7.NAME: [K7.NAME_BITS]}.get(k["name"], [])
        paths = launches_f32 if k["name"] in (K2.NAME_F32, K2.NAME_WGRAD_F32) else launches
        by_path = {path: sum(counts.get(n, 0) for n in names) for path, counts in paths.items()}
        if not sum(by_path.values()):
            raise AssertionError(f"{k['name']} was never launched on a main path")
        k.update(route="cuda", launches=sum(by_path.values()), launches_by_path=by_path,
                 max_abs_err=err, max_err=err, tol=max(c["tol"] for c in plain),
                 kernel_ms=k["ms"])
    # every case in full to a file; the printed line keeps one worst case each
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_report.json"), "w") as f:
        json.dump({"kernels": kernels, **results, "card": smi}, f, indent=1)
    for k in kernels:
        cases = k.pop("cases")
        k["cases"] = len(cases)
        # a bitwise case (tolerance 0) that passed has error 0: ratio 0
        k["worst_case"] = max((c for c in cases if "tol" in c),
                              key=lambda c: c.get("rel_l2", c.get("max_abs_err")) / c["tol"]
                              if c["tol"] else 0.0)
    for part in (*serve.values(), *train.values()):
        part.pop("profile", None)
    float32["cases"] = len(float32["cases"])
    print(json.dumps({"kernels": kernels, **results, "card": smi}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
