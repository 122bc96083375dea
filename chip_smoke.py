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
   activations (NS 1 and 2), its pieces past 512 latent or encoded lanes
   (a latent of 640 and 1,024, 576 encoded lanes, d_hidden 256 with a
   latent of 1,024: output, stash, reruns, and the stash and recompute
   backward bit for bit), and
   the wgmma forward timed in turns with the cuBLAS chain of its products
   at the band chunk (serving) and at the train step's band call with the
   stash, each loop beside the SM clock and power that ``nvidia-smi``
   read; K2's bf16 wgrad (the
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
   tiles, float32 on 8-ray FMA tiles, each case's route counters checked) also
   at hidden 62, forward and backward, its forward and the timed
   backward's eight gradients bit for bit equal on a rerun (every float32
   case's too, early stop with frozen rays included), its forward also
   timed at the train step's call with the saved rows, its float32 kernels
   held to the plain version (the forward at 2 and 10 steps, NS 1 and 2,
   early stop, hidden 62, the serving and train shapes; the timed
   backward's eight gradients) and timed beside; K5
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
6. Fit: the training loop the way JAX's CLI trains, through the port's
   entry points: the full-width model from scratch (JAX's initialisation)
   with ``norm_type="group"``, bf16, EMA 0.999, ``rng_mode="legacy"``, on an
   in-memory synthetic set of 16 instances x 50 views of 128x128 (the SRN
   layout as a mapping, no ``h5py``) with 4 val instances x 6 views.
   ``fit(device_data=True)`` for 2 epochs of 4 steps (SB 4 x 4,096 rays),
   validation every 4 steps over the 4 val scenes: the launch counters are
   reset before and read after (``train_fit``: K1, K2 and K3 forward and
   backward and K7 must each launch), the JSONL log has JAX's events and
   keys, ``{run}_best`` and ``{run}_epoch2`` exist at JAX's paths.  One
   val view rendered with the EMA weights through ``eval_variables``,
   after K3 kept the raw weights' fragments, is bit for bit the kernels'
   render of a model that holds the EMA weights, in bf16 and (after the
   float32 epoch) in float32; in float32 it is within 2e-3 of the plain
   versions' render of the same weights on every ray (bf16 reported: the
   two round at other places through the 10-step march).  ``_epoch2``
   restored into a fresh template and trained one more epoch equals an
   uninterrupted 3-epoch run bit for bit (the step, the sampler's keys and
   batches, the losses, the parameters; cuDNN set deterministic for the
   phase).  The prefetched host batches equal the synchronous stream's bit
   for bit, and one epoch runs on the host path; one float32 epoch runs on
   the device-data path; ``test_approximate`` with the EMA and the
   random-VGG LPIPS archive scores the val set.  Printed: ms a ``fit`` step
   (between loss lines with no val or checkpoint between them) against the
   bare device-data step's (the loop's own host cost), the device's busy
   ms a step (the bare step's profile) over the fit step, the group-norm
   against the batch-norm step, the val PSNR/SSIM, ``test_approximate``'s
   result, a checkpoint's bytes and save and restore seconds.

7. The CLIs (``avr_tpu_torch/cli``), the way a user starts the system, at
   full ``conf/default_mv.conf`` width on phase 6's in-memory sets (the SRN
   layout as mappings, through ``cli.train.run``'s sources), each case with
   the launch counters reset before and read after: ``cli.train`` at JAX's
   defaults (float32, ``per_ray``, the host path with prefetch and the
   native ray gather, batch norm; SB 4 x 1,024 rays, 2 epochs of 4 steps,
   validation every 4 steps) under ``--profile_dir``; the quality runs'
   recipe in bf16 (``--device_data --rng_mode legacy --norm_type group
   --ema_decay 0.999 --lr_schedule cosine --ray_batch_size 4096``), which
   saves ``_best`` and ``_epoch2``, then resumes one epoch from ``_epoch2``
   with ``--schedule_total_epochs``; one epoch with ``--gather_impl
   pallas_proj`` (K5); one epoch of the VR; an ``--encoder_weights`` warm
   start from a torchvision-layout archive of seeded draws (the trunk
   holds the archive's tensors when ``fit`` starts); ``cli.test`` on
   ``_best`` with ``--use_ema`` and the random-VGG LPIPS archive;
   ``cli.video`` of 4 frames; ``profiling.analyze`` on the first run's
   trace (device-busy share, top kernels).  K1, K2 and K3 must launch
   forward and backward in float32 (the first run) and bf16 (the recipe),
   K7 in the recipe, K5 in the K5 run.  The kernels line carries each
   kernel's launches in these cases (``cli``, ``cli_by_case``).

8. The sharded train step (``avr_tpu_torch/parallel``) at full width on
   ``bench_weights``, cuDNN deterministic, the launch counters reset before
   each case and read after.  In an NCCL world of one made in-process (a
   ``HashStore``, no launcher), mesh (1, 1): both flavours (``shardmap``,
   ``gspmd``), bf16 and float32, each ``rng_mode``, 2 steps of SB 4 x 4,096
   rays, every step's loss and whole train state (parameters, Adam's
   moments, BatchNorm statistics, step) bit for bit ``make_train_step``'s,
   K1, K2 and K3 forward and backward launched, K7 under ``legacy``; the
   sharded step's ms against ``make_train_step``'s in turns, the gradient
   bucket's bytes and its all-reduce alone.  Two processes on the one card
   (gloo: NCCL refuses two ranks on one device), meshes (1, 2) and (2, 1),
   ``shardmap``, ``per_ray``, group norm, 2 steps: the ranks' losses and
   whole states equal after each step, float32 losses within 1e-5 relative
   of the one-rank step's on the same global batch (bf16 reported), each
   rank's kernels launched, their ms a step (two ranks sharing one card:
   information only), gloo's ``all_gather`` of CUDA tensors and its
   all-reduce of the bucket.  ``cli.train --mesh 1,1`` with each
   ``--step_impl``: one epoch of 4 steps on phase 6's sets, JAX's
   checkpoint names and log keys.  The kernels line carries each kernel's
   launches in these cases (``parallel``, ``parallel_by_case``).

9. The model options (``OPTION_CASES``: the decoder BatchNorm ``--bn``;
   SPADE, softplus ``beta`` and ``combine_type = max``; ``type = mlp``
   (``ImplicitNet``); the global encoder with ``mlp_fine { type = empty }``;
   the custom encoder; ``feature_scale``; ``use_xyz = False`` with coded view
   directions; ``use_code = False``; ``normalize_z = False`` without view
   directions; ``use_encoder = False`` with the global latent, on the VR) at
   full ``conf/default_mv.conf`` width on ``bench_weights``, each case's
   launch counters reset before and read after: one bf16 train step (SB 4 x
   4,096 rays; the global latent's 640 lanes take the wgmma forward in
   pieces and the wide dgrad, every forward on the wgmma counter) and one
   served 128x128 bf16 frame; the float32 field (one encoded view, 4,096
   points, coarse and fine) held to the CPU's on the same weights (1e-3 of
   max(1, |output|)); the bf16 field through the kernels held to the same
   field through their plain versions on the card (``option_kernel_check``:
   the query at K2's bf16 forward tolerance, the gradients of a loss of it
   by relative L2 at K2's backward tolerance, and K1 forward and backward
   on the case's own map).  A
   skipped update goes through phase 4's protocol (``diagnose_skip``): it
   fails unless the plain versions skip too or the first non-finite value
   appears outside a kernel.  K2 launches where JAX fuses (``supports``) and
   never where JAX runs XLA; K1 forward and backward on the custom
   encoder's 128x128x128 map.  The kernels line carries each kernel's launches by
   case (``options``, ``options_by_case``).

10. The quality script (``python -m avr_tpu_torch.scripts.quality_ab``):
    an adaptive and a VR arm at 64x64 (8 instances, 4 x 1,024 rays, device
    data), stopped at epoch 2 and resumed to epoch 4 by a second call, each
    call's launches counted (``quality``, ``quality_by_case``): K1, K2, K3
    and K7 launch; every evaluation (final and best, raw and EMA, the
    band-widening sweep) finite.  The long quality runs are runs of their
    own (``python -m avr_tpu_torch.scripts.quality_ab``, README).

11. K2 at JAX's widths (``csrc/resnetfc_wide.cu``: the wide forward and
    dgrad, bf16 and float32, which ``forward_route`` and ``backward_route``
    choose past the other kernels' envelopes): each held to its plain
    version at d_hidden 1,024 with a latent of 1,152 (NS 1; 576 encoded
    lanes at NS 2), d_hidden 640 with a latent of 612 (zero-padded to 640),
    and in bf16 d_hidden 512 with the global encoder's 640 lanes (the wide
    dgrad only), off both tiles: the forward (bf16 2 ulps of the largest
    output or twice the plain version's distance from the float32 function
    on the bf16-valued weights, whichever is larger, as phase 9 holds its
    fields; float32 1e-3) and its stash slot by slot; the 12 gradients
    against the plain autograd (relative L2, bf16 8e-2, float32 1e-2) and
    against the matched reference fed the kernel's own stash (bf16 3e-3,
    float32 1e-3); every gradient bit for bit on a rerun; the recompute
    backward bit for bit the stash backward (one chunk), and cut to
    1,000-point chunks its point cotangents bit for bit; the wgrads' jobs at
    1,024 x 1,024 and 1,024 x 1,152 against ``torch.matmul``.  Each kernel
    timed at the band chunk (81,920 points) beside its plain version, the
    cuBLAS chain of its products and its bound; the wgmma forward's pieces
    at d_hidden 512 with latents of 640 and 1,024 timed beside the same.
    K1, K5 and K3 at 1,024
    latent channels against their plain versions.  Then the full-width
    slice: the adaptive model ``make_model`` builds from a conf string
    (``WIDE_CONF``: conf/default_mv.conf's model with d_hidden 1,024 in
    both decoders, the spatial encoder at 5 stages and the global encoder: a
    latent of 1,024 + 128 lanes) serves a 128x128 frame (bf16 and float32)
    and takes train steps (SB 4 x 4,096 rays) in bf16 and float32, on the
    stash and on the recompute backward, the counters reset before each
    and read after: every K2 forward and dgrad on the wide kernels, no
    skipped update.  The kernels line carries the four wide rows, their
    launches on that slice (``wide``, ``wide_by_case``).

Prints the kernel table as one JSON line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``; every case in full
goes to ``DIR/chip_smoke_report.json`` (default ``traces/``), with the
profiles' chrome traces.

    python3 chip_smoke.py --march-draws=N

runs only K3's bf16 10-step backward over N input draws at two step heads
(``march_draws``: how the comparison depends on its draw) and prints one
JSON line per draw and head.

    python3 chip_smoke.py --fit

runs only phase 6 and prints its report as one JSON line.

    python3 chip_smoke.py --cli

runs only phase 7 and prints its report as one JSON line.

    python3 chip_smoke.py --parallel

runs only phase 8 and prints its report as one JSON line.

    python3 chip_smoke.py --options [--quality]

runs only phase 9 (and with ``--quality`` phase 10; ``--quality`` alone
runs only phase 10) and prints the report as one JSON line.

    python3 chip_smoke.py --wide

runs only phase 11 and prints its report as one JSON line.

    python3 chip_smoke.py --chain
    python3 chip_smoke.py --chain-sweep [--retired=DIR]

``--chain`` runs only phase 12 (K2's chain, ``csrc/resnetfc_chain.cu``, held
at CHAIN_CASES and timed; the binned backward on large maps; the chain's
slice).  ``--chain-sweep`` times the chain at the band chunk in turns
against the route that took each of CHAIN_SWEEP's shapes before it
(``sweep_row``: chain, other, other, chain, each held to its plain version
first), beside the cuBLAS chain of its products and its bound: the
evidence for the chain's range (``ops/kernels/resnetfc.py chain_takes``).
The routes this tree retired (RETIRED: ``resnetfc_kernel``, the first wide
version) run in DIR, a checkout of a commit that still has them, in a
process of its own on the same inputs; without ``--retired`` their turns
are not measured.
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
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from avr_tpu_torch.data.dataset import SceneClassDataset
from avr_tpu_torch.data.device import build_device_dataset, make_device_sampler
from avr_tpu_torch.data.synthetic import synthetic_scene_mapping, synthetic_scene_set
from avr_tpu_torch.evaluation import generate_video, render_full_image, test_approximate
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
from avr_tpu_torch.training import (FitConfig, LossParams, create_train_state, fit,
                                    make_optimizer, make_train_step, restore_checkpoint,
                                    save_checkpoint)
from avr_tpu_torch.training.checkpoint import checkpoint_path
from avr_tpu_torch.training.loop import select_source_views
from avr_tpu_torch.training.step import make_chunked_call_train_step
from avr_tpu_torch.training.step import loss_and_grads
from avr_tpu_torch.utils.geometry import get_world_rays, orbit_cam2world, pixel_grid
from avr_tpu_torch.utils.logging import MetricsLogger
from avr_tpu_torch.utils.lpips import random_state as lpips_random_state

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
    cases += check_resnetfc_pieces(gen_new)
    bf = torch.bfloat16
    x = (torch.rand(1, BAND, CODE.d_raw, generator=gen, device=DEV) * 2 - 1).contiguous()
    z = randn(gen, 1, BAND, C, dtype=bf)
    run = lambda f: f(x, z, w, compute_dtype=bf, **kw)
    ms, plain_ms = time_ms(lambda: run(fused_resnetfc)), time_ms(lambda: run(resnetfc_plain))
    wbytes = sum(t.numel() for t in w) * 2
    b_ms, b_by = bound(x.numel() * 4 + z.numel() * 2 + wbytes + BAND * 4 * 4,
                       decoder_flops(BAND, 1), BF16_FLOPS)
    # the wgmma forward beside the cuBLAS chain of its products, in turns in
    # this run: serving at the band chunk, and the stash forward at the band
    # call of a train step (the chain's inputs from a generator of their own)
    args = K2._prepare(x, z, w, CODE, bf)
    dims = K2._dims(args, 5, 3, True)
    gen_lib = torch.Generator(device=DEV).manual_seed(32)
    k_in = dims["k_in"]
    vs_chain = {"serve N=81920": alternate({
        "wgmma": lambda: K2._forward(args, dims, bf, False),
        "cublas_chain": product_chain(gen_lib, BAND, 512, C, k_in, bf, False)})}
    xs = torch.rand(1, BAND_TRAIN, CODE.d_raw, generator=gen_new, device=DEV) * 2 - 1
    sargs = K2._prepare(xs, randn(gen_new, 1, BAND_TRAIN, C, dtype=bf), w, CODE, bf)
    sdims = K2._dims(sargs, 5, 3, True)
    vs_chain["stash N=327680"] = alternate({
        "wgmma": lambda: K2._forward(sargs, sdims, bf, True),
        "cublas_chain": product_chain(gen_lib, BAND_TRAIN, 512, C, k_in, bf, False)})
    stash_ms = kernel_device_ms(lambda: K2._forward(sargs, sdims, bf, True), (FWD_KERNEL,))
    del sargs
    # the stash forward's least time: its products, or its 11 stash rows of
    # 512 bf16 a point written with the inputs read
    act = BAND_TRAIN * 512 * 2
    sb_ms, sb_by = bound(xs.numel() * 4 + BAND_TRAIN * C * 2 + wbytes + BAND_TRAIN * 4 * 4
                         + K2.stash_slots(1, 5, 3) * act, decoder_flops(BAND_TRAIN, 1), BF16_FLOPS)
    for label, r in vs_chain.items():
        m = r["median"]
        print(f"K2 forward {label}: wgmma {m['wgmma']['ms']:.4f} ms, the cuBLAS chain of its "
              f"products {m['cublas_chain']['ms']:.4f} ms (medians of 3 loops each, in turns; SM "
              f"clock {m['wgmma']['clocks.sm']:.0f} / {m['cublas_chain']['clocks.sm']:.0f} MHz, "
              f"power {m['wgmma']['power.draw']:.0f} / {m['cublas_chain']['power.draw']:.0f} W)")
    return dict(name="fused_resnetfc", source="avr_tpu_torch/csrc/resnetfc_hopper.cu",
                replaces="avr_tpu/ops/pallas/resnetfc.py:896", tpu_kernel="fused_resnetfc",
                shape=f"N={BAND}, NS=1, d_hidden 512, 5 blocks, bf16", cases=cases,
                ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                stash_ms=stash_ms[FWD_KERNEL], stash_bound_ms=sb_ms, stash_bound_by=sb_by,
                vs_cublas_chain=vs_chain)


# bf16 beyond the wgmma forward's 512-lane A tile (d_hidden <= 512):
# forward_route sends these to the wgmma forward, which takes the encoded
# input and the latent in pieces of up to 768 lanes (its A tile and park
# tiles), up to FWD_OPERAND_MAX.  A latent of 1,024 (an encoder of 5
# stages: 64 + 64 + 128 + 256 + 512), 547 encoded lanes (8 frequencies of 32
# coded lanes with the input, 3 passed through: padded to 576), the global
# encoder's 640 lanes beside the spatial 512, and d_hidden 256 with a
# latent of 1,024: (d_hidden, code, latent, views).
WIDE_CODE = CodeSpec(num_freqs=8, freq_factor=1.5, include_input=True, d_coded=32, d_pass=3)
PIECES_CASES = ((512, CODE, 1024, 2), (512, WIDE_CODE, C, 1), (512, CODE, 640, 1),
                  (256, CODE, 1024, 1))


def check_resnetfc_pieces(gen):
    """K2's bf16 forward past 512 latent or encoded lanes at PIECES_CASES
    (N off the 64-point tile): the wgmma forward's pieces through
    fused_resnetfc (the counters: the wgmma forward once); its output
    against the plain version at the bf16 cases' 2^-7 of the largest
    output, its stash slot by slot (STASH_REL, STASH_FLIPS), both bit for
    bit on a rerun; and the backward on the pieces: the stash backward bit
    for bit on a rerun, the recompute backward bit for bit the stash
    backward in one chunk, and its point cotangents bit for bit in
    1,000-point chunks (every forward of them on the wgmma route)."""
    bf, kw, cases = torch.bfloat16, dict(n_blocks=5, n_lin_z=3, activate_out=True), []
    n = CHUNK + 37
    for dh, code, dl, ns in PIECES_CASES:
        k_in = K2.d_enc_padded(code.d_enc)
        route = K2.forward_route(bf, dl, k_in, dh)
        label = f"d_hidden {dh} d_latent {dl} k_in {k_in} N={n} NS={ns} bf16"
        if route != "wgmma":
            raise AssertionError(f"K2 {label}: routed to {route}")
        w = decoder_weights(gen, code=code, dl=dl, dh=dh)
        x = (torch.rand(ns, n, code.d_raw, generator=gen, device=DEV) * 2 - 1).contiguous()
        z = randn(gen, ns, n, dl, dtype=bf)
        want = resnetfc_plain(x, z, w, compute_dtype=bf, code=code, **kw)
        tol = 2.0 ** -7 * max(1.0, float(want.abs().max()))
        args = K2._prepare(x, z, w, code, bf)
        dims = K2._dims(args, 5, 3, True)
        before = dict(_build.launches)
        got = fused_resnetfc(x, z, w, compute_dtype=bf, code=code, **kw)
        ran = {k: v - before.get(k, 0) for k, v in _build.launches.items()
               if v != before.get(k, 0)}
        if ran != {K2.NAME: 1, K2.NAME_WGMMA: 1}:
            raise AssertionError(f"K2 {label}: launches {ran}, not the wgmma forward once")
        held = check(f"wgmma pieces {label}", max_err(got, want), tol)
        cases.append(held)
        out, st = K2._forward(args, dims, bf, True)
        again = K2._forward(args, dims, bf, True)
        cases.append(check_rerun(f"wgmma pieces rerun: output and stash {label}", (got, out, st),
                                 (again[0], again[0], again[1])))
        pst = decoder_plain_stash(x, z, w, n_blocks=5, n_lin_z=3, code=code, compute_dtype=bf)
        for i in range(len(pst)):
            cases.append(check(f"wgmma pieces stash slot {i} {label}", max_err(st[i], pst[i]),
                               STASH_REL * max(float(pst[i].abs().max()), 1e-30),
                               against="plain stash"))
        flips = float(((st > 0) != (pst > 0)).float().mean())
        if not flips <= STASH_FLIPS:
            raise AssertionError(f"K2 wgmma pieces stash {label}: {flips} of the ReLU masks "
                                 f"flipped > {STASH_FLIPS}")
        cases.append({"case": f"wgmma pieces stash ReLU mask flips {label}",
                      "against": "plain forward", "flip_fraction": flips, "bound": STASH_FLIPS})
        print(f"K2 {label}: wgmma pieces {held['max_abs_err']:.3e} (tolerance {tol:.3e}); stash "
              f"mask flips {flips:.2e}")
        # the backward on the pieces' stash and on the recompute's forwards
        g = randn(gen, n, 4) + 0.5
        kern = lambda stash: (lambda x, z, *ws: fused_resnetfc(
            x, z, DecoderWeights(*ws), compute_dtype=bf, code=code, stash=stash, **kw))
        before = dict(_build.launches)
        stash_grads = grads_of(kern(True), (x, z, *w), g)
        cases.append(check_rerun(f"wgmma pieces: stash backward rerun {label}", stash_grads,
                                 grads_of(kern(True), (x, z, *w), g)))
        rec = grads_of(kern(False), (x, z, *w), g)
        cases.append(check_rerun(f"wgmma pieces: recompute bit for bit the stash backward "
                                 f"{label}", stash_grads, rec))
        saved = K2.RECOMPUTE_CHUNK
        K2.RECOMPUTE_CHUNK = 1_000
        try:
            cut = grads_of(kern(False), (x, z, *w), g)
        finally:
            K2.RECOMPUTE_CHUNK = saved
        cases.append(check_rerun(f"wgmma pieces: recompute in 1,000-point chunks, dx and dz bit "
                                 f"for bit {label}", stash_grads[:2], cut[:2]))
        cases += [check_rel(f"{nm} {label} recompute in 1,000-point chunks vs stash", a, b,
                            SUM_ORDER_TOL, "stash kernels")
                  for nm, a, b in zip(DECODER_GRADS[2:], cut[2:], stash_grads[2:])]
        ran = {k: v - before.get(k, 0) for k, v in _build.launches.items()}
        fwds = ran.get(K2.NAME, 0) + ran.get(K2.NAME_STASH, 0)
        if not fwds or ran.get(K2.NAME_WGMMA, 0) != fwds:
            raise AssertionError(f"K2 {label} backward: {fwds} forwards, "
                                 f"{ran.get(K2.NAME_WGMMA, 0)} on the wgmma route")
        del stash_grads, rec, cut
        del args, st, pst, out, again, got, want
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


def march_inputs(gen, ns, dtype=torch.bfloat16, sb=1, w_out_scale=0.05, hidden=HIDDEN,
                 channels=C):
    """Rays of a 128x128 camera at z = 1.3 looking at the origin (the same
    4,096 rays in each of ``sb`` scenes); the source views are that camera,
    rotated about its axis.  The rays are jittered off the pixel centres and
    no source view is the ray camera itself: otherwise every march point
    projects exactly onto a latent pixel, where the bilinear taps and the
    border mask switch, and two correct implementations round onto
    different sides of that edge.  ``w_out_scale`` sets the step head's
    size, and with it how far a step moves with the latent it reads;
    ``hidden`` the LSTM's width (the step head scaled by 1/sqrt(hidden / 16)
    so the step keeps its size); ``channels`` the latent's."""
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
                feat=randn(gen, sb, ns, LATENT, LATENT, channels, dtype=dtype),
                w_ih=randn(gen, channels, H4, scale=channels ** -0.5),
                w_hh=randn(gen, hidden, H4, scale=0.25 * (16 / hidden) ** 0.5),
                bias=randn(gen, H4, scale=0.1),
                w_out=randn(gen, hidden, 1, scale=w_out_scale * (16 / hidden) ** 0.5),
                b_out=randn(gen, 1, scale=0.01))


# K3's kernels by route (csrc/march.cu): bf16 marches 16-ray tiles on the
# tensor cores, its backward's latent cotangent through K5's bins (the
# march's own instantiation, <true, true>: projected points shared by the
# views); float32 marches 8-ray tiles by register-tiled FMA, its backward's
# latent cotangent through the same bins' float32 accumulate
K3_FWD_KERNELS = ("lstm_march_tile_kernel",)
K3_BINS = ("gather_bin_count_kernel<true, true>", "gather_bin_scan_kernel",
           "gather_bin_plan_kernel", "gather_bin_scatter_kernel<true, true>",
           "gather_bin_reduce_kernel")
K3_BWD_KERNELS = ("lstm_march_tile_bwd_kernel", "lstm_march_partials_kernel",
                  "gather_bin_mma_kernel<true, true>") + K3_BINS
K3_F32_KERNELS = ("lstm_march_f32_tile_kernel", "lstm_march_f32_walk_kernel")
K3_F32_BWD_KERNELS = ("lstm_march_f32_walk_kernel", "lstm_march_partials_kernel",
                      "gather_bin_accum_kernel<true, true>") + K3_BINS
# the float32 wgrad (csrc/resnetfc.cu) and its reduction (the bf16 wgrad's)
WGRAD_F32_KERNELS = ("resnetfc_wgrad_f32_kernel", "resnetfc_wgrad_reduce_kernel")


@contextlib.contextmanager
def march_routed(cd, backward=False):
    """Runs one K3 call (and, with ``backward``, its backward) and fails
    unless the route's counters moved with the wrapper's: bf16 the tile
    kernels' (``NAME_TILES``, ``NAME_BWD_TILES``), float32 the float32 tile
    kernels' (``NAME_F32``, ``NAME_BWD_F32``)."""
    names = (K3.NAME, K3.NAME_TILES, K3.NAME_F32) + (
        (K3.NAME_BWD, K3.NAME_BWD_TILES, K3.NAME_BWD_F32) if backward else ())
    before = {n: _build.launches.get(n, 0) for n in names}
    yield
    ran = {n: _build.launches.get(n, 0) - before[n] for n in names}
    tiles = int(cd == torch.bfloat16)
    want = {K3.NAME: 1, K3.NAME_TILES: tiles, K3.NAME_F32: 1 - tiles}
    if backward:
        want.update({K3.NAME_BWD: 1, K3.NAME_BWD_TILES: tiles, K3.NAME_BWD_F32: 1 - tiles})
    if ran != want:
        raise AssertionError(f"K3 {str(cd)[6:]}: launches {ran}, expected {want}")


def march_fwd_bytes(rays, steps, hid, feat_bytes, save):
    """The forward's own bytes: the latent, the rays' points and directions
    in, the final points out, the weights; with ``save`` the saved rows."""
    rows = rays * steps * K3.aux_width(hid) * 4 if save else 0
    return feat_bytes + rays * 3 * 4 * 3 + C * 4 * hid * 2 + rows


def check_march_f32(gen):
    """K3's float32 forward (8-ray tiles, register-tiled FMA) against its
    plain version: the bf16 list's cases (NS 1 and 2 at 2 steps, early stop
    at 0.02, hidden 62 with W_ih read through L2) and the main path's two
    shapes at 10 steps, a served chunk and the train step's 4 x 4,096 rays
    under autograd (the saved rows), at the step head TIMED_HEAD (at 0.05 a
    10-step march is ill-conditioned: check_march_bwd's conditioning line).
    Tolerance 1e-4 abs on points of unit size: float32 on both sides, the
    gate sums in another order (the plain version's cuBLAS products) and
    one-ulp transcendental differences, carried through the steps."""
    cases = []
    # (scenes, views, steps, early-stop eps, hidden, step head, under autograd)
    for sb, ns, steps, eps, hid, head, grad in (
            (1, 1, 2, 0.0, HIDDEN, 0.05, False), (1, 2, 2, 0.0, HIDDEN, 0.05, False),
            (1, 1, 2, 0.02, HIDDEN, 0.05, False), (1, 1, 2, 0.0, 62, 0.05, False),
            (1, 1, STEPS, 0.0, HIDDEN, TIMED_HEAD, False),
            (SB_TRAIN, 1, STEPS, 0.0, HIDDEN, TIMED_HEAD, True)):
        inp = march_inputs(gen, ns, dtype=torch.float32, sb=sb, w_out_scale=head, hidden=hid)
        if grad:
            inp = {k: v.requires_grad_(True) if k != "proj" else v for k, v in inp.items()}
        kw = dict(steps=steps, early_stop_eps=eps, compute_dtype=torch.float32)
        with march_routed(torch.float32):
            got = fused_lstm_march(**inp, **kw).detach()
        want = lstm_march_plain(**inp, **kw).detach()
        if not torch.isfinite(got).all():
            raise AssertionError(f"float32 march NS={ns} steps={steps}: non-finite output")
        cases.append(check(f"float32 R={sb}x{CHUNK} NS={ns} steps={steps} eps={eps} hidden {hid} "
                           f"w_out {head}" + (" with the saved rows" if grad else ""),
                           max_err(got, want), 1e-4))
    print(f"K3 float32 forward: {len(cases)} cases, worst max abs error "
          f"{max(c['max_abs_err'] for c in cases):.3e} (tolerance 1e-4)")
    return cases


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
    # the float32 route (8-ray tiles, register-tiled FMA) at the serving
    # shape and at the train step's call with the saved rows, its cases
    # against the plain version (a generator of their own) and its reruns
    f32 = {k: (v.float() if v.is_floating_point() else v) for k, v in inp.items()}
    kw32 = dict(steps=STEPS, compute_dtype=torch.float32)
    with march_routed(torch.float32):
        fused_lstm_march(**f32, **kw32)
    run32 = lambda: fused_lstm_march(**f32, **kw32)
    cases.append(check_rerun("rerun float32 forward", [run32()], [run32()]))
    tr32 = {k: (v.detach().float().requires_grad_(True) if k != "proj" else v.float())
            for k, v in tr.items()}
    run32_saved = lambda: fused_lstm_march(**tr32, **kw32)
    cases.append(check_rerun("rerun float32 forward with the saved rows",
                             [run32_saved().detach()], [run32_saved().detach()]))
    f32_cases = check_march_f32(torch.Generator(device=DEV).manual_seed(9))
    cases += f32_cases
    kept = dict(kernel=K3_F32_KERNELS[0], ms=kernel_device_ms(run32, K3_F32_KERNELS[:1],
                                                              iters=20)[K3_F32_KERNELS[0]],
                call_ms=time_ms(run32), plain_ms=time_ms(lambda: lstm_march_plain(**f32, **kw32)),
                bound_ms=bound(march_fwd_bytes(CHUNK, STEPS, HIDDEN, inp["feat"].numel() * 4,
                                               False), flops, F32_FLOPS)[0],
                bound_by=bound(march_fwd_bytes(CHUNK, STEPS, HIDDEN, inp["feat"].numel() * 4,
                                               False), flops, F32_FLOPS)[1], library_ms=None,
                max_abs_err=max(c["max_abs_err"] for c in f32_cases),
                shape=f"R={CHUNK} x {STEPS} steps, NS=1, C={C}, hidden {HIDDEN}, float32")
    saved32 = bound(march_fwd_bytes(SB_TRAIN * CHUNK, STEPS, HIDDEN, tr["feat"].numel() * 4, True),
                    SB_TRAIN * flops, F32_FLOPS)
    kept["saved_rows"] = dict(
        shape=f"{SB_TRAIN}x{CHUNK} rays, under autograd",
        ms=kernel_device_ms(run32_saved, K3_F32_KERNELS[:1], iters=10)[K3_F32_KERNELS[0]],
        plain_ms=time_ms(lambda: lstm_march_plain(**tr32, **kw32), iters=3), bound_ms=saved32[0],
        bound_by=saved32[1])
    del tr32
    print(f"K3 forward: serve R={CHUNK} {device[K3_FWD_KERNELS[0]]:.4f} device ms (call {ms:.4f}, "
          f"host {host:.4f}, "
          f"SM {smi['clocks.sm']} MHz, {smi['power.draw']} W); train {SB_TRAIN}x{CHUNK} with "
          f"the saved rows {saved[K3_FWD_KERNELS[0]]:.4f} device ms (SM "
          f"{saved_smi['clocks.sm']} MHz); float32 tiles {kept['ms']:.4f}, with the saved rows "
          f"{kept['saved_rows']['ms']:.4f} (bounds {kept['bound_ms']:.4f}, "
          f"{kept['saved_rows']['bound_ms']:.4f})")
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
def decoder_bwd_matched(x, z, w, st, g, *, n_blocks, n_lin_z, code, compute_dtype, cot=None,
                        wgrads=True):
    """The decoder's stash backward (``activate_out`` on) in plain PyTorch
    with the kernel's rounding points, from a given stash ``st``: each
    product's input cotangent is rounded to the compute dtype, the trunk
    cotangent stays float32, the ReLU masks are read from the stash.  Fed
    the kernel's own stash, its masks are the kernel's, so only float32
    summation order separates the two; fed ``decoder_plain_stash`` in
    float32, it is the plain version's autograd up to that order.  Returns
    the gradients in ``DECODER_GRADS`` order.  With ``cot`` (a dict) it also
    keeps the rounded cotangents it forms by the kernels' cotangent slot
    (each block's ``c1`` and ``c0``, lin_in's ``ci``) and ``g_epi`` under
    ``"gout"``; ``wgrads=False`` forms no weight gradient (those stay zero):
    the dgrad's chain of products alone, the plain version of the dgrad."""
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
    if cot is not None:
        cot["gout"] = ge

    def block(gh, k, v):
        a1, a2 = act(k, 0, v), act(k, 1, v)
        c1 = r(gh)
        c0 = r(torch.where(a2 > 0, c1 @ w1[k], 0.0))
        if cot is not None:
            cot[K2.stash_slot(k, 1, v, ns, n_lin_z)] = c1
            cot[K2.stash_slot(k, 0, v, ns, n_lin_z)] = c0
        if wgrads:
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
            if wgrads:
                gr["wz"][k] += ci.T @ zv
                gr["bz"][k] += ci.sum(0)
        if cot is not None:
            cot[K2.cot_slots(ns, n_blocks, n_lin_z) - ns + v] = ci
        with torch.enable_grad():
            p = x[v].float().requires_grad_(True)
            enc = K2._encode(p, code)
            dx.append(torch.autograd.grad(enc, p, ci @ wi)[0])
        if wgrads:
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
            gs, wd, grads = K2._bwd_operands(args, dims, g, K2.NAME_DGRAD)
            _, _, cot, gout, enc = K2._dgrad(args, dims, kst, gs, wd, cd)
            jobs = wgrad_matmul_jobs(kst, cot, gout, enc, args["z"], 5, 3)
            timing["library_ms"] = time_ms(lambda: [torch.matmul(a.t(), b) for a, b in jobs],
                                           iters=5)
            cases += check_wgrad_jobs(kst, cot, gout, enc, args, dims, jobs)
            # each wrapper's host cost (the wgrad's: its plan, 30 tensor
            # maps, two launches; the dgrad's: 6 tensor maps, two launches)
            split = timing["split"]
            timing["dgrad_host"] = call_timing(
                lambda: K2._dgrad(args, dims, kst, gs, wd, cd),
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
# K2's forward, dgrad and the float32 wgrad are register-tiled FMA kernels
# (csrc/resnetfc.cu resnetfc_fwd_f32_kernel, resnetfc_dgrad_f32_kernel,
# resnetfc_wgrad_f32_kernel), and so are K3's (csrc/march.cu
# lstm_march_f32_tile_kernel, lstm_march_f32_walk_kernel: 8-ray tiles)
F32_FWD_KERNEL = "resnetfc_fwd_f32_kernel"
F32_DGRAD_KERNEL = "resnetfc_dgrad_f32_kernel"
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


# K2's float32 dgrad across its envelope: d_hidden 64, 256 and 512 (its
# thread layout's widths), d_latent 64, 512 and 1,024 (latent chunks
# narrower than, as wide as and twice d_hidden), NS 1 to 3, each at a
# partial last tile of F32_DGRAD_N points; lin_in in nine chunks (576
# encoded lanes) at two widths; and N = 0
F32_DGRAD_CASES = [(dh, CODE, dl, ns) for dh in (64, 256, 512) for dl in (64, 512, 1024)
                   for ns in (1, 2, 3)] + [(512, WIDE_CODE, 512, 2), (64, WIDE_CODE, 64, 1)]
F32_DGRAD_N = 1_037
# float32 FMA order against the cuBLAS chain over up to 13 chained products,
# on the same stash (so the same ReLU masks): summation order alone
F32_DGRAD_TOL = 1e-4
# the float32 dgrad's plain version
F32_DGRAD_CHAIN = ("the cuBLAS chain of the dgrad's products (decoder_bwd_matched without weight "
                   "gradients), float32, TF32 off: a chain of calls, not one")


def hold_f32_dgrad(label, got, x, z, w, st, g, code, k_in):
    """``K2._dgrad``'s five outputs ``got`` (float32, 5 blocks, 3
    injections) against ``decoder_bwd_matched`` on the same stash ``st``:
    dx, dz, the worst cotangent slot (the reference's rounded c1, c0 and
    ci) and gout within F32_DGRAD_TOL by relative L2, enc within it of the
    encoding.  Returns the cases."""
    ns, ref = x.shape[0], {}
    want = decoder_bwd_matched(x, z, w, st, g, n_blocks=5, n_lin_z=3, code=code,
                               compute_dtype=torch.float32, cot=ref, wgrads=False)
    dx, dz, cot, gout, enc = got
    cases = [check_l2(f"float32 dgrad dx {label}", dx, want[0], F32_DGRAD_TOL),
             check_l2(f"float32 dgrad dz {label}", dz, want[1], F32_DGRAD_TOL)]
    del want
    ge = ref.pop("gout")
    if sorted(ref) != list(range(K2.cot_slots(ns, 5, 3))):
        raise AssertionError(f"K2 float32 dgrad {label}: reference slots {sorted(ref)}")
    cases.append(max((check_l2(f"float32 dgrad cot slot {i} {label}", cot[i], c, F32_DGRAD_TOL)
                      for i, c in ref.items()), key=lambda c: c["rel_l2"]))
    del ref
    cases.append(check_l2(f"float32 dgrad gout {label}", gout,
                          torch.cat([ge, torch.zeros_like(gout[:, 4:])], dim=-1), F32_DGRAD_TOL))
    want_enc = torch.stack([torch.nn.functional.pad(K2._encode(x[v], code), (0, k_in - code.d_enc))
                            for v in range(ns)])
    cases.append(check_l2(f"float32 dgrad enc {label}", enc, want_enc, F32_DGRAD_TOL))
    return cases


def check_f32_dgrad(gen):
    """K2's float32 dgrad (``K2._dgrad``) at F32_DGRAD_CASES against
    ``decoder_bwd_matched`` fed the kernel's own stash: dx, dz, every
    cotangent slot (the reference's rounded c1, c0 and ci) and gout within
    F32_DGRAD_TOL by relative L2, enc within it of the encoding; each call
    one launch of the float32 dgrad kernel, a rerun bit for bit; at N = 0
    empty outputs and no launch."""
    f32, cases = torch.float32, []
    for dh, code, dl, ns in F32_DGRAD_CASES:
        w = decoder_weights(gen, dh=dh, code=code, dl=dl)
        for n in (F32_DGRAD_N, 0):
            if n == 0 and (code, ns) != (CODE, 1):
                continue
            x = (torch.rand(ns, n, code.d_raw, generator=gen, device=DEV) * 2 - 1).contiguous()
            z = randn(gen, ns, n, dl)
            g = randn(gen, n, 4) + 0.5
            label = f"d_hidden {dh} k_in {K2.d_enc_padded(code.d_enc)} d_latent {dl} N={n} NS={ns}"
            args = K2._prepare(x, z, w, code, f32)
            dims = K2._dims(args, 5, 3, True)
            st = K2._forward(args, dims, f32, True)[1]
            gs, wd, _ = K2._bwd_operands(args, dims, g, K2.NAME_DGRAD)
            before = dict(_build.launches)
            got = K2._dgrad(args, dims, st, gs, wd, f32)
            again = K2._dgrad(args, dims, st, gs, wd, f32)
            ran = f32_ran(before, (K2.NAME_DGRAD_F32,))[K2.NAME_DGRAD_F32]
            if ran != (2 if n else 0):
                raise AssertionError(f"K2 float32 dgrad {label}: {ran} launches of the kernel")
            if n == 0:
                if any(t.numel() for t in got[:2] + got[3:]) or got[2].shape[1]:
                    raise AssertionError(f"K2 float32 dgrad {label}: non-empty outputs")
                cases.append({"case": f"float32 dgrad {label}", "against": "shape",
                              "max_abs_err": 0.0, "tol": 0.0})
                continue
            cases.append(check_rerun(f"float32 dgrad rerun {label}", got, again))
            cases += hold_f32_dgrad(label, got, x, z, w, st, g, code, dims["k_in"])
            del x, z, g, args, st, got, again
    worst = max(c.get("rel_l2", 0.0) for c in cases)
    print(f"K2 float32 dgrad: {len(cases)} cases within {F32_DGRAD_TOL} of decoder_bwd_matched "
          f"on its own stash (worst relative L2 {worst:.3e}), every rerun bit for bit, every "
          f"call on {F32_DGRAD_KERNEL}")
    return cases


def check_float32(gen):
    """K2's float32 kernels at the main path's shapes (the forward at the
    band chunk and at a served chunk's coarse query, the stash backward's
    dgrad and wgrad at the train step's band call) and the float32 wgrad at
    K3's two jobs: times beside the float32 bounds and the plain versions
    (the wgrad also beside torch.matmul in float32, TF32 off), the
    forward's cases (check_f32_forward, a generator of their own), the
    dgrad held to its plain version (hold_f32_dgrad) at the band call and at
    the coarse query, the recompute's dx and dz at the band call (its
    chunks of 262,144 and 65,536 points) bitwise the stash dgrad's, the
    dgrad's envelope (check_f32_dgrad), the wgrad's jobs against
    torch.matmul and K3's against the plain product in float64, and every
    wgrad output bit for bit on a rerun.  Returns the rows and the
    kernels-line entries of the float32 forward, dgrad and wgrad."""
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
    gs, wd, grads = K2._bwd_operands(args, dims, g, K2.NAME_DGRAD)
    got = K2._dgrad(args, dims, st, gs, wd, f32)
    # the dgrad at the band call against its plain version, and the
    # recompute's (its chunks of 262,144 and 65,536 points): dx and dz the
    # stash backward's bit for bit
    dcases = hold_f32_dgrad(f"N={BAND_TRAIN} NS=1 (the train step's band call)", got, x, z, w,
                            st, g, CODE, dims["k_in"])
    rec = K2._backward_recompute(args, dims, g, f32)
    if not all(same_bits(a, b) for a, b in zip(got[:2], rec[:2])):
        raise AssertionError(f"K2 float32 recompute N={BAND_TRAIN}: dx, dz not bitwise the stash "
                             f"dgrad's")
    dcases.append({"case": f"float32 recompute dx, dz N={BAND_TRAIN}", "against": "stash dgrad",
                   "max_abs_err": 0.0, "tol": 0.0})
    del rec
    cot, gout, enc = got[2:]
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
    # the plain version of the dgrad: the cuBLAS chain of its products
    # (decoder_bwd_matched without the weight gradients), float32, TF32 off
    chain = lambda: decoder_bwd_matched(x, z, w, st, g, n_blocks=5, n_lin_z=3, code=CODE,
                                        compute_dtype=f32, wgrads=False)
    rows["K2 dgrad"] = dict(ms=split[F32_DGRAD_KERNEL], plain_ms=time_ms(chain, iters=2),
                            plain=F32_DGRAD_CHAIN, library_ms=None, bound_ms=bound(22 * act + io + wbytes, flops, F32_FLOPS)[0], **common)
    rows["K2 wgrad"] = dict(ms=sum(split[k] for k in WGRAD_F32_KERNELS), split=split,
                            call_ms=time_ms(wg, iters=3), library_ms=library_ms,
                            library="torch.matmul over the 15 G^T A jobs, float32, TF32 off",
                            plain_ms=None, bound_ms=bound(22 * act + BAND_TRAIN * C * 4
                                                          + wbytes * 2, flops, F32_FLOPS)[0],
                            **common)
    rows["K2 stash backward"] = dict(ms=time_ms(run, iters=2), plain_ms=time_ms(
        lambda: grads_of(lambda x_, z_: resnetfc_plain(x_, z_, w, **kw), (x, z), g), iters=2),
        **common)
    del x, z, g, args, st, gs, wd, grads, again, got, cot, gout, enc, jobs
    # the dgrad at the step's coarse query (the stash backward's other call:
    # 4 x 4,096 points; its own generator, so the draws above keep their inputs)
    cgen = torch.Generator(device=DEV).manual_seed(22)
    n = SB_TRAIN * CHUNK
    x = (torch.rand(1, n, CODE.d_raw, generator=cgen, device=DEV) * 2 - 1).contiguous()
    z = randn(cgen, 1, n, C)
    g = randn(cgen, n, 4) + 0.5
    args = K2._prepare(x, z, w, CODE, f32)
    dims = K2._dims(args, 5, 3, True)
    st = K2._forward(args, dims, f32, True)[1]
    gs, wd, _ = K2._bwd_operands(args, dims, g, K2.NAME_DGRAD)
    dg = lambda: K2._dgrad(args, dims, st, gs, wd, f32)
    dcases += hold_f32_dgrad(f"N={n} NS=1 (the train step's coarse query)", dg(), x, z, w, st,
                             g, CODE, dims["k_in"])
    chain = lambda: decoder_bwd_matched(x, z, w, st, g, n_blocks=5, n_lin_z=3, code=CODE,
                                        compute_dtype=f32, wgrads=False)
    rows["K2 dgrad coarse"] = dict(
        shape=f"N={n}, NS=1, f32 (the train step's coarse query)",
        ms=kernel_device_ms(dg, (F32_DGRAD_KERNEL,), iters=10)[F32_DGRAD_KERNEL],
        plain_ms=time_ms(chain, iters=5), plain=F32_DGRAD_CHAIN, library_ms=None,
        bound_ms=bound(22 * n * 512 * 4 + n * (CODE.d_raw * 8 + C * 8 + 16) + wbytes,
                       decoder_flops(n, 1), F32_FLOPS)[0])
    del x, z, g, args, st, gs, wd
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
        chain = " (a cuBLAS chain)" if r.get("plain") == F32_DGRAD_CHAIN else ""
        print(f"float32 {name} ({r['shape']}): {r['ms']:.4f} ms (bound {r.get('bound_ms')}, "
              f"plain{chain} {r.get('plain_ms')}, library {r.get('library_ms')})")
    fcases = check_f32_forward(torch.Generator(device=DEV).manual_seed(20))
    dcases += check_f32_dgrad(torch.Generator(device=DEV).manual_seed(23))
    fwd_row, wg_row, dg_row = rows["K2 forward"], rows["K2 wgrad"], rows["K2 dgrad"]
    src = "avr_tpu_torch/csrc/resnetfc.cu"
    kernels = [
        dict(name=K2.NAME_F32, source=src, replaces="avr_tpu/ops/pallas/resnetfc.py:896",
             tpu_kernel="fused_resnetfc (call :726), float32",
             shape=f"N={BAND}, NS=1, d_hidden 512, 5 blocks, f32", cases=fcases,
             ms=fwd_row["ms"], plain_ms=fwd_row["plain_ms"], library_ms=None,
             bound_ms=fwd_row["bound_ms"], bound_by="operations",
             serve_ms=rows["K2 forward serve"]["ms"],
             serve_bound_ms=rows["K2 forward serve"]["bound_ms"]),
        dict(name=K2.NAME_DGRAD_F32, source=src, replaces="avr_tpu/ops/pallas/resnetfc.py:823",
             tpu_kernel="_bwd_stash_impl's dgrad (and _bwd_impl's, call :853), float32",
             shape=f"N={BAND_TRAIN}, NS=1, d_hidden 512, 5 blocks, f32", cases=dcases,
             ms=dg_row["ms"], plain_ms=dg_row["plain_ms"], plain=dg_row["plain"],
             library_ms=None, bound_ms=dg_row["bound_ms"],
             bound_by="operations", coarse_ms=rows["K2 dgrad coarse"]["ms"],
             coarse_plain_ms=rows["K2 dgrad coarse"]["plain_ms"],
             coarse_bound_ms=rows["K2 dgrad coarse"]["bound_ms"]),
        dict(name=K2.NAME_WGRAD_F32, source=src, replaces="avr_tpu/ops/pallas/resnetfc.py:823",
             tpu_kernel="_bwd_stash_impl's weight gradients, float32",
             shape=f"N={BAND_TRAIN}, 15 jobs, f32", cases=wcases, ms=wg_row["ms"],
             plain_ms=rows["K3 dW_ih + dW_hh"]["plain_ms"], plain="K3's two jobs in float64",
             library_ms=wg_row["library_ms"], bound_ms=wg_row["bound_ms"],
             bound_by="operations", k3_ms=rows["K3 dW_ih + dW_hh"]["ms"],
             k3_library_ms=rows["K3 dW_ih + dW_hh"]["library_ms"],
             k3_bound_ms=rows["K3 dW_ih + dW_hh"]["bound_ms"])]
    return dict(rows=rows, cases=cases + fcases + dcases + wcases, kernels=kernels)


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
        gs, wd, _ = K2._bwd_operands(args, dims, g, K2.NAME_DGRAD)
        _, _, cot, gout, enc = K2._dgrad(args, dims, st, gs, wd, cd)
        s0 = K2.RECOMPUTE_CHUNK
        n0 = BAND_TRAIN - s0
        work = K2._recompute_workspace(dims, n0, cd, DEV)
        _, rst, rcot, rgout, renc = K2._recompute_chunk(
            args, dims, gs, wd, work, s0, n0, torch.empty_like(got[0]), torch.empty_like(got[1]),
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
        del x, z, g, args, st, want, got, gs, wd, cot, gout, enc, work, rst, rcot, rgout, renc

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
    # the float32 route (8-ray tiles, the bins' float32 accumulate, the
    # float32 wgrad) at the same shape: its eight gradients against the plain
    # autograd and bit for bit on a rerun, and its time
    f32 = {k: (v.float() if v.is_floating_point() else v) for k, v in inp.items()}
    f32_fn = lambda *t: fused_lstm_march(f32["proj"], *t, steps=STEPS, compute_dtype=torch.float32)
    got32, run32 = grads_of(f32_fn, tuple(f32[k] for k in keys), g, keep=True)
    cases.append(check_rerun(f"rerun all eight gradients {label[:-len('bf16 (timed)')]}float32",
                             got32, run32()))
    # held to the plain autograd at 1e-3 relative L2, as the float32 10-step
    # case above: sums in other orders only, at the contractive step head
    want32, plain32 = grads_of(lambda *t: lstm_march_plain(f32["proj"], *t, steps=STEPS,
                                                           compute_dtype=torch.float32),
                               tuple(f32[k] for k in keys), g, keep=True)
    label32 = f"{label[:-len('bf16 (timed)')]}float32 (timed)"
    f32_cases = [check_l2(f"{nm} {label32}", a, b, 1e-3)
                 for nm, a, b in zip(MARCH_GRADS, got32, want32)]
    cases += f32_cases
    del want32
    split32 = kernel_device_ms(run32, K3_F32_BWD_KERNELS + WGRAD_F32_KERNELS, iters=2)
    # its own bytes: a float32 latent read and dfeat written once, the saved
    # rows, the rays, the weights (the rows it writes for the bins and the
    # wgrad are the design's, as in the bf16 bound)
    b32 = bound(fmap * 4 * 2 + rows * aw * 4 + rays * 3 * 4 * 4 + (C + HIDDEN) * 4 * HIDDEN * 4,
                walk_flops, F32_FLOPS)
    kept = dict(kernel=K3_F32_KERNELS[1], ms=sum(split32[k] for k in K3_F32_BWD_KERNELS),
                walk_ms=split32[K3_F32_BWD_KERNELS[0]], call_ms=time_ms(run32, iters=3),
                wgrad_device_ms=sum(split32[k] for k in WGRAD_F32_KERNELS),
                device_ms_by_kernel=split32, plain_ms=time_ms(plain32, iters=2), library_ms=None,
                bound_ms=b32[0], bound_by=b32[1],
                max_abs_err=max(c["max_abs_err"] for c in f32_cases),
                shape=f"{SB_TRAIN}x{CHUNK} rays x {STEPS} steps, NS=1, C={C}, hidden {HIDDEN}, "
                      f"float32")
    del run32, plain32
    print(f"K3 backward timed: walk + bins + reduce {bwd_ms:.4f} device ms ({split}), bound "
          f"{b_ms:.4f} by {b_by} (the parent's figure {old_b[0]:.4f} by {old_b[1]}); SM "
          f"{smi['clocks.sm']} MHz, {smi['power.draw']} W; float32 walk + bins + reduce "
          f"{kept['ms']:.4f} (the walk {kept['walk_ms']:.4f}), its dW_ih + dW_hh "
          f"{kept['wgrad_device_ms']:.4f}; float32 worst relative L2 against the plain autograd "
          f"{max(c['rel_l2'] for c in f32_cases):.3e}")
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


def proj_inputs(gen, sb, ns, dtype, n, channels=C):
    """K5's inputs at a field query of ``sb`` scenes and ``ns`` views: the
    latent, the points broadcast over the views, and each view's packed
    projection.  The points lie on ``march_inputs``' rays, which are
    jittered off the pixel centres and seen by source views that are not
    the ray camera: at the band query (``n = BAND``) ``N_BAND`` a ray over
    +-0.15 about the marched point, at the coarse query (``n = CHUNK``) the
    marched point itself, one a ray.  ``channels``: the latent's."""
    inp = march_inputs(gen, ns, dtype=dtype, sb=sb, channels=channels)
    pts = inp["coords0"]
    if n == BAND:
        off = (torch.rand(sb, CHUNK, N_BAND, 1, generator=gen, device=DEV) - 0.5) * 0.3
        pts = pts[:, :, None] + inp["rds"][:, :, None] * off
    pts = pts.reshape(sb, 1, n, 3).expand(sb, ns, n, 3).reshape(sb * ns, n, 3)
    return (inp["feat"].reshape(sb * ns, LATENT, LATENT, channels), pts.contiguous(),
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
    # the library call K1's row times, F.grid_sample, at K5's projected
    # coordinates: the projection (project_packed) is left out of its time
    nchw, grid = feat.permute(0, 3, 1, 2).float(), project_packed(proj, pts)[:, None]
    lib = lambda: F.grid_sample(nchw, grid, mode="bilinear", padding_mode="border",
                                align_corners=True)
    cases.append(check("F.grid_sample at the projected coordinates agrees",
                       max_err(lib()[:, :, 0].transpose(1, 2), run()), 2e-2, against="library"))
    return dict(name="gather_bilinear_projected", source="avr_tpu_torch/csrc/gather.cu",
                replaces="avr_tpu/ops/pallas/gather.py:642",
                tpu_kernel="gather_bilinear_projected",
                shape=f"latent 1x{LATENT}x{LATENT}x{C} bf16, N={BAND}", cases=cases, ms=ms,
                call_ms=time_ms(run, iters=20),
                plain_ms=time_ms(lambda: gather_bilinear_projected_plain(feat, pts, proj)),
                library_ms=time_ms(lib), library="F.grid_sample at the projected coordinates "
                                                 "(the projection left out)",
                bound_ms=b_ms, bound_by=b_by)


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
    # the library call K1's backward row times, F.grid_sample's backward (the
    # map's and the coordinates' cotangents), at K5's projected coordinates:
    # the projection and its chain rule are left out of its time
    nchw = feat.permute(0, 3, 1, 2).float()
    _, run_lib = grads_of(lambda f, c: F.grid_sample(f, c[:, None], mode="bilinear",
                                                     padding_mode="border", align_corners=True),
                          (nchw, project_packed(proj, pts)), g.float().permute(0, 2, 1)[:, :, None],
                          keep=True)
    ms, by_kernel = bwd_device_ms(run, K5_BWD_KERNELS)
    smi = sustained(run, 1.0, SMI_FIELDS)
    no_host_sync(run)
    b_ms, b_by = proj_bound(SB_TRAIN, BAND, torch.bfloat16, True)
    return dict(name="gather_bilinear_projected_bwd", source="avr_tpu_torch/csrc/gather.cu",
                replaces="avr_tpu/ops/pallas/gather.py:712", tpu_kernel="_pbwd",
                shape=f"latent {SB_TRAIN}x{LATENT}x{LATENT}x{C} bf16, N={BAND} per scene",
                cases=cases, ms=ms, device_ms_by_kernel=by_kernel, sustained=smi,
                call_ms=time_ms(run),
                plain_ms=time_ms(run_plain, iters=3), library_ms=time_ms(run_lib),
                library="F.grid_sample's backward at the projected coordinates (the projection "
                        "left out)", bound_ms=b_ms, bound_by=b_by)


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
    if dtype == torch.float32:  # every float32 K2 forward and K3 march on the float32 kernels
        want[K2.NAME_F32] = want.get(K2.NAME, 0) + want.get(K2.NAME_STASH, 0)
        if K3.NAME in want:
            want[K3.NAME_F32] = want[K3.NAME]
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
    ours = (GATHER_FWD_KERNEL, "gather_bilinear_bwd_kernel",
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
# K3's float32 tile kernels)
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

    def confirm_skip(i, metrics):
        """The optimizer skipped step ``i``: ``diagnose_skip``."""
        if int(metrics["notfinite"]) == len(skipped):
            return
        skipped.append(dict(step=i, **diagnose_skip(
            model, state.params, loss_params, replay["batch"], replay["key"],
            float(metrics["loss"]), f"{path} train step {i}", chunks, rng_mode)))

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


def diagnose_skip(model, params, loss_params, batch, key, loss, label, ray_chunks=1,
                  rng_mode="per_ray"):
    """A train step's optimizer skipped its update (a non-finite gradient;
    the weights did not move).  Redone on the same weights, batch and key
    (the BatchNorm statistics restored after) through the plain versions on
    the card, the loss must agree; the gradient must be non-finite too, or
    else, redone through the kernels, the first non-finite value must
    appear in the backward of an op that is not a kernel's, from finite
    incoming gradients: the kernels' forward points differ from the plain
    versions' in the last bits, so a point at a camera depth of exactly 0
    can come out on one side only (module docstring, phase 4).  Otherwise a
    kernel made it, and this raises.  The redos' launches are not counted.
    Returns what was found."""
    def redo(plain, found=None):
        stats = {k: v.clone() for k, v in model.named_buffers()}
        counted = dict(_build.launches)
        with plain_kernels() if plain else first_nonfinite(found):
            loss, g = loss_and_grads(model, params, loss_params, *batch, key,
                                     ray_chunks=ray_chunks, rng_mode=rng_mode)
        _build.launches.clear()
        _build.launches.update(counted)
        with torch.no_grad():
            for k, v in model.named_buffers():
                v.copy_(stats[k])
        return float(loss), [k for k, v in g.items() if not bool(torch.isfinite(v).all())]

    plain_loss, bad = redo(plain=True)
    # bf16 forward through the kernels and through the plain versions:
    # the probe's skips read up to 1.1e-5 apart
    if not abs(plain_loss - loss) <= 1e-4:
        raise AssertionError(f"{label}: loss {loss} through the kernels, {plain_loss} through "
                             f"the plain versions")
    entry = {"plain_loss": plain_loss, "plain_nonfinite": len(bad),
             "plain_nonfinite_grads": bad}
    if not bad:
        found = []
        redo(plain=False, found=found)
        if not found or found[0]["kernel"]:
            raise AssertionError(f"{label}: the kernels' gradient is not finite, the plain "
                                 f"versions' is; first non-finite at "
                                 f"{found[0] if found else 'no node'}")
        entry["first_nonfinite_node"] = found[0]
    where = (f"{len(bad)} non-finite gradients" if bad else
             f"a finite gradient, and the kernels' first non-finite value appears in "
             f"{entry['first_nonfinite_node']['node']}, which is not a kernel")
    print(f"{label}: update skipped; on the same weights and batch the plain versions give "
          f"{where}")
    return entry


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
        # every float32 K2 forward, dgrad (the stash backward's and the
        # recompute's) and wgrad (K2's, K3's) on the float32 kernels
        f32 = {K2.NAME_F32: launches.get(K2.NAME, 0) + launches.get(K2.NAME_STASH, 0),
               K2.NAME_DGRAD_F32: launches.get(K2.NAME_DGRAD, 0)
               + launches.get(K2.NAME_RECOMPUTE, 0),
               K2.NAME_WGRAD_F32: launches.get(K2.NAME_WGRAD, 0) + launches.get(K3.NAME_WGRAD, 0),
               K3.NAME_F32: launches.get(K3.NAME, 0), K3.NAME_BWD_F32: launches.get(K3.NAME_BWD, 0)}
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


# ---------------------------------------------------------------------------
# phase 6: the training loop
# ---------------------------------------------------------------------------

# the fit phase's sets: train 16 instances x 50 views (an epoch of 4 steps at
# SB 4), val 4 instances x 6 views, SIDE x SIDE synthetic scenes
FIT_TRAIN, FIT_VAL = (16, 50), (4, 6)
FIT_CFG = dict(epochs=2, batch_size=SB_TRAIN, ray_batch_size=CHUNK, device_data=True,
               rng_mode="legacy", ema_decay=0.999, steps_print=2, steps_val=4, val_scenes=4,
               render_chunk=CHUNK)
# JAX's log records (avr_tpu/training/loop.py): each event's keys
FIT_LOG_KEYS = {"train": [{"event", "t", "epoch", "step", "loss", "grad_norm", "rays_per_s"}],
                "val": [{"event", "t", "epoch", "step", "loss", "psnr", "ssim"}],
                "checkpoint": [{"event", "t", "epoch", "step", "path", "best_psnr"},
                               {"event", "t", "epoch", "path"}]}
# the kernels a fit run's steps and val renders must launch: K1, K2 and K3
# forward and backward, K7's draws and raw bits
FIT_KERNELS = ("gather_bilinear", "gather_bilinear_bwd", K2.NAME, K2.NAME_STASH,
               K2.NAME_DGRAD, K2.NAME_WGRAD, K3.NAME, K3.NAME_BWD, K3.NAME_WGRAD, K7.NAME,
               K7.NAME_BITS)


class _TimedLogger(MetricsLogger):
    """The JSONL logger, each record's host clock kept beside it."""

    def __init__(self, log_dir):
        super().__init__(log_dir, stdout=False)
        self.records = []

    def log(self, event, **scalars):
        super().log(event, **scalars)
        self.records.append(dict(event=event, clock=time.perf_counter(), **{
            k: (float(v) if isinstance(v, (float, torch.Tensor)) else v)
            for k, v in scalars.items()}))


def fit_model(dtype=torch.bfloat16, norm_type="group"):
    """The full-width model from scratch (JAX's initialisation scheme) and
    its EMA train state."""
    model = make_model(dtype=dtype, seed=0, device=DEV, norm_type=norm_type)
    opt = make_optimizer(1e-4)
    return model, opt, create_train_state(model, opt, ema=True)


def fit_run(sets, root, name, epochs, state_of=None, val=True, **kw):
    """One ``fit`` call on the phase's sets (``val=False``: no validation);
    ``state_of(model, opt, state)`` may replace the fresh state (a
    restore).  Returns the model, the state, the epoch losses, the log
    records and the call's seconds."""
    model, opt, state = fit_model(kw.pop("dtype", torch.bfloat16))
    if state_of is not None:
        state = state_of(model, opt, state)
    logger = _TimedLogger(os.path.join(root, name, "logs"))
    cfg = FitConfig(**{**FIT_CFG, "epochs": epochs, "save_root": os.path.join(root, name),
                       **kw})
    t = time.perf_counter()
    state, losses = fit(model, state, opt, sets["train"], sets["val"] if val else None,
                        LossParams(), cfg, logger=logger, device=DEV)
    torch.cuda.synchronize()
    logger.close()
    return dict(model=model, opt=opt, state=state, losses=losses, log=logger.records,
                seconds=time.perf_counter() - t)


def clean_ms_per_step(log, warm=1):
    """Wall ms a step between consecutive train records with no val or
    checkpoint between them (the first ``warm`` such intervals dropped)."""
    out, prev = [], None
    for r in log:
        if r["event"] == "train":
            if prev is not None and prev[1]:
                out.append((r["clock"] - prev[0]["clock"]) * 1e3
                           / (r["step"] - prev[0]["step"]))
            prev = (r, True)
        elif prev is not None:
            prev = (prev[0], False)
    return out[warm:]


def bare_step_ms(sets, norm_type, pairs=12, warm=2):
    """The bare device-data step (``make_train_step(sampler=...)``, no loop
    around it) on the phase's train set: ms a step over ``pairs`` pairs of
    steps, each pair ended by a synchronize (as the loop's loss line ends
    every ``steps_print`` = 2 steps), and the step itself."""
    model, opt, state = fit_model(norm_type=norm_type)
    data = build_device_dataset(sets["train"], DEV)
    step = make_train_step(model, opt, LossParams(), ema_decay=FIT_CFG["ema_decay"],
                           rng_mode="legacy",
                           sampler=make_device_sampler(data, SB_TRAIN, CHUNK),
                           sampler_key=threefry.PRNGKey(0))
    box = [state]

    def run(_=0):
        box[0], metrics = step(box[0])
        return metrics

    for _ in range(warm):
        run()
    torch.cuda.synchronize()
    ms = []
    for _ in range(pairs):
        t = time.perf_counter()
        run()
        metrics = run()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3 / 2)
    if not np.isfinite(float(metrics["loss"])):
        raise AssertionError(f"bare {norm_type} device-data step: loss {float(metrics['loss'])}")
    return ms, run


def ema_render_check(run, sets):
    """One val view rendered with the EMA weights through ``eval_variables``
    after the kernels rendered it with the raw weights (K3's bf16 forward
    keeps the raw weights' fragments then).

    * Bit for bit the kernels' render of a model that holds the EMA weights
      as its own: a stale fragment cache would give the raw weights' image.
    * Against the plain versions' render of the same EMA weights on the
      card.  At the model's 10 march steps these weights make the march
      ill-conditioned: the plain versions' own render moves by more than
      2e-3 on a share of the rays when the camera moves by 1e-6 (the floor,
      measured here), so the share of rays beyond 2e-3 between the kernels
      and the plain versions may not pass the floor's.  In float32 also at
      ``check_small_reference``'s 2 march steps, where every ray is held to
      its 2e-3."""
    model, state = run["model"], run["state"]
    dtype = model.dtype
    batch = next(sets["val"].batches(1, shuffle=True, epoch_seed=0, drop_last=False))
    src = select_source_views(np.random.default_rng(0), batch, 1, fixed_idx=[0], device=DEV)
    intr = torch.as_tensor(batch["intrinsics"][:, 1])
    c2w = torch.as_tensor(np.array(batch["cam2world"][:, 1]))
    nudged_c2w = c2w.clone()
    nudged_c2w[:, :3, 3] += 1e-6

    def render(m, cam=c2w):
        with torch.inference_mode():
            cond = m.encode(*src, train=False)
            return render_full_image(m, cond, intr, cam, SIDE, threefry.PRNGKey(0), CHUNK, DEV)

    def rays_beyond(a, b, names):
        err = {k: (getattr(a, k).float() - getattr(b, k).float()).abs().amax(-1) for k in names}
        return ({k: float((e > 2e-3).float().mean()) for k, e in err.items()},
                {k: float(e.max()) for k, e in err.items()})

    raw = render(model)  # the kernels' caches now hold the raw weights'
    with state.eval_variables():
        ema = render(model)
        with plain_kernels():
            plain, nudged = render(model), render(model, nudged_c2w)
        if dtype == torch.float32:
            cfg = model.renderer_cfg
            model.renderer_cfg = dataclasses.replace(cfg, raymarch_steps=2)
            try:
                short = render(model)
                with plain_kernels():
                    short_plain = render(model)
            finally:
                model.renderer_cfg = cfg
    holder, _, _ = fit_model(dtype)
    with torch.no_grad():
        for k, p in holder.named_parameters():
            p.copy_(state.ema_params[k])
    ref = render(holder)
    names = [k for k, v in ema._asdict().items() if v is not None]
    kind = str(dtype)[6:]
    for k in names:
        if not same_bits(getattr(ema, k), getattr(ref, k)):
            raise AssertionError(f"{kind} EMA render through eval_variables: {k} is not the "
                                 f"render of a model holding the EMA weights (a stale cache?)")
    share, worst = rays_beyond(ema, plain, names)
    floor, floor_worst = rays_beyond(nudged, plain, names)
    over = {k: (share[k], floor[k]) for k in names if share[k] > floor[k]}
    if over:
        raise AssertionError(f"{kind} EMA render: rays beyond 2e-3 of the plain versions "
                             f"(kernels, floor) {over}")
    res = dict(dtype=kind, bitwise_vs_holder=True, rays_beyond_2e_3=share,
               max_abs_err_vs_plain=worst, floor_rays_beyond_2e_3=floor,
               floor_max_abs=floor_worst, raw_vs_ema=rays_beyond(raw, ema, names)[1])
    if dtype == torch.float32:
        _, short_worst = rays_beyond(short, short_plain, names)
        if not max(short_worst.values()) <= 2e-3:
            raise AssertionError(f"float32 EMA render at 2 march steps vs the plain versions: "
                                 f"{short_worst} > 2e-3")
        res.update(steps2_max_abs_err_vs_plain=short_worst, steps2_tol=2e-3)
    return res


def check_fit_log(log, name):
    for r in log:
        keys = set(r) - {"clock"} | {"t"}
        if keys not in FIT_LOG_KEYS[r["event"]]:
            raise AssertionError(f"{name} log: {r['event']} record has keys {sorted(keys)}, "
                                 f"JAX's {FIT_LOG_KEYS[r['event']]}")
    events = {r["event"] for r in log}
    if events != set(FIT_LOG_KEYS):
        raise AssertionError(f"{name} log: events {events}")


def run_fit():
    """The training loop the way JAX's CLI trains (module docstring, phase
    6).  Returns the phase's report and its launch counts."""
    import shutil
    import tempfile

    from avr_tpu_torch.data import device as device_data
    from avr_tpu_torch.data.prefetch import PrefetchPipeline
    from avr_tpu_torch.training.loop import _epoch_inputs

    t0 = time.perf_counter()
    sets = dict(train=SceneClassDataset(synthetic_scene_mapping(*FIT_TRAIN, side=SIDE, seed=0)),
                val=SceneClassDataset(synthetic_scene_mapping(*FIT_VAL, side=SIDE, seed=1),
                                      samples_per_instance=FIT_VAL[1]))
    made_s = time.perf_counter() - t0
    root = tempfile.mkdtemp(prefix="fit_")
    # cuDNN's deterministic algorithms: the resumed run must equal the
    # uninterrupted one bit for bit (the port's kernels have no float atomics)
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    # the device sampler's draws of each run: (key, the drawn batch)
    draws = {}
    real_sampler = device_data.make_device_sampler

    def recording_sampler(*a, **kw):
        sample = real_sampler(*a, **kw)
        sink = draws.setdefault(current[0], [])

        def record(key):
            out = sample(key)
            sink.append((tuple(key), [t.clone() for t in
                                      (out[0], out[1], *out[4].values(), out[5])]))
            return out

        return record

    current = [None]
    device_data.make_device_sampler = recording_sampler
    try:
        # the first fit: 2 epochs, its launches counted
        current[0] = "first"
        torch.cuda.synchronize()
        _build.reset_launches()
        first = fit_run(sets, root, "first", 2)
        launches = dict(_build.launches)
        missing = [n for n in FIT_KERNELS if not launches.get(n)]
        if missing:
            raise AssertionError(f"fit launched no {missing}: {launches}")
        check_fit_log(first["log"], "first fit")
        files = sorted(os.listdir(os.path.join(root, "first", "checkpoints", "experiments")))
        want_files = ["run_best", "run_epoch2"]
        if files != want_files or not all(
                os.path.isfile(checkpoint_path(os.path.join(root, "first"), "run", e))
                for e in ("best", 2)):
            raise AssertionError(f"fit checkpoints {files}, expected {want_files}")
        ckpt = checkpoint_path(os.path.join(root, "first"), "run", 2)
        t = time.perf_counter()
        save_checkpoint(os.path.join(root, "save"), "run", 2, first["state"])
        torch.cuda.synchronize()
        save_s = time.perf_counter() - t
        ema = [ema_render_check(first, sets)]

        # resume from _epoch2 for one epoch, beside an uninterrupted 3-epoch run
        restored_step = []

        def restore(model, opt, state):
            t = time.perf_counter()
            state = restore_checkpoint(os.path.join(root, "first"), "run", 2, state,
                                       strict=True)
            torch.cuda.synchronize()
            restored_step.append((int(state.step), time.perf_counter() - t))
            return state

        current[0] = "resumed"
        resumed = fit_run(sets, root, "resumed", 1, state_of=restore)
        current[0] = "full"
        full = fit_run(sets, root, "full", 3)
        step0, restore_s = restored_step[0]
        if step0 != 8 or int(resumed["state"].step) != 12 or int(full["state"].step) != 12:
            raise AssertionError(f"restored step {step0}, resumed to "
                                 f"{int(resumed['state'].step)}, full {int(full['state'].step)}")
        got, want = draws["resumed"], draws["full"][8:]
        if len(got) != 4 or len(want) != 4 or any(
                a[0] != b[0] or not all(same_bits(x, y) for x, y in zip(a[1], b[1]))
                for a, b in zip(got, want)):
            raise AssertionError("the resumed run's sampler drew other batches than the "
                                 "uninterrupted run's")
        losses = lambda run: {r["step"]: r["loss"] for r in run["log"] if r["event"] == "train"}
        lr, lf = losses(resumed), losses(full)
        moved = [k for k, p in full["state"].params.items()
                 if not same_bits(p, resumed["state"].params[k])]
        if any(lr[s] != lf[s] for s in lr) or moved:
            raise AssertionError(f"resumed run: losses {lr} vs the uninterrupted {lf}; "
                                 f"parameters not bit for bit: {moved[:5]}")
        check_fit_log(full["log"], "3-epoch fit")
    finally:
        device_data.make_device_sampler = real_sampler

    # the host path: one more epoch from the resumed state, prefetched; the
    # prefetched batches against the synchronous stream's
    cfg = FitConfig(**{**FIT_CFG, "device_data": False, "prefetch": 2})
    pre = list(PrefetchPipeline(sets["train"], SB_TRAIN, CHUNK, depth=2, device=DEV)
               .epoch(epoch_seed=3, start_step=12))
    sync = list(_epoch_inputs(sets["train"], cfg, 3, 12, 0, DEV))
    flat = lambda x: [x[0], x[1], x[2], x[3], *x[4].values(), x[5]]
    steps = list(range(12, 16))
    if [g for g, _ in pre] != steps or [g for g, _ in sync] != steps or not all(
            same_bits(a, b) for (_, p), (_, s) in zip(pre, sync)
            for a, b in zip(flat(p), flat(s))):
        raise AssertionError("the prefetched batches differ from the synchronous stream's")
    host = fit_run(sets, root, "host", 1, device_data=False, prefetch=2,
                   state_of=lambda m, o, s: restore_checkpoint(
                       os.path.join(root, "resumed"), "run", 3, s, strict=True))
    if int(host["state"].step) != 16 or not all(np.isfinite(host["losses"])):
        raise AssertionError(f"host-path epoch: step {int(host['state'].step)}, losses "
                             f"{host['losses']}")
    # float32 (the JAX CLI's default dtype): one device-data epoch
    f32 = fit_run(sets, root, "float32", 1, dtype=torch.float32)
    if not all(np.isfinite(f32["losses"])):
        raise AssertionError(f"float32 fit: losses {f32['losses']}")
    ema.append(ema_render_check(f32, sets))

    # the loop's own cost, in turns, cuDNN as in the runs above: fit's steps
    # (8 epochs, no val and no checkpoint, a loss line every 2 steps; the
    # first 2 intervals dropped) against the bare step's pairs, and the
    # group-norm against the batch-norm bare step
    bare_group, run_step = bare_step_ms(sets, "group")
    timed = fit_run(sets, root, "timed", 8, val=False, save_root=None)
    bare_batch, _ = bare_step_ms(sets, "batch")
    bare_group2, _ = bare_step_ms(sets, "group")
    fit_ms = clean_ms_per_step(timed["log"], warm=2)
    prof = profile_frame(run_step, label="train_step_fit_group", out_dir=root)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved

    # test_approximate on the val set with the EMA, and the random LPIPS archive
    lp = os.path.join(root, "lpips_rand.npz")
    np.savez(lp, **lpips_random_state(0))
    ev = test_approximate(full["model"], full["state"], sets["val"], LossParams(),
                          lpips_weights=lp, render_chunk=CHUNK, use_ema=True, device=DEV)
    if set(ev) != {"psnr", "ssim", "loss", "count", "lpips_rand"} or ev["count"] != 4 or \
            not all(np.isfinite(ev[k]) for k in ("psnr", "ssim", "loss", "lpips_rand")):
        raise AssertionError(f"test_approximate: {ev}")

    fit_med = float(np.median(fit_ms))
    group_med = float(np.median(bare_group + bare_group2))
    res = dict(
        sets=dict(train=FIT_TRAIN, val=FIT_VAL, side=SIDE, generate_s=made_s),
        first=dict(losses=first["losses"], seconds=first["seconds"],
                   val=[{k: r[k] for k in ("step", "psnr", "ssim", "loss")}
                        for r in first["log"] if r["event"] == "val"]),
        checkpoint=dict(files=files, bytes=os.path.getsize(ckpt), save_s=save_s,
                        restore_s=restore_s),
        resume=dict(restored_step=step0, losses=lr, bitwise=True, sampler_draws_equal=True),
        prefetch=dict(batches=len(pre), bitwise=True),
        host=dict(losses=host["losses"], seconds=host["seconds"]),
        float32=dict(losses=f32["losses"], seconds=f32["seconds"],
                     ms_per_step=clean_ms_per_step(f32["log"], warm=0)),
        ema_render=ema, test_approximate=ev,
        fit_ms_per_step=fit_med, fit_step_ms=fit_ms,
        rays_per_s=SB_TRAIN * CHUNK / fit_med * 1e3,
        bare_ms_per_step=dict(group=group_med, batch=float(np.median(bare_batch))),
        bare_step_ms=dict(group=bare_group, batch=bare_batch, group_again=bare_group2),
        loop_ms_per_step=fit_med - group_med,
        device_busy_ms=prof["device_busy_ms"],
        device_busy_share_of_fit_step=prof["device_busy_ms"] / fit_med,
        seconds=time.perf_counter() - t0)
    shutil.rmtree(root, ignore_errors=True)
    return res, launches


def print_fit(res, launches):
    print(f"fit: {res['fit_ms_per_step']:.2f} ms a step ({res['rays_per_s']:.0f} rays/s; "
          f"steps {', '.join(f'{x:.2f}' for x in res['fit_step_ms'])}) against the bare "
          f"device-data step's {res['bare_ms_per_step']['group']:.2f} ms: the loop's own "
          f"{res['loop_ms_per_step']:.2f} ms a step; device busy {res['device_busy_ms']:.2f} ms a "
          f"step ({res['device_busy_share_of_fit_step']:.3f} of the fit step)")
    b = res["bare_step_ms"]
    fmt = lambda xs: ", ".join(f"{x:.2f}" for x in xs)
    print(f"fit: bare step (medians of pairs) group norm {res['bare_ms_per_step']['group']:.2f} "
          f"ms ({fmt(b['group'])}; again {fmt(b['group_again'])}), batch norm "
          f"{res['bare_ms_per_step']['batch']:.2f} ms ({fmt(b['batch'])})")
    print("fit val: " + "; ".join(f"step {v['step']} psnr {v['psnr']:.4f} ssim {v['ssim']:.4f} "
                                  f"loss {v['loss']:.5f}" for v in res["first"]["val"]))
    print(f"fit test_approximate (EMA, random LPIPS): {res['test_approximate']}")
    c = res["checkpoint"]
    print(f"fit checkpoint: {c['files']}, {c['bytes']} bytes, save {c['save_s']:.3f} s, "
          f"restore {c['restore_s']:.3f} s")
    print(f"fit resume: restored step {res['resume']['restored_step']}, losses "
          f"{res['resume']['losses']} bit for bit the uninterrupted run's, the sampler's draws "
          f"too; prefetch: {res['prefetch']['batches']} batches bit for bit the synchronous "
          f"stream's; host path losses {res['host']['losses']}; float32 losses "
          f"{res['float32']['losses']} ({res['float32']['ms_per_step']} ms a step)")
    print(f"fit EMA render: {res['ema_render']}")
    print(f"fit launches (train_fit): {launches}; phase {res['seconds']:.1f} s "
          f"(sets made in {res['sets']['generate_s']:.1f} s)")


# ---------------------------------------------------------------------------
# phase 7: the CLIs
# ---------------------------------------------------------------------------

# the kernels each dtype's train cases must launch, forward and backward:
# K1, K2 and K3 (by the counters of the dtype's own routes)
CLI_F32_KERNELS = ("gather_bilinear", "gather_bilinear_bwd", K2.NAME_F32, K2.NAME_DGRAD_F32,
                   K2.NAME_WGRAD_F32, K3.NAME_F32, K3.NAME_BWD_F32)
CLI_BF16_KERNELS = ("gather_bilinear", "gather_bilinear_bwd", K2.NAME_WGMMA, K2.NAME_STASH,
                    K2.NAME_DGRAD, K2.NAME_WGRAD, K3.NAME_TILES, K3.NAME_BWD_TILES)
# (case, kernels it must launch)
CLI_REQUIRED = {"default": CLI_F32_KERNELS, "bf16_recipe": CLI_BF16_KERNELS + (K7.NAME,
                                                                                K7.NAME_BITS),
                "proj": ("gather_bilinear_projected", "gather_bilinear_projected_bwd")}
CLI_BATCH, CLI_RAYS = "4", "1024"


def torchvision_npz(path, seed=0, backbone="resnet34"):
    """A torchvision ResNet state dict's layout (``np.savez``) of seeded
    numpy draws: the stem and the three stages the encoder's trunk keeps
    (``num_layers = 4``)."""
    from avr_tpu_torch.models.resnet import RESNET_STAGES

    rng = np.random.default_rng(seed)
    sd = {}

    def bn(name, c):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{name}.bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        sd[f"{name}.running_mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)

    def conv(name, o, i, k):
        sd[name] = (rng.standard_normal((o, i, k, k)) / np.sqrt(i * k * k)).astype(np.float32)

    conv("conv1.weight", 64, 3, 7)
    bn("bn1", 64)
    blocks, chans = RESNET_STAGES[backbone]
    c_in = 64
    for s in range(3):
        for b in range(blocks[s]):
            t = f"layer{s + 1}.{b}"
            conv(f"{t}.conv1.weight", chans[s], c_in, 3)
            bn(f"{t}.bn1", chans[s])
            conv(f"{t}.conv2.weight", chans[s], chans[s], 3)
            bn(f"{t}.bn2", chans[s])
            if b == 0 and s > 0:
                conv(f"{t}.downsample.0.weight", chans[s], c_in, 1)
                bn(f"{t}.downsample.1", chans[s])
            c_in = chans[s]
    np.savez(path, **sd)
    return sd


def cli_log(root, name):
    with open(os.path.join(root, "logs", f"{name}.jsonl")) as f:
        return [json.loads(line) for line in f]


def cli_ms_per_step(log):
    """ms a step between consecutive loss lines with no val or checkpoint
    between them (the log's own clock, ms resolution)."""
    out, prev = [], None
    for r in log:
        if r["event"] == "train":
            if prev is not None and prev[1]:
                out.append((r["t"] - prev[0]["t"]) * 1e3 / (r["step"] - prev[0]["step"]))
            prev = (r, True)
        elif prev is not None:
            prev = (prev[0], False)
    return out


def run_cli():
    """Phase 7: the port's CLIs at full ``conf/default_mv.conf`` width on
    in-memory synthetic sets (phase 6's), each case with the launch
    counters reset before and read after.  Returns the report and each
    case's launches."""
    import shutil
    import tempfile

    from avr_tpu_torch.cli import test as cli_test
    from avr_tpu_torch.cli import train as cli_train
    from avr_tpu_torch.cli import video as cli_video
    from avr_tpu_torch.profiling import analyze

    t0 = time.perf_counter()
    sets = dict(train=synthetic_scene_mapping(*FIT_TRAIN, side=SIDE, seed=0),
                val=synthetic_scene_mapping(*FIT_VAL, side=SIDE, seed=1))
    made_s = time.perf_counter() - t0
    root = tempfile.mkdtemp(prefix="cli_")
    launches, res = {}, dict(sets=dict(train=FIT_TRAIN, val=FIT_VAL, side=SIDE, generate_s=made_s))

    def case(name, fn):
        torch.cuda.synchronize()
        _build.reset_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = dict(_build.launches)
        res.setdefault(name, {})["seconds"] = time.perf_counter() - t
        missing = [k for k in CLI_REQUIRED.get(name, ()) if not launches[name].get(k)]
        if missing:
            raise AssertionError(f"cli {name}: no launch of {missing}: {launches[name]}")
        return out

    def train(name, run_name, *flags, start=0, epochs=2):
        run_root = os.path.join(root, run_name)
        argv = ["--root_dir", run_root, "--loss_mode", "both", "--renderer", run_name,
                "--starting_epoch", str(start), "--epochs", str(epochs), "--sl", str(SIDE),
                "--batch_size", CLI_BATCH, "--steps_print", "2", "--steps_val", "4", *flags]
        opt = cli_train.build_parser().parse_args(argv)
        # a resumed run appends to its first run's log: keep its own records
        seen = len(cli_log(run_root, run_name)) if start else 0
        state = case(name, lambda: cli_train.run(opt, device=DEV, train_source=sets["train"],
                                                 val_source=sets["val"]))
        log = cli_log(run_root, run_name)[seen:]
        losses = [r["loss"] for r in log if r["event"] == "train"]
        if not losses or not all(np.isfinite(losses)):
            raise AssertionError(f"cli {name}: losses {losses}")
        ms = cli_ms_per_step(log)
        res[name].update(step=int(state.step), losses=losses, ms_per_step=ms,
                         ms_per_step_median=float(np.median(ms)) if ms else None,
                         val=[{k: r[k] for k in ("step", "psnr", "ssim", "loss")}
                              for r in log if r["event"] == "val"],
                         checkpoints=sorted(os.listdir(os.path.join(
                             run_root, "checkpoints", "experiments"))))
        return state

    # 1. JAX's defaults: float32, per_ray, the host path (prefetch 2, the
    #    native gather), batch norm; traced by --profile_dir
    prof_dir = os.path.join(root, "prof")
    train("default", "AVR_cli", "--ray_batch_size", CLI_RAYS, "--profile_dir", prof_dir)
    # 2. the quality runs' recipe in bf16, then a resume from _epoch2
    recipe = ("--dtype", "bf16", "--device_data", "--rng_mode", "legacy", "--norm_type", "group",
              "--ema_decay", "0.999", "--lr_schedule", "cosine", "--ray_batch_size", "4096",
              "--schedule_total_epochs", "3")
    train("bf16_recipe", "AVR_bf16", *recipe)
    if res["bf16_recipe"]["checkpoints"] != ["AVR_bf16_best", "AVR_bf16_epoch2"]:
        raise AssertionError(f"cli bf16_recipe: checkpoints {res['bf16_recipe']['checkpoints']}")
    state = train("bf16_resume", "AVR_bf16", *recipe, start=2, epochs=1)
    spe = FIT_TRAIN[0] // int(CLI_BATCH)  # steps an epoch
    if int(state.step) != 3 * spe or "AVR_bf16_epoch3" not in res["bf16_resume"]["checkpoints"]:
        raise AssertionError(f"cli bf16_resume: step {int(state.step)}, "
                             f"{res['bf16_resume']['checkpoints']}")
    del state
    # 3. the adaptive renderer with K5's projected gather
    train("proj", "AVR_proj", "--gather_impl", "pallas_proj", "--ray_batch_size", CLI_RAYS,
          epochs=1)
    # 4. the volume renderer
    train("vr", "VR_cli", "--ray_batch_size", CLI_RAYS, epochs=1)
    # 5. an encoder warm start from a torchvision-layout archive: the trunk
    #    holds the archive's tensors when fit starts
    npz = os.path.join(root, "resnet34.npz")
    sd = torchvision_npz(npz)
    start = {}
    real_fit = cli_train.fit

    def fit_snapshot(model, st, *a, **kw):
        trunk = model.net.encoder.model
        start.update({k: v.detach().cpu().clone() for k, v in trunk.state_dict().items()})
        return real_fit(model, st, *a, **kw)

    cli_train.fit = fit_snapshot
    try:
        train("encoder_weights", "AVR_warm", "--encoder_weights", npz, "--dtype", "bf16",
              "--device_data", "--ray_batch_size", CLI_RAYS, epochs=1)
    finally:
        cli_train.fit = real_fit
    tv = {"conv1.weight": "conv1.weight", "bn1.scale": "bn1.weight", "bn1.mean":
          "bn1.running_mean", "bn1.var": "bn1.running_var"}
    for s, blocks in enumerate((3, 4, 6)):
        for b in range(blocks):
            for part in ("conv1", "conv2"):
                tv[f"stages.layer{s + 1}_block{b}.{part}.weight"] = f"layer{s + 1}.{b}.{part}.weight"
    off = [k for k, v in tv.items() if not np.array_equal(start[k].numpy(), sd[v])]
    if len(start) != 5 + 10 * 13 + 2 * 5 or off:
        raise AssertionError(f"cli encoder_weights: {len(start)} trunk tensors, not the "
                             f"archive's: {off[:5]}")
    res["encoder_weights"].update(trunk_tensors=len(start), equal_to_archive=True)

    # 6. cli.test on _best with the EMA and the random-VGG LPIPS archive
    lp = os.path.join(root, "lpips_rand.npz")
    np.savez(lp, **lpips_random_state(0))
    bf16_root = os.path.join(root, "AVR_bf16")
    common = ["--root_dir", bf16_root, "--renderer", "AVR_bf16", "--norm_type", "group",
              "--sl", str(SIDE), "--data", "<in memory>"]
    opt = cli_test.build_parser().parse_args(common + ["--epoch", "best", "--use_ema",
                                                       "--lpips_weights", lp])
    ev = case("test", lambda: cli_test.run(opt, device=DEV, data_source=sets["val"]))
    if set(ev) != {"psnr", "ssim", "loss", "count", "lpips_rand"} or ev["count"] != FIT_VAL[0] \
            or not all(np.isfinite(ev[k]) for k in ("psnr", "ssim", "loss", "lpips_rand")):
        raise AssertionError(f"cli test: {ev}")
    res["test"]["metrics"] = ev
    # 7. cli.video: 4 orbit frames of _epoch2
    out = os.path.join(root, "orbit.mp4")
    opt = cli_video.build_parser().parse_args(common + ["--epoch", "2", "--num_frames", "4",
                                                        "--out", out])
    frames = case("video", lambda: cli_video.run(opt, device=DEV, data_source=sets["val"]))
    written = [p for p in (out, os.path.splitext(out)[0] + ".npz") if os.path.exists(p)]
    if len(frames) != 4 or any(f.shape != (SIDE, SIDE, 3) or f.dtype != np.uint8
                               for f in frames) or len(written) != 1:
        raise AssertionError(f"cli video: {len(frames)} frames, written {written}")
    res["video"].update(path=os.path.basename(written[0]), frame_shape=list(frames[0].shape),
                        frame_dtype=str(frames[0].dtype),
                        frame_means=[float(f.mean()) for f in frames])
    # 8. the analyzer on run 1's trace
    t = time.perf_counter()
    rows = analyze.op_breakdown(prof_dir)
    busy = analyze.busy_share(prof_dir)
    if not rows or (DEV.type == "cuda" and busy["busy_us"] is None):
        raise AssertionError(f"cli analyze: no device lane in {prof_dir}: {busy}")
    res["analyze"] = dict(busy, trace_bytes=sum(os.path.getsize(os.path.join(prof_dir, f))
                                                for f in os.listdir(prof_dir)),
                          top=[dict(op=n[:100], ms=us / 1e3, count=c) for n, us, c in rows[:12]],
                          seconds=time.perf_counter() - t)
    res["seconds"] = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    return res, launches


def print_cli(res, launches):
    for name in ("default", "bf16_recipe", "bf16_resume", "proj", "vr", "encoder_weights"):
        r = res[name]
        ms = ", ".join(f"{x:.1f}" for x in r["ms_per_step"])
        med = r["ms_per_step_median"]
        print(f"cli {name}: {r['seconds']:.1f} s, step {r['step']}, "
              f"{'%.1f' % med if med is not None else '-'} ms a step between loss lines "
              f"({ms}); losses {[round(x, 5) for x in r['losses']]}; val "
              f"{[(v['step'], round(v['psnr'], 4), round(v['ssim'], 4)) for v in r['val']]}; "
              f"checkpoints {r['checkpoints']}")
    print(f"cli encoder_weights: {res['encoder_weights']['trunk_tensors']} trunk tensors equal "
          f"to the archive's when fit starts")
    print(f"cli test: {res['test']['seconds']:.1f} s, {res['test']['metrics']}")
    v = res["video"]
    print(f"cli video: {v['seconds']:.1f} s, {v['path']}, frames {v['frame_shape']} "
          f"{v['frame_dtype']}, means {[round(x, 2) for x in v['frame_means']]}")
    a = res["analyze"]
    busy = ("no device lane" if a["busy_us"] is None else
            f"device busy {a['busy_us'] / 1e3:.1f} ms ({a['share']:.4f})")
    print(f"cli analyze (run 1's trace, {a['trace_bytes']} bytes): window "
          f"{a['window_us'] / 1e3:.1f} ms, {busy}, {a['device_events']} device events; top: "
          + "; ".join(f"{t['op'][:48]} {t['ms']:.1f} ms x{t['count']}" for t in a["top"][:6]))
    print(f"cli launches: {launches}; phase {res['seconds']:.1f} s (sets made in "
          f"{res['sets']['generate_s']:.1f} s)")


# ---------------------------------------------------------------------------
# phase 8: the sharded train step over a mesh of ranks
# ---------------------------------------------------------------------------

PAR_STEPS = 2
PAR_IMPLS = ("shardmap", "gspmd")
# the two-rank cases: meshes of the two processes sharing the one card
PAR_MESHES = ((1, 2), (2, 1))
PAR_JOIN_S = 300
PAR_TURNS, PAR_TURN_STEPS = 4, 5


def par_required(dtype, rng_mode):
    """The kernels a sharded step must launch: K1, K2 and K3 forward and
    backward on the dtype's routes, K7 under ``legacy``."""
    base = CLI_BF16_KERNELS if dtype == torch.bfloat16 else CLI_F32_KERNELS
    return base + ((K7.NAME,) if rng_mode == "legacy" else ())


def par_digest(state):
    """The bits of a whole train state (parameters, BatchNorm statistics,
    Adam's count, moments and skip count, the EMA, the step)."""
    import hashlib

    from avr_tpu_torch.parallel.sharded_step import state_tensors

    h = hashlib.sha256()
    for t in state_tensors(state):
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def par_model(dtype, norm_type):
    """The full-width adaptive model on ``bench_weights`` (phase 3's) with
    ``norm_type``, and its Adam train state."""
    model = make_model(dtype=dtype, seed=0, device=DEV, norm_type=norm_type)
    bench_weights(model, 0)
    opt = make_optimizer(1e-4)
    return model, opt, create_train_state(model, opt)


def par_run(step, state, batch, keys, case=None, launches=None):
    """``len(keys)`` steps; each loss and the state's digest after each."""
    if launches is not None:
        torch.cuda.synchronize()
        _build.reset_launches()
    losses, digests = [], []
    for key in keys:
        state, m = step(state, *batch, key)
        losses.append(float(m["loss"]))
        digests.append(par_digest(state))
    if launches is not None:
        torch.cuda.synchronize()
        launches[case] = dict(_build.launches)
    return state, losses, digests


def par_one_rank(launches):
    """Case 1: a world of one NCCL rank, mesh (1, 1), both flavours, bf16 and
    float32, both ``rng_mode``s: every step's loss and whole state bit for
    bit ``make_train_step``'s (``shardmap``'s legacy key is ``fold_in(key,
    0)``, the rank's key, as in JAX)."""
    from avr_tpu_torch.parallel import (make_mesh, make_sharded_train_step,
                                        make_shardmap_train_step)

    mesh = make_mesh((1, 1))
    batch = train_batch(DEV)
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        for rng_mode in ("per_ray", "legacy"):
            for impl in PAR_IMPLS:
                name = f"one_rank_{impl}_{rng_mode}_{str(dtype)[6:]}"
                keys = [threefry.PRNGKey(i) for i in range(PAR_STEPS)]
                model, opt, state = par_model(dtype, "batch")
                maker = make_sharded_train_step if impl == "gspmd" else make_shardmap_train_step
                step = maker(model, opt, LossParams(), mesh, rng_mode=rng_mode)
                _, losses, digests = par_run(step, state, batch, keys, name, launches)
                del model, opt, state, step
                model, opt, state = par_model(dtype, "batch")
                plain_keys = ([threefry.fold_in(k, 0) for k in keys]
                              if impl == "shardmap" and rng_mode == "legacy" else keys)
                step = make_train_step(model, opt, LossParams(), rng_mode=rng_mode)
                _, p_losses, p_digests = par_run(step, state, batch, plain_keys)
                del model, opt, state, step
                if losses != p_losses or digests != p_digests:
                    raise AssertionError(f"parallel {name}: losses {losses} vs make_train_step "
                                         f"{p_losses}; states equal {[a == b for a, b in zip(digests, p_digests)]}")
                missing = [k for k in par_required(dtype, rng_mode) if not launches[name].get(k)]
                if missing:
                    raise AssertionError(f"parallel {name}: no launch of {missing}: "
                                         f"{launches[name]}")
                out.append(dict(case=name, losses=losses, bitwise=True))
    torch.cuda.empty_cache()
    return out


def par_timing(smi):
    """ms a step of the sharded step at (1, 1) and of ``make_train_step``,
    bf16 ``per_ray``, in turns (plain, sharded, sharded, plain, ...); and the
    gradient bucket's all-reduce alone (the NCCL world of one)."""
    import torch.distributed as dist

    from avr_tpu_torch.parallel import make_mesh, make_shardmap_train_step

    mesh = make_mesh((1, 1))
    batch = train_batch(DEV)
    runs = {}
    for label in ("plain", "sharded"):
        model, opt, state = par_model(torch.bfloat16, "batch")
        step = (make_train_step(model, opt, LossParams()) if label == "plain" else
                make_shardmap_train_step(model, opt, LossParams(), mesh))
        runs[label] = [step, state, model]
    ms = {"plain": [], "sharded": []}
    order = [("plain", "sharded"), ("sharded", "plain")] * (PAR_TURNS // 2)
    for i, (a, b) in enumerate([("plain", "sharded")] + order):
        for label in (a, b):
            step, state = runs[label][:2]
            torch.cuda.synchronize()
            t = time.perf_counter()
            for j in range(PAR_TURN_STEPS):
                state, m = step(state, *batch, threefry.PRNGKey(j))
            torch.cuda.synchronize()
            runs[label][1] = state
            if i:  # the first pair warms up
                ms[label].append((time.perf_counter() - t) * 1e3 / PAR_TURN_STEPS)
    n_bucket = 1 + sum(p.numel() for p in runs["sharded"][2].parameters()) + sum(
        b.numel() for b in runs["sharded"][2].buffers())
    flat = torch.zeros(n_bucket, dtype=torch.float32, device=DEV)
    for _ in range(3):
        dist.all_reduce(flat)
    ar = time_ms(lambda: dist.all_reduce(flat), iters=20)
    del runs, flat
    torch.cuda.empty_cache()
    return dict(card=smi, plain_ms=ms["plain"], sharded_ms=ms["sharded"],
                plain_median=float(np.median(ms["plain"])),
                sharded_median=float(np.median(ms["sharded"])),
                bucket_bytes=4 * n_bucket, allreduce_ms=ar, backend="nccl", world=1,
                steps_a_turn=PAR_TURN_STEPS, turns=PAR_TURNS)


def _par_rank(rank, store, out_dir, shapes, dtypes):
    """Case 2, one of two processes on the one card: a gloo world of two,
    each ``shape``'s ``shardmap`` step, ``per_ray``, group norm, on the
    rank's block of the global batch; its losses, state digests, launches
    and ms a step to ``out_dir``."""
    import torch.distributed as dist

    from avr_tpu_torch.parallel import make_mesh, make_shardmap_train_step, shard_train_inputs
    from avr_tpu_torch.parallel import multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    multihost.initialize(init_method=f"file://{store}", world_size=2, rank=rank, backend="gloo",
                         timeout_s=PAR_JOIN_S / 2)
    res, n_bucket = {}, 0
    try:
        for dtype in dtypes:
            for shape in shapes:
                name = f"two_ranks_{shape[0]}x{shape[1]}_{str(dtype)[6:]}"
                mesh = make_mesh(shape)
                model, opt, state = par_model(dtype, "group")
                n_bucket = 1 + sum(t.numel() for t in (*model.parameters(), *model.buffers()))
                step = make_shardmap_train_step(model, opt, LossParams(), mesh)
                local = shard_train_inputs(mesh, *train_batch(DEV))
                launches, ms = {}, []
                keys = [threefry.PRNGKey(i) for i in range(PAR_STEPS)]
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, losses, digests = par_run(step, state, local, keys, name, launches)
                ms.append((time.perf_counter() - t) * 1e3 / PAR_STEPS)
                # two steps more, timed (information: two ranks share one card)
                dist.barrier()
                t = time.perf_counter()
                for i in range(2):
                    state, _ = step(state, *local, threefry.PRNGKey(10 + i))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3 / 2)
                res[name] = dict(losses=losses, digests=digests, launches=launches[name],
                                 ms=ms, block=[list(t.shape) for t in (local[0], local[5])])
                del model, opt, state, step, local
                torch.cuda.empty_cache()
        # gloo's all-reduce and broadcast took CUDA tensors above (the bucket,
        # the state); its all_gather takes them too (multihost's host-bound
        # collectives gather on the host under gloo all the same)
        t = torch.full((4,), float(rank), device=DEV)
        parts = [torch.empty_like(t) for _ in range(2)]
        dist.all_gather(parts, t)
        if [float(p[0]) for p in parts] != [0.0, 1.0]:
            raise AssertionError(f"gloo all_gather of CUDA tensors: {parts}")
        res["gloo_all_gather_cuda"] = "accepted"
        flat = torch.zeros(n_bucket, device=DEV)  # the group-norm model's loss and gradients
        dist.barrier()
        res["gloo_allreduce_ms"] = time_ms(lambda: dist.all_reduce(flat), iters=5, warmup=1)
        res["gloo_bucket_bytes"] = flat.numel() * 4
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"par_rank{rank}.json"), "w") as f:
        json.dump(res, f)


def par_two_ranks(launches, shapes=PAR_MESHES, dtypes=(torch.float32, torch.bfloat16)):
    """Case 2: two processes on the one card (gloo: NCCL refuses two ranks
    on one device), meshes (1, 2) and (2, 1), ``shardmap``, ``per_ray``,
    group norm: the ranks' losses and whole states equal after each step,
    float32 losses within 1e-5 relative of the one-rank step's on the same
    global batch (bf16 reported), each rank's kernels launched."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="par_")
    ctx = mp.start_processes(_par_rank, args=(os.path.join(tmp, "store"), tmp, shapes, dtypes),
                             nprocs=2, join=False, start_method="spawn")
    # the one-rank reference while the ranks start: make_train_step on the
    # global batch
    ref = {}
    for dtype in dtypes:
        model, opt, state = par_model(dtype, "group")
        _, ref[str(dtype)[6:]], _ = par_run(make_train_step(model, opt, LossParams()), state,
                                            train_batch(DEV),
                                            [threefry.PRNGKey(i) for i in range(PAR_STEPS)])
        del model, opt, state
    torch.cuda.empty_cache()
    deadline = time.monotonic() + PAR_JOIN_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise AssertionError(f"parallel: two ranks still running after {PAR_JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"par_rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    out = dict(cases=[], gloo_all_gather_cuda=ranks[0]["gloo_all_gather_cuda"],
               gloo_allreduce_ms=ranks[0]["gloo_allreduce_ms"],
               gloo_bucket_bytes=ranks[0]["gloo_bucket_bytes"], reference_losses=ref)
    for name in (k for k in ranks[0] if k.startswith("two_ranks_")):
        a, b = ranks[0][name], ranks[1][name]
        if a["losses"] != b["losses"] or a["digests"] != b["digests"]:
            raise AssertionError(f"parallel {name}: the ranks differ: losses {a['losses']} vs "
                                 f"{b['losses']}, states equal "
                                 f"{[x == y for x, y in zip(a['digests'], b['digests'])]}")
        dt = name.rsplit("_", 1)[1]
        rel = [abs(x - y) / abs(y) for x, y in zip(a["losses"], ref[dt])]
        if dt == "float32" and max(rel) > 1e-5:
            raise AssertionError(f"parallel {name}: losses {a['losses']} vs the one-rank "
                                 f"step's {ref[dt]}: relative {rel}")
        dtype = torch.float32 if dt == "float32" else torch.bfloat16
        for r, rk in enumerate((a, b)):
            missing = [k for k in par_required(dtype, "per_ray") if not rk["launches"].get(k)]
            if missing:
                raise AssertionError(f"parallel {name} rank {r}: no launch of {missing}")
            launches[f"{name}_rank{r}"] = rk["launches"]
        out["cases"].append(dict(case=name, losses=a["losses"], one_rank_losses=ref[dt],
                                 rel_to_one_rank=rel, held=dt == "float32",
                                 ms_a_step=[a["ms"], b["ms"]], block=a["block"],
                                 ranks_bitwise=True))
    return out


def par_cli(sets, launches):
    """Case 3: ``cli.train --mesh 1,1`` with each ``--step_impl``, one epoch
    of 4 steps (JAX's defaults: float32, the host path) on phase 6's sets
    in the NCCL world of one: JAX's checkpoint names and log keys."""
    import shutil
    import tempfile

    from avr_tpu_torch.cli import train as cli_train

    root = tempfile.mkdtemp(prefix="par_cli_")
    out = {}
    for impl in PAR_IMPLS:
        name = f"cli_{impl}"
        run_root = os.path.join(root, name)
        argv = ["--root_dir", run_root, "--loss_mode", "both", "--renderer", "AVR_mesh",
                "--starting_epoch", "0", "--epochs", "1", "--sl", str(SIDE), "--batch_size",
                CLI_BATCH, "--ray_batch_size", CLI_RAYS, "--steps_print", "2", "--steps_val",
                "4", "--mesh", "1,1", "--step_impl", impl]
        torch.cuda.synchronize()
        _build.reset_launches()
        t = time.perf_counter()
        state = cli_train.run(cli_train.build_parser().parse_args(argv), device=DEV,
                              train_source=sets["train"], val_source=sets["val"])
        torch.cuda.synchronize()
        launches[name] = dict(_build.launches)
        log = cli_log(run_root, "AVR_mesh")
        ckpts = sorted(os.listdir(os.path.join(run_root, "checkpoints", "experiments")))
        losses = [r["loss"] for r in log if r["event"] == "train"]
        bad = [r for r in log if set(r) not in FIT_LOG_KEYS[r["event"]]]
        missing = [k for k in CLI_F32_KERNELS if not launches[name].get(k)]
        if (int(state.step) != FIT_TRAIN[0] // int(CLI_BATCH) or bad or missing
                or ckpts != ["AVR_mesh_best", "AVR_mesh_epoch1"]
                or not losses or not all(np.isfinite(losses))):
            raise AssertionError(f"parallel {name}: step {int(state.step)}, checkpoints {ckpts}, "
                                 f"losses {losses}, records off JAX's keys {bad[:2]}, "
                                 f"no launch of {missing}")
        out[name] = dict(seconds=time.perf_counter() - t, step=int(state.step), losses=losses,
                         checkpoints=ckpts, ms_per_step=cli_ms_per_step(log))
        del state
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def run_parallel(smi):
    """Phase 8: the sharded train step (``avr_tpu_torch/parallel``) at full
    ``conf/default_mv.conf`` width, each case's launch counters reset
    before and read after.  Returns the report and each case's launches."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    launches = {}
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    # cuDNN's deterministic algorithms: the sharded step is held to
    # make_train_step bit for bit (the port's kernels have no float atomics)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        res = dict(card=smi, one_rank=par_one_rank(launches))
        res["timing"] = par_timing(smi)
        sets = dict(train=synthetic_scene_mapping(*FIT_TRAIN, side=SIDE, seed=0),
                    val=synthetic_scene_mapping(*FIT_VAL, side=SIDE, seed=1))
        res["cli"] = par_cli(sets, launches)
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    res["two_ranks"] = par_two_ranks(launches)
    res["seconds"] = time.perf_counter() - t0
    return res, launches


def print_parallel(res, launches):
    smi = res["card"]
    one = res["one_rank"]
    print(f"parallel one rank (NCCL world of one, mesh (1, 1)): {len(one)} cases, every step's "
          f"loss and whole state bit for bit make_train_step's: "
          + "; ".join(f"{c['case']} {[round(x, 6) for x in c['losses']]}" for c in one))
    t = res["timing"]
    print(f"parallel timing ({smi}): sharded step at (1, 1) {t['sharded_median']:.2f} ms a step "
          f"({', '.join(f'{x:.2f}' for x in t['sharded_ms'])}) against make_train_step "
          f"{t['plain_median']:.2f} ms ({', '.join(f'{x:.2f}' for x in t['plain_ms'])}), bf16 "
          f"adaptive SB 4 x 4,096, in turns; the bucket {t['bucket_bytes']} bytes, its NCCL "
          f"all-reduce over one rank {t['allreduce_ms']:.4f} ms")
    two = res["two_ranks"]
    for c in two["cases"]:
        print(f"parallel {c['case']} (gloo, two processes on one card; {smi}): losses "
              f"{c['losses']} on both ranks, states bitwise equal; one-rank step's "
              f"{c['one_rank_losses']}, relative {[f'{x:.2e}' for x in c['rel_to_one_rank']]}"
              f" ({'held to 1e-5' if c['held'] else 'reported'}); blocks {c['block']}; ms a step "
              f"by rank [first 2, next 2] {[[round(x, 1) for x in r] for r in c['ms_a_step']]}")
    print(f"parallel gloo ({smi}): all_gather of CUDA tensors {two['gloo_all_gather_cuda']}; "
          f"all-reduce of the {two['gloo_bucket_bytes']}-byte float32 bucket on the card "
          f"{two['gloo_allreduce_ms']:.2f} ms between two processes on one card")
    for name, c in res["cli"].items():
        print(f"parallel {name}: {c['seconds']:.1f} s, step {c['step']}, losses "
              f"{[round(x, 5) for x in c['losses']]}, checkpoints {c['checkpoints']}")
    print(f"parallel launches: {launches}; phase {res['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# phase 9: the model options
# ---------------------------------------------------------------------------

# K2's counters (its float32 wgrad's counter is shared with K3's: left out)
K2_NAMES = (K2.NAME, K2.NAME_STASH, K2.NAME_WGMMA, K2.NAME_DGRAD, K2.NAME_WGRAD,
            K2.NAME_RECOMPUTE, K2.NAME_F32, K2.NAME_DGRAD_F32, *K2.NAME_WIDE.values(),
            *K2.NAME_DGRAD_WIDE.values(), K2.NAME_WIDE_TMA, K2.NAME_DGRAD_WIDE_TMA)
# each option group of the model conf's ``model`` subtree (added to
# conf/default_mv.conf at full width): (model block, make_model keywords,
# JAX fuses the decoders); the adaptive renderer unless the keywords say
OPTION_CASES = {
    "bn": ("", dict(bn=True), False),
    "spade_beta_max": ("mlp_coarse { use_spade = True\n beta = 1.0\n combine_type = max }\n"
                       "mlp_fine { use_spade = True\n beta = 1.0\n combine_type = max }", {},
                       False),
    "type_mlp": ("mlp_coarse { type = mlp\n n_blocks = 8\n d_hidden = 256 }\n"
                 "mlp_fine { type = mlp\n n_blocks = 8\n d_hidden = 256 }", {}, False),
    "global_coarse_only": ("use_global_encoder = True\n"
                           "global_encoder { backbone = resnet34\n latent_size = 128 }\n"
                           "mlp_fine { type = empty }", {}, True),
    "custom_encoder": ("encoder { backbone = custom }", {}, True),
    "feature_scale": ("encoder { feature_scale = 0.5 }", {}, True),
    "xyz_off_viewdirs_coded": ("use_xyz = False\nuse_code_viewdirs = True", {}, True),
    "code_off": ("use_code = False", {}, True),
    "normalize_z_off_viewdirs_off": ("normalize_z = False\nuse_viewdirs = False", {}, True),
    "no_encoder_vr": ("use_encoder = False\nuse_global_encoder = True", dict(renderer="VR"),
                      True),
}
OPTION_POINTS = 4096  # the float32 field query held against the CPU
OPTION_TOL = 1e-3  # of max(1, |CPU output|): float32, cuDNN's and the K2 kernels' sums


def conf_model(block, dtype, dev, **kw):
    """``make_model`` from conf/default_mv.conf with ``block`` added to its
    ``model`` subtree (a conf string JAX's reader takes too), on
    ``bench_weights``."""
    from avr_tpu_torch.config import parse_conf_string

    conf = parse_conf_string(f'include required("default_mv.conf")\nmodel {{\n{block}\n}}\n',
                             base_dir=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                   "conf"))
    model = make_model(conf, dtype=dtype, seed=0, device=dev, **kw)
    bench_weights(model, 0)
    return model


def option_model(case, dtype, dev):
    block, kw, _ = OPTION_CASES[case]
    return conf_model(block, dtype, dev, **kw)


def option_field_check(case):
    """The float32 field (encode one 128x128 view, query OPTION_POINTS points,
    coarse and fine) on the card against the same weights on the CPU."""
    cpu = option_model(case, torch.float32, "cpu")
    gpu = option_model(case, torch.float32, DEV)
    rng = np.random.default_rng(9)
    batch = scene_batch(3)
    xyz = torch.from_numpy(rng.normal(scale=0.3, size=(1, OPTION_POINTS, 3)).astype(np.float32))
    vd = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(1, OPTION_POINTS, 3)).astype(np.float32)), dim=-1)
    errs = {}
    with torch.inference_mode():
        want_c = encode_scene(cpu, batch, "cpu")
        got_c = encode_scene(gpu, batch, DEV)
        for coarse in (True, False):
            want = cpu.net(want_c, xyz, vd, coarse)
            got = gpu.net(got_c, xyz.to(DEV), vd.to(DEV), coarse).cpu()
            errs["coarse" if coarse else "fine"] = float((got - want).abs().max()) / max(
                1.0, float(want.abs().max()))
    worst = max(errs.values())
    if not worst <= OPTION_TOL:
        raise AssertionError(f"options {case}: float32 field on the card against the CPU "
                             f"{errs} > {OPTION_TOL}")
    return errs


# the field through the kernels against the same field through their plain
# versions on the card.  The bf16 query: at least K2's bf16 forward tolerance
# (check_resnetfc: 2 bf16 ulps of max(1, |plain|), set for random weights
# whose trunk is of the output's scale); bench_weights' trunk may be larger
# than the output, and an activation rounded one bf16 ulp apart moves the
# output by the trunk's ulp, so the tolerance is also twice the plain
# version's own distance from the float32 field on the same bf16-valued
# weights and latents (two roundings of one function, each that far from
# it, are at most twice that apart), and the kernel is held to that field
# too.  The backward against the plain autograd by relative L2
# (check_resnetfc_bwd: bf16 8e-2, ReLU masks flipping between two correct
# roundings), and K1 on the case's map (check_gather_bwd: dfeat 2 bf16 ulps,
# dcoords 1e-4 of the largest value)
OPTION_FWD_REL = 2.0 ** -7
OPTION_BWD_L2 = 8e-2


def option_kernel_check(case):
    """Phase 9's kernels against their plain versions on the card, same
    weights and inputs: the bf16 field query (coarse, and fine where the
    case has a fine decoder), the gradients of a loss of it (the decoder's
    parameters and the latents), and K1 forward and backward on the case's
    own latent map."""
    rng = np.random.default_rng(11)
    xyz = torch.from_numpy(rng.normal(scale=0.3, size=(1, OPTION_POINTS, 3)).astype(np.float32))
    vd = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(1, OPTION_POINTS, 3)).astype(np.float32)), dim=-1)
    g = torch.from_numpy(rng.normal(size=(1, OPTION_POINTS, 4)).astype(np.float32) + 0.5)
    xyz, vd, g = xyz.to(DEV), vd.to(DEV), g.to(DEV)
    counted = dict(_build.launches)
    cases = []
    model = option_model(case, torch.bfloat16, DEV)
    # the float32 field on the bf16 model's weights rounded to bf16, fed the
    # bf16 latents: what both bf16 roundings of the query approximate
    exact = option_model(case, torch.float32, DEV)
    with torch.no_grad():
        cond = encode_scene(model, scene_batch(3), DEV)
        for k, p in exact.net.named_parameters():
            if k.startswith("mlp_"):
                p.copy_(p.bfloat16().float())
    cond32 = dataclasses.replace(cond, **{k: getattr(cond, k).float() for k in
                                          ("latent", "global_latent")
                                          if getattr(cond, k) is not None})
    heads = (True,) if model.net.mlp_fine is None else (True, False)
    for coarse in heads:
        label = f"options {case} {'coarse' if coarse else 'fine'}"
        net = model.net
        with torch.no_grad():
            got = net(cond, xyz, vd, coarse)
            with plain_kernels():
                want = net(cond, xyz, vd, coarse)
                ref = exact.net(cond32, xyz, vd, coarse)
        plain_err, kernel_err = max_err(want, ref), max_err(got, ref)
        tol = max(OPTION_FWD_REL * max(1.0, float(want.abs().max())), 2 * plain_err)
        if not (max_err(got, want) <= tol and kernel_err <= tol):
            raise AssertionError(f"{label} bf16 field: kernels against plain versions "
                                 f"{max_err(got, want)}, kernels against the float32 field "
                                 f"{kernel_err}, plain against it {plain_err}; tolerance {tol}")
        cases.append(dict(check(f"{label} bf16 field", max_err(got, want), tol),
                          plain_vs_float32=plain_err, kernel_vs_float32=kernel_err))
        cases.append(check(f"{label} bf16 field vs float32 (bf16 weights)", kernel_err, tol,
                           against="float32"))

        def grads(plain):
            leaves = {k: getattr(cond, k).detach().clone().requires_grad_()
                      for k in ("latent", "global_latent") if getattr(cond, k) is not None}
            c = dataclasses.replace(cond, **leaves)
            mlp = net.mlp_coarse if coarse else net.mlp_fine
            named = {**dict(mlp.named_parameters()), **leaves}
            with plain_kernels() if plain else contextlib.nullcontext():
                out = net(c, xyz, vd, coarse)
                gr = torch.autograd.grad((out * g).sum(), list(named.values()),
                                         allow_unused=True)
            return {k: v for k, v in zip(named, gr) if v is not None}

        got, want = grads(False), grads(True)
        if set(got) != set(want):
            raise AssertionError(f"{label}: gradients {sorted(got)} against {sorted(want)}")
        cases += [check_l2(f"{label} bf16 d{k}", got[k], want[k], OPTION_BWD_L2) for k in want]
    del exact
    if cond.latent is not None:
        feat = cond.latent.detach().clone()
        gen = torch.Generator(DEV).manual_seed(11)
        coords = (torch.rand(1, OPTION_POINTS, 2, generator=gen, device=DEV) * 2.2
                  - 1.1).contiguous()
        gl = randn(gen, 1, OPTION_POINTS, feat.shape[-1], dtype=feat.dtype)
        got, want = gather_bilinear(feat, coords), gather_bilinear_plain(feat, coords)
        shape = "x".join(map(str, feat.shape))
        cases.append(check(f"options {case} K1 forward {shape}", max_err(got, want),
                           2.0 ** -7 * max(1.0, float(want.float().abs().max()))))
        got = grads_of(gather_bilinear, (feat, coords), gl)
        want = grads_of(gather_bilinear_plain, (feat, coords), gl)
        cases.append(check_rel(f"options {case} K1 dfeat {shape}", got[0], want[0], 2.0 ** -7))
        cases.append(check_rel(f"options {case} K1 dcoords {shape}", got[1], want[1], 1e-4))
    _build.launches.clear()  # the comparisons' launches are not counted
    _build.launches.update(counted)
    return cases


def run_options():
    """Phase 9: each option group (OPTION_CASES) at full width, the launch
    counters reset before and read after its cases: one bf16 train step (SB
    4 x 4,096 rays) and one served 128x128 bf16 frame; the float32 field
    held to its CPU run.  K2 launches where JAX fuses and never where JAX
    runs XLA; K1 on the custom encoder's 128x128x128 map.  Returns the
    report and each case's launches."""
    t0 = time.perf_counter()
    launches, res = {}, {}
    batch, tb = scene_batch(), train_batch(DEV)
    intr = torch.as_tensor(batch["intrinsics"][:, 0])
    c2w = orbit_cam2world(1, 1.3)[:1]
    for case, (_, kw, fused) in OPTION_CASES.items():
        r = res[case] = dict(fused=fused, field_f32_err=option_field_check(case))
        r["vs_plain"] = option_kernel_check(case)
        counts = {}

        def step_once(dtype):
            model = option_model(case, dtype, DEV)
            opt = make_optimizer(1e-4)
            state = create_train_state(model, opt)
            step = make_train_step(model, opt, LossParams(loss_mode="both"))
            torch.cuda.synchronize()
            _build.reset_launches()
            t = time.perf_counter()
            state, m = step(state, *tb, (0, 1))
            loss = float(m["loss"])
            ms = (time.perf_counter() - t) * 1e3
            counts.update({f"train_{k}": v for k, v in _build.launches.items()})
            params = [p for p in state.params.values()]
            if not np.isfinite(loss) or not all(torch.isfinite(p).all() for p in params):
                raise AssertionError(f"options {case}: {dtype} step loss {loss}, parameters "
                                     f"finite: {all(torch.isfinite(p).all() for p in params)}")
            res = dict(dtype=str(dtype).split(".")[-1], loss=loss, ms=ms,
                       skipped=int(m["notfinite"]))
            if res["skipped"]:
                # phase 4's protocol: the plain versions on the same weights,
                # batch and key must skip too, or the first non-finite value
                # must appear outside a kernel; else a kernel made it (raises)
                res["skip"] = diagnose_skip(model, state.params, LossParams(loss_mode="both"),
                                            tb, (0, 1), loss, f"options {case} {dtype}")
            return res

        r["train"] = step_once(torch.bfloat16)
        model = option_model(case, torch.bfloat16, DEV)
        with torch.inference_mode():
            cond = encode_scene(model, batch, DEV)
            render_full_image(model, cond, intr, c2w, SIDE, threefry.PRNGKey(0), CHUNK, DEV)
            torch.cuda.synchronize()
            _build.reset_launches()
            t = time.perf_counter()
            out = render_full_image(model, cond, intr, c2w, SIDE, threefry.PRNGKey(1), CHUNK,
                                    DEV)
            torch.cuda.synchronize()
            r["frame_ms"] = (time.perf_counter() - t) * 1e3
        counts.update({f"serve_{k}": v for k, v in _build.launches.items()})
        rgb = (out.rgb_coarse if out.rgb_fine is None else out.rgb_fine).float()
        # [0, 1] to 1e-6: the white background adds 1 - acc, and acc's float32
        # sum reaches 1 + 2.4e-7
        if not torch.isfinite(rgb).all() or rgb.min() < -1e-6 or rgb.max() > 1 + 1e-6:
            bad = {k: (int((~torch.isfinite(v)).sum()), float(v.float().nan_to_num().min()),
                       float(v.float().nan_to_num().max()))
                   for k, v in out._asdict().items() if v is not None}
            raise AssertionError(f"options {case}: served rgb not finite in [0, 1]: "
                                 f"(non-finite, min, max) {bad}")
        r["rgb_mean"] = float(rgb.mean())
        if cond.latent is not None:
            r["latent_shape"] = list(cond.latent.shape)
        launches[case] = counts
        k2 = {k: v for k, v in counts.items() if k.split("_", 1)[1] in K2_NAMES}
        if fused != bool(k2) or (fused and not (counts.get(f"train_{K2.NAME_DGRAD}")
                                                or counts.get(f"train_{K2.NAME_DGRAD_F32}")
                                                or counts.get(f"train_{K2.NAME_RECOMPUTE}"))):
            raise AssertionError(f"options {case}: JAX {'fuses' if fused else 'runs XLA'}, K2 "
                                 f"launches {k2}")
        # the global latent's 640 lanes (d_hidden 512): the bf16 dgrad on the
        # wide TMA cluster kernel, every one of them
        if case == "global_coarse_only" and (
                not counts.get(f"train_{K2.NAME_DGRAD_WIDE_TMA}")
                or counts.get(f"train_{K2.NAME_DGRAD_WIDE_TMA}")
                != counts.get(f"train_{K2.NAME_DGRAD_WIDE[torch.bfloat16]}")):
            raise AssertionError(f"options global_coarse_only: dgrad launches {k2}")
        # ... and every forward (served, and the step's stash forward) on the
        # wgmma forward, the latent's 640 lanes in one piece (A and the park
        # tiles)
        if case == "global_coarse_only" and any(
                not counts.get(f"{p}_{K2.NAME_WGMMA}") or counts.get(f"{p}_{K2.NAME_WGMMA}")
                != counts.get(f"{p}_{K2.NAME}", 0) + counts.get(f"{p}_{K2.NAME_STASH}", 0)
                for p in ("serve", "train")):
            raise AssertionError(f"options global_coarse_only: forward launches {k2}")
        if case == "custom_encoder" and (r["latent_shape"] != [1, SIDE, SIDE, 128]
                                         or not counts.get("serve_gather_bilinear")
                                         or not counts.get("train_gather_bilinear_bwd")):
            raise AssertionError(f"options custom_encoder: latent {r['latent_shape']}, "
                                 f"launches {counts}")
        r["k2_routes"] = {k: v for k, v in k2.items()}
        del model, cond, out
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    return res, launches


def print_options(res, launches, smi):
    for case in OPTION_CASES:
        r = res[case]
        skip = r["train"].get("skip", {})
        skipped = (f", update skipped (the plain versions: {skip['plain_nonfinite']} non-finite "
                   f"gradients {skip['plain_nonfinite_grads'][:4]}"
                   + (f", first at {skip['first_nonfinite_node']['node']}"
                      if "first_nonfinite_node" in skip else "") + ")"
                   if r["train"]["skipped"] else "")
        print(f"options {case} ({smi}): JAX {'fuses' if r['fused'] else 'runs XLA'}; train "
              f"{r['train']['dtype']} loss {r['train']['loss']:.5f} in {r['train']['ms']:.1f} ms"
              f"{skipped}; frame {r['frame_ms']:.1f} ms, rgb mean {r['rgb_mean']:.4f}; float32 "
              f"field against the CPU {r['field_f32_err']}; K2 {r['k2_routes']}")
        worst = {}
        for c in r["vs_plain"]:
            kind = ("K1" if " K1 " in c["case"] else "field" if c["case"].endswith(" field")
                    else "field_vs_float32" if c["against"] == "float32" else "grads")
            err = c.get("rel_l2", c["max_abs_err"])
            worst[kind] = max(worst.get(kind, (0.0, "")), (err, c["case"]))
        print(f"options {case} kernels against the plain versions on the card: "
              f"{len(r['vs_plain'])} cases within tolerance (backward in bf16); worst "
              f"(field max abs, against the float32 field "
              f"on bf16 weights, gradient relative L2, K1 max abs) {worst}; plain against the "
              f"float32 field {[c['plain_vs_float32'] for c in r['vs_plain'] if 'plain_vs_float32' in c]}")
    print(f"options launches: {launches}; phase {res['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# phase 10: the quality script
# ---------------------------------------------------------------------------

# a few steps of both arms at 64x64 (8 instances, 2 epochs of 2 steps a
# call), cut at epoch 2 and resumed to 4 in a second call
QUALITY_ARGS = ["--steps", "8", "--side", "64", "--instances", "8", "--train_views", "4",
                "--ray_batch_size", "1024", "--device_data", "--steps_val", "4",
                "--renderers", "AVR_smoke,VR_smoke", "--depth_consistency", "0.5",
                "--eps_scales", "1.5"]
QUALITY_REQUIRED = ("gather_bilinear", "gather_bilinear_bwd", K2.NAME_WGMMA, K2.NAME_DGRAD,
                    K3.NAME_TILES, K3.NAME_BWD_TILES, K7.NAME)


def run_quality():
    """Phase 10: ``python -m avr_tpu_torch.scripts.quality_ab`` for a few steps
    of an adaptive and a VR arm, stopped at epoch 2 and resumed to 4, each
    call's launch counters reset before and read after."""
    import shutil
    import tempfile

    from avr_tpu_torch.scripts import quality_ab

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="quality_")
    launches, res = {}, {}
    for stop in (2, 4):
        torch.cuda.synchronize()
        _build.reset_launches()
        t = time.perf_counter()
        summary = quality_ab.main(["--workdir", root, *QUALITY_ARGS, "--stop_epoch", str(stop)],
                                  device=DEV)
        torch.cuda.synchronize()
        launches[f"stop{stop}"] = dict(_build.launches)
        missing = [k for k in QUALITY_REQUIRED if not launches[f"stop{stop}"].get(k)]
        for arm, e in summary.items():
            vals = [e[k]["psnr"] for k in ("final_raw", "final_ema", "best_raw", "best_ema")]
            if (e["steps"] != stop * 2 or e["resumed_from_epoch"] != stop - 2
                    or not all(np.isfinite(vals))):
                raise AssertionError(f"quality stop {stop} {arm}: {e}")
        if missing:
            raise AssertionError(f"quality stop {stop}: no launch of {missing}")
        res[f"stop{stop}"] = dict(seconds=time.perf_counter() - t, summary=summary)
    shutil.rmtree(root, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t0
    return res, launches


def print_quality(res, launches, smi):
    for stop in (2, 4):
        r = res[f"stop{stop}"]
        arms = "; ".join(f"{a} step {e['steps']} (from epoch {e['resumed_from_epoch']}), "
                         f"{e['ms_per_step']:.1f} ms a step, {e['skipped_updates']} skipped "
                         f"updates, final EMA PSNR "
                         f"{e['final_ema']['psnr']:.3f}" for a, e in r["summary"].items())
        print(f"quality --stop_epoch {stop} ({smi}): {r['seconds']:.1f} s; {arms}")
    print(f"quality launches: {launches}; phase {res['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# phase 11: K2 at JAX's widths (csrc/resnetfc_wide.cu)
# ---------------------------------------------------------------------------

# d_hidden 1,024, and the latent of a 5-stage spatial encoder (64 + 64 + 128
# + 256 + 512 = 1,024 lanes) beside the global encoder's 128
WIDE_DH, WIDE_DL = 1024, 1152
# the wide forward's and dgrad's cases (d_hidden, d_latent, code, views):
# the slice's decoder, 576 encoded lanes at two views (WIDE_CODE: 8
# frequencies of 32 coded lanes; 85 frequencies of 3 lanes would reach the
# same width, but their top frequency, 1.5 * 2^84, makes dx overflow
# float32), d_hidden 640 with a
# latent of 612 lanes (zero-padded to 640: a global latent_size of 100), and
# bf16 d_hidden 512 with the global encoder's 640 lanes (the wgmma forward's
# pieces, then the TMA cluster dgrad: past the bf16 tail's 512).  N is off
# every tile (32 and 16 points, a cluster's 64 and 32).
WIDE_CASES = ((WIDE_DH, WIDE_DL, CODE, 1), (WIDE_DH, WIDE_DL, WIDE_CODE, 2),
              (640, 612, CODE, 2), (512, 640, CODE, 1))
WIDE_N = CHUNK + 37
# float32 (no TF32) against cuBLAS in float32 over 13 chained products of
# up to 1,152 terms: 1e-3 of max(1, |output|) forward, and by relative L2
# against the matched reference (the same masks and rounding points) for
# the gradients
WIDE_F32_TOL = 1e-3
# the model conf's model block of the full-width slice: conf/default_mv.conf
# with both decoders at d_hidden 1,024, the spatial encoder at 5 stages and
# the global encoder (its 128 lanes after the spatial 1,024)
WIDE_CONF = ("mlp_coarse { d_hidden = 1024 }\nmlp_fine { d_hidden = 1024 }\n"
             "encoder { num_layers = 5 }\nuse_global_encoder = True\n"
             "global_encoder { backbone = resnet34\n latent_size = 128 }")


def wide_flops(n, ns, dh, dl, d_enc, nb=5, nlz=3):
    """The decoder's products a call of ``n`` points, forward (the dgrad's
    products are the same shapes transposed)."""
    return 2 * n * (ns * (d_enc * dh + nlz * dl * dh + 2 * nlz * dh * dh)
                    + 2 * (nb - nlz) * dh * dh + dh * 4)


def product_chain(gen, n, dh, dl, k_in, cd, backward, nb=5, nlz=3, ns=1):
    """The cuBLAS chain of the same products in the compute dtype (TF32
    off): the forward's (per view lin_in, the injections and their blocks,
    then the pooled blocks, lin_out) or the dgrad's (the blocks, the
    injections' latent cotangents, lin_in's input cotangent), one
    ``torch.matmul`` each; the library yardstick."""
    a = {k: randn(gen, n, k, dtype=cd) for k in {dh, dl, k_in}}
    w = {(i, o): randn(gen, i, o, dtype=cd) for i, o in
         ({(dh, dh), (dh, dl), (dh, k_in)} if backward else {(k_in, dh), (dl, dh), (dh, dh)})}
    if backward:
        pairs = ([(dh, dh)] * (2 * (nb - nlz)) + ns * ([(dh, dh)] * (2 * nlz) + [(dh, dl)] * nlz
                                                      + [(dh, k_in)]))
    else:
        pairs = ns * ([(k_in, dh)] + [(dl, dh)] * nlz + [(dh, dh)] * (2 * nlz)) \
            + [(dh, dh)] * (2 * (nb - nlz))
    return lambda: [torch.matmul(a[i], w[(i, o)]) for i, o in pairs]


def fill_k2_chains(kernels):
    """The library column of K2's rows at the shipped width: the cuBLAS
    chain of each kernel's products (``product_chain``, TF32 off) at the
    row's shape, d_hidden 512, the latent's 512 lanes and 64 encoded lanes:
    the bf16 forward at the band (81,920 points), the bf16 dgrad at the
    train step's band call (327,680), the float32 forward at the band, the
    float32 dgrad at the band call (its plain version is the matched
    reference, ``decoder_bwd_matched``), and the recompute backward (the
    forward's and the dgrad's products) at the VR fine pass (1,572,864).
    Inputs from a generator of their own."""
    gen = torch.Generator(device=DEV).manual_seed(31)
    k_in, bf, f32 = K2.d_enc_padded(CODE.d_enc), torch.bfloat16, torch.float32
    chains = {K2.NAME: [(BAND, bf, False)], K2.NAME_DGRAD: [(BAND_TRAIN, bf, True)],
              K2.NAME_F32: [(BAND, f32, False)], K2.NAME_DGRAD_F32: [(BAND_TRAIN, f32, True)],
              K2.NAME_RECOMPUTE: [(FINE_VR, bf, False), (FINE_VR, bf, True)]}
    for k in kernels:
        if k["name"] not in chains:
            continue
        calls = [product_chain(gen, n, 512, C, k_in, cd, bwd) for n, cd, bwd in chains[k["name"]]]
        k["library_ms"] = time_ms(lambda: [c() for c in calls], iters=3, warmup=1)
        k["library"] = "the cuBLAS chain of its products (product_chain)"
        del calls
        torch.cuda.empty_cache()
        print(f"kernel {k['name']}: the cuBLAS chain of its products {k['library_ms']:.3f} ms")


def wide_inputs(gen, n, ns, dl, code, cd):
    x = (torch.rand(ns, n, code.d_raw, generator=gen, device=DEV) * 2 - 1).contiguous()
    return x, randn(gen, ns, n, dl, dtype=cd), randn(gen, n, 4) + 0.5


def wide_ran(before, cd, route, names):
    """The launches since ``before`` of the wide counters: ``names`` (K2's
    forward or dgrad counter, the dtype's wide one, the dtype's cluster one)
    against what ``route`` must have launched (one call)."""
    ran = f32_ran(before, names)
    want = {names[0]: 1, names[1]: int(route.startswith("wide")),
            names[2]: int(route in ("wide_tma", "wide_f32"))}
    return ran, ran == want


# the cluster kernels' counters by dtype: (forward, dgrad)
WIDE_CLUSTER = {torch.bfloat16: (K2.NAME_WIDE_TMA, K2.NAME_DGRAD_WIDE_TMA),
                torch.float32: (K2.NAME_WIDE_F32_RING, K2.NAME_DGRAD_WIDE_F32_RING)}


def check_wide_rerun_bits(label, args, dims, cd, g):
    """The float32 cluster kernels' forward (output and stash) and, on that
    stash, their dgrad (dx, dz, the cotangents, gout, enc) the same bits on
    a rerun: one FMA chain per output in k order, one writer per output."""
    out, st = K2._forward(args, dims, cd, True)
    gs, wd, _ = K2._bwd_operands(args, dims, g, K2.NAME_DGRAD)
    got = K2._dgrad(args, dims, st, gs, wd, cd)
    again_out, again_st = K2._forward(args, dims, cd, True)
    again = K2._dgrad(args, dims, st, gs, wd, cd)
    pairs = [("forward", out, again_out), ("stash", st, again_st)] + list(
        zip(("dx", "dz", "cot", "gout", "enc"), got, again))
    for nm, a, b in pairs:
        if not same_bits(a, b):
            raise AssertionError(f"K2 wide_f32 {label}: {nm} differs on a rerun "
                                 f"(max abs {max_err(a, b)})")
    return {"case": f"wide_f32 {label} N={WIDE_N}: forward, stash and dgrad bit for bit on a "
                    f"rerun", "against": "rerun", "max_abs_err": 0.0, "tol": 0.0}


def check_wide_refusal(bf=torch.bfloat16):
    """A cluster launch its kernel refuses raises, and nothing falls back:
    the forward and dgrad at d_hidden 1,152 (past the bf16 TMA kernels' two
    trunk groups a warp, past the float32 kernels' 1,024 columns) forced
    onto the dtype's cluster route ("wide_tma", "wide_f32") return
    cudaErrorInvalidValue from the C entry, which the wrapper raises; the
    launch counters do not move.  Its inputs draw from a generator of their
    own."""
    gen = torch.Generator(device=DEV).manual_seed(13)
    forced = "wide_tma" if bf == torch.bfloat16 else "wide_f32"
    w = decoder_weights(gen, dl=1152, dh=1152)
    x, z, g = wide_inputs(gen, 256, 1, 1152, CODE, bf)
    args = K2._prepare(x, z, w, CODE, bf)
    dims = K2._dims(args, 5, 3, True)
    st = K2._forward(args, dims, bf, True)[1]
    gs, wd, _ = K2._bwd_operands(args, dims, g, K2.NAME_DGRAD)
    fwd, bwd = K2.forward_route, K2.backward_route
    K2.forward_route = K2.backward_route = lambda *a, **k: forced
    raised, before = [], dict(_build.launches)
    try:
        for call in (lambda: K2._forward(args, dims, bf, False),
                     lambda: K2._dgrad(args, dims, st, gs, wd, bf)):
            try:
                call()
            except RuntimeError as e:
                raised.append(str(e))
    finally:
        K2.forward_route, K2.backward_route = fwd, bwd
    torch.cuda.synchronize()
    if len(raised) != 2 or dict(_build.launches) != before:
        raise AssertionError(f"K2 {forced} refusal: raised {raised}, launches moved "
                             f"{dict(_build.launches) != before}")
    print(f"K2 {forced} at d_hidden 1,152 refused and raised: {raised}")
    return dict(case=f"{forced} launch refused at d_hidden 1,152 raises", max_abs_err=0.0,
                tol=0.0, against="refusal")


def check_wide(gen):
    """The wide kernels (``forward_route``/``backward_route`` = "wide_tma"
    for bf16 d_hidden 256..1,024, the TMA cluster kernels; "wide_f32" for
    float32 d_hidden 576..1,024, the float32 cluster kernels, also bit for
    bit on a rerun) held to their plain versions on the card at WIDE_CASES
    in bf16 and float32:
    the forward (bf16 2 ulps of the largest output or twice the plain
    version's distance from the float32 function on the same bf16-valued
    weights, whichever is larger, and held to that function too, as phase
    9 holds its fields; float32 1e-3 of the largest output) and its stash
    slot by slot by the same rules; the stash backward's 12 gradients (the
    dgrad with the wgrads) against the plain autograd (bf16 8e-2, float32
    1e-2 by relative L2: ReLU masks flipping between two correct roundings)
    and against the matched
    reference fed the kernel's own stash (bf16 MATCHED_BF16_TOL, float32
    1e-3); a rerun bit for bit; the recompute backward bit for bit the
    stash backward in one chunk, and cut to 1,000-point chunks its point
    cotangents bit for bit, its weight gradients to summation order; the
    wgrads per job at 1,024 x 1,024 and 1,024 x 1,152 against torch.matmul.
    The launch counters show which kernel each case took.  Then each kernel
    timed twice at the band chunk (81,920 points, d_hidden 1,024, latent
    1,152) beside its plain version, the cuBLAS chain of its products and
    its bound.  Returns the four kernel rows (the cluster kernels: bf16
    TMA, float32)."""
    kw = dict(n_blocks=5, n_lin_z=3, activate_out=True)
    rows = {}
    for cd in (torch.bfloat16, torch.float32):
        fwd, bwd = [], []
        rows[cd] = (fwd, bwd)
        f32 = cd == torch.float32
        for dh, dl, code, ns in WIDE_CASES:
            if f32 and dh <= 512:
                continue  # float32 at 512 is the register kernels' (check_float32)
            label = f"d_hidden {dh} d_latent {dl} k_in {K2.d_enc_padded(code.d_enc)} NS={ns} " \
                    f"{str(cd)[6:]}"
            w = decoder_weights(gen, code=code, dl=dl, dh=dh)
            x, z, g = wide_inputs(gen, WIDE_N, ns, dl, code, cd)
            before = dict(_build.launches)
            got = fused_resnetfc(x, z, w, compute_dtype=cd, code=code, **kw)
            want = resnetfc_plain(x, z, w, compute_dtype=cd, code=code, **kw)
            route = K2.forward_route(cd, K2.d_enc_padded(dl), K2.d_enc_padded(code.d_enc), dh)
            ran, ok = wide_ran(before, cd, route,
                               (K2.NAME, K2.NAME_WIDE[cd], WIDE_CLUSTER[cd][0]))
            if not ok:
                raise AssertionError(f"K2 {label}: route {route}, launches {ran}")
            wide = route.startswith("wide")
            mkw = dict(n_blocks=5, n_lin_z=3, code=code, compute_dtype=cd)
            # bf16: the float32 function on the bf16-valued weights and
            # latents, which both bf16 roundings approximate (phase 9's rule)
            exact = DecoderWeights(*(t.to(cd).float() for t in w))
            ref = None if f32 else resnetfc_plain(x, z.float(), exact,
                                                  compute_dtype=torch.float32, code=code,
                                                  **kw)
            fwd_err = max_err(got, want)
            tol = (WIDE_F32_TOL if f32 else 2.0 ** -7) * max(1.0, float(want.abs().max()))
            if not f32:
                tol = max(tol, 2 * max_err(want, ref))
                fwd.append(check(f"wide forward {label} N={WIDE_N} vs float32 (bf16 weights)",
                                 max_err(got, ref), tol, against="float32"))
            if wide:
                fwd.append(check(f"wide forward ({route}) {label} N={WIDE_N}", fwd_err, tol))
            args = K2._prepare(x, z, w, code, cd)
            dims = K2._dims(args, 5, 3, True)
            kst = K2._forward(args, dims, cd, True)[1]
            broute = K2.backward_route(cd, dh, dims["d_latent"], dims["k_in"])
            if "wide_f32" in (route, broute):
                fwd.append(check_wide_rerun_bits(label, args, dims, cd, g))
            if wide:
                pst = decoder_plain_stash(x, z, w, **mkw)
                rst = None if f32 else decoder_plain_stash(
                    x, z.float(), exact, **dict(mkw, compute_dtype=torch.float32))
                for i in range(len(pst)):
                    stol = (WIDE_F32_TOL if f32 else STASH_REL) * max(float(pst[i].abs().max()),
                                                                      1e-30)
                    if not f32:
                        stol = max(stol, 2 * max_err(pst[i], rst[i]))
                    fwd.append(check(f"wide stash slot {i} {label}", max_err(kst[i], pst[i]),
                                     stol, against="plain stash"))
                flips = float(((kst > 0) != (pst > 0)).float().mean())
                if not flips <= STASH_FLIPS:
                    raise AssertionError(f"K2 wide stash {label}: {flips} of the ReLU masks "
                                         f"flipped > {STASH_FLIPS}")
                del pst, rst
            # the backward: its dgrad is a wide one here
            if not broute.startswith("wide"):
                raise AssertionError(f"K2 {label}: backward route {broute} is not wide")
            kern = lambda stash: (lambda x, z, *ws: fused_resnetfc(
                x, z, DecoderWeights(*ws), compute_dtype=cd, code=code, stash=stash, **kw))
            plain = lambda x, z, *ws: resnetfc_plain(x, z, DecoderWeights(*ws),
                                                     compute_dtype=cd, code=code, **kw)
            before = dict(_build.launches)
            got = grads_of(kern(True), (x, z, *w), g)
            ran, ok = wide_ran(before, cd, broute, (K2.NAME_DGRAD, K2.NAME_DGRAD_WIDE[cd],
                                                    WIDE_CLUSTER[cd][1]))
            if not ok:
                raise AssertionError(f"K2 {label}: dgrad route {broute}, launches {ran}")
            want = grads_of(plain, (x, z, *w), g)
            matched = decoder_bwd_matched(x, z, w, kst, g, **mkw)
            bl = f"{label} N={WIDE_N}"
            bwd += [check_l2(f"wide {nm} {bl}", a, b, 1e-2 if f32 else 8e-2)
                    for nm, a, b in zip(DECODER_GRADS, got, want)]
            bwd += [check_l2(f"wide {nm} {bl} vs matched rounding", a, m,
                             WIDE_F32_TOL if f32 else MATCHED_BF16_TOL, against="matched")
                    for nm, a, m in zip(DECODER_GRADS, got, matched)]
            bwd.append(check_rerun(f"wide rerun every gradient {bl}", got,
                                   grads_of(kern(True), (x, z, *w), g)))
            rec = grads_of(kern(False), (x, z, *w), g)  # one chunk: the same launches
            bwd.append(check_rerun(f"wide recompute bit for bit the stash backward {bl}", got,
                                   rec))
            saved = K2.RECOMPUTE_CHUNK
            K2.RECOMPUTE_CHUNK = 1_000
            try:
                cut = grads_of(kern(False), (x, z, *w), g)
            finally:
                K2.RECOMPUTE_CHUNK = saved
            bwd.append(check_rerun(f"wide recompute in 1,000-point chunks: dx, dz bit for bit "
                                   f"{bl}", got[:2], cut[:2]))
            bwd += [check_rel(f"wide {nm} {bl} recompute in 1,000-point chunks vs stash", a, b,
                              SUM_ORDER_TOL, "stash kernels")
                    for nm, a, b in zip(DECODER_GRADS[2:], cut[2:], got[2:])]
            worst = max((c["rel_l2"], c["case"].split()[1]) for c in bwd
                        if c["against"] == "plain" and bl in c["case"])
            print(f"K2 wide {bl}: forward on the {route} route {fwd_err:.3e} (tolerance "
                  f"{tol:.3e}); backward on the {broute} route, worst relative L2 against the "
                  f"plain autograd {worst}")
            del kst, got, want, matched, rec, cut, args
        bwd.append(check_wide_refusal(cd))
        # the wgrads at width: K2's 15 jobs at 1,024 x 1,024 and 1,024 x
        # 1,152 (and lin_in, lin_out) against torch.matmul, a coarse query's
        # 16,384 points
        w = decoder_weights(gen, dl=WIDE_DL, dh=WIDE_DH)
        x, z, g = wide_inputs(gen, SB_TRAIN * CHUNK, 1, WIDE_DL, CODE, cd)
        args = K2._prepare(x, z, w, CODE, cd)
        dims = K2._dims(args, 5, 3, True)
        kst = K2._forward(args, dims, cd, True)[1]
        gs, wd, _ = K2._bwd_operands(args, dims, g, K2.NAME_DGRAD)
        _, _, cot, gout, enc = K2._dgrad(args, dims, kst, gs, wd, cd)
        jobs = wgrad_matmul_jobs(kst, cot, gout, enc, args["z"], 5, 3)
        bwd += check_wgrad_jobs(kst, cot, gout, enc, args, dims, jobs, cd)
        del kst, cot, gout, enc, jobs, args
        torch.cuda.empty_cache()

    # timed at the band chunk: the forward (no stash, as served) and the
    # dgrad on the stash forward's activations
    out = []
    w = decoder_weights(gen, dl=WIDE_DL, dh=WIDE_DH)
    for cd in (torch.bfloat16, torch.float32):
        fwd, bwd = rows[cd]
        item = 2 if cd == torch.bfloat16 else 4
        peak = BF16_FLOPS if cd == torch.bfloat16 else F32_FLOPS
        x, z, g = wide_inputs(gen, BAND, 1, WIDE_DL, CODE, cd)
        args = K2._prepare(x, z, w, CODE, cd)
        dims = K2._dims(args, 5, 3, True)
        k_in = dims["k_in"]
        iters = 5 if cd == torch.bfloat16 else 2
        fwd_call = lambda: K2._forward(args, dims, cd, False)
        ms = [time_ms(fwd_call, iters=iters, warmup=1) for _ in range(2)]
        plain_ms = time_ms(lambda: resnetfc_plain(x, z, w, compute_dtype=cd, code=CODE, **kw),
                           iters=iters, warmup=1)
        lib_ms = time_ms(product_chain(gen, BAND, WIDE_DH, WIDE_DL, k_in, cd, False),
                         iters=iters, warmup=1)
        wbytes = sum(t.numel() for t in w) * item
        flops = wide_flops(BAND, 1, WIDE_DH, WIDE_DL, CODE.d_enc)
        b_ms, b_by = bound(x.numel() * 4 + z.numel() * item + wbytes + BAND * 4 * 4, flops, peak)
        out.append(dict(name=WIDE_CLUSTER[cd][0],
                        source="avr_tpu_torch/csrc/resnetfc_wide.cu",
                        replaces="avr_tpu/ops/pallas/resnetfc.py:896", tpu_kernel="fused_resnetfc",
                        shape=f"N={BAND}, NS=1, d_hidden {WIDE_DH}, d_latent {WIDE_DL}, 5 blocks, "
                              f"{str(cd)[6:]}", cases=fwd, ms=min(ms),
                        plain_ms=plain_ms, library_ms=lib_ms,
                        library="the cuBLAS chain of the forward's products", bound_ms=b_ms,
                        bound_by=b_by, ms_turns=ms))
        st = K2._forward(args, dims, cd, True)[1]
        gs, wd, _ = K2._bwd_operands(args, dims, g, K2.NAME_DGRAD)
        dgrad_call = lambda: K2._dgrad(args, dims, st, gs, wd, cd)
        ms = [time_ms(dgrad_call, iters=iters, warmup=1) for _ in range(2)]
        plain_ms = time_ms(lambda: decoder_bwd_matched(x, z, w, st, g, n_blocks=5, n_lin_z=3,
                                                       code=CODE, compute_dtype=cd,
                                                       wgrads=False), iters=iters, warmup=1)
        lib_ms = time_ms(product_chain(gen, BAND, WIDE_DH, WIDE_DL, k_in, cd, True),
                         iters=iters, warmup=1)
        slots = K2.stash_slots(1, 5, 3)
        io = BAND * (CODE.d_raw * 4 * 2 + WIDE_DL * item * 2 + 4 * 4)  # x, dx, z, dz, g
        b_ms, b_by = bound(2 * slots * BAND * WIDE_DH * item + io + wbytes, flops, peak)
        out.append(dict(name=WIDE_CLUSTER[cd][1],
                        source="avr_tpu_torch/csrc/resnetfc_wide.cu",
                        replaces="avr_tpu/ops/pallas/resnetfc.py:823", tpu_kernel="_bwd_stash_impl",
                        shape=f"N={BAND}, NS=1, d_hidden {WIDE_DH}, d_latent {WIDE_DL}, 5 blocks, "
                              f"{str(cd)[6:]}", cases=bwd, ms=min(ms),
                        plain_ms=plain_ms, library_ms=lib_ms,
                        library="the cuBLAS chain of the dgrad's products", bound_ms=b_ms,
                        bound_by=b_by, ms_turns=ms))
        for r in out[-2:]:
            print(f"kernel {r['name']}: {r['ms']:.3f} ms ({[round(v, 3) for v in r['ms_turns']]}; "
                  f"plain {r['plain_ms']:.3f}, cuBLAS chain {r['library_ms']:.3f}, bound "
                  f"{r['bound_ms']:.3f} by {r['bound_by']}) {len(r['cases'])} cases, all within "
                  f"tolerance")
        del st, gs, wd, args, x, z, g
        torch.cuda.empty_cache()
    return out


# the bf16 forward past the wgmma forward's 512-lane A tile at the shipped
# d_hidden 512, timed at the band chunk: phase 9's global encoder (640
# lanes) and a 5-stage encoder (1,024)
PIECES_DLS = (640, 1024)


def time_pieces_forward(gen):
    """The bf16 forward at latents of PIECES_DLS lanes at the band chunk:
    the wgmma forward's pieces (its route by forward_route) timed twice
    (CUDA events) beside the plain version, the cuBLAS chain of its
    products and its bound, held to the plain version (2^-7 of the largest
    output, as check_resnetfc_pieces).  Returns a row a latent for the
    report."""
    bf = torch.bfloat16
    kw = dict(n_blocks=5, n_lin_z=3, activate_out=True)
    rows = {}
    for dl in PIECES_DLS:
        w = decoder_weights(gen, dl=dl)
        x, z, _ = wide_inputs(gen, BAND, 1, dl, CODE, bf)
        args = K2._prepare(x, z, w, CODE, bf)
        dims = K2._dims(args, 5, 3, True)
        route = K2.forward_route(bf, dims["d_latent"], dims["k_in"], 512)
        if route != "wgmma":
            raise AssertionError(f"K2 d_latent {dl}: routed to {route}")
        call = lambda: K2._forward(args, dims, bf, False)
        want = resnetfc_plain(x, z, w, compute_dtype=bf, code=CODE, **kw)
        tol = 2.0 ** -7 * max(1.0, float(want.abs().max()))
        cases = [check(f"pieces timed N={BAND} d_latent {dl} NS=1 bf16", max_err(call()[0], want),
                       tol)]
        ms = [time_ms(call, iters=5, warmup=1) for _ in range(2)]
        plain_ms = time_ms(lambda: resnetfc_plain(x, z, w, compute_dtype=bf, code=CODE, **kw),
                           iters=3, warmup=1)
        lib_ms = time_ms(product_chain(gen, BAND, 512, dl, dims["k_in"], bf, False),
                         iters=5, warmup=1)
        wbytes = sum(t.numel() for t in w) * 2
        b_ms, b_by = bound(x.numel() * 4 + z.numel() * 2 + wbytes + BAND * 4 * 4,
                           wide_flops(BAND, 1, 512, dl, CODE.d_enc), BF16_FLOPS)
        row = rows[str(dl)] = dict(
            kernel="resnetfc_fwd_wgmma_kernel (pieces)",
            source="avr_tpu_torch/csrc/resnetfc_hopper.cu",
            shape=f"N={BAND}, NS=1, d_hidden 512, d_latent {dl}, bf16",
            ms=min(ms), ms_turns=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
            bound_by=b_by, cases=cases)
        print(f"K2 wgmma pieces {row['shape']}: {[round(v, 3) for v in ms]} ms (plain "
              f"{plain_ms:.3f}, cuBLAS chain {lib_ms:.3f}, bound {b_ms:.3f} by {b_by}); "
              f"{cases[0]['max_abs_err']:.3e} from the plain version (tolerance {tol:.3e})")
        del args, x, z, want
        torch.cuda.empty_cache()
    return rows


WIDE_C = 1024  # the latent channels of a 5-stage encoder's map


def check_wide_channels(gen):
    """K1, K5 and K3 at the wide slice's 1,024 latent channels, bf16 and
    float32, against their plain versions at the tolerances of
    check_gather_proj, check_gather_proj_bwd, check_march, check_march_f32
    and check_march_bwd: K1 and K5 forward and backward at the band (81,920
    points of a 64 x 64 x 1,024 map; the backward also bit for bit on a
    rerun), K3's forward and backward over 2 steps (float32's W_ih, 1,024 x
    64, is past WIH_SMEM_MAX and is read through L2)."""
    cases = []
    for cd in (torch.bfloat16, torch.float32):
        bf, kind = cd == torch.bfloat16, f"C={WIDE_C} {str(cd)[6:]}"
        feat, pts, proj = proj_inputs(gen, 1, 1, cd, BAND, channels=WIDE_C)
        coords = (torch.rand(1, BAND, 2, generator=gen, device=DEV) * 2.2 - 1.1).contiguous()
        g = randn(gen, 1, BAND, WIDE_C, dtype=cd)
        k5 = lambda f, p: gather_bilinear_projected(f, p, proj)
        p5 = lambda f, p: gather_bilinear_projected_plain(f, p, proj)
        for name, fk, fp, inputs, dname in (
                ("K1", gather_bilinear, gather_bilinear_plain, (feat, coords), "dcoords"),
                ("K5", k5, p5, (feat, pts), "dpoints")):
            cases.append(check(f"{name} forward {kind} N={BAND}", max_err(fk(*inputs), fp(*inputs)),
                               2e-2 if bf else 1e-5))
            got, want = grads_of(fk, inputs, g), grads_of(fp, inputs, g)
            cases += [check_l2(f"{name} dfeat {kind} N={BAND}", got[0], want[0],
                               2.0 ** -7 if bf else 1e-5),
                      check_l2(f"{name} {dname} {kind} N={BAND}", got[1], want[1], 1e-4),
                      check_rerun(f"{name} rerun {kind} N={BAND}", got, grads_of(fk, inputs, g))]
        inp = march_inputs(gen, 1, dtype=cd, channels=WIDE_C)
        kw = dict(steps=2, compute_dtype=cd)
        with march_routed(cd):
            got = fused_lstm_march(**inp, **kw)
        cases.append(check(f"K3 forward {kind} steps=2",
                           max_err(got, lstm_march_plain(**inp, **kw)), 1e-3 if bf else 1e-4))
        gm = randn(gen, 1, CHUNK, 3)
        f = lambda fn: (lambda *t: fn(inp["proj"], *t, **kw))
        with march_routed(cd, backward=True):
            got = grads_of(f(fused_lstm_march), tuple(inp[k] for k in MARCH_KEYS), gm)
        want = grads_of(f(lstm_march_plain), tuple(inp[k] for k in MARCH_KEYS), gm)
        cases += [check_l2(f"K3 {nm} {kind} steps=2", a, b, 2e-2 if bf else 1e-3)
                  for nm, a, b in zip(MARCH_GRADS, got, want)]
        del feat, pts, proj, coords, g, inp, got, want
    worst = max((c for c in cases if c["tol"]),
                key=lambda c: c.get("rel_l2", c["max_abs_err"]) / c["tol"])
    print(f"K1, K5 and K3 at {WIDE_C} channels: {len(cases)} cases within tolerance; worst "
          f"against its tolerance {worst['case']}")
    return cases


def run_wide_slice(chain=False):
    """The full-width slice through the entry points a user calls: the
    adaptive model of ``make_model`` from the WIDE_CONF conf string
    (d_hidden 1,024, a latent of 1,024 + 128 lanes), a served 128x128
    frame (``render_full_image``, bf16 and float32) and train steps
    (``make_train_step``, SB 4 x 4,096 rays) in bf16 and float32, each on
    the stash and on the recompute backward; the launch counters reset
    just before each and read just after.  Every K2 forward and dgrad of
    these runs is on the wide kernels; the frames are finite in [0, 1], the
    losses finite, the updates not skipped, the parameters moved.  With
    ``chain``, phase 12's slice: the same model at CHAIN_DH (bf16 d_hidden
    1,280: the frame and both steps; float32 1,920: the frame and the
    recompute step), every K2 forward and dgrad on the chain.  Returns the
    report and the launches by case."""
    t0 = time.perf_counter()
    res, launches = {}, {}
    batch, tb = scene_batch(), train_batch(DEV)
    intr = torch.as_tensor(batch["intrinsics"][:, 0])
    c2w = orbit_cam2world(1, 1.3)[:1]

    def wide_only(case, counts, cd):
        # every forward on the dtype's cluster kernel (bf16 TMA, float32),
        # or with ``chain`` on the chain
        fwd = counts.get(K2.NAME, 0) + counts.get(K2.NAME_STASH, 0)
        other = {k: counts.get(k, 0) for k in (K2.NAME_WGMMA, K2.NAME_F32, K2.NAME_DGRAD_F32)}
        if chain:
            other[K2.NAME_WIDE[cd]] = counts.get(K2.NAME_WIDE[cd], 0)
            if not fwd or counts.get(K2.NAME_CHAIN[cd], 0) != fwd or any(other.values()):
                raise AssertionError(f"chain {case}: K2 forwards {fwd}, on the chain "
                                     f"{counts.get(K2.NAME_CHAIN[cd], 0)}, elsewhere {other}")
            return
        cl = counts.get(WIDE_CLUSTER[cd][0], 0)
        if not fwd or counts.get(K2.NAME_WIDE[cd], 0) != fwd or any(other.values()) or cl != fwd:
            raise AssertionError(f"wide {case}: K2 forwards {fwd}, on the wide kernels "
                                 f"{counts.get(K2.NAME_WIDE[cd], 0)} (cluster {cl}), "
                                 f"elsewhere {other}")

    for cd in (torch.bfloat16, torch.float32):
        kind = str(cd)[6:]
        conf = chain_conf(CHAIN_DH[cd]) if chain else WIDE_CONF
        model = conf_model(conf, cd, DEV)
        with torch.inference_mode():
            cond = encode_scene(model, batch, DEV)
            render_full_image(model, cond, intr, c2w, SIDE, threefry.PRNGKey(0), CHUNK, DEV)
            torch.cuda.synchronize()
            _build.reset_launches()
            t = time.perf_counter()
            out = render_full_image(model, cond, intr, c2w, SIDE, threefry.PRNGKey(1), CHUNK, DEV)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        counts = launches[f"serve_{kind}"] = dict(_build.launches)
        wide_only(f"serve {kind}", counts, cd)
        rgb = (out.rgb_coarse if out.rgb_fine is None else out.rgb_fine).float()
        if not torch.isfinite(rgb).all() or rgb.min() < -1e-6 or rgb.max() > 1 + 1e-6:
            raise AssertionError(f"wide serve {kind}: rgb not finite in [0, 1]")
        res[f"serve_{kind}"] = dict(frame_ms=ms, rgb_mean=float(rgb.mean()),
                                    latent_shape=list(cond.latent.shape),
                                    global_latent_shape=list(cond.global_latent.shape))
        if cond.latent.shape[-1] + cond.global_latent.shape[-1] != WIDE_DL:
            raise AssertionError(f"wide: latents {cond.latent.shape}, {cond.global_latent.shape}")
        del model, cond, out
        trains = (("stash", "stash"), ("always", "recompute"))
        for fused_mlp, bwd in trains[1:] if chain and cd == torch.float32 else trains:
            case = f"train_{kind}_{bwd}"
            model = conf_model(conf, cd, DEV, fused_mlp=fused_mlp)
            opt = make_optimizer(1e-4)
            state = create_train_state(model, opt)
            loss_params = LossParams(loss_mode="both")
            step = make_train_step(model, opt, loss_params)
            initial = {k: v.detach().clone() for k, v in state.params.items()}
            state, m = step(state, *tb, (0, 0))  # warm-up
            torch.cuda.synchronize()
            _build.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            state, m = step(state, *tb, (0, 1))
            loss, skipped = float(m["loss"]), int(m["notfinite"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            counts = launches[case] = dict(_build.launches)
            wide_only(case, counts, cd)
            name = K2.NAME_DGRAD if bwd == "stash" else K2.NAME_RECOMPUTE
            dgrads = counts.get(K2.NAME_DGRAD, 0) + counts.get(K2.NAME_RECOMPUTE, 0)
            if chain and (not counts.get(name) or counts.get(K2.NAME_DGRAD_CHAIN[cd], 0) != dgrads
                          or counts.get(K2.NAME_DGRAD_WIDE[cd]) or not counts.get(K2.NAME_WGRAD)):
                raise AssertionError(f"chain {case}: dgrads {counts}")
            cl = counts.get(WIDE_CLUSTER[cd][1], 0)
            if not chain and (not counts.get(K2.NAME_DGRAD_WIDE[cd]) or
                              counts.get(K2.NAME_DGRAD_WIDE[cd]) != counts.get(name, 0) or
                              cl != counts.get(name, 0) or not counts.get(K2.NAME_WGRAD)):
                raise AssertionError(f"wide {case}: dgrads {counts}")
            if not np.isfinite(loss) or skipped:
                raise AssertionError(f"wide {case}: loss {loss}, skipped updates {skipped}")
            same = [k for k, v in state.params.items()
                    if k.startswith(("mlp_", "net.mlp_")) and torch.equal(v, initial[k])]
            if same:
                raise AssertionError(f"wide {case}: decoder parameters unchanged: {same[:4]}")
            res[case] = dict(ms=ms, loss=loss, skipped=skipped,
                             max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
            print(f"{'chain' if chain else 'wide'} {case}: loss {loss:.5f}, {ms:.1f} ms a step, "
                  f"peak "
                  f"{res[case]['max_memory_gb']:.1f} GB; launches {counts}")
            del model, opt, state, step, initial
            torch.cuda.empty_cache()
        print(f"{'chain' if chain else 'wide'} serve {kind}: {res[f'serve_{kind}']}; launches "
              f"{launches[f'serve_{kind}']}")
    res["seconds"] = time.perf_counter() - t0
    return res, launches


# the wide rows of the kernels line: the four kernels' names (the cluster
# kernels: bf16 TMA, float32)
WIDE_NAMES = (*WIDE_CLUSTER[torch.bfloat16], *WIDE_CLUSTER[torch.float32])


def run_wide():
    """Phase 11: the wide kernels against their plain versions, timed, K1,
    K5 and K3 at 1,024 channels, then the full-width slice.  Returns the
    kernel rows, the slice's report and its launches; each row carries its
    launches on the slice."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(12)
    kernels = check_wide(gen)
    channels = check_wide_channels(gen)
    pieces = time_pieces_forward(torch.Generator(device=DEV).manual_seed(14))
    res, launches = run_wide_slice()
    res["channels"] = channels
    res["pieces_forward"] = pieces
    for k in kernels:
        by_case = {case: counts.get(k["name"], 0) for case, counts in launches.items()}
        if not sum(by_case.values()):
            raise AssertionError(f"{k['name']} was never launched on the wide slice")
        k.update(wide=sum(by_case.values()), wide_by_case=by_case)
    res["seconds_phase"] = time.perf_counter() - t0
    print(f"wide launches: {launches}; phase {res['seconds_phase']:.1f} s")
    return kernels, res, launches


# ---------------------------------------------------------------------------
# phase 12: K2's chain past the wide kernels' shared memory; the binned
# backward on maps past 1,024 tiles
# ---------------------------------------------------------------------------

# the chain's slice: conf/default_mv.conf's model as WIDE_CONF, both
# decoders at these widths (past the cluster kernels' 1,024 columns)
CHAIN_DH = {torch.bfloat16: 1280, torch.float32: 1920}
# encodings past 64 lanes for the sweep and the chain's checks (18
# frequencies or fewer: more make dx's norm overflow float32), by their
# padded lanes
SWEEP_CODES = {192: CodeSpec(2, 1.5, True, 32, 3), 1088: CodeSpec(16, 1.5, True, 32, 3),
               1216: CodeSpec(18, 1.5, True, 32, 3), 2048: CodeSpec(15, 1.5, True, 64, 3),
               2176: CodeSpec(16, 1.5, True, 64, 3), 3072: CodeSpec(16, 1.5, True, 64, 900)}
# (dtype, d_hidden, d_latent, code): the chain's shapes held on the card;
# bf16 d_hidden 1,024 with a latent of 4,096 takes the chain's forward and
# the TMA cluster dgrad (which holds no latent tile), as does bf16 d_hidden
# 512 with a latent of 4,096; and a corner of each family the sweep moved
# to the chain (CHAIN_SWEEP): A1 (bf16 d_hidden 64, a latent of 1,216: the
# forward, and its dgrad too), B1 (bf16 d_hidden 576, a latent of 2,112:
# the forward, the TMA cluster dgrad), C4 (bf16 d_hidden 192, a latent of
# 4,096: the dgrad, its forward the chain's already), D1 (float32 d_hidden
# 1,024, 1,088 encoded lanes: both)
CHAIN_CASES = ((torch.bfloat16, 1280, WIDE_DL, CODE), (torch.bfloat16, 2048, WIDE_DL, CODE),
               (torch.bfloat16, 1024, 4096, CODE), (torch.float32, 1920, WIDE_DL, CODE),
               (torch.bfloat16, 512, 4096, CODE), (torch.bfloat16, 64, 1216, CODE),
               (torch.bfloat16, 576, 2112, CODE), (torch.bfloat16, 192, 4096, CODE),
               (torch.float32, 1024, WIDE_DL, SWEEP_CODES[1088]))
CHAIN_N = (BAND, CHUNK + 37)  # the band chunk, and off every tile
class SweepRow(NamedTuple):
    """A shape of ``--chain-sweep``: the chain against ``other`` (both forced)
    at the band chunk, timing ``times`` ("forward", "dgrad" or both)."""

    corner: str
    cd: torch.dtype
    dh: int
    dl: int
    other: str
    times: tuple = ("forward", "dgrad")
    code: CodeSpec = CODE
    ns: int = 1

FWD, DGRAD = ("forward",), ("dgrad",)
# the chain timed in turns against the routes that took these shapes
# before it (the RETIRED ones run from a tree that has them): the first
# wide version at bf16 1,152 and float32 1,152 to 1,792 (where the chain
# first took d_hidden past 1,024), resnetfc_kernel at d_hidden 128 to 512
# past 1,152 lanes and the corners of the four families the chain then
# took whole: A1-A6 resnetfc_kernel's bf16 forwards at d_hidden 64 to 512
# past 1,152 lanes (A6 at NS 2), B1-B2 the first wide version's bf16
# forwards at d_hidden 576 to 704 past the TMA cluster kernel's shared
# memory, C1-C5 its bf16 dgrads at d_hidden 64 to 192 past the tail's
# envelope, D1-D4 its float32 forwards and dgrads where fewer than 3 ring
# stages of the float32 cluster kernels fit (D4's forward the chain's
# already); and at d_hidden 1,024 the cluster kernels beside the chain (a
# reading, no route moved by it)
CHAIN_SWEEP = (SweepRow("", torch.bfloat16, 1152, WIDE_DL, "wide"),
               SweepRow("", torch.float32, 1152, WIDE_DL, "wide"),
               SweepRow("", torch.float32, 1408, WIDE_DL, "wide"),
               SweepRow("", torch.float32, 1792, WIDE_DL, "wide"),
               SweepRow("", torch.bfloat16, 512, 1280, "mma_sync", FWD),
               SweepRow("", torch.bfloat16, 512, 2048, "mma_sync", FWD),
               SweepRow("", torch.bfloat16, 256, 2048, "mma_sync", FWD),
               SweepRow("", torch.bfloat16, 128, 1280, "mma_sync", FWD),
               SweepRow("", torch.bfloat16, 1024, WIDE_DL, "wide_tma"),
               SweepRow("", torch.float32, 1024, WIDE_DL, "wide_f32"),
               SweepRow("A1", torch.bfloat16, 64, 1216, "mma_sync", FWD),
               SweepRow("A2", torch.bfloat16, 64, 3328, "mma_sync", FWD),
               SweepRow("A3", torch.bfloat16, 512, 1216, "mma_sync", FWD),
               SweepRow("A4", torch.bfloat16, 512, 1984, "mma_sync", FWD),
               SweepRow("A5", torch.bfloat16, 512, 512, "mma_sync", FWD, SWEEP_CODES[1216]),
               SweepRow("A6", torch.bfloat16, 512, 1280, "mma_sync", FWD, ns=2),
               SweepRow("B1", torch.bfloat16, 576, 2112, "wide", FWD),
               SweepRow("B2", torch.bfloat16, 704, 2176, "wide", FWD),
               SweepRow("C1", torch.bfloat16, 64, 576, "wide", DGRAD),
               SweepRow("C2", torch.bfloat16, 64, 4096, "wide", DGRAD),
               SweepRow("C3", torch.bfloat16, 192, 576, "wide", DGRAD),
               SweepRow("C4", torch.bfloat16, 192, 4096, "wide", DGRAD),
               SweepRow("C5", torch.bfloat16, 128, 512, "wide", DGRAD, SWEEP_CODES[192]),
               SweepRow("D1", torch.float32, 1024, WIDE_DL, "wide", code=SWEEP_CODES[1088]),
               SweepRow("D2", torch.float32, 576, WIDE_DL, "wide", code=SWEEP_CODES[2176]),
               SweepRow("D3", torch.float32, 768, WIDE_DL, "wide", code=SWEEP_CODES[2048]),
               SweepRow("D4", torch.float32, 1024, WIDE_DL, "wide", DGRAD, SWEEP_CODES[3072]))

BIG_MAPS = (288, 512)  # 1,296 and 4,096 8 x 8 tiles a map


def chain_conf(dh):
    """WIDE_CONF with both decoders at ``dh``."""
    return WIDE_CONF.replace("d_hidden = 1024", f"d_hidden = {dh}")


def launched(before):
    return {k: v - before.get(k, 0) for k, v in _build.launches.items() if v != before.get(k, 0)}


@contextlib.contextmanager
def routes_forced(route):
    """Every K2 forward and dgrad on ``route`` (the sweep's turns)."""
    fwd, bwd = K2.forward_route, K2.backward_route
    K2.forward_route = K2.backward_route = lambda *a, **k: route
    try:
        yield
    finally:
        K2.forward_route, K2.backward_route = fwd, bwd


def check_chain(gen):
    """The chain (``forward_route`` / ``backward_route`` = "chain",
    ``csrc/resnetfc_chain.cu``) at CHAIN_CASES, N in CHAIN_N, NS 1 and 2:
    the forward against its plain version by phase 9's bf16 rule (the larger
    of 2 bf16 ulps of the largest output and twice the plain version's
    distance from the float32 function on the same bf16-valued weights, and
    held to that function too) or float32 at WIDE_F32_TOL, its stash slot by
    slot by the same rules; the stash backward's dgrad against
    ``decoder_bwd_matched`` on the kernel's own stash (bf16
    MATCHED_BF16_TOL, float32 WIDE_F32_TOL, by relative L2) and, off the
    tile, the 12 gradients against the plain autograd (bf16 8e-2, float32
    1e-2 by relative L2, as check_wide); each backward bit for bit on a
    rerun; the recompute backward bit for bit the stash backward; off the
    tile, the chain cut into 384-point chunks (the recompute into
    1,000-point ones): the forward bit for bit, dx and dz bit for bit, the
    weight gradients to summation order.  The launch counters show every
    call on its route.  Returns the cases by dtype: (forward, dgrad)."""
    kw = dict(n_blocks=5, n_lin_z=3, activate_out=True)
    rows = {cd: ([], []) for cd in (torch.bfloat16, torch.float32)}
    for cd, dh, dl, code in CHAIN_CASES:
        f32 = cd == torch.float32
        fwd, bwd = rows[cd]
        k_in = K2.d_enc_padded(code.d_enc)
        route = K2.forward_route(cd, K2.d_enc_padded(dl), k_in, dh)
        broute = K2.backward_route(cd, dh, K2.d_enc_padded(dl), k_in)
        if route != "chain":
            raise AssertionError(f"K2 chain d_hidden {dh} d_latent {dl}: routed to {route}")
        w = decoder_weights(gen, dh=dh, dl=dl, code=code)
        exact = DecoderWeights(*(t.to(cd).float() for t in w))
        mkw = dict(n_blocks=5, n_lin_z=3, code=code, compute_dtype=cd)
        kern = lambda stash: (lambda x, z, *ws: fused_resnetfc(
            x, z, DecoderWeights(*ws), compute_dtype=cd, code=code, stash=stash, **kw))
        for n in CHAIN_N:
            for ns in (1, 2):
                label = (f"d_hidden {dh} d_latent {dl} k_in {k_in} NS={ns} N={n} "
                         f"{str(cd)[6:]}")
                x, z, g = wide_inputs(gen, n, ns, dl, code, cd)
                before = dict(_build.launches)
                kout = fused_resnetfc(x, z, w, compute_dtype=cd, code=code, **kw)
                ran = launched(before)
                if ran != {K2.NAME: 1, K2.NAME_CHAIN[cd]: 1}:
                    raise AssertionError(f"K2 chain {label}: forward launches {ran}")
                want = resnetfc_plain(x, z, w, compute_dtype=cd, code=code, **kw)
                fwd_err = max_err(kout, want)
                tol = (WIDE_F32_TOL if f32 else 2.0 ** -7) * max(1.0, float(want.abs().max()))
                if not f32:
                    ref = resnetfc_plain(x, z.float(), exact, compute_dtype=torch.float32,
                                         code=code, **kw)
                    tol = max(tol, 2 * max_err(want, ref))
                    fwd.append(check(f"chain forward {label} vs float32 (bf16 weights)",
                                     max_err(kout, ref), tol, against="float32"))
                    del ref
                fwd.append(check(f"chain forward {label}", fwd_err, tol))
                args = K2._prepare(x, z, w, code, cd)
                dims = K2._dims(args, 5, 3, True)
                kst = K2._forward(args, dims, cd, True)[1]
                pst = decoder_plain_stash(x, z, w, **mkw)
                rst = None if f32 else decoder_plain_stash(
                    x, z.float(), exact, **dict(mkw, compute_dtype=torch.float32))
                for i in range(len(pst)):
                    stol = (WIDE_F32_TOL if f32 else STASH_REL) * max(float(pst[i].abs().max()),
                                                                      1e-30)
                    if not f32:
                        stol = max(stol, 2 * max_err(pst[i], rst[i]))
                    fwd.append(check(f"chain stash slot {i} {label}", max_err(kst[i], pst[i]),
                                     stol, against="plain stash"))
                flips = float(((kst > 0) != (pst > 0)).float().mean())
                if not flips <= STASH_FLIPS:
                    raise AssertionError(f"K2 chain stash {label}: {flips} of the ReLU masks "
                                         f"flipped > {STASH_FLIPS}")
                del pst, rst, args
                before = dict(_build.launches)
                got = grads_of(kern(True), (x, z, *w), g)
                ran = launched(before)
                want_ran = {K2.NAME_STASH: 1, K2.NAME_DGRAD: 1, K2.NAME_CHAIN[cd]: 1,
                            K2.NAME_WGRAD: 1, **({K2.NAME_WGRAD_F32: 1} if f32 else {})}
                want_ran.update({K2.NAME_DGRAD_CHAIN[cd]: 1} if broute == "chain" else
                                {K2.NAME_DGRAD_WIDE[cd]: 1, WIDE_CLUSTER[cd][1]: 1})
                if ran != want_ran:
                    raise AssertionError(f"K2 chain {label}: backward launches {ran}, "
                                         f"expected {want_ran}")
                matched = decoder_bwd_matched(x, z, w, kst, g, **mkw)
                bwd += [check_l2(f"chain {nm} {label} vs matched rounding ({broute} dgrad)", a, m,
                                 WIDE_F32_TOL if f32 else MATCHED_BF16_TOL, against="matched")
                        for nm, a, m in zip(DECODER_GRADS, got, matched)]
                del matched, kst
                bwd.append(check_rerun(f"chain rerun every gradient {label}", got,
                                       grads_of(kern(True), (x, z, *w), g)))
                bwd.append(check_rerun(f"chain recompute bit for bit the stash backward {label}",
                                       got, grads_of(kern(False), (x, z, *w), g)))
                if n != BAND:
                    plain = lambda x, z, *ws: resnetfc_plain(x, z, DecoderWeights(*ws),
                                                             compute_dtype=cd, code=code, **kw)
                    bwd += [check_l2(f"chain {nm} {label}", a, b, 1e-2 if f32 else 8e-2)
                            for nm, a, b in zip(DECODER_GRADS, got,
                                                grads_of(plain, (x, z, *w), g))]
                    saved = K2.CHAIN_CHUNK, K2.RECOMPUTE_CHUNK
                    K2.CHAIN_CHUNK, K2.RECOMPUTE_CHUNK = 384, 1_000
                    try:
                        cut_out = fused_resnetfc(x, z, w, compute_dtype=cd, code=code, **kw)
                        cut = grads_of(kern(False), (x, z, *w), g)
                    finally:
                        K2.CHAIN_CHUNK, K2.RECOMPUTE_CHUNK = saved
                    fwd.append(check_rerun(f"chain forward in 384-point chunks bit for bit "
                                           f"{label}", [kout], [cut_out]))
                    bwd.append(check_rerun(f"chain recompute in 1,000-point chunks: dx, dz bit "
                                           f"for bit {label}", got[:2], cut[:2]))
                    bwd += [check_rel(f"chain {nm} {label} in 1,000-point chunks vs stash", a, b,
                                      SUM_ORDER_TOL, "stash kernels")
                            for nm, a, b in zip(DECODER_GRADS[2:], cut[2:], got[2:])]
                worst = max((c.get("rel_l2", 0.0), c["case"].split()[1]) for c in bwd
                            if c["against"] == "matched" and label in c["case"])
                print(f"K2 chain {label}: forward {fwd_err:.3e} (tolerance {tol:.3e}); {broute} "
                      f"dgrad, worst relative L2 against the matched reference {worst}")
                del got, kout, want, x, z, g
                torch.cuda.empty_cache()
    return rows


def chain_bound(cd, dh, dl, d_enc, backward, d_raw=CODE.d_raw, ns=1, n=BAND):
    """The least time of a K2 call of ``n`` points (the band chunk): its
    operations (``wide_flops``, the dgrad the same products) at the dtype's
    peak, or its bytes (the forward's inputs, weights and output; the
    dgrad's stash read, cotangents written, its inputs and outputs)."""
    item, peak = (2, BF16_FLOPS) if cd == torch.bfloat16 else (4, F32_FLOPS)
    wbytes = item * (dh * d_enc + 3 * dh * dl + 10 * dh * dh + 4 * dh)
    if backward:
        slots = K2.stash_slots(ns, 5, 3)
        io = n * (ns * (d_raw * 4 * 2 + dl * item * 2) + 4 * 4)
        nbytes = 2 * slots * n * dh * item + io + wbytes
    else:
        nbytes = n * (ns * (d_raw * 4 + dl * item) + 4 * 4) + wbytes
    return bound(nbytes, wide_flops(n, ns, dh, dl, d_enc), peak)


# csrc/resnetfc_chain.cu's kernels, as the profiler names them, and the least
# share of a call's CUDA-event time their device ms must sum to (a call is
# its kernels back to back: ~98% in phase 12 alone)
CHAIN_KERNELS = ("chain_gemm_wgmma_kernel", "chain_gemm_f32_kernel", "chain_linout_kernel",
                 "chain_head_kernel", "chain_enc_kernel")
CHAIN_DEVICE_FLOOR = 0.9
# the widths time_chain times the chain at, by dtype
CHAIN_TIMED = ((torch.bfloat16, (1280, 2048)), (torch.float32, (1920,)))


def chain_calls(gen, cd, dh):
    """time_chain's band call at ``dh``: its inputs and its forward (no
    stash) and dgrad (on the stash forward's activations) as closures."""
    w = decoder_weights(gen, dh=dh, dl=WIDE_DL)
    x, z, g = wide_inputs(gen, BAND, 1, WIDE_DL, CODE, cd)
    args = K2._prepare(x, z, w, CODE, cd)
    dims = K2._dims(args, 5, 3, True)
    st = K2._forward(args, dims, cd, True)[1]
    gs, wd, _ = K2._bwd_operands(args, dims, g, K2.NAME_DGRAD)
    return (dict(w=w, x=x, z=z, g=g, args=args, dims=dims, st=st),
            lambda: K2._forward(args, dims, cd, False),
            lambda: K2._dgrad(args, dims, st, gs, wd, cd))


def chain_device_ms():
    """Device ms a call by kernel (CHAIN_KERNELS, ``torch.profiler``) of
    time_chain's calls, keyed ``"<dtype> <d_hidden> fwd"`` / ``"... dgrad"``.
    Run in a process of its own (:func:`chain_device_child`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_library()
    gen = torch.Generator(device=DEV).manual_seed(15)
    out = {}
    for cd, dhs in CHAIN_TIMED:
        iters = 3 if cd == torch.bfloat16 else 1
        for dh in dhs:
            _, fcall, bcall = chain_calls(gen, cd, dh)
            out[f"{str(cd)[6:]} {dh} fwd"] = kernel_device_ms(fcall, CHAIN_KERNELS, iters=iters)
            out[f"{str(cd)[6:]} {dh} dgrad"] = kernel_device_ms(bcall, CHAIN_KERNELS, iters=iters)
            del fcall, bcall
            torch.cuda.empty_cache()
    return out


_CHAIN_DEVICE = """
import json, sys
sys.path.insert(0, ".")
import chip_smoke
print(json.dumps(chip_smoke.chain_device_ms()), flush=True)
"""


def chain_device_child():
    """:func:`chain_device_ms` in a child process, waited for: a profiler of
    its own (in the default run, after the other phases' profiles, this
    process's profiler returned none or part of the chain's kernels)."""
    torch.cuda.empty_cache()
    r = subprocess.run([sys.executable, "-c", _CHAIN_DEVICE],
                       cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                       text=True, timeout=600)
    if r.returncode:
        raise AssertionError(f"the chain's device times: exit {r.returncode}\n{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def time_chain(gen, rows):
    """The chain at the band chunk (81,920 points, NS 1, a latent of 1,152,
    64 encoded lanes): bf16 d_hidden 1,280 and 2,048, float32 1,920; the
    forward (no stash, as served) and the dgrad on the stash forward's
    activations, each by CUDA events beside its device ms by kernel
    (``torch.profiler``, CHAIN_KERNELS, in a process of its own:
    :func:`chain_device_child`), its plain version, the cuBLAS chain of its
    products (``product_chain``) and its bound.  Returns the four kernel
    rows (bf16 at 1,280 with the 2,048 readings beside, float32 at
    1,920)."""
    kw = dict(n_blocks=5, n_lin_z=3, activate_out=True)
    out = []
    devs = chain_device_child()
    for cd, dhs in CHAIN_TIMED:
        fwd_cases, bwd_cases = rows[cd]
        fr = dict(name=K2.NAME_CHAIN[cd], source="avr_tpu_torch/csrc/resnetfc_chain.cu",
                  replaces="avr_tpu/ops/pallas/resnetfc.py:896", tpu_kernel="fused_resnetfc",
                  cases=fwd_cases, library="the cuBLAS chain of the forward's products")
        br = dict(name=K2.NAME_DGRAD_CHAIN[cd], source="avr_tpu_torch/csrc/resnetfc_chain.cu",
                  replaces="avr_tpu/ops/pallas/resnetfc.py:823", tpu_kernel="_bwd_stash_impl",
                  cases=bwd_cases, library="the cuBLAS chain of the dgrad's products")
        iters = 3 if cd == torch.bfloat16 else 1
        for dh in dhs:
            t, fcall, bcall = chain_calls(gen, cd, dh)
            w, x, z, g, st = t["w"], t["x"], t["z"], t["g"], t["st"]
            k_in = t["dims"]["k_in"]
            fwd_ms = time_ms(fcall, iters=iters, warmup=1)
            fdev = devs[f"{str(cd)[6:]} {dh} fwd"]
            dgrad_ms = time_ms(bcall, iters=iters, warmup=1)
            bdev = devs[f"{str(cd)[6:]} {dh} dgrad"]
            fplain = time_ms(lambda: resnetfc_plain(x, z, w, compute_dtype=cd, code=CODE, **kw),
                             iters=iters, warmup=1)
            bplain = time_ms(lambda: decoder_bwd_matched(x, z, w, st, g, n_blocks=5, n_lin_z=3,
                                                         code=CODE, compute_dtype=cd,
                                                         wgrads=False), iters=iters, warmup=1)
            del t, st, fcall, bcall
            torch.cuda.empty_cache()
            flib = time_ms(product_chain(gen, BAND, dh, WIDE_DL, k_in, cd, False), iters=iters,
                           warmup=1)
            blib = time_ms(product_chain(gen, BAND, dh, WIDE_DL, k_in, cd, True), iters=iters,
                           warmup=1)
            shape = f"N={BAND}, NS=1, d_hidden {dh}, d_latent {WIDE_DL}, k_in {k_in}, 5 blocks, " \
                    f"{str(cd)[6:]}"
            for r, ms, dev, pl, lib, bwd in ((fr, fwd_ms, fdev, fplain, flib, False),
                                             (br, dgrad_ms, bdev, bplain, blib, True)):
                b_ms, b_by = chain_bound(cd, dh, WIDE_DL, k_in, bwd)
                dev = {k: v for k, v in dev.items() if v}
                if sum(dev.values()) < CHAIN_DEVICE_FLOOR * ms:
                    # the profiler missed kernels (seen in the default run, where phase
                    # 12 follows the other phases' profiles): not measured, not a short sum
                    dev = None
                vals = dict(ms=ms, device_ms=sum(dev.values()) if dev else None,
                            device_ms_by_kernel=dev, plain_ms=pl, library_ms=lib, bound_ms=b_ms,
                            bound_by=b_by, shape=shape)
                if dh == dhs[0]:
                    r.update(vals)
                else:
                    r[f"at_d_hidden_{dh}"] = vals
                by = (f"device {vals['device_ms']:.3f}: "
                      f"{', '.join(f'{k} {v:.3f}' for k, v in dev.items())}" if dev else
                      "device not measured: the profiler's kernels summed below "
                      f"{CHAIN_DEVICE_FLOOR:.0%} of the call")
                print(f"kernel {r['name']} {shape}: {ms:.3f} ms ({by}; plain {pl:.3f}, "
                      f"cuBLAS chain {lib:.3f}, bound {b_ms:.3f} by {b_by})")
            del x, z, g
            torch.cuda.empty_cache()
        out += [fr, br]
    return out


def sweep_setup(row, seed):
    """A SweepRow's inputs at the band chunk, drawn from ``seed`` (the same
    bits in any process), its calls by kind (the forward without the stash;
    the dgrad on the chain forward's stash) and each kind's hold: a route's
    forward against the plain version (phase 9's bf16 rule, float32
    WIDE_F32_TOL), its dgrad's dx and dz against ``decoder_bwd_matched`` on
    that stash by relative L2 (bf16 MATCHED_BF16_TOL, float32
    WIDE_F32_TOL)."""
    kw = dict(n_blocks=5, n_lin_z=3, activate_out=True)
    cd, dh, dl, code, ns = row.cd, row.dh, row.dl, row.code, row.ns
    f32 = cd == torch.float32
    gen = torch.Generator(device=DEV).manual_seed(seed)
    w = decoder_weights(gen, dh=dh, dl=dl, code=code)
    x, z, g = wide_inputs(gen, BAND, ns, dl, code, cd)
    args = K2._prepare(x, z, w, code, cd)
    dims = K2._dims(args, 5, 3, True)
    shape = f"{str(cd)[6:]} d_hidden {dh} d_latent {dl} k_in {dims['k_in']} NS={ns} N={BAND}"
    calls, held = {}, {}
    if "forward" in row.times:
        want = resnetfc_plain(x, z, w, compute_dtype=cd, code=code, **kw)
        tol = (WIDE_F32_TOL if f32 else 2.0 ** -7) * max(1.0, float(want.abs().max()))
        if not f32:
            exact = DecoderWeights(*(t.to(cd).float() for t in w))
            ref = resnetfc_plain(x, z.float(), exact, compute_dtype=torch.float32, code=code, **kw)
            tol = max(tol, 2 * max_err(want, ref))
            del ref
        calls["forward"] = lambda: K2._forward(args, dims, cd, False)
        held["forward"] = lambda r, res: {r: check(f"sweep {r} forward {shape}",
                                                   max_err(res[0], want), tol)["max_abs_err"]}
    if "dgrad" in row.times:
        with routes_forced("chain"):
            st = K2._forward(args, dims, cd, True)[1]
        gs, wd, _ = K2._bwd_operands(args, dims, g, K2.NAME_DGRAD)
        matched = decoder_bwd_matched(x, z, w, st, g, n_blocks=5, n_lin_z=3, code=code,
                                      compute_dtype=cd, wgrads=False)[:2]
        calls["dgrad"] = lambda: K2._dgrad(args, dims, st, gs, wd, cd)
        held["dgrad"] = lambda r, res: {
            f"{r} {nm}": check_l2(f"sweep {r} dgrad {nm} {shape}", a, m,
                                  WIDE_F32_TOL if f32 else MATCHED_BF16_TOL,
                                  against="matched")["rel_l2"]
            for nm, a, m in zip(("dx", "dz"), res, matched)}
    return dict(shape=shape, dims=dims, calls=calls, held=held)


def sweep_hold_time(setup, route, name, iters, count, hold=True):
    """``setup``'s ``name`` call on ``route`` (forced): held (with
    ``hold``), then timed ``count`` times back to back; (errors, ms a call
    each time)."""
    with routes_forced(route):
        errs = setup["held"][name](route, setup["calls"][name]()) if hold else {}
        return errs, [time_ms(setup["calls"][name], iters=iters, warmup=1) for _ in range(count)]


# the routes this tree no longer has (resnetfc_kernel and the first wide
# version, retired by this sweep): --chain-sweep --retired=DIR times them in
# DIR, a checkout of a commit that still has them, in a child process
RETIRED = ("mma_sync", "wide")
_RETIRED_CHILD = """
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1])  # the retired tree's avr_tpu_torch
spec = importlib.util.spec_from_file_location("chip_smoke_here", sys.argv[2])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
torch = cs.torch
torch.backends.cuda.matmul.allow_tf32 = False
print("SWEEP " + json.dumps({"library": str(cs._build.load_library()["path"])}), flush=True)
setup = None
for line in sys.stdin:
    req = json.loads(line)
    if req["op"] == "setup":
        row = cs.SweepRow(**dict(req["row"], cd=getattr(torch, req["row"]["cd"]),
                                 code=cs.CodeSpec(**req["row"]["code"])))
        setup = cs.sweep_setup(row, req["seed"])
        reply = {"shape": setup["shape"]}
    else:
        errs, ms = cs.sweep_hold_time(setup, req["route"], req["name"], req["iters"], 2)
        reply = {"errs": errs, "ms": ms}
        if req.get("last"):
            setup = None
            torch.cuda.empty_cache()
    print("SWEEP " + json.dumps(reply), flush=True)
"""


class RetiredRoutes:
    """A child process in a checkout of a tree that still has the RETIRED
    routes, running this file's ``sweep_setup`` / ``sweep_hold_time`` on that
    tree's kernels: the other route's turns of a SweepRow."""

    def __init__(self, tree):
        here = os.path.abspath(__file__)
        self.proc = subprocess.Popen([sys.executable, "-c", _RETIRED_CHILD,
                                      os.path.abspath(tree), here],
                                     cwd=os.path.abspath(tree), stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, text=True)
        self.library = self._reply()["library"]

    def _reply(self):
        for line in self.proc.stdout:
            if line.startswith("SWEEP "):
                return json.loads(line[6:])
        raise AssertionError(f"the retired routes' process ended: {self.proc.wait()}")

    def ask(self, **req):
        self.proc.stdin.write(json.dumps(req) + "\n")
        self.proc.stdin.flush()
        return self._reply()

    def setup(self, row, seed):
        spec = dict(row._asdict(), cd=str(row.cd)[6:], code=dataclasses.asdict(row.code))
        return self.ask(op="setup", row=spec, seed=seed)

    def close(self):
        self.proc.stdin.close()
        self.proc.wait(timeout=120)


def sweep_row(row, seed, retired=None):
    """One SweepRow at the band chunk on the chain and on the other route,
    both forced, each held (``sweep_setup``) and timed in turns (chain,
    other, other, chain; CUDA events), beside the cuBLAS chain of its
    products (``product_chain``) and its bound (``chain_bound``).  A RETIRED
    other route runs in ``retired`` (a RetiredRoutes) on the same inputs;
    without one it is not measured.  ``chain_faster``: the chain's slower
    call beat the other route's faster one."""
    cd, dh, dl, other = row.cd, row.dh, row.dl, row.other
    setup = sweep_setup(row, seed)
    k_in = setup["dims"]["k_in"]
    out = dict(corner=row.corner, shape=setup["shape"], other=other,
               route=K2.forward_route(cd, setup["dims"]["d_latent"], k_in, dh),
               dgrad_route=K2.backward_route(cd, dh, setup["dims"]["d_latent"], k_in))
    away = other in RETIRED
    if away and retired is not None:
        out["other_tree"] = retired.library
        if retired.setup(row, seed)["shape"] != setup["shape"]:
            raise AssertionError(f"sweep {setup['shape']}: the retired tree drew another shape")
    iters = 3 if cd == torch.bfloat16 else 1
    names = list(setup["calls"])
    for name in names:
        errs, first = sweep_hold_time(setup, "chain", name, iters, 1)
        if not away:
            e, mid = sweep_hold_time(setup, other, name, iters, 2)
        elif retired is not None:
            r = retired.ask(op="hold_time", route=other, name=name, iters=iters,
                            last=name == names[-1])
            e, mid = r["errs"], r["ms"]
        else:
            e, mid = {}, None
        errs.update(e)
        last = sweep_hold_time(setup, "chain", name, iters, 1, hold=False)[1]
        chain_ms = first + last
        lib = time_ms(product_chain(torch.Generator(device=DEV).manual_seed(seed), BAND, dh, dl,
                                    k_in, cd, name == "dgrad", ns=row.ns), iters=iters, warmup=1)
        b_ms, b_by = chain_bound(cd, dh, dl, row.code.d_enc, name == "dgrad", row.code.d_raw,
                                 row.ns)
        out[name] = dict(chain_ms=chain_ms, other_ms=mid, errs=errs,
                         chain_faster=None if mid is None else max(chain_ms) < min(mid),
                         library_ms=lib, bound_ms=b_ms, bound_by=b_by)
    print(f"chain sweep {json.dumps(out)}", flush=True)
    return out


def sweep_chain(retired_tree=None, rows=CHAIN_SWEEP, seed=16):
    """``rows`` (CHAIN_SWEEP) by ``sweep_row``, row i's inputs from seed
    ``seed + i``; the RETIRED routes in a checkout ``retired_tree`` (not
    measured without one).  The evidence for the chain's range
    (``forward_route``, ``backward_route``); returns a row a shape."""
    retired = RetiredRoutes(retired_tree) if retired_tree else None
    out = []
    try:
        for i, row in enumerate(rows):
            out.append(sweep_row(row, seed + i, retired))
            torch.cuda.empty_cache()
    finally:
        if retired is not None:
            retired.close()
    return out


def check_bins_large(gen):
    """The binned backward on maps past 1,024 8 x 8 tiles (BIG_MAPS, C 512,
    bf16 and float32): K1's and K5's backward at the band (81,920 points)
    and K3's over 2 steps, against their plain versions at the tolerances
    of check_wide_channels, each bit for bit on a rerun."""
    cases = []
    for cd in (torch.bfloat16, torch.float32):
        bf = cd == torch.bfloat16
        for side in BIG_MAPS:
            kind = f"{side}x{side} ({(side // 8) ** 2} tiles) C={C} {str(cd)[6:]}"
            feat0, pts, proj = proj_inputs(gen, 1, 1, cd, BAND)
            feat = randn(gen, 1, side, side, C, dtype=cd)
            coords = (torch.rand(1, BAND, 2, generator=gen, device=DEV) * 2.2 - 1.1).contiguous()
            g = randn(gen, 1, BAND, C, dtype=cd)
            k5 = lambda f, p: gather_bilinear_projected(f, p, proj)
            p5 = lambda f, p: gather_bilinear_projected_plain(f, p, proj)
            for name, fk, fp, inputs, dname in (
                    ("K1", gather_bilinear, gather_bilinear_plain, (feat, coords), "dcoords"),
                    ("K5", k5, p5, (feat, pts), "dpoints")):
                got, want = grads_of(fk, inputs, g), grads_of(fp, inputs, g)
                cases += [check_l2(f"{name} dfeat {kind} N={BAND}", got[0], want[0],
                                   2.0 ** -7 if bf else 1e-5),
                          check_l2(f"{name} {dname} {kind} N={BAND}", got[1], want[1], 1e-4),
                          check_rerun(f"{name} rerun {kind} N={BAND}", got,
                                      grads_of(fk, inputs, g))]
            inp = march_inputs(gen, 1, dtype=cd)
            inp["feat"] = randn(gen, 1, 1, side, side, C, dtype=cd)
            kw = dict(steps=2, compute_dtype=cd)
            gm = randn(gen, 1, CHUNK, 3)
            f = lambda fn: (lambda *t: fn(inp["proj"], *t, **kw))
            with march_routed(cd, backward=True):
                got = grads_of(f(fused_lstm_march), tuple(inp[k] for k in MARCH_KEYS), gm)
            want = grads_of(f(lstm_march_plain), tuple(inp[k] for k in MARCH_KEYS), gm)
            cases += [check_l2(f"K3 {nm} {kind} steps=2", a, b, 2e-2 if bf else 1e-3)
                      for nm, a, b in zip(MARCH_GRADS, got, want)]
            with march_routed(cd, backward=True):
                again = grads_of(f(fused_lstm_march), tuple(inp[k] for k in MARCH_KEYS), gm)
            cases.append(check_rerun(f"K3 rerun {kind} steps=2", got, again))
            del feat0, feat, pts, proj, coords, g, inp, got, want, again
            torch.cuda.empty_cache()
    worst = max((c for c in cases if c["tol"]),
                key=lambda c: c.get("rel_l2", c["max_abs_err"]) / c["tol"])
    print(f"bins past 1,024 tiles: K1, K5 and K3 backward on {BIG_MAPS} maps, {len(cases)} cases "
          f"within tolerance; worst against its tolerance {worst['case']}")
    return cases


CUSTOM_SIDE = 320  # the custom encoder's full-resolution map: 40 x 40 = 1,600 tiles


def check_custom_encoder_large():
    """Phase 9's custom-encoder case (``OPTION_CASES["custom_encoder"]``, its
    latent map the view's full resolution) for one bf16 train step on a
    synthetic CUSTOM_SIDE^2 view: K1's backward bins a 320 x 320 map.  The
    loss finite, the parameters finite, K1's backward launched."""
    model = option_model("custom_encoder", torch.bfloat16, DEV)
    opt = make_optimizer(1e-4)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, LossParams(loss_mode="both"))
    tb = train_batch(DEV, side=CUSTOM_SIDE)
    torch.cuda.synchronize()
    _build.reset_launches()
    t = time.perf_counter()
    state, m = step(state, *tb, (0, 1))
    loss = float(m["loss"])
    ms = (time.perf_counter() - t) * 1e3
    counts = dict(_build.launches)
    finite = all(torch.isfinite(p).all() for p in state.params.values())
    if not np.isfinite(loss) or not finite or not counts.get("gather_bilinear_bwd"):
        raise AssertionError(f"custom encoder at {CUSTOM_SIDE}^2: loss {loss}, parameters finite "
                             f"{finite}, launches {counts}")
    res = dict(side=CUSTOM_SIDE, tiles=(CUSTOM_SIDE // 8) ** 2, loss=loss, ms=ms,
               skipped=int(m["notfinite"]), launches=counts)
    print(f"custom encoder at {CUSTOM_SIDE}^2 ({res['tiles']} tiles): {res}")
    del model, opt, state, step
    torch.cuda.empty_cache()
    return res


# the chain's rows of the kernels line: forward and dgrad counters by dtype
CHAIN_NAMES = (*K2.NAME_CHAIN.values(), *K2.NAME_DGRAD_CHAIN.values())


def run_chain():
    """Phase 12: the chain against its plain versions and timed, the bins
    past 1,024 tiles, a custom-encoder step on a 320^2 view, then the
    chain's slice (``run_wide_slice(chain=True)``).  Returns the kernel
    rows (each with its launches on the slice), the report and the
    launches."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(15)
    kernels = time_chain(gen, check_chain(gen))
    bins = check_bins_large(gen)
    custom = check_custom_encoder_large()
    res, launches = run_wide_slice(chain=True)
    res.update(bins=bins, custom_encoder=custom)
    for k in kernels:
        by_case = {case: counts.get(k["name"], 0) for case, counts in launches.items()}
        if not sum(by_case.values()):
            raise AssertionError(f"{k['name']} was never launched on the chain's slice")
        k.update(chain=sum(by_case.values()), chain_by_case=by_case)
    res["seconds_phase"] = time.perf_counter() - t0
    print(f"chain launches: {launches}; phase {res['seconds_phase']:.1f} s")
    return kernels, res, launches


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
    if "--fit" in sys.argv[1:]:
        res, launches = run_fit()
        print_fit(res, launches)
        print(json.dumps({"fit": res, "launches": launches}))
        return 0
    if "--cli" in sys.argv[1:]:
        res, launches = run_cli()
        print_cli(res, launches)
        print(json.dumps({"cli": res, "launches": launches, "card": smi}))
        print(smi)
        return 0
    if "--parallel" in sys.argv[1:]:
        res, launches = run_parallel(smi)
        print_parallel(res, launches)
        print(json.dumps({"parallel": res, "launches": launches, "card": smi}))
        print(smi)
        return 0
    if "--wide" in sys.argv[1:]:
        kernels, res, launches = run_wide()
        print(json.dumps({"wide": res, "kernels": [{k: v for k, v in r.items() if k != "cases"}
                                                    for r in kernels],
                          "launches": launches, "card": smi}))
        print(smi)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if "--chain" in sys.argv[1:] or "--chain-sweep" in sys.argv[1:]:
        out = {"card": smi}
        if "--chain-sweep" in sys.argv[1:]:
            out["sweep"] = sweep_chain(next((a.split("=", 1)[1] for a in sys.argv[1:]
                                             if a.startswith("--retired=")), None))
        if "--chain" in sys.argv[1:]:
            kernels, res, launches = run_chain()
            out.update(chain=res, launches=launches,
                       kernels=[{k: v for k, v in r.items() if k != "cases"} for r in kernels])
        print(json.dumps(out))
        print(smi)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if "--options" in sys.argv[1:] or "--quality" in sys.argv[1:]:
        out = {"card": smi}
        if "--options" in sys.argv[1:]:
            res, launches = run_options()
            print_options(res, launches, smi)
            out.update(options=res, options_launches=launches)
        if "--quality" in sys.argv[1:]:
            res, launches = run_quality()
            print_quality(res, launches, smi)
            out.update(quality=res, quality_launches=launches)
        print(json.dumps(out))
        print(smi)
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
    # K3's float32 rows: the forward runs on the float32 frames and step, the
    # walk on the step
    k3_f32 = {"K3 forward": (K3.NAME_F32, ("serve_adaptive_float32",
                                           "train_adaptive_float32_step")),
              "K3 walk + bins + reduce": (K3.NAME_BWD_F32, ("train_adaptive_float32_step",))}
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
    fit_res, fit_launches = run_fit()
    print_fit(fit_res, fit_launches)
    train["fit"] = {"launches": fit_launches}
    cli_res, cli_launches = run_cli()
    print_cli(cli_res, cli_launches)
    par_res, par_launches = run_parallel(smi)
    print_parallel(par_res, par_launches)
    opt_res, opt_launches = run_options()
    print_options(opt_res, opt_launches, smi)
    q_res, q_launches = run_quality()
    print_quality(q_res, q_launches, smi)
    wide_kernels, wide_res, wide_launches = run_wide()
    kernels += wide_kernels
    chain_kernels, chain_res, chain_launches = run_chain()
    kernels += chain_kernels
    fill_k2_chains(kernels)
    results = {"serve": serve, "train": train, "float32": float32, "fit": fit_res,
               "cli": dict(cli_res, launches=cli_launches),
               "parallel": dict(par_res, launches=par_launches),
               "options": dict(opt_res, launches=opt_launches),
               "quality": dict(q_res, launches=q_launches),
               "wide": dict(wide_res, launches=wide_launches),
               "chain": dict(chain_res, launches=chain_launches),
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
    # K3's float32 kernels (the kernels line's kept_f32 rows): launched on
    # their float32 paths
    for row, (name, paths) in k3_f32.items():
        by_path = {path: launches_f32[path].get(name, 0) for path in paths}
        if not all(by_path.values()):
            raise AssertionError(f"{name} was not launched on every float32 path: {by_path}")
        float32["rows"][row].update(launches=sum(by_path.values()), launches_by_path=by_path,
                                    route="cuda", source="avr_tpu_torch/csrc/march.cu")

    for k in kernels:
        plain = [c for c in k["cases"] if c.get("against") == "plain"]
        err = max(c["max_abs_err"] for c in plain)
        # K2's forward counts under two names (without and with stash), K7
        # under two (the uniform draw and its raw bits)
        names = [k["name"]] + {K2.NAME: [K2.NAME_STASH], K7.NAME: [K7.NAME_BITS]}.get(k["name"], [])
        paths = (launches_f32 if k["name"] in (K2.NAME_F32, K2.NAME_DGRAD_F32, K2.NAME_WGRAD_F32)
                 else wide_launches if k["name"] in WIDE_NAMES
                 else chain_launches if k["name"] in CHAIN_NAMES else launches)
        by_path = {path: sum(counts.get(n, 0) for n in names) for path, counts in paths.items()}
        if not sum(by_path.values()):
            raise AssertionError(f"{k['name']} was never launched on a main path")
        # phase 7's cases (each dtype's own), under the row's names
        cli_counts = {case: sum(counts.get(n, 0) for n in names)
                      for case, counts in cli_launches.items()}
        # phase 8's cases (the sharded steps, each rank's own)
        par_counts = {case: sum(counts.get(n, 0) for n in names)
                      for case, counts in par_launches.items()}
        # phase 9's cases (train step and served frame), phase 10's calls
        opt_counts = {case: sum(v for key, v in counts.items() if key.split("_", 1)[1] in names)
                      for case, counts in opt_launches.items()}
        q_counts = {case: sum(counts.get(n, 0) for n in names)
                    for case, counts in q_launches.items()}
        k.update(route="cuda", launches=sum(by_path.values()), launches_by_path=by_path,
                 max_abs_err=err, max_err=err, tol=max(c["tol"] for c in plain),
                 kernel_ms=k["ms"], cli=sum(cli_counts.values()), cli_by_case=cli_counts,
                 parallel=sum(par_counts.values()), parallel_by_case=par_counts,
                 options=sum(opt_counts.values()), options_by_case=opt_counts,
                 quality=sum(q_counts.values()), quality_by_case=q_counts)
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
