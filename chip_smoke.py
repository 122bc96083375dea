#!/usr/bin/env python3
"""On-card smoke test of the avr_tpu_torch port (one NVIDIA Hopper GPU).

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. The card (``nvidia-smi`` name and power limit), torch/CUDA versions, and
   the kernel library build from ``avr_tpu_torch/csrc`` (nvcc, sm_90a).
2. Kernels: each hand-written kernel against its plain PyTorch version on
   the same inputs at the serving path's shapes, with its tolerance; times
   (CUDA events) of the kernel, the plain version and, where one PyTorch
   call computes the same function, that call; the least time the card
   could take (bytes over 3.35 TB/s or operations over the type's peak).
3. Slice: the full-width ``conf/default_mv.conf`` model (bf16, seeded random
   weights) encodes one 128x128 source view and renders 3 orbit frames of
   128x128 through ``evaluation.generate_video``; the launch counters are
   reset just before and read just after, and must show every kernel ran.
   Then a small render (2 march steps, float32) through the kernels is held
   against the same model's plain path on the CPU.

Prints the kernel table as one JSON line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from avr_tpu_torch.evaluation import generate_video, render_full_image
from avr_tpu_torch.models.wrapper import make_model
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.ops.kernels.gather import gather_bilinear, gather_bilinear_plain
from avr_tpu_torch.ops.kernels.march import (fused_lstm_march, lstm_march_plain,
                                             pack_projection)
from avr_tpu_torch.ops.kernels.resnetfc import (CodeSpec, DecoderWeights, fused_resnetfc,
                                                resnetfc_plain)
from avr_tpu_torch.utils.geometry import get_world_rays, orbit_cam2world, pixel_grid

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12  # dense tensor-core peak
F32_FLOPS = 67e12  # outside the tensor cores
SIDE, LATENT, C = 128, 64, 512
BAND, CHUNK, STEPS, HIDDEN = 81_920, 4_096, 10, 16
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
    for n in (BAND, CHUNK):
        # [-1.1, 1.1]: interior taps, the border clamp and out-of-range points
        coords = (torch.rand(1, n, 2, generator=gen, device=DEV) * 2.2 - 1.1).contiguous()
        # bitwise equal by construction (same rounded ops in the same order);
        # the tolerance allows one bf16 rounding flip of a value of ~4
        cases.append(check(f"N={n} bf16", max_err(gather_bilinear(feat, coords),
                                                  gather_bilinear_plain(feat, coords)), 2e-2))
    coords_band = (torch.rand(1, BAND, 2, generator=gen, device=DEV) * 2.2 - 1.1).contiguous()
    ms = time_ms(lambda: gather_bilinear(feat, coords_band))
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
                replaces="avr_tpu/ops/pallas/gather.py:395", tpu_kernel="gather_bilinear_windowed",
                shape=f"latent 1x{LATENT}x{LATENT}x{C} bf16, N={BAND}", cases=cases,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)


def decoder_weights(gen, dtype=torch.float32, dh=512, nb=5, nlz=3):
    lin = lambda o, i: randn(gen, o, i, scale=i ** -0.5)
    return DecoderWeights(
        lin(dh, CODE.d_enc), randn(gen, dh, scale=0.1),
        torch.stack([lin(dh, C) for _ in range(nlz)]), randn(gen, nlz, dh, scale=0.1),
        torch.stack([lin(dh, dh) for _ in range(nb)]), randn(gen, nb, dh, scale=0.1),
        torch.stack([lin(dh, dh) for _ in range(nb)]), randn(gen, nb, dh, scale=0.1),
        lin(4, dh), randn(gen, 4, scale=0.1))


def decoder_flops(n, ns, dh=512, nb=5, nlz=3):
    return 2 * n * (ns * (CODE.d_enc * dh + nlz * C * dh + 2 * nlz * dh * dh)
                    + 2 * (nb - nlz) * dh * dh + dh * 4)


def check_resnetfc(gen):
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
        (CHUNK, 2, torch.bfloat16, 2.0 ** -7),
        # f32 operands: FMA order against cuBLAS over 13 chained products
        (CHUNK, 1, torch.float32, 1e-4),
    ):
        x = (torch.rand(ns, n, CODE.d_raw, generator=gen, device=DEV) * 2 - 1).contiguous()
        z = randn(gen, ns, n, C, dtype=cd)
        got = fused_resnetfc(x, z, w, compute_dtype=cd, **kw)
        want = resnetfc_plain(x, z, w, compute_dtype=cd, **kw)
        tol = rel * max(1.0, float(want.abs().max()))
        cases.append(check(f"N={n} NS={ns} {str(cd)[6:]}", max_err(got, want), tol))
    x = (torch.rand(1, BAND, CODE.d_raw, generator=gen, device=DEV) * 2 - 1).contiguous()
    z = randn(gen, 1, BAND, C, dtype=torch.bfloat16)
    run = lambda f: f(x, z, w, compute_dtype=torch.bfloat16, **kw)
    ms, plain_ms = time_ms(lambda: run(fused_resnetfc)), time_ms(lambda: run(resnetfc_plain))
    wbytes = sum(t.numel() for t in w) * 2
    b_ms, b_by = bound(x.numel() * 4 + z.numel() * 2 + wbytes + BAND * 4 * 4,
                       decoder_flops(BAND, 1), BF16_FLOPS)
    return dict(name="fused_resnetfc", source="avr_tpu_torch/csrc/resnetfc.cu",
                replaces="avr_tpu/ops/pallas/resnetfc.py:896", tpu_kernel="fused_resnetfc",
                shape=f"N={BAND}, NS=1, d_hidden 512, 5 blocks, bf16", cases=cases,
                ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by)


def march_inputs(gen, ns, dtype=torch.bfloat16):
    """Rays of a 128x128 camera at z = 1.3 looking at the origin; the source
    views are that camera, slightly rotated per view."""
    c2w = torch.diag(torch.tensor([1.0, -1.0, -1.0, 1.0]))
    c2w[2, 3] = 1.3
    K = torch.tensor([[1.09375, 0, 0.5], [0, 1.09375, 0.5], [0, 0, 1]])
    xy = torch.from_numpy(pixel_grid(64, 64).reshape(1, CHUNK, 2))
    ros, rds = get_world_rays(xy, K[None], c2w.expand(1, CHUNK, 4, 4))
    d0 = 0.8 + 0.05 * torch.randn(1, CHUNK, 1, generator=torch.Generator().manual_seed(1))
    poses = []
    for v in range(ns):
        a = 0.1 * v
        rot = torch.tensor([[np.cos(a), -np.sin(a), 0, 0], [np.sin(a), np.cos(a), 0, 0],
                            [0, 0, 1, 0], [0, 0, 0, 1]], dtype=torch.float32)
        src = c2w @ rot
        w2c_rot = src[:3, :3].T
        poses.append(torch.cat([w2c_rot, (-w2c_rot @ src[:3, 3])[:, None]], dim=1))
    focal = torch.tensor([[1.09375 * SIDE, -1.09375 * SIDE]])
    proj = pack_projection(torch.stack(poses), focal, torch.tensor([[SIDE / 2, SIDE / 2]]),
                           torch.tensor([2 * LATENT / (LATENT - 1)] * 2),
                           torch.tensor([float(SIDE)] * 2)).reshape(1, ns, 16)
    H4 = 4 * HIDDEN
    return dict(proj=proj.to(DEV), coords0=(ros + rds * d0).to(DEV).contiguous(),
                rds=rds.to(DEV).contiguous(),
                feat=randn(gen, 1, ns, LATENT, LATENT, C, dtype=dtype),
                w_ih=randn(gen, C, H4, scale=C ** -0.5), w_hh=randn(gen, HIDDEN, H4, scale=0.25),
                bias=randn(gen, H4, scale=0.1), w_out=randn(gen, HIDDEN, 1, scale=0.05),
                b_out=randn(gen, 1, scale=0.01))


def check_march(gen):
    cases = []
    # (views, steps, early-stop eps, tolerance and why)
    for ns, steps, eps, tol in (
        # 2 steps: gate sums in another order and one-ulp transcendental
        # differences, through a bf16-rounded hidden state (2^-8 relative)
        (1, 2, 0.0, 1e-3), (2, 2, 0.0, 1e-3), (1, 2, 0.02, 1e-3),
        # 10 steps: the recurrence is chaotic; finite and a loose bound
        (1, STEPS, 0.0, 5e-2),
    ):
        inp = march_inputs(gen, ns)
        got = fused_lstm_march(**inp, steps=steps, early_stop_eps=eps,
                               compute_dtype=torch.bfloat16)
        want = lstm_march_plain(**inp, steps=steps, early_stop_eps=eps,
                                compute_dtype=torch.bfloat16)
        if not torch.isfinite(got).all():
            raise AssertionError(f"march NS={ns} steps={steps}: non-finite output")
        cases.append(check(f"R={CHUNK} NS={ns} steps={steps} eps={eps}", max_err(got, want), tol))
    inp = march_inputs(gen, 1)
    kw = dict(steps=STEPS, compute_dtype=torch.bfloat16)
    ms = time_ms(lambda: fused_lstm_march(**inp, **kw))
    plain_ms = time_ms(lambda: lstm_march_plain(**inp, **kw))
    flops = CHUNK * STEPS * (8 * C + 2 * C * 4 * HIDDEN + 2 * HIDDEN * 4 * HIDDEN + 2 * HIDDEN)
    b_ms, b_by = bound(inp["feat"].numel() * 2 + CHUNK * 3 * 4 * 3 + C * 4 * HIDDEN * 2,
                       flops, BF16_FLOPS)
    return dict(name="fused_lstm_march", source="avr_tpu_torch/csrc/march.cu",
                replaces="avr_tpu/ops/pallas/march.py:703", tpu_kernel="fused_lstm_march",
                shape=f"R={CHUNK} x {STEPS} steps, NS=1, C={C}, hidden {HIDDEN}, bf16",
                cases=cases, ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by)


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


def run_slice(frames=3):
    model = make_model(dtype=torch.bfloat16, seed=0, device=DEV)
    batch = scene_batch()
    generate_video(model, batch, 1, 1.3, render_chunk=CHUNK, device=DEV)  # warm-up: cuDNN/cuBLAS set-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    video = generate_video(model, batch, frames, 1.3, render_chunk=CHUNK, device=DEV)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(_build.launches)
    per_frame = SIDE * SIDE // CHUNK
    want = {"fused_lstm_march": frames * per_frame, "gather_bilinear": 2 * frames * per_frame,
            "fused_resnetfc": 2 * frames * per_frame}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    if len(video) != frames or any(f.shape != (SIDE, SIDE, 3) for f in video):
        raise AssertionError("wrong frame count or shape")
    # outside the counted run: frame 0 as floats (finite, in [0, 1], the
    # image the video holds), then the time of one frame's render alone
    poses = orbit_cam2world(frames, 1.3)
    intr = torch.as_tensor(batch["intrinsics"][:, 0])
    with torch.inference_mode():
        cond = encode_scene(model, batch, DEV)
        out = render_full_image(model, cond, intr, poses[:1], SIDE, (0, 0), CHUNK, DEV)
    for name in ("rgb_coarse", "rgb_fine", "depth_coarse", "depth_fine", "acc"):
        if not torch.isfinite(getattr(out, name)).all():
            raise AssertionError(f"{name} has non-finite values")
    rgb = out.rgb_fine.float()
    if rgb.min() < 0 or rgb.max() > 1 + 1e-6:
        raise AssertionError(f"rgb outside [0, 1]: {float(rgb.min())}..{float(rgb.max())}")
    img = np.clip(rgb[0].reshape(SIDE, SIDE, 3).cpu().numpy() * 255.0, 0, 255).astype(np.uint8)
    if np.abs(img.astype(int) - video[0].astype(int)).max() > 1:
        raise AssertionError("video frame 0 differs from its float render")
    render = lambda i: render_full_image(model, cond, intr, poses[i % frames][None], SIDE,
                                         (0, i), CHUNK, DEV)
    frame_ms = []
    for i in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        render(i)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
    return dict(frames=frames, video_seconds=seconds, frame_ms=frame_ms,
                ms_per_frame=float(np.median(frame_ms)),
                rays_per_s=SIDE * SIDE / float(np.median(frame_ms)) * 1e3, launches=counts,
                acc_mean=float(out.acc.mean()), rgb_mean=float(rgb.mean())), render


def profile_frame(render, out_dir="traces"):
    """One frame under ``torch.profiler``: device time by operation, the
    device's busy share of the frame's wall time, and a chrome trace."""
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
    ours = ("gather_bilinear_kernel", "resnetfc_kernel", "lstm_march_kernel")
    kernel_us = sum(r[1] for r in rows if any(o in r[0] for o in ours))
    print(f"profile: frame wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"({busy_us / wall_us:.3f} of wall), port kernels {kernel_us / 1e3:.3f} ms")
    for key, us, count in rows[:25]:
        print(f"  {us / 1e3:9.3f} ms  x{count:<5d} {key[:100]}")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "frame_trace.json"))
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
                busy_share=busy_us / wall_us, port_kernels_ms=kernel_us / 1e3,
                top=[dict(op=k[:100], ms=us / 1e3, count=c) for k, us, c in rows[:25]])


def check_small_reference(sl=16):
    """A 16x16 render, 2 march steps, float32: kernels on the card against
    the same weights' plain path on the CPU."""
    outs = []
    for dev in (DEV, torch.device("cpu")):
        model = make_model(dtype=torch.float32, seed=0, device=dev)
        model.renderer_cfg = dataclasses.replace(model.renderer_cfg, raymarch_steps=2)
        batch = scene_batch()
        with torch.inference_mode():
            cond = encode_scene(model, batch, dev)
            c2w = torch.as_tensor(batch["cam2world"][:, 0])
            outs.append(render_full_image(model, cond, torch.as_tensor(batch["intrinsics"][:, 0]),
                                          c2w, sl, (0, 7), 128, dev))
    # f32 everywhere; the encoder's convolutions (cuDNN vs CPU) and the
    # decoder's FMA order differ in the last bits, and two march steps
    # amplify them a little
    return [check(f"{name} {sl}x{sl} f32 card vs CPU",
                  max_err(getattr(outs[0], name).cpu(), getattr(outs[1], name)), 2e-3)
            for name in ("rgb_coarse", "rgb_fine", "depth_coarse", "depth_fine", "acc")]


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
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    gen = torch.Generator(device=DEV).manual_seed(0)
    kernels = [check_gather(gen), check_resnetfc(gen), check_march(gen)]
    for k in kernels:
        print(f"kernel {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, bound "
              f"{k['bound_ms']:.4f} by {k['bound_by']}) cases {k['cases']}")

    slice_, render = run_slice()
    print(f"slice: {slice_}")
    if "--profile" in sys.argv[1:]:
        slice_["profile"] = profile_frame(render)
    for c in check_small_reference():
        print(f"reference: {c}")

    for k in kernels:
        plain = [c for c in k["cases"] if c["against"] == "plain"]
        err = max(c["max_abs_err"] for c in plain)
        k.update(route="cuda", launches=slice_["launches"][k["name"]], max_abs_err=err,
                 max_err=err, tol=max(c["tol"] for c in plain), kernel_ms=k["ms"])
    print(json.dumps({"kernels": kernels, "slice": slice_, "card": smi}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
