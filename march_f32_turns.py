"""K3's float32 kernels (the march forward and its backward walk) in
checkouts of the repo, in turns, and with ``--probe`` what holds them.

    python3 march_f32_turns.py CHECKOUT [CHECKOUT ...]
    python3 march_f32_turns.py --probe CHECKOUT [CHECKOUT ...]

Each CHECKOUT is a tree of the repo (a ``git archive`` of a commit) with its
own ``chip_smoke.py``.  In each, in the order given and then in reverse, a
process of its own (``march_turns.main``, the runner the turns scripts
share) builds that tree's kernels and, from that tree's ``chip_smoke``:

- times K3's float32 forward (``fused_lstm_march``, ``compute_dtype``
  float32, NS 1, C 512, hidden 16) at a served chunk (4,096 rays x 10 steps,
  ``chip_smoke.check_march``'s serving draw) and at the train step's call
  (4 x 4,096 rays x 10 steps under autograd, with the saved rows, step head
  ``TIMED_HEAD``): the device time of its kernel (``torch.profiler``), the
  call back to back (CUDA events), digests of the end points and of the
  saved rows (equal digests: equal bits), and at the served chunk a loop of
  about a second with the SM clock and power that ``nvidia-smi`` read;
- times K3's float32 backward at the train step's call on two draws:
  ``chip_smoke.check_march_bwd``'s timed inputs (its generator's state at
  that draw, ``TIMED_STATE``) and ``integral_turns.py``'s seed 14: the
  device time of the walk, of the bins, of the partial sums' reduction and
  of the wgrad (dW_ih and dW_hh), a digest of each of the eight gradients,
  and on the first draw a loop of about a second with the SM clock and the
  walk's device time profiled over 1, 2 and 3 calls;
- serves three float32 frames of the adaptive renderer
  (``chip_smoke.run_slice``): ms a frame;
- runs a float32 adaptive train step (loss and gradients, as
  ``chip_smoke.check_adaptive_rerun`` runs it): ms wall (median of 5 after
  2 of warm-up) and the device time of one step, all of it and K3's float32
  kernels'.

``--probe`` runs once in each checkout, not in turns: the tree's float32
forward at both shapes and its walk on both draws beside probe kernels
compiled from this file into a temporary directory (not into the kernel
library): (a) an empty kernel at the warp-per-ray kernels' launch geometry
(the forward: a CTA of 8 warps a ray each, 163,072 B of shared memory; the
walk: 132 persistent CTAs of 8 warps, 183,296 B); (b) the warp-per-ray
forward's gather alone (the same lanes, taps and blend, at the points the
forward saved); (c) its gate product alone (``gate_dots``: W_ih and a
feature row in shared memory, one weight read per FMA); (d) the walk on
each draw with the other draw's cotangent (which input moves its time);
(e) cycles by phase: a copy of the checkout's port with ``csrc/march.cu``
stamped (``STAMPS`` for the warp-per-ray kernels, ``STAMPS_TILES`` for the
ray-tile kernels: exact edits of the source; a tree that matches neither
prints ``{"stamps": "source does not match"}``), built and run in a
directory of its own: ``clock64()`` sums a warp, kept by one CTA, read back
by ``cudaMemcpyFromSymbol``; the stamps cost a few percent of the kernels'
time.  With ``--capture`` the probe also runs ``chip_smoke.main``'s checks
up to the timed draw and prints its generator's state.

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

# chip_smoke.check_march_bwd's timed draw: the state of chip_smoke.main's
# generator (seed 0) there, read by ``--probe --capture`` on an H100 (the
# CUDA generator's seed and offset; the same in every tree whose checks
# before it draw the same numbers)
TIMED_STATE = [0] * 8 + [80, 86, 0, 0, 0, 0, 0, 0]  # seed 0, offset 22,096

# run before each of the snippets below: the two draws of the train step's call, the
# backward's kernels by part, the digests
_COMMON = r"""
import hashlib, json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.ops.kernels import march as K3

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
f32 = torch.float32
# the float32 kernels of either tree: the warp-per-ray ones, the ray-tile ones
FWD = ("lstm_march_kernel", "lstm_march_f32_tile_kernel")
WALK = ("lstm_march_bwd_kernel", "lstm_march_f32_walk_kernel")
BINS = ("gather_bin_",)
PARTIALS = ("lstm_march_partials_kernel",)
WGRAD = ("resnetfc_wgrad_f32_kernel", "resnetfc_wgrad_reduce_kernel")
GRADS = ("dcoords0", "drds", "dfeat", "dw_ih", "dw_hh", "dbias", "dw_out", "db_out")


def digest(ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def dev_ms(fn, names, iters=5):
    return sum(cs.kernel_device_ms(fn, names, iters).values())


def as_f32(inp):
    return {k: (v.float() if v.is_floating_point() else v) for k, v in inp.items()}


def draws(state):
    # the train step's call (4 x 4,096 rays x 10 steps, step head TIMED_HEAD)
    # on chip_smoke's timed draw and on integral_turns.py's
    out = {}
    if state is not None:
        gen = torch.Generator(device=cs.DEV)
        gen.set_state(torch.tensor(state, dtype=torch.uint8))
        inp = cs.march_inputs(gen, 1, sb=cs.SB_TRAIN, w_out_scale=cs.TIMED_HEAD)
        out["chip_smoke"] = (as_f32(inp), cs.randn(gen, cs.SB_TRAIN, cs.CHUNK, 3))
    inp = cs.march_inputs(torch.Generator(device=cs.DEV).manual_seed(14), 1, sb=cs.SB_TRAIN,
                          w_out_scale=cs.TIMED_HEAD)
    g = cs.randn(torch.Generator(device=cs.DEV).manual_seed(15), cs.SB_TRAIN, cs.CHUNK, 3)
    out["integral_turns"] = (as_f32(inp), g)
    return out


def backward(inp, g):
    fn = lambda *t: cs.fused_lstm_march(inp["proj"], *t, steps=cs.STEPS, compute_dtype=f32)
    return cs.grads_of(fn, tuple(inp[k] for k in cs.MARCH_KEYS), g, keep=True)
"""

# run inside a checkout: its own chip_smoke and kernels, whatever its commit
_TURN = r"""
from avr_tpu_torch.profiling.wgrad_timing import SMI_FIELDS, sustained


def loop(fn):
    r = sustained(fn, 1.0, SMI_FIELDS)
    return dict(loop_ms=r["ms"], sm_mhz=r["clocks.sm"], power_w=r["power.draw"])


state = json.loads(sys.argv[2])
_build.load_library()
res = {"checkout": sys.argv[1]}
kw = dict(steps=cs.STEPS, compute_dtype=f32)
# the forward at a served chunk (check_march's serving draw) and at the
# train step's call with the saved rows
serve = as_f32(cs.march_inputs(torch.Generator(device=cs.DEV).manual_seed(0), 1))
train = as_f32(cs.march_inputs(torch.Generator(device=cs.DEV).manual_seed(3), 1, sb=cs.SB_TRAIN,
                               w_out_scale=cs.TIMED_HEAD))
for label, inp in (("fwd serve", serve), ("fwd train", train)):
    if label == "fwd serve":
        run = lambda: cs.fused_lstm_march(**inp, **kw)
    else:
        leaves = {k: v.requires_grad_(True) if k != "proj" else v for k, v in inp.items()}
        run = lambda: cs.fused_lstm_march(**leaves, **kw)
    out = run()
    # the saved rows: the wrapper's own forward with save=True
    a = dict(proj=inp["proj"], coords0=inp["coords0"], rds=inp["rds"], feat=inp["feat"],
             w_ih=inp["w_ih"].detach(), w_hh=inp["w_hh"].detach(), bias=inp["bias"].detach(),
             w_out=inp["w_out"].detach().reshape(-1), b_out=inp["b_out"].detach().reshape(1))
    a = {k: v.detach().contiguous() for k, v in a.items()}
    pts, aux = K3._forward(a, cs.STEPS, 0.0, f32, save=True)
    res[label] = dict(device_ms=dev_ms(run, FWD, iters=20), call_ms=cs.time_ms(run, iters=20),
                      digest=digest([out]), rows_digest=digest([aux]),
                      same_as_call=bool(torch.equal(pts, out.detach())))
    if label == "fwd serve":
        res[label].update(**loop(run))
    del out, pts, aux
# the backward at the train step's call on both draws
for name, (inp, g) in draws(state).items():
    got, run = backward(inp, g)
    by = cs.kernel_device_ms(run, WALK + BINS + PARTIALS + WGRAD, iters=3)
    r = dict(walk_ms=sum(by[k] for k in WALK), bins_ms=by[BINS[0]], partials_ms=by[PARTIALS[0]],
             wgrad_ms=sum(by[k] for k in WGRAD),
             digests={n: digest([t]) for n, t in zip(GRADS, got)})
    r["walk_bins_partials_ms"] = r["walk_ms"] + r["bins_ms"] + r["partials_ms"]
    if name == "chip_smoke":
        r.update(**loop(run))
        # the walk profiled over 1, 2 and 3 calls (chip_smoke.py profiles 2)
        r["walk_ms_profiled_over"] = {n: dev_ms(run, WALK, n) for n in (1, 2, 3)}
    res["bwd " + name] = r
    del got, run
    torch.cuda.empty_cache()
r, _ = cs.run_slice("adaptive", dtype=f32)
res["serve adaptive f32"] = dict(frame_ms=[r["ms_per_frame"], min(r["frame_ms"]),
                                           max(r["frame_ms"])])
# a float32 adaptive train step: loss and gradients, as check_adaptive_rerun runs it
model = cs.path_model("adaptive", f32, cs.DEV)
params = dict(model.named_parameters())
batch = cs.train_batch(cs.DEV)
step = lambda: cs.loss_and_grads(model, params, cs.LossParams(loss_mode="both"), *batch, (0, 5))
for _ in range(2):
    step()
torch.cuda.synchronize()
walls = []
for _ in range(5):
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    walls.append((time.perf_counter() - t0) * 1e3)
from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    step()
    torch.cuda.synchronize()
rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
k3 = lambda names: sum(e.self_device_time_total for e in rows
                       if any(n in e.key for n in names)) / 1e3
res["train adaptive f32 step"] = dict(
    wall_ms=sorted(walls)[2], wall_range=[min(walls), max(walls)],
    device_ms=sum(e.self_device_time_total for e in rows) / 1e3,
    k3_fwd_device_ms=k3(FWD), k3_walk_device_ms=k3(WALK))
print(json.dumps(res), flush=True)
"""

# --probe, run once in a checkout: its float32 kernels beside the floors
_PROBE = r"""
import ctypes, os, shutil, subprocess, tempfile

SRC = '''
#include "common.cuh"
__global__ void probe_empty_kernel() {}
extern "C" int probe_empty(unsigned blocks, unsigned threads, int smem, void* stream) {
  cudaFuncSetAttribute(probe_empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  probe_empty_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
// the warp-per-ray forward's gather alone: a warp a ray, 8 a CTA, each step's
// point read from the saved rows (pts: rays x steps x 3), the view sum and
// mean into the warp's row, one value a lane kept
__global__ void __launch_bounds__(256) probe_gather_kernel(
    const float* __restrict__ pts, const float* __restrict__ proj, const float* __restrict__ feat,
    float* __restrict__ out, int SB, int R, int NS, int H, int W, int C, int steps) {
  extern __shared__ __align__(16) float v_s[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long ray = (long long)blockIdx.x * 8 + warp;
  if (ray >= (long long)SB * R) return;
  const int sb = (int)(ray / R), groups = C / 4;
  float* v_w = v_s + warp * C;
  float chk = 0.f;
  for (int step = 0; step < steps; ++step) {
    const float* p = pts + ((size_t)ray * steps + step) * 3;
    const float cx = p[0], cy = p[1], cz = p[2];
    for (int view = 0; view < NS; ++view) {
      const Projected q = project_point(proj + ((size_t)sb * NS + view) * 16, cx, cy, cz);
      const Taps tp = bilinear_taps(q.gx, q.gy, H, W);
      const float* base = feat + ((size_t)sb * NS + view) * H * W * C;
      for (int grp = lane; grp < groups; grp += 32) {
        float t00[4], t01[4], t10[4], t11[4];
        load16(base + (size_t)tp.i00 * C + grp * 4, t00);
        load16(base + (size_t)tp.i01 * C + grp * 4, t01);
        load16(base + (size_t)tp.i10 * C + grp * 4, t10);
        load16(base + (size_t)tp.i11 * C + grp * 4, t11);
        for (int j = 0; j < 4; ++j) {
          const float val = blend4(t00[j], t01[j], t10[j], t11[j], tp);
          v_w[grp * 4 + j] = view == 0 ? val : __fadd_rn(v_w[grp * 4 + j], val);
        }
      }
    }
    __syncwarp();
    chk += v_w[lane];
    __syncwarp();
  }
  out[ray * 32 + lane] = chk;
}
// the warp-per-ray forward's gate product alone: W_ih (C x 4 hid) and the
// warp's feature row in shared memory, one weight read per FMA (gate_dots)
template <int GI>
__global__ void __launch_bounds__(256) probe_gates_kernel(const float* __restrict__ w_ih,
                                                          float* __restrict__ out, long long rays,
                                                          int C, int hid, int steps) {
  extern __shared__ __align__(16) float s[];
  const int G4 = 4 * hid, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < C * G4; i += blockDim.x) s[i] = w_ih[i];
  float* v_w = s + C * G4 + warp * C;
  for (int ch = lane; ch < C; ch += 32) v_w[ch] = 1e-3f * (float)ch;
  __syncthreads();
  const long long ray = (long long)blockIdx.x * 8 + warp;
  if (ray >= rays) return;
  float keep = 0.f;
  for (int step = 0; step < steps; ++step) {
    float acc[GI];
    for (int gi = 0; gi < GI; ++gi) acc[gi] = 0.f;
    for (int ch = 0; ch < C; ++ch) {
      const float x = v_w[ch];
      const float* wrow = s + (size_t)ch * G4;
#pragma unroll
      for (int gi = 0; gi < GI; ++gi) {
        const int q = lane + 32 * gi;
        if (q < G4) acc[gi] = fmaf(x, wrow[q], acc[gi]);
      }
    }
    __syncwarp();
    v_w[lane] = acc[0] * 1e-6f;
    keep += acc[GI - 1];
    __syncwarp();
  }
  out[ray * 32 + lane] = keep;
}
extern "C" int probe_gather(const void* pts, const void* proj, const void* feat, void* out,
                            int SB, int R, int NS, int H, int W, int C, int steps, int smem,
                            void* stream) {
  cudaFuncSetAttribute(probe_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const unsigned blocks = (unsigned)(((long long)SB * R + 7) / 8);
  probe_gather_kernel<<<blocks, 256, smem, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)proj, (const float*)feat, (float*)out, SB, R, NS, H, W, C,
      steps);
  return (int)cudaGetLastError();
}
extern "C" int probe_gates(const void* w_ih, void* out, long long rays, int C, int hid,
                           int steps, int smem, void* stream) {
  cudaFuncSetAttribute(probe_gates_kernel<4>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  probe_gates_kernel<4><<<(unsigned)((rays + 7) / 8), 256, smem, (cudaStream_t)stream>>>(
      (const float*)w_ih, (float*)out, rays, C, hid, steps);
  return (int)cudaGetLastError();
}
'''

state = json.loads(sys.argv[2])
info = _build.load_library()
tmp = tempfile.mkdtemp()
nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
with open(os.path.join(tmp, "probe.cu"), "w") as f:
    f.write(SRC)
so = os.path.join(tmp, "probe.so")
subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared", "-Xcompiler",
                "-fPIC", "-I", os.path.join("avr_tpu_torch", "csrc"), "-o", so,
                os.path.join(tmp, "probe.cu")], check=True)
lib = ctypes.CDLL(so)
V, U, I, L = ctypes.c_void_p, ctypes.c_uint, ctypes.c_int, ctypes.c_longlong
lib.probe_empty.argtypes = [U, U, I, V]
lib.probe_gather.argtypes = [V, V, V, V] + [I] * 8 + [V]
lib.probe_gates.argtypes = [V, V, L, I, I, I, I, V]
stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def call(fn, *a):
    err = fn(*a, stream())
    if err:
        raise RuntimeError(f"probe launch failed: cudaError {err}")


res = {"checkout": sys.argv[1]}
C, hid, NS = cs.C, cs.HIDDEN, 1
G4 = 4 * hid
# the warp-per-ray kernels' shared memory (csrc/march.cu weight_bytes,
# bwd_smem_bytes at C 512, hidden 16): W_ih, W_hh and 8 warps' rows
fwd_smem = C * G4 * 4 + hid * G4 * 4 + 4 * (8 * (C + 256 + 64) + 256 + 64)
walk_smem = C * G4 * 4 + 4 * 8 * (2 * C + 256 + 11 * 32)
sms = torch.cuda.get_device_properties(0).multi_processor_count
kw = dict(steps=cs.STEPS, compute_dtype=f32)
serve = as_f32(cs.march_inputs(torch.Generator(device=cs.DEV).manual_seed(0), 1))
train = as_f32(cs.march_inputs(torch.Generator(device=cs.DEV).manual_seed(3), 1, sb=cs.SB_TRAIN,
                               w_out_scale=cs.TIMED_HEAD))
for label, inp in (("fwd serve", serve), ("fwd train", train)):
    rays = inp["coords0"].shape[0] * cs.CHUNK
    a = {k: v.detach().contiguous() for k, v in inp.items()}
    a["w_out"], a["b_out"] = a["w_out"].reshape(-1), a["b_out"].reshape(1)
    save = label == "fwd train"
    run = lambda: K3._forward(a, cs.STEPS, 0.0, f32, save=save)
    _, aux = K3._forward(a, cs.STEPS, 0.0, f32, save=True)
    pts = aux[:, :, 2 * hid:2 * hid + 3].contiguous()
    out = torch.empty(rays * 32, device=cs.DEV)
    r = {"kernel": dict(device_ms=dev_ms(run, FWD, 20)),
         "empty, warp-per-ray geometry": dict(device_ms=dev_ms(
             lambda: call(lib.probe_empty, -(-rays // 8), 256, fwd_smem),
             ("probe_empty_kernel",), 20)),
         "gather alone": dict(device_ms=dev_ms(
             lambda: call(lib.probe_gather, pts.data_ptr(), a["proj"].data_ptr(),
                          a["feat"].data_ptr(), out.data_ptr(), a["coords0"].shape[0], cs.CHUNK,
                          NS, cs.LATENT, cs.LATENT, C, cs.STEPS, fwd_smem),
             ("probe_gather_kernel",), 20)),
         "gate product alone": dict(device_ms=dev_ms(
             lambda: call(lib.probe_gates, a["w_ih"].data_ptr(), out.data_ptr(), rays, C, hid,
                          cs.STEPS, C * G4 * 4 + 8 * C * 4), ("probe_gates_kernel",), 20))}
    flops = rays * cs.STEPS * 2 * C * G4
    r["gate product alone"]["tflops"] = flops / r["gate product alone"]["device_ms"] / 1e9
    r["kernel"]["tflops_gates"] = flops / r["kernel"]["device_ms"] / 1e9
    res[label] = r
    del aux, pts, out
# the walk on both draws, each also with the other draw's cotangent
ds = draws(state)
names = list(ds)
for name in names:
    inp, g = ds[name]
    _, run = backward(inp, g)
    by = cs.kernel_device_ms(run, WALK + BINS + PARTIALS, iters=3)
    r = dict(walk_ms=sum(by[k] for k in WALK), bins_ms=by[BINS[0]], partials_ms=by[PARTIALS[0]])
    for other in names:
        if other != name:
            _, run2 = backward(inp, ds[other][1])
            r["walk_ms with the cotangent of " + other] = dev_ms(run2, WALK, 3)
            del run2
    r["g_abs_mean"] = float(g.abs().mean())
    res["bwd " + name] = r
    del run
    torch.cuda.empty_cache()
res["empty, walk geometry"] = dict(
    ctas=min(sms, -(-cs.SB_TRAIN * cs.CHUNK // 8)),
    device_ms=dev_ms(lambda: call(lib.probe_empty, min(sms, -(-cs.SB_TRAIN * cs.CHUNK // 8)), 256,
                                  walk_smem), ("probe_empty_kernel",), 20))
shutil.rmtree(tmp)
print(json.dumps(res), flush=True)
"""

# --probe --capture: chip_smoke.main's checks up to check_march_bwd's timed
# draw, then its generator's state
_CAPTURE = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs


class Stop(Exception):
    pass


draw = cs.march_inputs


def march_inputs(gen, ns, dtype=torch.bfloat16, sb=1, w_out_scale=0.05, hidden=cs.HIDDEN):
    if (gen.initial_seed() == 0 and dtype == torch.bfloat16 and sb == cs.SB_TRAIN
            and w_out_scale == cs.TIMED_HEAD):
        print(json.dumps({"timed_state": gen.get_state().tolist()}), flush=True)
        raise Stop
    return draw(gen, ns, dtype, sb, w_out_scale, hidden)


cs.march_inputs = march_inputs
sys.argv = sys.argv[:1]
try:
    cs.main()
except Stop:
    pass
"""

# (e): exact edits of csrc/march.cu that stamp the warp-per-ray kernels
# (lstm_march_kernel's phases: gather, mean, gate products, cell and step
# head; lstm_march_bwd_kernel's: saved row and cell backward, gh, the gate
# rows and dv, the per-tap dots with the re-blend, the v_t row)
STAMPS = [
    ("#include <climits>", """#include <climits>
__device__ long long k3_stamps[2][8][8];
#define K3_T(k) pt[k] += clock64() - t0; t0 = clock64()
extern "C" int avr_k3_stamps(void* out) {
  return (int)cudaMemcpyFromSymbol(out, k3_stamps, sizeof(k3_stamps));
}"""),
    ("""  const int AW = aux_width(hid), G0 = aux_g0(hid);
  __syncwarp();
""", """  const int AW = aux_width(hid), G0 = aux_g0(hid);
  __syncwarp();
  long long pt[8] = {0, 0, 0, 0, 0, 0, 0, 0}, t0;
  const long long t_all = clock64();
"""),
    ("    // gather, summed over views into this warp's feature row\n",
     "    t0 = clock64();\n    // gather, summed over views into this warp's feature row\n"),
    ("    __syncwarp();  // the mean below reads channels another lane wrote\n",
     "    K3_T(0);\n    __syncwarp();  // the mean below reads channels another lane wrote\n"),
    ("    // gates: lane owns gate columns lane + 32 * gi\n",
     "    K3_T(1);\n    // gates: lane owns gate columns lane + 32 * gi\n"),
    ("    // cell: lane k updates units k and k + 32 (< hid); step head reduced\n",
     "    K3_T(2);\n    // cell: lane k updates units k and k + 32 (< hid); step head reduced\n"),
    ("    if (eps > 0.f && fabsf(s) < eps) {  // frozen: s is 0 from now on\n",
     "    K3_T(3);\n    if (eps > 0.f && fabsf(s) < eps) {  // frozen: s is 0 from now on\n"),
    ("""  if (lane == 0) {
    out[ray * 3] = cx;""", """  if (blockIdx.x == K3_STAMP_CTA && lane == 0) {
    pt[7] = clock64() - t_all;
    for (int k = 0; k < 8; ++k) k3_stamps[0][warp][k] = pt[k];
  }
  if (lane == 0) {
    out[ray * 3] = cx;"""),
    ("""  for (long long ray = (long long)blockIdx.x * WARPS + warp; ray < rays;
       ray += (long long)gridDim.x * WARPS) {""",
     """  long long pt[8] = {0, 0, 0, 0, 0, 0, 0, 0}, t0 = 0;
  const long long t_all = clock64();
  for (long long ray = (long long)blockIdx.x * WARPS + warp; ray < rays;
       ray += (long long)gridDim.x * WARPS) {"""),
    ("      const size_t rsp = (size_t)ray * a.steps + t;  // the ray-step's row\n",
     "      t0 = clock64();\n      const size_t rsp = (size_t)ray * a.steps + t;  // the ray-step's row\n"),
    ("      // the h cotangent of step t-1\n", "      K3_T(0);\n      // the h cotangent of step t-1\n"),
    ("      // the gate cotangents: dW_ih's and dW_hh's other operand (a GEMM after\n",
     "      K3_T(1);\n      // the gate cotangents: dW_ih's and dW_hh's other operand (a GEMM after\n"),
    ("      // the per-tap dots of the gather backward per view; v_t re-blended\n",
     "      K3_T(2);\n      // the per-tap dots of the gather backward per view; v_t re-blended\n"),
    ("      // v_t as the forward computed it: dW_ih's operand\n",
     "      K3_T(3);\n      // v_t as the forward computed it: dW_ih's operand\n"),
    ("      __syncwarp();  // v_w, dv_w and dg_w are rewritten by the next step\n",
     "      __syncwarp();  // v_w, dv_w and dg_w are rewritten by the next step\n      K3_T(4);\n"),
    ("  // the CTA's partial sums: each output's owning lane, warps in order\n",
     """  if (blockIdx.x == K3_STAMP_CTA_BWD && lane == 0) {
    pt[7] = clock64() - t_all;
    for (int k = 0; k < 8; ++k) k3_stamps[1][warp][k] = pt[k];
  }
  // the CTA's partial sums: each output's owning lane, warps in order
"""),
]
STAMP_PHASES = {"warp": (("gather", "mean", "gate products", "cell and step head"),
                         ("saved row and cell backward", "gh", "gate rows and dv",
                          "per-tap dots and re-blend", "v_t row")),
                "tiles": (("rows and taps", "h W_hh", "gather", "gate product", "gates",
                           "cell and step head"),
                          ("rows and taps", "cell backward", "gate rows and gh", "dv product",
                           "tap loads and dots", "dots' warp sums"))}
# the stamped CTA of each kind: one of a later wave of the forward at a
# served chunk (the warp-per-ray forward: 512 CTAs; the tiles: 128) and one
# of the walk (132 persistent CTAs; the tiles: 256 in two waves)
STAMP_CTAS = {"warp": (300, 5), "tiles": (100, 200)}
# the ray-tile kernels' edits: lstm_march_f32_tile_kernel's phases (the
# rows' heads and taps, h W_hh, the gather, the gate product, the gates, the
# cell and step head); lstm_march_f32_walk_kernel's (the rows' heads and
# taps, the cell backward, the gate rows and gh, the dv product, the tap
# loads and dots, the dots' warp sums)
STAMPS_TILES = [STAMPS[0]] + [
    ("""  const size_t map = (size_t)a.H * a.W * C;

  for (int step = 0; step < a.steps; ++step) {
""", """  const size_t map = (size_t)a.H * a.W * C;
  long long pt[8] = {0, 0, 0, 0, 0, 0, 0, 0}, t0;
  const long long t_all = clock64();
  for (int step = 0; step < a.steps; ++step) {
    t0 = clock64();
"""),
    ("    // h W_hh into the gate tile\n", "    K3_T(0);\n    // h W_hh into the gate tile\n"),
    ("    // v_t W_ih, chunk by chunk: each chunk of v_t gathered into the A tile,\n",
     "    K3_T(1);\n    // v_t W_ih, chunk by chunk: each chunk of v_t gathered into the A tile,\n"),
    ("""      f32_tile_fma<NB, !WSM, NB <= 2 ? 4 : 2>(a_s, AP, wih + (size_t)c0 * ldw, ldw, 4 * gpr, G4,
                                              rg, cg, acc);
      __syncwarp();  // the A tile is rewritten by the next chunk
""", """      K3_T(2);
      f32_tile_fma<NB, !WSM, NB <= 2 ? 4 : 2>(a_s, AP, wih + (size_t)c0 * ldw, ldw, 4 * gpr, G4,
                                              rg, cg, acc);
      __syncwarp();  // the A tile is rewritten by the next chunk
      K3_T(3);
"""),
    ("    // the cell: lane k updates units k and k + 32 (< hid) of a ray; the step\n",
     "    K3_T(4);\n    // the cell: lane k updates units k and k + 32 (< hid) of a ray; the step\n"),
    ("    __syncwarp();  // the taps, the A and gate tiles and h are rewritten by the next step\n",
     "    __syncwarp();  // the taps, the A and gate tiles and h are rewritten by the next step\n"
     "    K3_T(5);\n"),
    ("""  if (valid) {
    a.out[my * 3] = cx;""", """  if (blockIdx.x == K3_STAMP_CTA && lane == 0) {
    pt[7] = clock64() - t_all;
    for (int k = 0; k < 8; ++k) k3_stamps[0][warp][k] = pt[k];
  }
  if (valid) {
    a.out[my * 3] = cx;"""),
    ("""    fetch_rows(a.steps - 1);
    for (int t = a.steps - 1; t >= 0; --t) {
""", """    long long pt[8] = {0, 0, 0, 0, 0, 0, 0, 0}, t0;
    const long long t_all = clock64();
    fetch_rows(a.steps - 1);
    for (int t = a.steps - 1; t >= 0; --t) {
      t0 = clock64();
"""),
    ("      // the cell backward: lane k takes units k and k + 32 of a ray (at\n",
     "      K3_T(0);\n      // the cell backward: lane k takes units k and k + 32 of a ray (at\n"),
    ("      // the gate cotangents: dW_ih's and dW_hh's other operand (a GEMM after\n",
     "      K3_T(1);\n      // the gate cotangents: dW_ih's and dW_hh's other operand (a GEMM after\n"),
    ("      // dv = dgates W_ih^T / NS, F32_DOTS channels at a time, into the\n",
     "      K3_T(2);\n      // dv = dgates W_ih^T / NS, F32_DOTS channels at a time, into the\n"),
    ("      __syncwarp();  // the dv rows are read back by other lanes below\n",
     "      __syncwarp();  // the dv rows are read back by other lanes below\n      K3_T(3);\n"),
    ("          float d[4];\n", "          K3_T(4);\n          float d[4];\n"),
    ("""          if (lane == r) {
            gcx += dw.x;
            gcy += dw.y;
            gcz += dw.z;
          }
        }
""", """          if (lane == r) {
            gcx += dw.x;
            gcy += dw.y;
            gcz += dw.z;
          }
          K3_T(5);
        }
"""),
    ("""    if (valid) {
      a.dcoords0[my * 3] = gcx;""", """    if (blockIdx.x == K3_STAMP_CTA_BWD && lane == 0) {
      pt[7] = clock64() - t_all;
      for (int k = 0; k < 8; ++k) k3_stamps[1][warp][k] = pt[k];
    }
    if (valid) {
      a.dcoords0[my * 3] = gcx;"""),
]

# run in the stamped copy: the forward at both shapes, the walk on both
# draws, each kernel's cycles by phase in the stamped CTA's warps
_STAMPED = r"""
import ctypes
state = json.loads(sys.argv[2])
info = _build.load_library()
get = _build.kernel_fn("avr_k3_stamps", [ctypes.c_void_p])


def stamps(kind):
    buf = (ctypes.c_longlong * 128)()
    torch.cuda.synchronize()
    err = get(ctypes.cast(buf, ctypes.c_void_p))
    if err:
        raise RuntimeError(f"stamps: cudaError {err}")
    return [list(buf[64 * kind + 8 * w:64 * kind + 8 * w + 8]) for w in range(8)]


res = {}
kw = dict(steps=cs.STEPS, compute_dtype=f32)
serve = as_f32(cs.march_inputs(torch.Generator(device=cs.DEV).manual_seed(0), 1))
train = as_f32(cs.march_inputs(torch.Generator(device=cs.DEV).manual_seed(3), 1, sb=cs.SB_TRAIN,
                               w_out_scale=cs.TIMED_HEAD))
for label, inp in (("fwd serve", serve), ("fwd train", train)):
    a = {k: v.detach().contiguous() for k, v in inp.items()}
    a["w_out"], a["b_out"] = a["w_out"].reshape(-1), a["b_out"].reshape(1)
    run = lambda: K3._forward(a, cs.STEPS, 0.0, f32, save=label == "fwd train")
    res[label] = dict(device_ms=dev_ms(run, FWD, 5))
    run()
    res[label]["warps"] = stamps(0)
for name, (inp, g) in draws(state).items():
    _, run = backward(inp, g)
    res["bwd " + name] = dict(device_ms=dev_ms(run, WALK, 3))
    run()
    res["bwd " + name]["warps"] = stamps(1)
    del run
print(json.dumps(res), flush=True)
"""


def stamped(checkout, state):
    """The checkout's port copied, its ``csrc/march.cu`` stamped (``STAMPS``
    or ``STAMPS_TILES``, whichever matches its source exactly), built and
    run in a directory of its own: device ms and each phase's share of a
    warp's cycles (mean over the stamped CTA's warps that ran)."""
    import shutil
    import subprocess
    import tempfile

    src = os.path.join(checkout, "avr_tpu_torch", "csrc", "march.cu")
    text = open(src).read()
    for kind, edits in (("warp", STAMPS), ("tiles", STAMPS_TILES)):
        if edits and all(text.count(old) == 1 for old, _ in edits):
            break
    else:
        return {"stamps": "source does not match"}
    for old, new in edits:
        text = text.replace(old, new)
    text = "#define K3_STAMP_CTA %d\n#define K3_STAMP_CTA_BWD %d\n" % STAMP_CTAS[kind] + text
    tmp = tempfile.mkdtemp()
    try:
        shutil.copytree(os.path.join(checkout, "avr_tpu_torch"), os.path.join(tmp, "avr_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build"))
        shutil.copy(os.path.join(checkout, "chip_smoke.py"), tmp)
        open(os.path.join(tmp, "avr_tpu_torch", "csrc", "march.cu"), "w").write(text)
        r = subprocess.run([sys.executable, "-c", _COMMON + _STAMPED, tmp, json.dumps(state)],
                           cwd=tmp, capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(f"stamps: exit {r.returncode}\n{r.stderr[-3000:]}")
        out = json.loads(r.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(tmp)
    fwd_phases, bwd_phases = STAMP_PHASES[kind]
    for label, reading in out.items():
        phases = bwd_phases if label.startswith("bwd") else fwd_phases
        warps = [w for w in reading.pop("warps") if w[7] > 0]
        total = sum(w[7] for w in warps) / max(len(warps), 1)
        reading["cycles"] = total
        reading["share"] = {p: sum(w[k] for w in warps) / max(len(warps), 1) / total
                            for k, p in enumerate(phases)} if warps else {}
        reading["share"]["other"] = 1 - sum(reading["share"].values())
    return out


def _capture(checkout):
    """The state of ``chip_smoke.main``'s generator at check_march_bwd's
    timed draw, read in ``checkout`` (printed, for ``TIMED_STATE``)."""
    import subprocess

    path = os.path.abspath(checkout)
    r = subprocess.run([sys.executable, "-c", _CAPTURE, path], cwd=path, capture_output=True,
                       text=True)
    line = next((ln for ln in r.stdout.splitlines() if ln.startswith('{"timed_state"')), None)
    if line is None:
        raise SystemExit(f"capture: exit {r.returncode}\n{r.stderr[-3000:]}")
    print(line, flush=True)
    return json.loads(line)["timed_state"]


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a not in ("--probe", "--capture")]
    if not args:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    state = _capture(args[0]) if "--capture" in sys.argv else TIMED_STATE
    extra = [json.dumps(state)]
    if "--probe" in sys.argv:
        rc = march_turns.run(_COMMON + _PROBE, args, both_orders=False, extra=extra)
        for c in args:
            print(json.dumps({"checkout": c, "stamps": stamped(os.path.abspath(c), state)}),
                  flush=True)
        sys.exit(rc)
    sys.exit(march_turns.run(_COMMON + _TURN, args, extra=extra))
