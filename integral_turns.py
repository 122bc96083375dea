"""K4's forward, the float32 backward's repaired kernels, and what bounds
K4's forward, in checkouts of the repo, in turns.

    python3 integral_turns.py CHECKOUT [CHECKOUT ...]
    python3 integral_turns.py --probe CHECKOUT [CHECKOUT ...]

Each CHECKOUT is a tree of the repo (a ``git archive`` of a commit) with its
own ``chip_smoke.py``.  In each, in the order given and then in reverse, a
process of its own (``march_turns.main``, the runner the turns scripts
share) builds that tree's kernels and, from that tree's ``chip_smoke``:

- times K4's forward (``fused_volume_integral``, float32) at the train
  step's band (4 x 4,096 rays x 20 samples), at a served chunk (1 x 4,096 x
  20) and at 40 samples (4 x 4,096 x 40), on ``chip_smoke.integral_inputs``:
  the device time of its kernel (``chip_smoke.kernel_device_ms``) and the
  call back to back (CUDA events, 100 calls), the largest difference from
  the plain version, a digest of its outputs, and at the band a loop of
  about a second with the SM clock and power that ``nvidia-smi`` read;
- runs K4's backward on ``check_integral_bwd``'s inputs (all four of its
  cases) and prints a digest of its outputs: equal digests in two trees
  are equal bits;
- times the float32 backward of K3 at the train step's call (4 x 4,096 rays
  x 10 steps, ``chip_smoke.check_march_bwd``'s timed inputs in float32):
  the walk with what follows it in the same C call (the bins and the
  partial sums, where the tree has them) and the wgrad of dW_ih (and dW_hh)
  apart, device time; and the float32 wgrad at K2's 15 jobs of the train
  step's band call (327,680 points, NS 1), device time.

``--probe`` runs once in each checkout, not in turns: K4's forward kernel
of that tree beside (b) an empty kernel with the parent kernel's grid and
block (2,048 CTAs of 256 threads at the band: one warp a ray) and with the
new kernel's (CTAs of 32 rays, a thread each), and (c) a kernel that reads
every z and field row once, coalesced, and writes the same outputs (the
practical byte floor at this size), each at the three shapes; and (d) the
forward kernel's SASS (``cuobjdump``): its instructions, shuffles and
loads.  The probe kernels are compiled from this file into a temporary
directory, not into the kernel library.

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
import hashlib, json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.ops.kernels import resnetfc as K2
from avr_tpu_torch.profiling.wgrad_timing import SMI_FIELDS, sustained

torch.backends.cuda.matmul.allow_tf32 = False
FWD = "volume_integral_kernel"


def digest(ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


_build.load_library()
res = {"checkout": sys.argv[1]}
gen = torch.Generator(device=cs.DEV).manual_seed(12)
for label, sb, n in (("band", cs.SB_TRAIN, cs.N_BAND), ("serve", 1, cs.N_BAND),
                     ("n40", cs.SB_TRAIN, cs.N_BAND_WIDE)):
    z, fo = cs.integral_inputs(gen, sb, n)
    run = lambda: cs.K4.fused_volume_integral(z, fo)
    got, want = run(), cs.K4.fused_volume_integral_plain(z, fo)
    res[label] = dict(device_ms=cs.kernel_device_ms(run, (FWD,), iters=50)[FWD],
                      call_ms=cs.time_ms(run, iters=100),
                      max_abs_err=max(cs.max_err(a, b) for a, b in zip(got, want)),
                      digest=digest(got))
    if label == "band":
        loop = sustained(run, 1.0, SMI_FIELDS)
        res[label].update(loop_ms=loop["ms"], sm_mhz=loop["clocks.sm"],
                          power_w=loop["power.draw"])
# K4's backward on check_integral_bwd's inputs (its own generator's draws)
bgen = torch.Generator(device=cs.DEV).manual_seed(13)
outs = []
for sb, n in ((cs.SB_TRAIN, cs.N_BAND), (1, cs.N_BAND), (cs.SB_TRAIN, cs.N_BAND_WIDE),
              (1, cs.N_BAND_WIDE)):
    z, fo = cs.integral_inputs(bgen, sb, n)
    g = (cs.randn(bgen, sb, cs.CHUNK, 3), cs.randn(bgen, sb, cs.CHUNK, 1))
    outs += list(cs.grads_of(cs.K4.fused_volume_integral, (z, fo), g))
res["bwd_digest"] = digest(outs)
del outs
# K3's float32 backward at the train step's call
inp = cs.march_inputs(torch.Generator(device=cs.DEV).manual_seed(14), 1, sb=cs.SB_TRAIN,
                      w_out_scale=cs.TIMED_HEAD)
f32 = {k: (v.float() if v.is_floating_point() else v) for k, v in inp.items()}
keys = cs.MARCH_KEYS
g = cs.randn(torch.Generator(device=cs.DEV).manual_seed(15), cs.SB_TRAIN, cs.CHUNK, 3)
fn = lambda *t: cs.fused_lstm_march(f32["proj"], *t, steps=cs.STEPS, compute_dtype=torch.float32)
got, run = cs.grads_of(fn, tuple(f32[k] for k in keys), g, keep=True)
walk = ("lstm_march_bwd_kernel", "lstm_march_partials_kernel", "gather_bin_")
wgrad = ("resnetfc_wgrad_kernel", "resnetfc_wgrad_reduce_kernel")
by = cs.kernel_device_ms(run, walk + wgrad, iters=3)
res["k3_f32_bwd"] = dict(walk_device_ms=sum(by[k] for k in walk),
                         wgrad_device_ms=sum(by[k] for k in wgrad), by_kernel=by,
                         digest=digest(got))
del got, run
# the float32 wgrad at K2's 15 jobs of the train step's band call
w = cs.decoder_weights(torch.Generator(device=cs.DEV).manual_seed(16))
wg = torch.Generator(device=cs.DEV).manual_seed(17)
x = (torch.rand(1, cs.BAND_TRAIN, cs.CODE.d_raw, generator=wg, device=cs.DEV) * 2 - 1).contiguous()
z = cs.randn(wg, 1, cs.BAND_TRAIN, cs.C)
g = cs.randn(wg, cs.BAND_TRAIN, 4) + 0.5
args = K2._prepare(x, z, w, cs.CODE, torch.float32)
dims = K2._dims(args, 5, 3, True)
st = K2._forward(args, dims, torch.float32, True)[1]
gs, wT, grads = K2._bwd_operands(args, dims, g, K2.NAME_DGRAD)
_, _, cot, gout, enc = K2._dgrad(args, dims, st, gs, wT, torch.float32)
run = lambda: K2._wgrad(cs.BAND_TRAIN, args["z"], st, cot, gout, enc, grads, dims, torch.float32)
by = cs.kernel_device_ms(run, wgrad, iters=3)
for v in grads.values():
    v.zero_()
run()
res["k2_f32_wgrad"] = dict(device_ms=sum(by.values()), by_kernel=by,
                           digest=digest(list(grads.values())))
print(json.dumps(res), flush=True)
"""

# --probe, run once in a checkout: the tree's K4 forward beside the floors
_PROBE = r"""
import ctypes, json, os, re, shutil, subprocess, sys, tempfile
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from avr_tpu_torch.ops.kernels import _build

SRC = '''
#include <cuda_runtime.h>
__global__ void probe_empty_kernel() {}
// every z and field row read once (coalesced: element i by thread i), the
// outputs of ray i written by thread i
__global__ void probe_touch_kernel(const float* __restrict__ z, const float4* __restrict__ fo,
                                   float* __restrict__ rgb, float* __restrict__ dist,
                                   long long rays, long long rows) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float s = 0.f;
  if (i < rows) {
    const float4 f = __ldg(fo + i);
    s = __ldg(z + i) + f.x + f.y + f.z + f.w;
  }
  if (i < rays) {
    rgb[i * 3] = s;
    rgb[i * 3 + 1] = s;
    rgb[i * 3 + 2] = s;
    dist[i] = s;
  }
}
extern "C" int probe_empty(unsigned blocks, unsigned threads, void* stream) {
  probe_empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
extern "C" int probe_touch(const void* z, const void* fo, void* rgb, void* dist, long long rays,
                           long long rows, void* stream) {
  const long long blocks = (rows + 255) / 256;
  probe_touch_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)z, (const float4*)fo, (float*)rgb, (float*)dist, rays, rows);
  return (int)cudaGetLastError();
}
'''

info = _build.load_library()
tmp = tempfile.mkdtemp()
nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
with open(os.path.join(tmp, "probe.cu"), "w") as f:
    f.write(SRC)
so = os.path.join(tmp, "probe.so")
subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                "-Xcompiler", "-fPIC", "-o", so, os.path.join(tmp, "probe.cu")], check=True)
lib = ctypes.CDLL(so)
lib.probe_empty.argtypes = [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
lib.probe_touch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
res = {"checkout": sys.argv[1]}
gen = torch.Generator(device=cs.DEV).manual_seed(12)
for label, sb, n in (("band", cs.SB_TRAIN, cs.N_BAND), ("serve", 1, cs.N_BAND),
                     ("n40", cs.SB_TRAIN, cs.N_BAND_WIDE)):
    z, fo = cs.integral_inputs(gen, sb, n)
    rays = sb * cs.CHUNK
    rgb = torch.empty(sb, cs.CHUNK, 3, device=cs.DEV)
    dist = torch.empty(sb, cs.CHUNK, 1, device=cs.DEV)
    run = lambda: cs.K4.fused_volume_integral(z, fo)
    calls = {"kernel": (run, ("volume_integral_kernel",)),
             "empty, one warp a ray": (lambda: lib.probe_empty(-(-rays // 8), 256, stream()),
                                       ("probe_empty_kernel",)),
             "empty, a thread a ray": (lambda: lib.probe_empty(-(-rays // 32), 32, stream()),
                                       ("probe_empty_kernel",)),
             "read once": (lambda: lib.probe_touch(z.data_ptr(), fo.data_ptr(), rgb.data_ptr(),
                                                   dist.data_ptr(), rays, rays * n, stream()),
                           ("probe_touch_kernel",))}
    res[label] = {name: dict(device_ms=sum(cs.kernel_device_ms(fn, names, iters=50).values()),
                             call_ms=cs.time_ms(fn, iters=100))
                  for name, (fn, names) in calls.items()}
tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
sass = subprocess.run([tool, "-sass", info["path"]], capture_output=True, text=True).stdout
for f in re.split(r"\n\s*(?=Function : )", sass):
    if f.startswith("Function : ") and "volume_integral" in f.split()[2]:
        ins = [l for l in f.splitlines() if re.search(r"/\*[0-9a-f]{4}\*/", l)]
        count = lambda op: sum(bool(re.search(r"\b" + op, l)) for l in ins)
        res["sass " + f.split()[2]] = dict(instructions=len(ins), shfl=count("SHFL"),
                                           ldg=count("LDG"), lds=count("LDS"),
                                           ldgsts=count("LDGSTS"), stg=count("STG"),
                                           mufu=count("MUFU"))
shutil.rmtree(tmp)
print(json.dumps(res), flush=True)
"""


if __name__ == "__main__":
    if sys.argv[1:2] == ["--probe"]:
        sys.exit(march_turns.run(_PROBE, sys.argv[2:], both_orders=False))
    sys.exit(march_turns.main(_TURN, __doc__))
