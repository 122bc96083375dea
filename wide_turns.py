"""K2's wide kernels (the forward and the dgrad past d_hidden 512: the bf16
TMA cluster kernels and the float32 cluster kernels), in checkouts of the
repo, in turns, and with ``--probe`` (the bf16 pair) or ``--probe-f32``
(the float32 pair) what bounds them; with ``--slice`` the float32 slice of
``chip_smoke.py --wide`` profiled.

    python3 wide_turns.py CHECKOUT [CHECKOUT ...]
    python3 wide_turns.py --probe CHECKOUT [CHECKOUT ...]
    python3 wide_turns.py --probe-f32 CHECKOUT [CHECKOUT ...]
    python3 wide_turns.py --slice CHECKOUT [CHECKOUT ...]

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
- times the float32 wide forward and dgrad the same way, and the narrow
  bf16 K2 forward and dgrad at d_hidden 512 (the band's 81,920 points, the
  shipped decoder, which must not move): device ms and digests.

``--probe`` runs once in each checkout, not in turns: the tree's bf16 wide
forward and dgrad at the band beside probe kernels compiled from this file
into a temporary directory (not into the kernel library): (a) the decoder's
bf16 weights at the band's shape (wi, wz, w0, w1: 28.2 MB) streamed once a
32-point tile (2,560 CTAs, one a streaming multiprocessor) through
registers by ``__ldg``, 8 loads of 16 bytes a lane in flight (a warp's 64
weight rows, a lane's 16 bytes of 8 of them a step: the pattern of the
first wide version, which read its weights from L2); (b) the same bytes
once a CTA by bulk copies (``cp.async.bulk``) through a ring of shared
stages that eight warps wait on and release (3 stages of 32 KB, 4 of 16
KB); (c) the same through the same rings in clusters of 2 and 4 CTAs, each
stage's pieces issued by the cluster's CTAs and multicast to all
(``.multicast::cluster``), so L2 reads each byte once a cluster, a stage
reissued when every CTA's consumers released it: their arrivals a release
at cluster scope, at the default (CTA) scope as CUTLASS's cluster barriers
arrive, or one arrival a CTA after a named barrier; and (d) the TMA
cluster kernels' cycles by phase: a copy of the checkout's port, its
``resnetfc_wide.cu`` stamped (``STAMPS_TMA``: ``clock64()`` sums a
consumer warp, kept by one CTA of a later wave), built and run in a
directory of its own; the stamps cost part of the kernel's time (its
stamped time is printed beside).  A tree whose kernel lacks a stamp site
prints ``{"stamps": "source does not match"}`` and is not run.

``--probe-f32`` does the same for the float32 pair: the tree's float32 wide
forward and dgrad at the band, then the 56.4 MB of float32 weights
streamed once a 16-point tile (5,120 CTAs, one an SM) by ``__ldg`` (16
warps, a lane's two 16-byte loads of each of four k rows in flight), by
bulk copies through 3 x 30 KB and 3 x 32 KB rings, the same multicast over
2- and 4-CTA clusters, and the first 40 MB alone (inside L2), each with its
L2 read rate (above HBM's 3.35 TB/s the reads cannot all come from HBM);
then the float32 cluster kernels' cycles by phase (``STAMPS_WF``: their
four consumer warps).

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


# (d): exact edits of csrc/resnetfc_wide.cu that stamp the bf16 TMA cluster
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
    ("""// The bf16 forward on the TMA cluster kernel""", """extern "C" int avr_wd_stamps(void* out) {
  return (int)cudaMemcpyFromSymbol(out, wts_out, sizeof(wts_out));
}

// The bf16 forward on the TMA cluster kernel""", 1),
]
STAMP_PHASES_TMA = ("stage wait", "products (mma.sync)", "epilogues", "named barriers")

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
    ("""// The bf16 forward on the TMA cluster kernel""", """extern "C" int avr_wd_stamps(void* out) {
  return (int)cudaMemcpyFromSymbol(out, wfs_out, sizeof(wfs_out));
}

// The bf16 forward on the TMA cluster kernel""", 1),
]
STAMP_PHASES_WF = ("slab wait", "FMA", "epilogues", "named barriers", "row copies")

# run in a stamped copy: the band's forward and dgrad, their cycles by phase;
# argv[1] "tma": the bf16 TMA cluster kernels, "new_f32": the float32 ones
_STAMPED = r"""
import ctypes, json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.ops.kernels import resnetfc as K2
WARPS = {"new_f32": 4}.get(sys.argv[1], 8)
F32 = sys.argv[1] == "new_f32"
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


def stamped(checkout, kernels):
    """The checkout's port copied, its cluster kernels stamped (``kernels``
    "tma": ``STAMPS_TMA``, the bf16 pair; "new_f32": ``STAMPS_WF``, the
    float32 pair), built and run at the band in a directory of its own:
    device ms of the stamped kernels and each phase's share of a warp's
    cycles (mean over the consumer warps), for the forward and the dgrad.
    A tree whose source lacks a stamp site is reported as such and not
    run."""
    import shutil
    import subprocess
    import tempfile

    src = os.path.join(checkout, "avr_tpu_torch", "csrc", "resnetfc_wide.cu")
    text = open(src).read()
    for old, new, count in {"tma": STAMPS_TMA, "new_f32": STAMPS_WF}[kernels]:
        if text.count(old) != count if count else not text.count(old):
            return {"stamps": "source does not match"}
        text = text.replace(old, new)
    tmp = tempfile.mkdtemp()
    try:
        shutil.copytree(os.path.join(checkout, "avr_tpu_torch"), os.path.join(tmp, "avr_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build"))
        shutil.copy(os.path.join(checkout, "chip_smoke.py"), tmp)
        open(os.path.join(tmp, "avr_tpu_torch", "csrc", "resnetfc_wide.cu"), "w").write(text)
        r = subprocess.run([sys.executable, "-c", _STAMPED, kernels], cwd=tmp,
                           capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(f"stamps: exit {r.returncode}\n{r.stderr[-3000:]}")
        out = json.loads(r.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(tmp)
    warps = out.pop("warps")
    phases = {"tma": STAMP_PHASES_TMA, "new_f32": STAMP_PHASES_WF}[kernels]
    for kind, rows in (("forward", warps[:len(warps) // 2]), ("dgrad", warps[len(warps) // 2:])):
        total = sum(w[0] for w in rows) / len(rows)
        share = {name: sum(w[k + 1] for w in rows) / len(rows) / total
                 for k, name in enumerate(phases)}
        share["other"] = 1 - sum(share.values())
        out[kind] = dict(cycles_a_tile=total, share=share)
    return out


if __name__ == "__main__":
    if sys.argv[1:2] == ["--slice"]:
        sys.exit(march_turns.run(_SLICE, sys.argv[2:]))
    if sys.argv[1:2] in (["--probe"], ["--probe-f32"]):
        f32 = sys.argv[1] == "--probe-f32"
        rc = march_turns.run(_PROBE, sys.argv[2:], both_orders=False,
                             extra=("float32",) if f32 else ())
        for c in sys.argv[2:]:
            for kernels in (("new_f32",) if f32 else ("tma",)):
                print(json.dumps({"checkout": c, "kernels": kernels,
                                  "stamps": stamped(os.path.abspath(c), kernels)}), flush=True)
        sys.exit(rc)
    sys.exit(march_turns.main(_TURN, __doc__))
