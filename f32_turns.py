"""K2's float32 forward and the float32 wgrad, in checkouts of the repo, in
turns, and with ``--probe`` what bounds them.

    python3 f32_turns.py CHECKOUT [CHECKOUT ...]
    python3 f32_turns.py --probe CHECKOUT [CHECKOUT ...]

Each CHECKOUT is a tree of the repo (a ``git archive`` of a commit) with its
own ``chip_smoke.py``.  In each, in the order given and then in reverse, a
process of its own (``march_turns.main``, the runner the turns scripts
share) builds that tree's kernels and, from that tree's ``chip_smoke``:

- times K2's float32 forward (``fused_resnetfc``, ``compute_dtype``
  float32) at the band chunk (81,920 points, NS 1, on
  ``chip_smoke.check_float32``'s inputs) and at a served chunk's coarse
  query (4,096 points): the device time of its kernel (``torch.profiler``)
  and the call back to back (CUDA events), a digest of its output and its
  largest difference from the plain version; at the band also the plain
  version (the cuBLAS chain) and a loop of about a second with the SM
  clock and power that ``nvidia-smi`` read;
- times the float32 wgrad (``resnetfc._wgrad``) at K2's 15 jobs of the
  train step's band call (327,680 points, NS 1) and at K3's two jobs
  (dW_ih and dW_hh over 163,840 ray-steps, as ``chip_smoke.check_float32``
  launches them): device time of its kernels, a digest of its outputs,
  ``torch.matmul`` over the same jobs in float32 (TF32 off) in the same
  process, and for each a loop of about a second with the SM clock;
- serves three float32 frames of the adaptive renderer
  (``chip_smoke.run_slice``): ms a frame.

``--probe`` runs once in each checkout, not in turns: the tree's float32
forward and wgrad beside probe kernels compiled from this file into a
temporary directory (not into the kernel library): (a) an empty kernel at
the parent forward's launch geometry (a CTA of 256 threads a 32-point
tile, its 132 KB of shared memory); (b) every float32 weight of the
decoder (420 slabs of 32 KB, 13.8 MB) streamed once a CTA through a ring
of shared slabs by bulk copies, at a 32-point tile's grid and a 64-point
tile's, and read once a CTA through registers by ``__ldg``; (c) the
parent wgrad's inner loop (``wgrad_step``: the ``mma.sync`` fragment
layout, 20 scalar shared loads a thread for every 64 FMAs) fed from shared
memory with no global loads, at the parent's grids for K3's two jobs (40
CTAs) and K2's 15 (1,728), and a register-tiled loop (8 x 8 outputs a
thread read with 4 vector shared loads for every 64 FMAs) at the same
grids and at K3's work over 264 CTAs; (d) a register-tiled forward loop
(8 points x 8 columns a thread, a 32-point tile's FMAs for 420 slabs) from
shared memory; and (e) the SASS counts (``cuobjdump``) of the tree's
float32 forward and wgrad kernels.

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
from avr_tpu_torch.ops.kernels import march as K3
from avr_tpu_torch.ops.kernels import resnetfc as K2
from avr_tpu_torch.profiling.wgrad_timing import SMI_FIELDS, sustained

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# the float32 forward and wgrad kernels of either tree (the parent's, this PR's)
FWD = ("resnetfc_kernel", "resnetfc_fwd_f32_kernel")
WGRAD = ("resnetfc_wgrad_kernel", "resnetfc_wgrad_f32_kernel", "resnetfc_wgrad_reduce_kernel")
f32 = torch.float32


def digest(ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def device_ms(fn, names, iters=5):
    return sum(cs.kernel_device_ms(fn, names, iters).values())


def loop(fn):
    r = sustained(fn, 1.0, SMI_FIELDS)
    return dict(loop_ms=r["ms"], sm_mhz=r["clocks.sm"], power_w=r["power.draw"])


_build.load_library()
res = {"checkout": sys.argv[1]}
# K2's float32 forward: the band on check_float32's inputs, and a served coarse query
gen = torch.Generator(device=cs.DEV).manual_seed(6)
w = cs.decoder_weights(gen)
kw = dict(n_blocks=5, n_lin_z=3, code=cs.CODE, activate_out=True, compute_dtype=f32)
x = (torch.rand(1, cs.BAND, cs.CODE.d_raw, generator=gen, device=cs.DEV) * 2 - 1).contiguous()
z = cs.randn(gen, 1, cs.BAND, cs.C)
sgen = torch.Generator(device=cs.DEV).manual_seed(18)
xs = (torch.rand(1, cs.CHUNK, cs.CODE.d_raw, generator=sgen, device=cs.DEV) * 2 - 1).contiguous()
zs = cs.randn(sgen, 1, cs.CHUNK, cs.C)
for label, xx, zz in (("fwd band", x, z), ("fwd serve", xs, zs)):
    run = lambda: cs.fused_resnetfc(xx, zz, w, **kw)
    got, want = run(), cs.resnetfc_plain(xx, zz, w, **kw)
    res[label] = dict(device_ms=device_ms(run, FWD), call_ms=cs.time_ms(run, iters=5),
                      max_abs_err=cs.max_err(got, want), digest=digest([got]))
    if label == "fwd band":
        plain = lambda: cs.resnetfc_plain(xx, zz, w, **kw)
        res[label].update(plain_ms=cs.time_ms(plain, iters=3), **loop(run))
        res[label]["plain_loop"] = loop(plain)
del x, z, xs, zs, got, want
# the float32 wgrad at K2's 15 jobs of the train step's band call
wg = torch.Generator(device=cs.DEV).manual_seed(17)
x = (torch.rand(1, cs.BAND_TRAIN, cs.CODE.d_raw, generator=wg, device=cs.DEV) * 2 - 1).contiguous()
z = cs.randn(wg, 1, cs.BAND_TRAIN, cs.C)
g = cs.randn(wg, cs.BAND_TRAIN, 4) + 0.5
args = K2._prepare(x, z, w, cs.CODE, f32)
dims = K2._dims(args, 5, 3, True)
st = K2._forward(args, dims, f32, True)[1]
gs, wT, grads = K2._bwd_operands(args, dims, g, K2.NAME_DGRAD)
_, _, cot, gout, enc = K2._dgrad(args, dims, st, gs, wT, f32)
run = lambda: K2._wgrad(cs.BAND_TRAIN, args["z"], st, cot, gout, enc, grads, dims, f32)
ms = device_ms(run, WGRAD, iters=3)
for v in grads.values():
    v.zero_()
run()
jobs = cs.wgrad_matmul_jobs(st, cot, gout, enc, args["z"], 5, 3)
mm = lambda: [torch.matmul(a.t(), b) for a, b in jobs]
res["wgrad K2"] = dict(device_ms=ms, digest=digest(list(grads.values())),
                       matmul_ms=cs.time_ms(mm, iters=3), **loop(run))
res["wgrad K2"]["matmul_loop"] = loop(mm)
del x, z, g, args, st, gs, wT, grads, cot, gout, enc, jobs
# the float32 wgrad at K3's two jobs (v_t | h_prev against the gate cotangents)
kg = torch.Generator(device=cs.DEV).manual_seed(19)
rows, hid = cs.K3_F32_JOB_ROWS, cs.HIDDEN
vld, dgl = cs.C + -(-hid // 4) * 4, K3.gate_row_width(hid)
v = cs.randn(kg, rows, vld)
dg = cs.randn(kg, rows, dgl)
outs = [torch.zeros((cs.C, 4 * hid), device=cs.DEV), torch.zeros((hid, 4 * hid), device=cs.DEV)]
k3 = lambda: K2.wgrad(K3.NAME_WGRAD, [
    (v.data_ptr(), dg.data_ptr(), outs[0], None, rows, vld, dgl, cs.C, 4 * hid),
    (v.data_ptr() + 4 * cs.C, dg.data_ptr(), outs[1], None, rows, vld, dgl, hid, 4 * hid)],
    f32, cs.DEV)
ms = device_ms(k3, WGRAD, iters=20)
for o in outs:
    o.zero_()
k3()
mm = lambda: torch.matmul(v.t(), dg)
res["wgrad K3"] = dict(device_ms=ms, digest=digest(outs), matmul_ms=cs.time_ms(mm, iters=20),
                       **loop(k3))
res["wgrad K3"]["matmul_loop"] = loop(mm)
del v, dg, outs
r, _ = cs.run_slice("adaptive", dtype=f32)
res["serve adaptive f32"] = dict(frame_ms=[r["ms_per_frame"], min(r["frame_ms"]),
                                           max(r["frame_ms"])])
print(json.dumps(res), flush=True)
"""

# --probe, run once in a checkout: its float32 kernels beside the floors
_PROBE = r"""
import ctypes, json, os, re, shutil, subprocess, sys, tempfile
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.ops.kernels import march as K3
from avr_tpu_torch.ops.kernels import resnetfc as K2

torch.backends.cuda.matmul.allow_tf32 = False
FWD = ("resnetfc_kernel", "resnetfc_fwd_f32_kernel")
WGRAD = ("resnetfc_wgrad_kernel", "resnetfc_wgrad_f32_kernel", "resnetfc_wgrad_reduce_kernel")
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
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
                 "selp.u32 %0, 1, 0, p; }" : "=r"(done) : "r"(smem_u32(bar)), "r"(parity)
                 : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];" :: "r"(smem_u32(dst)), "l"(src), "r"(bytes),
               "r"(smem_u32(bar)) : "memory");
}

__global__ void probe_empty_kernel() {}

constexpr int SLAB = 32768, STAGES = 4;

// n slabs of SLAB bytes through a ring of shared slabs by bulk copies, once a CTA
__global__ void __launch_bounds__(256, 1) probe_stream_bulk_kernel(const unsigned char* w, int n,
                                                                   float* sink) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[STAGES];
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < STAGES && i < n; ++i) {
      mbar_expect_tx(&full[i], SLAB);
      bulk_load(smem + i * SLAB, w + (size_t)i * SLAB, SLAB, &full[i]);
    }
  float acc = 0.f;
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    acc += reinterpret_cast<const float*>(smem + s * SLAB)[threadIdx.x];
    __syncthreads();
    if (threadIdx.x == 0 && i + STAGES < n) {
      mbar_expect_tx(&full[s], SLAB);
      bulk_load(smem + s * SLAB, w + (size_t)(i + STAGES) * SLAB, SLAB, &full[s]);
    }
  }
  if (acc == 1234.5f) sink[blockIdx.x] = acc;
}

// the same bytes read once a CTA through registers (16-byte __ldg, coalesced)
__global__ void __launch_bounds__(256, 1) probe_stream_ldg_kernel(const float4* w, long long n4,
                                                                  float* sink) {
  float acc = 0.f;
#pragma unroll 8
  for (long long i = threadIdx.x; i < n4; i += blockDim.x) {
    const float4 v = __ldg(w + i);
    acc += (v.x + v.y) + (v.z + v.w);
  }
  if (acc == 1234.5f) sink[blockIdx.x] = acc;
}

// the parent float32 wgrad's inner loop (csrc/resnetfc.cu wgrad_step: rows
// g + 8 hi of two 16-row blocks, columns nt 8 + 2 t + cc) on shared tiles
typedef float Frag[2][8][4];
__device__ __forceinline__ void parent_wgrad_step(const float* Gs, const float* As, int m0,
                                                  int n0, Frag& acc) {
  constexpr int L = 132;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < 16; ++k)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const float gv = Gs[k * L + m0 + mt * 16 + g + 8 * hi];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc)
            acc[mt][nt][2 * hi + cc] = fmaf(gv, As[k * L + n0 + nt * 8 + 2 * t + cc],
                                            acc[mt][nt][2 * hi + cc]);
      }
}

__global__ void __launch_bounds__(256) probe_wgrad_parent_kernel(int steps, float* sink) {
  __shared__ __align__(16) float Gs[2][16 * 132];
  __shared__ __align__(16) float As[2][16 * 132];
  for (int i = threadIdx.x; i < 2 * 16 * 132; i += 256) {
    (&Gs[0][0])[i] = 1e-3f * (float)(i % 7);
    (&As[0][0])[i] = 1e-3f * (float)(i % 5);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, m0 = (warp & 3) * 32, n0 = (warp >> 2) * 64;
  Frag acc;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;
  for (int s = 0; s < steps; ++s) {
    parent_wgrad_step(Gs[s & 1], As[s & 1], m0, n0, acc);
    __syncthreads();
  }
  float t = 0.f;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) t += acc[a][b][c];
  if (t == 1234.5f) sink[blockIdx.x] = t;
}

// a register-tiled loop: 8 x 8 outputs a thread (two 4-wide groups 64 apart
// in each dimension) read with four 16-byte shared loads for 64 FMAs
__global__ void __launch_bounds__(256, 2) probe_wgrad_tiled_kernel(int steps, float* sink) {
  __shared__ __align__(16) float Gs[2][16 * 128];
  __shared__ __align__(16) float As[2][16 * 128];
  for (int i = threadIdx.x; i < 2 * 16 * 128; i += 256) {
    (&Gs[0][0])[i] = 1e-3f * (float)(i % 7);
    (&As[0][0])[i] = 1e-3f * (float)(i % 5);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ty = (warp >> 1) * 4 + (lane >> 3), tx = (warp & 1) * 8 + (lane & 7);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int s = 0; s < steps; ++s) {
    const float* g = Gs[s & 1];
    const float* a = As[s & 1];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float4 g0 = *reinterpret_cast<const float4*>(g + k * 128 + ty * 4);
      const float4 g1 = *reinterpret_cast<const float4*>(g + k * 128 + 64 + ty * 4);
      const float4 a0 = *reinterpret_cast<const float4*>(a + k * 128 + tx * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(a + k * 128 + 64 + tx * 4);
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(gv[i], av[j], acc[i][j]);
    }
    __syncthreads();
  }
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) t += acc[i][j];
  if (t == 1234.5f) sink[blockIdx.x] = t;
}

// a register-tiled forward loop: a 32-point tile, 8 points x 8 columns a
// thread (points tp + 4 i, columns 4 tc and 256 + 4 tc), the points' rows
// read along k by 16-byte loads, a 16 x 512 weight slab by two a k
__global__ void __launch_bounds__(256, 1) probe_fwd_loop_kernel(int slabs, float* sink) {
  extern __shared__ __align__(16) float sm[];
  float* As = sm;
  float* Ws = sm + 32 * 516;
  for (int i = threadIdx.x; i < 32 * 516 + 16 * 512; i += 256) sm[i] = 1e-3f * (float)(i % 7);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tp = lane >> 3, tc = warp * 8 + (lane & 7), c0 = tc * 4, c1 = 256 + tc * 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int s = 0; s < slabs; ++s) {
    const float* A = As + (s & 31) * 16;
#pragma unroll
    for (int k4 = 0; k4 < 16; k4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(A + (tp + 4 * i) * 516 + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(Ws + (k4 + kk) * 512 + c0);
        const float4 b1 = *reinterpret_cast<const float4*>(Ws + (k4 + kk) * 512 + c1);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) t += acc[i][j];
  if (t == 1234.5f) sink[blockIdx.x] = t;
}

static int smem_attr(const void* fn, int bytes) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}
extern "C" int probe_empty(unsigned blocks, unsigned threads, int smem, void* sink,
                           void* stream) {
  int e = smem_attr((const void*)probe_empty_kernel, smem);
  if (e) return e;
  probe_empty_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
extern "C" int probe_stream_bulk(const void* w, int n, unsigned blocks, void* sink, void* stream) {
  int e = smem_attr((const void*)probe_stream_bulk_kernel, STAGES * SLAB);
  if (e) return e;
  probe_stream_bulk_kernel<<<blocks, 256, STAGES * SLAB, (cudaStream_t)stream>>>(
      (const unsigned char*)w, n, (float*)sink);
  return (int)cudaGetLastError();
}
extern "C" int probe_stream_ldg(const void* w, long long n4, unsigned blocks, int smem,
                                void* sink, void* stream) {
  int e = smem_attr((const void*)probe_stream_ldg_kernel, smem);
  if (e) return e;
  probe_stream_ldg_kernel<<<blocks, 256, smem, (cudaStream_t)stream>>>((const float4*)w, n4,
                                                                        (float*)sink);
  return (int)cudaGetLastError();
}
extern "C" int probe_wgrad_parent(unsigned blocks, int steps, void* sink, void* stream) {
  probe_wgrad_parent_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(steps, (float*)sink);
  return (int)cudaGetLastError();
}
extern "C" int probe_wgrad_tiled(unsigned blocks, int steps, void* sink, void* stream) {
  probe_wgrad_tiled_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(steps, (float*)sink);
  return (int)cudaGetLastError();
}
extern "C" int probe_fwd_loop(unsigned blocks, int slabs, void* sink, void* stream) {
  const int smem = 200 * 1024;  // one CTA an SM, as a forward tile with its ring
  int e = smem_attr((const void*)probe_fwd_loop_kernel, smem);
  if (e) return e;
  probe_fwd_loop_kernel<<<blocks, 256, smem, (cudaStream_t)stream>>>(slabs, (float*)sink);
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
                "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so, os.path.join(tmp, "probe.cu")],
               check=True)
lib = ctypes.CDLL(so)
V, U, I, L = ctypes.c_void_p, ctypes.c_uint, ctypes.c_int, ctypes.c_longlong
for name, argtypes in (("probe_empty", [U, U, I, V, V]), ("probe_stream_bulk", [V, I, U, V, V]),
                       ("probe_stream_ldg", [V, L, U, I, V, V]),
                       ("probe_wgrad_parent", [U, I, V, V]), ("probe_wgrad_tiled", [U, I, V, V]),
                       ("probe_fwd_loop", [U, I, V, V])):
    getattr(lib, name).argtypes = argtypes
stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
sink = torch.zeros(1 << 16, device=cs.DEV)


def dev(fn, names, iters=5):
    return sum(cs.kernel_device_ms(fn, names, iters).values())


def call(fn, *a):
    err = fn(*a, sink.data_ptr(), stream())
    if err:
        raise RuntimeError(f"probe launch failed: cudaError {err}")


res = {"checkout": sys.argv[1]}
f32 = torch.float32
# (a), (b): the tree's forward at the band beside the floors
gen = torch.Generator(device=cs.DEV).manual_seed(6)
w = cs.decoder_weights(gen)
kw = dict(n_blocks=5, n_lin_z=3, code=cs.CODE, activate_out=True, compute_dtype=f32)
x = (torch.rand(1, cs.BAND, cs.CODE.d_raw, generator=gen, device=cs.DEV) * 2 - 1).contiguous()
z = cs.randn(gen, 1, cs.BAND, cs.C)
tiles = -(-cs.BAND // 32)
SLABS, SLAB_FLOATS = 420, 8192  # 16 rows of 512 floats: the decoder's 13.76 MB
wbuf = torch.randn(SLABS * SLAB_FLOATS, device=cs.DEV)
parent_smem = 32 * (516 + 516) * 4  # the parent forward's tile: 32 x (k + 4) twice
fwd_flops = cs.decoder_flops(cs.BAND, 1)
loop_flops = lambda blocks, steps: blocks * steps * 16 * 128 * 128 * 2
ms = dev(lambda: cs.fused_resnetfc(x, z, w, **kw), FWD)
res["forward"] = {
    "kernel": dict(device_ms=ms, tflops=fwd_flops / ms / 1e9),
    "empty, parent geometry": dict(device_ms=dev(
        lambda: call(lib.probe_empty, tiles, 256, parent_smem), ("probe_empty_kernel",), 20)),
    "stream bulk, 32-point tiles": dict(device_ms=dev(
        lambda: call(lib.probe_stream_bulk, wbuf.data_ptr(), SLABS, tiles),
        ("probe_stream_bulk_kernel",))),
    "stream bulk, 64-point tiles": dict(device_ms=dev(
        lambda: call(lib.probe_stream_bulk, wbuf.data_ptr(), SLABS, tiles // 2),
        ("probe_stream_bulk_kernel",))),
    "stream ldg, 32-point tiles": dict(device_ms=dev(
        lambda: call(lib.probe_stream_ldg, wbuf.data_ptr(), SLABS * SLAB_FLOATS // 4, tiles,
                     parent_smem), ("probe_stream_ldg_kernel",))),
    "FMA loop from shared, 32-point tiles": dict(device_ms=dev(
        lambda: call(lib.probe_fwd_loop, tiles, SLABS), ("probe_fwd_loop_kernel",)))}
for k, ctas in (("stream bulk, 32-point tiles", tiles), ("stream ldg, 32-point tiles", tiles),
                ("stream bulk, 64-point tiles", tiles // 2)):
    r = res["forward"][k]
    r["l2_tb_s"] = ctas * SLABS * SLAB_FLOATS * 4 / r["device_ms"] / 1e9
r = res["forward"]["FMA loop from shared, 32-point tiles"]
r["tflops"] = loop_flops(tiles, SLABS) / r["device_ms"] / 1e9
del x, z, wbuf
# (c): the wgrad at K3's two jobs and K2's 15 beside its inner loop alone
kg = torch.Generator(device=cs.DEV).manual_seed(19)
rows, hid = cs.K3_F32_JOB_ROWS, cs.HIDDEN
vld, dgl = cs.C + -(-hid // 4) * 4, K3.gate_row_width(hid)
v = cs.randn(kg, rows, vld)
dg = cs.randn(kg, rows, dgl)
outs = [torch.zeros((cs.C, 4 * hid), device=cs.DEV), torch.zeros((hid, 4 * hid), device=cs.DEV)]
k3 = lambda: K2.wgrad(K3.NAME_WGRAD, [
    (v.data_ptr(), dg.data_ptr(), outs[0], None, rows, vld, dgl, cs.C, 4 * hid),
    (v.data_ptr() + 4 * cs.C, dg.data_ptr(), outs[1], None, rows, vld, dgl, hid, 4 * hid)],
    f32, cs.DEV)
k3_split = cs.kernel_device_ms(k3, WGRAD, 20)
plan = K2.wgrad_plan([(rows, cs.C, 4 * hid, False), (rows, hid, 4 * hid, False)], f32)
res["wgrad K3"] = dict(device_ms=sum(k3_split.values()), by_kernel=k3_split,
                       ctas=sum(plan.blocks), matmul_ms=cs.time_ms(lambda: torch.matmul(v.t(), dg),
                                                                   iters=20))
del v, dg, outs
wg = torch.Generator(device=cs.DEV).manual_seed(17)
x = (torch.rand(1, cs.BAND_TRAIN, cs.CODE.d_raw, generator=wg, device=cs.DEV) * 2 - 1).contiguous()
z = cs.randn(wg, 1, cs.BAND_TRAIN, cs.C)
g = cs.randn(wg, cs.BAND_TRAIN, 4) + 0.5
args = K2._prepare(x, z, w, cs.CODE, f32)
dims = K2._dims(args, 5, 3, True)
st = K2._forward(args, dims, f32, True)[1]
gs, wT, grads = K2._bwd_operands(args, dims, g, K2.NAME_DGRAD)
_, _, cot, gout, enc = K2._dgrad(args, dims, st, gs, wT, f32)
k2 = lambda: K2._wgrad(cs.BAND_TRAIN, args["z"], st, cot, gout, enc, grads, dims, f32)
k2_split = cs.kernel_device_ms(k2, WGRAD, 3)
shapes = [(cs.BAND_TRAIN, 512, 512, True)] * 13 + [(cs.BAND_TRAIN, 512, 64, True),
                                                  (cs.BAND_TRAIN, 4, 512, True)]
res["wgrad K2"] = dict(device_ms=sum(k2_split.values()), by_kernel=k2_split,
                       ctas=sum(K2.wgrad_plan(shapes, f32).blocks))
del x, z, g, args, st, gs, wT, grads, cot, gout, enc
# the parent's grids: K3 5 tiles x 8 splits of 20,480 rows, K2 1,728 CTAs of
# 40,960 rows; 16 rows a step
for label, blocks, steps in (("K3 parent grid", 40, 1280), ("K2 parent grid", 1728, 2560),
                             ("K3 work on 264 CTAs", 264, 40 * 1280 // 264)):
    for kind, fn, names in (("parent loop", lib.probe_wgrad_parent, "probe_wgrad_parent_kernel"),
                            ("tiled loop", lib.probe_wgrad_tiled, "probe_wgrad_tiled_kernel")):
        if kind == "parent loop" and label.startswith("K3 work"):
            continue
        ms = dev(lambda: call(fn, blocks, steps), (names,), 3)
        res[f"wgrad {kind}, {label}"] = dict(device_ms=ms,
                                             tflops=loop_flops(blocks, steps) / ms / 1e9)
# (e) SASS counts of the tree's float32 forward and wgrad kernels
tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
if os.path.exists(tool):
    sass = subprocess.run([tool, "-sass", info["path"]], capture_output=True, text=True).stdout
    for f in re.split(r"\n\s*(?=Function : )", sass):
        if not f.startswith("Function : "):
            continue
        fname = f.split()[2]
        if not any(n in fname for n in ("resnetfc_kernelIf", "resnetfc_wgrad_kernelIf",
                                        "resnetfc_fwd_f32", "resnetfc_wgrad_f32")):
            continue
        ins = [l for l in f.splitlines() if re.search(r"/\*[0-9a-f]{4,}\*/", l)]
        count = lambda op: sum(bool(re.search(r"\b" + op + r"\b", l)) for l in ins)
        res["sass " + fname] = dict(instructions=len(ins), ffma=count("FFMA"),
                                    lds=sum("LDS" in l for l in ins),
                                    lds128=sum("LDS.128" in l for l in ins),
                                    ldg=sum("LDG" in l for l in ins),
                                    ldgsts=count("LDGSTS"), bar=count("BAR"))
shutil.rmtree(tmp)
print(json.dumps(res), flush=True)
"""


if __name__ == "__main__":
    if sys.argv[1:2] == ["--probe"]:
        sys.exit(march_turns.run(_PROBE, sys.argv[2:], both_orders=False))
    sys.exit(march_turns.main(_TURN, __doc__))
