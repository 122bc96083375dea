"""K2: fused FC-ResNet field decoder — CUDA kernels (forward, forward with
activation stash, stash backward, recompute backward), the autograd
function that joins them, and the plain version.

Replaces ``avr_tpu/ops/pallas/resnetfc.py:896 fused_resnetfc``: the forward
(``:726``), its stash mode (``:637-653``), the stash backward
``_bwd_stash_impl`` (``:400-575``, call ``:823``) and the recompute backward
``_bwd_impl`` (``:248-390``, call ``:853``).  The function: an optional
in-kernel positional encoding of the raw ``[xyz | viewdir]`` lanes
(:class:`CodeSpec`); per source view, ``lin_in`` and the first ``n_lin_z``
blocks, each preceded by a latent injection ``h += z @ Wz_k + bz_k``; the
mean over views; the remaining blocks; ``relu -> lin_out``; optionally
``sigmoid(rgb) / relu(sigma)``.  A block is ``h + relu(relu(h) @ W0 + b0) @
W1 + b1``.  The residual trunk ``h`` and its cotangent are float32; matmul
operands (weights, biases, activations, cotangents, the encoded input and
the latent) are rounded to the compute dtype and accumulate in float32.

What bounds it on Hopper: operations.  Forward at the band call of a train
step (327,680 points, d_hidden 512, 13 hidden products, 6.86 MFLOP a point)
~2.27 ms at the bf16 tensor-core peak; the backward does twice the products
(~4.5 ms) against ~2.4 ms of stash reads and cotangent writes.  Which
forward kernel a call launches is :func:`forward_route`'s choice, by dtype
and shape: bf16 inside the wgmma kernel's envelope (``d_latent`` and the
encoded input lanes at most 512: every shipped config) takes
``csrc/resnetfc_hopper.cu``'s ``resnetfc_fwd_wgmma_kernel``: one CTA per
64-point tile, the float32 trunk in two consumer warpgroups' registers, a
producer thread streaming every product's weight k-slabs through a
shared-memory ring by TMA, ``wgmma`` on the swizzled operand tile, the
stash stored from that tile by TMA.  bf16 outside that envelope
takes ``csrc/resnetfc.cu``'s 32-point ``mma.sync`` kernel, whose ~6.8 MB of
weights stream from L2 for every tile.  float32 takes
``csrc/resnetfc.cu``'s ``resnetfc_fwd_f32_kernel`` (:func:`f32_forward_plan`):
a CTA a 32-point tile, register-tiled FMA products (8 points x 8 columns a
thread, the trunk in registers), the transposed weights' 16-row slabs
streamed through a shared-memory ring by copies the warps take turns to
issue.
Under autograd the forward also writes the 2 * n_blocks + 1 post-ReLU
activations (bf16, 11.3 KB a point) for the backward.  bf16 backward
(``csrc/resnetfc_hopper.cu``), on ``wgmma`` with
TMA-fed tiles: the dgrad walks each 64-point tile's chain in reverse (the
float32 trunk cotangent in two consumer warpgroups' registers, the
transposed weights' k-slabs streamed through a shared-memory ring by a
producer thread, the ReLU masks' stash rows loaded ahead of each product),
writes every product's rounded output cotangent by TMA store (11 rows of
512 a point), then a tail kernel forms ``dz`` as one K = n_lin_z x 512
product over the injections' stored cotangents, the encoding's gradient
and ``dx``; the wgrad sums ``dW = G^T A`` over the points in 128 x 128
tiles with both operands MN-major in shared memory, rows split by
:func:`wgrad_plan` into at least two waves of CTAs per job, the float32
partial tiles added by a second kernel in split order (deterministic), the
bias gradients column sums of the same rounded cotangents.  float32
operands take ``csrc/resnetfc.cu``'s FMA dgrad with the ``mma.sync``
forward's 32-point tiling, and its register-tiled wgrad
(``resnetfc_wgrad_f32_kernel``: 8 x 8 outputs a thread from staged K-major
tiles), whose rows split as the bf16 wgrad's do (:func:`wgrad_plan`'s
float32 rule: at least ``WGRAD_WAVES_F32`` waves of CTAs a job) and whose
splits' partial tiles the bf16 wgrad's reduction adds in split order, so
float32 too is the same run to run.

``stash`` picks the backward as JAX does: ``True`` the stash backward,
``False`` the recompute backward, ``"auto"`` the stash while the call's
stash (``stash_slots * N * d_hidden`` compute-dtype values) is at most
6 GiB.  The recompute backward stores no O(N) activations: the host walks
the points in chunks of ``RECOMPUTE_CHUNK = 262,144`` and per chunk
launches the stash forward into a chunk-sized workspace, the dgrad on it
(counted as the recompute) and the wgrad, which adds the chunk's ``dW``
into the float32 sums; so it equals the stash backward bit for bit by
construction.  Its workspace (stash and cotangents, ~5.9 GB in bf16 at NS
1 and width 512) is sized by the chunk, not by ``N``.  A VR train step at
``conf/default_mv.conf`` width (4 x 4,096 rays, one chunk) has 1,048,576
coarse and 1,572,864 fine points: 4 + 6 chunks.  Bound on H100:
operations, ~20.6 MFLOP a point (recompute, dgrad and wgrad products).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from avr_tpu_torch.ops.kernels import _build

__all__ = ["CodeSpec", "DecoderWeights", "f32_forward_plan", "forward_route", "fused_resnetfc",
           "resnetfc_plain", "use_stash", "encode_tables", "wgrad_plan"]

NAME = "fused_resnetfc"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclass(frozen=True)
class CodeSpec:
    """The in-decoder positional encoding (``avr_tpu`` ``CodeSpec``).

    Raw input ``[coded dims | passthrough dims]``; encoded layout: optional
    raw coded dims, then ``sin(f_k x + phase_k)`` as channel ``k*d_coded +
    d`` with ``f_k = freq_factor * 2**(k//2)`` and ``phase_k = (k%2)*pi/2``,
    then the passthrough dims.
    """

    num_freqs: int
    freq_factor: float
    include_input: bool
    d_coded: int
    d_pass: int = 0

    @property
    def d_raw(self) -> int:
        return self.d_coded + self.d_pass

    @property
    def d_enc(self) -> int:
        return (self.d_coded if self.include_input else 0) + \
            2 * self.num_freqs * self.d_coded + self.d_pass


class DecoderWeights(NamedTuple):
    """Decoder parameters in ``nn.Linear`` layout ``(out, in)``, stacked."""

    wi: torch.Tensor  # (dh, d_enc)
    bi: torch.Tensor  # (dh,)
    wz: torch.Tensor  # (n_lin_z, dh, d_latent)
    bz: torch.Tensor  # (n_lin_z, dh)
    w0: torch.Tensor  # (n_blocks, dh, dh)
    b0: torch.Tensor  # (n_blocks, dh)
    w1: torch.Tensor  # (n_blocks, dh, dh)
    b1: torch.Tensor  # (n_blocks, dh)
    wo: torch.Tensor  # (d_out, dh)
    bo: torch.Tensor  # (d_out,)


_RAW, _SIN, _ZERO = 0, 1, 2


def encode_tables(code: Optional[CodeSpec], d_in: int, width: int):
    """Per encoded column: (mode, source lane, frequency, phase), padded
    with zero columns to ``width``.  ``code=None`` is the identity on
    ``d_in`` already-encoded lanes."""
    mode = np.full(width, _ZERO, np.int32)
    src = np.zeros(width, np.int32)
    f = np.ones(width, np.float32)
    ph = np.zeros(width, np.float32)
    if code is None:
        mode[:d_in], src[:d_in] = _RAW, np.arange(d_in)
        return mode, src, f, ph
    dc, col = code.d_coded, 0
    if code.include_input:
        mode[:dc], src[:dc] = _RAW, np.arange(dc)
        col = dc
    for k in range(2 * code.num_freqs):
        cols = col + k * dc + np.arange(dc)
        mode[cols], src[cols] = _SIN, np.arange(dc)
        f[cols] = code.freq_factor * 2.0 ** (k // 2)
        ph[cols] = (k % 2) * (np.pi / 2.0)
    col += 2 * code.num_freqs * dc
    mode[col:col + code.d_pass] = _RAW
    src[col:col + code.d_pass] = dc + np.arange(code.d_pass)
    return mode, src, f, ph


def _encode(p: torch.Tensor, code: CodeSpec) -> torch.Tensor:
    """``(N, d_raw)`` float32 -> ``(N, d_enc)`` float32 (the decoder prologue)."""
    mode, src, f, ph = (torch.from_numpy(a).to(p.device)
                        for a in encode_tables(code, code.d_raw, code.d_enc))
    lanes = p[:, src.long()]
    return torch.where(mode == _SIN, torch.sin(lanes * f + ph), lanes)


def resnetfc_plain(x: torch.Tensor, z: torch.Tensor, w: DecoderWeights, *,
                   n_blocks: int, n_lin_z: int, compute_dtype: torch.dtype,
                   code: Optional[CodeSpec] = None,
                   activate_out: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``x (NS, N, d_in)``, ``z
    (NS, N, d_latent)`` -> ``(N, d_out)`` float32."""
    c = lambda t: t.to(compute_dtype).float()  # operand rounding, f32 math
    wi, bi, wz, bz, w0, b0, w1, b1, wo, bo = (c(t) for t in w)

    def block(h, k):
        a2 = c(torch.relu(c(torch.relu(h)) @ w0[k].T + b0[k]))
        return h + a2 @ w1[k].T + b1[k]

    ns = x.shape[0]
    h_sum = None
    for v in range(ns):
        p = x[v].float()
        if code is not None:
            p = _encode(p, code)
        zv = c(z[v])
        h = c(p) @ wi.T + bi
        for k in range(n_lin_z):
            h = h + zv @ wz[k].T + bz[k]
            h = block(h, k)
        h_sum = h if h_sum is None else h_sum + h
    h = h_sum if ns == 1 else h_sum * (1.0 / ns)
    for k in range(n_lin_z, n_blocks):
        h = block(h, k)
    out = c(torch.relu(h)) @ wo.T + bo
    if activate_out:
        out = torch.cat([torch.sigmoid(out[:, :3]), torch.relu(out[:, 3:])], dim=-1)
    return out


_STASH_BUDGET_BYTES = 6 * 1024 ** 3  # resnetfc.py:893: above it JAX recomputes instead
RECOMPUTE_CHUNK = 262_144  # points per recompute launch: bounds its workspace
GOUT_W = 8  # row width of the rounded output cotangent (csrc/resnetfc.cu)
NAME_STASH = "fused_resnetfc_stash"
NAME_WGMMA = "fused_resnetfc_wgmma"  # forwards (stash or not) on the wgmma route
NAME_DGRAD = "fused_resnetfc_bwd_dgrad"
NAME_WGRAD = "fused_resnetfc_bwd_wgrad"
NAME_WGRAD_F32 = "resnetfc_wgrad_f32"  # every float32 wgrad launch (K2's and K3's)
NAME_RECOMPUTE = "fused_resnetfc_bwd_recompute"


def stash_slot(k: int, j: int, v: int, ns: int, n_lin_z: int) -> int:
    """Slot of block ``k``'s activation ``j`` (0: ``relu(h)``, 1:
    ``relu(fc_0)``) for view ``v``, in the stash and in the cotangents."""
    return (2 * k + j) * ns + v if k < n_lin_z else 2 * n_lin_z * ns + 2 * (k - n_lin_z) + j


def stash_slots(ns: int, n_blocks: int, n_lin_z: int) -> int:
    return 2 * n_lin_z * ns + 2 * (n_blocks - n_lin_z) + 1


def cot_slots(ns: int, n_blocks: int, n_lin_z: int) -> int:
    """The cotangent slots: one per stash slot but lin_out's, then lin_in's
    output cotangent per view."""
    return 2 * n_lin_z * ns + 2 * (n_blocks - n_lin_z) + ns


def stash_bytes(ns: int, N: int, d_hidden: int, n_blocks: int, n_lin_z: int,
                compute_dtype: torch.dtype) -> int:
    """The call's stash in bytes, as ``stash="auto"`` measures it
    (``avr_tpu/ops/pallas/resnetfc.py:945-948``)."""
    item = torch.empty((), dtype=compute_dtype).element_size()
    return N * d_hidden * item * stash_slots(ns, n_blocks, n_lin_z)


def use_stash(stash, ns: int, N: int, d_hidden: int, n_blocks: int, n_lin_z: int,
              compute_dtype: torch.dtype) -> bool:
    """Which backward a call takes: the stash one (True) or the recompute
    one (False); ``"auto"`` takes the stash while it fits the 6 GiB budget."""
    if stash == "auto":
        return stash_bytes(ns, N, d_hidden, n_blocks, n_lin_z,
                           compute_dtype) <= _STASH_BUDGET_BYTES
    if isinstance(stash, bool):
        return stash
    raise ValueError(f"{NAME}: stash must be True, False or 'auto', got {stash!r}")


def d_enc_padded(d_enc: int) -> int:
    """lin_in's input lanes as the kernels take them: a multiple of 64."""
    return (d_enc + 63) // 64 * 64


def _prepare(x, z, w: DecoderWeights, code, compute_dtype):
    """The kernels' operands: detached, contiguous, in the compute dtype
    (biases rounded to it and held in float32), lin_in zero-padded to a
    multiple of 64 input lanes, and the encoding tables."""
    ns, N, d_in = x.shape
    d_hidden, d_enc = w.wi.shape
    dev = x.device
    k_in = d_enc_padded(d_enc)
    mode, src, f, ph = encode_tables(code, d_in, k_in)
    cd = lambda t: t.detach().to(compute_dtype).contiguous()
    wi = torch.zeros((d_hidden, k_in), dtype=compute_dtype, device=dev)
    wi[:, :d_enc] = w.wi.detach()
    biases = [t.detach().to(compute_dtype).float().contiguous()
              for t in (w.bi, w.bz, w.b0, w.b1, w.bo)]
    a = dict(x=x.detach().float().contiguous(), z=cd(z), wi=wi, wz=cd(w.wz), w0=cd(w.w0),
             w1=cd(w.w1), wo=cd(w.wo), bi=biases[0], bz=biases[1], b0=biases[2],
             b1=biases[3], bo=biases[4],
             tables=torch.from_numpy(np.stack([mode, src]).astype(np.int32)).to(dev),
             fph=torch.from_numpy(np.stack([f, ph])).to(dev))
    if compute_dtype == torch.float32:
        # the float32 forward streams k-row slabs of the transposed weights,
        # which the float32 dgrad reads too; its latent rows go by bulk
        # copies, 16-byte aligned
        a.update(zip(_T_KEYS, _transposed(a)))
        if a["z"].data_ptr() % 16:
            a["z"] = a["z"].clone()
    return a


_T_KEYS = ("wiT", "wzT", "w0T", "w1T")


def _transposed(a):
    """lin_in, the injections and the blocks' weights transposed: ``(k_in,
    dh)``, ``(n_lin_z, dl, dh)``, ``(n_blocks, dh, dh)`` twice."""
    return [a["wi"].t().contiguous()] + [a[k].transpose(1, 2).contiguous()
                                         for k in ("wz", "w0", "w1")]


_FWD_ORDER = ("x", "z", "wi", "bi", "wz", "bz", "w0", "b0", "w1", "b1", "wo", "bo", "tables",
              "fph")
_DIM_ORDER = ("N", "ns", "d_in", "k_in", "d_latent", "d_hidden", "d_out", "n_blocks",
              "n_lin_z", "activate")


def _dims(a, n_blocks, n_lin_z, activate_out):
    ns, N, d_in = a["x"].shape
    d_hidden, k_in = a["wi"].shape
    return dict(N=N, ns=ns, d_in=d_in, k_in=k_in, d_latent=a["z"].shape[-1], d_hidden=d_hidden,
                d_out=a["wo"].shape[0], n_blocks=n_blocks, n_lin_z=n_lin_z,
                activate=int(activate_out))


# The bf16 wgmma forward's envelope (csrc/resnetfc_hopper.cu FWD_K_MAX):
# its operand tile holds at most 512 encoded input lanes, latent lanes and
# trunk columns; its points come in tiles of FWD_TILE.
FWD_K_MAX, FWD_TILE = 512, 64


def forward_route(compute_dtype: torch.dtype, d_latent: int, k_in: int) -> str:
    """The forward kernel that a call with these operands launches on the
    card, for every shape :func:`fused_resnetfc` takes (``d_latent`` a
    multiple of 64, ``k_in`` encoded input lanes padded to a multiple of 64;
    every ``d_hidden`` it takes, 64..512, and every number of views take the
    same route): ``"wgmma"`` (bf16 with ``d_latent`` and ``k_in`` at most
    512, ``csrc/resnetfc_hopper.cu``), ``"mma_sync"`` (other bf16) or
    ``"fma"`` (float32: ``resnetfc_fwd_f32_kernel``), both
    ``csrc/resnetfc.cu``.  A route's build or launch failure raises: no call
    changes kernel."""
    if compute_dtype == torch.float32:
        return "fma"
    return "wgmma" if d_latent <= FWD_K_MAX and k_in <= FWD_K_MAX else "mma_sync"


# The float32 forward (csrc/resnetfc.cu resnetfc_fwd_f32_kernel): a CTA a
# tile of F32_FWD_TILE points and d_hidden / 2 threads (the warps take
# turns to issue the slabs), a ring of F32_FWD_STAGES slabs of F32_FWD_SLAB
# k rows of the transposed weights (each stage also holding a latent slab's
# 32 rows of F32_FWD_SLAB + 4 floats) and an A tile of 32 rows of d_hidden
# + 4 floats; the source's F32_TM, F32_KS, F32_STAGES and F32_ZLD.
F32_FWD_TILE, F32_FWD_SLAB, F32_FWD_STAGES = 32, 16, 4


class F32FwdPlan(NamedTuple):
    tile: int         # points a CTA
    blocks: int       # CTAs: every point in one tile
    threads: int      # d_hidden / 2
    cluster: int      # CTAs a cluster (1: none)
    smem: int         # bytes of dynamic shared memory
    slabs: int        # weight slabs a tile streams through the ring
    products: tuple   # (weight, block, view, slabs, stash slot of its A operand or None)


def f32_forward_plan(N: int, ns: int, d_hidden: int, d_latent: int, k_in: int, n_blocks: int,
                     n_lin_z: int) -> F32FwdPlan:
    """The float32 forward's launch for a shape: tile, threads, shared bytes
    and the products in the order the kernel streams their slabs (per
    view lin_in, then each injection's latent product and its block's two
    products, then the pooled blocks, then lin_out, which reads its weights
    directly).  Each block's two products' A operands (relu(h) and
    relu(fc_0)) are the stash slots the kernel writes, and lin_out's the
    last one."""
    s = F32_FWD_SLAB
    stage = s * d_hidden + F32_FWD_TILE * (s + 4)
    smem = 4 * (F32_FWD_STAGES * stage + F32_FWD_TILE * (d_hidden + 4)) + 16 * F32_FWD_STAGES
    products = []
    for v in range(ns):
        products.append(("wi", None, v, k_in // s, None))
        for k in range(n_lin_z):
            products += [("wz", k, v, d_latent // s, None),
                         ("w0", k, v, d_hidden // s, stash_slot(k, 0, v, ns, n_lin_z)),
                         ("w1", k, v, d_hidden // s, stash_slot(k, 1, v, ns, n_lin_z))]
    for k in range(n_lin_z, n_blocks):
        products += [("w0", k, 0, d_hidden // s, stash_slot(k, 0, 0, ns, n_lin_z)),
                     ("w1", k, 0, d_hidden // s, stash_slot(k, 1, 0, ns, n_lin_z))]
    products.append(("wo", None, 0, 0, stash_slots(ns, n_blocks, n_lin_z) - 1))
    return F32FwdPlan(F32_FWD_TILE, -(-N // F32_FWD_TILE), d_hidden // 2, 1, smem,
                      sum(p[3] for p in products), tuple(products))


# the forward's C entry points: the operands in _FWD_ORDER, out, stash (and
# the wgmma and float32 kernels' view-sum scratch), the dims in _DIM_ORDER,
# the stream
FWD_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
FWD_WGMMA_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
NAME_F32 = "fused_resnetfc_f32"  # forwards (stash or not) on the float32 kernel


def _forward(a, d, compute_dtype, stash: bool, st=None):
    """Launch the forward on :func:`forward_route`'s kernel; with ``stash``
    also return the activations (written into ``st`` where given).  Counted
    under ``NAME`` or ``NAME_STASH``, and the wgmma route also under
    ``NAME_WGMMA``, the float32 one under ``NAME_F32``."""
    dev = a["x"].device
    N, ns, dh = d["N"], d["ns"], d["d_hidden"]
    out = torch.empty((N, d["d_out"]), dtype=torch.float32, device=dev)
    if stash and st is None:
        st = torch.empty((stash_slots(ns, d["n_blocks"], d["n_lin_z"]), N, dh),
                         dtype=compute_dtype, device=dev)
    if N == 0:
        return out, st
    route = forward_route(compute_dtype, d["d_latent"], d["k_in"])
    ptrs = [_build.ptr(a[k]) for k in _FWD_ORDER] + [_build.ptr(out),
                                                     _build.ptr(st) if stash else None]
    dims = [d[k] for k in _DIM_ORDER]
    stream = ctypes.c_void_p(_build.stream_ptr(dev))
    if route == "wgmma":
        # the view sums of NS > 1: per 64-point tile, 64 x 128 floats for each
        # 128-column half of each consumer warpgroup's d_hidden / 2 columns
        halves = 2 if dh > 256 else 1
        pool = (torch.empty(((N + FWD_TILE - 1) // FWD_TILE * FWD_TILE, 256 * halves),
                            dtype=torch.float32, device=dev) if ns > 1 else None)
        fn = _build.kernel_fn("avr_resnetfc_fwd_bf16", FWD_WGMMA_ARGTYPES)
        err = fn(*ptrs, _build.ptr(pool) if ns > 1 else None, *dims, stream)
    elif route == "fma":
        # the transposed weights in place of wi, wz, w0, w1; the view sums of
        # NS > 1: 32 x d_hidden floats a tile
        ptrs = [_build.ptr(a.get(k + "T", a[k])) for k in _FWD_ORDER] + ptrs[len(_FWD_ORDER):]
        plan = f32_forward_plan(N, ns, dh, d["d_latent"], d["k_in"], d["n_blocks"], d["n_lin_z"])
        pool = (torch.empty((plan.blocks * plan.tile, dh), dtype=torch.float32, device=dev)
                if ns > 1 else None)
        fn = _build.kernel_fn("avr_resnetfc_fwd_f32", FWD_WGMMA_ARGTYPES)  # the same signature
        err = fn(*ptrs, _build.ptr(pool) if ns > 1 else None, *dims, stream)
    else:
        fn = _build.kernel_fn("avr_resnetfc", FWD_ARGTYPES)
        err = fn(*ptrs, *dims, _DTYPES[compute_dtype], stream)
    _build.check(NAME_STASH if stash else NAME, err)
    if route != "mma_sync":
        _build.launches[NAME_WGMMA if route == "wgmma" else NAME_F32] += 1
    return out, st


def _bwd_operands(a, d, g, name):
    """What both backwards share: ``g`` in float32, the transposed weights
    and the zeroed float32 weight-gradient sums."""
    dev = g.device
    dh, dl, nb, nlz = d["d_hidden"], d["d_latent"], d["n_blocks"], d["n_lin_z"]
    g = g.float().contiguous()
    _build.check_cuda_inputs(name, {"g": g}, dev)
    wT = [a[k] for k in _T_KEYS] if "wiT" in a else _transposed(a)
    f32 = dict(dtype=torch.float32, device=dev)
    grads = dict(wi=torch.zeros((dh, d["k_in"]), **f32), bi=torch.zeros((dh,), **f32),
                 wz=torch.zeros((nlz, dh, dl), **f32), bz=torch.zeros((nlz, dh), **f32),
                 w0=torch.zeros((nb, dh, dh), **f32), b0=torch.zeros((nb, dh), **f32),
                 w1=torch.zeros((nb, dh, dh), **f32), b1=torch.zeros((nb, dh), **f32),
                 wo=torch.zeros((d["d_out"], dh), **f32), bo=torch.zeros((d["d_out"],), **f32))
    return g, wT, grads


def _grads_tuple(dx, dz, grads):
    return (dx, dz, grads["wi"], grads["bi"], grads["wz"], grads["bz"], grads["w0"],
            grads["b0"], grads["w1"], grads["b1"], grads["wo"], grads["bo"])


def dgrad_tile(compute_dtype) -> int:
    """Points a dgrad CTA walks: 64 on the bf16 wgmma walk
    (``csrc/resnetfc_hopper.cu``), 32 on the float32 one."""
    return 64 if compute_dtype == torch.bfloat16 else 32


def _dgrad(a, d, st, g, wT, compute_dtype, out=None, pool=None, name=NAME_DGRAD):
    """The dgrad launch on the stash ``st``: ``dx``, ``dz``, and what the
    wgrad reads: the rounded product cotangents ``cot``, the rounded output
    cotangent ``gout`` and the encoded input ``enc``; into ``out`` (those
    five, by name) where given, with ``pool`` the NS > 1 scratch."""
    ns, N, dh = d["ns"], d["N"], d["d_hidden"]
    cd = compute_dtype
    dev = g.device
    if out is None:
        out = dict(dx=torch.zeros((ns, N, d["d_in"]), dtype=torch.float32, device=dev),
                   dz=torch.zeros((ns, N, d["d_latent"]), dtype=cd, device=dev),
                   cot=torch.empty((cot_slots(ns, d["n_blocks"], d["n_lin_z"]), N, dh),
                                   dtype=cd, device=dev),
                   gout=torch.empty((N, GOUT_W), dtype=cd, device=dev),
                   enc=torch.empty((ns, N, d["k_in"]), dtype=cd, device=dev))
    if ns > 1 and pool is None:  # the pooled trunk cotangent, one tile of rows per CTA
        tile = dgrad_tile(cd)
        pool = torch.empty(((N + tile - 1) // tile * tile, dh), dtype=torch.float32, device=dev)
    if N:
        ptrs = [_build.ptr(t) for t in (a["x"], g, st, *wT, a["wo"], a["bo"], a["tables"],
                                        a["fph"], *(out[k] for k in ("dx", "dz", "cot", "gout",
                                                                      "enc")))]
        ptrs.append(_build.ptr(pool) if ns > 1 else None)
        dims = [d[k] for k in _DIM_ORDER]
        stream = ctypes.c_void_p(_build.stream_ptr(dev))
        if cd == torch.bfloat16:
            fn = _build.kernel_fn("avr_resnetfc_dgrad_bf16", [ctypes.c_void_p] * 17
                                  + [ctypes.c_int] * 10 + [ctypes.c_void_p])
            err = fn(*ptrs, *dims, stream)
        else:
            fn = _build.kernel_fn("avr_resnetfc_dgrad", [ctypes.c_void_p] * 17
                                  + [ctypes.c_int] * 11 + [ctypes.c_void_p])
            err = fn(*ptrs, *dims, _DTYPES[cd], stream)
        _build.check(name, err)
    return out["dx"], out["dz"], out["cot"], out["gout"], out["enc"]


def _backward(a, d, st, g, compute_dtype):
    """The stash backward: ``(dx, dz, dwi (dh, k_in), dbi, dwz, dbz, dw0,
    db0, dw1, db1, dwo, dbo)``, weight cotangents in float32."""
    g, wT, grads = _bwd_operands(a, d, g, NAME_DGRAD)
    dx, dz, cot, gout, enc = _dgrad(a, d, st, g, wT, compute_dtype)
    if d["N"]:
        _wgrad(d["N"], a["z"], st, cot, gout, enc, grads, d, compute_dtype)
    return _grads_tuple(dx, dz, grads)


def _recompute_layout(d):
    """(rows per point, row width) of the recompute workspace's stash,
    cotangents, gout and encoded input."""
    ns, nb, nlz = d["ns"], d["n_blocks"], d["n_lin_z"]
    return ((stash_slots(ns, nb, nlz), d["d_hidden"]), (cot_slots(ns, nb, nlz), d["d_hidden"]),
            (1, GOUT_W), (ns, d["k_in"]))


def _recompute_workspace(d, p, compute_dtype, device):
    """The recompute backward's workspace for chunks of up to ``p`` points:
    flat stash, cotangent, gout and encoded-input buffers, and (NS > 1) the
    pooled trunk cotangent."""
    bufs = [torch.empty(k * p * w, dtype=compute_dtype, device=device)
            for k, w in _recompute_layout(d)]
    tile = dgrad_tile(compute_dtype)
    pool = (torch.empty(((p + tile - 1) // tile * tile, d["d_hidden"]), dtype=torch.float32,
                        device=device) if d["ns"] > 1 else None)
    return bufs, pool


def _recompute_chunk(a, d, g, wT, work, s, n, dx, dz, compute_dtype):
    """The recompute backward over points ``[s, s + n)``: the stash forward
    into the workspace ``work``, then the dgrad on it, writing the points'
    rows of ``dx`` and ``dz``.  Returns what the chunk's wgrad reads: its
    latents and, as views of the workspace, its stash, rounded cotangents,
    rounded output cotangent and encoded input."""
    ns, cd, dev = d["ns"], compute_dtype, g.device
    bufs, pool = work
    ac = dict(a, x=a["x"][:, s:s + n].contiguous(), z=a["z"][:, s:s + n].contiguous())
    dc = dict(d, N=n)
    st, cot, gout, enc = (t[:k * n * w].view(k, n, w)
                          for t, (k, w) in zip(bufs, _recompute_layout(d)))
    # one view: the chunk's rows of dx and dz are contiguous; else a copy
    dxc = dx[:, s:s + n] if ns == 1 else torch.empty((ns, n, d["d_in"]), dtype=dx.dtype,
                                                     device=dev)
    dzc = dz[:, s:s + n] if ns == 1 else torch.empty((ns, n, d["d_latent"]), dtype=cd, device=dev)
    _forward(ac, dc, cd, stash=True, st=st)
    _dgrad(ac, dc, st, g[s:s + n], wT, cd, out=dict(dx=dxc, dz=dzc, cot=cot, gout=gout[0], enc=enc),
           pool=pool, name=NAME_RECOMPUTE)
    if ns > 1:
        dx[:, s:s + n].copy_(dxc)
        dz[:, s:s + n].copy_(dzc)
    return ac["z"], st, cot, gout[0], enc


def _backward_recompute(a, d, g, compute_dtype):
    """The recompute backward, in chunks of :data:`RECOMPUTE_CHUNK` points:
    per chunk the stash forward into a chunk-sized workspace, the dgrad on
    it and one wgrad launch adding into the float32 sums.  Returns what
    :func:`_backward` returns."""
    ns, N = d["ns"], d["N"]
    g, wT, grads = _bwd_operands(a, d, g, NAME_RECOMPUTE)
    dev = g.device
    dx = torch.empty((ns, N, d["d_in"]), dtype=torch.float32, device=dev)
    dz = torch.empty((ns, N, d["d_latent"]), dtype=compute_dtype, device=dev)
    # the workspace, sized for one chunk and reused by every chunk
    work = _recompute_workspace(d, min(N, RECOMPUTE_CHUNK), compute_dtype, dev)
    for s in range(0, N, RECOMPUTE_CHUNK):
        n = min(RECOMPUTE_CHUNK, N - s)
        zc, st, cot, gout, enc = _recompute_chunk(a, d, g, wT, work, s, n, dx, dz, compute_dtype)
        _wgrad(n, zc, st, cot, gout, enc, grads, d, compute_dtype)
    return _grads_tuple(dx, dz, grads)


def _wgrad(N, z, st, cot, gout, enc, grads, d, cd):
    """One launch for every weight: ``dW += G^T A`` and ``db += sum G`` over
    ``N`` points (``st``, ``cot`` with ``N`` rows a slot, ``z`` the
    points' latents)."""
    ns, dh, dl = d["ns"], d["d_hidden"], d["d_latent"]
    nb, nlz, k_in, d_out = d["n_blocks"], d["n_lin_z"], d["k_in"], d["d_out"]
    es = st.element_size()
    slot = lambda t, i: t.data_ptr() + i * N * dh * es
    jobs = []  # (G ptr, A ptr, dW, db, rows, ldg, lda, Mg, Ka)
    for k in range(nb):
        rows = ns * N if k < nlz else N
        for j, (wk, bk) in enumerate((("w0", "b0"), ("w1", "b1"))):
            s = stash_slot(k, j, 0, ns, nlz)
            jobs.append((slot(cot, s), slot(st, s), grads[wk][k], grads[bk][k], rows, dh, dh,
                         dh, dh))
    cot_in = slot(cot, 2 * nlz * ns + 2 * (nb - nlz))
    for k in range(nlz):
        gk = cot_in if k == 0 else slot(cot, stash_slot(k - 1, 1, 0, ns, nlz))
        jobs.append((gk, z.data_ptr(), grads["wz"][k], grads["bz"][k], ns * N, dh, dl, dh, dl))
    jobs.append((cot_in, enc.data_ptr(), grads["wi"], grads["bi"], ns * N, dh, k_in, dh, k_in))
    jobs.append((gout.data_ptr(), slot(st, stash_slots(ns, nb, nlz) - 1), grads["wo"],
                 grads["bo"], N, GOUT_W, dh, d_out, dh))
    wgrad(NAME_WGRAD, jobs, cd, st.device)


# The wgrad (bf16: csrc/resnetfc_hopper.cu; float32: csrc/resnetfc.cu): dW
# tiles of WGRAD_TILE x WGRAD_TILE, rows in steps of WGRAD_ROWS (bf16: a
# pipeline stage; float32: WGRAD_ROWS_F32, one of its stages), at most
# WGRAD_GROUP jobs a launch (bf16: their tensor maps are kernel
# parameters; float32 takes WGRAD_GROUP_F32 in one launch).
WGRAD_TILE, WGRAD_ROWS, WGRAD_GROUP = 128, 64, 8
WGRAD_ROWS_F32, WGRAD_GROUP_F32 = 32, 24
# The row split: each job gets at least WGRAD_WAVES (float32:
# WGRAD_WAVES_F32) waves of one CTA per SM on the card's WGRAD_SMS SMs, in
# chunks of at least WGRAD_MIN_CHUNK (WGRAD_MIN_CHUNK_F32) rows.  bf16: a
# CTA's float32 partial tile, 64 KB, is then at most ~3% of the operand
# bytes it reads.  float32: a chunk of 1,024 rows reads 1 MB of operands
# for its 64 KB partial tile (two float32 CTAs share an SM).
WGRAD_SMS, WGRAD_WAVES, WGRAD_MIN_CHUNK = 132, 2, 2048
WGRAD_WAVES_F32, WGRAD_MIN_CHUNK_F32 = 2, 1024


class WgradJobPlan(NamedTuple):
    tiles_o: int
    tiles_i: int
    splits: int
    chunk: int        # rows a split (a multiple of the dtype's row step)
    group: int        # the launch that runs the job
    first_block: int  # its first CTA in that launch
    part: int         # float offset of its partial tiles [split][Mg][Ka]
    bpart: int        # float offset of its bias partials [split][tiles_i][Mg]; -1: none


class WgradPlan(NamedTuple):
    jobs: tuple       # WgradJobPlan per job
    blocks: tuple     # CTAs per launch
    floats: int       # size of the partials buffer


def _split(rows: int, to: int, ti: int, compute_dtype) -> int:
    """Rows a split of a job of ``rows`` rows and ``to x ti`` tiles."""
    bf16 = compute_dtype == torch.bfloat16
    waves, least, step = ((WGRAD_WAVES, WGRAD_MIN_CHUNK, WGRAD_ROWS) if bf16 else
                          (WGRAD_WAVES_F32, WGRAD_MIN_CHUNK_F32, WGRAD_ROWS_F32))
    splits = max(1, min(-(-waves * WGRAD_SMS // (to * ti)), rows // least))
    return max(1, -(-(-(-rows // splits)) // step)) * step


def wgrad_plan(shapes, compute_dtype=torch.bfloat16) -> WgradPlan:
    """The wgrad's host plan for jobs of ``shapes``, each ``(rows, Mg, Ka,
    bias)``: per job 128 x 128 tiles times row splits (at least
    ``WGRAD_WAVES * WGRAD_SMS`` CTAs, float32 ``WGRAD_WAVES_F32 *
    WGRAD_SMS``, where the rows allow ``WGRAD_MIN_CHUNK`` a split, float32
    ``WGRAD_MIN_CHUNK_F32``); jobs in launches of ``WGRAD_GROUP`` (float32
    ``WGRAD_GROUP_F32``), CTAs ordered by job, then split, then tile (the
    tiles of one row range run together).  Each (split, tile) CTA owns a
    region of the partials buffer; the reduction adds the splits in order."""
    group = WGRAD_GROUP if compute_dtype == torch.bfloat16 else WGRAD_GROUP_F32
    jobs, blocks, part = [], [], 0
    plans = []
    for rows, mg, ka, bias in shapes:
        to, ti = -(-mg // WGRAD_TILE), -(-ka // WGRAD_TILE)
        chunk = _split(rows, to, ti, compute_dtype)
        plans.append((to, ti, max(1, -(-rows // chunk)), chunk))
    bpart = sum(p[2] * mg * ka for p, (_, mg, ka, _) in zip(plans, shapes))
    for j, ((to, ti, sp, chunk), (rows, mg, ka, bias)) in enumerate(zip(plans, shapes)):
        if j % group == 0:
            blocks.append(0)
        jobs.append(WgradJobPlan(to, ti, sp, chunk, len(blocks) - 1, blocks[-1], part,
                                 bpart if bias else -1))
        blocks[-1] += to * ti * sp
        part += sp * mg * ka
        bpart += sp * ti * mg if bias else 0
    return WgradPlan(tuple(jobs), tuple(blocks), bpart)


def wgrad(name: str, jobs, compute_dtype, device) -> None:
    """Launch the wgrad over ``jobs``, each ``(G ptr, A ptr, dW, db or None,
    rows, ldg, lda, Mg, Ka)``: ``dW (Mg, Ka) += G^T A`` over the rows of ``G
    (rows, ldg)`` and ``A (rows, lda)`` in the compute dtype, and ``db +=
    sum G``.  Counted under the caller's ``name``, and float32 also under
    ``NAME_WGRAD_F32``.  bf16 runs the wgmma kernel, float32 the
    register-tiled FMA kernel, each on :func:`wgrad_plan` and then the
    reduction of the splits' partial tiles in split order: no float
    atomics, the same bits on every run."""
    n = len(jobs)
    arr = lambda vals: (ctypes.c_void_p * n)(*vals)
    G, A = arr([j[0] for j in jobs]), arr([j[1] for j in jobs])
    dW = arr([j[2].data_ptr() for j in jobs])
    db = arr([None if j[3] is None else j[3].data_ptr() for j in jobs])
    stream = ctypes.c_void_p(_build.stream_ptr(device))
    vec = 8 if compute_dtype == torch.bfloat16 else 4  # values in 16 bytes (TMA, cp.async)
    for j in jobs:
        if j[5] % vec or j[6] % vec or j[0] % 16 or j[1] % 16:
            raise ValueError(f"{name}: wgrad rows must be 16-byte aligned, got job {j[4:]}")
    plan = wgrad_plan([(j[4], j[7], j[8], j[3] is not None) for j in jobs], compute_dtype)
    rows = [(j[4], j[5], j[6], j[7], j[8], jp.tiles_i, jp.tiles_o * jp.tiles_i, jp.splits,
             jp.chunk, jp.group, jp.first_block, jp.part, jp.bpart)
            for j, jp in zip(jobs, plan.jobs)]
    flat = (ctypes.c_longlong * (13 * n))(*(v for r in rows for v in r))
    part = torch.empty((plan.floats,), dtype=torch.float32, device=device)
    entry = "avr_resnetfc_wgrad_bf16" if compute_dtype == torch.bfloat16 else "avr_resnetfc_wgrad"
    fn = _build.kernel_fn(entry, [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p,
                                                         ctypes.c_void_p])
    err = fn(*(ctypes.cast(x, ctypes.c_void_p) for x in (G, A, dW, db, flat)), n,
             _build.ptr(part), stream)
    _build.check(name, err)
    if compute_dtype == torch.float32:
        _build.launches[NAME_WGRAD_F32] += 1


class _Decoder(torch.autograd.Function):
    """The kernels under autograd: with ``stash`` the forward writes the
    activations and the stash backward reads them; without, the forward
    keeps only the prepared operands and the recompute backward reruns it."""

    @staticmethod
    def forward(ctx, x, z, wi, bi, wz, bz, w0, b0, w1, b1, wo, bo, a, d, compute_dtype, stash):
        out, st = _forward(a, d, compute_dtype, stash=stash)
        ctx.a, ctx.d, ctx.st, ctx.cd = a, d, st, compute_dtype
        ctx.like = [(t.dtype, t.shape) for t in (x, z, wi, bi, wz, bz, w0, b0, w1, b1, wo, bo)]
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.st is None:
            grads = list(_backward_recompute(ctx.a, ctx.d, g, ctx.cd))
        else:
            grads = list(_backward(ctx.a, ctx.d, ctx.st, g, ctx.cd))
        grads[2] = grads[2][:, :ctx.like[2][1][1]]  # lin_in's zero-padded input lanes
        return tuple(gr.to(dt).reshape(sh) for gr, (dt, sh) in zip(grads, ctx.like)) + (None,) * 4


def fused_resnetfc(x: torch.Tensor, z: torch.Tensor, w: DecoderWeights, *,
                   n_blocks: int, n_lin_z: int, compute_dtype: torch.dtype,
                   code: Optional[CodeSpec] = None,
                   activate_out: bool = False, stash: Union[bool, str] = "auto") -> torch.Tensor:
    """Apply the decoder: ``x (NS, N, d_in)`` raw (``code``) or encoded
    point features, ``z (NS, N, d_latent)`` latents -> ``(N, d_out)`` float32.

    CPU tensors take the plain version (autograd gives the same gradients
    for any ``stash``); CUDA tensors launch the kernel, and under autograd
    the stash forward and stash backward kernels or, per ``stash``
    (:func:`use_stash`), the forward and the recompute backward kernels.
    """
    if not 0 < n_lin_z <= n_blocks:
        raise ValueError(f"{NAME}: need 0 < n_lin_z <= n_blocks")
    if activate_out and w.wo.shape[0] != 4:
        raise ValueError(f"{NAME}: activate_out requires d_out == 4")
    ns, N, d_in = x.shape
    d_hidden = w.wi.shape[0]
    keep = use_stash(stash, ns, N, d_hidden, n_blocks, n_lin_z, compute_dtype)
    if x.device.type == "cpu":
        return resnetfc_plain(x, z, w, n_blocks=n_blocks, n_lin_z=n_lin_z,
                              compute_dtype=compute_dtype, code=code,
                              activate_out=activate_out)
    if compute_dtype not in _DTYPES:
        raise TypeError(f"{NAME}: compute dtype {compute_dtype} not in {list(_DTYPES)}")
    d_latent, d_out = z.shape[-1], w.wo.shape[0]
    if code is not None and code.d_raw != d_in:
        raise ValueError(f"{NAME}: x width {d_in} != code.d_raw {code.d_raw}")
    # d_hidden <= 512: every forward kernel keeps its trunk in registers (and
    # so does the bf16 dgrad walk); which kernel runs is forward_route's choice
    if d_hidden % 64 or not 64 <= d_hidden <= 512 or d_latent % 64 or d_out > GOUT_W:
        raise ValueError(f"{NAME}: kernel needs d_hidden in 64..512, d_latent a multiple "
                         f"of 64 and d_out <= {GOUT_W}, got {d_hidden}, {d_latent}, {d_out}")
    if z.shape[:2] != (ns, N) or w.wz.shape != (n_lin_z, d_hidden, d_latent):
        raise ValueError(f"{NAME}: z {tuple(z.shape)} / wz {tuple(w.wz.shape)} mismatch")
    a = _prepare(x, z, w, code, compute_dtype)
    _build.check_cuda_inputs(NAME, a, x.device)
    d = _dims(a, n_blocks, n_lin_z, activate_out)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, z, *w)):
        # the bf16 backward's tail holds d_latent <= 512 and k_in <= 128
        if compute_dtype == torch.bfloat16 and (d_latent > 512 or d["k_in"] > 128):
            raise ValueError(f"{NAME}: the bf16 backward needs d_latent <= 512 and at most 128 "
                             f"encoded input lanes, got {d_latent}, {w.wi.shape[1]}")
        return _Decoder.apply(x, z, *w, a, d, compute_dtype, keep)
    return _forward(a, d, compute_dtype, stash=False)[0]
