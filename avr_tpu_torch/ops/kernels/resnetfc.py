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
stash stored from that tile by TMA; the encoded input and the latent past
512 lanes it takes in pieces, up to ``FWD_OPERAND_MAX`` lanes each.  bf16
past that takes the chain (below).  float32 takes ``csrc/resnetfc.cu``'s
``resnetfc_fwd_f32_kernel`` (:func:`f32_forward_plan`): a CTA a 32-point
tile, register-tiled FMA products (8 points x 8 columns a thread, the trunk
in registers), the transposed weights' 16-row slabs
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
operands take ``csrc/resnetfc.cu``'s dgrad (``resnetfc_dgrad_f32_kernel``,
:func:`f32_dgrad_plan`): the float32 forward's design walked in reverse
(32-point tiles, register-tiled FMA products over the untransposed
weights' 16-row slabs streamed through a shared ring, the ReLU masks'
stash rows prefetched into L2 and read when a product ends, the
cotangents written from registers), and its register-tiled wgrad
(``resnetfc_wgrad_f32_kernel``: 8 x 8 outputs a thread from staged K-major
tiles), whose rows split as the bf16 wgrad's do (:func:`wgrad_plan`'s
float32 rule: at least ``WGRAD_WAVES_F32`` waves of CTAs a job) and whose
splits' partial tiles the bf16 wgrad's reduction adds in split order, so
float32 too is the same run to run.

Every kernel above keeps its trunk or trunk cotangent in registers, full at
``d_hidden`` 512, and the bf16 dgrad's tail takes at most 512 latent and
128 encoded input lanes.  Past those envelopes the forward and the dgrad are
``csrc/resnetfc_wide.cu``'s cluster kernels where they fit.  bf16 with
``d_hidden`` from 256 to 1,024 (:func:`forward_route` and
:func:`backward_route` say ``"wide_tma"``, the rule :func:`wide_tma_fits`;
the forward only past 512) takes its TMA kernels: a CTA a tile of 32
points, the float32 trunk in registers, the weights streamed through a
shared ring by TMA, each stage multicast to a cluster of 2 CTAs, products
by ``mma.sync`` from shared memory.  float32 with ``d_hidden`` from 576 to
1,024 (``"wide_f32"``, the rule :func:`wide_f32_fits`) takes its float32
kernels: a CTA a tile of 16 points, the float32 trunk and one operand tile
in shared memory, full-width weight slabs of 8 rows streamed through a
3-stage (at 1,024) shared ring by bulk copies, each multicast to a cluster
of 2 CTAs (the forward's latent rows read into the operand tile a chunk at
a time), register-tiled FMA (16 points x 8 columns a thread), one FMA chain
per output in k order.  Every other shape (``"chain"``, the rule
:func:`chain_takes`: ``d_hidden`` past 1,024 in either dtype, bf16 forwards
past ``FWD_OPERAND_MAX`` lanes, bf16 dgrads below ``d_hidden`` 256 past the
tail, operands past the cluster kernels' shared memory) takes
``csrc/resnetfc_chain.cu``'s chain: each product one
launch over a chunk of up to ``CHAIN_CHUNK`` points (:func:`chain_plan`),
a tiled product (bf16 on ``wgmma``, float32 by register-tiled FMA, each
from a TMA ring in a persistent CTA an SM) whose epilogue adds into the float32 trunk in device memory and writes the
next product's operand into its stash slot.  The
wgrads above take their jobs at any width.  A latent of any width is
zero-padded to a multiple of 64 lanes (:func:`pad_latent`), as lin_in's
input is, and its gradient sliced back.

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

__all__ = ["CodeSpec", "DecoderWeights", "backward_route", "chain_plan", "chain_takes",
           "chain_workspace", "f32_dgrad_plan", "f32_forward_plan", "forward_route",
           "fused_resnetfc", "pad_latent", "resnetfc_plain", "use_stash", "encode_tables",
           "wgrad_plan", "wide_f32_fits", "wide_f32_smem", "wide_f32_stages", "wide_tma_fits",
           "wide_tma_smem"]

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


def encode_features(x: torch.Tensor, code: CodeSpec) -> torch.Tensor:
    """The positional encoding of raw features ``(..., d_raw)`` float32 ->
    ``(..., d_enc)``: the prologue the kernel runs, as JAX's XLA path
    (``ResnetFC._apply_code``) runs it."""
    return _encode(x.reshape(-1, x.shape[-1]), code).reshape(*x.shape[:-1], code.d_enc)


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
NAME_DGRAD_F32 = "resnetfc_dgrad_f32"  # every float32 dgrad launch (stash and recompute)


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


def pad_latent(z: torch.Tensor, wz: torch.Tensor):
    """``z (NS, N, d_latent)`` and ``wz (n_lin_z, d_hidden, d_latent)`` with
    zero latent lanes appended up to a multiple of 64, as the kernels take
    them (lin_in's input lanes are padded the same way): each injection's
    product only gains zero terms.  A width already a multiple of 64 is
    returned as it is."""
    dl = z.shape[-1]
    pad = d_enc_padded(dl) - dl
    if not pad:
        return z, wz
    return (torch.nn.functional.pad(z.detach(), (0, pad)),
            torch.nn.functional.pad(wz.detach(), (0, pad)))


def _prepare(x, z, w: DecoderWeights, code, compute_dtype):
    """The kernels' operands: detached, contiguous, in the compute dtype
    (biases rounded to it and held in float32), lin_in and the latent
    zero-padded to a multiple of 64 input lanes (:func:`pad_latent`), and
    the encoding tables."""
    ns, N, d_in = x.shape
    d_hidden, d_enc = w.wi.shape
    dev = x.device
    k_in = d_enc_padded(d_enc)
    mode, src, f, ph = encode_tables(code, d_in, k_in)
    cd = lambda t: t.detach().to(compute_dtype).contiguous()
    wi = torch.zeros((d_hidden, k_in), dtype=compute_dtype, device=dev)
    wi[:, :d_enc] = w.wi.detach()
    z, wz = pad_latent(cd(z), cd(w.wz))
    biases = [t.detach().to(compute_dtype).float().contiguous()
              for t in (w.bi, w.bz, w.b0, w.b1, w.bo)]
    a = dict(x=x.detach().float().contiguous(), z=z, wi=wi, wz=wz, w0=cd(w.w0),
             w1=cd(w.w1), wo=cd(w.wo), bi=biases[0], bz=biases[1], b0=biases[2],
             b1=biases[3], bo=biases[4],
             tables=torch.from_numpy(np.stack([mode, src]).astype(np.int32)).to(dev),
             fph=torch.from_numpy(np.stack([f, ph])).to(dev))
    if compute_dtype == torch.float32:
        # the float32 forward streams k-row slabs of the transposed weights,
        # the float32 dgrad those of the weights as they are; both go by
        # bulk copies, 16-byte aligned, as do the forward's latent rows
        a.update(zip(_T_KEYS, _transposed(a)))
        for k in ("z", "wi", "wz", "w0", "w1"):
            if a[k].data_ptr() % 16:
                a[k] = a[k].clone()
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


# The bf16 wgmma forward's envelope (csrc/resnetfc_hopper.cu FWD_K_MAX,
# FWD_K_EXT, FWD_OPERAND_MAX): its operand tile holds 512 lanes, the trunk's
# columns in one; the encoded input and the latent past 512 lanes take
# pieces of up to FWD_K_EXT lanes (the tile and its park tiles), up to
# FWD_OPERAND_MAX lanes each (the C entry refuses wider ones); its points
# come in tiles of FWD_TILE.
FWD_K_MAX, FWD_K_EXT, FWD_OPERAND_MAX, FWD_TILE = 512, 768, 1152, 64
# Every kernel but the wide ones keeps its trunk (or trunk cotangent) in
# registers, full at REG_DH_MAX columns; the bf16 dgrad's tail holds at most
# TAIL_DL_MAX latent lanes and TAIL_KIN_MAX encoded input lanes
# (csrc/resnetfc_hopper.cu TL_KIN_MAX).
REG_DH_MAX, TAIL_DL_MAX, TAIL_KIN_MAX = 512, 512, 128


def forward_route(compute_dtype: torch.dtype, d_latent: int, k_in: int,
                  d_hidden: int = REG_DH_MAX) -> str:
    """The forward kernel that a call with these operands launches on the
    card, for every shape :func:`fused_resnetfc` takes (``d_latent`` and
    ``k_in`` padded to multiples of 64, ``d_hidden`` a multiple of 64; every
    number of views takes the same route): ``"chain"`` where
    :func:`chain_takes` (``csrc/resnetfc_chain.cu``, a launch a product over
    all points); else for ``d_hidden`` above 512 ``"wide_f32"`` (float32,
    :func:`wide_f32_fits`: ``csrc/resnetfc_wide.cu
    resnetfc_wide_f32_fwd_kernel``) or ``"wide_tma"`` (bf16,
    :func:`wide_tma_fits`: ``resnetfc_wide_tma_fwd_kernel``); else
    ``"wgmma"`` (bf16 with ``d_latent`` and ``k_in`` at most
    ``FWD_OPERAND_MAX``, past 512 lanes in pieces of up to ``FWD_K_EXT``:
    ``csrc/resnetfc_hopper.cu``) or ``"fma"`` (float32: ``csrc/resnetfc.cu
    resnetfc_fwd_f32_kernel``).  A route's build or launch failure raises:
    no call changes kernel."""
    if chain_takes(compute_dtype, d_hidden, d_latent, k_in):
        return "chain"
    if d_hidden > REG_DH_MAX:
        return "wide_f32" if compute_dtype == torch.float32 else "wide_tma"
    return "fma" if compute_dtype == torch.float32 else "wgmma"


def backward_route(compute_dtype: torch.dtype, d_hidden: int, d_latent: int, k_in: int) -> str:
    """The dgrad that a call's backward launches on the card (the wgrads
    take jobs of any width): ``"chain"`` where :func:`chain_takes`
    (``csrc/resnetfc_chain.cu``); else ``"wgmma"`` (bf16 with ``d_hidden``
    and ``d_latent`` at most 512 and at most 128 encoded input lanes: the
    walk and tail of ``csrc/resnetfc_hopper.cu``), ``"fma"`` (float32 with
    ``d_hidden`` at most 512: ``csrc/resnetfc.cu
    resnetfc_dgrad_f32_kernel``), ``"wide_f32"`` (float32,
    :func:`wide_f32_fits`: ``csrc/resnetfc_wide.cu
    resnetfc_wide_f32_dgrad_kernel``) or ``"wide_tma"`` (bf16,
    :func:`wide_tma_fits`: ``resnetfc_wide_tma_dgrad_kernel``).
    ``d_latent`` and ``k_in`` as padded."""
    if chain_takes(compute_dtype, d_hidden, d_latent, k_in, True):
        return "chain"
    if compute_dtype == torch.float32:
        return "fma" if d_hidden <= REG_DH_MAX else "wide_f32"
    if d_hidden <= REG_DH_MAX and d_latent <= TAIL_DL_MAX and k_in <= TAIL_KIN_MAX:
        return "wgmma"
    return "wide_tma"


# The chain takes every shape no register or cluster kernel holds: at every
# corner of the four families of such shapes that other kernels took before
# it, the chain was the faster (chip_smoke.py --chain-sweep, CHAIN_SWEEP
# A1-D4, in turns at the band chunk on an H100 80GB HBM3 at 700 W; PERF.md
# section 6).


def chain_takes(compute_dtype: torch.dtype, d_hidden: int, d_latent: int, k_in: int,
                backward: bool = False) -> bool:
    """The chain's rule (``csrc/resnetfc_chain.cu``), one function of the
    shape: past ``REG_DH_MAX`` every shape that neither cluster kernel
    takes (:func:`wide_f32_fits`, :func:`wide_tma_fits`); up to it bf16
    forwards past ``FWD_OPERAND_MAX`` lanes and bf16 dgrads past the tail's
    ``TAIL_DL_MAX`` / ``TAIL_KIN_MAX`` that the TMA cluster dgrad does not
    take (``d_hidden`` below ``WIDE_TMA_DH[0]``).  ``d_latent`` and ``k_in``
    as padded."""
    if d_hidden > REG_DH_MAX:
        return not (wide_f32_fits(compute_dtype, d_hidden, k_in)
                    or wide_tma_fits(compute_dtype, d_hidden, d_latent, k_in, backward))
    if compute_dtype == torch.float32:
        return False
    if not backward:
        return max(d_latent, k_in) > FWD_OPERAND_MAX
    return ((d_latent > TAIL_DL_MAX or k_in > TAIL_KIN_MAX)
            and not wide_tma_fits(compute_dtype, d_hidden, d_latent, k_in, True))


# The shared memory a Hopper block can use (csrc/resnetfc_wide.cu SMEM_MAX).
SMEM_MAX = 232_448


# The bf16 TMA cluster kernels (csrc/resnetfc_wide.cu resnetfc_wide_tma_*):
# a CTA a tile of WIDE_TMA_TM points, WIDE_TMA_CLUSTER CTAs a cluster (the
# grid rounded up to whole clusters), a ring of WIDE_TMA_STAGES weight
# stages of WIDE_TMA_STAGE bytes (WIDE_TMA_PASS rows of 32 k), and the A
# region of two d_hidden tiles (the forward's as wide as its widest operand);
# the trunk in registers, two 64-column groups a warp at most; the source's
# WT_* constants.
WIDE_TMA_TM, WIDE_TMA_CLUSTER, WIDE_TMA_STAGES = 32, 2, 3
WIDE_TMA_PASS, WIDE_TMA_KS = 512, 32
WIDE_TMA_STAGE = WIDE_TMA_PASS * WIDE_TMA_KS * 2
WIDE_TMA_DH = (256, 1024)


def wide_tma_smem(d_hidden: int, d_latent: int, k_in: int, backward: bool = False) -> int:
    """Shared bytes of a bf16 TMA cluster forward (or, ``backward``, dgrad)
    CTA (``csrc/resnetfc_wide.cu wt_smem``): the ring, the A region, the
    output cotangent tile and the ring's three barriers a stage."""
    ka = 2 * d_hidden if backward else max(2 * d_hidden, d_latent, k_in)
    return WIDE_TMA_STAGES * WIDE_TMA_STAGE + WIDE_TMA_TM * ka * 2 + WIDE_TMA_TM * GOUT_W * 4 \
        + 3 * WIDE_TMA_STAGES * 8


def wide_tma_fits(compute_dtype: torch.dtype, d_hidden: int, d_latent: int, k_in: int,
                  backward: bool = False) -> bool:
    """The bf16 TMA cluster kernels' envelope, one function of the shape:
    ``d_hidden`` from 256 to 1,024 (a warp's trunk is at most two 64-column
    groups; the dgrad's d-encoding chunk needs 256) where their shared
    memory fits; the chain takes every other bf16 shape past the register
    kernels (:func:`chain_takes`)."""
    lo, hi = WIDE_TMA_DH
    return (compute_dtype == torch.bfloat16 and lo <= d_hidden <= hi
            and wide_tma_smem(d_hidden, d_latent, k_in, backward) <= SMEM_MAX)


# The float32 cluster kernels (csrc/resnetfc_wide.cu resnetfc_wide_f32_*): a
# CTA a tile of WIDE_F32_TM points, WIDE_F32_CLUSTER CTAs a cluster (the
# grid rounded up to whole clusters), a ring of weight stages of
# WIDE_F32_KS rows of at most d_hidden columns, as many as fit up to
# WIDE_F32_STAGES_MAX and at least WIDE_F32_STAGES_MIN, beside the trunk,
# the operand tile and g_epi; d_hidden up to WIDE_F32_DH_MAX (128 consumer
# threads of 8 columns); the source's WF_* constants.
WIDE_F32_TM, WIDE_F32_KS, WIDE_F32_CLUSTER = 16, 8, 2
WIDE_F32_STAGES_MIN, WIDE_F32_STAGES_MAX, WIDE_F32_DH_MAX = 3, 8, 1024


def _wide_f32_fixed(d_hidden: int, k_in: int) -> int:
    """A float32 cluster CTA's shared bytes beside its ring: the trunk
    (WIDE_F32_TM rows of ``d_hidden + 4`` floats), the operand tile (rows of
    ``max(d_hidden, k_in) + 4``), g_epi and the ring's two barriers a stage
    (``csrc/resnetfc_wide.cu wf_fixed``)."""
    return 4 * (WIDE_F32_TM * (d_hidden + 4) + WIDE_F32_TM * (max(d_hidden, k_in) + 4)
                + WIDE_F32_TM * GOUT_W) + 2 * WIDE_F32_STAGES_MAX * 8


def wide_f32_stages(d_hidden: int, k_in: int) -> int:
    """Stages of a float32 cluster CTA's ring (``csrc/resnetfc_wide.cu
    wf_stages``): as many as fit beside :func:`_wide_f32_fixed`, at most
    WIDE_F32_STAGES_MAX."""
    stage = 4 * WIDE_F32_KS * d_hidden
    return max(0, min(WIDE_F32_STAGES_MAX, (SMEM_MAX - _wide_f32_fixed(d_hidden, k_in)) // stage))


def wide_f32_smem(d_hidden: int, k_in: int) -> int:
    """Shared bytes of a float32 cluster forward or dgrad CTA
    (``csrc/resnetfc_wide.cu wf_smem``)."""
    return wide_f32_stages(d_hidden, k_in) * 4 * WIDE_F32_KS * d_hidden \
        + _wide_f32_fixed(d_hidden, k_in)


def wide_f32_fits(compute_dtype: torch.dtype, d_hidden: int, k_in: int) -> bool:
    """The float32 cluster kernels' envelope, one function of the shape:
    ``d_hidden`` above 512 up to 1,024 where at least WIDE_F32_STAGES_MIN
    stages fit (the card measured both faster than the first wide version at
    every such width: PERF.md section 6); the chain takes every other
    float32 shape past 512 (:func:`chain_takes`)."""
    return (compute_dtype == torch.float32 and REG_DH_MAX < d_hidden <= WIDE_F32_DH_MAX
            and wide_f32_stages(d_hidden, k_in) >= WIDE_F32_STAGES_MIN)


# The chain (csrc/resnetfc_chain.cu): each product one launch over a chunk
# of at most CHAIN_CHUNK points, whose float32 trunk (and view sums, and
# without the stash two operand buffers; the dgrad's gh, pooled cotangent and
# lin_in's input cotangent) is the workspace.
CHAIN_CHUNK = 131_072
# forwards (stash or not) and dgrads (stash and recompute) on the chain, by dtype
NAME_CHAIN = {torch.bfloat16: "fused_resnetfc_chain", torch.float32: "fused_resnetfc_chain_f32"}
NAME_DGRAD_CHAIN = {torch.bfloat16: "resnetfc_dgrad_chain",
                    torch.float32: "resnetfc_dgrad_chain_f32"}


def chain_workspace(N: int, ns: int, d_hidden: int, k_in: int, compute_dtype: torch.dtype,
                    stash: bool, backward: bool) -> dict:
    """Byte offsets of the chain's workspace for calls of up to ``N``
    points (its chunks at most ``CHAIN_CHUNK``): ``H`` (the trunk, or gh),
    ``pool`` (NS > 1: the view sums, or the pooled cotangent), the forward's
    ``encoded`` input (a view's encoding, rounded: lin_in's A operand) and
    without the stash its ``act`` buffers (relu(h) and relu(fc_0), rounded),
    the dgrad's ``denc`` (lin_in's input cotangent, float32), and
    ``bytes``."""
    c = min(N, CHAIN_CHUNK)
    item = torch.empty((), dtype=compute_dtype).element_size()
    f32 = 4 * c * d_hidden
    off = dict(H=0, pool=f32)
    at = f32 * (2 if ns > 1 else 1)
    if backward:
        off["denc"] = at
        at += 4 * c * k_in
    else:
        off["encoded"] = at
        at += item * c * k_in
        if not stash:
            off["act"] = (at, at + item * c * d_hidden)
            at += 2 * item * c * d_hidden
    off["bytes"] = at
    return off


class ChainStep(NamedTuple):
    """One record of the chain, symbolic (bound to pointers chunk by chunk
    by :func:`_chain_records`).  ``kind``: ``"gemm"`` (a product), ``"linout"``
    (lin_out, a warp a point), ``"head"`` (the dgrad's lin_out backward),
    ``"enc"`` (view ``view``'s encoded input, rounded: in the forward into
    ``("encoded",)``, in the dgrad beside the encoding's backward).
    Operands: ``("encoded",)`` the forward's encoded input, ``("z", v)``
    view v's latents, ``("stash", slot)``, ``("cot", slot)``, ``("act", i)``
    (the forward's operand buffers without the stash), ``("dz", v)``,
    ``("denc",)``; weights ``("wi",)``, ``("wz", k)``, ``("w0", k)``,
    ``("w1", k)`` (a product's bias is its weight's)."""

    kind: str
    epi: str = ""                 # a product's epilogue: CHAIN_EPI's keys
    a: Optional[tuple] = None     # A operand (segment 0)
    w: Optional[tuple] = None     # B operand (segment 0)
    kdim: str = ""                # K a segment: "k_in", "d_latent" or "d_hidden"
    ndim: str = ""                # output columns
    out: Optional[tuple] = None   # what the epilogue writes (the next A operand)
    mask: Optional[tuple] = None  # the stash slot whose ReLU mask the epilogue reads
    pool: str = ""                # fc1: "first", "add", "last"; gh and head: "use", "boundary"
    view: int = 0                 # enc: the view
    nseg: int = 1                 # dz: the injections' segments
    a1: Optional[tuple] = None    # segment 1's A; segment j at a1 + (j - 1) * a_seg slots
    a_seg: int = 0


CHAIN_KINDS = {"gemm": 0, "linout": 1, "head": 2, "enc": 3}
CHAIN_EPI = {"in": 0, "z": 1, "fc0": 2, "fc1": 3, "c0": 4, "gh": 5, "f32": 6, "t": 7}
CHAIN_FLAGS = {"use": 2, "boundary": 4, "first": 8, "add": 16, "last": 32}


def chain_plan(ns: int, n_blocks: int, n_lin_z: int, backward: bool = False,
               stash: bool = True) -> list:
    """The chain's records for one chunk, in launch order.

    Forward: per view the encoding pass (the rounded encoded input into the
    workspace) and lin_in (h = acc + b), then
    per injection k its product (h = (h + acc) + b, relu(h) out as block k's
    fc_0 input), fc_0 (relu(acc + b) out as fc_1's input) and fc_1 (h = (h
    + acc) + b; the combine layer's last block sums the views into the pool,
    the last view forming the mean, and writes relu(h) for the next
    product); then the pooled blocks, each fc_1 writing the next fc_0's
    input, the last one lin_out's; then lin_out.  Those operands are the
    stash slots (:func:`stash_slot`, the last slot lin_out's), or without
    the stash the two ``act`` buffers.

    dgrad (on the stash): the head (gout, gh, round(gh) to the last
    block's c1 slot); per block c0 = round(mask(relu(fc_0)) * (c1 @ W1)) to
    its cotangent slot and gh += mask(relu(h)) * (c0 @ W0), which writes
    round(gh) to the next block's c1 slot (cot_in after a view's block 0);
    over NS > 1 the pooled blocks once (view 0's slots), whose last product
    (or the head, when every block is a view's) writes the pooled cotangent
    and every view's first c1, round(gh / NS), and each view's first block
    reads gh = pool / NS; per view lin_in's input cotangent (float32), the
    encoding's backward (dx, enc) and dz, one product over the injections'
    segments G_0 = cot_in, G_j = block j - 1's c1."""
    nb, nlz = n_blocks, n_lin_z
    last = ("stash", stash_slots(ns, nb, nlz) - 1)
    if backward:
        C = lambda k, j, v: ("cot", stash_slot(k, j, v, ns, nlz))
        M = lambda k, j, v: ("stash", stash_slot(k, j, v, ns, nlz))
        cin = lambda v: ("cot", cot_slots(ns, nb, nlz) - ns + v)
        steps = [ChainStep("head", a=last, out=C(nb - 1, 1, 0),
                           pool="boundary" if ns > 1 and nb == nlz else "")]

        def block(k, v, out, pool):
            steps.append(ChainStep("gemm", "c0", C(k, 1, v), ("w1", k), "d_hidden", "d_hidden",
                                   out=C(k, 0, v), mask=M(k, 1, v)))
            steps.append(ChainStep("gemm", "gh", C(k, 0, v), ("w0", k), "d_hidden", "d_hidden",
                                   out=out, mask=M(k, 0, v), pool=pool))

        lo = 0 if ns == 1 else nlz  # the blocks walked once, on view 0's slots
        for k in range(nb - 1, lo - 1, -1):
            if k > lo:
                block(k, 0, C(k - 1, 1, 0), "")
            elif ns == 1:
                block(k, 0, cin(0), "")
            else:
                block(k, 0, C(nlz - 1, 1, 0), "boundary")
        for v in range(ns):
            if ns > 1:
                for k in range(nlz - 1, -1, -1):
                    block(k, v, C(k - 1, 1, v) if k else cin(v), "use" if k == nlz - 1 else "")
            steps += [ChainStep("gemm", "f32", cin(v), ("wi",), "d_hidden", "k_in", out=("denc",)),
                      ChainStep("enc", view=v),
                      ChainStep("gemm", "t", cin(v), ("wz", 0), "d_hidden", "d_latent",
                                out=("dz", v), nseg=nlz, a1=C(0, 1, v), a_seg=2 * ns)]
        return steps
    S = ((lambda k, j, v: ("stash", stash_slot(k, j, v, ns, nlz))) if stash else
         (lambda k, j, v: ("act", j)))
    if not stash:
        last = ("act", 0)
    nxt = lambda k: S(k, 0, 0) if k < nb else last  # relu(h) entering block k (or lin_out)
    steps = []
    for v in range(ns):
        steps += [ChainStep("enc", view=v, out=("encoded",)),
                  ChainStep("gemm", "in", ("encoded",), ("wi",), "k_in", "d_hidden")]
        for k in range(nlz):
            pool = ("" if ns == 1 or k < nlz - 1 else
                    "first" if v == 0 else "last" if v == ns - 1 else "add")
            steps += [ChainStep("gemm", "z", ("z", v), ("wz", k), "d_latent", "d_hidden",
                                out=S(k, 0, v)),
                      ChainStep("gemm", "fc0", S(k, 0, v), ("w0", k), "d_hidden", "d_hidden",
                                out=S(k, 1, v)),
                      ChainStep("gemm", "fc1", S(k, 1, v), ("w1", k), "d_hidden", "d_hidden",
                                out=nxt(nlz) if k == nlz - 1 and pool in ("", "last") else None,
                                pool=pool)]
    for k in range(nlz, nb):
        steps += [ChainStep("gemm", "fc0", S(k, 0, 0), ("w0", k), "d_hidden", "d_hidden",
                            out=S(k, 1, 0)),
                  ChainStep("gemm", "fc1", S(k, 1, 0), ("w1", k), "d_hidden", "d_hidden",
                            out=nxt(k + 1))]
    steps.append(ChainStep("linout", a=last))
    return steps


class ChainOp(ctypes.Structure):
    """One launch of the chain (``csrc/resnetfc_chain.cu`` ``ChainOp``, field
    for field)."""

    _fields_ = ([(k, ctypes.c_void_p) for k in (
        "A", "A1", "B", "bias", "H", "pool", "out", "mask", "x", "tables", "fph", "g", "gout",
        "wo", "bo", "outf", "dx", "enc")]
        + [(k, ctypes.c_longlong) for k in ("a_seg", "b_seg", "out_view")]
        + [(k, ctypes.c_int) for k in (
            "kind", "epi", "flags", "M", "Ncols", "K", "nseg", "lda", "ldb", "ldh", "ldo", "ldm",
            "d_in", "k_tab", "d_out", "activate", "views")]
        + [("scale", ctypes.c_float)])


_BIAS = {"wi": "bi", "wz": "bz", "w0": "b0", "w1": "b1"}


def _chain_records(steps, t, d, s, n, work, cd, backward):
    """The records of ``steps`` for the chunk of points ``[s, s + n)``:
    ``t`` the call's tensors by name (``x``, ``z``, ``stash``, the weights
    the products read as ``wi``, ``wz``, ``w0``, ``w1``, the biases, ``wo``,
    ``bo``, ``tables``, ``fph``, ``out``; the dgrad's ``g``, ``cot``,
    ``gout``, ``dx``, ``dz``, ``enc``), ``work`` the workspace's base
    address and offsets (:func:`chain_workspace`).  Weights: bf16 as
    ``[columns][K]`` rows, float32 as ``[K][columns]``."""
    N, ns, dh = d["N"], d["ns"], d["d_hidden"]
    dims = dict(k_in=d["k_in"], d_latent=d["d_latent"], d_hidden=dh)
    item = 2 if cd == torch.bfloat16 else 4
    base, off = work
    rows = lambda key, v, width, size: t[key].data_ptr() + ((v * N + s) * width) * size

    def operand(ref):
        kind = ref[0]
        if kind in ("stash", "cot"):
            return rows(kind, ref[1], dh, item)
        if kind == "act":
            return base + off["act"][ref[1]]
        if kind == "z":
            return rows("z", ref[1], d["d_latent"], item)
        if kind == "dz":
            return rows("dz", ref[1], d["d_latent"], item)
        if kind in ("denc", "encoded"):
            return base + off[kind]
        raise ValueError(ref)

    def weight(ref):
        name = ref[0]
        per = {"wi": 0, "wz": dh * d["d_latent"], "w0": dh * dh, "w1": dh * dh}[name]
        k = ref[1] if len(ref) > 1 else 0
        return t[name].data_ptr() + k * per * item, per

    recs = []
    for st in steps:
        r = ChainOp(kind=CHAIN_KINDS[st.kind], M=n, scale=1.0 / ns, views=ns,
                    out_view=N * dh, H=base + off["H"], pool=base + off["pool"], ldh=dh, ldo=dh,
                    ldm=dh, d_in=d["d_in"], k_tab=d["k_in"], d_out=d["d_out"],
                    activate=d["activate"], x=t["x"].data_ptr() + (st.view * N + s) * d["d_in"] * 4,
                    tables=t["tables"].data_ptr(), fph=t["fph"].data_ptr(),
                    flags=CHAIN_FLAGS.get(st.pool, 0))
        if st.kind in ("linout", "head"):
            r.A, r.lda, r.K = operand(st.a), dh, dh
            r.wo, r.bo = t["wo"].data_ptr(), t["bo"].data_ptr()
            if st.kind == "linout":
                r.outf = t["out"].data_ptr() + s * d["d_out"] * 4
            else:
                r.g = t["g"].data_ptr() + s * d["d_out"] * 4
                r.gout = t["gout"].data_ptr() + s * GOUT_W * item
                r.out = operand(st.out)
        elif st.kind == "enc" and not backward:
            r.enc = operand(st.out)
        elif st.kind == "enc":
            r.H, r.ldh = base + off["denc"], d["k_in"]
            r.dx = rows("dx", st.view, d["d_in"], 4)
            r.enc = rows("enc", st.view, d["k_in"], item)
        else:
            K, cols = dims[st.kdim], dims[st.ndim]
            r.epi, r.K, r.Ncols, r.nseg, r.lda = CHAIN_EPI[st.epi], K, cols, st.nseg, K
            r.ldb = K if cd == torch.bfloat16 else cols
            r.B, r.b_seg = weight(st.w)
            r.A = operand(st.a)
            if st.a1 is not None:
                r.A1, r.a_seg = operand(st.a1), st.a_seg * N * dh
            if not backward:
                bias = t[_BIAS[st.w[0]]]
                r.bias = bias.data_ptr() + (st.w[1] * dh * 4 if len(st.w) > 1 else 0)
            if st.out is not None:
                r.out = operand(st.out)
                if st.out[0] == "dz":
                    r.ldo = d["d_latent"]
                elif st.out[0] == "denc":
                    r.H, r.ldh = operand(st.out), d["k_in"]
            if st.mask is not None:
                r.mask = operand(st.mask)
        recs.append(r)
    return recs


def _chain_run(name, steps, t, d, cd, stash, backward, work=None):
    """Launch ``steps`` chunk by chunk (``CHAIN_CHUNK`` points) on the
    current stream; counted once under ``name`` and the chain's own
    counter (:data:`NAME_CHAIN` or :data:`NAME_DGRAD_CHAIN` by dtype).
    ``work``: a workspace at least :func:`chain_workspace`'s
    bytes (allocated when not given)."""
    N = d["N"]
    dev = t["x"].device
    off = chain_workspace(N, d["ns"], d["d_hidden"], d["k_in"], cd, stash, backward)
    if work is None or work.numel() * work.element_size() < off["bytes"]:
        work = torch.empty((off["bytes"],), dtype=torch.uint8, device=dev)
    size = _build.kernel_fn("avr_resnetfc_chain_op_bytes", [])()
    if size != ctypes.sizeof(ChainOp):
        raise RuntimeError(f"{name}: ChainOp is {ctypes.sizeof(ChainOp)} bytes here, {size} in "
                           f"csrc/resnetfc_chain.cu")
    fn = _build.kernel_fn("avr_resnetfc_chain", [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                  ctypes.c_void_p])
    stream = ctypes.c_void_p(_build.stream_ptr(dev))
    err = 0
    for s in range(0, N, CHAIN_CHUNK):
        recs = _chain_records(steps, t, d, s, min(CHAIN_CHUNK, N - s), (work.data_ptr(), off),
                              cd, backward)
        arr = (ChainOp * len(recs))(*recs)
        err = fn(ctypes.cast(arr, ctypes.c_void_p), len(recs), _DTYPES[cd], stream)
        if err:
            break
    _build.check(name, err)
    _build.launches[(NAME_DGRAD_CHAIN if backward else NAME_CHAIN)[cd]] += 1


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


# The float32 dgrad (csrc/resnetfc.cu resnetfc_dgrad_f32_kernel): the
# forward's tile, threads and ring (each stage a slab of at most d_hidden
# columns); lin_in in chunks of F32_DGRAD_IN_W columns (the source's
# F32_IN_W), whose output chunk (32 rows of F32_DGRAD_IN_W + 4 floats) and
# g_epi (32 x GOUT_W) follow the A tile.
F32_DGRAD_IN_W = 64


def f32_dgrad_mode(cols: int, d_hidden: int) -> int:
    """Points a thread takes in a product ``cols`` wide (``dg_mode``): 8, 4,
    2 or 1, the most that keeps the threads' 8-column groups inside it."""
    p = 1
    while p < 8 and p * d_hidden < 8 * cols:
        p *= 2
    return p


class F32DgradPlan(NamedTuple):
    tile: int         # points a CTA
    blocks: int       # CTAs: every point in one tile
    threads: int      # d_hidden / 2
    smem: int         # bytes of dynamic shared memory
    slabs: int        # weight slabs a tile streams through the ring
    # (weight, block, view, first column, columns, points a thread, slabs,
    # stash slot of its ReLU mask or None, cotangent slot written just
    # before it or None)
    products: tuple


def f32_dgrad_plan(N: int, ns: int, d_hidden: int, d_latent: int, k_in: int, n_blocks: int,
                   n_lin_z: int) -> F32DgradPlan:
    """The float32 dgrad's launch for a shape: tile, threads, shared bytes
    and the products in the order the kernel streams their slabs (first
    lin_out's cotangent, which reads the last stash slot's mask and no
    slab; the pooled blocks, W1 then W0, k descending; per view, k
    descending, block k's W1 and W0 and injection k's latent product in
    column chunks of at most ``d_hidden``, then lin_in in chunks of
    ``F32_DGRAD_IN_W``).  Every weight product has K = ``d_hidden``: its
    ``d_hidden / 16`` slabs.  A block's W1 reads the mask of stash slot (k,
    1), its W0 of (k, 0) (the tile's rows, prefetched into L2 with the
    product's first slab); the cotangent slots are written by the trunk
    cotangent's stores (a pooled block's and a view's first block's cot1,
    each injection's G_k) and by W1's masked output (cot0)."""
    s, dh = F32_FWD_SLAB, d_hidden
    stage = s * dh
    smem = 4 * (F32_FWD_STAGES * stage + F32_FWD_TILE * (dh + 4)
                + F32_FWD_TILE * (F32_DGRAD_IN_W + 4) + F32_FWD_TILE * GOUT_W) \
        + 16 * F32_FWD_STAGES
    sl = dh // s
    products = [("wo", None, 0, 0, dh, 8, 0, stash_slots(ns, n_blocks, n_lin_z) - 1, None)]

    def block(k, v, entry):
        products.append(("w1", k, v, 0, dh, 8, sl, stash_slot(k, 1, v, ns, n_lin_z), entry))
        c0 = stash_slot(k, 0, v, ns, n_lin_z)
        products.append(("w0", k, v, 0, dh, 8, sl, c0, c0))

    for k in range(n_blocks - 1, n_lin_z - 1, -1):
        block(k, 0, stash_slot(k, 1, 0, ns, n_lin_z))
    for v in range(ns):
        for k in range(n_lin_z - 1, -1, -1):
            block(k, v, stash_slot(k, 1, v, ns, n_lin_z) if k == n_lin_z - 1 else None)
            g_k = (stash_slot(k - 1, 1, v, ns, n_lin_z) if k else
                   cot_slots(ns, n_blocks, n_lin_z) - ns + v)
            for cb in range(0, d_latent, dh):
                cw = min(dh, d_latent - cb)
                products.append(("wz", k, v, cb, cw, f32_dgrad_mode(cw, dh), sl, None,
                                 g_k if cb == 0 else None))
        for cb in range(0, k_in, F32_DGRAD_IN_W):
            products.append(("wi", None, v, cb, F32_DGRAD_IN_W,
                             f32_dgrad_mode(F32_DGRAD_IN_W, dh), sl, None, None))
    return F32DgradPlan(F32_FWD_TILE, -(-N // F32_FWD_TILE), dh // 2, smem,
                        sum(p[6] for p in products), tuple(products))


# the forward's C entry points by route: the operands in _FWD_ORDER, out,
# stash, the view-sum scratch, the dims in _DIM_ORDER, the stream
FWD_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_FWD_ENTRY = {"wgmma": "avr_resnetfc_fwd_bf16", "fma": "avr_resnetfc_fwd_f32",
              "wide_tma": "avr_resnetfc_fwd_wide_tma", "wide_f32": "avr_resnetfc_fwd_wide_f32"}
NAME_F32 = "fused_resnetfc_f32"  # forwards (stash or not) on the float32 kernel
# forwards (stash or not) and dgrads (stash and recompute) on the cluster
# kernels, by dtype
NAME_WIDE = {torch.bfloat16: "fused_resnetfc_wide", torch.float32: "fused_resnetfc_wide_f32"}
NAME_DGRAD_WIDE = {torch.bfloat16: "resnetfc_dgrad_wide", torch.float32: "resnetfc_dgrad_wide_f32"}
# the bf16 TMA cluster kernels and the float32 cluster kernels, each counted
# also under its own name
NAME_WIDE_TMA = "fused_resnetfc_wide_tma"
NAME_DGRAD_WIDE_TMA = "resnetfc_dgrad_wide_tma"
NAME_WIDE_F32_RING = "fused_resnetfc_wide_f32_ring"
NAME_DGRAD_WIDE_F32_RING = "resnetfc_dgrad_wide_f32_ring"
# (forward, dgrad) counters of the cluster routes
_CLUSTER_NAMES = {"wide_tma": (NAME_WIDE_TMA, NAME_DGRAD_WIDE_TMA),
                  "wide_f32": (NAME_WIDE_F32_RING, NAME_DGRAD_WIDE_F32_RING)}


def _forward(a, d, compute_dtype, stash: bool, st=None):
    """Launch the forward on :func:`forward_route`'s kernel; with ``stash``
    also return the activations (written into ``st`` where given).  Counted
    under ``NAME`` or ``NAME_STASH``, and the wgmma route also under
    ``NAME_WGMMA``, the float32 one under ``NAME_F32``, the cluster ones
    under ``NAME_WIDE[compute_dtype]`` (the bf16 TMA cluster one also under
    ``NAME_WIDE_TMA``, the float32 cluster one under
    ``NAME_WIDE_F32_RING``), the chain under ``NAME_CHAIN[compute_dtype]``."""
    dev = a["x"].device
    N, ns, dh = d["N"], d["ns"], d["d_hidden"]
    out = torch.empty((N, d["d_out"]), dtype=torch.float32, device=dev)
    if stash and st is None:
        st = torch.empty((stash_slots(ns, d["n_blocks"], d["n_lin_z"]), N, dh),
                         dtype=compute_dtype, device=dev)
    if N == 0:
        return out, st
    route = forward_route(compute_dtype, d["d_latent"], d["k_in"], dh)
    if route == "chain":
        f32 = compute_dtype == torch.float32
        # float32 products read the transposed weights ([K][columns])
        t = dict(a, out=out, stash=st,
                 **{k: a[k + "T"] if f32 else a[k] for k in ("wi", "wz", "w0", "w1")})
        _chain_run(NAME_STASH if stash else NAME,
                   chain_plan(ns, d["n_blocks"], d["n_lin_z"], False, stash), t, d,
                   compute_dtype, stash, False)
        return out, st
    ptrs = [_build.ptr(a[k]) for k in _FWD_ORDER] + [_build.ptr(out),
                                                     _build.ptr(st) if stash else None]
    dims = [d[k] for k in _DIM_ORDER]
    stream = ctypes.c_void_p(_build.stream_ptr(dev))
    if compute_dtype == torch.float32:
        # the float32 kernels read the transposed weights
        ptrs = [_build.ptr(a.get(k + "T", a[k])) for k in _FWD_ORDER] + ptrs[len(_FWD_ORDER):]
    # the view sums of NS > 1, by route: the wgmma forward's per 64-point
    # tile 64 x 128 floats for each 128-column half of each consumer
    # warpgroup's d_hidden / 2 columns; the float32 forward's 32 x d_hidden
    # floats a tile; the cluster kernels' a CTA's points x d_hidden floats
    # over the grid (whole clusters)
    if ns == 1:
        pool = None
    elif route == "wgmma":
        pool = torch.empty((-(-N // FWD_TILE) * FWD_TILE, 256 * (2 if dh > 256 else 1)),
                           dtype=torch.float32, device=dev)
    elif route == "fma":
        plan = f32_forward_plan(N, ns, dh, d["d_latent"], d["k_in"], d["n_blocks"], d["n_lin_z"])
        pool = torch.empty((plan.blocks * plan.tile, dh), dtype=torch.float32, device=dev)
    else:
        tile = dgrad_tile(compute_dtype, route)
        pool = torch.empty((-(-N // tile) * tile, dh), dtype=torch.float32, device=dev)
    fn = _build.kernel_fn(_FWD_ENTRY[route], FWD_ARGTYPES)
    err = fn(*ptrs, _build.ptr(pool) if ns > 1 else None, *dims, stream)
    _build.check(NAME_STASH if stash else NAME, err)
    _build.launches[{"wgmma": NAME_WGMMA, "fma": NAME_F32}.get(route,
                                                               NAME_WIDE[compute_dtype])] += 1
    if route in _CLUSTER_NAMES:
        _build.launches[_CLUSTER_NAMES[route][0]] += 1
    return out, st


def _bwd_operands(a, d, g, name):
    """What both backwards share: ``g`` in float32, the dgrad's weights
    (bf16: transposed copies; float32: as they are, lin_in zero-padded) and
    the zeroed float32 weight-gradient sums."""
    dev = g.device
    dh, dl, nb, nlz = d["d_hidden"], d["d_latent"], d["n_blocks"], d["n_lin_z"]
    g = g.float().contiguous()
    _build.check_cuda_inputs(name, {"g": g}, dev)
    f32_walk = a["wi"].dtype == torch.float32
    wd = [a[k] for k in ("wi", "wz", "w0", "w1")] if f32_walk else _transposed(a)
    f32 = dict(dtype=torch.float32, device=dev)
    grads = dict(wi=torch.zeros((dh, d["k_in"]), **f32), bi=torch.zeros((dh,), **f32),
                 wz=torch.zeros((nlz, dh, dl), **f32), bz=torch.zeros((nlz, dh), **f32),
                 w0=torch.zeros((nb, dh, dh), **f32), b0=torch.zeros((nb, dh), **f32),
                 w1=torch.zeros((nb, dh, dh), **f32), b1=torch.zeros((nb, dh), **f32),
                 wo=torch.zeros((d["d_out"], dh), **f32), bo=torch.zeros((d["d_out"],), **f32))
    return g, wd, grads


def _grads_tuple(dx, dz, grads):
    return (dx, dz, grads["wi"], grads["bi"], grads["wz"], grads["bz"], grads["w0"],
            grads["b0"], grads["w1"], grads["b1"], grads["wo"], grads["bo"])


def _dgrad_route(d, compute_dtype) -> str:
    return backward_route(compute_dtype, d["d_hidden"], d["d_latent"], d["k_in"])


def dgrad_tile(compute_dtype, route: Optional[str] = None) -> int:
    """Points a dgrad CTA walks on ``route`` (:func:`backward_route`; by
    default the dtype's route at the shipped widths): 64 on the bf16 wgmma
    walk (``csrc/resnetfc_hopper.cu``), :func:`f32_dgrad_plan`'s tile (32) on
    the float32 one; on the cluster kernels a cluster's points (their grid
    is whole clusters, a CTA ``WIDE_TMA_TM`` or ``WIDE_F32_TM`` of them)."""
    route = route or ("wgmma" if compute_dtype == torch.bfloat16 else "fma")
    return {"wgmma": 64, "fma": F32_FWD_TILE, "wide_tma": WIDE_TMA_TM * WIDE_TMA_CLUSTER,
            "wide_f32": WIDE_F32_TM * WIDE_F32_CLUSTER}[route]


_DGRAD_ENTRY = {"wgmma": "avr_resnetfc_dgrad_bf16", "fma": "avr_resnetfc_dgrad",
                "wide_tma": "avr_resnetfc_dgrad_wide_tma",
                "wide_f32": "avr_resnetfc_dgrad_wide_f32"}


def _dgrad(a, d, st, g, wd, compute_dtype, out=None, pool=None, name=NAME_DGRAD):
    """The dgrad launch on the stash ``st`` with the weights ``wd`` (what
    :func:`_bwd_operands` returns): ``dx``, ``dz``, and what the wgrad
    reads: the rounded product cotangents ``cot``, the rounded output
    cotangent ``gout`` and the encoded input ``enc``; into ``out`` (those
    five, by name) where given, with ``pool`` the NS > 1 scratch.  The
    kernel is :func:`backward_route`'s: float32's register-tiled dgrad is
    counted also under ``NAME_DGRAD_F32``, either cluster one under
    ``NAME_DGRAD_WIDE[compute_dtype]`` and the TMA cluster one also under
    ``NAME_DGRAD_WIDE_TMA``, the float32 cluster one also under
    ``NAME_DGRAD_WIDE_F32_RING``, the chain under
    ``NAME_DGRAD_CHAIN[compute_dtype]``."""
    ns, N, dh = d["ns"], d["N"], d["d_hidden"]
    cd = compute_dtype
    dev = g.device
    route = _dgrad_route(d, cd)
    if out is None:
        out = dict(dx=torch.zeros((ns, N, d["d_in"]), dtype=torch.float32, device=dev),
                   dz=torch.zeros((ns, N, d["d_latent"]), dtype=cd, device=dev),
                   cot=torch.empty((cot_slots(ns, d["n_blocks"], d["n_lin_z"]), N, dh),
                                   dtype=cd, device=dev),
                   gout=torch.empty((N, GOUT_W), dtype=cd, device=dev),
                   enc=torch.empty((ns, N, d["k_in"]), dtype=cd, device=dev))
    if route == "chain":
        if N:
            t = dict(x=a["x"], g=g, stash=st, wo=a["wo"], bo=a["bo"], tables=a["tables"],
                     fph=a["fph"], **dict(zip(("wi", "wz", "w0", "w1"), wd)), **out)
            _chain_run(name, chain_plan(ns, d["n_blocks"], d["n_lin_z"], True), t, d, cd, True,
                       True, work=pool)
        return out["dx"], out["dz"], out["cot"], out["gout"], out["enc"]
    # the pooled trunk cotangent of NS > 1: a tile of rows a CTA
    tile = dgrad_tile(cd, route)
    rows = -(-N // tile) * tile
    if ns > 1 and pool is None:
        pool = torch.empty((rows, dh), dtype=torch.float32, device=dev)
    if ns > 1 and (pool.dtype != torch.float32 or pool.numel() < rows * dh):
        raise ValueError(f"{name}: the pool holds {pool.numel()} {pool.dtype} values; the "
                         f"dgrad's CTAs need {rows} x {dh} float32")
    if N:
        ptrs = [_build.ptr(t) for t in (a["x"], g, st, *wd, a["wo"], a["bo"], a["tables"],
                                        a["fph"], *(out[k] for k in ("dx", "dz", "cot", "gout",
                                                                      "enc")))]
        ptrs.append(_build.ptr(pool) if ns > 1 else None)
        dims = [d[k] for k in _DIM_ORDER]
        stream = ctypes.c_void_p(_build.stream_ptr(dev))
        # the float32 dgrad's entry also takes the dtype
        dtype = [_DTYPES[cd]] if route == "fma" else []
        fn = _build.kernel_fn(_DGRAD_ENTRY[route], [ctypes.c_void_p] * 17
                              + [ctypes.c_int] * (10 + len(dtype)) + [ctypes.c_void_p])
        err = fn(*ptrs, *dims, *dtype, stream)
        _build.check(name, err)
        if route != "wgmma":
            _build.launches[NAME_DGRAD_F32 if route == "fma" else NAME_DGRAD_WIDE[cd]] += 1
        if route in _CLUSTER_NAMES:
            _build.launches[_CLUSTER_NAMES[route][1]] += 1
    return out["dx"], out["dz"], out["cot"], out["gout"], out["enc"]


def _backward(a, d, st, g, compute_dtype):
    """The stash backward: ``(dx, dz, dwi (dh, k_in), dbi, dwz, dbz, dw0,
    db0, dw1, db1, dwo, dbo)``, weight cotangents in float32."""
    g, wd, grads = _bwd_operands(a, d, g, NAME_DGRAD)
    dx, dz, cot, gout, enc = _dgrad(a, d, st, g, wd, compute_dtype)
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
    route = _dgrad_route(d, compute_dtype)
    if route == "chain":  # the chain's dgrad workspace in place of the pool
        return bufs, torch.empty((chain_workspace(p, d["ns"], d["d_hidden"], d["k_in"],
                                                  compute_dtype, True, True)["bytes"],),
                                 dtype=torch.uint8, device=device)
    tile = dgrad_tile(compute_dtype, route)
    pool = (torch.empty(((p + tile - 1) // tile * tile, d["d_hidden"]), dtype=torch.float32,
                        device=device) if d["ns"] > 1 else None)
    return bufs, pool


def _recompute_chunk(a, d, g, wd, work, s, n, dx, dz, compute_dtype):
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
    _dgrad(ac, dc, st, g[s:s + n], wd, cd, out=dict(dx=dxc, dz=dzc, cot=cot, gout=gout[0], enc=enc),
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
    g, wd, grads = _bwd_operands(a, d, g, NAME_RECOMPUTE)
    dev = g.device
    dx = torch.empty((ns, N, d["d_in"]), dtype=torch.float32, device=dev)
    dz = torch.empty((ns, N, d["d_latent"]), dtype=compute_dtype, device=dev)
    # the workspace, sized for one chunk and reused by every chunk
    work = _recompute_workspace(d, min(N, RECOMPUTE_CHUNK), compute_dtype, dev)
    for s in range(0, N, RECOMPUTE_CHUNK):
        n = min(RECOMPUTE_CHUNK, N - s)
        zc, st, cot, gout, enc = _recompute_chunk(a, d, g, wd, work, s, n, dx, dz, compute_dtype)
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
        dl = ctx.like[1][1][-1]  # the latent's zero-padded lanes (pad_latent)
        grads[1], grads[4] = grads[1][..., :dl], grads[4][..., :dl]
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
    if d_hidden % 64 or d_hidden < 64 or d_latent < 1 or d_out > GOUT_W:
        raise ValueError(f"{NAME}: kernel needs d_hidden a multiple of 64, d_latent > 0 and "
                         f"d_out <= {GOUT_W}, got {d_hidden}, {d_latent}, {d_out}")
    if z.shape[:2] != (ns, N) or w.wz.shape != (n_lin_z, d_hidden, d_latent):
        raise ValueError(f"{NAME}: z {tuple(z.shape)} / wz {tuple(w.wz.shape)} mismatch")
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (x, z, *w))
    a = _prepare(x, z, w, code, compute_dtype)
    _build.check_cuda_inputs(NAME, a, x.device)
    d = _dims(a, n_blocks, n_lin_z, activate_out)
    if grad:
        return _Decoder.apply(x, z, *w, a, d, compute_dtype, keep)
    return _forward(a, d, compute_dtype, stash=False)[0]
