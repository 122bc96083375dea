"""K3: fused LSTM ray-march — CUDA kernels (forward and backward), the
autograd function that joins them, its plain version and ``pack_projection``.

Replaces ``avr_tpu/ops/pallas/march.py:703 fused_lstm_march``: the forward
(``:556``) and the backward (``:621``, kernel ``:381-521``).  The whole
march per ray: for ``steps`` steps, project the point into each source view
with the packed scalars, gather the bilinear latent (float32 blend) and mean
it over the views, run the LSTM cell (gate order i, f, g, o; ``gates = v @
W_ih + h @ W_hh + b``), clip the hidden state's cotangent to
``+-grad_clamp`` (the reference's autograd hook), take the signed step ``s =
h @ w_out + b_out`` along the ray; with ``early_stop_eps > 0`` rays whose
``|s|`` falls below the threshold freeze (``active`` carries no gradient).
Matmul operands (weights, biases, ``v`` and ``h``) are rounded to the
compute dtype; the carries ``h``, ``c`` and the coordinates stay float32.
Gradients reach the start points, the ray directions, the latent and every
LSTM and step-head weight; the packed projection gets none (camera poses
are data, as in the JAX package).

What bounds it on Hopper: neither peak, but the 10 dependent steps.  At the
train step's call (4 x 4,096 rays x 10 steps, C = 512, hidden 16) the gate
products are ~11 GFLOP (~0.011 ms at the bf16 peak) and the saved rows ~79
MB; the taps come from L2 (the latent is 4 MB a view).  Each step needs the
last one's point, so the time is 10 times the latency of one step while
enough rays are in flight to fill the card.  :func:`march_route` picks the
kernels by dtype and hidden size:

* ``"tiles"`` (bf16, the main path; ``csrc/march.cu lstm_march_tile_kernel``
  and ``lstm_march_tile_bwd_kernel``): a warp marches 16 rays in lockstep,
  their gate products by ``mma.sync`` (16 rays are the products' M; wgmma's
  64 rows a warpgroup would leave half the card idle at 4,096 rays), the
  CTA's warps sharing one copy of the weights in shared memory.  The gate
  columns are permuted (:func:`gate_permutation`) so that a lane holds all
  four gates of its units, and the weights are passed as ``mma.sync`` B
  fragments (:func:`b_fragments`), the forward's kept per weight
  (:func:`_kept_fragments`).  The backward walks the tiles back from
  the saved rows and writes, per ray-step, ``round(dv / NS)``, its point,
  ``v_t`` with ``round(h_prev)`` after it, and the rounded gate cotangents;
  the latent cotangent is then K5's binned accumulation (``csrc/bins.cuh``,
  no float atomics, written once in bf16), and ``dW_ih`` and ``dW_hh`` one
  bf16 wgrad of two jobs (``csrc/resnetfc_hopper.cu``
  ``resnetfc_wgrad_wgmma_kernel``; counted as
  ``fused_lstm_march_bwd_wgrad``).  Every output is bit for bit the same
  on a rerun.  Counted also under ``fused_lstm_march_tiles`` and
  ``fused_lstm_march_bwd_tiles``.
* ``"warp"`` (float32; ``lstm_march_kernel``, ``lstm_march_bwd_kernel``):
  one warp a ray, eight rays a CTA, float32 FMA (float32 operands on the
  tensor cores would round to TF32).  The backward writes the same rows as
  the tile walk, in float32 (``dv / NS`` and the point of every ray-step,
  ``v_t | h_prev`` and the gate cotangents), the latent cotangent goes
  through the bins' float32 accumulate, ``dW_ih`` and ``dW_hh`` are one
  float32 wgrad of two jobs, and the bias and step-head sums are lane-owned
  partials added per CTA and then in CTA order (:func:`walk_ctas_f32`): no
  float atomics, every output bit for bit the same on a rerun.

The TPU kernel's ray sort (``models/wrapper.py:256-280``) only feeds its
windowed gather; the port leaves it out.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.ops.kernels.gather import _bin_scratch, bilinear_f32, project_packed
from avr_tpu_torch.ops.kernels.resnetfc import wgrad
from avr_tpu_torch.renderers.lstm import clamp_grad

__all__ = ["pack_projection", "fused_lstm_march", "lstm_march_plain", "march_route"]

NAME = "fused_lstm_march"
NAME_BWD = "fused_lstm_march_bwd"
NAME_WGRAD = "fused_lstm_march_bwd_wgrad"
# the bf16 route's launches, counted also under NAME and NAME_BWD
NAME_TILES = "fused_lstm_march_tiles"
NAME_BWD_TILES = "fused_lstm_march_bwd_tiles"
_DTYPES = (torch.float32, torch.bfloat16)
MAX_HIDDEN = 62  # the TPU kernel's 2 H + 4 <= 128 (avr_tpu/models/wrapper.py:219)
UNIT_BLOCK = 8  # units of one n8 tile of the permuted gates (csrc/march.cu UNIT_BLOCK)
TILE_RAYS = 16  # rays a warp of the tile kernels marches (csrc/march.cu TILE_RAYS)


def march_route(dtype: torch.dtype, hidden: int) -> str:
    """The kernels a card call of ``dtype`` and ``hidden`` runs: ``"tiles"``
    (bf16: 16-ray tiles on the tensor cores) or ``"warp"`` (float32: a warp
    a ray).  Raises for a hidden size outside 1 .. ``MAX_HIDDEN`` or another
    dtype."""
    if not 0 < hidden <= MAX_HIDDEN:
        raise ValueError(f"{NAME}: hidden {hidden} outside 1 .. {MAX_HIDDEN} (the TPU "
                         f"kernel's 2 H + 4 <= 128)")
    if dtype not in _DTYPES:
        raise TypeError(f"{NAME}: compute dtype {dtype} is not one of {list(_DTYPES)}")
    return "tiles" if dtype == torch.bfloat16 else "warp"


def padded_hidden(hid: int) -> int:
    """Hidden units the tile kernels carry: a multiple of 16 (one k16 chunk
    of the ``h W_hh`` product), the padding held at zero."""
    return -(-hid // 16) * 16


def gate_permutation(hid: int) -> torch.Tensor:
    """Column ``p`` of the tile kernels' gate layout (``4 * padded_hidden``
    columns) holds gate column ``perm[p]`` of ``[i | f | g | o]``, or the
    zero padding (``4 * hid``): n8 tile ``4 b + k`` is gate ``k`` of units
    ``8 b .. 8 b + 7``, so an ``mma.sync`` lane's accumulators hold all four
    gates of its units."""
    p = torch.arange(4 * padded_hidden(hid))
    blk, k, c = p // (4 * UNIT_BLOCK), p // UNIT_BLOCK % 4, p % UNIT_BLOCK
    u = blk * UNIT_BLOCK + c
    return torch.where(u < hid, k * hid + u, torch.full_like(p, 4 * hid))


@functools.lru_cache(maxsize=None)
def _gate_index(hid: int, device: torch.device, inverse: bool) -> torch.Tensor:
    """:func:`gate_permutation` (or its inverse) on ``device``, kept."""
    perm = gate_permutation(hid)
    if inverse:
        live = perm < 4 * hid
        perm = torch.empty(4 * hid, dtype=torch.long).index_put_(
            (perm[live],), torch.nonzero(live).squeeze(1))
    return perm.to(device)


def permute_gates(w: torch.Tensor, hid: int) -> torch.Tensor:
    """``w (..., 4 hid)`` in the tile kernels' gate layout ``(..., 4 HP)``."""
    pad = torch.cat([w, w.new_zeros(w.shape[:-1] + (1,))], dim=-1)
    return pad[..., _gate_index(hid, w.device, False)]


def unpermute_gates(w: torch.Tensor, hid: int) -> torch.Tensor:
    """The inverse of :func:`permute_gates`: ``(..., 4 HP)`` -> ``(..., 4 hid)``."""
    return w[..., _gate_index(hid, w.device, True)]


def b_fragments(b: torch.Tensor, fill=0) -> torch.Tensor:
    """``b (K, N)`` as ``mma.sync.m16n8k16`` B operands in lane order,
    ``(K / 16, N / 16, 32, 8)`` (K and N padded with ``fill`` to multiples
    of 16): lane ``l`` of k16 chunk ``kc`` and n8 tiles ``2 j``, ``2 j + 1`` holds
    ``b[16 kc + kr, 16 j + 8 (e // 4) + l // 4]`` at ``e``, with ``kr = 8 (e %
    4 // 2) + 2 (l % 4) + e % 2``: the registers ``b0, b1`` of both tiles,
    one 16-byte load."""
    K, N = b.shape
    bp = b.new_full((-(-K // 16) * 16, -(-N // 16) * 16), fill)
    bp[:K, :N] = b
    lane, e = torch.arange(32)[:, None], torch.arange(8)[None, :]
    kr = (e % 4 // 2) * 8 + (lane % 4) * 2 + e % 2
    nr = (e // 4) * 8 + lane // 4
    kc = torch.arange(bp.shape[0] // 16)[:, None, None, None]
    j = torch.arange(bp.shape[1] // 16)[None, :, None, None]
    return bp[(kc * 16 + kr).to(b.device), (j * 16 + nr).to(b.device)]


def aux_width(hid: int) -> int:
    """Floats per saved row (``csrc/march.cu aux_width``)."""
    return (7 * hid + 5 + 3) // 4 * 4


def pack_projection(poses_w2c: torch.Tensor, focal: torch.Tensor, c: torch.Tensor,
                    latent_scaling: torch.Tensor, image_shape: torch.Tensor) -> torch.Tensor:
    """Per-view projection scalars ``(B, 16)`` float32: ``[R (9) | t (3) |
    fg (2) | cg (2)]`` with ``grid = -cam_xy / cam_z * fg + cg``, ``fg =
    focal * scale`` and ``cg = c * scale - 1`` (``scale = latent_scaling /
    image_shape``; focal already fy-negated)."""
    B = poses_w2c.shape[0]
    rot = poses_w2c[:, :3, :3].reshape(B, 9)
    t = poses_w2c[:, :3, 3]
    scale = (latent_scaling / image_shape)[None, :]
    fg = focal.reshape(-1, 2).expand(B, 2) * scale
    cg = c.reshape(-1, 2).expand(B, 2) * scale - 1.0
    return torch.cat([rot, t, fg, cg], dim=-1).float()


def lstm_march_plain(proj, coords0, rds, feat, w_ih, w_hh, bias, w_out, b_out, *,
                     steps: int, early_stop_eps: float = 0.0, grad_clamp: float = 10.0,
                     compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernels' function in plain PyTorch (argument layout as
    :func:`fused_lstm_march`; autograd gives the backward, with the hidden
    state's cotangent clipped as ``avr_tpu/renderers/raymarch.py:83-85``
    does)."""
    c = lambda t: t.to(compute_dtype).float()
    w_ih, w_hh, bias, w_out, b_out = (c(t) for t in (w_ih, w_hh, bias, w_out, b_out))
    SB, NS = feat.shape[:2]
    R = coords0.shape[1]
    hid = w_hh.shape[0]
    coords = coords0.float()
    h = coords.new_zeros((SB, R, hid))
    cc = coords.new_zeros((SB, R, hid))
    active = coords.new_ones((SB, R, 1))
    for _ in range(steps):
        v = None
        for view in range(NS):
            g = bilinear_f32(feat[:, view], project_packed(proj[:, view], coords))
            v = g if v is None else v + g
        if NS > 1:
            v = v * (1.0 / NS)
        gates = c(v) @ w_ih + c(h) @ w_hh + bias
        i, f, g, o = gates.split(hid, dim=-1)
        cc = torch.sigmoid(f) * cc + torch.sigmoid(i) * torch.tanh(g)
        h = clamp_grad(torch.sigmoid(o) * torch.tanh(cc), grad_clamp)
        s = c(h) @ w_out + b_out
        if early_stop_eps > 0.0:
            s = s * active
            active = active * (1.0 - (torch.abs(s) < early_stop_eps).float())
        coords = coords + rds * s
    return coords


_F32_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
_F32_BWD_ARGS = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p]
_TILES_BWD_ARGS = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]


def gate_row_width(hid: int) -> int:
    """Row width of the float32 route's saved gate cotangents: 4 H rounded
    up to 8 values."""
    return -(-4 * hid // 8) * 8


@functools.lru_cache(maxsize=None)
def _gather_index(K: int, hid: int, transpose: bool, device: torch.device) -> torch.Tensor:
    """Flat indices into ``w (K, 4 hid)`` with one zero slot after it (index
    ``K * 4 hid``): gathered, they give ``b_fragments`` of the permuted
    gates (``transpose``: of their transpose), one gather on the card."""
    zero = K * 4 * hid
    src = torch.arange(zero).reshape(K, 4 * hid)
    src = torch.cat([src, torch.full((K, 1), zero)], dim=-1)[..., gate_permutation(hid)]
    return b_fragments(src.t() if transpose else src, fill=zero).to(device)


def _tile_operands(a: dict, hid: int, backward: bool) -> dict:
    """W_ih's and W_hh's permuted gates as the tile kernels' B fragments
    (``backward``: of their transpose, K = the permuted gates); one gather
    each through cached indices.  The kernels permute the bias and pad the
    step head as they stage them."""
    dev = a["w_ih"].device
    frags = lambda w: torch.cat([w.reshape(-1), w.new_zeros(1)])[
        _gather_index(w.shape[0], hid, backward, dev)]
    names = ("wihT", "whhT") if backward else ("wih", "whh")
    return {n: frags(a[k]) for n, k in zip(names, ("w_ih", "w_hh"))}


_KEPT: dict = {}  # the forward's fragments per pair of weights
_KEPT_MAX = 8


def _kept_fragments(w_ih: torch.Tensor, w_hh: torch.Tensor, a: dict, hid: int) -> dict:
    """The forward's :func:`_tile_operands` of the caller's ``w_ih`` and
    ``w_hh``, kept while both are the same tensors (or views of the same
    bases), unchanged (their version counters) at the same address and
    layout, so a served frame gathers them once; computed anew otherwise."""
    ws = (w_ih, w_hh)
    if any(w.is_inference() for w in ws):  # no version counter to watch
        return _tile_operands(a, hid, backward=False)
    bases = tuple(w if w._base is None else w._base for w in ws)
    key = tuple(id(b) for b in bases) + (hid,)
    state = tuple((w.data_ptr(), w._version, w.shape, w.stride(), w.dtype) for w in ws)
    kept = _KEPT.get(key)
    if kept is not None and kept[1] == state and all(r() is b for r, b in zip(kept[0], bases)):
        return kept[2]
    t = _tile_operands(a, hid, backward=False)
    _KEPT.pop(key, None)
    while len(_KEPT) >= _KEPT_MAX:
        _KEPT.pop(next(iter(_KEPT)))
    _KEPT[key] = (tuple(weakref.ref(b) for b in bases), state, t)
    return t


def _forward(a: dict, steps: int, eps: float, cd: torch.dtype, save: bool):
    """Launch the forward; with ``save`` also return the saved rows."""
    SB, NS, H, W, C = a["feat"].shape
    R = a["coords0"].shape[1]
    hid = a["w_hh"].shape[0]
    dev = a["feat"].device
    out = torch.empty((SB, R, 3), dtype=torch.float32, device=dev)
    aux = (torch.empty((SB * R, steps, aux_width(hid)), dtype=torch.float32, device=dev)
           if save else None)
    if SB * R == 0:
        return out, aux
    stream = ctypes.c_void_p(_build.stream_ptr(dev))
    tail = (_build.ptr(out), _build.ptr(aux) if save else None, SB, R, NS, H, W, C, hid, steps,
            float(eps), stream)
    if march_route(cd, hid) == "tiles":
        err = _build.kernel_fn("avr_lstm_march_tiles", _F32_ARGS)(
            *(_build.ptr(a[k]) for k in ("proj", "coords0", "rds", "feat", "wih", "whh", "bias",
                                         "w_out", "b_out")), *tail)
        _build.check(NAME, err)
        _build.launches[NAME_TILES] += 1
    else:
        err = _build.kernel_fn("avr_lstm_march_f32", _F32_ARGS)(
            *(_build.ptr(a[k]) for k in ("proj", "coords0", "rds", "feat", "w_ih", "w_hh",
                                         "bias", "w_out", "b_out")), *tail)
        _build.check(NAME, err)
    return out, aux


def _backward_tiles(a: dict, aux: torch.Tensor, g: torch.Tensor, steps: int, grad_clamp: float):
    """The bf16 backward: the walk, the binned latent cotangent and the
    partial sums' reduction (one C call), then ``dW_ih`` and ``dW_hh`` as
    one wgrad of two jobs over the walk's rows."""
    SB, NS, H, W, C = a["feat"].shape
    R = a["coords0"].shape[1]
    hid = a["w_hh"].shape[0]
    HP = padded_hidden(hid)
    dev = g.device
    rows = SB * R * steps
    f32 = dict(dtype=torch.float32, device=dev)
    bf = dict(dtype=torch.bfloat16, device=dev)
    dcoords0, drds = torch.empty((SB, R, 3), **f32), torch.empty((SB, R, 3), **f32)
    vbuf = torch.empty((rows, C + HP), **bf)  # v_t | round(h_prev): dW_ih's and dW_hh's rows
    dgbuf = torch.empty((rows, 4 * HP), **bf)  # round(dgates), permuted
    dvbuf = torch.empty((rows, C), **bf)  # round(dv / NS): the bins' cotangent rows
    pts = torch.empty((rows, 3), **f32)  # the ray-steps' points
    part = torch.empty((-(-SB * R // TILE_RAYS), 5 * HP + 1), **f32)
    dfeat = torch.empty((SB, NS, H, W, C), **bf)
    ints, partials = _bin_scratch(NAME_BWD, dfeat.view(SB * NS, H, W, C), R * steps)
    dbias, dw_out, db_out = (torch.empty(n, **f32) for n in (4 * HP, HP, 1))
    t = _tile_operands(a, hid, backward=True)
    err = _build.kernel_fn("avr_lstm_march_tiles_bwd", _TILES_BWD_ARGS)(
        *(_build.ptr(x) for x in (a["proj"], a["rds"], a["feat"], t["wihT"], t["whhT"],
                                  a["w_out"], aux, g, dcoords0, drds, vbuf, dgbuf, dvbuf, pts,
                                  part, dfeat, ints, partials, dbias, dw_out, db_out)),
        SB, R, NS, H, W, C, hid, steps, float(grad_clamp), ctypes.c_void_p(_build.stream_ptr(dev)))
    _build.check(NAME_BWD, err)
    _build.launches[NAME_BWD_TILES] += 1
    dw_ih, dw_hh = torch.zeros((C, 4 * HP), **f32), torch.zeros((HP, 4 * HP), **f32)
    wgrad(NAME_WGRAD, [(vbuf.data_ptr(), dgbuf.data_ptr(), dw_ih, None, rows, C + HP, 4 * HP, C,
                        4 * HP),
                       (vbuf.data_ptr() + 2 * C, dgbuf.data_ptr(), dw_hh, None, rows, C + HP,
                        4 * HP, HP, 4 * HP)], torch.bfloat16, dev)
    return (dcoords0, drds, dfeat, unpermute_gates(dw_ih, hid), unpermute_gates(dw_hh[:hid], hid),
            unpermute_gates(dbias, hid), dw_out[:hid], db_out)


WARPS_F32 = 8  # rays a CTA of the float32 walk (csrc/march.cu WARPS)


def walk_ctas_f32(rays: int, sms: int) -> int:
    """CTAs of the float32 walk over ``rays`` rays on a card of ``sms`` SMs:
    one a ``WARPS_F32`` rays, at most one an SM (the walk is persistent
    over its warps' rays).  Fixed by the shapes and the card, so the lanes'
    partial sums, and their order, are the same on every run."""
    return max(1, min(-(-rays // WARPS_F32), sms))


def _backward_f32(a: dict, aux: torch.Tensor, g: torch.Tensor, steps: int, grad_clamp: float):
    """The float32 backward: the warp-per-ray walk, the binned latent
    cotangent and the partial sums' reduction (one C call), then ``dW_ih``
    and ``dW_hh`` as one float32 wgrad of two jobs over the walk's rows.  No
    float atomics."""
    SB, NS, H, W, C = a["feat"].shape
    R = a["coords0"].shape[1]
    hid = a["w_hh"].shape[0]
    dev = g.device
    rows = SB * R * steps
    f32 = dict(dtype=torch.float32, device=dev)
    dcoords0, drds = torch.empty((SB, R, 3), **f32), torch.empty((SB, R, 3), **f32)
    # per ray-step: v_t | h_prev (the width a multiple of 4: 16-byte rows),
    # the gate cotangents, dv / NS and the point; zero rows where a ray was
    # frozen
    vld = C + -(-hid // 4) * 4
    dg_ld = gate_row_width(hid)
    vbuf = torch.empty((rows, vld), **f32)
    dgbuf = torch.empty((rows, dg_ld), **f32)
    dvbuf = torch.empty((rows, C), **f32)
    pts = torch.empty((rows, 3), **f32)
    ctas = walk_ctas_f32(SB * R, torch.cuda.get_device_properties(dev).multi_processor_count)
    part = torch.empty((ctas, 5 * hid + 1), **f32)
    dfeat = torch.empty((SB, NS, H, W, C), **f32)
    ints, partials = _bin_scratch(NAME_BWD, dfeat.view(SB * NS, H, W, C), R * steps)
    dbias, dw_out, db_out = (torch.empty(n, **f32) for n in (4 * hid, hid, 1))
    err = _build.kernel_fn("avr_lstm_march_bwd_f32", _F32_BWD_ARGS)(
        *(_build.ptr(t) for t in (
            a["proj"], a["rds"], a["feat"], a["w_ih"].t().contiguous(), a["w_hh"], a["w_out"],
            aux, g, dcoords0, drds, vbuf, dgbuf, dvbuf, pts, part, dfeat, ints, partials, dbias,
            dw_out, db_out)),
        SB, R, NS, H, W, C, hid, steps, vld, dg_ld, ctas, float(grad_clamp),
        ctypes.c_void_p(_build.stream_ptr(dev)))
    _build.check(NAME_BWD, err)
    dw_ih, dw_hh = torch.zeros((C, 4 * hid), **f32), torch.zeros((hid, 4 * hid), **f32)
    wgrad(NAME_WGRAD, [(vbuf.data_ptr(), dgbuf.data_ptr(), dw_ih, None, rows, vld, dg_ld, C,
                        4 * hid),
                       (vbuf.data_ptr() + 4 * C, dgbuf.data_ptr(), dw_hh, None, rows, vld,
                        dg_ld, hid, 4 * hid)], torch.float32, dev)
    return dcoords0, drds, dfeat, dw_ih, dw_hh, dbias, dw_out, db_out


class _March(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coords0, rds, feat, w_ih, w_hh, bias, w_out, b_out, a, steps, eps,
                grad_clamp, cd):
        out, aux = _forward(a, steps, eps, cd, save=True)
        ctx.a, ctx.aux, ctx.cfg = a, aux, (steps, grad_clamp, cd)
        ctx.dtypes = [t.dtype for t in (coords0, rds, feat, w_ih, w_hh, bias, w_out, b_out)]
        ctx.shapes = [t.shape for t in (w_out, b_out)]
        return out

    @staticmethod
    def backward(ctx, g):
        steps, grad_clamp, cd = ctx.cfg
        g = g.float().contiguous()
        _build.check_cuda_inputs(NAME_BWD, {"g": g}, ctx.a["feat"].device)
        hid = ctx.a["w_hh"].shape[0]
        if not g.numel():  # no ray: nothing to launch
            grads = [torch.zeros_like(ctx.a[k], dtype=torch.float32) for k in
                     ("coords0", "rds", "feat", "w_ih", "w_hh", "bias", "w_out", "b_out")]
        else:
            run = _backward_tiles if march_route(cd, hid) == "tiles" else _backward_f32
            grads = list(run(ctx.a, ctx.aux, g, steps, grad_clamp))
        grads[6], grads[7] = grads[6].reshape(ctx.shapes[0]), grads[7].reshape(ctx.shapes[1])
        return tuple(gr.to(dt) for gr, dt in zip(grads, ctx.dtypes)) + (None,) * 5


def fused_lstm_march(proj: torch.Tensor,  # (SB, NS, 16) packed projections
                     coords0: torch.Tensor,  # (SB, R, 3) initial world points
                     rds: torch.Tensor,  # (SB, R, 3) unit ray directions
                     feat: torch.Tensor,  # (SB, NS, H, W, C) latents
                     w_ih: torch.Tensor,  # (C, 4H)
                     w_hh: torch.Tensor,  # (H, 4H)
                     bias: torch.Tensor,  # (4H,) b_ih + b_hh
                     w_out: torch.Tensor,  # (H, 1)
                     b_out: torch.Tensor,  # (1,)
                     *, steps: int, early_stop_eps: float = 0.0, grad_clamp: float = 10.0,
                     compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """March every ray ``steps`` times; returns final world points ``(SB, R, 3)``
    float32.  CPU tensors take the plain version; CUDA tensors launch the
    kernels of :func:`march_route` (the latent must already be in the
    compute dtype, as the encoder stores it), and under autograd their
    backward."""
    if feat.device.type == "cpu":
        return lstm_march_plain(proj, coords0, rds, feat, w_ih, w_hh, bias, w_out, b_out,
                                steps=steps, early_stop_eps=early_stop_eps,
                                grad_clamp=grad_clamp, compute_dtype=compute_dtype)
    SB, NS, H, W, C = feat.shape
    R = coords0.shape[1]
    hid = w_hh.shape[0]
    route = march_route(compute_dtype, hid)  # raises for a dtype or hidden size no kernel takes
    if feat.dtype != compute_dtype:
        raise TypeError(f"{NAME}: latent dtype {feat.dtype} must be the compute dtype "
                        f"{compute_dtype}")
    if w_ih.shape != (C, 4 * hid):
        raise ValueError(f"{NAME}: w_ih must be (C, 4H), got w_hh {tuple(w_hh.shape)} "
                         f"w_ih {tuple(w_ih.shape)}")
    if C % (16 // feat.element_size()):
        raise ValueError(f"{NAME}: channels {C} must fill 16-byte vectors")
    if proj.shape != (SB, NS, 16) or rds.shape != (SB, R, 3):
        raise ValueError(f"{NAME}: proj {tuple(proj.shape)} / rds {tuple(rds.shape)} mismatch")
    cd = lambda t: t.detach().to(compute_dtype).contiguous()
    f32 = lambda t: t.detach().to(compute_dtype).float().contiguous()
    a = dict(proj=proj.detach().float().contiguous(),
             coords0=coords0.detach().float().contiguous(),
             rds=rds.detach().float().contiguous(), feat=feat.detach().contiguous(),
             w_ih=cd(w_ih), w_hh=cd(w_hh), bias=f32(bias), w_out=f32(w_out.reshape(hid)),
             b_out=f32(b_out.reshape(1)))
    _build.check_cuda_inputs(NAME, a, feat.device)
    if route == "tiles":
        a.update(_kept_fragments(w_ih, w_hh, a, hid))
    grad_args = (coords0, rds, feat, w_ih, w_hh, bias, w_out, b_out)
    if torch.is_grad_enabled() and any(t.requires_grad for t in grad_args):
        return _March.apply(*grad_args, a, steps, early_stop_eps, grad_clamp, compute_dtype)
    return _forward(a, steps, early_stop_eps, compute_dtype, save=False)[0]
