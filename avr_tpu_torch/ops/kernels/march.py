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

What bounds it on Hopper: neither peak.  At the slice's shape (4 x 4,096
rays x 10 steps, C = 512) the forward is ~2.9 GFLOP per 4,096 rays (~3 us
at the bf16 peak) and a few MB of compulsory traffic; the backward ~2.3e10
FLOP and 67 MB of dfeat zeroing and writing (~0.02 ms).  Both take the
time of 10 dependent steps.  Forward: one warp per ray, eight rays per CTA,
``W_ih`` (512 x 64) in shared memory (read from L2 where it takes more than
128 KB; lane ``k`` carries units ``k`` and ``k + 32``, so hidden goes up to
62, the TPU kernel's ``2 H + 4 <= 128``), each step's 4-tap gather read
from L2 and blended in registers, the carries in registers for all steps; under
autograd it also writes one float32 row per ray and step (h_prev, c_prev,
coordinates, active, gates, tanh c, s).  Backward: one warp per ray walks
the steps in reverse from those rows, re-blends ``v_t`` from the four taps
it loads anyway for the coordinate cotangent, computes ``dv`` from
``W_ih^T`` in shared memory, adds ``dfeat`` by float4 atomics, and writes
``v_t`` and the rounded gate cotangents per ray-step; ``dW_ih`` is then one
GEMM through the decoder's bf16 wgrad (``wgmma``, its rows split over the
card; counted as ``fused_lstm_march_bwd_wgrad``), the gate cotangents'
rows padded to 8 values (16-byte TMA rows).  The TPU kernel's ray sort
(``models/wrapper.py:256-280``) only feeds its windowed gather; the port
leaves it out.
"""

from __future__ import annotations

import ctypes

import torch

from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.ops.kernels.gather import bilinear_f32, project_packed
from avr_tpu_torch.ops.kernels.resnetfc import wgrad
from avr_tpu_torch.renderers.lstm import clamp_grad

__all__ = ["pack_projection", "fused_lstm_march", "lstm_march_plain"]

NAME = "fused_lstm_march"
NAME_BWD = "fused_lstm_march_bwd"
NAME_WGRAD = "fused_lstm_march_bwd_wgrad"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HIDDEN = 62  # the TPU kernel's 2 H + 4 <= 128 (avr_tpu/models/wrapper.py:219)


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


_FWD_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                                            ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2 + [
    ctypes.c_int, ctypes.c_void_p]


def gate_row_width(hid: int) -> int:
    """Row width of the saved gate cotangents: 4 H rounded up to 8 values,
    so every row starts 16-byte aligned (the wgrad's TMA rows)."""
    return -(-4 * hid // 8) * 8


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
    fn = _build.kernel_fn("avr_lstm_march", _FWD_ARGS)
    err = fn(*(_build.ptr(a[k]) for k in ("proj", "coords0", "rds", "feat", "w_ih", "w_hh",
                                          "bias", "w_out", "b_out")), _build.ptr(out),
             _build.ptr(aux) if save else None, SB, R, NS, H, W, C, hid, steps, float(eps),
             _DTYPES[cd], ctypes.c_void_p(_build.stream_ptr(dev)))
    _build.check(NAME, err)
    return out, aux


class _March(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coords0, rds, feat, w_ih, w_hh, bias, w_out, b_out, a, steps, eps,
                grad_clamp, cd):
        out, aux = _forward(a, steps, eps, cd, save=True)
        ctx.a, ctx.aux, ctx.cfg = a, aux, (steps, eps, grad_clamp, cd)
        ctx.dtypes = [t.dtype for t in (coords0, rds, feat, w_ih, w_hh, bias, w_out, b_out)]
        ctx.shapes = [t.shape for t in (w_out, b_out)]
        return out

    @staticmethod
    def backward(ctx, g):
        a, aux = ctx.a, ctx.aux
        steps, eps, grad_clamp, cd = ctx.cfg
        SB, NS, H, W, C = a["feat"].shape
        R = a["coords0"].shape[1]
        hid = a["w_hh"].shape[0]
        dev = g.device
        g = g.float().contiguous()
        _build.check_cuda_inputs(NAME_BWD, {"g": g}, dev)
        f32 = dict(dtype=torch.float32, device=dev)
        dcoords0 = torch.zeros((SB, R, 3), **f32)
        drds = torch.zeros((SB, R, 3), **f32)
        dfeat = torch.zeros((SB, NS, H, W, C), **f32)
        dw_ih = torch.zeros((C, 4 * hid), **f32)
        # per ray and step: v_t and the rounded gate cotangents, zero where a
        # ray was frozen; dW_ih = sum of v_t (x) dgates is one GEMM after
        vbuf = torch.zeros((SB * R, steps, C), dtype=cd, device=dev)
        dg_ld = gate_row_width(hid)
        dgbuf = torch.zeros((SB * R, steps, dg_ld), dtype=cd, device=dev)
        dw_hh = torch.zeros((hid, 4 * hid), **f32)
        dbias = torch.zeros((4 * hid,), **f32)
        dw_out = torch.zeros((hid,), **f32)
        db_out = torch.zeros((1,), **f32)
        if SB * R:
            fn = _build.kernel_fn("avr_lstm_march_bwd", _BWD_ARGS)
            err = fn(*(_build.ptr(t) for t in (
                a["proj"], a["rds"], a["feat"], a["w_ih"].t().contiguous(), a["w_hh"],
                a["w_out"], aux, g, dcoords0, drds, dfeat, vbuf, dgbuf, dw_hh, dbias, dw_out,
                db_out)),
                SB, R, NS, H, W, C, hid, steps, dg_ld, float(eps), float(grad_clamp), _DTYPES[cd],
                ctypes.c_void_p(_build.stream_ptr(dev)))
            _build.check(NAME_BWD, err)
            rows = SB * R * steps
            wgrad(NAME_WGRAD, [(vbuf.data_ptr(), dgbuf.data_ptr(), dw_ih, None, rows, C,
                                dg_ld, C, 4 * hid)], cd, dev)
        grads = (dcoords0, drds, dfeat, dw_ih, dw_hh, dbias, dw_out.reshape(ctx.shapes[0]),
                 db_out.reshape(ctx.shapes[1]))
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
    kernel (the latent must already be in the compute dtype, as the encoder
    stores it), and under autograd its backward kernel."""
    if feat.device.type == "cpu":
        return lstm_march_plain(proj, coords0, rds, feat, w_ih, w_hh, bias, w_out, b_out,
                                steps=steps, early_stop_eps=early_stop_eps,
                                grad_clamp=grad_clamp, compute_dtype=compute_dtype)
    SB, NS, H, W, C = feat.shape
    R = coords0.shape[1]
    hid = w_hh.shape[0]
    if compute_dtype not in _DTYPES or feat.dtype != compute_dtype:
        raise TypeError(f"{NAME}: latent dtype {feat.dtype} must be the compute dtype "
                        f"{compute_dtype}, one of {list(_DTYPES)}")
    if not 0 < hid <= MAX_HIDDEN or w_ih.shape != (C, 4 * hid):
        raise ValueError(f"{NAME}: kernel needs hidden <= {MAX_HIDDEN} and w_ih (C, 4H), "
                         f"got w_hh {tuple(w_hh.shape)} w_ih {tuple(w_ih.shape)}")
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
    grad_args = (coords0, rds, feat, w_ih, w_hh, bias, w_out, b_out)
    if torch.is_grad_enabled() and any(t.requires_grad for t in grad_args):
        return _March.apply(*grad_args, a, steps, early_stop_eps, grad_clamp, compute_dtype)
    return _forward(a, steps, early_stop_eps, compute_dtype, save=False)[0]
