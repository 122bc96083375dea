"""K3: fused LSTM ray-march (forward) — CUDA kernel wrapper, its plain
version and ``pack_projection``.

Replaces ``avr_tpu/ops/pallas/march.py:703 fused_lstm_march`` (forward,
``:556``).  The whole march per ray: for ``steps`` steps, project the point
into each source view with the packed scalars, gather the bilinear latent
(float32 blend) and mean it over the views, run the LSTM cell (gate order
i, f, g, o; ``gates = v @ W_ih + h @ W_hh + b``), take the signed step
``s = h @ w_out + b_out`` along the ray; with ``early_stop_eps > 0`` rays
whose ``|s|`` falls below the threshold freeze.  Matmul operands (weights,
biases, ``v`` and ``h``) are rounded to the compute dtype; the carries
``h``, ``c`` and the coordinates stay float32.

What bounds it on Hopper: neither peak.  At the slice's shape (4,096 rays x
10 steps, C = 512) the work is ~2.9 GFLOP (~3 us at the bf16 peak) and
~4.3 MB of compulsory traffic (~1.3 us); the time goes to the 10 dependent
steps.  The kernel runs one warp per ray, eight rays per CTA: ``W_ih``
(512 x 64) sits in shared memory shared by the CTA's rays, each step's 4-tap
gather is read from L2 and blended in registers, and the carries stay in
registers for all steps.  Nothing per step is written to device memory
(the TPU kernel's per-step stash serves its backward, a later slice).  A
frozen ray stops early: its coordinates can no longer change.  The TPU
kernel's ray sort (``models/wrapper.py:256-280``) only feeds its windowed
gather; the port leaves it out.
"""

from __future__ import annotations

import ctypes

import torch

from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.ops.kernels.gather import bilinear_f32

__all__ = ["pack_projection", "fused_lstm_march", "lstm_march_plain"]

NAME = "fused_lstm_march"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HIDDEN = 32


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


def _project(p: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``p (SB, 16)``, ``coords (SB, R, 3)`` -> grid coords ``(SB, R, 2)``."""
    cx, cy, cz = coords.unbind(-1)
    q = lambda k: p[:, k:k + 1]
    camx = q(0) * cx + q(1) * cy + q(2) * cz + q(9)
    camy = q(3) * cx + q(4) * cy + q(5) * cz + q(10)
    camz = q(6) * cx + q(7) * cy + q(8) * cz + q(11)
    gx = -(camx / camz) * q(12) + q(14)
    gy = -(camy / camz) * q(13) + q(15)
    return torch.stack([gx, gy], dim=-1)


def lstm_march_plain(proj, coords0, rds, feat, w_ih, w_hh, bias, w_out, b_out, *,
                     steps: int, early_stop_eps: float = 0.0,
                     compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch (argument layout as
    :func:`fused_lstm_march`)."""
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
            g = bilinear_f32(feat[:, view], _project(proj[:, view], coords))
            v = g if v is None else v + g
        if NS > 1:
            v = v * (1.0 / NS)
        gates = c(v) @ w_ih + c(h) @ w_hh + bias
        i, f, g, o = gates.split(hid, dim=-1)
        cc = torch.sigmoid(f) * cc + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(cc)
        s = c(h) @ w_out + b_out
        if early_stop_eps > 0.0:
            s = s * active
            active = active * (1.0 - (torch.abs(s) < early_stop_eps).float())
        coords = coords + rds * s
    return coords


def fused_lstm_march(proj: torch.Tensor,  # (SB, NS, 16) packed projections
                     coords0: torch.Tensor,  # (SB, R, 3) initial world points
                     rds: torch.Tensor,  # (SB, R, 3) unit ray directions
                     feat: torch.Tensor,  # (SB, NS, H, W, C) latents
                     w_ih: torch.Tensor,  # (C, 4H)
                     w_hh: torch.Tensor,  # (H, 4H)
                     bias: torch.Tensor,  # (4H,) b_ih + b_hh
                     w_out: torch.Tensor,  # (H, 1)
                     b_out: torch.Tensor,  # (1,)
                     *, steps: int, early_stop_eps: float = 0.0,
                     compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """March every ray ``steps`` times; returns final world points ``(SB, R, 3)``
    float32.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (the latent must already be in the compute dtype, as the encoder
    stores it)."""
    kw = dict(steps=steps, early_stop_eps=early_stop_eps, compute_dtype=compute_dtype)
    if feat.device.type == "cpu":
        return lstm_march_plain(proj, coords0, rds, feat, w_ih, w_hh, bias, w_out,
                                b_out, **kw)
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
    cd = lambda t: t.to(compute_dtype).contiguous()
    f32 = lambda t: t.to(compute_dtype).float().contiguous()
    args = dict(proj=proj.float().contiguous(), coords0=coords0.float().contiguous(),
                rds=rds.float().contiguous(), feat=feat, w_ih=cd(w_ih), w_hh=cd(w_hh),
                bias=f32(bias), w_out=f32(w_out.reshape(hid)), b_out=f32(b_out.reshape(1)))
    _build.check_cuda_inputs(NAME, "the march backward, march.py:621", args, feat.device)
    out = torch.empty((SB, R, 3), dtype=torch.float32, device=feat.device)
    if SB * R == 0:
        return out
    fn = _build.kernel_fn("avr_lstm_march", [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                          + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    a = args
    err = fn(*(_build.ptr(a[k]) for k in ("proj", "coords0", "rds", "feat", "w_ih", "w_hh",
                                          "bias", "w_out", "b_out")), _build.ptr(out),
             SB, R, NS, H, W, C, hid, steps, float(early_stop_eps), _DTYPES[compute_dtype],
             ctypes.c_void_p(_build.stream_ptr(feat.device)))
    _build.check(NAME, err)
    return out
