"""K1: bilinear latent gather — CUDA kernel wrapper and its plain version.

Replaces ``avr_tpu/ops/pallas/gather.py:395 gather_bilinear_windowed``
(forward).  Semantics are ``avr_tpu/ops/grid_sample.py`` exactly, i.e.
``F.grid_sample(align_corners=True, padding_mode="border")`` on NHWC maps:
``x = clip((gx + 1) / 2 * (W - 1), 0, W - 1)``, ``x0 = floor(x)``,
``x1 = min(x0 + 1, W - 1)`` (same for y), weights ``(1-wy)(1-wx), (1-wy)wx,
wy(1-wx), wy*wx``, blended in float32, output in the map's dtype.

What bounds it on Hopper: bytes.  At the band shape (N = 81,920 points,
C = 512, bf16) the output alone is 84 MB against a 4.2 MB latent, about
26 us at 3.35 TB/s.  The TPU kernel's one-hot MXU selectors and row windows
work around the TPU's lack of a fast random gather; on Hopper a tap is a
plain load, and the 4 MB latent stays in the 50 MB L2.  So the kernel is
direct 4-tap loads, one thread per (point, 16-byte channel group), with
neighbouring threads on neighbouring channels of the same tap.  The
TPU path sorts rays by source-view row to make its windows coherent
(``models/wrapper.py:160-204``); per-ray results do not depend on it and
the port leaves it out.
"""

from __future__ import annotations

import ctypes

import torch

from avr_tpu_torch.ops.kernels import _build

__all__ = ["gather_bilinear", "gather_bilinear_plain", "bilinear_f32"]

NAME = "gather_bilinear"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _taps(coords: torch.Tensor, H: int, W: int):
    """Flat tap indices and weights, ``(B, N)`` each (float32 math)."""
    x = torch.clamp((coords[..., 0] + 1.0) * 0.5 * (W - 1), 0.0, W - 1)
    y = torch.clamp((coords[..., 1] + 1.0) * 0.5 * (H - 1), 0.0, H - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = torch.clamp(x0i + 1, max=W - 1)
    y1i = torch.clamp(y0i + 1, max=H - 1)
    idx = (y0i * W + x0i, y0i * W + x1i, y1i * W + x0i, y1i * W + x1i)
    w = ((1.0 - wy) * (1.0 - wx), (1.0 - wy) * wx, wy * (1.0 - wx), wy * wx)
    return idx, w


def bilinear_f32(features: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``(B, H, W, C)`` x ``(B, N, 2)`` -> ``(B, N, C)`` float32 blend
    (shared with the march's plain version, whose per-step feature stays
    float32)."""
    B, H, W, C = features.shape
    idx, w = _taps(coords.float(), H, W)
    flat = features.reshape(B, H * W, C)
    rows = torch.arange(B, device=features.device)[:, None]
    out = None
    for i, wi in zip(idx, w):
        term = flat[rows, i].float() * wi[..., None]
        out = term if out is None else out + term
    return out


def gather_bilinear_plain(features: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: output in the map's dtype."""
    return bilinear_f32(features, coords).to(features.dtype)


def gather_bilinear(features: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear-sample ``features (B, H, W, C)`` at ``coords (B, N, 2)``
    (``(x, y)`` in [-1, 1], border clamp) -> ``(B, N, C)`` in the map's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if features.device.type == "cpu":
        return gather_bilinear_plain(features, coords)
    B, H, W, C = features.shape
    N = coords.shape[1]
    if features.dtype not in _DTYPES:
        raise TypeError(f"{NAME}: features dtype {features.dtype} not in {list(_DTYPES)}")
    if coords.dtype != torch.float32 or coords.shape != (B, N, 2):
        raise ValueError(f"{NAME}: coords must be float32 (B, N, 2), got "
                         f"{coords.dtype} {tuple(coords.shape)}")
    vec = 16 // features.element_size()
    if C % vec:
        raise ValueError(f"{NAME}: channels {C} must be a multiple of {vec}")
    _build.check_cuda_inputs(NAME, "the VJP of gather_bilinear_windowed, gather.py:447",
                             {"features": features, "coords": coords}, features.device)
    out = torch.empty((B, N, C), dtype=features.dtype, device=features.device)
    if N == 0:
        return out
    fn = _build.kernel_fn("avr_gather_bilinear", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                          + [ctypes.c_void_p])
    err = fn(_build.ptr(features), _build.ptr(coords), _build.ptr(out), B, H, W, C, N,
             _DTYPES[features.dtype], ctypes.c_void_p(_build.stream_ptr(features.device)))
    _build.check(NAME, err)
    return out
