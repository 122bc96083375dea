"""K4: fused band compositing — CUDA kernels (forward and backward), the
autograd function that joins them, and the plain version.

Replaces ``avr_tpu/ops/pallas/integrate.py:302 fused_volume_integral``: the
forward (``_run_fwd``, call ``:244``) and its VJP (``bwd``, call ``:276``).
The adaptive renderer's band integral (:mod:`avr_tpu_torch.ops.integrate`
semantics, colour and distance only) over the decoder's point-major rows:
sample ``k`` of ray ``r`` at row ``r * n + k`` of ``field_out (SB, R * n,
4)``, consumed with no relayout.  The autograd function saves only ``z``
and ``field_out``; the backward kernel recomputes the rest, as the TPU
kernel's does.

What bounds it on Hopper: bytes, and at these sizes launch latency (train
step's band call, 4 x 4,096 rays x 20 samples: ~6.8 MB forward, ~2.0 us at
3.35 TB/s; ~13.4 MB backward, ~4.0 us).  One warp per ray, walking the
band in groups of 32 samples (lane ``k`` of group ``j`` holding sample ``32 j
+ k``), so a ray takes any number of samples (the adaptive renderer's band
has 20, the quality series' 2x epsilon sweep 40); the shifts, the
transmittance's prefix product and the sums are warp shuffles, the
transmittance and the sums carried from group to group, forward and
backward (``csrc/integrate.cu``).
"""

from __future__ import annotations

import ctypes

import torch

from avr_tpu_torch.ops.integrate import volume_integral
from avr_tpu_torch.ops.kernels import _build

__all__ = ["fused_volume_integral", "fused_volume_integral_plain"]

NAME = "fused_volume_integral"
NAME_BWD = "fused_volume_integral_bwd"


def fused_volume_integral_plain(z_vals: torch.Tensor, field_out: torch.Tensor,
                                white_back: bool = True, infinity: float = 1.8):
    """The kernels' function in plain PyTorch: the port's volume integral
    (its closed-form adjoint under autograd) on the rows folded to ``(SB, R,
    n, 4)``."""
    SB, R, n = z_vals.shape
    fo = field_out.reshape(SB, R, n, 4)
    rgb, distance, _ = volume_integral(z_vals, fo[..., 3:4], fo[..., :3], white_back, infinity)
    return rgb, distance


def _check(z_vals: torch.Tensor, field_out: torch.Tensor) -> None:
    if z_vals.ndim != 3:
        raise ValueError(f"{NAME}: z_vals must be (SB, R, n), got {tuple(z_vals.shape)}")
    SB, R, n = z_vals.shape
    if n < 1:
        raise ValueError(f"{NAME}: the kernel takes at least one sample a ray, got {n}")
    if field_out.shape != (SB, R * n, 4):
        raise ValueError(f"{NAME}: field_out must be (SB, R * n, 4) = {(SB, R * n, 4)}, got "
                         f"{tuple(field_out.shape)}")
    if z_vals.dtype != torch.float32 or field_out.dtype != torch.float32:
        raise TypeError(f"{NAME}: z_vals and field_out must be float32, got {z_vals.dtype} "
                        f"and {field_out.dtype}")
    _build.check_cuda_inputs(NAME, {"z_vals": z_vals, "field_out": field_out}, field_out.device)


def _forward(z, fo, white_back, infinity):
    SB, R, n = z.shape
    rgb = torch.empty((SB, R, 3), dtype=torch.float32, device=fo.device)
    dist = torch.empty((SB, R, 1), dtype=torch.float32, device=fo.device)
    if SB * R == 0:
        return rgb, dist
    fn = _build.kernel_fn("avr_volume_integral", [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    err = fn(_build.ptr(z), _build.ptr(fo), _build.ptr(rgb), _build.ptr(dist), SB * R, n,
             int(white_back), float(infinity), ctypes.c_void_p(_build.stream_ptr(fo.device)))
    _build.check(NAME, err)
    return rgb, dist


def _backward(z, fo, g_rgb, g_dist, white_back, infinity):
    SB, R, n = z.shape
    g_rgb = g_rgb.float().contiguous()
    g_dist = g_dist.float().contiguous()
    _build.check_cuda_inputs(NAME_BWD, {"g_rgb": g_rgb, "g_dist": g_dist}, fo.device)
    dz = torch.empty_like(z)
    dfo = torch.empty_like(fo)
    if SB * R:
        fn = _build.kernel_fn("avr_volume_integral_bwd", [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        err = fn(_build.ptr(z), _build.ptr(fo), _build.ptr(g_rgb), _build.ptr(g_dist),
                 _build.ptr(dz), _build.ptr(dfo), SB * R, n, int(white_back), float(infinity),
                 ctypes.c_void_p(_build.stream_ptr(fo.device)))
        _build.check(NAME_BWD, err)
    return dz, dfo


class _Integral(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z_vals, field_out, white_back, infinity):
        ctx.save_for_backward(z_vals, field_out)
        ctx.cfg = (white_back, infinity)
        return _forward(z_vals, field_out, white_back, infinity)

    @staticmethod
    def backward(ctx, g_rgb, g_dist):
        z_vals, field_out = ctx.saved_tensors
        dz, dfo = _backward(z_vals, field_out, g_rgb, g_dist, *ctx.cfg)
        return dz, dfo, None, None


def fused_volume_integral(z_vals: torch.Tensor,  # (SB, R, n) ascending band depths
                          field_out: torch.Tensor,  # (SB, R * n, 4) activated (rgb, sigma)
                          white_back: bool = True, infinity: float = 1.8):
    """Composite each ray's band -> ``(rgb (SB, R, 3), distance (SB, R, 1))``
    float32.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (float32, contiguous, or it raises), and under
    autograd its backward kernel."""
    if field_out.device.type == "cpu":
        return fused_volume_integral_plain(z_vals, field_out, white_back, infinity)
    _check(z_vals, field_out)
    if torch.is_grad_enabled() and (z_vals.requires_grad or field_out.requires_grad):
        return _Integral.apply(z_vals, field_out, bool(white_back), float(infinity))
    return _forward(z_vals, field_out, bool(white_back), float(infinity))
