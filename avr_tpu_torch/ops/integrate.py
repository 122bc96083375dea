"""Alpha-composited volume integration with its closed-form adjoint (port
of ``avr_tpu/ops/integrate.py``).

Every constant is the JAX package's: ``1e10`` delta tail, ``alpha = 1 -
exp(-sigma * delta)``, transmittance the shifted cumulative product of
``1 - alpha + 1e-10``, the distance map against shifted z-values whose tail
is ``infinity``, white background ``+ (1 - sum(weights))``.  Plain PyTorch:
the default path computes it outside any kernel in both packages
(``avr_tpu/models/wrapper.py:61``, ``fused_integral="never"``).

The backward is the JAX package's closed form (``integrate.py:84-152``):
with ``G_i`` the cotangent collected by weight ``i``, ``dL/dalpha_k = G_k
T_k - S_k / u_k`` where ``S_k`` is the exclusive suffix sum of ``G_i w_i``
and ``u_k = 1 - alpha_k + eps`` is computed as ``exp(-sigma_k delta_k) +
eps``, never by subtracting: at a saturated lane ``1 - alpha`` is 0 and the
subtraction form gives 0/0.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["volume_integral"]

_EPS = 1e-10


def _integrate(z_vals, sigmas, radiances, white_back, infinity):
    dists = torch.cat(
        [z_vals[..., 1:] - z_vals[..., :-1], torch.full_like(z_vals[..., :1], 1e10)],
        dim=-1,
    )
    expn = torch.exp(-sigmas * dists[..., None])  # 1 - alpha
    alpha = 1.0 - expn
    trans = torch.cumprod(1.0 - alpha + _EPS, dim=-2)
    trans = torch.cat([torch.ones_like(alpha[..., :1, :]), trans[..., :-1, :]], dim=-2)
    weights = alpha * trans
    rgb = torch.sum(weights * radiances, dim=-2)
    zz = torch.cat([z_vals[..., 1:], torch.full_like(z_vals[..., :1], infinity)], dim=-1)
    distance = torch.sum(weights * zz[..., None], dim=-2)
    if white_back:
        rgb = rgb + (1.0 - torch.sum(weights, dim=-2))
    return rgb, distance, weights, (dists, zz, expn, trans)


class _VolumeIntegral(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z_vals, sigmas, radiances, white_back, infinity):
        rgb, distance, weights, (dists, zz, expn, trans) = _integrate(
            z_vals, sigmas, radiances, white_back, infinity)
        ctx.white_back = white_back
        ctx.save_for_backward(sigmas, radiances, dists, zz, expn, trans, weights)
        return rgb, distance, weights

    @staticmethod
    def backward(ctx, g_rgb, g_dist, g_w):
        sigmas, radiances, dists, zz, expn, trans, weights = ctx.saved_tensors
        # G_i = dL/dw_i, every use of the weights downstream
        G = torch.sum(radiances * g_rgb[..., None, :], dim=-1, keepdim=True)
        if ctx.white_back:
            G = G - torch.sum(g_rgb, dim=-1, keepdim=True)[..., None, :]
        G = G + g_dist[..., None, :] * zz[..., None] + g_w
        GW = G * weights
        suffix = torch.flip(torch.cumsum(torch.flip(GW, dims=(-2,)), dim=-2), dims=(-2,)) - GW
        dalpha = G * trans - suffix / (expn + _EPS)
        d_sigma = dalpha * expn * dists[..., None]
        dd = (dalpha * expn * sigmas)[..., 0]  # w.r.t. dists; the 1e10 tail is constant
        fwd_diff = dd[..., :-1]
        gw = (g_dist[..., None, :] * weights)[..., :-1, 0]
        zero = torch.zeros_like(dd[..., :1])
        d_z = torch.cat([-fwd_diff, zero], dim=-1) + torch.cat([zero, fwd_diff + gw], dim=-1)
        d_rad = weights * g_rgb[..., None, :]
        return d_z, d_sigma, d_rad, None, None


def volume_integral(
    z_vals: torch.Tensor,  # (SB, R, n)
    sigmas: torch.Tensor,  # (SB, R, n, 1)
    radiances: torch.Tensor,  # (SB, R, n, 3)
    white_back: bool = True,
    infinity: float = 1.8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``rgb (SB, R, 3)``, ``distance (SB, R, 1)``, ``weights (SB, R, n, 1)``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (z_vals, sigmas, radiances)):
        return _VolumeIntegral.apply(z_vals, sigmas, radiances, white_back, infinity)
    return _integrate(z_vals, sigmas, radiances, white_back, infinity)[:3]
