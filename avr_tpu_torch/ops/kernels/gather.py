"""K1: bilinear latent gather, and K5: the same gather at the projection of
world points — CUDA kernels (forward and backward), the autograd functions
that join them, the plain versions, and the packed projection
(:func:`project_packed`) that K3's and K5's plain versions share.

K1 replaces ``avr_tpu/ops/pallas/gather.py:395 gather_bilinear_windowed``
(forward, ``:415``) and its VJP ``_wbwd`` (``:447``, call ``:463``), and
with them ``gather.py:164 gather_bilinear`` (VJP ``_bwd`` ``:207``), the
same function on the full map.
Semantics are ``avr_tpu/ops/grid_sample.py`` exactly, i.e.
``F.grid_sample(align_corners=True, padding_mode="border")`` on NHWC maps:
``x = clip((gx + 1) / 2 * (W - 1), 0, W - 1)``, ``x0 = floor(x)``,
``x1 = min(x0 + 1, W - 1)`` (same for y), weights ``(1-wy)(1-wx), (1-wy)wx,
wy(1-wx), wy*wx``, blended in float32, output in the map's dtype.

The backward is the TPU kernel's: ``dfeat = sum over taps of w * g`` with
``w`` and ``g`` rounded to the map's dtype and float32 sums, cast to the
map's dtype at the end; ``dcoords`` from the per-tap dots ``<g, f_tap>``,
the weights' derivatives and a **strict** live mask ``0 < x_un < W - 1``
on the unclamped coordinate (``gather.py:142-148``): a point on or beyond
the border gets no coordinate gradient (``torch.clamp``'s own gradient
would pass at the border itself).

What bounds it on Hopper: bytes.  Forward at the band shape (N = 81,920,
C = 512, bf16): 84 MB of output against a 4.2 MB latent, ~26 us at
3.35 TB/s; the TPU kernel's one-hot MXU selectors and row windows work
around the TPU's lack of a fast random gather, while on Hopper a tap is a
plain load and the latent stays in the 50 MB L2.  Forward: direct 4-tap
loads, one thread per (point, 16-byte channel group).  Backward (the
function's own bytes, ~0.11 ms at 4 x 81,920 points in bf16): one warp per
point computes the coordinate cotangent from the four dots; ``dfeat`` is
binned and owner-computed (``csrc/gather.cu``'s source note): a stable
counting sort lists each point in the 8 x 8 map tiles its taps touch, and
one CTA per (tile, 128 channels, chunk of its bin) sums ``w * g`` on the
chip in bin order (bf16: a one-hot product on the tensor cores; float32:
a shared-memory tile), so no float atomic touches the map and ``dfeat``
is bit for bit the same launch to launch.  The wrapper allocates
``dfeat`` in the map's dtype and the sort's scratch (:func:`bin_workspace`)
with ``torch.empty``; nothing is copied to the host.  The TPU path's ray
sort (``models/wrapper.py:160-204``) only feeds its windows; the port has
none.

K5 replaces ``gather.py:642 gather_bilinear_projected`` (forward, ``:669``)
and its VJP ``_pbwd`` (``:699``, call ``:712``): world points ``(B, N, 3)``
and each view's packed projection ``(B, 16)`` in, the grid computed in the
kernel in :func:`project_packed`'s order (each operation rounded on its
own, so the grid, and with it the forward, equals the plain version's bit
for bit), then K1's gather.  The backward is K1's, chained on through the
projection to the points; ``proj`` gets no gradient (cameras are
conditioning, as JAX's zero cotangent says, ``gather.py:745``).  Bound:
K1's bytes plus 12 B a point of points (and of their cotangent).
"""

from __future__ import annotations

import ctypes

import torch

from avr_tpu_torch.ops.kernels import _build

__all__ = ["gather_bilinear", "gather_bilinear_plain", "bilinear_f32", "clamp_strict",
           "project_packed", "gather_bilinear_projected", "gather_bilinear_projected_plain",
           "bin_workspace"]

NAME = "gather_bilinear"
NAME_BWD = "gather_bilinear_bwd"
NAME_PROJ = "gather_bilinear_projected"
NAME_PROJ_BWD = "gather_bilinear_projected_bwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the binned backward's constants (csrc/gather.cu): map tile side, points a
# sort block, partial tiles of split bins; the sort keeps a per-warp count
# of every tile of a view in 48 KB of shared memory, hence MAX_TILES
TILE, SEG, PARTIAL_CHUNKS = 8, 256, 128
MAX_TILES = 1024


def clamp_strict(u: torch.Tensor, hi: float) -> torch.Tensor:
    """``clamp(u, 0, hi)`` whose gradient passes only strictly inside
    ``(0, hi)``, the live mask of the TPU kernels' backward."""
    inside = (u > 0) & (u < hi)
    return torch.where(inside, u, u.detach().clamp(0.0, hi))


def project_packed(p: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """``p (B, 16)`` packed projections (``march.pack_projection``),
    ``points (B, N, 3)`` world points -> grid coords ``(B, N, 2)``: ``cam = R
    x + t``, ``grid = -(cam_xy / cam_z) * fg + cg``, each operation on its own
    in this order (the kernels' ``project_point``, ``csrc/common.cuh``)."""
    cx, cy, cz = points.unbind(-1)
    q = lambda k: p[:, k:k + 1]
    camx = q(0) * cx + q(1) * cy + q(2) * cz + q(9)
    camy = q(3) * cx + q(4) * cy + q(5) * cz + q(10)
    camz = q(6) * cx + q(7) * cy + q(8) * cz + q(11)
    gx = -(camx / camz) * q(12) + q(14)
    gy = -(camy / camz) * q(13) + q(15)
    return torch.stack([gx, gy], dim=-1)


def _taps(coords: torch.Tensor, H: int, W: int):
    """Flat tap indices and weights, ``(B, N)`` each (float32 math)."""
    x = clamp_strict((coords[..., 0] + 1.0) * 0.5 * (W - 1), W - 1)
    y = clamp_strict((coords[..., 1] + 1.0) * 0.5 * (H - 1), H - 1)
    x0 = torch.floor(x.detach())
    y0 = torch.floor(y.detach())
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
    float32).  The map is read as float32, so its gradient sums in float32
    and is cast to the map's dtype once, as the TPU kernel's is."""
    B, H, W, C = features.shape
    idx, w = _taps(coords.float(), H, W)
    flat = features.reshape(B, H * W, C).float()
    rows = torch.arange(B, device=features.device)[:, None]
    out = None
    for i, wi in zip(idx, w):
        term = flat[rows, i] * wi[..., None]
        out = term if out is None else out + term
    return out


def gather_bilinear_plain(features: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """The kernels' function in plain PyTorch (autograd gives the backward):
    output in the map's dtype."""
    return bilinear_f32(features, coords).to(features.dtype)


def _check(features: torch.Tensor, coords: torch.Tensor) -> None:
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
    _build.check_cuda_inputs(NAME, {"features": features, "coords": coords}, features.device)


def _forward(features: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    B, H, W, C = features.shape
    N = coords.shape[1]
    out = torch.empty((B, N, C), dtype=features.dtype, device=features.device)
    if N == 0:
        return out
    fn = _build.kernel_fn("avr_gather_bilinear", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                          + [ctypes.c_void_p])
    err = fn(_build.ptr(features), _build.ptr(coords), _build.ptr(out), B, H, W, C, N,
             _DTYPES[features.dtype], ctypes.c_void_p(_build.stream_ptr(features.device)))
    _build.check(NAME, err)
    return out


def bin_workspace(B: int, H: int, W: int, C: int, N: int) -> tuple:
    """``(ints, floats)``: the binned backward's scratch (``csrc/gather.cu``
    ``launch_bins``): the per-(bin, sort block) counts, the bin sizes, the
    plan (4 ints a bin and one), at most 4 entries a point; and
    ``PARTIAL_CHUNKS`` float32 partial tiles of ``TILE^2 x C``."""
    bins = B * -(-H // TILE) * -(-W // TILE)
    return (bins * -(-N // SEG) + 5 * bins + 1 + 4 * B * N,
            PARTIAL_CHUNKS * TILE * TILE * C)


def _bin_scratch(name: str, features: torch.Tensor, N: int):
    B, H, W, C = features.shape
    if -(-H // TILE) * -(-W // TILE) > MAX_TILES or 4 * B * N >= 2 ** 31:
        raise ValueError(f"{name}: the binned backward takes at most {MAX_TILES} "
                         f"{TILE}x{TILE} tiles a map and 4 * B * N < 2^31, got map "
                         f"{H}x{W}, B * N = {B * N}")
    ints, floats = bin_workspace(B, H, W, C, N)
    return (torch.empty(ints, dtype=torch.int32, device=features.device),
            torch.empty(floats, dtype=torch.float32, device=features.device))


def _backward(features: torch.Tensor, coords: torch.Tensor, g: torch.Tensor):
    """``(dfeatures in the map's dtype, dcoords float32)`` for cotangent ``g``."""
    B, H, W, C = features.shape
    N = coords.shape[1]
    g = g.to(features.dtype).contiguous()
    _build.check_cuda_inputs(NAME_BWD, {"g": g}, features.device)
    dcoords = torch.empty((B, N, 2), dtype=torch.float32, device=features.device)
    if not N:  # no point: nothing to launch
        return torch.zeros_like(features), dcoords
    ints, partials = _bin_scratch(NAME_BWD, features, N)
    dfeat = torch.empty_like(features)
    fn = _build.kernel_fn("avr_gather_bilinear_bwd", [ctypes.c_void_p] * 7
                          + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    err = fn(_build.ptr(features), _build.ptr(coords), _build.ptr(g), _build.ptr(dfeat),
             _build.ptr(dcoords), _build.ptr(ints), _build.ptr(partials), B, H, W, C, N,
             _DTYPES[features.dtype], ctypes.c_void_p(_build.stream_ptr(features.device)))
    _build.check(NAME_BWD, err)
    return dfeat, dcoords


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, coords):
        ctx.save_for_backward(features, coords)
        return _forward(features, coords)

    @staticmethod
    def backward(ctx, g):
        features, coords = ctx.saved_tensors
        dfeat, dcoords = _backward(features, coords, g)
        return dfeat, dcoords


def gather_bilinear(features: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear-sample ``features (B, H, W, C)`` at ``coords (B, N, 2)``
    (``(x, y)`` in [-1, 1], border clamp) -> ``(B, N, C)`` in the map's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    under autograd its backward kernel (nothing is saved without a graph).
    """
    if features.device.type == "cpu":
        return gather_bilinear_plain(features, coords)
    _check(features, coords)
    if torch.is_grad_enabled() and (features.requires_grad or coords.requires_grad):
        return _Gather.apply(features, coords)
    return _forward(features, coords)


# ---------------------------------------------------------------------------
# K5: the gather at the projection of world points
# ---------------------------------------------------------------------------


def gather_bilinear_projected_plain(features: torch.Tensor, points: torch.Tensor,
                                    proj: torch.Tensor) -> torch.Tensor:
    """The K5 kernels' function in plain PyTorch: :func:`project_packed`
    (``proj`` detached: it gets no gradient) then the K1 blend, output in
    the map's dtype."""
    grid = project_packed(proj.detach().float(), points.float())
    return bilinear_f32(features, grid).to(features.dtype)


def _check_projected(features: torch.Tensor, points: torch.Tensor, proj: torch.Tensor) -> None:
    B, H, W, C = features.shape
    N = points.shape[1]
    if features.dtype not in _DTYPES:
        raise TypeError(f"{NAME_PROJ}: features dtype {features.dtype} not in {list(_DTYPES)}")
    if points.dtype != torch.float32 or points.shape != (B, N, 3):
        raise ValueError(f"{NAME_PROJ}: points must be float32 (B, N, 3), got "
                         f"{points.dtype} {tuple(points.shape)}")
    if proj.dtype != torch.float32 or proj.shape != (B, 16):
        raise ValueError(f"{NAME_PROJ}: proj must be float32 (B, 16), got "
                         f"{proj.dtype} {tuple(proj.shape)}")
    vec = 16 // features.element_size()
    if C % vec:
        raise ValueError(f"{NAME_PROJ}: channels {C} must be a multiple of {vec}")
    _build.check_cuda_inputs(NAME_PROJ, {"features": features, "points": points, "proj": proj},
                             features.device)


def _forward_projected(features, points, proj):
    B, H, W, C = features.shape
    N = points.shape[1]
    out = torch.empty((B, N, C), dtype=features.dtype, device=features.device)
    if B * N == 0:
        return out
    fn = _build.kernel_fn("avr_gather_projected", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                          + [ctypes.c_void_p])
    err = fn(_build.ptr(features), _build.ptr(points), _build.ptr(proj), _build.ptr(out), B, H,
             W, C, N, _DTYPES[features.dtype],
             ctypes.c_void_p(_build.stream_ptr(features.device)))
    _build.check(NAME_PROJ, err)
    return out


def _backward_projected(features, points, proj, g):
    """``(dfeatures in the map's dtype, dpoints float32)`` for cotangent ``g``."""
    B, H, W, C = features.shape
    N = points.shape[1]
    g = g.to(features.dtype).contiguous()
    _build.check_cuda_inputs(NAME_PROJ_BWD, {"g": g}, features.device)
    dpoints = torch.empty((B, N, 3), dtype=torch.float32, device=features.device)
    if not B * N:  # no point: nothing to launch
        return torch.zeros_like(features), dpoints
    ints, partials = _bin_scratch(NAME_PROJ_BWD, features, N)
    dfeat = torch.empty_like(features)
    fn = _build.kernel_fn("avr_gather_projected_bwd", [ctypes.c_void_p] * 8
                          + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    err = fn(_build.ptr(features), _build.ptr(points), _build.ptr(proj), _build.ptr(g),
             _build.ptr(dfeat), _build.ptr(dpoints), _build.ptr(ints), _build.ptr(partials), B,
             H, W, C, N, _DTYPES[features.dtype],
             ctypes.c_void_p(_build.stream_ptr(features.device)))
    _build.check(NAME_PROJ_BWD, err)
    return dfeat, dpoints


class _GatherProjected(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, points, proj):
        ctx.save_for_backward(features, points, proj)
        return _forward_projected(features, points, proj)

    @staticmethod
    def backward(ctx, g):
        features, points, proj = ctx.saved_tensors
        dfeat, dpoints = _backward_projected(features, points, proj, g)
        return dfeat, dpoints, None


def gather_bilinear_projected(features: torch.Tensor,  # (B, H, W, C) per-view maps
                              points: torch.Tensor,  # (B, N, 3) world points
                              proj: torch.Tensor,  # (B, 16) packed projections
                              ) -> torch.Tensor:
    """Bilinear-sample each view's map at the projection of its world
    points -> ``(B, N, C)`` in the map's dtype.  CPU tensors take the plain
    version; CUDA tensors launch the kernel, and under autograd its backward
    kernel (gradients for the map and the points, none for ``proj``)."""
    if features.device.type == "cpu":
        return gather_bilinear_projected_plain(features, points, proj)
    _check_projected(features, points, proj)
    if torch.is_grad_enabled() and (features.requires_grad or points.requires_grad):
        return _GatherProjected.apply(features, points, proj)
    return _forward_projected(features, points, proj)
