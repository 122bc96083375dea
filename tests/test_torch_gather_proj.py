"""Port parity: the K5 projected gather and the K6 full-map gather against
``avr_tpu``.

K5: the same numpy inputs through JAX ``gather_bilinear_projected`` (the
Pallas kernel in interpret mode) and through the port's wrapper on CPU
tensors (its plain version: ``project_packed`` then the K1 blend), on the
geometry of ``tests/test_pallas_gather.py``'s projected case: two views
with nearly-identity rotations 1.2 in front of the points, focal 20 on a
16 x 16 map.  Tolerances are that test's: forward 2e-5 (float32, the same
operations; XLA may round the projection's products differently), dfeat
5e-5, dpoints 3e-3 (it passes through ``-xy / z * f``, whose float32
rounding scales with the focal).  The camera gets no gradient.

K6 (``gather_bilinear``, the full-map kernel K1's windows cut down) is the
port's K1 function: the port's ``gather_bilinear`` against JAX's, forward
and VJP, 1e-5 of each array's largest value (float32, the same formula and
the same strict border mask; the coordinate cotangent is a difference of
per-tap dots of C products summed in another order, times (W - 1) / 2), at
``tests/test_torch_gather.py``'s coordinates, which put points exactly on
the border and the corners.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu.ops.pallas.gather import gather_bilinear as pallas_gather
from avr_tpu.ops.pallas.gather import gather_bilinear_projected as pallas_projected
from avr_tpu.ops.pallas.march import pack_projection as jax_pack_projection
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.ops.kernels.gather import (gather_bilinear, gather_bilinear_plain,
                                              gather_bilinear_projected, project_packed)
from avr_tpu_torch.ops.kernels.march import pack_projection
from tests.test_torch_gather import _case as k1_case

torch.set_num_threads(2)


def _ray_points(rng, rays_side, samples, band):
    """World points along a camera's rays, ray after ray as the renderers
    give them, the camera not a source view: ``band`` samples 20 depths over
    +-0.15 about each ray's crossing of the z = 0 plane (the adaptive band),
    else 64 stratified depths over that crossing +-0.6 (the VR coarse
    pass)."""
    origin = np.array([0.35, -0.25, -1.6])
    u = np.linspace(-0.35, 0.35, rays_side)
    target = np.stack(np.meshgrid(u, u, indexing="xy"), -1).reshape(-1, 2)
    target = target + rng.uniform(-0.02, 0.02, target.shape)
    target = np.concatenate([target, np.zeros((len(target), 1))], 1)
    d = target - origin
    dist = np.linalg.norm(d, axis=1, keepdims=True)
    d = d / dist
    half = 0.15 if band else 0.6
    s = (np.arange(samples) + rng.uniform(0, 1, (len(d), samples))) / samples
    t = dist + (2 * s - 1) * half
    return (origin + t[..., None] * d[:, None]).reshape(-1, 3)


def _proj_case(seed=0, B=2, H=16, W=16, C=64, N=300, rays=None):
    """``rays=(band, samples)``: the points are ``_ray_points`` of 6 x 6
    rays a view (N = 36 x samples), not normal draws."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, H, W, C)).astype(np.float32)
    poses = []
    for b in range(B):
        Q, _ = np.linalg.qr(np.eye(3) + 0.1 * rng.normal(size=(3, 3)))
        t = np.array([0.05, -0.03, 1.2 + 0.1 * b])
        poses.append(np.concatenate([Q, t[:, None]], 1))
    poses = np.stack(poses).astype(np.float32)
    focal = np.asarray([[20.0, -20.0]] * B, np.float32)
    c = np.asarray([[8.0, 8.0]] * B, np.float32)
    scale = np.asarray([2.0 * W / (W - 1), 2.0 * H / (H - 1)], np.float32)
    img = np.asarray([float(W), float(H)], np.float32)
    if rays is None:
        pts = (0.4 * rng.normal(size=(B, N, 3))).astype(np.float32)
    else:
        pts = np.stack([_ray_points(rng, 6, rays[1], rays[0]) for _ in range(B)])
        pts = pts.astype(np.float32)
        N = pts.shape[1]
    g = rng.normal(size=(B, N, C)).astype(np.float32)
    return feats, poses, focal, c, scale, img, pts, g


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("seed,shape", [
    (0, dict()), (1, dict(B=1, N=7)), (2, dict(B=3, H=20, W=12, C=16, N=500)),
    # ray-ordered points, as the tiled forward is timed: the adaptive band
    # and the VR coarse pass's stratified samples
    (20, dict(C=16, rays=(True, 20))), (21, dict(C=16, rays=(False, 64)))])
def test_projected_gather_matches_pallas(seed, shape):
    feats, poses, focal, c, scale, img, pts, g = _proj_case(seed, **shape)
    jproj = jax_pack_projection(*(jnp.asarray(a) for a in (poses, focal, c, scale, img)))
    if "rays" in shape:
        grid = np.asarray(project_packed(pack_projection(
            *(_t(a) for a in (poses, focal, c, scale, img))), _t(pts)))
        inside = (np.abs(grid) < 1).all(-1).mean()
        assert inside > 0.8, f"the rays should project onto the map ({inside:.2f} inside)"
        # ray order: a ray's consecutive samples project to neighbouring pixels
        samples = shape["rays"][1]
        step = np.abs(np.diff(grid.reshape(len(grid), -1, samples, 2), axis=2)).max() * 7.5
        assert step < 1.0, f"consecutive samples move {step:.2f} pixels"
    f = lambda ff, pp: pallas_projected(ff, pp, jproj, True)
    want, vjp = jax.vjp(f, jnp.asarray(feats), jnp.asarray(pts))
    want_df, want_dp = (np.asarray(a) for a in vjp(jnp.asarray(g)))

    proj = pack_projection(*(_t(a) for a in (poses, focal, c, scale, img)))
    np.testing.assert_allclose(proj.numpy(), np.asarray(jproj), rtol=0, atol=1e-6)
    ft, pt = _t(feats).requires_grad_(True), _t(pts).requires_grad_(True)
    proj.requires_grad_(True)
    got = gather_bilinear_projected(ft, pt, proj)
    df, dp, dproj = torch.autograd.grad(got, (ft, pt, proj), _t(g), allow_unused=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(df.numpy(), want_df, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(dp.numpy(), want_dp, rtol=3e-3, atol=3e-3)
    assert dproj is None, "the packed projection must get no gradient"


def test_projected_gather_is_k1_at_the_packed_grid():
    """The plain version is the K1 function at ``project_packed``'s grid,
    bit for bit, for a bf16 map too (the output rounds to the map's dtype)."""
    feats, poses, focal, c, scale, img, pts, _ = _proj_case(3)
    proj = pack_projection(*(_t(a) for a in (poses, focal, c, scale, img)))
    for dtype in (torch.float32, torch.bfloat16):
        f = _t(feats).to(dtype)
        got = gather_bilinear_projected(f, _t(pts), proj)
        want = gather_bilinear_plain(f, project_packed(proj, _t(pts)))
        assert got.dtype == dtype
        assert torch.equal(got, want)


def test_project_packed_matches_the_camera_chain():
    """``project_packed`` is ``-(R x + t)_xy / z * focal + c`` on the latent
    grid, as ``tests/test_pallas_gather.py``'s reference chain computes it."""
    feats, poses, focal, c, scale, img, pts, _ = _proj_case(4)
    proj = pack_projection(*(_t(a) for a in (poses, focal, c, scale, img)))
    cam = np.einsum("bij,bnj->bni", poses[:, :, :3].astype(np.float64), pts) + poses[:, None, :, 3]
    uv = -cam[..., :2] / cam[..., 2:3] * focal[:, None] + c[:, None]
    grid = uv * (scale / img)[None, None] - 1.0
    # float32 against float64: a few ulps of each value (points near a
    # camera's plane project far outside the map)
    np.testing.assert_allclose(project_packed(proj, _t(pts)).numpy(), grid, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("seed,shape", [(0, dict()), (1, dict(B=1, H=64, W=64, C=32, N=1000)),
                                        (2, dict(N=7))])
def test_full_map_gather_k6_matches_pallas(seed, shape):
    feats, coords = k1_case(seed, **shape)
    g = np.random.default_rng(seed + 10).normal(size=coords.shape[:2] + feats.shape[-1:])
    g = g.astype(np.float32)
    f = lambda ff, cc: pallas_gather(ff, cc, True)
    want, vjp = jax.vjp(f, jnp.asarray(feats), jnp.asarray(coords))
    want_df, want_dc = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    ft, ct = _t(feats).requires_grad_(True), _t(coords).requires_grad_(True)
    got = gather_bilinear(ft, ct)
    df, dc = torch.autograd.grad(got, (ft, ct), _t(g))
    for a, b in ((got.detach(), want), (df, want_df), (dc, want_dc)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * max(1.0, np.abs(b).max()))


def test_projected_wrapper_check_and_cpu_launches():
    """CPU tensors take the plain version and launch nothing; the kernel's
    own check refuses CPU tensors, a wrong points shape and a non-float32
    camera."""
    from avr_tpu_torch.ops.kernels import gather as K

    feats, poses, focal, c, scale, img, pts, _ = _proj_case(5)
    proj = pack_projection(*(_t(a) for a in (poses, focal, c, scale, img)))
    _build.reset_launches()
    gather_bilinear_projected(_t(feats), _t(pts), proj)
    assert not _build.launches
    with pytest.raises(ValueError, match="CUDA"):
        K._check_projected(_t(feats), _t(pts), proj)
    with pytest.raises(ValueError, match="points"):
        K._check_projected(_t(feats), _t(pts)[..., :2], proj)
    with pytest.raises(ValueError, match="proj"):
        K._check_projected(_t(feats), _t(pts), proj.double())
