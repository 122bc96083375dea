"""Port parity: the K4 band integral against ``avr_tpu``.

Same numpy inputs through JAX ``fused_volume_integral`` (the Pallas kernel
in interpret mode) and through the port's wrapper on CPU tensors (which
takes the plain version: the port's volume integral and its closed-form
adjoint), forward and VJP (``jax.vjp`` against ``torch.autograd.grad``).
Cases: ``white_back`` on and off, the adaptive renderer's 20 samples and 7,
ray counts that are not a multiple of the Pallas kernel's 64-ray block, a
saturated lane (``exp(-sigma delta)`` is 0, so ``1 - alpha + 1e-10`` is the
floor itself) and a ray of zero density.

Tolerance 1e-5, relative to each value and absolute: float32 on both
sides; the transmittance's prefix product is associated differently (the
Pallas kernel's doubling against a sequential ``cumprod``) and the sums run
in other orders.  Where the density is 0 at a ray's last sample, its
constant ``1e10`` step makes the density's cotangent ~1e10 in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu.ops.pallas.integrate import fused_volume_integral as pallas_integral
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.ops.kernels import integrate as K4

torch.set_num_threads(2)

TOL = 1e-5


def _case(seed, SB=2, R=100, n=20, saturate=True):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.8, 1.6, size=(SB, R, 1))
    # stratified band samples: ascending by construction, as sample_coarse's
    u = (np.arange(n) + rng.uniform(size=(SB, R, n))) / n
    z = (d - 0.15 + 0.3 * u).astype(np.float32)
    fo = np.concatenate([rng.uniform(size=(SB, R * n, 3)),
                         rng.uniform(0.0, 30.0, size=(SB, R * n, 1))], -1).astype(np.float32)
    fo[:, ::5, 3] = 0.0  # relu'd densities
    if saturate:
        r = min(7, R - 1)
        fo[0, 3 * n + 4, 3] = 1e6  # ray 3, sample 4: e == 0 exactly
        fo[-1, r * n:(r + 1) * n, 3] = 0.0  # ray 7 (or the last): no density at all
    g_rgb = rng.normal(size=(SB, R, 3)).astype(np.float32)
    g_dist = rng.normal(size=(SB, R, 1)).astype(np.float32)
    return z, fo, g_rgb, g_dist


def _jax(z, fo, g_rgb, g_dist, white_back):
    f = lambda zz, ff: pallas_integral(zz, ff, white_back=white_back, interpret=True)
    (rgb, dist), vjp = jax.vjp(f, jnp.asarray(z), jnp.asarray(fo))
    dz, dfo = vjp((jnp.asarray(g_rgb), jnp.asarray(g_dist)))
    return [np.asarray(a) for a in (rgb, dist, dz, dfo)]


def _port(z, fo, g_rgb, g_dist, white_back):
    zt = torch.from_numpy(z).requires_grad_(True)
    ft = torch.from_numpy(fo).requires_grad_(True)
    rgb, dist = K4.fused_volume_integral(zt, ft, white_back=white_back)
    dz, dfo = torch.autograd.grad((rgb, dist), (zt, ft),
                                  (torch.from_numpy(g_rgb), torch.from_numpy(g_dist)))
    return [t.detach().numpy() for t in (rgb, dist, dz, dfo)]


@pytest.mark.parametrize("seed,white_back,shape", [
    (0, True, dict()),
    (1, False, dict()),
    (2, True, dict(R=70, n=7)),
    (3, False, dict(SB=1, R=5, n=20)),  # below one Pallas block
    (4, True, dict(R=64, n=20, saturate=False)),
    (7, True, dict(R=70, n=40)),  # the 2x epsilon sweep's band: two groups of 32 on the card
])
def test_forward_and_vjp_match_pallas(seed, white_back, shape):
    z, fo, g_rgb, g_dist = _case(seed, **shape)
    want = _jax(z, fo, g_rgb, g_dist, white_back)
    got = _port(z, fo, g_rgb, g_dist, white_back)
    for name, a, b in zip(("rgb", "distance", "dz", "dfo"), got, want):
        assert a.shape == b.shape, name
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=name)


def test_saturated_lane_and_empty_ray():
    """Nothing behind the saturated sample shows (its transmittance is the
    1e-10 floor), the empty ray is white background, and no cotangent is
    NaN."""
    n = 20
    z, fo, g_rgb, g_dist = _case(5)
    rgb, _, dz, dfo = _port(z, fo, g_rgb, g_dist, True)
    assert np.isfinite(dz).all() and np.isfinite(dfo).all()
    np.testing.assert_allclose(rgb[1, 7], 1.0, rtol=0, atol=1e-6)
    behind = fo.copy()
    for ray in (2, 3):  # ray 2 has no saturated sample and sees the change
        rows = slice(ray * n + 5, (ray + 1) * n)
        behind[0, rows, :3] = 1.0 - behind[0, rows, :3]
    rgb_behind = _port(z, behind, g_rgb, g_dist, True)[0]
    np.testing.assert_allclose(rgb_behind[0, 3], rgb[0, 3], rtol=0, atol=1e-7)
    assert np.abs(rgb_behind[0, 2] - rgb[0, 2]).max() > 1e-3


def test_the_wrapper_check_refuses_what_the_kernel_does_not_take():
    """An empty band, a wrong dtype and a CPU tensor all raise in the
    wrapper's own check, which runs before any CUDA launch; any number of
    samples a ray passes the shape check (the kernel walks the band in
    groups of 32), so 40 gets as far as the device check."""
    with pytest.raises(ValueError, match="at least one"):
        K4._check(torch.zeros(1, 2, 0), torch.zeros(1, 0, 4))
    with pytest.raises(ValueError, match="CUDA"):
        K4._check(torch.zeros(1, 2, 40), torch.zeros(1, 80, 4))
    with pytest.raises(ValueError, match="R \\* n"):
        K4._check(torch.zeros(1, 2, 20), torch.zeros(1, 41, 4))
    with pytest.raises(TypeError, match="float32"):
        K4._check(torch.zeros(1, 2, 20), torch.zeros(1, 40, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        K4._check(torch.zeros(1, 2, 20), torch.zeros(1, 40, 4))


def test_cpu_tensors_never_launch():
    _build.reset_launches()
    z, fo, g_rgb, g_dist = _case(6, SB=1, R=8)
    _port(z, fo, g_rgb, g_dist, True)
    assert not _build.launches
