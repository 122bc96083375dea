"""Port parity for the serving path's plain substrate: the conf parser,
camera geometry, the band sampler, the volume integral and the encoder's
align-corners resize.

The same numpy inputs go through ``avr_tpu`` (JAX on the CPU) and
``avr_tpu_torch`` (CPU tensors).  Tolerances, float32 on both sides:
exact for the parser, the pixel grid, the orbit poses and the sampler's
z-values (the same operations in the same order); 1e-6 abs where a 3x3 or
4x4 inverse or a normalisation may round differently; 1e-5 abs for the
integral's cumulative product over 20 samples.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu.config import parse_conf as jax_parse_conf
from avr_tpu.data.dataset import pixel_grid as jax_pixel_grid
from avr_tpu.ops import hashrng as jh
from avr_tpu.ops.integrate import volume_integral as jax_volume_integral
from avr_tpu.ops.resize import resize_bilinear_align_corners as jax_resize
from avr_tpu.ops.sampling import sample_coarse as jax_sample_coarse
from avr_tpu.utils import geometry as jg
from avr_tpu_torch.config import parse_conf
from avr_tpu_torch.models.pixelnerf import ModelConfig
from avr_tpu_torch.ops import hashrng as th
from avr_tpu_torch.ops.integrate import volume_integral
from avr_tpu_torch.ops.resize import resize_bilinear_align_corners
from avr_tpu_torch.ops.sampling import sample_coarse
from avr_tpu_torch.renderers.base import AdaptiveRendererConfig
from avr_tpu_torch.utils import geometry as tg

torch.set_num_threads(2)

CONF_DIR = os.path.join(os.path.dirname(__file__), "..", "conf")


@pytest.mark.parametrize("name", ["default.conf", "default_mv.conf"])
def test_conf_parses_as_the_jax_parser_does(name):
    path = os.path.join(CONF_DIR, name)
    assert parse_conf(path).as_dict() == jax_parse_conf(path).as_dict()


def test_default_mv_conf_is_the_slice_width():
    conf = parse_conf(os.path.join(CONF_DIR, "default_mv.conf"))
    mc = ModelConfig.from_conf(conf["model"])
    rc = AdaptiveRendererConfig.from_conf(conf["adaptive_renderer"])
    mc.check_supported()
    assert (mc.encoder.backbone, mc.encoder.num_layers) == ("resnet34", 4)
    assert (mc.code.num_freqs, mc.code.freq_factor, mc.code.include_input) == (6, 1.5, True)
    for mlp in (mc.mlp_coarse, mc.mlp_fine):
        assert (mlp.n_blocks, mlp.d_hidden, mlp.combine_layer) == (5, 512, 3)
    assert (rc.raymarch_steps, rc.hidden_size, rc.n_coarse, rc.epsilon, rc.white_back) == \
        (10, 16, 20, 0.15, True)


@pytest.mark.parametrize("sl", [8, 128])
def test_pixel_grid_matches(sl):
    np.testing.assert_array_equal(tg.pixel_grid(sl, sl), jax_pixel_grid(sl, sl))
    np.testing.assert_array_equal(tg.pixel_grid(sl, sl),
                                  np.asarray(jg.get_opencv_pixel_coordinates(sl, sl)))


def test_orbit_poses_match():
    got = tg.orbit_cam2world(5, 1.3).numpy()
    want = np.asarray(jg.orbit_cam2world(5, 1.3))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _rays(seed, SB=2, N=33):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 1, (SB, N, 2)).astype(np.float32)
    K = np.tile(np.asarray([[1.1, 0, 0.5], [0, 1.05, 0.48], [0, 0, 1]], np.float32), (SB, 1, 1))
    poses = np.asarray(jg.orbit_cam2world(SB, 1.3))
    c2w = np.broadcast_to(poses[:, None], (SB, N, 4, 4)).copy()
    return xy, K, c2w


def test_world_rays_and_depth_match():
    xy, K, c2w = _rays(0)
    ro_w, rd_w = jg.get_world_rays(jnp.asarray(xy), jnp.asarray(K), jnp.asarray(c2w))
    ro, rd = tg.get_world_rays(torch.from_numpy(xy), torch.from_numpy(K), torch.from_numpy(c2w))
    np.testing.assert_allclose(ro.numpy(), np.asarray(ro_w), rtol=0, atol=1e-6)
    np.testing.assert_allclose(rd.numpy(), np.asarray(rd_w), rtol=0, atol=1e-6)
    np.testing.assert_allclose(torch.linalg.norm(rd, dim=-1).numpy(), 1.0, atol=1e-6)
    pts = ro + rd * 0.9
    want = np.asarray(jg.depth_from_world(jnp.asarray(pts.numpy()), jnp.asarray(c2w)))
    got = tg.depth_from_world(pts, torch.from_numpy(c2w)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_band_sampler_matches_with_ray_seeds():
    rng = np.random.default_rng(1)
    near = rng.uniform(0.5, 1.0, (2, 40)).astype(np.float32)
    far = near + 0.3
    key = jax.random.PRNGKey(3)
    jseeds = jh.split_any(jh.derive(key, jh.global_ray_ids(2, 40)))[1]
    tseeds = th.split_any(th.derive(0, 3, th.global_ray_ids(2, 40)))[1]
    want = np.asarray(jax_sample_coarse(jseeds, jnp.asarray(near), jnp.asarray(far), 20))
    got = sample_coarse(tseeds, torch.from_numpy(near), torch.from_numpy(far), 20).numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.diff(got, axis=-1) > 0).all()  # monotone: no sort needed


@pytest.mark.parametrize("white_back", [True, False])
def test_volume_integral_matches(white_back):
    rng = np.random.default_rng(2)
    z = np.sort(rng.uniform(0.6, 1.2, (2, 30, 20)), axis=-1).astype(np.float32)
    sig = rng.exponential(3.0, (2, 30, 20, 1)).astype(np.float32)
    sig[0, 0] = 1e4  # a saturated ray: 1 - alpha + 1e-10 must stay finite
    rad = rng.uniform(0, 1, (2, 30, 20, 3)).astype(np.float32)
    want = jax_volume_integral(jnp.asarray(z), jnp.asarray(sig), jnp.asarray(rad),
                               white_back=white_back)
    got = volume_integral(torch.from_numpy(z), torch.from_numpy(sig), torch.from_numpy(rad),
                          white_back=white_back)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


@pytest.mark.parametrize("src,dst", [((4, 4), (16, 16)), ((8, 4), (32, 16)), ((16, 16), (16, 16))])
def test_resize_matches(src, dst):
    x = np.random.default_rng(3).normal(size=(2, *src, 5)).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), dst))
    got = resize_bilinear_align_corners(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
