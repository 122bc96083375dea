"""Port parity of the classic VolumeRenderer and the Raymarcher.

* ``sample_fine`` and ``sample_depth`` (both modes) against the JAX
  samplers on the same per-ray seeds: 1e-6, the same bins.
* ``render_volume`` and ``render_raymarcher`` through a small
  ``RadFieldRenderer`` (``test_torch_slice.py``'s model: ResNet34 cut to 2
  layers on a 32x32 view, decoders d_hidden 128 with 3 blocks; the VR with
  8 coarse, 4 importance and 2 depth samples a ray, the Raymarcher with 3
  steps), Flax-initialised and carried across by ``load_flax_variables``:
  JAX on its CPU path against the port's plain versions, a ray batch and
  ``render_full_image`` in chunks.  Tolerance 1e-4 abs, as for the
  adaptive slice: float32 throughout, sums in other orders (the
  Raymarcher's 3-step march amplifies them to ~1e-6).
* The VR and Raymarcher variable trees round-trip through
  ``load_flax_variables`` and ``to_flax_variables``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu.config import parse_conf_string as jax_parse_conf
from avr_tpu.models.pixelnerf import ModelConfig as JaxModelConfig
from avr_tpu.models.wrapper import RadFieldRenderer as JaxRenderer
from avr_tpu.ops import hashrng as jh
from avr_tpu.ops.sampling import sample_depth as jax_sample_depth
from avr_tpu.ops.sampling import sample_fine as jax_sample_fine
from avr_tpu.renderers.base import renderer_config_from_conf as jax_renderer_config
from avr_tpu.training.loop import render_full_image as jax_render_full_image
from avr_tpu_torch.config import parse_conf_string
from avr_tpu_torch.evaluation import render_full_image
from avr_tpu_torch.models.flax_import import load_flax_variables, to_flax_variables
from avr_tpu_torch.models.pixelnerf import ModelConfig
from avr_tpu_torch.models.wrapper import RadFieldRenderer, make_model
from avr_tpu_torch.ops import hashrng as th
from avr_tpu_torch.ops import threefry
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.ops.sampling import sample_depth, sample_fine
from avr_tpu_torch.renderers.base import (RaymarcherConfig, VolumeRendererConfig,
                                          renderer_config_from_conf)
from avr_tpu_torch.utils.geometry import pixel_grid
from tests.test_torch_slice import CONF, CONF_DIR, SIDE, TOL, _camera, _perturb

torch.set_num_threads(2)

CONF_VR = CONF + """
normal_renderer { n_coarse = 8
                  n_fine = 6
                  n_fine_depth = 2 }
"""


def _seeds(SB, R, k):
    return (jh.derive(jax.random.PRNGKey(k), jh.global_ray_ids(SB, R)),
            th.derive(0, k, th.global_ray_ids(SB, R)))


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_axis", [False, True])
def test_sample_fine_matches_jax(with_axis):
    rng = np.random.default_rng(4)
    SB, R, n, k = 3, 40, 16, 12
    w = rng.uniform(size=(SB, R, n)).astype(np.float32) ** 4  # peaked pdfs
    w[0, 0] = 0.0  # an empty ray: the 1e-5 floor makes it uniform
    near = rng.uniform(0.5, 0.9, size=(SB, R)).astype(np.float32)
    far = near + rng.uniform(0.5, 1.5, size=(SB, R)).astype(np.float32)
    if with_axis:
        w = w[..., None]
    jkey, tkey = _seeds(SB, R, 7)
    want = np.asarray(jax_sample_fine(jkey, jnp.asarray(near), jnp.asarray(far), k,
                                      jnp.asarray(w)))
    wt = torch.from_numpy(w).requires_grad_(True)
    got = sample_fine(tkey, torch.from_numpy(near), torch.from_numpy(far), k, wt)
    assert got.shape == (SB, R, k) and not got.requires_grad  # the weights are detached
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the same coarse bin for every sample
    bins = lambda z: np.floor((z - near[..., None]) / (far - near)[..., None] * n)
    np.testing.assert_array_equal(bins(got), bins(want))
    assert len(np.unique(bins(got))) > n // 2


@pytest.mark.parametrize("mode", ["reference", "intended"])
def test_sample_depth_matches_jax(mode):
    rng = np.random.default_rng(5)
    SB, R, k = 2, 33, 8
    depth = rng.uniform(0.8, 1.8, size=(SB, R, 1)).astype(np.float32)
    jkey, tkey = _seeds(SB, R, 9)
    want = np.asarray(jax_sample_depth(jkey, jnp.asarray(depth), k, 0.01, mode=mode))
    got = sample_depth(tkey, torch.from_numpy(depth), k, 0.01, mode=mode).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if mode == "reference":  # the mean is dropped: clipped to [near, far] it sits at near
        assert np.abs(got).max() < 0.1
    with pytest.raises(ValueError, match="mode"):
        sample_depth(tkey, torch.from_numpy(depth), k, 0.01, mode="other")


def test_renderer_config_dispatch_matches_jax():
    jconf = jax_parse_conf(CONF_VR, base_dir=CONF_DIR)
    conf = parse_conf_string(CONF_VR, base_dir=CONF_DIR)
    for name, kind in (("VR_run", VolumeRendererConfig), ("my_Raymarcher", RaymarcherConfig),
                       ("AVR", None)):
        got, want = renderer_config_from_conf(conf, name), jax_renderer_config(jconf, name)
        assert type(got).__name__ == type(want).__name__
        assert kind is None or isinstance(got, kind)
        for f, v in vars(got).items():
            assert getattr(want, f) == v, (name, f)
    assert VolumeRendererConfig().depth_sample_mode == "reference"


# ---------------------------------------------------------------------------
# the renderers through the whole model
# ---------------------------------------------------------------------------


def _build_pair(name, rng):
    jconf = jax_parse_conf(CONF_VR, base_dir=CONF_DIR)
    jmodel = JaxRenderer(model_cfg=JaxModelConfig.from_conf(jconf["model"]),
                         renderer_cfg=jax_renderer_config(jconf, name, raymarch_steps=3))
    c2w, _ = _camera()
    images = rng.uniform(-1, 1, size=(1, 1, SIDE, SIDE, 3)).astype(np.float32)
    poses = c2w[None, None]
    focal = np.float32(1.09375 * SIDE)
    c = np.asarray([SIDE / 2, SIDE / 2], np.float32)
    variables = jax.jit(lambda im, po, cc: jmodel.init(  # jitted: 5x faster than eager
        jax.random.PRNGKey(0), im, po, focal, cc, method=jmodel.init_all))(images, poses, c)
    variables = _perturb(variables, rng)

    conf = parse_conf_string(CONF_VR, base_dir=CONF_DIR)
    port = RadFieldRenderer(ModelConfig.from_conf(conf["model"]),
                            renderer_config_from_conf(conf, name, raymarch_steps=3))
    load_flax_variables(port, variables)
    port.eval()
    jvars = jax.tree.map(jnp.asarray, variables)
    jcond = jmodel.apply(jvars, jnp.asarray(images), jnp.asarray(poses), focal, jnp.asarray(c),
                         method=jmodel.encode)
    with torch.inference_mode():
        pcond = port.encode(torch.from_numpy(images), torch.from_numpy(poses), float(focal),
                            torch.from_numpy(c))
    jrender = jax.jit(lambda v, cond, xy, K, c2w, key: jmodel.apply(
        v, cond, xy, K, c2w, key, method=jmodel.render))
    return dict(variables=variables, jvars=jvars, jcond=jcond, jrender=jrender, port=port,
                pcond=pcond)


@pytest.fixture(scope="module", params=["VR", "Raymarcher"])
def pair(request):
    return request.param, _build_pair(request.param, np.random.default_rng(0))


def _outputs(out):
    return {k: v for k, v in out._asdict().items() if v is not None}


def test_render_matches(pair):
    name, m = pair
    c2w, K = _camera()
    rng = np.random.default_rng(1)
    xy = pixel_grid(8, 8).reshape(1, 64, 2)[:, rng.permutation(64)]
    rays_c2w = np.broadcast_to(c2w, (1, 64, 4, 4)).copy()
    key = jax.random.PRNGKey(5)
    want = m["jrender"](m["jvars"], m["jcond"], jnp.asarray(xy), jnp.asarray(K),
                        jnp.asarray(rays_c2w), jh.derive(key, jh.global_ray_ids(1, 64)))
    _build.reset_launches()
    with torch.inference_mode():
        got = m["port"].render(m["pcond"], torch.from_numpy(xy), torch.from_numpy(K),
                               torch.from_numpy(rays_c2w), th.derive(0, 5, th.global_ray_ids(1, 64)))
    assert not _build.launches
    g, w = _outputs(got), _outputs(want)
    assert g.keys() == w.keys()
    assert ("rgb_fine" in g) == (name == "VR") and "acc" not in g
    for k in w:
        assert np.isfinite(g[k].numpy()).all()
        np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), rtol=0, atol=TOL, err_msg=k)
    # the outputs carry information: not all white background, depth inside the scene
    assert np.asarray(w["rgb_coarse"]).min() < 0.9
    assert 0.3 < float(g["depth_fine"].mean()) < 3.0


def test_render_full_image_matches_chunked_jax(pair):
    """8x8 image in 24-ray chunks, the last one ragged (edge-padded), against
    JAX's own ``render_full_image`` with the same threefry key."""
    _, m = pair
    c2w, K = _camera()
    sl, chunk, frame = 8, 24, 4
    want = _outputs(jax_render_full_image(m["jrender"], m["jvars"], m["jcond"], jnp.asarray(K),
                                          jnp.asarray(c2w)[None], sl, jax.random.PRNGKey(frame),
                                          chunk))
    _build.reset_launches()
    got = _outputs(render_full_image(m["port"], m["pcond"], torch.from_numpy(K),
                                     torch.from_numpy(c2w)[None], sl, threefry.PRNGKey(frame),
                                     chunk, device="cpu"))
    assert not _build.launches
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=0, atol=TOL, err_msg=k)


def test_flax_trees_round_trip(pair):
    """The port's module tree is the Flax tree: no ``lstm``/``out_layer``
    for the VR, and the Raymarcher keeps ``mlp_fine``."""
    name, m = pair
    back = to_flax_variables(m["port"])
    flat = lambda t: {"/".join(str(p.key) for p in path): np.asarray(v)
                      for path, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    got, want = flat(back), flat(m["variables"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    params = back["params"]
    assert ("lstm" in params) == ("out_layer" in params) == (name == "Raymarcher")
    assert "mlp_fine" in params["net"]


def test_make_model_picks_the_renderer():
    conf = parse_conf_string(CONF_VR, base_dir=CONF_DIR)
    kinds = {r: type(make_model(conf, dtype=torch.float32, device="cpu", renderer=r).renderer_cfg)
             for r in ("", "VR", "Raymarcher")}
    assert kinds["VR"] is VolumeRendererConfig and kinds["Raymarcher"] is RaymarcherConfig
    assert kinds[""].__name__ == "AdaptiveRendererConfig"
    assert not make_model(conf, dtype=torch.float32, device="cpu", renderer="VR").has_marcher
