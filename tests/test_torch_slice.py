"""Port parity for the whole serving slice: encode -> adaptive render.

A small ``RadFieldRenderer`` (``conf/default_mv.conf`` flags; ResNet34 cut
to ``num_layers=2`` on a 32x32 source view, decoders d_hidden 128 with 3
blocks and ``combine_layer=2``, 3 march steps, 4 band samples).  Flax
initialises it; the numpy weights are perturbed (BatchNorm statistics,
the zero-initialised ``fc_1``, and sigma's ``lin_out`` bias raised so the
band integral is not all white background) and ``load_flax_variables``
carries them into the port.  Both packages encode the same image and
render the same rays with the same per-ray seeds; the JAX side runs its
default CPU path (XLA fallbacks, which ``tests/test_pallas_*.py`` pin to
the Pallas kernels), the port its plain versions (CPU tensors).

Tolerance 1e-4 abs: float32 everywhere; the march is a chaotic recurrence
and the two packages round the projection and the LSTM sums in different
orders, which 3 steps amplify to ~1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu.config import parse_conf_string as jax_parse_conf
from avr_tpu.models.pixelnerf import ModelConfig as JaxModelConfig
from avr_tpu.models.wrapper import RadFieldRenderer as JaxRenderer
from avr_tpu.ops import hashrng as jh
from avr_tpu.renderers.base import AdaptiveRendererConfig as JaxAdaptiveConfig
from avr_tpu.training.loop import render_full_image as jax_render_full_image
from avr_tpu_torch.config import parse_conf_string
from avr_tpu_torch.evaluation import render_full_image
from avr_tpu_torch.models.flax_import import load_flax_variables
from avr_tpu_torch.models.pixelnerf import ModelConfig
from avr_tpu_torch.models.wrapper import RadFieldRenderer
from avr_tpu_torch.ops import hashrng as th
from avr_tpu_torch.ops import threefry
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.renderers.base import AdaptiveRendererConfig
from avr_tpu_torch.utils.geometry import pixel_grid

torch.set_num_threads(2)

CONF_DIR = os.path.join(os.path.dirname(__file__), "..", "conf")
CONF = """
include required("default_mv.conf")
model {
    encoder { num_layers = 2 }
    mlp_coarse { d_hidden = 128
                 n_blocks = 3
                 combine_layer = 2 }
    mlp_fine { d_hidden = 128
               n_blocks = 3
               combine_layer = 2 }
}
adaptive_renderer { raymarch_steps = 3
                    n_coarse = 4 }
"""
SIDE, TOL = 32, 1e-4
OUTPUTS = ("rgb_coarse", "rgb_fine", "depth_coarse", "depth_fine", "acc")


def _camera():
    c2w = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    c2w[2, 3] = 1.3
    K = np.asarray([[1.09375, 0, 0.5], [0, 1.09375, 0.5], [0, 0, 1]], np.float32)[None]
    return c2w, K


def _perturb(variables, rng):
    """Numpy copy of the Flax tree with every piece of the model exercised."""
    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            p = path + (k,)
            if hasattr(v, "items"):
                out[k] = walk(v, p)
                continue
            a = np.array(v, np.float32)
            if k == "mean":
                a += 0.1 * rng.normal(size=a.shape)
            elif k == "var":
                a *= rng.uniform(0.5, 1.5, size=a.shape)
            elif "fc_1" in p:
                a += 0.05 * rng.normal(size=a.shape)
            elif p[-2:] == ("lin_out", "bias"):
                a[3] += 3.0  # sigma: a band that is not empty
            out[k] = a.astype(np.float32)
        return out
    return walk(variables, ())


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    jconf = jax_parse_conf(CONF, base_dir=CONF_DIR)
    jmodel = JaxRenderer(model_cfg=JaxModelConfig.from_conf(jconf["model"]),
                         renderer_cfg=JaxAdaptiveConfig.from_conf(jconf["adaptive_renderer"]))
    c2w, _ = _camera()
    images = rng.uniform(-1, 1, size=(1, 1, SIDE, SIDE, 3)).astype(np.float32)
    poses = c2w[None, None]
    focal = np.float32(1.09375 * SIDE)
    c = np.asarray([SIDE / 2, SIDE / 2], np.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(poses),
                            focal, jnp.asarray(c), method=jmodel.init_all)
    variables = _perturb(variables, rng)

    conf = parse_conf_string(CONF, base_dir=CONF_DIR)
    port = RadFieldRenderer(ModelConfig.from_conf(conf["model"]),
                            AdaptiveRendererConfig.from_conf(conf["adaptive_renderer"]))
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
    return dict(jvars=jvars, jcond=jcond, jrender=jrender, port=port, pcond=pcond)


def test_encode_matches(models):
    want = np.asarray(models["jcond"].latent)
    got = models["pcond"].latent.numpy()
    assert got.shape == want.shape == (1, SIDE // 2, SIDE // 2, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    for name in ("latent_scaling", "poses", "focal", "c", "image_shape"):
        np.testing.assert_allclose(getattr(models["pcond"], name).numpy(),
                                   np.asarray(getattr(models["jcond"], name)), atol=1e-6)


def test_render_matches(models):
    c2w, K = _camera()
    rng = np.random.default_rng(1)
    xy = pixel_grid(8, 8).reshape(1, 64, 2)[:, rng.permutation(64)]
    rays_c2w = np.broadcast_to(c2w, (1, 64, 4, 4)).copy()
    key = jax.random.PRNGKey(5)
    want = models["jrender"](models["jvars"], models["jcond"], jnp.asarray(xy), jnp.asarray(K),
                             jnp.asarray(rays_c2w), jh.derive(key, jh.global_ray_ids(1, 64)))
    with torch.inference_mode():
        got = models["port"].render(models["pcond"], torch.from_numpy(xy), torch.from_numpy(K),
                                    torch.from_numpy(rays_c2w),
                                    th.derive(0, 5, th.global_ray_ids(1, 64)))
    acc = got.acc.numpy()
    assert acc.max() > 0.3, "the band integral must see some opacity"
    for name in OUTPUTS:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=name)


def test_render_full_image_matches_chunked_jax(models):
    """8x8 image in 24-ray chunks, the last one ragged (16 rays, edge-padded
    to 24), against JAX's own ``render_full_image``: every chunk renders
    with the same threefry key, whose draws the port makes through K7's
    plain version on the CPU."""
    c2w, K = _camera()
    sl, chunk, frame = 8, 24, 9
    want = jax_render_full_image(models["jrender"], models["jvars"], models["jcond"],
                                 jnp.asarray(K), jnp.asarray(c2w)[None], sl,
                                 jax.random.PRNGKey(frame), chunk)
    _build.reset_launches()
    got = render_full_image(models["port"], models["pcond"], torch.from_numpy(K),
                            torch.from_numpy(c2w)[None], sl, threefry.PRNGKey(frame), chunk,
                            device="cpu")
    assert not _build.launches
    for name in OUTPUTS:
        w = np.asarray(getattr(want, name))
        assert w.shape[1] == sl * sl
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=0, atol=TOL,
                                   err_msg=name)
