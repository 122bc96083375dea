"""The full-width model's options at JAX's widths, port against ``avr_tpu``.

``conf/default_mv.conf``'s model with d_hidden 1,024 in both decoders, the
spatial encoder at 5 stages and the global encoder (a latent of 1,024 +
128 = 1,152 lanes): the model the card's wide slice runs (``chip_smoke.py``
phase 11, ``WIDE_CONF``), here from the same conf string through both
packages' conf readers, ``make_model`` on the port's side, with the
adaptive renderer (its march cut to 3 steps and 4 band samples, as
``tests/test_torch_slice.py``: a chaotic recurrence over more steps
amplifies float32 rounding past any tolerance) and with the VR (8 coarse,
4 + 2 fine samples).  The source views are 64 x 64 (the global encoder's
train-mode BatchNorm over a smaller view's last stage normalises too few
values, ``tests/test_torch_model_options.py _batch64``).  Flax initialises
each, the weights are perturbed and carried by ``load_flax_variables``;
both packages encode the same view and render the same rays (1e-4
absolute) and take one train step on the same batch: the loss to 1e-5, and
with the VR Adam's first moment (0.1 of the gradient) to 5e-3 of each
leaf's scale (the march's tolerance, ROADMAP's parity note; measured 1.7e-3).
The adaptive step's gradients are not held: on this model they move by up
to 35% of a leaf's scale when the source view moves by 1e-6 (the march's
discrete choices flip), in the port alone as between the packages.
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
from avr_tpu.renderers.base import AdaptiveRendererConfig as JaxAdaptiveConfig
from avr_tpu.renderers.base import VolumeRendererConfig as JaxVolumeConfig
from avr_tpu.training import LossParams as JaxLossParams
from avr_tpu.training import create_train_state as jax_create_state
from avr_tpu.training import make_optimizer as jax_make_optimizer
from avr_tpu.training import make_train_step as jax_make_train_step
from avr_tpu_torch.config import parse_conf_string
from avr_tpu_torch.models.flax_import import load_flax_variables, to_flax_tree
from avr_tpu_torch.models.wrapper import make_model
from avr_tpu_torch.ops import hashrng as th
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.renderers.base import VolumeRendererConfig
from avr_tpu_torch.training import (LossParams, create_train_state, make_optimizer,
                                    make_train_step)
from avr_tpu_torch.utils.geometry import pixel_grid
from tests.test_torch_model_options import _batch64, _close_tree
from tests.test_torch_slice import CONF_DIR, OUTPUTS, _camera, _perturb
from tests.test_torch_training import KEY

torch.set_num_threads(2)

CONF = """
include required("default_mv.conf")
model {
mlp_coarse { d_hidden = 1024 }
mlp_fine { d_hidden = 1024 }
encoder { num_layers = 5 }
use_global_encoder = True
global_encoder { backbone = resnet34
 latent_size = 128 }
}
adaptive_renderer { raymarch_steps = 3
                    n_coarse = 4 }
normal_renderer { n_coarse = 8
                  n_fine = 4
                  n_fine_depth = 2 }
"""
TOL = 1e-4
t = lambda a: torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module", params=["adaptive", "VR"])
def models(request):
    rng = np.random.default_rng(0)
    jconf = jax_parse_conf(CONF, base_dir=CONF_DIR)
    jren = (JaxVolumeConfig.from_conf(jconf["normal_renderer"]) if request.param == "VR"
            else JaxAdaptiveConfig.from_conf(jconf["adaptive_renderer"]))
    jmodel = JaxRenderer(model_cfg=JaxModelConfig.from_conf(jconf["model"]), renderer_cfg=jren)
    images, poses, focal, c, model_input, gt = _batch64()
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images[:1]),
                            jnp.asarray(poses[:1]), focal, jnp.asarray(c),
                            method=jmodel.init_all)
    variables = _perturb(variables, rng)
    port = make_model(parse_conf_string(CONF, base_dir=CONF_DIR), dtype=torch.float32,
                      device="cpu", renderer="VR" if request.param == "VR" else "")
    load_flax_variables(port, variables)
    return jmodel, variables, port, (images, poses, focal, c, model_input, gt)


def test_the_wide_conf_builds_the_wide_decoders(models):
    _, _, port, _ = models
    for mlp in (port.net.mlp_coarse, port.net.mlp_fine):
        assert (mlp.d_hidden, mlp.d_latent) == (1024, 1152)
        assert mlp.fuses(1, True)  # JAX fuses it: on the card, K2's wide kernels


def test_render_matches(models):
    jmodel, variables, port, (images, poses, focal, c, _, _) = models
    jvars = jax.tree.map(jnp.asarray, variables)
    jcond = jmodel.apply(jvars, jnp.asarray(images[:1]), jnp.asarray(poses[:1]), focal,
                         jnp.asarray(c), method=jmodel.encode)
    c2w, K = _camera()
    rng = np.random.default_rng(1)
    xy = pixel_grid(8, 8).reshape(1, 64, 2)[:, rng.permutation(64)]
    rays_c2w = np.broadcast_to(c2w, (1, 64, 4, 4)).copy()
    want = jmodel.apply(jvars, jcond, jnp.asarray(xy), jnp.asarray(K), jnp.asarray(rays_c2w),
                        jh.derive(jax.random.PRNGKey(5), jh.global_ray_ids(1, 64)),
                        method=jmodel.render)
    _build.reset_launches()
    with torch.inference_mode():
        cond = port.encode(t(images[:1]), t(poses[:1]), float(focal), t(c))
        assert cond.latent.shape[-1] + cond.global_latent.shape[-1] == 1152
        np.testing.assert_allclose(cond.latent.numpy(), np.asarray(jcond.latent), rtol=0,
                                   atol=TOL)
        got = port.render(cond, t(xy), t(K), t(rays_c2w),
                          th.derive(0, 5, th.global_ray_ids(1, 64)))
    assert not _build.launches  # CPU tensors: the plain versions
    for name in OUTPUTS:
        if getattr(want, name) is None:  # the VR keeps no acc
            assert getattr(got, name) is None, name
            continue
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=name)


def test_train_step_matches_jax(models):
    jmodel, variables, port, (images, poses, focal, c, model_input, gt) = models
    opt = make_optimizer(1e-4)
    state = create_train_state(port, opt)
    step = make_train_step(port, opt, LossParams(loss_mode="both"), rng_mode="legacy")
    state, metrics = step(state, t(images), t(poses), float(focal), t(c),
                          {k: t(v) for k, v in model_input.items()}, t(gt), (0, KEY))
    tx = jax_make_optimizer(1e-4)
    jstate = jax_create_state(jax.tree.map(jnp.asarray, variables), tx)
    jstep = jax_make_train_step(jmodel, tx, JaxLossParams(loss_mode="both"), donate=False,
                                rng_mode="legacy")
    jin = (jnp.asarray(images), jnp.asarray(poses), focal, jnp.asarray(c),
           jax.tree.map(jnp.asarray, model_input), jnp.asarray(gt))
    jstate, jm = jstep(jstate, *jin, jax.random.PRNGKey(KEY))
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=0, atol=1e-5)
    if isinstance(port.renderer_cfg, VolumeRendererConfig):
        mu = to_flax_tree(state.opt_state.mu)["params"]
        _close_tree(mu, jstate.opt_state.inner_state[0].mu, rel=5e-3, what="wide VR")
