"""Port parity of the VolumeRenderer's and the Raymarcher's train steps,
whole and in ray chunks, against ``avr_tpu``.

``test_torch_volume.py``'s small models (Flax-initialised, perturbed, carried
across by ``load_flax_variables``) take one step on the same batch (SB 2 x
48 rays) and key in both packages, on the CPU (the port's plain versions):

* the VR, one chunk, against JAX ``make_train_step``;
* the VR in 2 ray chunks, through ``make_train_step(ray_chunks=2)`` and
  ``make_chunked_call_train_step(ray_chunks=2)``, against JAX
  ``make_chunked_call_train_step(ray_chunks=2)`` and against the port's own
  one-chunk step;
* the Raymarcher (``loss_mode="coarse"``) against JAX ``make_train_step``.

Compared: the loss, the gradient norm, every gradient (Adam's first moment
after one step is ``0.1 g``), the updated BatchNorm statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu.config import parse_conf_string as jax_parse_conf
from avr_tpu.models.pixelnerf import ModelConfig as JaxModelConfig
from avr_tpu.models.wrapper import RadFieldRenderer as JaxRenderer
from avr_tpu.renderers.base import renderer_config_from_conf as jax_renderer_config
from avr_tpu.training import LossParams as JaxLossParams
from avr_tpu.training import create_train_state as jax_create_state
from avr_tpu.training import make_optimizer as jax_make_optimizer
from avr_tpu.training import make_train_step as jax_make_train_step
from avr_tpu.training.step import make_chunked_call_train_step as jax_make_chunked_step
from avr_tpu_torch.config import parse_conf_string
from avr_tpu_torch.models.flax_import import load_flax_variables, to_flax_tree, to_flax_variables
from avr_tpu_torch.models.pixelnerf import ModelConfig
from avr_tpu_torch.models.wrapper import RadFieldRenderer
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.renderers.base import renderer_config_from_conf
from avr_tpu_torch.training import (LossParams, create_train_state, make_optimizer,
                                    make_train_step)
from avr_tpu_torch.training.step import make_chunked_call_train_step
from tests.test_torch_slice import CONF_DIR, _perturb
from tests.test_torch_training import KEY, _batch, _leaves
from tests.test_torch_volume import CONF_VR

torch.set_num_threads(2)

LOSS_MODE = {"VR": "both", "Raymarcher": "coarse"}


def _models(name):
    rng = np.random.default_rng(3)
    jconf = jax_parse_conf(CONF_VR, base_dir=CONF_DIR)
    jmodel = JaxRenderer(model_cfg=JaxModelConfig.from_conf(jconf["model"]),
                         renderer_cfg=jax_renderer_config(jconf, name, raymarch_steps=3))
    images, poses, focal, c, _, _ = _batch()
    variables = jax.jit(lambda im, po, cc: jmodel.init(
        jax.random.PRNGKey(0), im, po, focal, cc, method=jmodel.init_all))(
        images[:1], poses[:1], c)
    variables = _perturb(variables, rng)
    conf = parse_conf_string(CONF_VR, base_dir=CONF_DIR)

    def port():
        model = RadFieldRenderer(ModelConfig.from_conf(conf["model"]),
                                 renderer_config_from_conf(conf, name, raymarch_steps=3))
        return load_flax_variables(model, variables)

    return jmodel, variables, port


def _jax_step(jmodel, variables, name, chunks):
    images, poses, focal, c, model_input, gt = _batch()
    tx = jax_make_optimizer(1e-4)
    state = jax_create_state(jax.tree.map(jnp.asarray, variables), tx)
    lp = JaxLossParams(loss_mode=LOSS_MODE[name])
    step = (jax_make_train_step(jmodel, tx, lp, donate=False) if chunks == 1
            else jax_make_chunked_step(jmodel, tx, lp, ray_chunks=chunks))
    state, metrics = step(state, jnp.asarray(images), jnp.asarray(poses), focal, jnp.asarray(c),
                          jax.tree.map(jnp.asarray, model_input), jnp.asarray(gt),
                          jax.random.PRNGKey(KEY))
    return dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                g=_leaves(jax.tree.map(lambda m: m / 0.1, state.opt_state.inner_state[0].mu)),
                stats=_leaves(state.batch_stats))


def _port_step(model, name, make_step):
    images, poses, focal, c, model_input, gt = _batch()
    opt = make_optimizer(1e-4)
    state = create_train_state(model, opt)
    t = lambda a: torch.from_numpy(np.asarray(a))
    _build.reset_launches()
    state, metrics = make_step(model, opt, LossParams(loss_mode=LOSS_MODE[name]))(
        state, t(images), t(poses), float(focal), t(c),
        {k: t(v) for k, v in model_input.items()}, t(gt), (0, KEY))
    assert not _build.launches, "the CPU step launched a kernel"
    assert int(metrics["notfinite"]) == 0 and int(state.step) == 1
    return dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                g=_leaves(to_flax_tree({k: v / 0.1 for k, v in state.opt_state.mu.items()})
                          ["params"]),
                stats=_leaves(to_flax_variables(model)["batch_stats"]))


def _compare(got, want, grad_tol):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-3)
    assert got["g"].keys() == want["g"].keys()
    for k, w in want["g"].items():
        scale = max(np.abs(w).max(), 1e-12)
        np.testing.assert_allclose(got["g"][k], w, rtol=0, atol=grad_tol * scale, err_msg=k)
    assert got["stats"].keys() == want["stats"].keys()
    for k, w in want["stats"].items():
        np.testing.assert_allclose(got["stats"][k], w, rtol=0, atol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def vr():
    jmodel, variables, port = _models("VR")
    chunked = lambda m, o, lp: make_chunked_call_train_step(m, o, lp, ray_chunks=2)
    return dict(
        jax1=_jax_step(jmodel, variables, "VR", 1),
        jax2=_jax_step(jmodel, variables, "VR", 2),
        port1=_port_step(port(), "VR", make_train_step),
        port2=_port_step(port(), "VR", lambda m, o, lp: make_train_step(m, o, lp, ray_chunks=2)),
        port2_call=_port_step(port(), "VR", chunked))


# float32 with no march: sums in other orders, which the encoder's
# train-mode BatchNorm amplifies most (7.4e-6 of a leaf's scale measured;
# an importance sample in another coarse bin would move its ray by far
# more): 1e-4
VR_TOL = 1e-4


def test_vr_step_matches_jax(vr):
    _compare(vr["port1"], vr["jax1"], VR_TOL)


@pytest.mark.parametrize("flavour", ["port2", "port2_call"])
def test_vr_chunked_step_matches_jax_chunked_call(vr, flavour):
    _compare(vr[flavour], vr["jax2"], VR_TOL)


def test_vr_chunked_step_matches_one_chunk(vr):
    """Per-ray work is independent and the seeds are one global map, so two
    chunks give the one-chunk update up to summation order."""
    _compare(vr["port2"], vr["port1"], VR_TOL)
    for k in vr["port2"]["g"]:  # the two chunked flavours are one computation
        np.testing.assert_array_equal(vr["port2"]["g"][k], vr["port2_call"]["g"][k])


def test_raymarcher_step_matches_jax():
    jmodel, variables, port = _models("Raymarcher")
    got = _port_step(port(), "Raymarcher", make_train_step)
    want = _jax_step(jmodel, variables, "Raymarcher", 1)
    # float32, but the 3-step march is a chaotic recurrence (as for the
    # adaptive step, test_torch_training.py): 5e-3 of each leaf's scale
    _compare(got, want, 5e-3)
    # the coarse loss reads no fine decoder and no coarse sigma
    assert not any(np.abs(v).max() for k, v in got["g"].items() if "mlp_fine" in k)
    assert not np.abs(got["g"]["net/mlp_coarse/lin_out/kernel"][:, 3]).max()


def test_ray_chunks_must_divide_the_rays():
    _, _, port = _models("VR")
    with pytest.raises(ValueError, match="divisible"):
        _port_step(port(), "VR", lambda m, o, lp: make_train_step(m, o, lp, ray_chunks=5))
