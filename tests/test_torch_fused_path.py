"""Port parity of the adaptive renderer's fused path against ``avr_tpu``.

The port's model with ``gather_impl="pallas_proj"`` (K5) and
``fused_integral="always"`` (K4) against the JAX model at
``fused_integral="always"``, which runs the Pallas band integral in
interpret mode on the CPU (``avr_tpu/renderers/adaptive.py:123``), and its
default gather (JAX's ``pallas_proj`` passes no ``interpret`` and cannot
run on the CPU; ``tests/test_torch_gather_proj.py`` holds K5 to it
alone).  The small model, weights and batch are ``test_torch_slice.py``'s
and ``test_torch_training.py``'s; on CPU tensors the port runs the plain
versions of K4 and K5.

* The render: rgb and depth, coarse and fine, 1e-4 (the slice's tolerance:
  float32, a 3-step march rounded in other orders); neither side gives a
  band opacity (``acc`` is None).
* One train step: the loss 1e-5, every gradient (Adam's first moment is
  ``0.1 g``) 5e-3 of its leaf's largest value, for the reason
  ``test_torch_training.py`` states (the march's chaotic recurrence).  The
  CPU step launches nothing.
* ``gather_impl="xla"`` (a plain path on the card) is refused.
"""

import dataclasses

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
from avr_tpu.training import LossParams as JaxLossParams
from avr_tpu.training import create_train_state as jax_create_state
from avr_tpu.training import make_optimizer as jax_make_optimizer
from avr_tpu.training import make_train_step as jax_make_train_step
from avr_tpu_torch.config import parse_conf_string
from avr_tpu_torch.models.flax_import import load_flax_variables, to_flax_tree
from avr_tpu_torch.models.pixelnerf import ModelConfig
from avr_tpu_torch.models.wrapper import RadFieldRenderer, make_model
from avr_tpu_torch.ops import hashrng as th
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.renderers.base import AdaptiveRendererConfig
from avr_tpu_torch.training import LossParams, create_train_state, make_optimizer, make_train_step
from avr_tpu_torch.utils.geometry import pixel_grid
from tests.test_torch_slice import CONF, CONF_DIR, SIDE, _camera, _perturb
from tests.test_torch_training import KEY, _batch, _leaves

torch.set_num_threads(2)

OUTPUTS = ("rgb_coarse", "rgb_fine", "depth_coarse", "depth_fine")


def _models(images, poses, focal, c):
    """The JAX model (fused integral) with perturbed Flax weights, and the
    port's fused model carrying the same weights."""
    jconf = jax_parse_conf(CONF, base_dir=CONF_DIR)
    jmodel = JaxRenderer(model_cfg=JaxModelConfig.from_conf(jconf["model"]),
                         renderer_cfg=JaxAdaptiveConfig.from_conf(jconf["adaptive_renderer"]),
                         fused_integral="always")
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images[:1]),
                            jnp.asarray(poses[:1]), focal, jnp.asarray(c),
                            method=jmodel.init_all)
    variables = _perturb(variables, np.random.default_rng(0))
    conf = parse_conf_string(CONF, base_dir=CONF_DIR)
    port = RadFieldRenderer(
        dataclasses.replace(ModelConfig.from_conf(conf["model"]), gather_impl="pallas_proj"),
        AdaptiveRendererConfig.from_conf(conf["adaptive_renderer"]), fused_integral="always")
    load_flax_variables(port, variables)
    return jmodel, variables, port


def test_fused_render_matches_jax():
    rng = np.random.default_rng(0)
    c2w, K = _camera()
    images = rng.uniform(-1, 1, size=(1, 1, SIDE, SIDE, 3)).astype(np.float32)
    poses = c2w[None, None]
    focal = np.float32(1.09375 * SIDE)
    c = np.asarray([SIDE / 2, SIDE / 2], np.float32)
    jmodel, variables, port = _models(images, poses, focal, c)
    port.eval()
    jvars = jax.tree.map(jnp.asarray, variables)
    jcond = jmodel.apply(jvars, jnp.asarray(images), jnp.asarray(poses), focal, jnp.asarray(c),
                         method=jmodel.encode)
    xy = pixel_grid(8, 8).reshape(1, 64, 2)[:, np.random.default_rng(1).permutation(64)]
    rays_c2w = np.broadcast_to(c2w, (1, 64, 4, 4)).copy()
    want = jax.jit(lambda v, cond: jmodel.apply(
        v, cond, jnp.asarray(xy), jnp.asarray(K), jnp.asarray(rays_c2w),
        jh.derive(jax.random.PRNGKey(5), jh.global_ray_ids(1, 64)), method=jmodel.render))(
        jvars, jcond)
    _build.reset_launches()
    with torch.inference_mode():
        pcond = port.encode(torch.from_numpy(images), torch.from_numpy(poses), float(focal),
                            torch.from_numpy(c))
        got = port.render(pcond, torch.from_numpy(xy), torch.from_numpy(K),
                          torch.from_numpy(rays_c2w), th.derive(0, 5, th.global_ray_ids(1, 64)))
    assert not _build.launches
    assert got.acc is None and want.acc is None
    for name in OUTPUTS:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=name)
    # the band is not all white background: the integral has work to do
    assert np.abs(got.rgb_fine.numpy() - 1.0).max() > 0.05


@pytest.fixture(scope="module")
def stepped():
    images, poses, focal, c, model_input, gt = _batch()
    jmodel, variables, port = _models(images, poses, focal, c)
    tx = jax_make_optimizer(1e-4)
    jstate = jax_create_state(jax.tree.map(jnp.asarray, variables), tx)
    jstep = jax_make_train_step(jmodel, tx, JaxLossParams(loss_mode="both"), donate=False)
    jstate, jmetrics = jstep(jstate, jnp.asarray(images), jnp.asarray(poses), focal,
                             jnp.asarray(c), jax.tree.map(jnp.asarray, model_input),
                             jnp.asarray(gt), jax.random.PRNGKey(KEY))
    opt = make_optimizer(1e-4)
    state = create_train_state(port, opt)
    t = lambda a: torch.from_numpy(np.asarray(a))
    _build.reset_launches()
    state, metrics = make_train_step(port, opt, LossParams(loss_mode="both"))(
        state, t(images), t(poses), float(focal), t(c),
        {k: t(v) for k, v in model_input.items()}, t(gt), (0, KEY))
    return dict(jstate=jstate, jmetrics=jmetrics, state=state, metrics=metrics,
                launches=dict(_build.launches))


def test_fused_train_step_loss_matches_jax(stepped):
    assert not stepped["launches"], "the CPU step launched a kernel"
    np.testing.assert_allclose(float(stepped["metrics"]["loss"]),
                               float(stepped["jmetrics"]["loss"]), rtol=0, atol=1e-5)
    assert int(stepped["metrics"]["notfinite"]) == int(stepped["jmetrics"]["notfinite"]) == 0


def test_fused_train_step_gradients_match_jax(stepped):
    got = _leaves(to_flax_tree(stepped["state"].opt_state.mu)["params"])
    want = _leaves(stepped["jstate"].opt_state.inner_state[0].mu)
    assert got.keys() == want.keys()
    for k in want:
        scale = max(np.abs(want[k]).max(), 1e-12)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=5e-3 * scale, err_msg=k)


def test_gather_impl_xla_and_unknown_values_are_refused():
    conf = parse_conf_string(CONF, base_dir=CONF_DIR)
    with pytest.raises(NotImplementedError, match="gather_impl"):
        make_model(conf, dtype=torch.float32, device="cpu", gather_impl="xla")
    with pytest.raises(ValueError, match="fused_integral"):
        make_model(conf, dtype=torch.float32, device="cpu", fused_integral="sometimes")
    model = make_model(conf, dtype=torch.float32, device="cpu", gather_impl="pallas_proj",
                       fused_integral="auto")
    assert model.net.cfg.gather_impl == "pallas_proj" and model.fused_integral == "auto"
