"""Repaired faults of the port against ``avr_tpu``.

* ``fused_integral="auto"`` fuses where JAX fuses: on the accelerator.  On
  the CPU JAX composites the band plainly and returns its opacity ``acc``
  (``avr_tpu/renderers/adaptive.py:105-131``); the port does the same on
  CPU tensors (and takes K4 on the card).  The render (1e-4, the slice's
  tolerance) and one adaptive train step with ``depth_consistency=0.5``,
  which needs ``acc`` (the loss 1e-5, every gradient 5e-3 of its leaf's
  largest value: the march's chaotic recurrence, as
  ``test_torch_training.py`` states), against the JAX model at "auto".
* The render paths invert their matrices with ``torch.linalg.inv_ex``:
  ``torch.linalg.inv`` checks its result on the host (a device sync on the
  card) on every call.  With ``torch.linalg.inv`` made to raise, an
  adaptive and a VR render still run.
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
from tests.test_torch_rules import _tiny_conf
from tests.test_torch_slice import CONF, CONF_DIR, SIDE, _camera, _perturb
from tests.test_torch_training import KEY, _batch, _leaves

torch.set_num_threads(2)

OUTPUTS = ("rgb_coarse", "rgb_fine", "depth_coarse", "depth_fine", "acc")


def _models(images, poses, focal, c):
    jconf = jax_parse_conf(CONF, base_dir=CONF_DIR)
    jmodel = JaxRenderer(model_cfg=JaxModelConfig.from_conf(jconf["model"]),
                         renderer_cfg=JaxAdaptiveConfig.from_conf(jconf["adaptive_renderer"]),
                         fused_integral="auto")
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images[:1]),
                            jnp.asarray(poses[:1]), focal, jnp.asarray(c),
                            method=jmodel.init_all)
    variables = _perturb(variables, np.random.default_rng(0))
    conf = parse_conf_string(CONF, base_dir=CONF_DIR)
    port = RadFieldRenderer(ModelConfig.from_conf(conf["model"]),
                            AdaptiveRendererConfig.from_conf(conf["adaptive_renderer"]),
                            fused_integral="auto")
    load_flax_variables(port, variables)
    return jmodel, variables, port


def test_auto_composites_plainly_with_acc_on_the_cpu_as_jax():
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
    xy = pixel_grid(8, 8).reshape(1, 64, 2)
    rays_c2w = np.broadcast_to(c2w, (1, 64, 4, 4)).copy()
    want = jmodel.apply(jvars, jcond, jnp.asarray(xy), jnp.asarray(K), jnp.asarray(rays_c2w),
                        jh.derive(jax.random.PRNGKey(5), jh.global_ray_ids(1, 64)),
                        method=jmodel.render)
    _build.reset_launches()
    with torch.inference_mode():
        pcond = port.encode(torch.from_numpy(images), torch.from_numpy(poses), float(focal),
                            torch.from_numpy(c))
        got = port.render(pcond, torch.from_numpy(xy), torch.from_numpy(K),
                          torch.from_numpy(rays_c2w), th.derive(0, 5, th.global_ray_ids(1, 64)))
    assert not _build.launches
    assert got.acc is not None and want.acc is not None
    for name in OUTPUTS:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=name)
    assert float(np.asarray(want.acc).max()) > 0.05  # the band holds some opacity


@pytest.fixture(scope="module")
def stepped():
    images, poses, focal, c, model_input, gt = _batch()
    jmodel, variables, port = _models(images, poses, focal, c)
    loss = dict(loss_mode="both", depth_consistency=0.5)
    tx = jax_make_optimizer(1e-4)
    jstate = jax_create_state(jax.tree.map(jnp.asarray, variables), tx)
    jstep = jax_make_train_step(jmodel, tx, JaxLossParams(**loss), donate=False)
    jstate, jmetrics = jstep(jstate, jnp.asarray(images), jnp.asarray(poses), focal,
                             jnp.asarray(c), jax.tree.map(jnp.asarray, model_input),
                             jnp.asarray(gt), jax.random.PRNGKey(KEY))
    opt = make_optimizer(1e-4)
    state = create_train_state(port, opt)
    t = lambda a: torch.from_numpy(np.asarray(a))
    _build.reset_launches()
    state, metrics = make_train_step(port, opt, LossParams(**loss))(
        state, t(images), t(poses), float(focal), t(c),
        {k: t(v) for k, v in model_input.items()}, t(gt), (0, KEY))
    return dict(jstate=jstate, jmetrics=jmetrics, state=state, metrics=metrics,
                launches=dict(_build.launches))


def test_depth_consistency_step_at_auto_matches_jax(stepped):
    assert not stepped["launches"], "the CPU step launched a kernel"
    np.testing.assert_allclose(float(stepped["metrics"]["loss"]),
                               float(stepped["jmetrics"]["loss"]), rtol=0, atol=1e-5)
    assert int(stepped["metrics"]["notfinite"]) == int(stepped["jmetrics"]["notfinite"]) == 0
    got = _leaves(to_flax_tree(stepped["state"].opt_state.mu)["params"])
    want = _leaves(stepped["jstate"].opt_state.inner_state[0].mu)
    assert got.keys() == want.keys()
    for k in want:
        scale = max(np.abs(want[k]).max(), 1e-12)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=5e-3 * scale, err_msg=k)


@pytest.mark.parametrize("renderer", ["", "VR"])
def test_renders_never_call_the_syncing_inverse(monkeypatch, renderer):
    def refuse(*args, **kw):
        raise AssertionError("torch.linalg.inv checks its result on the host (a device sync)")

    model = make_model(_tiny_conf(), dtype=torch.float32, seed=1, device="cpu",
                       renderer=renderer)
    c2w, K = _camera()
    rng = np.random.default_rng(3)
    monkeypatch.setattr(torch.linalg, "inv", refuse)
    xy = torch.from_numpy(rng.uniform(0.05, 0.95, size=(1, 16, 2)).astype(np.float32))
    with torch.inference_mode():
        cond = model.encode(torch.zeros(1, 1, 16, 16, 3), torch.from_numpy(c2w)[None, None],
                            17.5)
        out = model.render(cond, xy, torch.from_numpy(K),
                           torch.from_numpy(c2w).expand(1, 16, 4, 4),
                           th.derive(0, 2, th.global_ray_ids(1, 16)))
    assert torch.isfinite(out.rgb_fine).all() and torch.isfinite(out.depth_fine).all()
