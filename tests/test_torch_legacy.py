"""Port parity of the legacy threefry key stream against ``avr_tpu``.

JAX's serving path (``render_full_image``, ``generate_video``) and its
``rng_mode="legacy"`` train steps give the renderers a raw threefry key;
the port draws that key's stream through K7 (its plain version on CPU
tensors), bit for bit the ``jax.random`` draws the JAX package makes off a
TPU.  The small models are ``test_torch_volume.py``'s (ResNet34 cut to 2
layers, decoders d_hidden 128 with 3 blocks, 3 march steps, 4 band
samples; the VR 8 + 4 + 2 samples a ray), Flax-initialised, perturbed and
carried across by ``load_flax_variables``; the fused path is the adaptive
model with K5's gather and K4's integral (the JAX model at
``fused_integral="always"``, interpret mode).

* A ray batch rendered with ``PRNGKey(5)`` by each renderer, and
  ``render_full_image`` of a 16x16 image in 96-ray chunks (the last one
  ragged: 64 rays edge-padded to 96) against JAX's: 1e-4 absolute, the
  slice's tolerance (float32, sums in other orders, a 3-step march).
* ``generate_video``'s uint8 frames (adaptive and VR, two orbit frames)
  against ``avr_tpu.evaluation.generate_video``: the floats agree to 1e-4,
  so a pixel may round to the next uint8 level where its value sits within
  that of a level's edge: at most 1 level, in at most 1% of the values.
* Legacy train steps against JAX's (loss, gradient norm, every gradient
  through Adam's first moment, BatchNorm statistics): the VR at ``C = 1``
  (``make_train_step``), at ``C = 2`` (``make_train_step(ray_chunks=2)``
  and ``make_chunked_call_train_step``, chunk ``i`` with ``split(key,
  2)[i]``) and the chunked-call step at ``C = 1`` (``split(key, 1)[0]``),
  at ``test_torch_chunked.py``'s 1e-4; the Raymarcher at ``C = 1``, 5e-3
  (its chaotic march).  No CPU step launches a kernel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu.config import parse_conf_string as jax_parse_conf
from avr_tpu.evaluation import generate_video as jax_generate_video
from avr_tpu.models.pixelnerf import ModelConfig as JaxModelConfig
from avr_tpu.models.wrapper import RadFieldRenderer as JaxRenderer
from avr_tpu.renderers.base import renderer_config_from_conf as jax_renderer_config
from avr_tpu.training import LossParams as JaxLossParams
from avr_tpu.training import create_train_state as jax_create_state
from avr_tpu.training import make_optimizer as jax_make_optimizer
from avr_tpu.training import make_train_step as jax_make_train_step
from avr_tpu.training.loop import render_full_image as jax_render_full_image
from avr_tpu.training.step import make_chunked_call_train_step as jax_make_chunked_step
from avr_tpu_torch.config import parse_conf_string
from avr_tpu_torch.evaluation import generate_video, render_full_image
from avr_tpu_torch.models.flax_import import load_flax_variables
from avr_tpu_torch.models.pixelnerf import ModelConfig
from avr_tpu_torch.models.wrapper import RadFieldRenderer
from avr_tpu_torch.ops import threefry
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.renderers.base import renderer_config_from_conf
from avr_tpu_torch.training import create_train_state, make_optimizer, make_train_step
from avr_tpu_torch.training.step import make_chunked_call_train_step
from tests.test_torch_chunked import LOSS_MODE, VR_TOL, _compare, _models, _port_step
from tests.test_torch_slice import CONF_DIR, TOL, _camera, _perturb
from tests.test_torch_training import KEY, _batch, _leaves
from tests.test_torch_volume import CONF_VR

torch.set_num_threads(2)

# each path: the experiment name that picks the renderer, and the fused path's flag
PATHS = {"adaptive": ("", False), "fused": ("", True), "VR": ("VR", False),
         "Raymarcher": ("Raymarcher", False)}
SL, CHUNK = 16, 96


def _scene(rng):
    c2w, _ = _camera()
    images = rng.uniform(-1, 1, size=(1, 1, SL, SL, 3)).astype(np.float32)
    return images, c2w[None, None], np.float32(1.09375 * SL), np.asarray([SL / 2] * 2, np.float32)


def _pair(path):
    """JAX and port models of ``path`` with the same perturbed weights, both
    conditioned on one 16x16 source view."""
    name, fused = PATHS[path]
    rng = np.random.default_rng(0)
    jconf = jax_parse_conf(CONF_VR, base_dir=CONF_DIR)
    jmodel = JaxRenderer(model_cfg=JaxModelConfig.from_conf(jconf["model"]),
                         renderer_cfg=jax_renderer_config(jconf, name, raymarch_steps=3),
                         **(dict(fused_integral="always") if fused else {}))
    images, poses, focal, c = _scene(rng)
    variables = jax.jit(lambda im, po, cc: jmodel.init(
        jax.random.PRNGKey(0), im, po, focal, cc, method=jmodel.init_all))(images, poses, c)
    variables = _perturb(variables, rng)
    conf = parse_conf_string(CONF_VR, base_dir=CONF_DIR)
    model_cfg = ModelConfig.from_conf(conf["model"])
    port = RadFieldRenderer(
        dataclasses.replace(model_cfg, gather_impl="pallas_proj") if fused else model_cfg,
        renderer_config_from_conf(conf, name, raymarch_steps=3),
        fused_integral="always" if fused else "never")
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
    return dict(jmodel=jmodel, jvars=jvars, jcond=jcond, jrender=jrender, port=port,
                pcond=pcond, scene=(images, poses, focal, c))


@pytest.fixture(scope="module", params=list(PATHS))
def pair(request):
    return request.param, _pair(request.param)


def _outputs(out):
    return {k: np.asarray(v) for k, v in out._asdict().items() if v is not None}


def _assert_outputs_match(got, want):
    got, want = _outputs(got), _outputs(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], w, rtol=0, atol=TOL, err_msg=k)


def test_render_with_a_threefry_key_matches_jax(pair):
    path, m = pair
    c2w, K = _camera()
    xy = np.random.default_rng(1).uniform(0.05, 0.95, size=(1, CHUNK, 2)).astype(np.float32)
    rays_c2w = np.broadcast_to(c2w, (1, CHUNK, 4, 4)).copy()
    want = m["jrender"](m["jvars"], m["jcond"], jnp.asarray(xy), jnp.asarray(K),
                        jnp.asarray(rays_c2w), jax.random.PRNGKey(5))
    _build.reset_launches()
    with torch.inference_mode():
        got = m["port"].render(m["pcond"], torch.from_numpy(xy), torch.from_numpy(K),
                               torch.from_numpy(rays_c2w), threefry.PRNGKey(5))
    assert not _build.launches
    _assert_outputs_match(got, want)
    # another key moves the jitter, and with it the outputs
    with torch.inference_mode():
        other = m["port"].render(m["pcond"], torch.from_numpy(xy), torch.from_numpy(K),
                                 torch.from_numpy(rays_c2w), threefry.PRNGKey(6))
    assert not torch.equal(other.depth_fine, got.depth_fine), path


def test_render_full_image_matches_jax_with_a_ragged_last_chunk(pair):
    _, m = pair
    c2w, K = _camera()
    assert SL * SL % CHUNK, "the last chunk must be ragged"
    want = jax_render_full_image(m["jrender"], m["jvars"], m["jcond"], jnp.asarray(K),
                                 jnp.asarray(c2w)[None], SL, jax.random.PRNGKey(3), CHUNK)
    got = render_full_image(m["port"], m["pcond"], torch.from_numpy(K),
                            torch.from_numpy(c2w)[None], SL, threefry.PRNGKey(3), CHUNK,
                            device="cpu")
    assert got.rgb_coarse.shape == (1, SL * SL, 3)
    _assert_outputs_match(got, want)


@pytest.mark.parametrize("path", ["adaptive", "VR"])
def test_generate_video_frames_match_jax(path):
    m = _pair(path)
    images, poses, focal, c = m["scene"]
    _, K = _camera()
    batch = dict(images=images.reshape(1, 1, SL * SL, 3), cam2world=poses,
                 focal=np.full((1, 1), focal, np.float32), c=c.reshape(1, 1, 2),
                 intrinsics=K.reshape(1, 1, 3, 3))
    state = jax_create_state(m["jvars"], jax_make_optimizer(1e-4))
    want = jax_generate_video(m["jmodel"], state, batch, 2, 1.3, render_chunk=CHUNK)
    _build.reset_launches()
    got = generate_video(m["port"], batch, 2, 1.3, render_chunk=CHUNK, device="cpu")
    assert not _build.launches
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape == (SL, SL, 3)
        diff = np.abs(g.astype(int) - w.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    assert not np.array_equal(got[0], got[1]), "the two orbit frames are different views"


# ---------------------------------------------------------------------------
# legacy train steps
# ---------------------------------------------------------------------------


def _jax_legacy_step(jmodel, variables, name, chunks, chunked_call):
    images, poses, focal, c, model_input, gt = _batch()
    tx = jax_make_optimizer(1e-4)
    state = jax_create_state(jax.tree.map(jnp.asarray, variables), tx)
    lp = JaxLossParams(loss_mode=LOSS_MODE[name])
    step = (jax_make_chunked_step(jmodel, tx, lp, ray_chunks=chunks, rng_mode="legacy")
            if chunked_call else
            jax_make_train_step(jmodel, tx, lp, donate=False, rng_mode="legacy"))
    state, metrics = step(state, jnp.asarray(images), jnp.asarray(poses), focal, jnp.asarray(c),
                          jax.tree.map(jnp.asarray, model_input), jnp.asarray(gt),
                          jax.random.PRNGKey(KEY))
    return dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                g=_leaves(jax.tree.map(lambda m: m / 0.1, state.opt_state.inner_state[0].mu)),
                stats=_leaves(state.batch_stats))


def _legacy(make):
    """A step factory of ``_port_step``'s form in ``rng_mode="legacy"``,
    given the key ``PRNGKey(KEY)`` (``_port_step`` passes ``(0, KEY)``, the
    same two words)."""
    assert tuple(threefry.PRNGKey(KEY)) == (0, KEY)
    return lambda m, o, lp: make(m, o, lp, rng_mode="legacy")


@pytest.fixture(scope="module")
def vr():
    jmodel, variables, port = _models("VR")
    two = lambda m, o, lp, rng_mode: make_train_step(m, o, lp, ray_chunks=2, rng_mode=rng_mode)
    call = lambda c: (lambda m, o, lp, rng_mode: make_chunked_call_train_step(
        m, o, lp, ray_chunks=c, rng_mode=rng_mode))
    return dict(
        jax1=_jax_legacy_step(jmodel, variables, "VR", 1, False),
        jax2=_jax_legacy_step(jmodel, variables, "VR", 2, True),
        jax_call1=_jax_legacy_step(jmodel, variables, "VR", 1, True),
        port1=_port_step(port(), "VR", _legacy(make_train_step)),
        port2=_port_step(port(), "VR", _legacy(two)),
        port2_call=_port_step(port(), "VR", _legacy(call(2))),
        port_call1=_port_step(port(), "VR", _legacy(call(1))),
        per_ray=_port_step(port(), "VR", make_train_step))


def test_vr_legacy_step_matches_jax(vr):
    _compare(vr["port1"], vr["jax1"], VR_TOL)
    # the legacy stream is another stream than the per-ray hash
    assert abs(vr["port1"]["loss"] - vr["per_ray"]["loss"]) > 1e-6


@pytest.mark.parametrize("flavour", ["port2", "port2_call"])
def test_vr_legacy_two_chunks_match_jax(vr, flavour):
    _compare(vr[flavour], vr["jax2"], VR_TOL)


def test_vr_legacy_chunked_call_one_chunk_splits_the_key(vr):
    """JAX's chunked-call step renders its one chunk with ``split(key,
    1)[0]``, its scan step with the key itself: the port follows both."""
    _compare(vr["port_call1"], vr["jax_call1"], VR_TOL)
    assert abs(vr["port_call1"]["loss"] - vr["port1"]["loss"]) > 1e-6


def test_raymarcher_legacy_step_matches_jax():
    jmodel, variables, port = _models("Raymarcher")
    got = _port_step(port(), "Raymarcher", _legacy(make_train_step))
    want = _jax_legacy_step(jmodel, variables, "Raymarcher", 1, False)
    _compare(got, want, 5e-3)


def test_unknown_rng_mode_is_refused():
    _, _, port = _models("VR")
    model = port()
    opt = make_optimizer(1e-4)
    with pytest.raises(ValueError, match="rng_mode"):
        make_train_step(model, opt, None, rng_mode="sometimes")
    with pytest.raises(ValueError, match="rng_mode"):
        make_chunked_call_train_step(model, opt, None, 2, rng_mode="sometimes")
    assert create_train_state(model, opt).step.dtype == torch.int32
