"""The port's checkpoints (``training/checkpoint.py``) and the device-data
step's resume, against ``avr_tpu``.

* Round trip: a state after two steps (Adam's moments, the skip count, the
  EMA, BatchNorm's statistics) saved and restored into a fresh model's
  template equals the saved one bit for bit; the restored state is a new
  ``TrainState`` whose parameters are the template model's own tensors.
  The path follows JAX's ``checkpoint_path`` naming.
* JAX's four restore rules: a missing file warns and keeps the template
  (``strict`` raises); a checkpoint without optimizer state (or another
  optimizer's) restores the rest and keeps the template's fresh optimizer
  state, with a warning; parameters of another model raise; a checkpoint
  saved without an EMA seeds the template's EMA from the restored
  parameters.
* A JAX checkpoint (Orbax, saved and restored by JAX's functions) carried
  across into the port (``load_flax_variables`` and ``from_flax_tree``)
  gives the same next train step in both packages, by
  ``test_torch_chunked.py``'s comparison of the small VR model's step (the
  loss to 1e-5, the gradient norm to 1e-3, Adam's first moment after the
  second step to ``DD_TOL`` of its leaf's largest value, at the learning
  rate 1e-4 where that tolerance was measured; at 1e-3 two elements of an
  encoder convolution's moment differ by 1.2e-3 of the leaf's largest value,
  float32 sums in other orders); the carried state saved by the port and
  restored gives the port the same step bit for bit.
* The device-data step after a restore into a state it has already stepped
  (and after a step count set anew or changed in place) draws the batch of
  ``fold_in(sampler_key, restored step)``: bit for bit JAX's sampler at that
  step.
"""

import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from avr_tpu.data.dataset import SceneClassDataset as JaxSceneClassDataset  # noqa: E402
from avr_tpu.data.device import build_device_dataset as jax_build_device_dataset  # noqa: E402
from avr_tpu.data.device import make_device_sampler as jax_make_device_sampler  # noqa: E402
from avr_tpu.data.synthetic import write_synthetic_hdf5  # noqa: E402
from avr_tpu.training import LossParams as JaxLossParams  # noqa: E402
from avr_tpu.training import create_train_state as jax_create_state  # noqa: E402
from avr_tpu.training import make_optimizer as jax_make_optimizer  # noqa: E402
from avr_tpu.training import make_train_step as jax_make_train_step  # noqa: E402
from avr_tpu.training import restore_checkpoint as jax_restore  # noqa: E402
from avr_tpu.training import save_checkpoint as jax_save  # noqa: E402
from avr_tpu.training.checkpoint import checkpoint_path as jax_checkpoint_path  # noqa: E402
from avr_tpu_torch.config import parse_conf_string  # noqa: E402
from avr_tpu_torch.data.dataset import SceneClassDataset  # noqa: E402
from avr_tpu_torch.data.device import build_device_dataset, make_device_sampler  # noqa: E402
from avr_tpu_torch.data.synthetic import synthetic_scene_mapping  # noqa: E402
from avr_tpu_torch.models.flax_import import (from_flax_tree, load_flax_variables,  # noqa: E402
                                              to_flax_tree, to_flax_variables)
from avr_tpu_torch.models.wrapper import make_model  # noqa: E402
from avr_tpu_torch.ops import threefry  # noqa: E402
from avr_tpu_torch.training import (AdamState, LossParams, TrainState,  # noqa: E402
                                    create_train_state, make_optimizer, make_train_step)
from avr_tpu_torch.training.checkpoint import (checkpoint_path, restore_checkpoint,  # noqa: E402
                                               save_checkpoint)
from tests.test_torch_chunked import _models  # noqa: E402
from tests.test_torch_device_data import DD_TOL  # noqa: E402
from tests.test_torch_rules import ROOT, TINY  # noqa: E402
from tests.test_torch_training import KEY, _batch, _leaves  # noqa: E402

torch.set_num_threads(2)

NI, NV, SIDE = 3, 4, 16


def _tiny(seed=0, **kw):
    conf = parse_conf_string(TINY, base_dir=str(ROOT / "conf"))
    return make_model(conf, dtype=torch.float32, seed=seed, device="cpu", **kw)


def _stepped(model, steps=2, ema=True, opt=None):
    """A state of ``model`` after ``steps`` device-data steps."""
    opt = opt or make_optimizer(1e-3)
    state = create_train_state(model, opt, ema=ema)
    data = build_device_dataset(SceneClassDataset(synthetic_scene_mapping(NI, NV, SIDE)),
                                device="cpu")
    step = make_train_step(model, opt, LossParams(), ema_decay=0.9, rng_mode="legacy",
                           sampler=make_device_sampler(data, 2, 16),
                           sampler_key=threefry.PRNGKey(4))
    for _ in range(steps):
        state, _ = step(state)
    return state


def _assert_state_equal(got: TrainState, want: TrainState):
    assert torch.equal(got.step, want.step) and got.step.dtype == torch.int32
    for piece in ("params", "batch_stats", "ema_params"):
        g, w = getattr(got, piece), getattr(want, piece)
        assert g.keys() == w.keys(), piece
        for k in w:
            assert torch.equal(g[k], w[k]), (piece, k)
    go, wo = got.opt_state, want.opt_state
    assert torch.equal(go.count, wo.count) and torch.equal(go.total_notfinite,
                                                           wo.total_notfinite)
    for k in wo.mu:
        assert torch.equal(go.mu[k], wo.mu[k]) and torch.equal(go.nu[k], wo.nu[k]), k


def test_checkpoint_path_is_jax_naming(tmp_path):
    for epoch in (3, "best"):
        assert checkpoint_path(str(tmp_path), "run", epoch) == \
            jax_checkpoint_path(str(tmp_path), "run", epoch)
    assert checkpoint_path("rel", "VR", 12).endswith(
        os.path.join("rel", "checkpoints", "experiments", "VR_epoch12"))


@pytest.mark.parametrize("norm_type", ["batch", "group"])
def test_round_trip(tmp_path, norm_type):
    model = _tiny(norm_type=norm_type)
    state = _stepped(model)
    state.opt_state.total_notfinite = torch.tensor(3, dtype=torch.int32)
    path = save_checkpoint(str(tmp_path), "run", 2, state)
    assert path == checkpoint_path(str(tmp_path), "run", 2) and os.path.isfile(path)
    assert os.listdir(os.path.dirname(path)) == ["run_epoch2"]  # no partial file left

    fresh = _tiny(seed=9, norm_type=norm_type)
    template = create_train_state(fresh, make_optimizer(1e-3), ema=True)
    restored = restore_checkpoint(str(tmp_path), "run", 2, template)
    assert restored is not template
    assert all(restored.params[k] is p for k, p in fresh.named_parameters())
    assert all(restored.batch_stats[k] is b for k, b in fresh.named_buffers())
    assert (norm_type == "batch") == bool(restored.batch_stats)
    _assert_state_equal(restored, state)
    assert int(restored.step) == 2


def test_missing_checkpoint_keeps_the_template(tmp_path):
    template = create_train_state(_tiny(), make_optimizer(1e-3))
    with pytest.warns(UserWarning, match="does not exist"):
        assert restore_checkpoint(str(tmp_path), "run", 1, template) is template
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), "run", 1, template, strict=True)


def test_optimizer_drift_restores_the_rest(tmp_path):
    state = _stepped(_tiny())
    save_checkpoint(str(tmp_path), "noopt", 1, state, include_opt_state=False)
    opt = make_optimizer(1e-3)
    fresh = _tiny(seed=9)
    template = create_train_state(fresh, opt, ema=True)
    with pytest.warns(UserWarning, match="optimizer state structure"):
        restored = restore_checkpoint(str(tmp_path), "noopt", 1, template)
    assert restored.opt_state is template.opt_state and int(restored.opt_state.count) == 0
    assert int(restored.step) == 2
    for k in state.params:
        assert torch.equal(restored.params[k], state.params[k])
        assert torch.equal(restored.ema_params[k], state.ema_params[k])
    # another optimizer's moments (a parameter missing): the same rule
    save_checkpoint(str(tmp_path), "other", 1, state)
    drifted = dataclasses.replace(template.opt_state,
                                  mu=dict(list(template.opt_state.mu.items())[1:]))
    with pytest.warns(UserWarning, match="optimizer state structure"):
        restored = restore_checkpoint(str(tmp_path), "other", 1,
                                      dataclasses.replace(template, opt_state=drifted))
    assert restored.opt_state is drifted


def test_another_model_raises(tmp_path):
    save_checkpoint(str(tmp_path), "run", 1, _stepped(_tiny(), steps=1))
    other = parse_conf_string(TINY.replace("d_hidden = 64", "d_hidden = 32"),
                              base_dir=str(ROOT / "conf"))
    template = create_train_state(make_model(other, dtype=torch.float32, device="cpu"),
                                  make_optimizer(1e-3))
    with pytest.raises(ValueError, match="'params' structure does not match"):
        restore_checkpoint(str(tmp_path), "run", 1, template)


def test_checkpoint_without_ema_seeds_it_from_the_params(tmp_path):
    state = _stepped(_tiny(), steps=1, ema=False)
    save_checkpoint(str(tmp_path), "run", 1, state)
    template = create_train_state(_tiny(seed=9), make_optimizer(1e-3), ema=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        restored = restore_checkpoint(str(tmp_path), "run", 1, template)
    for k, p in restored.params.items():
        assert torch.equal(restored.ema_params[k], state.params[k])
        assert restored.ema_params[k] is not p
    # a template without EMA keeps none, whatever the checkpoint holds
    save_checkpoint(str(tmp_path), "ema", 1, _stepped(_tiny(), steps=1))
    plain = create_train_state(_tiny(seed=9), make_optimizer(1e-3))
    assert restore_checkpoint(str(tmp_path), "ema", 1, plain).ema_params is None


# ---------------------------------------------------------------------------
# a JAX checkpoint carried across
# ---------------------------------------------------------------------------


def _carry(state, port):
    """JAX's restored ``TrainState`` -> the port's, on ``port``'s tensors."""
    load_flax_variables(port, {"params": jax.tree.map(np.asarray, state.params),
                               "batch_stats": jax.tree.map(np.asarray, state.batch_stats)})
    inner = state.opt_state.inner_state[0]
    moments = lambda tree: from_flax_tree(port, {"params": jax.tree.map(np.asarray, tree)})
    opt = AdamState(torch.tensor(int(inner.count), dtype=torch.int32), moments(inner.mu),
                    moments(inner.nu),
                    torch.tensor(int(state.opt_state.total_notfinite), dtype=torch.int32))
    return TrainState(step=torch.tensor(int(state.step), dtype=torch.int32),
                      params=dict(port.named_parameters()),
                      batch_stats=dict(port.named_buffers()), opt_state=opt,
                      ema_params=moments(state.ema_params))


def _jax_metrics(jstate, jmetrics):
    return dict(loss=float(jmetrics["loss"]), grad_norm=float(jmetrics["grad_norm"]),
                p=_leaves(jax.tree.map(np.asarray, jstate.params)),
                stats=_leaves(jstate.batch_stats))


def _port_metrics(state, metrics, port):
    v = to_flax_variables(port)
    return dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                p=_leaves(v["params"]), stats=_leaves(v["batch_stats"]))


def test_jax_checkpoint_carried_across_steps_the_same(tmp_path):
    jmodel, variables, port_fn = _models("VR")
    images, poses, focal, c, model_input, gt = _batch()
    args = (jnp.asarray(images), jnp.asarray(poses), focal, jnp.asarray(c),
            jax.tree.map(jnp.asarray, model_input), jnp.asarray(gt))
    tx = jax_make_optimizer(1e-4)
    jstep = jax_make_train_step(jmodel, tx, JaxLossParams(loss_mode="both"), donate=False,
                                ema_decay=0.9)
    jstate = jax_create_state(jax.tree.map(jnp.asarray, variables), tx, ema=True)
    jstate, _ = jstep(jstate, *args, jax.random.PRNGKey(KEY))
    jax_save(str(tmp_path / "jax"), "VR", 1, jstate)
    template = jax_create_state(jax.tree.map(jnp.asarray, variables), tx, ema=True)
    jstate = jax_restore(str(tmp_path / "jax"), "VR", 1, template)
    assert int(jstate.step) == 1

    port = port_fn()
    state = _carry(jstate, port)
    # the carried state through the port's own checkpoint: bit for bit
    save_checkpoint(str(tmp_path / "port"), "VR", 1, state)
    port2 = port_fn()
    state2 = restore_checkpoint(str(tmp_path / "port"), "VR", 1,
                                create_train_state(port2, make_optimizer(1e-4), ema=True))
    _assert_state_equal(state2, state)

    jnext, jmetrics = jstep(jstate, *args, jax.random.PRNGKey(KEY + 1))
    t = lambda a: torch.from_numpy(np.array(a))
    pargs = (t(images), t(poses), float(focal), t(c), {k: t(v) for k, v in model_input.items()},
             t(gt), (0, KEY + 1))
    results = []
    for p, s in ((port, state), (port2, state2)):
        step = make_train_step(p, make_optimizer(1e-4), LossParams(loss_mode="both"),
                               ema_decay=0.9)
        s, metrics = step(s, *pargs)
        assert int(s.step) == 2 and int(s.opt_state.count) == 2
        results.append((s, _port_metrics(s, metrics, p)))
    # the second step's first moments (0.1 g2 + 0.09 g1) leaf by leaf
    want = _jax_metrics(jnext, jmetrics)
    got = results[0][1]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-3)
    g_port = _leaves(to_flax_tree({k: v for k, v in results[0][0].opt_state.mu.items()})
                     ["params"])
    g_jax = _leaves(jnext.opt_state.inner_state[0].mu)
    for k, w in g_jax.items():
        scale = max(np.abs(w).max(), 1e-12)
        np.testing.assert_allclose(g_port[k], w, rtol=0, atol=DD_TOL * scale, err_msg=k)
    for k, w in want["stats"].items():
        np.testing.assert_allclose(got["stats"][k], w, rtol=0, atol=1e-4, err_msg=k)
    # the port's own restore steps bit for bit the carried state
    a, b = results[0][1], results[1][1]
    assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    for k in a["p"]:
        np.testing.assert_array_equal(a["p"][k], b["p"][k], err_msg=k)


# ---------------------------------------------------------------------------
# the device-data step after a restore
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_sampler(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dd") / "scenes.h5")
    write_synthetic_hdf5(path, num_instances=NI, num_views=NV, side=SIDE, seed=0)
    return jax_make_device_sampler(jax_build_device_dataset(JaxSceneClassDataset(path)), 2, 16)


def _flat(out):
    return [np.asarray(a) for a in (out[0], out[1], out[2], out[3], out[4]["x_pix"],
                                    out[4]["cam2world"], out[4]["intrinsics"], out[5])]


def test_device_data_step_after_restore_draws_jax_batch(tmp_path, jax_sampler):
    model = _tiny()
    opt = make_optimizer(1e-3)
    data = build_device_dataset(SceneClassDataset(synthetic_scene_mapping(NI, NV, SIDE)),
                                device="cpu")
    sampler = make_device_sampler(data, 2, 16)
    drawn = []
    step = make_train_step(model, opt, LossParams(), rng_mode="legacy",
                           sampler=lambda k: drawn.append(sampler(k)) or drawn[-1],
                           sampler_key=threefry.PRNGKey(2))
    state = create_train_state(model, opt, ema=True)
    state, _ = step(state)
    save_checkpoint(str(tmp_path), "run", 1, state)
    state, _ = step(state)
    state, _ = step(state)  # the step's host count is 3 now
    restored = restore_checkpoint(str(tmp_path), "run", 1, state)
    restored, _ = step(restored)
    assert int(restored.step) == 2
    # a count set anew on the same state object, and one changed in place
    restored.step = torch.tensor(6, dtype=torch.int32)
    restored, _ = step(restored)
    restored.step.fill_(9)
    restored, _ = step(restored)
    base = jax.random.PRNGKey(2)
    for got, s in zip(drawn, (0, 1, 2, 1, 6, 9)):
        want = jax_sampler(jax.random.split(jax.random.fold_in(base, s))[0])
        for g, w in zip(_flat(got), _flat(want)):
            np.testing.assert_array_equal(g, w, err_msg=f"step {s}")
