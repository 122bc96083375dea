"""The port's training CLI resumed from a JAX checkpoint, against JAX's CLI.

JAX's CLI (``avr_tpu.cli.train.main``) trains a ``VR_`` run for epoch 1 on
a synthetic HDF5 set (JAX's ``write_synthetic_hdf5``: 4 instances x 4 views
of 32x32) with ``tests/test_cli_and_eval.py``'s tiny conf, the group norm
and EMA 0.9, at JAX's defaults otherwise (``--rng_mode per_ray``, the host
path with ``--prefetch 2``).  Its Orbax ``_epoch1`` is restored by JAX and
carried into the port's checkpoint format under a second root
(``load_flax_variables``, and ``from_flax_tree`` for Adam's moments and the
EMA, as ``test_torch_checkpoint.py`` carries one).  Then both CLIs resume
with ``--starting_epoch 1 --epochs 2``, each under its own root:

* ``--prng_impl threefry2x32``: each step's inputs (source views, rays,
  ground truth) are JAX's bit for bit, the step keys are JAX's raw key data;
  the JSONL train losses match to 2e-5 and the ``_epoch2`` and ``_epoch3``
  parameters to 1e-4 of each leaf's largest value (float32 sums in other
  orders: 8.8e-6 measured).
* ``--prng_impl rbg`` on JAX's side: an rbg key's data is two copies of the
  threefry key of the same seed and steps, and the per-ray hash reads its
  first and last words, so JAX's losses are its threefry run's and the
  port's (which has one key stream for both values of the flag) bit for
  bit; the step inputs too.
* What the port cannot match under rbg: the bits JAX draws from
  ``lax.rng_bit_generator`` (``--rng_mode legacy``, the device-data
  sampler's ``randint``).  Under rbg JAX's ``randint`` and ``uniform`` of a
  key whose data is two copies of the threefry key differ from the port's
  draws, which are JAX's under threefry2x32.

JAX's ``main`` sets ``jax_default_prng_impl`` (and ``jax_debug_nans`` with
``--anomaly_detection``) for the whole process; the fixture restores both,
so later tests in the same worker see JAX's defaults.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from avr_tpu.cli import train as jax_train_cli  # noqa: E402
from avr_tpu.data.synthetic import write_synthetic_hdf5  # noqa: E402
from avr_tpu.training import loop as jloop  # noqa: E402
from avr_tpu.training import restore_checkpoint as jax_restore  # noqa: E402
from avr_tpu_torch.cli import train as cli_train  # noqa: E402
from avr_tpu_torch.models.flax_import import (from_flax_tree, load_flax_variables,  # noqa: E402
                                              to_flax_variables)
from avr_tpu_torch.models.wrapper import make_model  # noqa: E402
from avr_tpu_torch.ops import threefry  # noqa: E402
from avr_tpu_torch.ops.kernels import _build  # noqa: E402
from avr_tpu_torch.training import (AdamState, TrainState, create_train_state,  # noqa: E402
                                    make_optimizer, restore_checkpoint, save_checkpoint)
from avr_tpu_torch.training import loop as tloop  # noqa: E402
from tests.test_cli_and_eval import TINY_CONF  # noqa: E402

torch.set_num_threads(2)

NAME = "VR_resume"
LOSS_TOL, PARAM_TOL = 2e-5, 1e-4
JAX_GLOBALS = ("jax_default_prng_impl", "jax_debug_nans")


def jax_globals():
    return {k: getattr(jax.config, k) for k in JAX_GLOBALS}


def restore_jax_globals(saved):
    for k, v in saved.items():
        jax.config.update(k, v)


def argv(root, conf, data, impl, start, epochs):
    return ["--root_dir", str(root), "--loss_mode", "both", "--renderer", NAME,
            "--starting_epoch", str(start), "--sl", "32", "--batch_size", "2", "--epochs",
            str(epochs), "--epochs_save", "1", "--ray_batch_size", "64",
            "--samples_per_instance", "3", "--steps_print", "1", "--steps_val", "1000000",
            "--norm_type", "group", "--ema_decay", "0.9", "--conf", conf, "--data", data,
            "--prng_impl", impl]


def port_model(conf):
    return make_model(conf, dtype=torch.float32, device="cpu", renderer=NAME, norm_type="group")


def carry(jstate, port) -> TrainState:
    """JAX's restored ``TrainState`` -> the port's, on ``port``'s tensors."""
    load_flax_variables(port, {"params": jax.tree.map(np.asarray, jstate.params),
                               "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)})
    moments = lambda tree: from_flax_tree(port, {"params": jax.tree.map(np.asarray, tree)})
    inner = jstate.opt_state.inner_state[0]
    opt = AdamState(torch.tensor(int(inner.count), dtype=torch.int32), moments(inner.mu),
                    moments(inner.nu),
                    torch.tensor(int(jstate.opt_state.total_notfinite), dtype=torch.int32))
    return TrainState(step=torch.tensor(int(jstate.step), dtype=torch.int32),
                      params=dict(port.named_parameters()),
                      batch_stats=dict(port.named_buffers()), opt_state=opt,
                      ema_params=None if jstate.ema_params is None
                      else moments(jstate.ema_params))


def recording_steps(module, monkeypatch, sink, key_data):
    """Record each host-path train step's inputs and key (``key_data``:
    the key's raw words)."""
    real = module.make_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def recorded(state, *args):
            *inputs, key = args
            src_images, src_poses, focal, c, model_input, gt = inputs
            flat = [src_images, src_poses, focal, c, *(model_input[k] for k in sorted(
                model_input)), gt]
            sink.append(([np.asarray(x) for x in flat], key_data(key)))
            return step(state, *args)

        return recorded

    monkeypatch.setattr(module, "make_train_step", make)


def train_losses(root):
    with open(os.path.join(root, "logs", f"{NAME}.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: r["loss"] for r in recs if r["event"] == "train"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    saved = jax_globals()
    mp = pytest.MonkeyPatch()
    w = tmp_path_factory.mktemp("cli_resume")
    conf = str(w / "tiny.conf")
    with open(conf, "w") as f:
        f.write(TINY_CONF)
    data = write_synthetic_hdf5(str(w / "train.h5"), 4, 4, 32)
    out = {}
    try:
        first = jax_train_cli.main(argv(w / "jax_first", conf, data, "threefry2x32", 0, 1))
        out["globals_set"] = jax_globals()
        restore_jax_globals(saved)
        jstate = jax_restore(str(w / "jax_first"), NAME, 1, first)
        assert int(jstate.step) == 2
        ckpt = os.path.join("checkpoints", "experiments", f"{NAME}_epoch1")
        for impl in ("threefry2x32", "rbg"):
            # JAX resumes from its own _epoch1, the port from the carried one
            shutil.copytree(w / "jax_first" / ckpt, w / f"jax_{impl}" / ckpt)
            save_checkpoint(str(w / f"port_{impl}"), NAME, 1, carry(jstate, port_model(conf)))
            jin, tin = [], []
            with mp.context() as m:
                recording_steps(jloop, m, jin,
                                lambda k: np.asarray(jax.random.key_data(k)).ravel().tolist())
                recording_steps(tloop, m, tin, lambda k: list(k))
                try:
                    jend = jax_train_cli.main(argv(w / f"jax_{impl}", conf, data, impl, 1, 2))
                    out[f"impl_during_{impl}"] = jax.config.jax_default_prng_impl
                finally:
                    restore_jax_globals(saved)
                _build.reset_launches()
                tend = cli_train.main(argv(w / f"port_{impl}", conf, data, impl, 1, 2),
                                      device="cpu")
                assert not _build.launches
            params = {}
            for epoch in (2, 3):
                j = jax_restore(str(w / f"jax_{impl}"), NAME, epoch, jend)
                model = port_model(conf)
                restore_checkpoint(str(w / f"port_{impl}"), NAME, epoch,
                                   create_train_state(model, make_optimizer(1e-4), ema=True),
                                   strict=True)
                params[epoch] = (jax.tree.map(np.asarray, j.params),
                                 to_flax_variables(model)["params"])
            out[impl] = dict(jin=jin, tin=tin, params=params, tstep=int(tend.step),
                             jloss=train_losses(w / f"jax_{impl}"),
                             tloss=train_losses(w / f"port_{impl}"))
    finally:
        mp.undo()
        restore_jax_globals(saved)
    out["saved"] = saved
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
def test_resumed_inputs_and_keys_are_jax(runs, impl):
    r = runs[impl]
    assert len(r["jin"]) == len(r["tin"]) == 4 and r["tstep"] == 6
    for (jx, jk), (tx, tk) in zip(r["jin"], r["tin"]):
        for a, b in zip(jx, tx):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        # an rbg key's data: the threefry key's two words, twice
        assert jk == (tk if impl == "threefry2x32" else tk + tk)


@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
def test_resumed_losses_match_jax(runs, impl):
    r = runs[impl]
    assert sorted(r["jloss"]) == sorted(r["tloss"]) == [3, 4, 5, 6]
    for s, want in r["jloss"].items():
        assert abs(r["tloss"][s] - want) <= LOSS_TOL, (s, r["tloss"][s], want)


@pytest.mark.parametrize("epoch", [2, 3])
def test_resumed_parameters_match_jax(runs, epoch):
    want, got = runs["threefry2x32"]["params"][epoch]
    got = dict(_leaves(got))
    for k, w in _leaves(want):
        scale = max(np.abs(w).max(), 1e-12)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=PARAM_TOL * scale, err_msg=k)


def test_rbg_resume_is_the_threefry_resume_bit_for_bit(runs):
    tf, rbg = runs["threefry2x32"], runs["rbg"]
    assert rbg["jloss"] == tf["jloss"] and rbg["tloss"] == tf["tloss"]
    for (a, _), (b, _) in zip(tf["jin"], rbg["jin"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for epoch in (2, 3):
        for (k, x), (_, y) in zip(_leaves(tf["params"][epoch][0]),
                                  _leaves(rbg["params"][epoch][0])):
            np.testing.assert_array_equal(x, y, err_msg=k)


def test_jax_cli_global_state_is_restored(runs):
    # JAX's main set the process-wide impl during its runs; the fixture put
    # the defaults back
    assert runs["globals_set"]["jax_default_prng_impl"] == "threefry2x32"
    assert runs["impl_during_rbg"] == "rbg"
    assert jax_globals() == runs["saved"]


def test_rbg_bit_generator_draws_are_not_the_ports():
    saved = jax_globals()
    try:
        jax.config.update("jax_default_prng_impl", "rbg")
        k = jax.random.fold_in(jax.random.PRNGKey(5), 3)
        rbg_kd = np.asarray(jax.random.key_data(k)).ravel().tolist()
        rbg_int = np.asarray(jax.random.randint(k, (256,), 0, 819_200))
        rbg_uni = np.asarray(jax.random.uniform(k, (256,)))
        jax.config.update("jax_default_prng_impl", "threefry2x32")
        k = jax.random.fold_in(jax.random.PRNGKey(5), 3)
        tf_int = np.asarray(jax.random.randint(k, (256,), 0, 819_200))
        tf_uni = np.asarray(jax.random.uniform(k, (256,)))
    finally:
        restore_jax_globals(saved)
    key = threefry.fold_in(threefry.PRNGKey(5), 3)
    assert rbg_kd == [*key, *key]  # the same keys
    port_int = threefry.randint(key, (256,), 0, 819_200, "cpu").numpy()
    port_uni = threefry.uniform(key, (256,), "cpu").numpy()
    np.testing.assert_array_equal(port_int, tf_int)
    np.testing.assert_array_equal(port_uni, tf_uni)
    # rng_bit_generator's bits are XLA's: other numbers from the same key
    assert (port_int != rbg_int).mean() > 0.99 and (port_uni != rbg_uni).mean() > 0.99
