"""The port's ``fit`` loop, its validation and ``test_approximate``
against ``avr_tpu``.

* ``fit`` against JAX's ``fit`` on the same HDF5 sets (JAX's
  ``write_synthetic_hdf5``: 4 train instances x 4 views and 2 val instances
  x 3 views of 16x16), the small VR model of ``test_torch_volume.py`` with
  ``norm_type="group"``, EMA 0.999, ``rng_mode="legacy"``, 2 epochs of 2
  steps (SB 2 x 32 rays), validation every 2 steps over 2 scenes, the host
  path (``prefetch=0`` on both sides): each step's assembled inputs are
  JAX's bit for bit; the per-step losses match to ``LOSS_TOL``, the
  gradient norms to ``NORM_TOL`` relative and the val PSNR and SSIM to
  ``PSNR_TOL`` (float32 sums in other orders); the JSONL logs have the same
  events with the same keys; the checkpoint names are JAX's.  The port's
  prefetched stream trains to the same losses bit for bit.  The VR, not the
  adaptive renderer: a few Adam steps through the adaptive renderer's
  march are ill-conditioned (Adam's first update is +-lr for gradient
  elements near zero, whose signs follow float32 rounding, and the march
  amplifies the moved weights): changing only the order of the port's
  GroupNorm sums moved the adaptive fit's step-4 loss by 1.3e-3 and its
  gradient norm by 9% (measured).  ``test_torch_norms.py`` holds the
  adaptive group-norm step to JAX's.
* Resume: a port ``fit`` restored from its ``_epoch1`` checkpoint, and from
  a mid-epoch ``_best`` checkpoint (the epoch's ``skip``), gives the
  uninterrupted run's losses bit for bit, on the device-data path and on
  the prefetched host path.
* ``test_approximate`` with the EMA, 2 source views and the Raymarcher
  (scored coarse-only), with the random-VGG LPIPS archive, against JAX's:
  PSNR, SSIM and loss to ``EVAL_TOL``, ``lpips_rand`` to 1e-4 relative.
  ``LPIPS`` alone against JAX's on random images to 1e-5 relative, and the
  port's ``random_state`` against ``scripts/make_lpips_weights.py``'s bit
  for bit.
"""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from avr_tpu.data.dataset import SceneClassDataset as JaxDataset  # noqa: E402
from avr_tpu.data.synthetic import write_synthetic_hdf5  # noqa: E402
from avr_tpu.evaluation import test_approximate as jax_test_approximate  # noqa: E402
from avr_tpu.training import FitConfig as JaxFitConfig  # noqa: E402
from avr_tpu.training import LossParams as JaxLossParams  # noqa: E402
from avr_tpu.training import create_train_state as jax_create_state  # noqa: E402
from avr_tpu.training import fit as jax_fit  # noqa: E402
from avr_tpu.training import loop as jloop  # noqa: E402
from avr_tpu.training import make_optimizer as jax_make_optimizer  # noqa: E402
from avr_tpu.utils.logging import MetricsLogger as JaxLogger  # noqa: E402
from avr_tpu.utils.lpips import LPIPS as JaxLPIPS  # noqa: E402
from avr_tpu_torch import evaluation  # noqa: E402
from avr_tpu_torch.config import parse_conf_string  # noqa: E402
from avr_tpu_torch.data.dataset import SceneClassDataset  # noqa: E402
from avr_tpu_torch.models.flax_import import from_flax_tree  # noqa: E402
from avr_tpu_torch.models.wrapper import make_model  # noqa: E402
from avr_tpu_torch.ops.kernels import _build  # noqa: E402
from avr_tpu_torch.training import (FitConfig, LossParams, create_train_state,  # noqa: E402
                                    fit, make_optimizer, restore_checkpoint)
from avr_tpu_torch.training import loop as tloop  # noqa: E402
from avr_tpu_torch.utils.logging import MetricsLogger  # noqa: E402
from avr_tpu_torch.utils.lpips import LPIPS, random_state  # noqa: E402
from tests.test_torch_chunked import _models  # noqa: E402
from tests.test_torch_norms import pair  # noqa: E402
from tests.test_torch_rules import ROOT, TINY  # noqa: E402
from tests.test_torch_volume import CONF_VR  # noqa: E402

torch.set_num_threads(2)

SIDE = 16
# float32 sums in other orders over 4 VR steps: the losses differ by up to
# 1.2e-7, the gradient norms by 3e-6 relative, the val PSNR by 1.1e-6 dB
# (measured).  The Raymarcher's test renders are one march a pixel
LOSS_TOL, NORM_TOL, PSNR_TOL, EVAL_TOL = 1e-5, 1e-4, 1e-4, 1e-3


@pytest.fixture(scope="module")
def h5(tmp_path_factory):
    d = tmp_path_factory.mktemp("fit")
    return dict(train=write_synthetic_hdf5(str(d / "train.h5"), 4, 4, SIDE, seed=5),
                val=write_synthetic_hdf5(str(d / "val.h5"), 2, 3, SIDE, seed=6))


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _recorder(module, monkeypatch, sink):
    real = module._epoch_inputs

    def recording(*args, **kw):
        for gstep, inputs in real(*args, **kw):
            sink.append((gstep, inputs))
            yield gstep, inputs

    monkeypatch.setattr(module, "_epoch_inputs", recording)


CFG = dict(epochs=2, batch_size=2, ray_batch_size=32, steps_print=1, steps_val=2,
           val_scenes=2, render_chunk=128, rng_mode="legacy", ema_decay=0.999, seed=3,
           prefetch=0)


@pytest.fixture(scope="module")
def fits(h5, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("runs")
    jmodel, variables, port_fn = pair("group", conf=CONF_VR, renderer="VR")
    tx = jax_make_optimizer(1e-4)
    jstate = jax_create_state(jax.tree.map(jnp.asarray, variables), tx, ema=True)
    jin, tin = [], []
    _recorder(jloop, mp, jin)
    _recorder(tloop, mp, tin)
    try:
        jstate, jlosses = jax_fit(jmodel, jstate, tx, JaxDataset(h5["train"]),
                                  JaxDataset(h5["val"]), JaxLossParams(),
                                  JaxFitConfig(save_root=str(root / "jax"), **CFG),
                                  logger=JaxLogger(str(root / "jax" / "logs"), stdout=False))
        runs = {}
        for name, prefetch in (("sync", 0), ("prefetch", 2)):
            port = port_fn()
            opt = make_optimizer(1e-4)
            _build.reset_launches()
            state, losses = fit(port, create_train_state(port, opt, ema=True), opt,
                                SceneClassDataset(h5["train"]), SceneClassDataset(h5["val"]),
                                LossParams(),
                                FitConfig(save_root=str(root / name),
                                          **dict(CFG, prefetch=prefetch)),
                                logger=MetricsLogger(str(root / name / "logs"), stdout=False),
                                device="cpu")
            assert not _build.launches
            runs[name] = dict(state=state, losses=losses,
                              log=_records(root / name / "logs" / "train.jsonl"))
    finally:
        mp.undo()
    return dict(jlosses=jlosses, jstate=jstate, jin=jin, tin=tin, runs=runs, root=root,
                jlog=_records(root / "jax" / "logs" / "train.jsonl"))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.numpy()
    return np.asarray(a)


def test_fit_assembles_jax_inputs(fits):
    jin, tin = fits["jin"], fits["tin"]
    assert [g for g, _ in tin] == [g for g, _ in jin] == [0, 1, 2, 3]
    for (_, t), (_, j) in zip(tin, jin):
        flat = lambda x: [x[0], x[1], x[2], x[3], *x[4].values(), x[5]]
        assert list(t[4]) == list(j[4])
        for a, b in zip(flat(t), flat(j)):
            assert _np(a).dtype == _np(b).dtype
            np.testing.assert_array_equal(_np(a), _np(b))


def test_fit_losses_and_val_match_jax(fits):
    jlog, tlog = fits["jlog"], fits["runs"]["sync"]["log"]
    assert [r["event"] for r in tlog] == [r["event"] for r in jlog]
    assert [sorted(r) for r in tlog] == [sorted(r) for r in jlog]
    for t, j in zip(tlog, jlog):
        assert t.get("step") == j.get("step") and t.get("epoch") == j.get("epoch")
        if t["event"] == "train":
            np.testing.assert_allclose(t["loss"], j["loss"], rtol=0, atol=LOSS_TOL)
            np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=NORM_TOL)
        elif t["event"] == "val":
            np.testing.assert_allclose(t["psnr"], j["psnr"], rtol=0, atol=PSNR_TOL)
            np.testing.assert_allclose(t["ssim"], j["ssim"], rtol=0, atol=PSNR_TOL)
            np.testing.assert_allclose(t["loss"], j["loss"], rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(fits["runs"]["sync"]["losses"], fits["jlosses"], rtol=0,
                               atol=LOSS_TOL)
    assert int(fits["runs"]["sync"]["state"].step) == int(fits["jstate"].step) == 4


def test_fit_checkpoint_names_match_jax(fits):
    names = {}
    for run in ("jax", "sync"):
        d = fits["root"] / run / "checkpoints" / "experiments"
        names[run] = sorted(os.listdir(d))
    assert names["sync"] == names["jax"] == ["run_best", "run_epoch2"]
    paths = [r["path"] for r in fits["runs"]["sync"]["log"] if r["event"] == "checkpoint"]
    assert [os.path.basename(p) for p in paths][-1] == "run_epoch2"


def test_fit_prefetch_trains_the_same(fits):
    a, b = fits["runs"]["sync"], fits["runs"]["prefetch"]
    assert a["losses"] == b["losses"]
    la = [(r["event"], r.get("loss"), r.get("psnr")) for r in a["log"]]
    lb = [(r["event"], r.get("loss"), r.get("psnr")) for r in b["log"]]
    assert la == lb


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------


def _tiny():
    conf = parse_conf_string(TINY, base_dir=str(ROOT / "conf"))
    return make_model(conf, dtype=torch.float32, seed=1, device="cpu", norm_type="group")


def _losses(log):
    return {r["step"]: r["loss"] for r in log if r["event"] == "train"}


@pytest.mark.parametrize("path", ["device_data", "prefetch"])
def test_resumed_fit_equals_the_uninterrupted_run(h5, tmp_path, path):
    """4 steps an epoch (SB 1); validation every 3 steps with every val
    saving ``_best`` (so ``_best`` is step 6, mid-epoch 2)."""
    cfg = FitConfig(epochs=2, batch_size=1, ray_batch_size=16, steps_print=1, steps_val=3,
                    val_scenes=1, render_chunk=128, rng_mode="legacy", ema_decay=0.9, seed=7,
                    epochs_save=1, best_margin=-1e9, device_data=path == "device_data",
                    prefetch=2)
    train, val = SceneClassDataset(h5["train"]), SceneClassDataset(h5["val"])

    def run(name, epochs, restore=None):
        model = _tiny()
        opt = make_optimizer(1e-3)
        state = create_train_state(model, opt, ema=True)
        if restore is not None:
            state = restore_checkpoint(str(tmp_path / "full"), "run", restore, state,
                                       strict=True)
        fit(model, state, opt, train, val, LossParams(),
            dataclasses.replace(cfg, epochs=epochs, save_root=str(tmp_path / name)),
            logger=MetricsLogger(str(tmp_path / name / "logs"), stdout=False), device="cpu")
        return _losses(_records(tmp_path / name / "logs" / "train.jsonl"))

    full = run("full", 2)
    assert sorted(full) == list(range(1, 9))
    from_epoch = run("epoch", 1, restore=1)
    from_best = run("best", 1, restore="best")
    assert sorted(from_epoch) == [5, 6, 7, 8] and sorted(from_best) == [7, 8]
    for part in (from_epoch, from_best):
        for s, loss in part.items():
            assert loss == full[s], (s, loss, full[s])


# ---------------------------------------------------------------------------
# test_approximate and LPIPS
# ---------------------------------------------------------------------------


def _script_random_state():
    spec = importlib.util.spec_from_file_location(
        "make_lpips_weights", ROOT / "scripts" / "make_lpips_weights.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.random_state


@pytest.fixture(scope="module")
def lpips_archive(tmp_path_factory):
    state = random_state(3)
    want = _script_random_state()(3)
    assert state.keys() == want.keys()
    for k in want:
        assert state[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(state[k], want[k], err_msg=k)
    path = str(tmp_path_factory.mktemp("lpips") / "lpips_rand.npz")
    np.savez(path, **state)
    return path


def test_lpips_matches_jax(lpips_archive):
    rng = np.random.default_rng(4)
    a, b = (rng.uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    want = JaxLPIPS(lpips_archive)(a, b)
    port = LPIPS(lpips_archive, device="cpu")
    assert not port.calibrated
    np.testing.assert_allclose(port(a, b), want, rtol=1e-5)
    np.testing.assert_allclose(port(torch.from_numpy(a), b), want, rtol=1e-5)


def test_test_approximate_matches_jax(h5, lpips_archive):
    jmodel, variables, port_fn = _models("Raymarcher")
    rng = np.random.default_rng(8)
    tx = jax_make_optimizer(1e-4)
    jstate = jax_create_state(jax.tree.map(jnp.asarray, variables), tx, ema=True)
    ema = jax.tree.map(lambda a: np.asarray(a) * rng.uniform(0.9, 1.1, size=a.shape)
                       .astype(np.float32), variables["params"])
    jstate = jstate.replace(ema_params=jax.tree.map(jnp.asarray, ema))
    kw = dict(lpips_weights=lpips_archive, render_chunk=128, seed=2, max_instances=3,
              use_ema=True, num_source_views=2)
    want = jax_test_approximate(jmodel, jstate, JaxDataset(h5["train"], samples_per_instance=4),
                                JaxLossParams(), **kw)
    port = port_fn()
    state = create_train_state(port, make_optimizer(1e-4), ema=True)
    state.ema_params = from_flax_tree(port, {"params": ema})
    raw = {k: p.detach().clone() for k, p in state.params.items()}
    _build.reset_launches()
    got = evaluation.test_approximate(port, state, SceneClassDataset(h5["train"],
                                                                     samples_per_instance=4),
                                      LossParams(), device="cpu", **kw)
    assert not _build.launches
    assert got.keys() == want.keys() == {"psnr", "ssim", "loss", "count", "lpips_rand"}
    assert got["count"] == want["count"] == 3
    for k in ("psnr", "ssim", "loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=EVAL_TOL, err_msg=k)
    np.testing.assert_allclose(got["lpips_rand"], want["lpips_rand"], rtol=1e-4)
    for k, p in state.params.items():  # the raw weights are back
        assert torch.equal(p, raw[k]), k
    # without the EMA the result moves
    plain = evaluation.test_approximate(port, state, SceneClassDataset(h5["train"],
                                                                       samples_per_instance=4),
                                        LossParams(), device="cpu",
                                        **dict(kw, use_ema=False, lpips_weights=None))
    assert plain["psnr"] != got["psnr"]
