"""The port's multi-process runtime (``avr_tpu_torch/parallel/multihost.py``)
and ``fit`` over a mesh of ranks, on gloo ranks spawned from the test files
(``tests/test_torch_parallel.py``'s ``start_ranks``: torch at one thread a
rank, a ``FileStore`` rendezvous, every join bounded).

* ``initialize``'s fail-loud contract, as ``tests/test_multiprocess.py``
  pins JAX's (``torch.distributed.init_process_group`` monkeypatched): the
  bare call with no cluster configuration stays single-process; an explicit
  ``world_size > 1``, an explicit ``init_method``, a launcher's environment
  or ``MASTER_ADDR`` raise on failure; an initialised group and a world of
  one return at once.  The backend follows the device (NCCL for CUDA, gloo
  for the CPU) unless named, and the default device is the card.
* ``gather_metrics`` (the mean over ranks) and ``assemble_eval_image`` (a
  rays-sharded render, whole, on every rank, at meshes (1, 2), (2, 1) and
  (2, 2)); single-process both pass through.
* A two-rank ``fit`` over a (2, 1) mesh: the ranks' dataset shards are
  disjoint and cover the set; the losses and the whole train state are the
  same bits on both ranks; only the primary logs and writes checkpoints
  (JAX's names); a resume from ``_epoch1`` is the uninterrupted run bit for
  bit; and a (1, 2) mesh under ``step_impl="gspmd"`` trains too.
* ``fit``'s mesh checks (JAX's): ``device_data``, a batch the data axis
  does not divide, a ray batch the rays axis does not divide, an unknown
  ``step_impl``.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import digest, join_ranks, start_ranks

torch.set_num_threads(2)

TINY = """
include required("default_mv.conf")
model {
    encoder { num_layers = 2 }
    mlp_coarse { d_hidden = 32
                 n_blocks = 2
                 combine_layer = 1 }
    mlp_fine { d_hidden = 32
               n_blocks = 2
               combine_layer = 1 }
}
adaptive_renderer { raymarch_steps = 2
                    n_coarse = 3 }
"""
CONF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "conf")
INSTANCES, VIEWS, SIDE = 8, 3, 16


# ---------------------------------------------------------------------------
# initialize
# ---------------------------------------------------------------------------

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def boom(monkeypatch):
    """``init_process_group`` that fails, the environment clear of any
    cluster configuration; returns the calls' backends."""
    import torch.distributed as dist

    calls = []

    def fail(backend, **kw):
        calls.append(backend)
        raise RuntimeError("rendezvous unreachable")

    monkeypatch.setattr(dist, "init_process_group", fail)
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    return calls


def test_initialize_bare_call_stays_single_process(boom):
    from avr_tpu_torch.parallel import multihost

    multihost.initialize(device="cpu")
    multihost.initialize(world_size=1, rank=0, backend="gloo")
    assert not boom
    assert (multihost.process_index(), multihost.process_count(), multihost.is_primary()) == (
        0, 1, True)
    assert not multihost.launched()


@pytest.mark.parametrize("request_", ["world_size", "init_method", "launcher", "master_addr"])
def test_initialize_fails_loud_when_asked_for_processes(boom, monkeypatch, request_):
    from avr_tpu_torch.parallel import multihost

    kw = {"world_size": dict(world_size=2, rank=0),
          "init_method": dict(init_method="tcp://127.0.0.1:1")}.get(request_, {})
    if request_ == "launcher":
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("WORLD_SIZE", "2")
        assert multihost.launched()
    if request_ == "master_addr":
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(RuntimeError, match="unreachable"):
        multihost.initialize(device="cpu", **kw)
    assert boom == ["gloo"]


def test_initialize_is_idempotent_once_joined(boom, monkeypatch):
    import torch.distributed as dist

    from avr_tpu_torch.parallel import multihost

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    multihost.initialize(world_size=2, rank=0, device="cpu")
    assert not boom


def test_initialize_backend_follows_the_device(boom, monkeypatch):
    from avr_tpu_torch.parallel import multihost

    for kw, want in ((dict(device="cpu"), "gloo"), (dict(device="cuda"), "nccl"),
                     (dict(device="cuda", backend="gloo"), "gloo")):
        boom.clear()
        with pytest.raises(RuntimeError, match="unreachable"):
            multihost.initialize(world_size=2, rank=0, **kw)
        assert boom == [want], kw
    assert multihost.backend_for("cuda:1") == "nccl" and multihost.backend_for("cpu") == "gloo"
    assert multihost.comm_device() == torch.device("cpu")
    # the default device is the card: none, no backend
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    boom.clear()
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.initialize(world_size=2, rank=0)
    assert not boom


def test_single_process_metrics_and_image_pass_through():
    from avr_tpu_torch.parallel import make_mesh, multihost

    assert multihost.gather_metrics({"loss": torch.tensor(0.25), "n": 3}) == {
        "loss": 0.25, "n": 3.0}
    img = np.random.default_rng(0).normal(size=(2, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(multihost.assemble_eval_image(torch.from_numpy(img)), img)
    np.testing.assert_array_equal(multihost.assemble_eval_image(img, make_mesh()), img)
    multihost.barrier()


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------


def _image():
    return np.random.default_rng(5).normal(size=(4, 12, 3)).astype(np.float32)


def _collective_ranks(rank, world, tmp):
    from avr_tpu_torch.parallel import make_mesh, multihost, ray_sharding

    out = dict(gather=multihost.gather_metrics({"m": float(rank), "k": 2.0 * rank}),
               index=multihost.process_index(), count=multihost.process_count())
    shapes = [(1, world), (world, 1)] + ([(2, 2)] if world == 4 else [])
    for shape in shapes:
        mesh = make_mesh(shape)
        block = ray_sharding(mesh, 3)(torch.from_numpy(_image()))
        out[shape] = multihost.assemble_eval_image(block, mesh)
    multihost.barrier()
    with open(os.path.join(tmp, f"collective_{world}_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


class _Recorder:
    """A logger that keeps its records (the fit's own, on every rank)."""

    def __init__(self):
        self.records = []

    def log(self, event, **kw):
        self.records.append(dict(event=event, **{k: v for k, v in kw.items() if k != "path"}))


def _fit_once(rank, tmp, root, epochs, mesh_shape, step_impl="shardmap", restore=None):
    from avr_tpu_torch.config import parse_conf_string
    from avr_tpu_torch.data.dataset import SceneClassDataset
    from avr_tpu_torch.data.synthetic import synthetic_scene_mapping
    from avr_tpu_torch.models.wrapper import make_model
    from avr_tpu_torch.parallel import make_mesh
    from avr_tpu_torch.training import (FitConfig, LossParams, create_train_state, fit,
                                        make_optimizer, restore_checkpoint)

    model = make_model(parse_conf_string(TINY, base_dir=CONF_DIR), dtype=torch.float32,
                       seed=6, device="cpu", norm_type="group")
    opt = make_optimizer(1e-3)
    state = create_train_state(model, opt, ema=True)
    if restore is not None:
        state = restore_checkpoint(restore, "run", 1, state)
    train = SceneClassDataset(synthetic_scene_mapping(INSTANCES, VIEWS, SIDE), shard_index=rank,
                              num_shards=2, samples_per_instance=2)
    val = SceneClassDataset(synthetic_scene_mapping(1, 2, SIDE, seed=1),
                            specific_observation_idcs=[0], samples_per_instance=2)
    cfg = FitConfig(epochs=epochs, batch_size=2, ray_batch_size=16, steps_print=1,
                    steps_val=2, val_scenes=1, render_chunk=64, epochs_save=1, prefetch=2,
                    save_root=root, step_impl=step_impl)
    log = _Recorder()
    state, losses = fit(model, state, opt, train, val, LossParams(), cfg, log,
                        mesh=make_mesh(mesh_shape), device="cpu")
    return dict(instances=list(train.instance_keys), losses=losses, digest=digest(state),
                step=int(state.step), records=log.records)


def _fit_ranks(rank, world, tmp):
    root = os.path.join(tmp, f"rank{rank}")
    out = dict(full=_fit_once(rank, tmp, root, 2, (2, 1)),
               # every rank restores the primary's checkpoint
               resume=_fit_once(rank, tmp, os.path.join(tmp, f"resume{rank}"), 1, (2, 1),
                                restore=os.path.join(tmp, "rank0")),
               gspmd=_fit_once(rank, tmp, os.path.join(tmp, f"gspmd{rank}"), 1, (1, 2),
                               step_impl="gspmd"))
    with open(os.path.join(tmp, f"fit_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("multihost"))
    join_ranks(start_ranks(_collective_ranks, 2, (tmp,)), start_ranks(_collective_ranks, 4, (tmp,)),
               start_ranks(_fit_ranks, 2, (tmp,)))

    def load(name):
        with open(os.path.join(tmp, name), "rb") as f:
            return pickle.load(f)

    return dict(tmp=tmp, collective={w: [load(f"collective_{w}_{r}.pkl") for r in range(w)]
                                     for w in (2, 4)},
                fit=[load(f"fit_{r}.pkl") for r in range(2)])


@pytest.mark.parametrize("world", [2, 4])
def test_gather_metrics_is_the_mean_over_ranks(ranks, world):
    for r, out in enumerate(ranks["collective"][world]):
        assert (out["index"], out["count"]) == (r, world)
        assert out["gather"] == {"m": (world - 1) / 2, "k": float(world - 1)}


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (1, 4), (4, 1), (2, 2)])
def test_assemble_eval_image_gathers_the_blocks(ranks, shape):
    world = shape[0] * shape[1]
    for out in ranks["collective"][world]:
        np.testing.assert_array_equal(out[shape], _image())


def test_fit_shards_the_instances(ranks):
    a, b = (set(f["full"]["instances"]) for f in ranks["fit"])
    assert a.isdisjoint(b) and len(a | b) == INSTANCES


def test_fit_ranks_agree_bit_for_bit(ranks):
    r0, r1 = ranks["fit"]
    for run in ("full", "resume", "gspmd"):
        assert r0[run]["losses"] == r1[run]["losses"], run
        assert r0[run]["digest"] == r1[run]["digest"], run
        assert all(np.isfinite(r0[run]["losses"])), run
    # 4 instances a shard, a global batch of 2: 2 steps an epoch
    assert (r0["full"]["step"], r0["resume"]["step"], r0["gspmd"]["step"]) == (4, 4, 2)


def test_fit_logs_and_checkpoints_from_the_primary_only(ranks):
    r0, r1 = ranks["fit"]
    events = [r["event"] for r in r0["full"]["records"]]
    assert events.count("train") == 4 and events.count("val") == 2
    assert {"checkpoint"} <= set(events)
    assert not r1["full"]["records"] and not r1["resume"]["records"]
    tmp = ranks["tmp"]
    assert sorted(os.listdir(os.path.join(tmp, "rank0", "checkpoints", "experiments"))) == [
        "run_best", "run_epoch1", "run_epoch2"]
    assert not os.path.exists(os.path.join(tmp, "rank1", "checkpoints"))


def test_fit_resume_is_the_uninterrupted_run(ranks):
    for r in ranks["fit"]:
        assert r["resume"]["digest"] == r["full"]["digest"]
        assert r["resume"]["losses"] == r["full"]["losses"][1:]


@pytest.mark.parametrize("bad", ["device_data", "batch", "rays", "step_impl"])
def test_fit_mesh_checks(bad, tmp_path):
    from avr_tpu_torch.data.dataset import SceneClassDataset
    from avr_tpu_torch.data.synthetic import synthetic_scene_mapping
    from avr_tpu_torch.parallel.mesh import Mesh
    from avr_tpu_torch.training import FitConfig, LossParams, create_train_state, fit
    from avr_tpu_torch.training import make_optimizer
    from avr_tpu_torch.config import parse_conf_string
    from avr_tpu_torch.models.wrapper import make_model

    model = make_model(parse_conf_string(TINY, base_dir=CONF_DIR), dtype=torch.float32,
                       seed=6, device="cpu", norm_type="group")
    opt = make_optimizer(1e-3)
    state = create_train_state(model, opt)
    kw = dict(device_data=dict(device_data=True), batch=dict(batch_size=3),
              rays=dict(ray_batch_size=15), step_impl=dict(step_impl="pjit"))[bad]
    cfg = FitConfig(**{**dict(epochs=1, batch_size=2, ray_batch_size=16,
                              save_root=str(tmp_path)), **kw})
    # a (2, 2) mesh seen from its rank 0; the checks come before any collective
    mesh = Mesh({"data": 2, "rays": 2}, ("data", "rays"), 0, grouped=False)
    match = {"device_data": "single-device", "batch": "batch_size 3",
             "rays": "ray_batch_size 15", "step_impl": "pjit"}[bad]
    with pytest.raises(ValueError, match=match):
        fit(model, state, opt, SceneClassDataset(synthetic_scene_mapping(2, 2, SIDE)), None,
            LossParams(), cfg, mesh=mesh, device="cpu")
    assert int(state.step) == 0 and not (tmp_path / "checkpoints").exists()
