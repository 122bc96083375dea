"""The port's command-line entry points (``avr_tpu_torch/cli``) and demo
against ``avr_tpu/cli``.

* Flags: ``cli.train.build_parser()`` has the option strings, choices,
  defaults, types and required flags of ``avr_tpu.cli.train.build_parser()``;
  the test and video CLIs' parsers (built inside JAX's ``main``, read here by
  catching the parser at ``parse_args``) too, and each CLI's ``--help`` lists
  the same options.
* Refusals: the three values that select JAX's XLA path beside a kernel
  (``--fused_mlp never``, ``--fused_march never``, ``--gather_impl xla``)
  raise from one table (``models/pixelnerf.py XLA_ONLY``) before anything
  is written; ``--bn`` trains the decoders' BatchNorm (its parity with Flax
  is ``test_torch_model_options.py``'s); ``main()`` of each CLI without a
  CUDA device raises instead of running on the CPU.
* The parallel flags: ``--mesh 1,1``, ``--step_impl gspmd``, both, and
  ``--multihost`` without a launcher run one process, bit for bit the run
  without them; a mesh the ranks do not fill raises, as JAX's does; two gloo
  ranks (spawned from this file) of ``--multihost --mesh 1,2`` end with the
  same parameters, the primary's log and JAX's checkpoint names (as JAX's
  ``tests/test_fit_mesh_resume.py`` drives ``--mesh``).
* An adaptive run on the CPU (the JAX CLI test's settings, plus
  ``--profile_dir`` and ``--ema_decay``) writes JAX's checkpoint names, log
  events with JAX's keys, the losses plot (or, without matplotlib, the
  losses as JSON) and a chrome trace the analyzer reads; ``cli.test`` and
  ``cli.video`` run on its checkpoints.
* The train CLI's model flags reach the model: ``--encoder_weights`` (a
  torchvision-layout archive of seeded draws: the trunk holds the archive's
  tensors when ``fit`` starts; another encoder's archive and a norm other
  than batch raise), ``--sigma_bias_init``, ``--raymarch_steps``,
  ``--lr_schedule cosine`` over ``--schedule_total_epochs``, and
  ``--anomaly_detection`` (on during ``fit``, restored after).

The demo's tests are in ``test_torch_demo.py``, the resume against JAX's
CLI in ``test_torch_cli_resume.py``, ``cli.test`` and ``cli.video`` against
JAX's in ``test_torch_cli_eval.py``.
"""

import argparse
import contextlib
import io
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from avr_tpu.cli import test as jax_test_cli
from avr_tpu.cli import train as jax_train_cli
from avr_tpu.cli import video as jax_video_cli
from avr_tpu_torch.cli import test as cli_test
from avr_tpu_torch.cli import train as cli_train
from avr_tpu_torch.cli import video as cli_video
from avr_tpu_torch.data.synthetic import synthetic_scene_mapping
from avr_tpu_torch.models.resnet import RESNET_STAGES
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.profiling.analyze import busy_share, op_breakdown
from tests.test_cli_and_eval import TINY_CONF

torch.set_num_threads(2)

SIDE = 32
NAME = "AVR_citest"


@pytest.fixture(scope="module")
def conf_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("conf") / "tiny.conf"
    p.write_text(TINY_CONF)
    return str(p)


@pytest.fixture(scope="module")
def sets():
    """The JAX CLI test's sets (2 x 4 and 1 x 4 views of 32x32), in memory."""
    return dict(train=synthetic_scene_mapping(2, 4, SIDE),
                val=synthetic_scene_mapping(1, 4, SIDE, seed=7))


def train_args(root, conf, *extra, name=NAME, epochs=2, start=0):
    """The JAX CLI test's training flags (``tests/test_cli_and_eval.py``)."""
    return ["--root_dir", str(root), "--loss_mode", "both", "--renderer", name,
            "--starting_epoch", str(start), "--sl", str(SIDE), "--batch_size", "2",
            "--epochs", str(epochs), "--epochs_save", "1", "--ray_batch_size", "64",
            "--samples_per_instance", "3", "--steps_print", "1", "--steps_val", "1000000",
            "--norm_type", "group", "--conf", conf, *extra]


def run_train(argv, sets, **kw):
    return cli_train.run(cli_train.build_parser().parse_args(argv), device="cpu",
                         train_source=sets["train"], val_source=sets.get("val"), **kw)


# ---------------------------------------------------------------------------
# flags
# ---------------------------------------------------------------------------


class _Caught(Exception):
    pass


def jax_parser(main, monkeypatch):
    """The parser JAX's ``main`` builds, caught at ``parse_args``."""
    box = []

    def catch(self, args=None, namespace=None):
        box.append(self)
        raise _Caught

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(_Caught):
            main([])
    return box[0]


def _flags(parser):
    return {a.dest: dict(options=tuple(a.option_strings), choices=a.choices, default=a.default,
                         required=a.required, type=a.type, nargs=a.nargs, const=a.const,
                         action=type(a).__name__)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def _help_options(main_or_parser):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        if isinstance(main_or_parser, argparse.ArgumentParser):
            main_or_parser.parse_args(["--help"])
        else:
            main_or_parser(["--help"])
    return set(re.findall(r"(?<![\w-])--\w+", out.getvalue().split("options:")[-1]))


@pytest.mark.parametrize("name", ["train", "test", "video"])
def test_flags_match_jax(name, monkeypatch):
    port = {"train": cli_train, "test": cli_test, "video": cli_video}[name].build_parser()
    if name == "train":
        want = jax_train_cli.build_parser()
    else:
        want = jax_parser({"test": jax_test_cli, "video": jax_video_cli}[name].main, monkeypatch)
    got_flags, want_flags = _flags(port), _flags(want)
    assert got_flags.keys() == want_flags.keys()
    for dest, w in want_flags.items():
        assert got_flags[dest] == w, dest
    jax_main = jax_train_cli.main if name == "train" else want
    assert _help_options(port) == _help_options(jax_main)


def test_train_defaults_are_jax_defaults():
    opt = cli_train.build_parser().parse_args(
        ["--root_dir", "r", "--loss_mode", "both", "--renderer", "AVR", "--starting_epoch", "0"])
    assert (opt.dtype, opt.rng_mode, opt.prng_impl, opt.prefetch, opt.ray_batch_size,
            opt.norm_type, opt.gather_impl, opt.fused_mlp, opt.fused_march, opt.step_impl) == (
        "f32", "per_ray", "rbg", 2, 512, "batch", "auto", "auto", "auto", "shardmap")


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

REFUSED = {
    "fused_mlp_never": ["--fused_mlp", "never"],
    "fused_march_never": ["--fused_march", "never"],
    "gather_impl_xla": ["--gather_impl", "xla"],
}


@pytest.mark.parametrize("case", REFUSED)
def test_refused_flags_raise(case, tmp_path, conf_path, sets):
    with pytest.raises(NotImplementedError, match="one implementation on the card"):
        run_train(train_args(tmp_path, conf_path, *REFUSED[case]), sets)
    assert not (tmp_path / "checkpoints").exists() and not (tmp_path / "logs").exists()


def test_bn_flag_trains_the_decoder_batchnorm(tmp_path, conf_path, sets):
    """``--bn``, refused until the decoders' BatchNorm was ported: it reaches
    both decoders, whose statistics train with the run and are saved with
    the encoder's."""
    from avr_tpu_torch.models.mlp import PointBatchNorm

    state = run_train(train_args(tmp_path, conf_path, "--bn", epochs=1), sets)
    stats = {k: v for k, v in state.batch_stats.items() if ".bn_0." in k}
    assert {k.split(".")[1] for k in stats} == {"mlp_coarse", "mlp_fine"}
    assert all(not torch.equal(v, torch.zeros_like(v) if k.endswith("mean")
                               else torch.ones_like(v)) for k, v in stats.items())
    saved = torch.load(tmp_path / "checkpoints" / "experiments" / f"{NAME}_epoch1",
                       weights_only=True)["batch_stats"]
    assert all(torch.equal(saved[k], v.cpu()) for k, v in stats.items())
    assert PointBatchNorm.over == "points"


@pytest.mark.parametrize("name", ["train", "test", "video"])
def test_main_without_cuda_raises(name, monkeypatch, tmp_path, conf_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"train": train_args(tmp_path, conf_path),
            "test": ["--root_dir", str(tmp_path), "--renderer", NAME, "--epoch", "1",
                     "--data", "none.h5"],
            "video": ["--root_dir", str(tmp_path), "--renderer", NAME, "--epoch", "1",
                      "--data", "none.h5"]}[name]
    main = {"train": cli_train, "test": cli_test, "video": cli_video}[name].main
    _build.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
    assert not _build.launches and not (tmp_path / "logs").exists()


# ---------------------------------------------------------------------------
# an adaptive run and its artifacts
# ---------------------------------------------------------------------------

# JAX's log records (avr_tpu/training/loop.py): each event's keys
LOG_KEYS = {"train": [{"event", "t", "epoch", "step", "loss", "grad_norm", "rays_per_s"}],
            "checkpoint": [{"event", "t", "epoch", "path"},
                           {"event", "t", "epoch", "step", "path", "best_psnr"}],
            "val": [{"event", "t", "epoch", "step", "loss", "psnr", "ssim"}]}


@pytest.fixture(scope="module")
def adaptive_run(tmp_path_factory, conf_path, sets):
    root = tmp_path_factory.mktemp("adaptive")
    _build.reset_launches()
    state = run_train(train_args(root, conf_path, "--profile_dir", str(root / "prof"),
                                 "--ema_decay", "0.9", "--steps_val", "1"), sets)
    assert not _build.launches and _build._lib is None
    return root, state


def test_adaptive_run_writes_jax_artifacts(adaptive_run):
    from avr_tpu.training.checkpoint import checkpoint_path as jax_checkpoint_path

    root, state = adaptive_run
    assert int(state.step) == 2 and state.ema_params is not None
    for tag in (1, 2, "best"):
        path = jax_checkpoint_path(str(root), NAME, tag)
        assert os.path.isfile(path), path
    with open(root / "logs" / f"{NAME}.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert {r["event"] for r in records} == set(LOG_KEYS)
    for r in records:
        assert set(r) in LOG_KEYS[r["event"]], r
    assert (root / "logs" / f"losses_{NAME}_epoch0.png").stat().st_size > 0


def test_profile_dir_trace_reads_back(adaptive_run):
    root, _ = adaptive_run
    files = os.listdir(root / "prof")
    assert files == [f"{NAME}.pt.trace.json"]
    rows = op_breakdown(str(root / "prof"))
    assert rows and all(us >= 0 and n > 0 for _, us, n in rows)
    assert any(name.startswith("aten::") for name, _, _ in rows)
    b = busy_share(str(root / "prof"))
    assert b["busy_us"] is None and b["window_us"] > 0  # a CPU trace: no device lane


def test_test_and_video_clis_run_on_its_checkpoints(adaptive_run, conf_path, sets, tmp_path):
    root, _ = adaptive_run
    common = ["--root_dir", str(root), "--renderer", NAME, "--sl", str(SIDE), "--norm_type",
              "group", "--conf", conf_path, "--data", "<in memory>"]
    res = cli_test.run(cli_test.build_parser().parse_args(common + ["--epoch", "best",
                                                                    "--use_ema"]),
                       device="cpu", data_source=sets["val"])
    assert res["count"] == 1 and all(np.isfinite(res[k]) for k in ("psnr", "ssim", "loss"))
    out = str(tmp_path / "orbit.mp4")
    frames = cli_video.run(cli_video.build_parser().parse_args(
        common + ["--epoch", "2", "--num_frames", "2", "--out", out]), device="cpu",
        data_source=sets["val"])
    assert len(frames) == 2 and frames[0].shape == (SIDE, SIDE, 3)
    assert frames[0].dtype == np.uint8
    assert os.path.exists(out) or os.path.exists(str(tmp_path / "orbit.npz"))
    with pytest.raises(FileNotFoundError):  # a strict restore
        cli_test.run(cli_test.build_parser().parse_args(common + ["--epoch", "7"]),
                     device="cpu", data_source=sets["val"])


def test_losses_as_json_without_matplotlib(tmp_path, conf_path, sets, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    run_train(train_args(tmp_path, conf_path, epochs=1), sets)
    logs = sorted(os.listdir(tmp_path / "logs"))
    assert logs == [f"{NAME}.jsonl", f"losses_{NAME}_epoch0.json"]
    with open(tmp_path / "logs" / f"losses_{NAME}_epoch0.json") as f:
        saved = json.load(f)
    assert saved["start_epoch"] == 0 and len(saved["mean_losses"]) == 1
    assert "matplotlib unavailable" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the model flags reach the model
# ---------------------------------------------------------------------------


def at_fit_start(monkeypatch):
    """Record the model, state and optimizer ``fit`` starts from (the CLI
    module's ``fit``), with anomaly mode as it is then."""
    box = {}
    real = cli_train.fit

    def recording(model, state, tx, *args, **kw):
        box.update(model=model, tx=tx, anomaly=torch.is_anomaly_enabled(),
                   params={k: v.detach().clone() for k, v in state.params.items()},
                   stats={k: v.detach().clone() for k, v in state.batch_stats.items()})
        return real(model, state, tx, *args, **kw)

    monkeypatch.setattr(cli_train, "fit", recording)
    return box


def torchvision_archive(path, backbone="resnet18", num_layers=2, seed=0):
    """A torchvision ResNet state dict's layout (``np.savez``) of seeded
    draws: the stem and the first ``num_layers - 1`` stages."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[name] = rng.standard_normal((o, i, k, k)).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{name}.bias"] = rng.standard_normal(c).astype(np.float32)
        sd[f"{name}.running_mean"] = rng.standard_normal(c).astype(np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        sd[f"{name}.num_batches_tracked"] = np.asarray(7, np.int64)

    conv("conv1.weight", 64, 3, 7)
    bn("bn1", 64)
    blocks, chans = RESNET_STAGES[backbone]
    c_in = 64
    for s in range(num_layers - 1):
        for b in range(blocks[s]):
            t = f"layer{s + 1}.{b}"
            conv(f"{t}.conv1.weight", chans[s], c_in, 3)
            bn(f"{t}.bn1", chans[s])
            conv(f"{t}.conv2.weight", chans[s], chans[s], 3)
            bn(f"{t}.bn2", chans[s])
            if c_in != chans[s] or (s > 0 and b == 0):
                conv(f"{t}.downsample.0.weight", chans[s], c_in, 1)
                bn(f"{t}.downsample.1", chans[s])
            c_in = chans[s]
    np.savez(path, **sd)
    return sd


def test_encoder_weights_warm_start(tmp_path, conf_path, sets, monkeypatch, capsys):
    sd = torchvision_archive(tmp_path / "r18.npz")
    box = at_fit_start(monkeypatch)
    argv = train_args(tmp_path / "run", conf_path, "--encoder_weights", str(tmp_path / "r18.npz"),
                      epochs=1)
    argv[argv.index("group")] = "batch"
    run_train(argv, sets)
    assert "encoder warm-started" in capsys.readouterr().out
    trunk = "net.encoder.model."
    got = {**box["params"], **box["stats"]}
    want = {"conv1.weight": "conv1.weight", "bn1.scale": "bn1.weight", "bn1.mean":
            "bn1.running_mean", "stages.layer1_block1.bn2.var": "layer1.1.bn2.running_var",
            "stages.layer1_block0.conv2.weight": "layer1.0.conv2.weight"}
    for port_name, tv_name in want.items():
        np.testing.assert_array_equal(got[trunk + port_name].numpy(), sd[tv_name])
    n_trunk = sum(1 for k in got if k.startswith(trunk))
    assert n_trunk == 5 + 2 * 2 * 5  # stem conv + bn, two blocks of two convs + bns
    # archives of another encoder: a stage missing, another width; and a
    # norm without BatchNorm statistics
    torchvision_archive(tmp_path / "stem.npz", num_layers=1)
    narrow = dict(sd, **{"conv1.weight": sd["conv1.weight"][:32]})
    np.savez(tmp_path / "narrow.npz", **narrow)
    for bad in ("stem.npz", "narrow.npz"):
        argv_bad = list(argv)
        argv_bad[argv_bad.index(str(tmp_path / "r18.npz"))] = str(tmp_path / bad)
        with pytest.raises(SystemExit, match="does not match the configured encoder"):
            run_train(argv_bad, sets)
    with pytest.raises(SystemExit, match="norm_type batch"):
        run_train(train_args(tmp_path / "group", conf_path, "--encoder_weights",
                             str(tmp_path / "r18.npz")), sets)


def test_model_and_optimizer_flags(tmp_path, conf_path, sets, monkeypatch):
    from avr_tpu_torch.models.wrapper import make_model
    from avr_tpu_torch.renderers.base import RaymarcherConfig

    box = at_fit_start(monkeypatch)
    made = []
    real_opt = cli_train.make_optimizer
    monkeypatch.setattr(cli_train, "make_optimizer",
                        lambda *a, **kw: made.append((a, kw)) or real_opt(*a, **kw))
    argv = train_args(tmp_path, conf_path, "--sigma_bias_init", "0.5", "--raymarch_steps", "4",
                      "--lr_schedule", "cosine", "--schedule_total_epochs", "30",
                      "--anomaly_detection", "--stop_encoder_grad", name="Raymarcher_t",
                      epochs=1)
    argv[argv.index("both")] = "coarse"  # the Raymarcher renders no fine image
    run_train(argv, sets)
    model = box["model"]
    assert isinstance(model.renderer_cfg, RaymarcherConfig)
    assert model.renderer_cfg.raymarch_steps == 4 and model.net.cfg.stop_encoder_grad
    fresh = make_model(conf_path, dtype=torch.float32, device="cpu", renderer="Raymarcher_t",
                       norm_type="group")
    for head in ("mlp_coarse", "mlp_fine"):
        key = f"net.{head}.lin_out.bias"
        want = dict(fresh.named_parameters())[key].detach().clone()
        want[3] += 0.5
        torch.testing.assert_close(box["params"][key], want, rtol=0, atol=0)
    # the cosine horizon: --schedule_total_epochs x steps a epoch (2 scenes / SB 2)
    assert made == [((1e-4,), dict(schedule="cosine", total_steps=30))]
    assert box["anomaly"] and not torch.is_anomaly_enabled()


# ---------------------------------------------------------------------------
# the parallel flags
# ---------------------------------------------------------------------------


def _digest(state):
    from tests.test_torch_parallel import digest

    return digest(state)


@pytest.fixture(scope="module")
def one_process_baseline(tmp_path_factory, conf_path, sets):
    root = tmp_path_factory.mktemp("baseline")
    return _digest(run_train(train_args(root, conf_path, epochs=1), sets))


PARALLEL_FLAGS = {"mesh": ["--mesh", "1,1"], "gspmd": ["--step_impl", "gspmd"],
                  "mesh_gspmd": ["--mesh", "1,1", "--step_impl", "gspmd"],
                  "multihost": ["--multihost"]}


@pytest.mark.parametrize("case", PARALLEL_FLAGS)
def test_parallel_flags_run_one_process(case, tmp_path, conf_path, sets, one_process_baseline):
    """One process, no launcher: a (1, 1) mesh's step is the single-device
    step bit for bit (either flavour, ``per_ray``), ``--step_impl`` alone
    leaves the single-device step, and ``--multihost`` stays single-process
    (JAX's contract)."""
    import torch.distributed as dist

    state = run_train(train_args(tmp_path, conf_path, *PARALLEL_FLAGS[case], epochs=1), sets)
    assert not dist.is_initialized()
    assert int(state.step) == 1
    assert _digest(state) == one_process_baseline
    assert sorted(os.listdir(tmp_path / "checkpoints" / "experiments")) == [f"{NAME}_epoch1"]
    with open(tmp_path / "logs" / f"{NAME}.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records if r["event"] == "train"] == [1]


def test_mesh_the_ranks_do_not_fill_raises(tmp_path, conf_path, sets):
    with pytest.raises(ValueError, match="ranks 1"):
        run_train(train_args(tmp_path, conf_path, "--mesh", "2,4"), sets)
    with pytest.raises(SystemExit, match="data,rays"):
        run_train(train_args(tmp_path, conf_path, "--mesh", "2"), sets)
    assert not (tmp_path / "checkpoints").exists()


def _cli_ranks(rank, world, tmp, conf):
    from tests.test_torch_parallel import digest

    sets = dict(train=synthetic_scene_mapping(4, 4, SIDE), val=synthetic_scene_mapping(1, 4, SIDE, seed=7))
    state = run_train(train_args(os.path.join(tmp, "run"), conf, "--multihost", "--mesh", "1,2",
                                 "--steps_val", "1"), sets)
    with open(os.path.join(tmp, f"cli_{rank}.json"), "w") as f:
        json.dump(dict(step=int(state.step), digest=digest(state)), f)


def test_two_rank_mesh_run(tmp_path, conf_path):
    """``--multihost --mesh 1,2`` on two gloo ranks (2 instances a rank's
    shard, a global batch of 2: a step an epoch)."""
    from tests.test_torch_parallel import spawn_ranks

    spawn_ranks(_cli_ranks, 2, (str(tmp_path), conf_path))
    got = []
    for r in range(2):
        with open(tmp_path / f"cli_{r}.json") as f:
            got.append(json.load(f))
    assert got[0] == got[1] and got[0]["step"] == 2
    root = tmp_path / "run"
    assert sorted(os.listdir(root / "checkpoints" / "experiments")) == [
        f"{NAME}_best", f"{NAME}_epoch1", f"{NAME}_epoch2"]
    with open(root / "logs" / f"{NAME}.jsonl") as f:
        records = [json.loads(line) for line in f]
    for r in records:
        assert set(r) in LOG_KEYS[r["event"]], r
    # one process logged: each step once
    assert [r["step"] for r in records if r["event"] == "train"] == [1, 2]
    assert [r["step"] for r in records if r["event"] == "val"] == [1, 2]
