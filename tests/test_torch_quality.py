"""The quality script (``avr_tpu_torch/scripts/quality_ab.py``) against JAX's
``scripts/quality_ab.py``.

* The arguments it hands ``cli.train`` and ``cli.test`` equal the JAX
  script's for the same options (each script's calls recorded by patching
  its CLIs' ``main``): every arm's training flags, the final and best
  evaluations raw and EMA, the adaptive arms' ``--eps_scales`` sweep.  With
  ``--stop_epoch`` (the port's one departure) the training flags differ
  only in ``--epochs`` (the epochs left to the stop), ``--starting_epoch``
  (the newest epoch checkpoint) and ``--schedule_total_epochs`` (the whole
  schedule), and the final evaluations read the stop's checkpoint.
* Its in-memory sets equal the arrays JAX's ``write_synthetic_hdf5`` writes
  (read back with ``h5py``).
* Two arms for a few steps on a tiny set (the model cut by ``--conf``'s
  default, patched to the CLI tests' tiny configuration) resume bit for bit
  across a cut at ``--stop_epoch``: the stop's checkpoint (parameters,
  statistics, EMA, Adam's state) and the validation after the cut equal
  the uninterrupted run's.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from avr_tpu_torch.cli import test as cli_test
from avr_tpu_torch.cli import train as cli_train
from avr_tpu_torch.scripts import quality_ab
from tests.test_cli_and_eval import TINY_CONF

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--instances", "4", "--side", "16", "--train_views", "2", "--batch_size", "2",
         "--steps", "6", "--ray_batch_size", "32"]


def _jax_script(monkeypatch):
    """JAX's script as a module (its import sets a compilation-cache default
    in the environment: undone)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", os.environ.get("JAX_COMPILATION_CACHE_DIR",
                                                                   ""))
    spec = importlib.util.spec_from_file_location(
        "jax_quality_ab", os.path.join(ROOT, "scripts", "quality_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recorder(calls, kind):
    def main(argv, **kw):
        calls.append((kind, list(argv)))

    return main


def _calls(monkeypatch, workdir, argv, jax_side):
    calls = []
    if jax_side:
        import avr_tpu.cli.test
        import avr_tpu.cli.train

        monkeypatch.setattr(avr_tpu.cli.train, "main", _recorder(calls, "train"))
        monkeypatch.setattr(avr_tpu.cli.test, "main", _recorder(calls, "test"))
        _jax_script(monkeypatch).main(["--workdir", str(workdir), *argv])
    else:
        monkeypatch.setattr(cli_train, "main", _recorder(calls, "train"))
        monkeypatch.setattr(cli_test, "main", _recorder(calls, "test"))
        quality_ab.main(["--workdir", str(workdir), *argv], device="cpu")
    return [(k, [a.replace(str(workdir), "<W>") for a in args]) for k, args in calls]


OPTIONS = {
    "three_arms": ["--renderers", "AVR_q,VR_q,Raymarcher_q", "--depth_consistency", "0.5",
                   "--eps_scales", "1.5,2", "--device_data", "--epochs_save", "2",
                   "--num_source_views", "2"],
    "no_ema_no_lpips": ["--renderers", "VR_x", "--ema_decay", "0", "--lpips_weights", ""],
}


@pytest.mark.parametrize("case", OPTIONS)
def test_cli_arguments_equal_jax_script(case, tmp_path, monkeypatch):
    argv = SMALL + OPTIONS[case]
    want = _calls(monkeypatch, tmp_path / "jax", argv, jax_side=True)
    got = _calls(monkeypatch, tmp_path / "port", argv, jax_side=False)
    assert got == want
    assert [k for k, _ in got].count("train") == len(OPTIONS[case][1].split(","))


def test_stop_epoch_departs_only_in_the_schedule(tmp_path, monkeypatch):
    argv = SMALL + ["--renderers", "AVR_q", "--eps_scales", "2"]
    want = _calls(monkeypatch, tmp_path / "jax", argv, jax_side=True)
    # an epoch-1 checkpoint: the rerun resumes from it (3 epochs of 2 steps)
    ckpt = tmp_path / "port" / "checkpoints" / "experiments"
    ckpt.mkdir(parents=True)
    (ckpt / "AVR_q_epoch1").write_bytes(b"")
    got = _calls(monkeypatch, tmp_path / "port", argv + ["--stop_epoch", "2"], jax_side=False)
    (_, jtrain), (_, train) = want[0], got[0]
    flag = lambda args, f: args[args.index(f) + 1]
    assert flag(jtrain, "--epochs") == "3" and flag(jtrain, "--starting_epoch") == "0"
    assert (flag(train, "--epochs"), flag(train, "--starting_epoch"),
            flag(train, "--schedule_total_epochs")) == ("1", "1", "3")
    strip = lambda args: [a for i, a in enumerate(args)
                          if a not in ("--epochs", "--starting_epoch") and
                          (i == 0 or args[i - 1] not in ("--epochs", "--starting_epoch"))]
    assert strip(train) == strip(jtrain) + ["--schedule_total_epochs", "3"]
    # the final evaluations read the stop's checkpoint; the rest are JAX's
    at_stop = [(k, ["2" if i and args[i - 1] == "--epoch" and a == "3" else a
                    for i, a in enumerate(args)]) for k, args in want[1:]]
    assert got[1:] == at_stop and at_stop != want[1:]


def test_dtype_probe_departs_only_in_the_dtype(tmp_path, monkeypatch):
    argv = SMALL + ["--renderers", "AVR_q,VR_q"]
    want = _calls(monkeypatch, tmp_path / "jax", argv, jax_side=True)
    got = _calls(monkeypatch, tmp_path / "port", argv + ["--dtype", "f32"], jax_side=False)
    f32 = lambda args: ["f32" if i and args[i - 1] == "--dtype" else a
                        for i, a in enumerate(args)]
    assert [(k, f32(a) if k == "train" else a) for k, a in want] == got
    assert all("f32" in a for k, a in got if k == "train")


def test_sets_equal_the_jax_script_files(tmp_path):
    h5py = pytest.importorskip("h5py")
    from avr_tpu.data.synthetic import write_synthetic_hdf5

    opt = quality_ab.build_parser().parse_args(["--workdir", str(tmp_path), *SMALL])
    train, val = quality_ab.make_sets(opt)
    for mapping, kw in ((train, dict(num_instances=4, num_views=2, side=16, seed=0)),
                        (val, dict(num_instances=8, num_views=6, side=16, seed=9))):
        path = str(tmp_path / f"{kw['seed']}.hdf5")
        write_synthetic_hdf5(path, **kw)
        with h5py.File(path, "r") as f:
            assert sorted(f) == sorted(mapping)
            for inst, grp in f.items():
                np.testing.assert_array_equal(grp["intrinsics"][()], mapping[inst]["intrinsics"])
                for part in ("rgb", "pose"):
                    assert sorted(grp[part]) == sorted(mapping[inst][part])
                    for view, data in grp[part].items():
                        np.testing.assert_array_equal(data[()], mapping[inst][part][view])


@pytest.fixture()
def tiny_conf(tmp_path, monkeypatch):
    path = tmp_path / "tiny.conf"
    path.write_text(TINY_CONF)
    monkeypatch.setattr(cli_train, "DEFAULT_CONF", str(path))
    monkeypatch.setattr(cli_test, "DEFAULT_CONF", str(path))


def _run(workdir, stop):
    quality_ab.main(["--workdir", str(workdir), *SMALL, "--renderers", "AVR_t,VR_t",
                     "--steps_val", "2", "--device_data", "--stop_epoch", str(stop)],
                    device="cpu")


def _val(workdir, arm):
    with open(workdir / "logs" / f"{arm}.jsonl") as f:
        return {r["step"]: (r["psnr"], r["ssim"], r["loss"]) for r in map(json.loads, f)
                if r["event"] == "val"}


def test_resume_across_stop_epoch_is_bit_for_bit(tmp_path, tiny_conf):
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    _run(whole, 2)
    _run(cut, 1)
    first = json.loads((cut / "eval_AVR_t.json").read_text())
    assert first["steps"] == 2 and first["resumed_from_epoch"] == 0
    _run(cut, 2)
    for arm in ("AVR_t", "VR_t"):
        entry = json.loads((cut / f"eval_{arm}.json").read_text())
        assert (entry["steps"], entry["resumed_from_epoch"], entry["steps_this_call"]) == \
            (4, 1, 2)
        assert entry["skipped_updates"] == 0 and "final_ema" in entry and "best_raw" in entry
        a = torch.load(whole / "checkpoints" / "experiments" / f"{arm}_epoch2",
                       weights_only=True)
        b = torch.load(cut / "checkpoints" / "experiments" / f"{arm}_epoch2",
                       weights_only=True)
        flat = lambda d, p="": ({p + k: v for k, v in d.items() if torch.is_tensor(v)}
                                | {q: w for k, v in d.items() if isinstance(v, dict)
                                   for q, w in flat(v, p + k + "/").items()})
        fa, fb = flat(a), flat(b)
        assert fa.keys() == fb.keys() and int(fa["step"]) == 4
        for k in fa:
            assert torch.equal(fa[k], fb[k]), (arm, k)
        # the validation after the cut is the uninterrupted run's
        assert _val(cut, arm)[4] == _val(whole, arm)[4]
