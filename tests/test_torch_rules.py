"""Rules of the port that hold on any machine.

* No module of ``avr_tpu_torch`` (``scripts/`` and the model options'
  modules included) and no part of ``chip_smoke.py``,
  ``train_skip_probe.py``, ``march_turns.py``, ``gather_turns.py``,
  ``integral_turns.py``, ``f32_turns.py``, ``march_f32_turns.py``,
  ``wide_turns.py`` or ``chain_turns.py`` imports
  JAX, Flax, Optax, the JAX package or its ``scripts`` (AST scan, the turns
  scripts' ``_TURN`` and ``_PROBE`` snippets included: they run as ``python
  -c`` in each checkout).
* Entry points default to the card: with no CUDA device and no explicit
  ``device``, they raise instead of running on the CPU.
* CPU tensors take the plain versions and never touch the kernel library,
  on the default adaptive path and on the fused one (K5's gather, K4's
  band integral), and with the legacy threefry key (K7's draws) for every
  renderer and the device-data train step, and in a CPU ``fit`` (both data
  paths, validation and checkpoints included).
* ``fit`` (device-data path and host path), ``test_approximate``,
  ``LPIPS`` and the step-input assembly default to the card too, as do the
  CLIs' ``main`` (train, test, video), the demo's and the quality script's.
* The model options (the global and custom encoders, ``feature_scale``,
  ``type = mlp``, SPADE, ``beta``, ``max``, the decoder BatchNorm, the
  encoding variants) render and train on CPU tensors without touching the
  kernel library.
"""

import ast
import pathlib
import re

import numpy as np
import pytest
import torch

from avr_tpu_torch import evaluation
from avr_tpu_torch.config import parse_conf_string
from avr_tpu_torch.data.device import build_device_dataset, make_device_sampler
from avr_tpu_torch.data.synthetic import synthetic_scene_set
from avr_tpu_torch.models.wrapper import make_model
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.ops.threefry import PRNGKey

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "avr_tpu", "scripts")
# the turns scripts' sources run as python -c
SNIPPETS = ("_TURN", "_PROBE", "_STAMPED", "_CAPTURE", "_COMMON", "_SLICE", "_BINS",
            "_RECORDS", "_CHAIN_DEVICE", "_RETIRED_CHILD")
TINY = """
include required("default_mv.conf")
model {
    encoder { num_layers = 2 }
    mlp_coarse { d_hidden = 64
                 n_blocks = 2
                 combine_layer = 1 }
    mlp_fine { d_hidden = 64
               n_blocks = 2
               combine_layer = 1 }
}
adaptive_renderer { raymarch_steps = 2
                    n_coarse = 3 }
"""


def _imports(path: pathlib.Path, source=None):
    tree = ast.parse(path.read_text() if source is None else source, filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Assign) and any(getattr(t, "id", None) in SNIPPETS
                                                   for t in node.targets)):
            yield from _imports(path, node.value.value)  # a snippet run as ``python -c``


def _port_files():
    return sorted((ROOT / "avr_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "train_skip_probe.py", ROOT / "march_turns.py",
        ROOT / "gather_turns.py", ROOT / "integral_turns.py", ROOT / "f32_turns.py",
        ROOT / "march_f32_turns.py", ROOT / "wide_turns.py", ROOT / "chain_turns.py"]


def test_the_scan_reads_the_turns_snippets():
    for name in ("march_turns.py", "gather_turns.py", "integral_turns.py", "f32_turns.py",
                 "march_f32_turns.py", "wide_turns.py", "chain_turns.py"):
        assert "chip_smoke" in set(_imports(ROOT / name)), name
    for name in ("integral_turns.py", "f32_turns.py", "march_f32_turns.py",
                 "wide_turns.py"):  # their _PROBE snippets
        assert "ctypes" in set(_imports(ROOT / name)), name


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_the_scan_knows_every_snippet(path):
    """A module-level source string that imports (a snippet run as
    ``python -c``) is one of SNIPPETS, so the JAX-import scan reads it."""
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
                and re.search(r"^\s*(import|from) \w", node.value.value, re.M)):
            names = [getattr(t, "id", None) for t in node.targets]
            assert any(n in SNIPPETS for n in names), (path.name, names)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _tiny_conf():
    return parse_conf_string(TINY, base_dir=str(ROOT / "conf"))


# make_model's keywords for the adaptive renderer's two paths
PATHS = {"default": {}, "fused": dict(gather_impl="pallas_proj", fused_integral="always")}


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_model(_tiny_conf())
    model = make_model(_tiny_conf(), dtype=torch.float32, device="cpu")
    batch = dict(images=np.zeros((1, 1, 64, 3), np.float32),
                 cam2world=np.eye(4, dtype=np.float32)[None, None],
                 focal=np.ones((1, 1), np.float32), c=np.full((1, 1, 2), 4.0, np.float32),
                 intrinsics=np.eye(3, dtype=np.float32)[None, None])
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluation.generate_video(model, batch, 1, 1.3)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluation.render_full_image(model, None, torch.eye(3)[None], torch.eye(4)[None],
                                     8, PRNGKey(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_device_dataset(synthetic_scene_set(1, 2, 8))
    from avr_tpu_torch.cli import test as cli_test
    from avr_tpu_torch.cli import train as cli_train
    from avr_tpu_torch.cli import video as cli_video
    from avr_tpu_torch.examples import train_synthetic
    from avr_tpu_torch.scripts import quality_ab

    mains = {cli_train.main: ["--root_dir", "r", "--loss_mode", "both", "--renderer", "AVR",
                              "--starting_epoch", "0"],
             cli_test.main: ["--root_dir", "r", "--renderer", "AVR", "--epoch", "1",
                             "--data", "d.h5"],
             cli_video.main: ["--root_dir", "r", "--renderer", "AVR", "--epoch", "1",
                              "--data", "d.h5"],
             train_synthetic.main: ["--workdir", "w"],
             quality_ab.main: ["--workdir", "w"]}
    for main, argv in mains.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)


@pytest.mark.parametrize("path", PATHS)
def test_cpu_render_never_touches_the_kernel_library(path):
    model = make_model(_tiny_conf(), dtype=torch.float32, seed=3, device="cpu", **PATHS[path])
    rng = np.random.default_rng(0)
    c2w = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    c2w[2, 3] = 1.3
    K = np.asarray([[1.09375, 0, 0.5], [0, 1.09375, 0.5], [0, 0, 1]], np.float32)
    batch = dict(images=rng.uniform(-1, 1, (1, 1, 16 * 16, 3)).astype(np.float32),
                 cam2world=c2w[None, None], focal=np.full((1, 1), 17.5, np.float32),
                 c=np.full((1, 1, 2), 8.0, np.float32), intrinsics=K[None, None])
    _build.reset_launches()
    frames = evaluation.generate_video(model, batch, 2, 1.3, render_chunk=64, device="cpu")
    assert len(frames) == 2 and frames[0].shape == (16, 16, 3) and frames[0].dtype == np.uint8
    assert not _build.launches
    assert _build._lib is None, "the CPU path loaded the CUDA kernel library"


def test_the_scan_covers_the_training_package():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    for mod in ("loss", "state", "step", "__init__"):
        assert f"avr_tpu_torch/training/{mod}.py" in names


def test_the_scan_covers_the_renderers():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    for mod in ("base", "adaptive", "raymarch", "volume", "lstm"):
        assert f"avr_tpu_torch/renderers/{mod}.py" in names


def test_the_scan_covers_the_kernel_wrappers():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    for mod in ("_build", "gather", "resnetfc", "march", "integrate", "rng"):
        assert f"avr_tpu_torch/ops/kernels/{mod}.py" in names
    assert "avr_tpu_torch/ops/threefry.py" in names


def test_the_scan_covers_the_data_package():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    for mod in ("__init__", "device", "synthetic", "dataset", "sampling", "prefetch"):
        assert f"avr_tpu_torch/data/{mod}.py" in names


def test_the_scan_covers_the_clis_and_tools():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    for mod in ("cli/__init__", "cli/train", "cli/test", "cli/video", "examples/__init__",
                "examples/train_synthetic", "profiling/analyze", "data/native",
                "models/torch_import", "utils/debug", "utils/viz", "utils/device"):
        assert f"avr_tpu_torch/{mod}.py" in names


def test_the_scan_covers_the_model_options_and_scripts():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    for mod in ("models/implicit", "models/encoder", "models/mlp", "models/pixelnerf",
                "ops/resize", "scripts/__init__", "scripts/quality_ab"):
        assert f"avr_tpu_torch/{mod}.py" in names


# the model options on TINY's width: (conf edits, make_model keywords)
OPTIONS = {
    "global_custom_mlp": ([("encoder { num_layers = 2 }",
                            "encoder { backbone = custom }\n    use_global_encoder = True\n"
                            "    global_encoder { backbone = resnet18\n latent_size = 64 }"),
                           ("mlp_fine { d_hidden = 64", "mlp_fine { type = mlp\n d_hidden = 32")],
                          {}),
    "spade_beta_max_bn": ([("mlp_coarse { d_hidden = 64", "mlp_coarse { use_spade = True\n"
                            " beta = 2.0\n combine_type = max\n d_hidden = 64"),
                           ("encoder { num_layers = 2 }",
                            "encoder { num_layers = 2\n feature_scale = 0.5 }\n"
                            "    use_xyz = False\n    use_code_viewdirs = True")],
                          dict(bn=True)),
    "code_off_coarse_only": ([("mlp_fine { d_hidden = 64", "mlp_fine { type = empty\n d_hidden = 64"),
                              ("encoder { num_layers = 2 }",
                               "encoder { num_layers = 2 }\n    use_code = False")], {}),
}


@pytest.mark.parametrize("case", OPTIONS)
def test_cpu_option_models_never_touch_the_kernel_library(case):
    from avr_tpu_torch.training import (LossParams, create_train_state, make_optimizer,
                                        make_train_step)

    text = TINY
    for old, new in OPTIONS[case][0]:
        assert old in text, old
        text = text.replace(old, new)
    model = make_model(parse_conf_string(text, base_dir=str(ROOT / "conf")),
                       dtype=torch.float32, seed=4, device="cpu", **OPTIONS[case][1])
    rng = np.random.default_rng(2)
    SB, R, S = 2, 8, 32
    c2w = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    c2w[2, 3] = 1.3
    K = np.asarray([[1.09375, 0, 0.5], [0, 1.09375, 0.5], [0, 0, 1]], np.float32)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    batch = (t(rng.uniform(-1, 1, (SB, 1, S, S, 3))), t(np.broadcast_to(c2w, (SB, 1, 4, 4))),
             35.0, t([16.0, 16.0]),
             dict(x_pix=t(rng.uniform(0.05, 0.95, (SB, R, 2))),
                  cam2world=t(np.broadcast_to(c2w, (SB, R, 4, 4))),
                  intrinsics=t(np.broadcast_to(K, (SB, 3, 3)))),
             t(rng.uniform(size=(SB, R, 3))))
    _build.reset_launches()
    opt = make_optimizer(1e-3)
    state = create_train_state(model, opt)
    state, metrics = make_train_step(model, opt, LossParams())(state, *batch, (0, 2))
    assert int(metrics["notfinite"]) == 0 and np.isfinite(float(metrics["loss"]))
    frames = evaluation.generate_video(model, dict(
        images=rng.uniform(-1, 1, (1, 1, S * S, 3)).astype(np.float32),
        cam2world=c2w[None, None], focal=np.full((1, 1), 35.0, np.float32),
        c=np.full((1, 1, 2), 16.0, np.float32), intrinsics=K[None, None]),
        1, 1.3, render_chunk=256, device="cpu")
    assert frames[0].shape == (S, S, 3)
    assert not _build.launches
    assert _build._lib is None, "the CPU option model loaded the CUDA kernel library"


def test_the_scan_covers_the_parallel_package():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    for mod in ("__init__", "mesh", "sharded_step", "multihost"):
        assert f"avr_tpu_torch/parallel/{mod}.py" in names


def test_the_scan_covers_the_training_loop_and_utils():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    for mod in ("training/loop", "training/checkpoint", "utils/metrics", "utils/logging",
                "utils/lpips", "evaluation"):
        assert f"avr_tpu_torch/{mod}.py" in names


def _fit_args(tmp_path, device_data, **kw):
    from avr_tpu_torch.data.dataset import SceneClassDataset
    from avr_tpu_torch.data.synthetic import synthetic_scene_mapping
    from avr_tpu_torch.training import FitConfig, LossParams, create_train_state, make_optimizer

    model = make_model(_tiny_conf(), dtype=torch.float32, seed=6, device="cpu",
                       norm_type="group")
    opt = make_optimizer(1e-3)
    cfg = FitConfig(epochs=1, batch_size=2, ray_batch_size=16, steps_print=1, steps_val=2,
                    val_scenes=1, render_chunk=64, rng_mode="legacy",
                    device_data=device_data, save_root=str(tmp_path), **kw)
    return (model, create_train_state(model, opt, ema=True), opt,
            SceneClassDataset(synthetic_scene_mapping(4, 3, 16)),
            SceneClassDataset(synthetic_scene_mapping(1, 2, 16, seed=1)), LossParams(), cfg)


@pytest.mark.parametrize("device_data", [True, False])
def test_fit_defaults_to_the_card(monkeypatch, tmp_path, device_data):
    from avr_tpu_torch.training import fit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _fit_args(tmp_path, device_data)
    _build.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA"):
        fit(*args)
    assert int(args[1].step) == 0 and not _build.launches
    assert not (tmp_path / "checkpoints").exists()


def test_evaluation_entry_points_default_to_the_card(monkeypatch, tmp_path):
    from avr_tpu_torch.data.dataset import SceneClassDataset
    from avr_tpu_torch.data.synthetic import synthetic_scene_mapping
    from avr_tpu_torch.training import LossParams, create_train_state, make_optimizer
    from avr_tpu_torch.training.loop import assemble_step_inputs
    from avr_tpu_torch.utils.lpips import LPIPS, random_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = make_model(_tiny_conf(), dtype=torch.float32, device="cpu")
    dset = SceneClassDataset(synthetic_scene_mapping(1, 2, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluation.test_approximate(model, create_train_state(model, make_optimizer(1e-3)),
                                    dset, LossParams())
    path = str(tmp_path / "lpips.npz")
    np.savez(path, **random_state(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        LPIPS(path)
    batch = next(dset.batches(1, epoch_seed=0))
    with pytest.raises(RuntimeError, match="CUDA"):
        assemble_step_inputs(np.random.default_rng(0), batch, 8)


@pytest.mark.parametrize("device_data", [True, False])
def test_cpu_fit_never_touches_the_kernel_library(tmp_path, device_data):
    from avr_tpu_torch.training import fit

    args = _fit_args(tmp_path, device_data, prefetch=2)
    _build.reset_launches()
    state, losses = fit(*args, device="cpu")
    assert int(state.step) == 2 and len(losses) == 1 and np.isfinite(losses[0])
    assert sorted(p.name for p in (tmp_path / "checkpoints" / "experiments").iterdir()) == [
        "run_best", "run_epoch1"]
    assert not _build.launches
    assert _build._lib is None, "the CPU fit loaded the CUDA kernel library"


def test_fit_mesh_waits_for_the_parallel_port(tmp_path):
    """``parallel/`` is ported: a CPU ``fit`` over a mesh of one rank (no
    process group, no launcher) runs the sharded step's plain path and never
    touches the kernel library; the device-data path over a mesh raises, as
    JAX's does."""
    from avr_tpu_torch.parallel import make_mesh
    from avr_tpu_torch.training import fit

    with pytest.raises(ValueError, match="single-device"):
        fit(*_fit_args(tmp_path, True), mesh=make_mesh(), device="cpu")
    _build.reset_launches()
    state, losses = fit(*_fit_args(tmp_path, False, step_impl="gspmd"), mesh=make_mesh(),
                        device="cpu")
    assert int(state.step) == 2 and len(losses) == 1 and np.isfinite(losses[0])
    assert not _build.launches
    assert _build._lib is None, "the CPU fit loaded the CUDA kernel library"


@pytest.mark.parametrize("renderer", ["", "VR", "Raymarcher"])
def test_cpu_legacy_render_never_touches_the_kernel_library(renderer):
    """A threefry key's draws (K7) take the plain version on the CPU."""
    model = make_model(_tiny_conf(), dtype=torch.float32, seed=4, device="cpu",
                       renderer=renderer)
    c2w = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    c2w[2, 3] = 1.3
    K = torch.tensor([[1.09375, 0, 0.5], [0, 1.09375, 0.5], [0, 0, 1]])[None]
    _build.reset_launches()
    with torch.inference_mode():
        cond = model.encode(torch.zeros(1, 1, 16, 16, 3), torch.from_numpy(c2w)[None, None],
                            17.5)
        out = evaluation.render_full_image(model, cond, K, torch.from_numpy(c2w)[None], 8,
                                           PRNGKey(3), 48, device="cpu")
    assert out.rgb_coarse.shape == (1, 64, 3) and torch.isfinite(out.rgb_coarse).all()
    assert not _build.launches
    assert _build._lib is None, "the CPU legacy render loaded the CUDA kernel library"


def test_cpu_device_data_step_never_touches_the_kernel_library():
    from avr_tpu_torch.training import LossParams, create_train_state, make_optimizer
    from avr_tpu_torch.training import make_train_step

    model = make_model(_tiny_conf(), dtype=torch.float32, seed=5, device="cpu")
    data = build_device_dataset(synthetic_scene_set(2, 3, 16), device="cpu")
    opt = make_optimizer(1e-3)
    _build.reset_launches()
    step = make_train_step(model, opt, LossParams(), rng_mode="legacy",
                           sampler=make_device_sampler(data, 2, 16), sampler_key=PRNGKey(1))
    state, metrics = step(create_train_state(model, opt))
    assert int(metrics["notfinite"]) == 0 and int(state.step) == 1
    assert not _build.launches
    assert _build._lib is None, "the CPU device-data step loaded the CUDA kernel library"


@pytest.mark.parametrize("path", PATHS)
def test_cpu_train_step_runs_the_plain_versions_under_autograd(path):
    """Under autograd on the CPU no wrapper raises, launches or loads the
    kernel library; every parameter gets a gradient."""
    from avr_tpu_torch.training import (LossParams, create_train_state, make_optimizer,
                                        make_train_step)
    from avr_tpu_torch.training.step import loss_and_grads

    model = make_model(_tiny_conf(), dtype=torch.float32, seed=2, device="cpu", **PATHS[path])
    rng = np.random.default_rng(1)
    SB, R, S = 2, 16, 16
    c2w = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    c2w[2, 3] = 1.3
    K = np.asarray([[1.09375, 0, 0.5], [0, 1.09375, 0.5], [0, 0, 1]], np.float32)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    batch = (t(rng.uniform(-1, 1, (SB, 1, S, S, 3))), t(np.broadcast_to(c2w, (SB, 1, 4, 4))),
             17.5, t([8.0, 8.0]),
             dict(x_pix=t(rng.uniform(0.05, 0.95, (SB, R, 2))),
                  cam2world=t(np.broadcast_to(c2w, (SB, R, 4, 4))),
                  intrinsics=t(np.broadcast_to(K, (SB, 3, 3)))),
             t(rng.uniform(size=(SB, R, 3))))
    _build.reset_launches()
    params = dict(model.named_parameters())
    loss, grads = loss_and_grads(model, params, LossParams(), *batch, (0, 1))
    assert np.isfinite(float(loss)) and grads.keys() == params.keys()
    assert all(torch.isfinite(g).all() for g in grads.values())
    opt = make_optimizer(1e-3)
    state = create_train_state(model, opt)
    state, metrics = make_train_step(model, opt, LossParams())(state, *batch, (0, 2))
    assert int(metrics["notfinite"]) == 0 and int(state.step) == 1
    assert not _build.launches
    assert _build._lib is None, "the CPU step loaded the CUDA kernel library"
