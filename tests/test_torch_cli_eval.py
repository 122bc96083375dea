"""The port's evaluation and video CLIs against JAX's, on one carried
checkpoint.

A JAX train state is initialised as JAX's CLI does (``init_all``, the
group norm, ``tests/test_cli_and_eval.py``'s tiny conf), its EMA set to the
parameters plus seeded noise (so ``--use_ema`` scores other weights), and
saved by JAX's ``save_checkpoint`` (Orbax); the same state carried into the
port (``tests/test_torch_cli_resume.py carry``) is saved by the port's.
Both CLIs then run on their own checkpoint of the same weights, with the
same synthetic HDF5 test split (JAX's writer: 2 instances x 4 views of
32x32):

* ``cli.test`` (strict restore, ``evaluation.test_approximate``) agrees
  with ``avr_tpu.cli.test`` on PSNR, SSIM and loss to 1e-4 for the adaptive
  renderer, the Raymarcher (scored coarse-only), ``--use_ema``, ``--epoch
  best`` and the adaptive renderer's eval-time band (``--eps_scale 2
  --band_samples 8``); with ``--lpips_weights`` (the random-VGG archive) it
  also reports ``lpips_rand`` (``test_torch_fit.py`` holds the port's LPIPS
  to JAX's; JAX's VGG-16 would triple this file's time on the CPU);
* ``cli.video`` gives uint8 frames within 1 level of ``avr_tpu.cli.video``'s
  and writes ``--out`` (mp4 through imageio, or the frames in an ``.npz``
  where it has no mp4 writer, as JAX does).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from avr_tpu.cli import test as jax_test_cli  # noqa: E402
from avr_tpu.cli import video as jax_video_cli  # noqa: E402
from avr_tpu.config import parse_conf as jax_parse_conf  # noqa: E402
from avr_tpu.data.synthetic import write_synthetic_hdf5  # noqa: E402
from avr_tpu.models.pixelnerf import ModelConfig as JaxModelConfig  # noqa: E402
from avr_tpu.models.wrapper import RadFieldRenderer as JaxRenderer  # noqa: E402
from avr_tpu.renderers.base import renderer_config_from_conf as jax_renderer_cfg  # noqa: E402
from avr_tpu.training import create_train_state as jax_create_state  # noqa: E402
from avr_tpu.training import make_optimizer as jax_make_optimizer  # noqa: E402
from avr_tpu.training import save_checkpoint as jax_save  # noqa: E402
from avr_tpu_torch.cli import test as cli_test  # noqa: E402
from avr_tpu_torch.cli import video as cli_video  # noqa: E402
from avr_tpu_torch.models.wrapper import make_model  # noqa: E402
from avr_tpu_torch.ops.kernels import _build  # noqa: E402
from avr_tpu_torch.training import save_checkpoint  # noqa: E402
from avr_tpu_torch.utils.lpips import random_state  # noqa: E402
from tests.test_cli_and_eval import TINY_CONF  # noqa: E402
from tests.test_torch_cli_resume import carry, jax_globals  # noqa: E402

torch.set_num_threads(2)

SIDE = 32
METRIC_TOL = 1e-4


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The conf, the test split, the LPIPS archive and a checkpoint of each
    renderer under a JAX root and a port root (epoch 1 and ``best``)."""
    w = tmp_path_factory.mktemp("cli_eval")
    conf = str(w / "tiny.conf")
    with open(conf, "w") as f:
        f.write(TINY_CONF)
    data = write_synthetic_hdf5(str(w / "test.h5"), 2, 4, SIDE, seed=7)
    lpips = str(w / "lpips_rand.npz")
    np.savez(lpips, **random_state(0))
    for name, seed in (("AVR_eval", 3), ("Raymarcher_eval", 4)):
        c = jax_parse_conf(conf)
        mc = JaxModelConfig.from_conf(c["model"])
        mc = dataclasses.replace(mc, encoder=dataclasses.replace(mc.encoder, norm_type="group"))
        model = JaxRenderer(model_cfg=mc, renderer_cfg=jax_renderer_cfg(c, name, 10))
        # jitted: the eager init runs op by op (3x slower on the CPU)
        variables = jax.jit(lambda *a: model.init(*a, method=model.init_all))(
            jax.random.PRNGKey(seed), jnp.zeros((1, 1, SIDE, SIDE, 3)),
            jnp.broadcast_to(jnp.eye(4), (1, 1, 4, 4)), jnp.float32(1.09375 * SIDE),
            jnp.asarray([SIDE / 2.0, SIDE / 2.0]))
        state = jax_create_state(variables, jax_make_optimizer(1e-4), ema=True)
        rng = np.random.default_rng(seed)
        state = state.replace(ema_params=jax.tree.map(
            lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
            state.ema_params))
        port = make_model(conf, dtype=torch.float32, device="cpu", renderer=name,
                          norm_type="group")
        carried = carry(state, port)
        for epoch in (1, "best"):
            jax_save(str(w / "jax"), name, epoch, state)
            save_checkpoint(str(w / "port"), name, epoch, carried)
    return dict(w=w, conf=conf, data=data, lpips=lpips)


def _args(work, root, name, *extra):
    return ["--root_dir", str(work["w"] / root), "--renderer", name, "--sl", str(SIDE),
            "--norm_type", "group", "--conf", work["conf"], "--data", work["data"], *extra]


CASES = {
    "adaptive": ("AVR_eval", ["--epoch", "1"]),
    "raymarcher": ("Raymarcher_eval", ["--epoch", "1"]),
    "adaptive_ema": ("AVR_eval", ["--epoch", "best", "--use_ema"]),
    "adaptive_band": ("AVR_eval", ["--epoch", "1", "--eps_scale", "2", "--band_samples", "8"]),
}


@pytest.mark.parametrize("case", CASES)
def test_cli_test_matches_jax(work, case):
    name, extra = CASES[case]
    saved = jax_globals()
    want = jax_test_cli.main(_args(work, "jax", name, *extra))
    assert jax_globals() == saved  # the test CLI sets no JAX global state
    _build.reset_launches()
    got = cli_test.main(_args(work, "port", name, *extra), device="cpu")
    assert not _build.launches
    assert got.keys() == want.keys() and got["count"] == want["count"] == 2
    for k in ("psnr", "ssim", "loss"):
        assert abs(got[k] - want[k]) <= METRIC_TOL, (k, got[k], want[k])


def test_cli_test_lpips_weights(work):
    plain = cli_test.main(_args(work, "port", "AVR_eval", "--epoch", "1"), device="cpu")
    got = cli_test.main(_args(work, "port", "AVR_eval", "--epoch", "1", "--lpips_weights",
                              work["lpips"]), device="cpu")
    assert set(got) == set(plain) | {"lpips_rand"} and np.isfinite(got["lpips_rand"])
    assert all(got[k] == plain[k] for k in plain)


def test_cli_test_ema_scores_other_weights(work):
    raw = cli_test.main(_args(work, "port", "AVR_eval", "--epoch", "best"), device="cpu")
    ema = cli_test.main(_args(work, "port", "AVR_eval", "--epoch", "best", "--use_ema"),
                        device="cpu")
    assert raw["psnr"] != ema["psnr"]


def test_cli_video_matches_jax(work):
    outs = {root: str(work["w"] / root / "orbit.mp4") for root in ("jax", "port")}
    common = ["--epoch", "1", "--num_frames", "2", "--radius", "1.3", "--instance", "1"]
    want = jax_video_cli.main(_args(work, "jax", "AVR_eval", *common, "--out", outs["jax"]))
    got = cli_video.main(_args(work, "port", "AVR_eval", *common, "--out", outs["port"]),
                         device="cpu")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == w.shape == (SIDE, SIDE, 3)
        assert int(np.abs(g.astype(np.int16) - w.astype(np.int16)).max()) <= 1
    written = [p for p in (outs["port"], os.path.splitext(outs["port"])[0] + ".npz")
               if os.path.exists(p)]
    assert len(written) == 1
    if written[0].endswith(".npz"):
        np.testing.assert_array_equal(np.load(written[0])["frames"], np.stack(got))
