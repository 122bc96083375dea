"""The decoder's BatchNorm (``--bn``) in the sharded steps (``parallel/``).

JAX's steps render with the batch statistics immutable and raise at
``--bn`` (``test_torch_model_options.py``), so the port's partitioned step
is held to its own single-device step on the same global batch, as JAX's
GSPMD step is to JAX's (``test_torch_parallel.py``): two gloo ranks (spawned
from this file, which imports no JAX) at mesh (1, 2), the rays split over
the ranks, a small adaptive model with ``bn`` and group norm in the encoder.

* ``gspmd``: the decoders normalise with the global batch's moments (a
  mean over the whole mesh), so the loss is the single-device step's
  within 1e-5 relative, the decoders' running statistics within 2e-5 and
  Adam's first moment within 5e-3 of each leaf's scale (the single-device
  step's own tolerance; a leaf whose gradient is zero in exact arithmetic,
  1e-3 of the largest leaf's); both ranks hold the same bits.
* ``shardmap``: each rank's decoders normalise over its own points, and the
  running statistics are the mean of the ranks' (JAX's ``pmean``): they
  differ from the single-device step's.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import digest, spawn_ranks

CONF = """
include required("default_mv.conf")
model {
    encoder { backbone = resnet18
              num_layers = 2 }
    mlp_coarse { d_hidden = 32
                 n_blocks = 2
                 combine_layer = 1 }
    mlp_fine { d_hidden = 32
               n_blocks = 2
               combine_layer = 1 }
}
adaptive_renderer { raymarch_steps = 2
                    n_coarse = 4 }
"""
CONF_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conf")
SB, R, SIDE, KEY = 2, 64, 32, 3


def _model():
    from avr_tpu_torch.config import parse_conf_string
    from avr_tpu_torch.models.wrapper import bench_weights, make_model

    model = make_model(parse_conf_string(CONF, base_dir=CONF_DIR), dtype=torch.float32,
                       seed=0, device="cpu", norm_type="group", bn=True)
    bench_weights(model, 1)
    return model


def _inputs():
    rng = np.random.default_rng(0)
    c2w = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    c2w[2, 3] = 1.3
    K = np.asarray([[1.09375, 0, 0.5], [0, 1.09375, 0.5], [0, 0, 1]], np.float32)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    return (t(rng.uniform(-1, 1, (SB, 1, SIDE, SIDE, 3))), t(np.broadcast_to(c2w, (SB, 1, 4, 4))),
            1.09375 * SIDE, t([SIDE / 2, SIDE / 2]),
            dict(x_pix=t(rng.uniform(0.05, 0.95, (SB, R, 2))),
                 cam2world=t(np.broadcast_to(c2w, (SB, R, 4, 4))),
                 intrinsics=t(np.broadcast_to(K, (SB, 3, 3)))),
            t(rng.uniform(size=(SB, R, 3))))


def _stats_and_mu(state):
    return ({k: v.clone().numpy() for k, v in state.batch_stats.items() if ".bn_0." in k},
            {k: v.clone().numpy() for k, v in state.opt_state.mu.items()})


def _ranks(rank, world, tmp):
    from avr_tpu_torch.ops import threefry
    from avr_tpu_torch.parallel import (make_mesh, make_sharded_train_step,
                                        make_shardmap_train_step, shard_train_inputs)
    from avr_tpu_torch.training import LossParams, create_train_state, make_optimizer

    out = {}
    for impl, maker in (("gspmd", make_sharded_train_step),
                        ("shardmap", make_shardmap_train_step)):
        model = _model()
        opt = make_optimizer(1e-3)
        state = create_train_state(model, opt)
        mesh = make_mesh((1, 2))
        step = maker(model, opt, LossParams(), mesh)
        state, m = step(state, *shard_train_inputs(mesh, *_inputs()), threefry.PRNGKey(KEY))
        out[impl] = dict(loss=float(m["loss"]), digest=digest(state), stats_mu=_stats_and_mu(state))
    with open(os.path.join(tmp, f"bn_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    from avr_tpu_torch.ops import threefry
    from avr_tpu_torch.training import LossParams, create_train_state, make_optimizer
    from avr_tpu_torch.training import make_train_step

    tmp = str(tmp_path_factory.mktemp("parallel_bn"))
    spawn_ranks(_ranks, 2, (tmp,))
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"bn_{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    torch.set_num_threads(2)
    model = _model()
    opt = make_optimizer(1e-3)
    state = create_train_state(model, opt)
    state, m = make_train_step(model, opt, LossParams())(state, *_inputs(),
                                                        threefry.PRNGKey(KEY))
    return dict(ranks=ranks, loss=float(m["loss"]), stats_mu=_stats_and_mu(state))


def test_gspmd_decoder_batchnorm_is_the_global_batchs(steps):
    got = steps["ranks"][0]["gspmd"]
    assert steps["ranks"][1]["gspmd"]["digest"] == got["digest"]
    np.testing.assert_allclose(got["loss"], steps["loss"], rtol=1e-5)
    (stats, mu), (want_stats, want_mu) = got["stats_mu"], steps["stats_mu"]
    assert stats.keys() == want_stats.keys() and len(stats) == 8  # 2 decoders x 2 blocks
    for k, v in want_stats.items():
        np.testing.assert_allclose(stats[k], v, rtol=0, atol=2e-5, err_msg=k)
    # a bias before a train-mode BatchNorm has a zero gradient in exact
    # arithmetic: rounding noise, held to 1e-3 of the largest moment's scale
    floor = 1e-3 * max(np.abs(v).max() for v in want_mu.values())
    for k, v in want_mu.items():
        np.testing.assert_allclose(mu[k], v, rtol=0, atol=5e-3 * max(np.abs(v).max(), floor),
                                   err_msg=k)


def test_shardmap_decoder_batchnorm_is_each_ranks(steps):
    got = steps["ranks"][0]["shardmap"]
    assert steps["ranks"][1]["shardmap"]["digest"] == got["digest"]
    stats, want = got["stats_mu"][0], steps["stats_mu"][0]
    assert any(not np.allclose(stats[k], want[k], rtol=0, atol=2e-5) for k in want
               if k.endswith(".var"))
