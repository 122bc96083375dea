"""Port parity of the training step's pieces against ``avr_tpu``.

* Train-mode BatchNorm against Flax ``nn.BatchNorm`` with
  ``mutable=["batch_stats"]``: outputs and updated running statistics.
* The optimizer against optax: three Adam updates through the non-finite
  skip (one non-finite gradient: skipped, counted, moments unchanged), and
  the warmup-cosine schedule's values.
* The slice: one train step of ``test_torch_slice.py``'s small model at
  SB = 2 against JAX ``make_train_step`` on the CPU: loss, gradient norm,
  every gradient (Adam's first moment after one step is ``0.1 * g``), the
  second moment, the updated parameters and the BatchNorm statistics,
  carried across by ``to_flax_variables``.
* On the CPU the whole step runs the plain versions: no wrapper raises or
  launches under autograd.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from avr_tpu.config import parse_conf_string as jax_parse_conf
from avr_tpu.models.pixelnerf import ModelConfig as JaxModelConfig
from avr_tpu.models.wrapper import RadFieldRenderer as JaxRenderer
from avr_tpu.renderers.base import AdaptiveRendererConfig as JaxAdaptiveConfig
from avr_tpu.training import LossParams as JaxLossParams
from avr_tpu.training import create_train_state as jax_create_state
from avr_tpu.training import make_optimizer as jax_make_optimizer
from avr_tpu.training import make_train_step as jax_make_train_step
from avr_tpu_torch.config import parse_conf_string
from avr_tpu_torch.models.flax_import import load_flax_variables, to_flax_tree, to_flax_variables
from avr_tpu_torch.models.pixelnerf import ModelConfig
from avr_tpu_torch.models.resnet import BatchNorm
from avr_tpu_torch.models.wrapper import RadFieldRenderer
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.renderers.base import AdaptiveRendererConfig
from avr_tpu_torch.training import (LossParams, create_train_state, make_optimizer,
                                    make_train_step)
from avr_tpu_torch.training.state import warmup_cosine_schedule
from tests.test_torch_slice import CONF, CONF_DIR, SIDE, _camera, _perturb

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_flax(dtype):
    rng = np.random.default_rng(3)
    C = 8
    x = (rng.normal(size=(3, 5, 6, C)) * 2.0 + 1.5).astype(np.float32)  # NHWC
    scale = rng.uniform(0.5, 1.5, size=C).astype(np.float32)
    bias = rng.normal(size=C).astype(np.float32)
    mean0 = rng.normal(size=C).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, size=C).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    x = np.asarray(jnp.asarray(x).astype(jd).astype(jnp.float32))  # the same values

    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jd)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, upd = bn.apply(variables, jnp.asarray(x).astype(jd), mutable=["batch_stats"])

    port = BatchNorm(C)
    with torch.no_grad():
        port.scale.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.mean.copy_(torch.from_numpy(mean0))
        port.var.copy_(torch.from_numpy(var0))
    got = port(torch.from_numpy(x.copy()).to(td).permute(0, 3, 1, 2), train=True)
    assert got.dtype == td
    got = got.permute(0, 2, 3, 1).float().detach().numpy()
    # float32: the same formula, sums in another order.  bf16: both round
    # the float32 result once; one bf16 ulp of the largest output
    tol = 1e-5 if dtype == "float32" else 2.0 ** -8 * np.abs(got).max()
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)), rtol=0, atol=tol)
    np.testing.assert_allclose(port.mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=0, atol=1e-5)
    # the stored variance is the biased one
    xf = x.reshape(-1, C).astype(np.float64)
    np.testing.assert_allclose(port.var.numpy(), 0.9 * var0 + 0.1 * xf.var(axis=0), rtol=1e-5)


def test_batchnorm_eval_leaves_stats():
    port = BatchNorm(4)
    x = torch.randn(2, 4, 3, 3, generator=torch.Generator().manual_seed(0))
    port(x)
    assert torch.equal(port.mean, torch.zeros(4)) and torch.equal(port.var, torch.ones(4))


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def test_adam_with_nonfinite_skip_matches_optax():
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    grads[1]["b"][2] = np.nan  # the second update is skipped

    tx = jax_make_optimizer(1e-3)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jp)
    opt = make_optimizer(1e-3)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = opt.init(tp)
    for i, g in enumerate(grads):
        upd, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        mu_before = {k: v.clone() for k, v in tstate.mu.items()}
        tupd, tstate = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, tstate)
        for k in tp:
            tp[k] = tp[k] + tupd[k]
        adam = jstate.inner_state[0]
        assert int(tstate.count) == int(adam.count)
        assert int(tstate.total_notfinite) == int(jstate.total_notfinite) == (0 if i == 0 else 1)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-7)
            np.testing.assert_allclose(tstate.mu[k].numpy(), np.asarray(adam.mu[k]), atol=1e-7)
            np.testing.assert_allclose(tstate.nu[k].numpy(), np.asarray(adam.nu[k]), atol=1e-9)
            if i == 1:  # skipped: the moments did not move
                assert torch.equal(tstate.mu[k], mu_before[k])
    assert int(tstate.count) == 2


def test_cosine_schedule_matches_optax():
    lr, total, warmup = 1e-3, 1000, 100
    want = optax.warmup_cosine_decay_schedule(init_value=lr / 10.0, peak_value=lr,
                                              warmup_steps=warmup, decay_steps=total,
                                              end_value=lr / 20.0)
    got = warmup_cosine_schedule(lr, total, warmup)
    for count in (0, 1, 50, 99, 100, 101, 500, 999, 1000, 1500):
        np.testing.assert_allclose(float(got(torch.tensor(count, dtype=torch.int32))),
                                   float(want(count)), rtol=1e-6)
    opt = make_optimizer(lr, schedule="cosine", total_steps=total, warmup_steps=warmup)
    assert callable(opt.lr)
    with pytest.raises(ValueError, match="total_steps"):
        make_optimizer(lr, schedule="cosine")


# ---------------------------------------------------------------------------
# one train step of the small slice model
# ---------------------------------------------------------------------------

SB, R, KEY = 2, 48, 3


def _batch():
    rng = np.random.default_rng(21)
    c2w, K = _camera()
    images = rng.uniform(-1, 1, size=(SB, 1, SIDE, SIDE, 3)).astype(np.float32)
    poses = np.broadcast_to(c2w, (SB, 1, 4, 4)).copy()
    xy = rng.uniform(0.05, 0.95, size=(SB, R, 2)).astype(np.float32)
    model_input = dict(x_pix=xy, cam2world=np.broadcast_to(c2w, (SB, R, 4, 4)).copy(),
                       intrinsics=np.broadcast_to(K, (SB, 3, 3)).copy())
    gt = rng.uniform(size=(SB, R, 3)).astype(np.float32)
    focal = np.float32(1.09375 * SIDE)
    c = np.asarray([SIDE / 2, SIDE / 2], np.float32)
    return images, poses, focal, c, model_input, gt


@pytest.fixture(scope="module")
def stepped():
    rng = np.random.default_rng(0)
    jconf = jax_parse_conf(CONF, base_dir=CONF_DIR)
    jmodel = JaxRenderer(model_cfg=JaxModelConfig.from_conf(jconf["model"]),
                         renderer_cfg=JaxAdaptiveConfig.from_conf(jconf["adaptive_renderer"]))
    images, poses, focal, c, model_input, gt = _batch()
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images[:1]),
                            jnp.asarray(poses[:1]), focal, jnp.asarray(c),
                            method=jmodel.init_all)
    variables = _perturb(variables, rng)

    conf = parse_conf_string(CONF, base_dir=CONF_DIR)
    port = RadFieldRenderer(ModelConfig.from_conf(conf["model"]),
                            AdaptiveRendererConfig.from_conf(conf["adaptive_renderer"]))
    load_flax_variables(port, variables)
    before = to_flax_variables(port)

    tx = jax_make_optimizer(1e-4)
    jstate = jax_create_state(jax.tree.map(jnp.asarray, variables), tx)
    jstep = jax_make_train_step(jmodel, tx, JaxLossParams(loss_mode="both"), donate=False)
    jstate, jmetrics = jstep(jstate, jnp.asarray(images), jnp.asarray(poses), focal,
                             jnp.asarray(c), jax.tree.map(jnp.asarray, model_input),
                             jnp.asarray(gt), jax.random.PRNGKey(KEY))

    opt = make_optimizer(1e-4)
    state = create_train_state(port, opt)
    step = make_train_step(port, opt, LossParams(loss_mode="both"))
    t = lambda a: torch.from_numpy(np.asarray(a))
    _build.reset_launches()
    state, metrics = step(state, t(images), t(poses), float(focal), t(c),
                          {k: t(v) for k, v in model_input.items()}, t(gt), (0, KEY))
    launches = dict(_build.launches)
    return dict(jstate=jstate, jmetrics=jmetrics, state=state, metrics=metrics, port=port,
                before=before, launches=launches)


def _leaves(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_train_step_loss_and_metrics_match(stepped):
    jm, m = stepped["jmetrics"], stepped["metrics"]
    assert not stepped["launches"], "the CPU step launched a kernel"
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    assert int(m["notfinite"]) == int(jm["notfinite"]) == 0
    assert int(stepped["state"].step) == int(stepped["jstate"].step) == 1


def test_train_step_gradients_and_moments_match(stepped):
    """After one step Adam's moments are ``0.1 g`` and ``0.001 g^2``: every
    gradient, leaf by leaf in the Flax layout."""
    adam = stepped["jstate"].opt_state.inner_state[0]
    st = stepped["state"].opt_state
    for name, port_tree, jax_tree in (("mu", st.mu, adam.mu), ("nu", st.nu, adam.nu)):
        got = _leaves(to_flax_tree(port_tree)["params"])
        want = _leaves(jax_tree)
        assert got.keys() == want.keys()
        for k in want:
            # float32, but the 3-step march is a chaotic recurrence: the two
            # packages sum its projection and LSTM products in other orders
            # (XLA's scan against PyTorch), and the march's own parameters
            # and the step head see the difference most (measured up to
            # 2.3e-3): 5e-3 of each leaf's largest value.  The XLA gather's
            # clip and the port's strict border mask differ only for points
            # exactly on the border.
            scale = max(np.abs(want[k]).max(), 1e-12)
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=5e-3 * scale,
                                       err_msg=f"{name} {k}")


def test_train_step_params_and_stats_match(stepped):
    got = to_flax_variables(stepped["port"])
    before = stepped["before"]
    jstate = stepped["jstate"]
    want_p, want_s = _leaves(jstate.params), _leaves(jstate.batch_stats)
    got_p, got_s = _leaves(got["params"]), _leaves(got["batch_stats"])
    g = _leaves(to_flax_tree(stepped["state"].opt_state.mu)["params"])
    b = _leaves(before["params"])
    for k in want_p:
        # Adam's first step is about -lr * sign(g): compare where |g| is
        # clear of the gradient tolerance, where the sign cannot flip
        live = np.abs(g[k]) > 1e-2 * max(np.abs(g[k]).max(), 1e-12)
        np.testing.assert_allclose(got_p[k][live], want_p[k][live], rtol=0, atol=1e-6,
                                   err_msg=k)
        assert not np.array_equal(got_p[k][live], b[k][live]) or not live.any(), k
    assert want_s.keys() == got_s.keys()
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], rtol=0, atol=1e-4, err_msg=k)
        assert not np.array_equal(got_s[k], _leaves(before["batch_stats"])[k]), k
