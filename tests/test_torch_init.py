"""The port's seeded initialisation against the JAX package's scheme.

JAX's ``init_all`` (``avr_tpu/models/wrapper.py:299``) and the port's
``make_model`` initialise the same small model (ResNet34 cut to two
layers, decoders of width 64 with 2 blocks, LSTM hidden 8).  Their random
draws cannot match (two generators), so each parameter, by name, is held
to the scheme on both sides:

* the same entries are exactly zero (``fc_1``, every bias) and exactly 1
  (the LSTM's forget quarters, BatchNorm's scale);
* ``w_hh`` has orthonormal rows, to 1e-5 (float32 QR);
* each matrix's variance matches its fan-in rule: Kaiming 2 / fan_in for
  the decoders' ``lin_in``, ``lin_z``, ``fc_0``, ``lin_out`` and the
  LSTM's ``w_ih``, LeCun 1 / fan_in for the convolutions and
  ``out_layer``, 1 / (4 H) for ``w_hh``'s orthonormal rows.  Sampling
  tolerance: the variance of n draws of a normal has a relative standard
  deviation of sqrt(2 / n) (less for the truncated LeCun draws); the test
  allows 6 of those, and a floor of 0.02 for ``w_hh``, whose rows are
  exactly unit length.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu.config import parse_conf_string as jax_parse_conf
from avr_tpu.models.pixelnerf import ModelConfig as JaxModelConfig
from avr_tpu.models.wrapper import RadFieldRenderer as JaxRenderer
from avr_tpu.renderers.base import AdaptiveRendererConfig as JaxAdaptiveConfig
from avr_tpu_torch.config import parse_conf_string
from avr_tpu_torch.models.flax_import import _convert, _flatten, _flax_path
from avr_tpu_torch.models.pixelnerf import ModelConfig
from avr_tpu_torch.models.wrapper import RadFieldRenderer, bench_weights, init_weights
from avr_tpu_torch.renderers.base import AdaptiveRendererConfig
from tests.test_torch_slice import CONF_DIR, SIDE, _camera

torch.set_num_threads(2)

CONF = """
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
"""
HIDDEN = 8


def _jax_params():
    jconf = jax_parse_conf(CONF, base_dir=CONF_DIR)
    rcfg = dataclasses.replace(JaxAdaptiveConfig.from_conf(jconf["adaptive_renderer"]),
                               hidden_size=HIDDEN)
    jmodel = JaxRenderer(model_cfg=JaxModelConfig.from_conf(jconf["model"]), renderer_cfg=rcfg)
    c2w, _ = _camera()
    images = np.zeros((1, 1, SIDE, SIDE, 3), np.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images),
                            jnp.asarray(c2w[None, None]), np.float32(1.09375 * SIDE),
                            jnp.asarray([SIDE / 2, SIDE / 2], np.float32), method=jmodel.init_all)
    return _flatten(jax.tree.map(np.asarray, variables))


def _port_model():
    conf = parse_conf_string(CONF, base_dir=CONF_DIR)
    rcfg = dataclasses.replace(AdaptiveRendererConfig.from_conf(conf["adaptive_renderer"]),
                               hidden_size=HIDDEN)
    return RadFieldRenderer(ModelConfig.from_conf(conf["model"]), rcfg)


@pytest.fixture(scope="module")
def both():
    flat = _jax_params()
    model = _port_model()
    init_weights(model, 0)
    out = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        out[name] = (p.detach().numpy(), _convert(flat[_flax_path(name)], p, leaf))
    return out


def _names():
    return [n for n, _ in _port_model().named_parameters()]


def _rule(name, shape):
    """The expected variance of a matrix's entries, or None for a vector."""
    if len(shape) < 2:
        return None
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "w_hh":
        return 1.0 / shape[1]  # H orthonormal rows of length 4H
    if leaf == "w_ih":
        return 2.0 / shape[0]  # (in, 4H)
    if ".fc_1." in name:
        return 0.0
    fan_in = int(np.prod(shape[1:]))
    return (2.0 if ".mlp_" in name else 1.0) / fan_in


@pytest.mark.parametrize("name", _names())
def test_init_follows_the_jax_scheme(both, name):
    port, jax_value = both[name]
    assert port.shape == jax_value.shape
    # exact zeros and ones in the same places
    np.testing.assert_array_equal(port == 0.0, jax_value == 0.0)
    np.testing.assert_array_equal(port == 1.0, jax_value == 1.0)
    if name.endswith("w_hh"):
        for w in (port, jax_value):
            np.testing.assert_allclose(w @ w.T, np.eye(w.shape[0]), rtol=0, atol=1e-5)
    want = _rule(name, port.shape)
    if want is None or want == 0.0:
        return
    n = port.size
    tol = max(6.0 * np.sqrt(2.0 / n), 0.02)
    for side, w in (("port", port), ("jax", jax_value)):
        var = float(np.mean(w.astype(np.float64) ** 2))
        assert abs(var / want - 1.0) < tol, (side, var, want, tol)


def test_forget_quarters_and_identity_blocks(both):
    H = HIDDEN
    for leaf in ("lstm.b_ih", "lstm.b_hh"):
        port, _ = both[leaf]
        np.testing.assert_array_equal(port[H:2 * H], 1.0)
        assert not port[:H].any() and not port[2 * H:].any()
    fc1 = [n for n in both if ".fc_1." in n]
    assert fc1 and all(not both[n][0].any() for n in fc1)


def test_bench_weights_keep_every_matrix_live():
    """The card's benchmark weights: no zero matrix (fc_1 included), so every
    cotangent of the decoder's backward is live."""
    model = _port_model()
    bench_weights(model, 0)
    for name, p in model.named_parameters():
        if p.ndim >= 2:
            assert bool(p.detach().abs().sum() > 0), name
