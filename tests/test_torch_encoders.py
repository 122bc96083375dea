"""The encoders and ``ImplicitNet``, port against ``avr_tpu/models``.

* ``ImplicitNet`` (``type = mlp``) against Flax ``ImplicitNet``: skip
  layers (``[h, input] / sqrt(2)``), the latent concatenated before ``x``,
  pooling at ``combine_layer`` (average and max) or after the last layer,
  softplus ``beta``, no latent; outputs and the gradients of a loss.
* ``ImageEncoder`` (the global latent, with and without ``fc``) and
  ``ConvEncoder`` (the custom backbone) against Flax in train and eval mode,
  outputs and gradients; the transposed convolutions' weights carried
  across and back (``to_flax_variables``) unchanged.
* ``ops/resize.py resize_linear`` against ``jax.image.resize(...,
  "linear")``, shrinking (antialiased) and growing.

Tolerances, float32: outputs 1e-4 absolute (the resize 1e-6); gradients
1e-4 of each leaf's largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu.models.encoder import ConvEncoder as FlaxConvEncoder
from avr_tpu.models.encoder import ImageEncoder as FlaxImageEncoder
from avr_tpu.models.implicit import ImplicitNet as FlaxImplicitNet
from avr_tpu_torch.models.encoder import ConvEncoder, ImageEncoder
from avr_tpu_torch.models.flax_import import (load_flax_variables, to_flax_tree,
                                              to_flax_variables)
from avr_tpu_torch.models.implicit import ImplicitNet
from avr_tpu_torch.ops.resize import resize_linear
from tests.test_torch_model_options import _close_tree
from tests.test_torch_slice import _perturb
from tests.test_torch_training import _leaves

torch.set_num_threads(2)

TOL = 1e-4
t = lambda a: torch.from_numpy(np.array(a, np.float32))


def _grads(port, loss):
    params = dict(port.named_parameters())
    g = torch.autograd.grad(loss, list(params.values()))
    return to_flax_tree(dict(zip(params, g)))["params"]


# (kwargs, NS, with z)
IMPLICIT = {
    "skip_average_at_layer": (dict(skip_in=(2,), combine_layer=3), 2, True),
    "skip_max_at_layer": (dict(skip_in=(2, 4), combine_layer=3, combine_type="max"), 2, True),
    "after_last_layer": (dict(skip_in=(), beta=1.5), 2, True),
    "no_latent": (dict(skip_in=(3,), d_latent=0, combine_layer=2), 1, False),
}


@pytest.mark.parametrize("case", IMPLICIT)
def test_implicit_net_matches_flax(case):
    kw, ns, with_z = IMPLICIT[case]
    kw = dict(dict(d_in=7, d_out=4, n_layers=5, d_hidden=24, d_latent=10), **kw)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, ns, 6, 7)).astype(np.float32)
    z = rng.normal(size=(2, ns, 6, kw["d_latent"])).astype(np.float32) if with_z else None
    w = rng.normal(size=(2, 6, 4)).astype(np.float32)
    flax = FlaxImplicitNet(**kw)
    jz = None if z is None else jnp.asarray(z)
    variables = _perturb(flax.init(jax.random.PRNGKey(0), jnp.asarray(x), jz), rng)
    port = load_flax_variables(ImplicitNet(**kw), variables)

    def jloss(p):
        out = flax.apply({"params": p}, jnp.asarray(x), jz)
        return jnp.sum(out * w), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, variables["params"]))
    out = port(t(x), None if z is None else t(z))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=TOL)
    _close_tree(_grads(port, (out * t(w)).sum()), jg, what=case)


# (module pair, input side); ImageEncoder at resnet18, 64 pixels so that its
# last stage has a 2 x 2 grid: train-mode BatchNorm over 2 x 1 x 1 values
# amplifies rounding past any tolerance
ENCODERS = {
    "image_encoder_fc": (lambda: (FlaxImageEncoder(backbone="resnet18", latent_size=32),
                                  ImageEncoder("resnet18", 32)), 64),
    "image_encoder_512": (lambda: (FlaxImageEncoder(backbone="resnet18", latent_size=512),
                                   ImageEncoder("resnet18", 512)), 64),
    "conv_encoder": (lambda: (FlaxConvEncoder(), ConvEncoder()), 64),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", ENCODERS)
def test_encoder_matches_flax(case, train):
    make, side = ENCODERS[case]
    flax, port = make()
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, size=(2, side, side, 3)).astype(np.float32)
    variables = _perturb(flax.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    load_flax_variables(port, variables)
    if case == "conv_encoder":
        # the transposed convolutions come back as they went
        back = _leaves(to_flax_variables(port)["params"])
        for k, v in _leaves(variables["params"]).items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)
    else:
        assert hasattr(port, "fc") == (case == "image_encoder_fc")
    stats = variables.get("batch_stats", {})

    def jloss(p):
        v = {"params": p, **({"batch_stats": stats} if stats else {})}
        if train and stats:
            out, _ = flax.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        else:
            out = flax.apply(v, jnp.asarray(x), train=train)
        return jnp.sum(out * wj), out

    out = port(t(x) if case != "conv_encoder" else t(x).permute(0, 3, 1, 2), train)
    if case == "conv_encoder":
        out = out.permute(0, 2, 3, 1)  # the port's ConvEncoder is NCHW
    w = rng.normal(size=tuple(out.shape)).astype(np.float32)
    wj = jnp.asarray(w)
    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, variables["params"]))
    assert out.shape == jout.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0,
                               atol=TOL * max(1.0, float(np.abs(jout).max())))
    _close_tree(_grads(port, (out * t(w)).sum()), jg, what=case)


@pytest.mark.parametrize("hw", [(10, 12), (7, 9), (33, 17), (40, 48)])
def test_resize_linear_matches_jax(hw):
    """``feature_scale``'s resize: the antialiased triangle filter when it
    shrinks, linear interpolation when it grows (half-pixel centres)."""
    x = np.random.default_rng(0).normal(size=(2, 20, 24, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *hw, 3), "linear"))
    got = resize_linear(t(x), hw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
