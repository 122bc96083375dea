"""Port parity: the K2 decoder's plain version against ``avr_tpu``.

A small decoder (d_hidden 128, 3 blocks, latent injection before the first
2, NS in {1, 2}) with the in-decoder positional encoding and the
``sigmoid / relu`` epilogue.  Flax initialises it (the zero-initialised
``fc_1`` perturbed so every block matters), ``load_flax_variables``
carries the weights into the port's ``ResnetFC``, and the same numpy
inputs go through the Pallas kernel in interpret mode, the Flax module's
plain path and the port (CPU tensors: the plain version).  Tolerance 1e-4
abs: float32 everywhere, sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu.models.mlp import ResnetFC as FlaxResnetFC
from avr_tpu.ops.pallas.resnetfc import CodeSpec as FlaxCodeSpec
from avr_tpu.ops.pallas.resnetfc import fused_resnetfc as pallas_resnetfc
from avr_tpu_torch.models.flax_import import load_flax_variables
from avr_tpu_torch.models.mlp import ResnetFC
from avr_tpu_torch.ops.kernels.resnetfc import CodeSpec, encode_tables, resnetfc_plain

torch.set_num_threads(2)

D_HIDDEN, D_LATENT, N_BLOCKS, N_LIN_Z = 128, 64, 3, 2
SPEC = dict(num_freqs=6, freq_factor=1.5, include_input=True, d_coded=3, d_pass=3)


@pytest.fixture(scope="module")
def flax_setup():
    rng = np.random.default_rng(31)
    spec = FlaxCodeSpec(**SPEC)
    mod = FlaxResnetFC(d_in=spec.d_enc, d_out=4, n_blocks=N_BLOCKS, d_latent=D_LATENT,
                       d_hidden=D_HIDDEN, combine_layer=N_LIN_Z, fused="never",
                       code_spec=spec, activate_out=True)
    x0 = jnp.zeros((1, 1, 2, spec.d_raw))
    z0 = jnp.zeros((1, 1, 2, D_LATENT))
    variables = mod.init(jax.random.PRNGKey(0), x0, z0)
    variables = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), variables)
    port = ResnetFC(spec.d_enc, 4, N_BLOCKS, D_LATENT, D_HIDDEN, N_LIN_Z,
                    code_spec=CodeSpec(**SPEC), activate_out=True)
    load_flax_variables(port, variables)
    return mod, variables, port


@pytest.mark.parametrize("ns", [1, 2])
def test_decoder_matches_pallas_and_flax(flax_setup, ns):
    mod, variables, port = flax_setup
    rng = np.random.default_rng(40 + ns)
    SB, B = 2, 37
    x = rng.uniform(-1.2, 1.2, size=(SB, ns, B, 6)).astype(np.float32)
    z = rng.normal(size=(SB, ns, B, D_LATENT)).astype(np.float32)

    flax_out = np.asarray(mod.apply(variables, jnp.asarray(x), jnp.asarray(z)))
    xt = jnp.asarray(np.swapaxes(x, 0, 1).reshape(ns, SB * B, 6))
    zt = jnp.asarray(np.swapaxes(z, 0, 1).reshape(ns, SB * B, D_LATENT))
    pallas_out = np.asarray(pallas_resnetfc(
        xt, zt, variables["params"], n_blocks=N_BLOCKS, n_lin_z=N_LIN_Z,
        compute_dtype=jnp.float32, interpret=True, code=FlaxCodeSpec(**SPEC),
        activate_out=True, stash=False)).reshape(SB, B, 4)

    with torch.inference_mode():
        got = port(torch.from_numpy(x), torch.from_numpy(z)).numpy()
    assert got.shape == (SB, B, 4)
    assert got[..., 3].min() >= 0 and 0 < got[..., :3].min() and got[..., :3].max() < 1
    np.testing.assert_allclose(got, flax_out, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, pallas_out, rtol=0, atol=1e-4)


def test_encode_tables_match_codespec_matrices():
    """The port's per-column tables are the JAX CodeSpec's (S0, F, PH)."""
    spec = FlaxCodeSpec(**SPEC)
    s0, f, ph = spec.matrices()
    mode, src, pf, pph = encode_tables(CodeSpec(**SPEC), spec.d_raw, spec.d_enc)
    np.testing.assert_array_equal(np.argmax(s0, axis=0), src)
    np.testing.assert_array_equal(s0.sum(axis=0), np.ones(spec.d_enc))
    np.testing.assert_array_equal(pf, f[0])
    np.testing.assert_array_equal(pph, ph[0])
    sin_cols = np.arange(spec.sin_lo, spec.sin_hi)
    np.testing.assert_array_equal(np.flatnonzero(mode == 1), sin_cols)
    # padded columns are zeros
    mode, _, _, _ = encode_tables(CodeSpec(**SPEC), spec.d_raw, 64)
    assert (mode[spec.d_enc:] == 2).all()


def test_bf16_operands_stay_close_to_f32(flax_setup):
    """bf16 operand rounding on a float32 trunk: a few 1e-2 at most."""
    _, _, port = flax_setup
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.uniform(-1, 1, size=(1, 50, 6)).astype(np.float32))
    z = torch.from_numpy(rng.normal(size=(1, 50, D_LATENT)).astype(np.float32))
    kw = dict(n_blocks=N_BLOCKS, n_lin_z=N_LIN_Z, code=CodeSpec(**SPEC), activate_out=True)
    w = [t.detach() for t in port.weights()]
    f32 = resnetfc_plain(x, z, w, compute_dtype=torch.float32, **kw)
    bf16 = resnetfc_plain(x, z, w, compute_dtype=torch.bfloat16, **kw)
    assert bf16.dtype == torch.float32
    assert 0 < float((f32 - bf16).abs().max()) < 5e-2
