"""Port parity: the K3 march's plain version against ``avr_tpu``.

The inputs of ``tests/test_pallas_march.py`` (3 steps, hidden 16, 8x8x32
maps, NS in {1, 2}) go through the Pallas kernel in interpret mode, that
file's plain-jnp reference march, and the port's ``fused_lstm_march`` on CPU
tensors (its plain version), with early stop off and on.  Tolerance 1e-4
abs: float32 on both sides; the recurrence amplifies last-bit differences
of the transcendentals, so the step count stays at 3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu.ops.pallas.march import fused_lstm_march as pallas_march
from avr_tpu.ops.pallas.march import pack_projection as jax_pack_projection
from avr_tpu_torch.ops.kernels.march import fused_lstm_march, pack_projection
from tests.test_pallas_march import STEPS, _inputs, _ref_march

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("ns,eps", [(1, 0.0), (2, 0.0), (1, 0.05), (2, 0.3)])
def test_march_matches_pallas_and_reference(ns, eps):
    inp = _inputs(seed=4, ns=ns)
    names = ("feat", "poses", "focal", "c", "latent_scaling", "image_shape", "coords0",
             "rds", "wih", "whh", "bias", "wout", "bout")
    ref = np.asarray(_ref_march(*(inp[n] for n in names), early_stop_eps=eps))
    pallas = np.asarray(pallas_march(
        inp["proj"], inp["coords0"], inp["rds"], inp["feat"], inp["wih"], inp["whh"],
        inp["bias"], inp["wout"], inp["bout"], steps=STEPS, early_stop_eps=eps,
        compute_dtype=jnp.float32, interpret=True))
    got = fused_lstm_march(
        _t(inp["proj"]), _t(inp["coords0"]), _t(inp["rds"]), _t(inp["feat"]), _t(inp["wih"]),
        _t(inp["whh"]), _t(inp["bias"]), _t(inp["wout"]), _t(inp["bout"]), steps=STEPS,
        early_stop_eps=eps, compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    if eps == 0.05:  # the threshold binds: some rays froze early
        free = fused_lstm_march(
            _t(inp["proj"]), _t(inp["coords0"]), _t(inp["rds"]), _t(inp["feat"]),
            _t(inp["wih"]), _t(inp["whh"]), _t(inp["bias"]), _t(inp["wout"]),
            _t(inp["bout"]), steps=STEPS, compute_dtype=torch.float32).numpy()
        assert not np.allclose(got, free)


def test_pack_projection_matches():
    inp = _inputs(seed=1, ns=2)
    want = np.asarray(jax_pack_projection(inp["poses"], inp["focal"], inp["c"],
                                          inp["latent_scaling"], inp["image_shape"]))
    got = pack_projection(_t(inp["poses"]), _t(inp["focal"]), _t(inp["c"]),
                          _t(inp["latent_scaling"]), _t(inp["image_shape"])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_bf16_operands_round_only_the_products():
    """bf16 compute dtype: the plain march stays within a step's rounding
    of the float32 march after 1 step (the carries stay float32)."""
    inp = _inputs(seed=2, ns=1)
    args = [_t(inp[k]) for k in ("proj", "coords0", "rds", "feat", "wih", "whh", "bias",
                                 "wout", "bout")]
    args[3] = args[3].to(torch.bfloat16)
    f32 = fused_lstm_march(*args[:3], args[3].float(), *args[4:], steps=1,
                           compute_dtype=torch.float32)
    bf16 = fused_lstm_march(*args, steps=1, compute_dtype=torch.bfloat16)
    assert bf16.dtype == torch.float32
    assert float((f32 - bf16).abs().max()) < 1e-2
