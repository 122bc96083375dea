"""Port parity: the K1 gather's plain version against ``avr_tpu``.

Same numpy inputs through JAX ``gather_bilinear_windowed`` (the Pallas
kernel in interpret mode) and ``grid_sample_2d``, and through the port's
``gather_bilinear`` on CPU tensors (which takes the plain version).  Coords
span [-1.3, 1.3] (interior taps, the border clamp, out-of-range points) and
every row of the map (the windowed kernel then runs several windows per
block).  Tolerance 1e-5 abs: float32 on both sides, same formula.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu.ops.grid_sample import grid_sample_2d
from avr_tpu.ops.pallas.gather import gather_bilinear_windowed
from avr_tpu_torch.ops.grid_sample import grid_sample_2d as port_grid_sample
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.ops.kernels.gather import gather_bilinear, gather_bilinear_plain

torch.set_num_threads(2)


def _case(seed, B=2, H=20, W=8, C=16, N=600, scale=1.3):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, H, W, C)).astype(np.float32)
    coords = rng.uniform(-scale, scale, size=(B, N, 2)).astype(np.float32)
    # exact border and corner coordinates
    coords[:, :4] = [[-1.0, -1.0], [1.0, 1.0], [1.0, -1.0], [0.0, 1.0]]
    return feats, coords


@pytest.mark.parametrize("seed,shape", [
    (0, dict()),
    (1, dict(B=1, H=64, W=64, C=32, N=1000)),  # the slice's map side, many windows
    (2, dict(N=7)),  # below one kernel block
])
def test_gather_matches_pallas_and_xla(seed, shape):
    feats, coords = _case(seed, **shape)
    pallas = np.asarray(gather_bilinear_windowed(jnp.asarray(feats), jnp.asarray(coords), True))
    xla = np.asarray(grid_sample_2d(jnp.asarray(feats), jnp.asarray(coords)))
    got = gather_bilinear(torch.from_numpy(feats), torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-5)
    port = port_grid_sample(torch.from_numpy(feats), torch.from_numpy(coords)).numpy()
    np.testing.assert_array_equal(port, got)


def test_gather_matches_torch_grid_sample():
    """The port's function is ``F.grid_sample(align_corners=True, border)``."""
    feats, coords = _case(3)
    f, c = torch.from_numpy(feats), torch.from_numpy(coords)
    want = torch.nn.functional.grid_sample(
        f.permute(0, 3, 1, 2), c[:, None], mode="bilinear", padding_mode="border",
        align_corners=True)[:, :, 0].transpose(1, 2)
    # float32, two formulations of the same weights
    np.testing.assert_allclose(gather_bilinear(f, c).numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_bf16_map_keeps_dtype_and_blends_in_f32():
    feats, coords = _case(4)
    f = torch.from_numpy(feats).to(torch.bfloat16)
    c = torch.from_numpy(coords)
    out = gather_bilinear_plain(f, c)
    assert out.dtype == torch.bfloat16
    want = gather_bilinear_plain(f.float(), c).to(torch.bfloat16)
    np.testing.assert_array_equal(out.float().numpy(), want.float().numpy())


def test_cpu_tensors_never_launch():
    _build.reset_launches()
    feats, coords = _case(5)
    gather_bilinear(torch.from_numpy(feats), torch.from_numpy(coords))
    assert _build.launches["gather_bilinear"] == 0
