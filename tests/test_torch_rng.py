"""Port parity of the threefry key stream and of K7's plain version.

* ``avr_tpu_torch.ops.threefry`` against ``jax.random`` (threefry keys,
  ``jax_threefry_partitionable`` on): ``PRNGKey``, ``bits``, ``uniform``,
  ``split``, ``fold_in`` and ``randint`` bit for bit, on several keys and
  shapes (``randint`` at spans 64, 50 and 819,200: at 819,200 the
  multiplier's square is ``2**32`` and must wrap to 0); ``normal`` within
  5e-5 absolute (JAX's and PyTorch's ``erfinv`` differ in the last bits:
  2.2e-5 measured at (4, 81,920)).
* ``uniform_2d_plain`` against ``avr_tpu.ops.sampling._uniform_2d`` on the
  CPU (a ``jax.random.uniform`` draw there), 2-D and 3-D, bit for bit.
* The four contract tests of ``tests/test_pallas_rng.py`` (which run only
  on a TPU), on the plain version: range and moments, determinism and key
  sensitivity, decorrelated column blocks, a ragged shape.
* A CPU device never launches the kernel or loads the library; any other
  device than the CPU and CUDA is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu.ops.sampling import _normal_2d as jax_normal_2d
from avr_tpu.ops.sampling import _uniform_2d as jax_uniform_2d
from avr_tpu_torch.ops import threefry
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.ops.kernels.rng import bits, uniform_2d, uniform_2d_plain
from avr_tpu_torch.ops.sampling import _normal_2d, _uniform_2d

torch.set_num_threads(2)

SEEDS = (0, 7, 2 ** 32 + 123, 987654321)
SHAPES = ((4, 81_920), (1, 1_000), (3, 7, 5))


@pytest.fixture(autouse=True)
def _threefry_partitionable():
    assert jax.config.jax_threefry_partitionable, "the port follows the partitionable stream"
    assert jax.config.jax_default_prng_impl == "threefry2x32"


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _words(a):
    return tuple(int(x) for x in np.asarray(a).reshape(-1))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_split_and_fold_in_match_jax(seed):
    jk, k = _jkey(seed), threefry.PRNGKey(seed)
    assert _words(jk) == tuple(k) and isinstance(k, tuple) and k == (k.k0, k.k1)
    for n in (1, 2, 3, 8):
        assert [_words(r) for r in jax.random.split(jk, n)] == [tuple(s) for s in
                                                                threefry.split(k, n)]
    for d in (0, 1, 5, 2 ** 31 + 3, 2 ** 32 - 1):
        assert _words(jax.random.fold_in(jk, d)) == tuple(threefry.fold_in(k, d))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_and_uniform_match_jax(seed, shape):
    jk, k = _jkey(seed), threefry.PRNGKey(seed)
    want = np.asarray(jax.random.bits(jk, shape)).astype(np.int64)
    got = threefry.random_bits(k, shape, "cpu")
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)
    want_u = np.asarray(jax.random.uniform(jk, shape))
    got_u = threefry.uniform(k, shape, "cpu")
    assert got_u.dtype == torch.float32
    np.testing.assert_array_equal(got_u.numpy().view(np.int32), want_u.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS[:2])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_normal_matches_jax(seed, shape):
    want = np.asarray(jax.random.normal(_jkey(seed), shape))
    got = threefry.normal(threefry.PRNGKey(seed), shape, "cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    assert (got == want).mean() > 0.2  # most differ by an ulp at most


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("span", [64, 50, 819_200, 1])
def test_randint_matches_jax(seed, span):
    jk, k = _jkey(seed), threefry.PRNGKey(seed)
    for shape in ((4,), (4, 1), (4, 4096)):
        want = np.asarray(jax.random.randint(jk, shape, 0, span))
        got = threefry.randint(k, shape, 0, span, "cpu")
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jax.random.randint(jk, (3, 9), 5, 5 + span))
    np.testing.assert_array_equal(threefry.randint(k, (3, 9), 5, 5 + span, "cpu").numpy(), want)


def test_randint_multiplier_wraps():
    """At the device sampler's span 50 * 128**2 the multiplier's square is
    exactly 2**32: without the wrap the indices differ from JAX's."""
    span = 50 * 128 ** 2
    assert ((2 ** 16) % span) ** 2 == 2 ** 32
    k = threefry.PRNGKey(11)
    got = threefry.randint(k, (2, 512), 0, span, "cpu")
    hi, lo = (threefry.random_bits(s, (2, 512), "cpu") for s in threefry.split(k, 2))
    unwrapped = ((hi % span) * ((2 ** 16) % span) ** 2 + lo % span) % span
    assert not torch.equal(got, unwrapped)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.random.randint(jax.random.PRNGKey(11), (2, 512), 0, span)))


@pytest.mark.parametrize("shape", [(2, 4096), (3, 20, 7), (4, 4096, 20)], ids=str)
def test_uniform_2d_plain_matches_the_jax_sampler_draw(shape):
    """The JAX package's sampler draw on the CPU (``jax.random.uniform``
    over the flat 2-D shape) against the port's, bit for bit; the normal
    within the erfinv tolerance."""
    jk, k = _jkey(42), threefry.PRNGKey(42)
    want = np.asarray(jax_uniform_2d(jk, shape, jnp.float32))
    got = _uniform_2d(k, shape, "cpu")
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    flat = (shape[0], int(np.prod(shape[1:])))
    np.testing.assert_array_equal(uniform_2d_plain(k, flat).reshape(shape).numpy(), got.numpy())
    np.testing.assert_allclose(_normal_2d(k, shape, "cpu").numpy(),
                               np.asarray(jax_normal_2d(jk, shape)), rtol=0, atol=5e-5)


def test_threefry_draws_are_float32_only():
    with pytest.raises(TypeError, match="float32"):
        _uniform_2d(threefry.PRNGKey(0), (2, 8), "cpu", torch.bfloat16)
    with pytest.raises(TypeError, match="threefry Key"):
        threefry.split((0, 1))


# the contract of tests/test_pallas_rng.py, held by the plain version


def test_uniform_range_and_moments():
    u = uniform_2d_plain(threefry.PRNGKey(0), (4, 81_920)).numpy()
    assert u.shape == (4, 81_920)
    assert u.min() >= 0.0 and u.max() < 1.0
    np.testing.assert_allclose(u.mean(), 0.5, atol=5e-3)
    np.testing.assert_allclose(u.var(), 1.0 / 12.0, atol=5e-3)


def test_uniform_deterministic_and_key_sensitive():
    a = uniform_2d_plain(threefry.PRNGKey(7), (2, 4096)).numpy()
    b = uniform_2d_plain(threefry.PRNGKey(7), (2, 4096)).numpy()
    c = uniform_2d_plain(threefry.PRNGKey(8), (2, 4096)).numpy()
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0.1


def test_uniform_blocks_decorrelated():
    u = uniform_2d_plain(threefry.PRNGKey(3), (2, 16_384)).numpy()
    blk0, blk1 = u[:, :8192], u[:, 8192:]
    assert np.abs(blk0 - blk1).max() > 0.1
    assert abs(np.corrcoef(blk0.ravel(), blk1.ravel())[0, 1]) < 0.02


def test_uniform_ragged_cols():
    u = uniform_2d_plain(threefry.PRNGKey(1), (3, 1000)).numpy()
    assert u.shape == (3, 1000)
    assert u.min() >= 0.0 and u.max() < 1.0


def test_cpu_draws_never_touch_the_kernel_library():
    _build.reset_launches()
    k = threefry.PRNGKey(5)
    np.testing.assert_array_equal(uniform_2d(k, (2, 300), "cpu").numpy(),
                                  uniform_2d_plain(k, (2, 300)).numpy())
    assert bits(k, (2, 300), "cpu").max() < 2 ** 32
    assert uniform_2d(k, (0, 5), "cpu").shape == (0, 5)
    assert not _build.launches and _build._lib is None
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        uniform_2d(k, (2, 3), "meta")
    with pytest.raises(ValueError, match="2-D"):
        uniform_2d(k, (2, 3, 4), "cpu")
