"""Port parity: the per-ray counter hash is bit-exact against ``avr_tpu``.

The same ray ids and key words go through ``avr_tpu.ops.hashrng`` (JAX,
uint32) and ``avr_tpu_torch.ops.hashrng`` (int64 words masked to 32 bits):
seeds, salts and uniforms must be equal bit for bit (integer / exact float
equality), normals within 1e-6 (``log1p``/``cos`` may differ in the last
ulp between XLA and PyTorch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu.ops import hashrng as jh
from avr_tpu_torch.ops import hashrng as th

torch.set_num_threads(2)


def _words(key):
    """The two key words ``avr_tpu.ops.hashrng.derive`` reads."""
    kd = np.asarray(key).ravel().astype(np.uint32)
    return int(kd[0]), int(kd[-1])


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def test_mul32_matches_uint32_wraparound():
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.integers(0, 2**32, 1000, dtype=np.uint64),
                        np.asarray([0, 1, 2**31, 2**32 - 1], np.uint64)]).astype(np.uint32)
    for m in (0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9, 0xFFFFFFFF):
        want = a * np.uint32(m)  # numpy uint32 wraps
        got = th._mul32(torch.from_numpy(a.astype(np.int64)), m)
        np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_derive_bit_exact(seed):
    key = jax.random.PRNGKey(seed)
    k0, k1 = _words(key)
    want = np.asarray(jh.derive(key, jh.global_ray_ids(3, 257)).seeds)
    got = th.derive(k0, k1, th.global_ray_ids(3, 257)).seeds
    np.testing.assert_array_equal(_u32(got), want)


def test_derive_ids_near_u32_wrap():
    gids = np.asarray([[0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]], np.uint32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jh.derive(key, jnp.asarray(gids)).seeds)
    got = th.derive(*_words(key), torch.from_numpy(gids.astype(np.int64))).seeds
    np.testing.assert_array_equal(_u32(got), want)


def test_split_salts_and_uniform_bit_exact():
    key = jax.random.PRNGKey(11)
    jr = jh.derive(key, jh.global_ray_ids(2, 50))
    tr = th.derive(*_words(key), th.global_ray_ids(2, 50))
    for (ja, jb), (ta, tb) in [(jh.split_any(jr), th.split_any(tr))]:
        for j, t in ((ja, ta), (jb, tb)):
            assert j.salt == t.salt
            for shape in ((2, 50), (2, 50, 20), (2, 50, 3, 4)):
                want = np.asarray(jh.hash_uniform(j, shape))
                got = th.hash_uniform(t, shape).numpy()
                assert got.dtype == np.float32 and got.shape == shape
                np.testing.assert_array_equal(got, want)
    deep = tr.fold(5).fold(123456).fold(2**31)
    assert deep.salt == jr.fold(5).fold(123456).fold(2**31).salt


def test_hash_normal_matches():
    key = jax.random.PRNGKey(4)
    jr = jh.derive(key, jh.global_ray_ids(2, 300))
    tr = th.derive(*_words(key), th.global_ray_ids(2, 300))
    for shape in ((2, 300), (2, 300, 5)):
        want = np.asarray(jh.hash_normal(jr, shape))
        got = th.hash_normal(tr, shape).numpy()
        # log1p / cos in XLA vs PyTorch: last-ulp differences only
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_chunked_ids_equal_global_ids():
    """A ray chunk of the train step gets the slice of the whole batch's
    seed map (JAX's global ids), so chunking never changes a ray's random
    numbers."""
    from avr_tpu_torch.training.step import _chunk_keys

    key = jax.random.PRNGKey(3)
    full = np.asarray(jh.derive(key, jh.global_ray_ids(2, 64)).seeds)
    chunks = _chunk_keys((0, 3), 2, 64, 4, "per_ray", torch.device("cpu"))
    for i, rs in enumerate(chunks):
        np.testing.assert_array_equal(_u32(rs.seeds), full[:, 16 * i:16 * (i + 1)])


def test_shape_mismatch_raises():
    tr = th.derive(0, 1, th.global_ray_ids(2, 5))
    with pytest.raises(ValueError):
        th.hash_uniform(tr, (2, 6))
