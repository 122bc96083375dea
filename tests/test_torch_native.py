"""The port's native ray gather (``avr_tpu_torch/data/native.py`` over its
own ``avr_tpu_torch/csrc/ray_gather.cpp``) against its numpy twin and the
JAX package.

* ``gather_rays_native`` and ``gather_rays(impl="auto" | "native")`` give
  the arrays of ``gather_rays(impl="numpy")`` and of JAX's
  ``gather_rays(impl="numpy")`` bit for bit (values, dtypes, shapes), with
  and without bbox sampling, on batches of 1 and 3 scenes and 1 or 2 worker
  threads; ``decode_images`` gives ``u8 / 127.5 - 1`` and JAX's
  ``decode_images`` bit for bit for every uint8 value.
* The library is built from the port's source into ``avr_tpu_torch/_build``
  under a name that hashes the source and flags (never JAX's committed
  ``csrc/libavr_native.so``); a source that does not compile raises with
  the compiler's message, and indices out of range raise before the call.
"""

import os

import numpy as np
import pytest

from avr_tpu.data import native as jax_native
from avr_tpu.data import sampling as jax_sampling
from avr_tpu_torch.data import native
from avr_tpu_torch.data import sampling
from avr_tpu_torch.data.synthetic import synthetic_scene_set


def _batch(sb, nv=3, side=8, seed=0):
    """A collated ``(SB, NV, ...)`` batch of the synthetic set, with bboxes."""
    insts = synthetic_scene_set(sb, nv, side, seed=seed).all_instances
    rng = np.random.default_rng(seed)
    batch = {k: np.stack([np.stack([v[k] for v in views]) for views in insts])
             for k in ("cam2world", "intrinsics", "focal", "c", "x_pix", "images")}
    lo = rng.integers(0, side // 2, size=(sb, nv, 2))
    hi = lo + rng.integers(1, side // 2, size=(sb, nv, 2))
    batch["bbox"] = np.concatenate([lo, hi], -1).astype(np.float32)
    return batch


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sb", [1, 3])
@pytest.mark.parametrize("with_bbox", [False, True])
def test_gather_rays_native_equals_numpy_and_jax(sb, with_bbox):
    batch = _batch(sb)
    want = jax_sampling.gather_rays(np.random.default_rng(4), batch, 37, with_bbox, impl="numpy")
    for impl in ("numpy", "auto", "native"):
        got = sampling.gather_rays(np.random.default_rng(4), batch, 37, with_bbox, impl=impl)
        assert got[0].keys() == want[0].keys()
        for k in want[0]:
            _same(got[0][k], want[0][k])
        _same(got[1], want[1])


@pytest.mark.parametrize("threads", [1, 2])
def test_gather_rays_native_threads(threads):
    batch = _batch(3)
    idx = sampling.sample_ray_indices(np.random.default_rng(2), batch, 50)
    got = native.gather_rays_native(batch, idx, num_threads=threads)
    want = sampling.gather_rays(np.random.default_rng(2), batch, 50, impl="numpy")
    for k in want[0]:
        _same(got[0][k], want[0][k])
    _same(got[1], want[1])


def test_decode_images_equals_numpy_and_jax():
    img = np.arange(256, dtype=np.uint8).reshape(4, 8, 8)
    img = np.stack([img, img[::-1], img[:, ::-1]], -1)  # (4, 8, 8, 3)
    got = native.decode_images(img)
    _same(got, (img.astype(np.float32) / 127.5 - 1.0).astype(np.float32))
    _same(got, jax_native.decode_images(img))
    assert got.min() == -1.0 and got.max() == 1.0


def test_the_library_is_the_ports_own_build():
    lib = native.load_native()
    path = lib._name
    assert os.path.dirname(path) == str(native.BUILD_DIR)
    assert os.path.basename(path).startswith("libavr_native_") and path.endswith(".so")
    assert native.SOURCE == native.CSRC / "ray_gather.cpp" and native.SOURCE.exists()
    assert native.load_native() is lib  # loaded once


def test_broken_source_raises(tmp_path, monkeypatch):
    bad = tmp_path / "ray_gather.cpp"
    bad.write_text(native.SOURCE.read_text().replace("return 0;", "return 0", 1))
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="building the native ray gather failed") as e:
        sampling.gather_rays(np.random.default_rng(0), _batch(1), 8)
    assert "error" in str(e.value)
    assert not [p for p in (tmp_path / "_build").iterdir() if p.suffix == ".so"]


def test_indices_out_of_range_raise():
    batch = _batch(2)
    nv_sl2 = batch["images"].shape[1] * batch["images"].shape[2]
    for bad in (-1, nv_sl2):
        idx = np.zeros((2, 5), np.int64)
        idx[1, 3] = bad
        with pytest.raises(IndexError):
            native.gather_rays_native(batch, idx)


def test_the_kernels_library_name_ignores_the_host_gather(tmp_path, monkeypatch):
    """The CUDA library's name hashes the kernels' sources and headers only:
    an edit of ``ray_gather.cpp`` does not rebuild the kernels, an edit of
    a ``.cu`` or ``.cuh`` does; both builds take their paths from one place."""
    from avr_tpu_torch import _paths
    from avr_tpu_torch.ops.kernels import _build

    assert (_build.CSRC, _build.BUILD_DIR) == (_paths.CSRC, _paths.BUILD_DIR)
    assert (native.CSRC, native.BUILD_DIR) == (_paths.CSRC, _paths.BUILD_DIR)
    copy = tmp_path / "csrc"
    copy.mkdir()
    for f in _paths.CSRC.iterdir():
        (copy / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", copy)
    base = _build._digest()
    (copy / "ray_gather.cpp").write_text("// edited\n")
    assert _build._digest() == base
    for name in ("march.cu", "common.cuh"):
        (copy / name).write_text((copy / name).read_text() + "\n// edited\n")
        assert _build._digest() != base
        base = _build._digest()
