"""The port's host-side data and metrics pieces, bit for bit against
``avr_tpu``.

* ``utils/metrics.py``: ``psnr``, ``ssim`` (2D and multichannel, another
  window) and ``get_metrics`` (fine and coarse, 3D and 4D render outputs,
  the port's given torch tensors) equal JAX's exactly.
* ``data/sampling.py``: ``sample_ray_indices`` (uniform and bbox),
  ``bbox_sample`` and ``gather_rays(impl="numpy")`` and ``impl="auto"``
  from the same generator state equal JAX's ``impl="numpy"`` arrays;
  ``impl="native"`` raises (``data/native.py`` is not ported).
* ``data/dataset.py``: ``SceneClassDataset`` read from a synthetic HDF5
  file (JAX's ``write_synthetic_hdf5``), and from the port's in-memory
  mapping of the same set with ``h5py`` made unimportable: every item's
  arrays, the resized items (``img_sidelength``), ``max_num_instances``,
  ``num_images``, the per-host stride, and ``batches(epoch_seed, skip)``
  (the deterministic resume stream) with and without ``shuffle`` and
  ``drop_last``, and the legacy stream (no ``epoch_seed``).
* ``select_source_views`` and ``assemble_step_inputs`` against JAX's, and
  ``PrefetchPipeline`` on and off: the same stream, bit for bit.
* ``MetricsLogger``: the same JSONL records as JAX's, but the time.
"""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from avr_tpu.data import dataset as jds  # noqa: E402
from avr_tpu.data import sampling as jsamp  # noqa: E402
from avr_tpu.data.prefetch import PrefetchPipeline as JaxPrefetch  # noqa: E402
from avr_tpu.data.synthetic import write_synthetic_hdf5  # noqa: E402
from avr_tpu.renderers.base import RenderOutput as JaxRenderOutput  # noqa: E402
from avr_tpu.training import loop as jloop  # noqa: E402
from avr_tpu.utils import metrics as jmet  # noqa: E402
from avr_tpu.utils.logging import MetricsLogger as JaxLogger  # noqa: E402
from avr_tpu_torch.data import dataset as tds  # noqa: E402
from avr_tpu_torch.data import sampling as tsamp  # noqa: E402
from avr_tpu_torch.data.prefetch import PrefetchPipeline  # noqa: E402
from avr_tpu_torch.data.synthetic import synthetic_scene_mapping  # noqa: E402
from avr_tpu_torch.renderers.base import RenderOutput  # noqa: E402
from avr_tpu_torch.training import loop as tloop  # noqa: E402
from avr_tpu_torch.utils import metrics as tmet  # noqa: E402
from avr_tpu_torch.utils.logging import MetricsLogger  # noqa: E402

torch.set_num_threads(2)

NI, NV, SIDE, SEED = 5, 6, 24, 3


@pytest.fixture(scope="module")
def h5path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data") / "scenes.h5")
    return write_synthetic_hdf5(path, num_instances=NI, num_views=NV, side=SIDE, seed=SEED)


@pytest.fixture
def no_h5py(monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)


def _same(got, want, what=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            _same(got[k], want[k], f"{what}/{k}")
        return
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    want = np.asarray(want)
    assert np.asarray(got).dtype == want.dtype, (what, np.asarray(got).dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def test_psnr_and_ssim_equal_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(20, 18, 3)).astype(np.float32)
    b = np.clip(a + 0.05 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    assert tmet.psnr(a, b) == jmet.psnr(a, b)
    assert tmet.psnr(a, a) == jmet.psnr(a, a) == float("inf")
    assert tmet.ssim(a, b) == jmet.ssim(a, b)
    assert tmet.ssim(a[..., 0], b[..., 0]) == jmet.ssim(a[..., 0], b[..., 0])
    assert tmet.ssim(a, b, win_size=5, data_range=2.0) == jmet.ssim(a, b, win_size=5,
                                                                    data_range=2.0)


@pytest.mark.parametrize("fine", [True, False])
@pytest.mark.parametrize("nv", [None, 2])
def test_get_metrics_equals_jax(fine, nv):
    rng = np.random.default_rng(1)
    shape = (2, 16 * 16, 3) if nv is None else (2, nv, 16 * 16, 3)
    coarse, fine_img, gt = (rng.uniform(size=shape).astype(np.float32) for _ in range(3))
    want = jmet.get_metrics(JaxRenderOutput(jnp.asarray(coarse), jnp.asarray(fine_img),
                                            None, None), gt, fine=fine)
    got = tmet.get_metrics(RenderOutput(torch.from_numpy(coarse), torch.from_numpy(fine_img),
                                        None, None), gt, fine=fine)
    assert got == want


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

DSET_KW = [dict(), dict(img_sidelength=16), dict(max_num_instances=3, num_shards=2,
                                                 shard_index=1),
           dict(max_observations_per_instance=4, samples_per_instance=3, seed=5),
           dict(specific_observation_idcs=[2, 0], samples_per_instance=3)]


def _port_dset(h5path, source, **kw):
    src = h5path if source == "hdf5" else synthetic_scene_mapping(NI, NV, SIDE, seed=SEED)
    return tds.SceneClassDataset(src, **kw)


@pytest.mark.parametrize("kw", DSET_KW, ids=lambda kw: ",".join(kw) or "default")
@pytest.mark.parametrize("source", ["hdf5", "mapping"])
def test_dataset_items_equal_jax(request, h5path, source, kw):
    jd = jds.SceneClassDataset(h5path, **kw)
    order = (0, jd.num_instances - 1, 0)
    # read JAX's items before h5py may be blocked
    want_views = [[inst[v] for v in range(len(inst))] for inst in jd.all_instances]
    want_items = [jd[i] for i in order]  # from the dataset's own generator, in turn
    if source == "mapping":
        request.getfixturevalue("no_h5py")
    got = _port_dset(h5path, source, **kw)
    assert got.num_instances == jd.num_instances == len(got)
    assert got.instance_keys == jd.instance_keys
    for i, views in enumerate(want_views):
        assert len(got.all_instances[i]) == len(views)
        for v, w in enumerate(views):
            _same(got.all_instances[i][v], w, f"{i}/{v}")
    for i, w in zip(order, want_items):
        g = got[i]
        assert len(g) == len(w)
        for a, b in zip(g, w):
            _same(a, b)


BATCH_KW = [dict(batch_size=2, epoch_seed=0), dict(batch_size=2, epoch_seed=3, skip=1),
            dict(batch_size=2, epoch_seed=1, shuffle=False),
            dict(batch_size=3, epoch_seed=2, drop_last=False, skip=1),
            dict(batch_size=2), dict(batch_size=2, skip=1)]


@pytest.mark.parametrize("kw", BATCH_KW, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("source", ["hdf5", "mapping"])
def test_batches_equal_jax(request, h5path, source, kw):
    want = list(jds.SceneClassDataset(h5path, samples_per_instance=3).batches(**kw))
    if source == "mapping":
        request.getfixturevalue("no_h5py")
    got = list(_port_dset(h5path, source, samples_per_instance=3).batches(**kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _same(g, w)


def test_skip_resumes_the_stream(h5path):
    d = tds.SceneClassDataset(h5path, samples_per_instance=2)
    full = list(d.batches(1, epoch_seed=4))
    resumed = list(d.batches(1, epoch_seed=4, skip=2))
    assert len(resumed) == len(full) - 2
    for g, w in zip(resumed, full[2:]):
        _same(g, w)


def test_hdf5_without_h5py_raises(h5path, no_h5py):
    with pytest.raises(ImportError, match="mapping"):
        tds.SceneClassDataset(h5path)


def test_collate_and_pixel_grid_equal_jax():
    assert np.array_equal(tds.pixel_grid(5, 7), jds.pixel_grid(5, 7))
    rng = np.random.default_rng(2)
    scenes = [[{"a": rng.normal(size=(3,)).astype(np.float32), "b": np.int64(v)}
               for v in range(3)] for _ in range(2)]
    _same(tds.collate_observations(scenes), jds.collate_observations(scenes))
    img = rng.integers(0, 256, size=(9, 11, 3)).astype(np.uint8)
    _same(tds._resize_bilinear_u8(img, 6), jds._resize_bilinear_u8(img, 6))


# ---------------------------------------------------------------------------
# sampling and the step inputs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def batch(h5path):
    return next(jds.SceneClassDataset(h5path, samples_per_instance=4).batches(3, epoch_seed=0))


@pytest.mark.parametrize("with_bbox", [False, True])
def test_sampling_equals_jax(batch, with_bbox):
    got = tsamp.sample_ray_indices(np.random.default_rng(5), batch, 50, with_bbox)
    want = jsamp.sample_ray_indices(np.random.default_rng(5), batch, 50, with_bbox)
    _same(got, want)
    _same(tsamp.bbox_sample(np.random.default_rng(6), batch["bbox"][0], 30),
          jsamp.bbox_sample(np.random.default_rng(6), batch["bbox"][0], 30))
    want = jsamp.gather_rays(np.random.default_rng(7), batch, 40, with_bbox, impl="numpy")
    for impl in ("numpy", "auto", "native"):
        got = tsamp.gather_rays(np.random.default_rng(7), batch, 40, with_bbox, impl=impl)
        _same(got[0], want[0])
        _same(got[1], want[1])
    with pytest.raises(ValueError, match="impl"):
        tsamp.gather_rays(np.random.default_rng(7), batch, 40, impl="xla")


@pytest.mark.parametrize("ns, fixed", [(1, None), (2, None), (2, [1, 3])])
def test_select_source_views_equals_jax(batch, ns, fixed):
    want = jloop.select_source_views(np.random.default_rng(8), batch, ns, fixed_idx=fixed)
    got = tloop.select_source_views(np.random.default_rng(8), batch, ns, fixed_idx=fixed,
                                    device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        _same(g, w)


@pytest.mark.parametrize("with_bbox", [False, True])
def test_assemble_step_inputs_equals_jax(batch, with_bbox):
    want = jloop.assemble_step_inputs(jloop.step_rng(3, 7), batch, 40, 2, with_bbox)
    got = tloop.assemble_step_inputs(tloop.step_rng(3, 7), batch, 40, 2, with_bbox,
                                     device="cpu")
    for g, w in zip(got, want):
        _same(g, jnp_to_np(w))


def jnp_to_np(tree):
    if isinstance(tree, dict):
        return {k: np.asarray(v) for k, v in tree.items()}
    return np.asarray(tree)


def _stream(pipe_or_list):
    return [(g, inputs) for g, inputs in pipe_or_list]


@pytest.mark.parametrize("skip", [0, 1])
def test_prefetch_equals_sync_and_jax(h5path, skip):
    """The prefetched stream equals the synchronous one (``fit``'s
    ``prefetch=0`` stream) and JAX's prefetched stream, bit for bit."""
    from avr_tpu_torch.training.loop import FitConfig, _epoch_inputs

    d = tds.SceneClassDataset(h5path, samples_per_instance=3)
    pre = _stream(PrefetchPipeline(d, 2, 24, num_source_views=2, depth=2, seed=9,
                                   device="cpu").epoch(epoch_seed=1, start_step=4, skip=skip))
    cfg = FitConfig(batch_size=2, ray_batch_size=24, num_source_views=2, seed=9, prefetch=0)
    sync = _stream(_epoch_inputs(d, cfg, 1, 4 + skip, skip, torch.device("cpu")))
    jpre = _stream(JaxPrefetch(jds.SceneClassDataset(h5path, samples_per_instance=3), 2, 24,
                               num_source_views=2, depth=2, seed=9).epoch(
        epoch_seed=1, start_step=4, skip=skip))
    assert [g for g, _ in pre] == [g for g, _ in sync] == [g for g, _ in jpre] \
        == list(range(4 + skip, 6))
    for (_, a), (_, b), (_, w) in zip(pre, sync, jpre):
        for x, y, z in zip(a, b, w):
            _same(x, y)
            _same(x, jnp_to_np(z))


def test_prefetch_stops_its_worker_when_the_consumer_stops(h5path):
    d = tds.SceneClassDataset(h5path, samples_per_instance=2)
    it = PrefetchPipeline(d, 1, 8, depth=1, device="cpu").epoch(epoch_seed=0)
    next(it)
    it.close()  # the worker ends instead of blocking on the full queue


def test_prefetch_raises_the_workers_error(h5path):
    d = tds.SceneClassDataset(h5path, samples_per_instance=2)
    with pytest.raises(ValueError):
        list(PrefetchPipeline(d, 1, -1, depth=1, device="cpu").epoch(epoch_seed=0))


def test_logger_writes_jax_records(tmp_path, capsys):
    recs = []
    for cls, sub in ((JaxLogger, "jax"), (MetricsLogger, "port")):
        log = cls(str(tmp_path / sub), name="run")
        log.log("train", epoch=1, step=5, loss=np.float32(0.25), grad_norm=torch.tensor(2.0),
                rays_per_s=1234.5)
        log.log("checkpoint", epoch=1, path="/x/run_epoch1")
        log.close()
        lines = (tmp_path / sub / "run.jsonl").read_text().splitlines()
        recs.append([{k: v for k, v in json.loads(l).items() if k != "t"} for l in lines])
    assert recs[0] == recs[1]
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == out[2:]
