"""Port parity of the device-resident dataset, its sampler and the
device-data train step against ``avr_tpu``.

One synthetic set (3 instances x 5 views of 32x32, JAX's
``write_synthetic_hdf5``) is read through JAX's ``SceneClassDataset``; both
packages build their device set from that one reader (the port's on the
CPU).  Held bit for bit: the uploaded arrays, the port's in-memory
``synthetic_scene_set`` against what the reader gives, the sampler's
indices (three ``randint`` draws, through K7's plain version) and every
array it gathers.  Then one device-data train step of the small VR model
(``test_torch_chunked.py``'s, SB 2 x 48 rays) in each ``rng_mode``, at
``state.step`` 0 and 3, against JAX's ``make_train_step(sampler=...)``,
by ``test_torch_chunked.py``'s comparison: the loss to 1e-5, the gradient
norm to 1e-3 relative, the BatchNorm statistics to 1e-4, and every
gradient element to ``DD_TOL`` of its leaf's largest value.  The focal and
principal point must be one for the whole set, or the build raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from avr_tpu.data.dataset import SceneClassDataset  # noqa: E402
from avr_tpu.data.device import build_device_dataset as jax_build_device_dataset  # noqa: E402
from avr_tpu.data.device import make_device_sampler as jax_make_device_sampler  # noqa: E402
from avr_tpu.data.synthetic import write_synthetic_hdf5  # noqa: E402
from avr_tpu.training import LossParams as JaxLossParams  # noqa: E402
from avr_tpu.training import create_train_state as jax_create_state  # noqa: E402
from avr_tpu.training import make_optimizer as jax_make_optimizer  # noqa: E402
from avr_tpu.training import make_train_step as jax_make_train_step  # noqa: E402
from avr_tpu_torch.data import synthetic  # noqa: E402
from avr_tpu_torch.data.device import build_device_dataset, make_device_sampler  # noqa: E402
from avr_tpu_torch.models.flax_import import to_flax_tree, to_flax_variables  # noqa: E402
from avr_tpu_torch.ops import threefry  # noqa: E402
from avr_tpu_torch.ops.kernels import _build  # noqa: E402
from avr_tpu_torch.training import (LossParams, create_train_state,  # noqa: E402
                                    make_optimizer, make_train_step)
from tests.test_torch_chunked import _compare, _models  # noqa: E402
from tests.test_torch_training import _leaves  # noqa: E402

torch.set_num_threads(2)

NI, NV, SIDE, SB, R = 3, 5, 32, 2, 48
# float32 sums in other orders, as test_torch_chunked.py's VR_TOL; on these
# mostly white scenes a few weight-gradient elements are sums whose terms
# cancel, where the order moves them by up to 2.4e-4 of their leaf's largest
# value (measured; 3e-6 in the other leaves).  A batch drawn with another
# key or index moves the loss itself far beyond its 1e-5.
DD_TOL = 1e-3


@pytest.fixture(scope="module")
def dset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("synthetic") / "scenes.h5")
    write_synthetic_hdf5(path, num_instances=NI, num_views=NV, side=SIDE, seed=4)
    return SceneClassDataset(path)


@pytest.fixture(scope="module")
def sets(dset):
    return jax_build_device_dataset(dset), build_device_dataset(dset, device="cpu")


def test_synthetic_scene_set_matches_the_hdf5_reader(dset):
    mem = synthetic.synthetic_scene_set(NI, NV, SIDE, seed=4)
    assert len(mem.all_instances) == NI
    for inst, read in zip(mem.all_instances, dset.all_instances):
        assert len(inst) == len(read) == NV
        for v, obs in enumerate(inst):
            want = read[v]
            for k, a in obs.items():
                assert np.asarray(a).dtype == np.asarray(want[k]).dtype, k
                np.testing.assert_array_equal(a, want[k], err_msg=k)


def test_device_dataset_matches_jax(sets):
    want, got = sets
    assert got.num_instances == NI and got.num_views == NV and got.sidelength == SIDE
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name)
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("seed", [0, 9])
@pytest.mark.parametrize("ns", [1, 2])
def test_sampler_matches_jax(sets, seed, ns):
    jdata, data = sets
    want = jax_make_device_sampler(jdata, SB, R, ns)(jax.random.PRNGKey(seed))
    _build.reset_launches()
    got = make_device_sampler(data, SB, R, ns)(threefry.PRNGKey(seed))
    assert not _build.launches
    flat = lambda out: [out[0], out[1], out[2], out[3], out[4]["x_pix"], out[4]["cam2world"],
                        out[4]["intrinsics"], out[5]]
    for w, g in zip(flat(want), flat(got)):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the rays come from several (instance, view) pairs
    assert len(np.unique(got[4]["cam2world"].numpy().reshape(-1, 16), axis=0)) > 2


@pytest.mark.parametrize("field, value", [("focal", np.float32(20.0)),
                                          ("c", np.asarray([8.0, 7.5], np.float32))])
def test_build_refuses_views_with_other_intrinsics(field, value):
    mem = synthetic.synthetic_scene_set(2, 3, 16)
    mem.all_instances[1][2] = dict(mem.all_instances[1][2], **{field: value})
    with pytest.raises(ValueError, match="one focal and c"):
        build_device_dataset(mem, device="cpu")


def _jax_dd_step(jmodel, variables, jdata, rng_mode, step0):
    tx = jax_make_optimizer(1e-4)
    state = jax_create_state(jax.tree.map(jnp.asarray, variables), tx)
    state = state.replace(step=jnp.int32(step0))
    step = jax_make_train_step(jmodel, tx, JaxLossParams(loss_mode="both"), donate=False,
                               rng_mode=rng_mode, sampler=jax_make_device_sampler(jdata, SB, R),
                               sampler_key=jax.random.PRNGKey(2))
    state, metrics = step(state)
    assert int(state.step) == step0 + 1
    return dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                g=_leaves(jax.tree.map(lambda m: m / 0.1, state.opt_state.inner_state[0].mu)),
                stats=_leaves(state.batch_stats))


def _port_dd_step(model, data, rng_mode, step0):
    opt = make_optimizer(1e-4)
    state = create_train_state(model, opt)
    state.step = torch.tensor(step0, dtype=torch.int32)
    step = make_train_step(model, opt, LossParams(loss_mode="both"), rng_mode=rng_mode,
                           sampler=make_device_sampler(data, SB, R),
                           sampler_key=threefry.PRNGKey(2))
    _build.reset_launches()
    state, metrics = step(state)
    assert not _build.launches, "the CPU step launched a kernel"
    assert int(metrics["notfinite"]) == 0 and int(state.step) == step0 + 1
    return dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                g=_leaves(to_flax_tree({k: v / 0.1 for k, v in state.opt_state.mu.items()})
                          ["params"]),
                stats=_leaves(to_flax_variables(model)["batch_stats"]))


@pytest.fixture(scope="module")
def vr_model():
    return _models("VR")


@pytest.mark.parametrize("rng_mode", ["per_ray", "legacy"])
@pytest.mark.parametrize("step0", [0, 3])
def test_device_data_step_matches_jax(sets, vr_model, rng_mode, step0):
    jdata, data = sets
    jmodel, variables, port = vr_model
    want = _jax_dd_step(jmodel, variables, jdata, rng_mode, step0)
    got = _port_dd_step(port(), data, rng_mode, step0)
    _compare(got, want, DD_TOL)


def test_device_data_step_counts_on_the_host(sets, vr_model):
    """Two steps on one state: the second draws with ``fold_in(key, 1)``, as
    a fresh state at step 1 does; the step reads ``state.step`` once."""
    _, data = sets
    _, _, port = vr_model
    model = port()
    opt = make_optimizer(1e-4)
    sampler = make_device_sampler(data, SB, R)
    drawn = []
    step = make_train_step(model, opt, LossParams(loss_mode="both"),
                           sampler=lambda k: drawn.append(k) or sampler(k),
                           sampler_key=threefry.PRNGKey(2))
    state = create_train_state(model, opt)
    for _ in range(2):
        state, _ = step(state)
    assert int(state.step) == 2
    base = threefry.PRNGKey(2)
    assert drawn == [threefry.split(threefry.fold_in(base, i))[0] for i in range(2)]
