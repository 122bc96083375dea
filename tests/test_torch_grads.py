"""Port parity of the training slice's gradients against ``avr_tpu``.

The same numpy inputs and cotangents go through the JAX function's VJP
(Pallas kernels in interpret mode, as the JAX package's own tests run them)
and through the port's wrapper on CPU tensors, whose plain version autograd
differentiates:

* K1 gather: ``dfeat`` and ``dcoords`` against ``gather_bilinear_windowed``
  (f32 and bf16 maps), with points on and beyond the border, where the live
  mask is strict (``avr_tpu/ops/pallas/gather.py:142-148``).
* K2 decoder: all 12 cotangents (``dx`` through the encoding's ``cos``
  lanes) against ``fused_resnetfc(..., stash=True)``, NS 1 and 2.
* K3 march: every cotangent against ``fused_lstm_march``, with the +-10
  clip binding, and with early stop.
* The volume integral's closed-form adjoint, with a saturated lane.

Tolerances are float32's: the two sides sum in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu.models.mlp import ResnetFC as FlaxResnetFC
from avr_tpu.ops.integrate import volume_integral as jax_volume_integral
from avr_tpu.ops.pallas.gather import gather_bilinear_windowed
from avr_tpu.ops.pallas.march import fused_lstm_march as pallas_march
from avr_tpu.ops.pallas.resnetfc import CodeSpec as FlaxCodeSpec
from avr_tpu.ops.pallas.resnetfc import fused_resnetfc as pallas_resnetfc
from avr_tpu_torch.models.flax_import import load_flax_variables, to_flax_tree
from avr_tpu_torch.models.mlp import ResnetFC
from avr_tpu_torch.ops.integrate import volume_integral
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.ops.kernels.gather import gather_bilinear
from avr_tpu_torch.ops.kernels.march import fused_lstm_march
from avr_tpu_torch.ops.kernels.resnetfc import CodeSpec, fused_resnetfc
from tests.test_pallas_march import STEPS, _inputs

torch.set_num_threads(2)


def _t(a, grad=True):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, rel, name=""):
    """Within ``rel`` of the reference's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale, err_msg=name)


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------


def _gather_case(seed, B=2, H=12, W=8, C=16, N=300):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, H, W, C)).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, size=(B, N, 2)).astype(np.float32)
    # on the border (x_un = 0 or W - 1, y likewise) and in its corners
    coords[:, :6] = [[-1.0, 0.3], [1.0, -0.2], [0.1, 1.0], [0.4, -1.0], [1.0, 1.0], [-1.0, -1.0]]
    g = rng.normal(size=(B, N, C)).astype(np.float32)
    return feats, coords, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_grads_match_pallas_vjp(dtype):
    feats, coords, g = _gather_case(0)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    # the same values on both sides: round the map and the cotangent first
    feats = np.asarray(jnp.asarray(feats).astype(jd).astype(jnp.float32))
    g = np.asarray(jnp.asarray(g).astype(jd).astype(jnp.float32))
    _, vjp = jax.vjp(lambda f, c: gather_bilinear_windowed(f, c, True),
                     jnp.asarray(feats).astype(jd), jnp.asarray(coords))
    want_f, want_c = vjp(jnp.asarray(g).astype(jd))
    f = _t(feats, False).to(td).requires_grad_(True)
    c = _t(coords)
    _build.reset_launches()
    got_f, got_c = torch.autograd.grad(gather_bilinear(f, c), (f, c), _t(g, False).to(td))
    assert not _build.launches
    assert got_f.dtype == td and got_c.dtype == torch.float32
    # float32: the same sums in another order.  bf16: the JAX kernel rounds
    # each tap weight to bf16 before w * g, the plain version does not; both
    # round the float32 sum to bf16 once: 2 bf16 ulps of the largest value
    _close(got_f.float().numpy(), np.asarray(want_f.astype(jnp.float32)),
           1e-5 if dtype == "float32" else 2.0 ** -7, "dfeat")
    _close(got_c.numpy(), np.asarray(want_c), 1e-5, "dcoords")


def test_gather_border_mask_is_strict():
    """On the border itself the coordinate gets no gradient (the TPU
    kernel's ``0 < x_un < W - 1``), where ``torch.clamp`` would pass one."""
    feats, coords, g = _gather_case(1)
    f, c = _t(feats, False), _t(coords)
    (got_c,) = torch.autograd.grad(gather_bilinear(f, c), (c,), _t(g, False))
    got_c = got_c.numpy()
    np.testing.assert_array_equal(got_c[:, 0, 0], 0.0)  # x = -1
    np.testing.assert_array_equal(got_c[:, 1, 0], 0.0)  # x = +1
    np.testing.assert_array_equal(got_c[:, 2, 1], 0.0)  # y = +1
    np.testing.assert_array_equal(got_c[:, 3, 1], 0.0)  # y = -1
    np.testing.assert_array_equal(got_c[:, 4:6], 0.0)  # corners
    assert np.abs(got_c[:, 0, 1]).min() > 0 and np.abs(got_c[:, 2, 0]).min() > 0

    # torch.clamp's own gradient is inclusive: it would pass at x = +-1
    x = torch.tensor([0.0, 7.0], requires_grad=True)
    (dx,) = torch.autograd.grad(torch.clamp(x, 0.0, 7.0).sum(), (x,))
    assert dx.tolist() == [1.0, 1.0]


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

D_HIDDEN, D_LATENT, N_BLOCKS, N_LIN_Z = 128, 64, 3, 2
SPEC = dict(num_freqs=6, freq_factor=1.5, include_input=True, d_coded=3, d_pass=3)


@pytest.fixture(scope="module")
def decoder():
    rng = np.random.default_rng(7)
    spec = FlaxCodeSpec(**SPEC)
    mod = FlaxResnetFC(d_in=spec.d_enc, d_out=4, n_blocks=N_BLOCKS, d_latent=D_LATENT,
                       d_hidden=D_HIDDEN, combine_layer=N_LIN_Z, fused="never",
                       code_spec=spec, activate_out=True)
    variables = mod.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 2, spec.d_raw)),
                         jnp.zeros((1, 1, 2, D_LATENT)))
    variables = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), variables)
    port = ResnetFC(spec.d_enc, 4, N_BLOCKS, D_LATENT, D_HIDDEN, N_LIN_Z,
                    code_spec=CodeSpec(**SPEC), activate_out=True)
    load_flax_variables(port, variables)
    return variables, port


@pytest.mark.parametrize("ns", [1, 2])
def test_decoder_grads_match_pallas_stash_vjp(decoder, ns):
    variables, port = decoder
    rng = np.random.default_rng(50 + ns)
    N = 61
    x = rng.uniform(-1.2, 1.2, size=(ns, N, 6)).astype(np.float32)
    z = rng.normal(size=(ns, N, D_LATENT)).astype(np.float32)
    g = (rng.normal(size=(N, 4)) + 0.5).astype(np.float32)

    fn = lambda x, z, p: pallas_resnetfc(x, z, p, n_blocks=N_BLOCKS, n_lin_z=N_LIN_Z,
                                         compute_dtype=jnp.float32, interpret=True,
                                         code=FlaxCodeSpec(**SPEC), activate_out=True,
                                         stash=True)
    params = jax.tree.map(jnp.asarray, variables["params"])
    _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(z), params)
    want_x, want_z, want_p = vjp(jnp.asarray(g))

    xt, zt = _t(x), _t(z)
    out = fused_resnetfc(xt, zt, port.weights(), n_blocks=N_BLOCKS, n_lin_z=N_LIN_Z,
                         compute_dtype=torch.float32, code=CodeSpec(**SPEC), activate_out=True)
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(out, [xt, zt, *port.parameters()], _t(g, False))
    _close(grads[0].numpy(), want_x, 1e-4, "dx")
    _close(grads[1].numpy(), want_z, 1e-4, "dz")
    got_p = to_flax_tree(dict(zip(names, grads[2:])))["params"]
    flat_want = jax.tree_util.tree_flatten_with_path(want_p)[0]
    assert len(flat_want) == len(names)  # the 12 stacked arrays, leaf by leaf
    for path, want in flat_want:
        keys = [p.key for p in path]
        got = got_p
        for k in keys:
            got = got[k]
        _close(got, want, 1e-4, "/".join(keys))


@pytest.mark.parametrize("ns,coded", [(1, True), (2, True), (1, False), (2, False)])
def test_decoder_grads_match_pallas_recompute_vjp(decoder, ns, coded):
    """The recompute backward (``stash=False``), with and without the
    in-decoder encoding (without it ``x`` holds already encoded lanes)."""
    variables, port = decoder
    rng = np.random.default_rng(60 + ns + 2 * coded)
    N = 45
    spec = FlaxCodeSpec(**SPEC)
    d_x = spec.d_raw if coded else spec.d_enc
    x = rng.uniform(-1.2, 1.2, size=(ns, N, d_x)).astype(np.float32)
    z = rng.normal(size=(ns, N, D_LATENT)).astype(np.float32)
    g = (rng.normal(size=(N, 4)) + 0.5).astype(np.float32)

    fn = lambda x, z, p: pallas_resnetfc(x, z, p, n_blocks=N_BLOCKS, n_lin_z=N_LIN_Z,
                                         compute_dtype=jnp.float32, interpret=True,
                                         code=spec if coded else None, activate_out=True,
                                         stash=False)
    params = jax.tree.map(jnp.asarray, variables["params"])
    _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(z), params)
    want_x, want_z, want_p = vjp(jnp.asarray(g))

    xt, zt = _t(x), _t(z)
    _build.reset_launches()
    out = fused_resnetfc(xt, zt, port.weights(), n_blocks=N_BLOCKS, n_lin_z=N_LIN_Z,
                         compute_dtype=torch.float32, code=CodeSpec(**SPEC) if coded else None,
                         activate_out=True, stash=False)
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(out, [xt, zt, *port.parameters()], _t(g, False))
    assert not _build.launches
    # float32; the same algorithm summed in other orders: 1e-4 of each scale
    _close(grads[0].numpy(), want_x, 1e-4, "dx")
    _close(grads[1].numpy(), want_z, 1e-4, "dz")
    got_p = to_flax_tree(dict(zip(names, grads[2:])))["params"]
    for path, want in jax.tree_util.tree_flatten_with_path(want_p)[0]:
        keys = [p.key for p in path]
        got = got_p
        for k in keys:
            got = got[k]
        _close(got, want, 1e-4, "/".join(keys))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("ns", [1, 2])
def test_stash_auto_choice_matches_jax(monkeypatch, dtype, ns):
    """``stash="auto"`` takes the stash backward exactly where JAX does, on
    both sides of the 6 GiB boundary: JAX's choice is read from the
    argument its kernel factory receives, on abstract shapes (no arrays)."""
    import avr_tpu.ops.pallas.resnetfc as pallas_mod
    from avr_tpu_torch.ops.kernels.resnetfc import use_stash

    nb, nlz, dh, dl = 5, 3, 512, 512
    spec = FlaxCodeSpec(**SPEC)
    seen = []

    def factory(*args):
        seen.append(args[11])  # the resolved stash flag
        return lambda x, z, *p: jnp.zeros((x.shape[1], 4), jnp.float32)

    monkeypatch.setattr(pallas_mod, "_make_fused", factory)
    sds = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.float32)
    params = {"lin_in": {"kernel": sds(spec.d_enc, dh), "bias": sds(dh)},
              "lin_out": {"kernel": sds(dh, 4), "bias": sds(4)},
              **{f"lin_z_{k}": {"kernel": sds(dl, dh), "bias": sds(dh)} for k in range(nlz)},
              **{f"block_{k}": {f: {"kernel": sds(dh, dh), "bias": sds(dh)}
                                for f in ("fc_0", "fc_1")} for k in range(nb)}}
    per_point = dh * jnp.dtype(dtype).itemsize * (2 * nlz * ns + 2 * (nb - nlz) + 1)
    edge = 6 * 1024 ** 3 // per_point
    for N in (edge - 1, edge, edge + 1, 2 * edge):
        jax.eval_shape(lambda x, z, p: pallas_resnetfc(
            x, z, p, n_blocks=nb, n_lin_z=nlz, compute_dtype=jnp.dtype(dtype), code=spec,
            activate_out=True, stash="auto"), sds(ns, N, spec.d_raw), sds(ns, N, dl), params)
        assert use_stash("auto", ns, N, dh, nb, nlz, getattr(torch, dtype)) == seen[-1], N
    assert seen == [True, True, False, False]
    assert use_stash(True, ns, 10 * edge, dh, nb, nlz, torch.float32)
    assert not use_stash(False, ns, 1, dh, nb, nlz, torch.float32)
    with pytest.raises(ValueError, match="stash"):
        use_stash("always", ns, 1, dh, nb, nlz, torch.float32)


@pytest.mark.parametrize("fused", ["auto", "always", "stash", "always_stash", "never"])
def test_fused_mlp_maps_to_jax_stash(monkeypatch, fused):
    """``ModelConfig.fused_mlp`` gives both decoders the ``stash`` argument
    that JAX's ``ResnetFC`` passes to its kernel for the same value, read
    from the call it makes on an accelerator backend (a stub kernel
    records it); ``"never"``, JAX's plain path, is not ported."""
    import dataclasses

    import avr_tpu.ops.pallas.resnetfc as pallas_mod
    from avr_tpu_torch.models.pixelnerf import ModelConfig, PixelNeRFNet

    seen = []

    def stub(x, z, params, **kw):
        seen.append(kw["stash"])
        return jnp.zeros((x.shape[1], 4), jnp.float32)

    spec = FlaxCodeSpec(**SPEC)
    mod = FlaxResnetFC(d_in=spec.d_enc, d_out=4, n_blocks=N_BLOCKS, d_latent=D_LATENT,
                       d_hidden=D_HIDDEN, combine_layer=N_LIN_Z, fused=fused,
                       code_spec=spec, activate_out=True)
    x, z = jnp.zeros((1, 1, 2, spec.d_raw)), jnp.zeros((1, 1, 2, D_LATENT))
    variables = mod.init(jax.random.PRNGKey(0), x, z)
    monkeypatch.setattr(pallas_mod, "fused_resnetfc", stub)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    mod.apply(variables, x, z)
    monkeypatch.undo()

    cfg = dataclasses.replace(ModelConfig(), fused_mlp=fused)
    if fused == "never":
        assert seen == []
        with pytest.raises(NotImplementedError, match="fused_mlp"):
            PixelNeRFNet(cfg)
        return
    net = PixelNeRFNet(cfg)
    assert net.mlp_coarse.stash == net.mlp_fine.stash == seen[0]


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

MARCH_ARGS = ("proj", "coords0", "rds", "feat", "wih", "whh", "bias", "wout", "bout")


def _march_grads(inp, g, **kw):
    jax_args = [inp[n] for n in MARCH_ARGS]
    _, vjp = jax.vjp(lambda *a: pallas_march(*a, steps=STEPS, compute_dtype=jnp.float32,
                                             interpret=True, **kw), *jax_args)
    want = vjp(jnp.asarray(g))[1:]  # proj is data: its cotangent is zero
    t = [_t(inp[n], grad=i > 0) for i, n in enumerate(MARCH_ARGS)]
    out = fused_lstm_march(*t, steps=STEPS, compute_dtype=torch.float32, **kw)
    got = torch.autograd.grad(out, t[1:], _t(g, False))
    return got, want


@pytest.mark.parametrize("ns,eps,scale", [(1, 0.0, 1.0), (2, 0.0, 1.0), (1, 0.05, 1.0),
                                          (1, 0.0, 500.0)])
def test_march_grads_match_pallas_vjp(ns, eps, scale):
    inp = _inputs(seed=4, ns=ns)
    g = (np.random.default_rng(9).normal(size=np.shape(inp["coords0"])) * scale).astype(np.float32)
    got, want = _march_grads(inp, g, early_stop_eps=eps)
    # float32; the recurrence amplifies last-bit differences, 3 steps
    for name, a, b in zip(MARCH_ARGS[1:], got, want):
        _close(a.numpy(), b, 1e-4, name)
    if scale > 1.0:
        # the +-10 clip on the hidden cotangent binds: without it the weight
        # gradients differ
        free, _ = _march_grads(inp, g, early_stop_eps=eps, grad_clamp=1e30)
        assert not np.allclose(free[3].numpy(), got[3].numpy(), rtol=1e-3, atol=0)
    if eps:
        # the threshold froze some rays: their marches differ from free ones
        t = [_t(inp[n], False) for n in MARCH_ARGS]
        frozen = fused_lstm_march(*t, steps=STEPS, compute_dtype=torch.float32,
                                  early_stop_eps=eps)
        free = fused_lstm_march(*t, steps=STEPS, compute_dtype=torch.float32)
        assert not torch.allclose(frozen, free)


# ---------------------------------------------------------------------------
# the integral
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("white_back", [True, False])
def test_integral_adjoint_matches_jax_with_saturated_lane(white_back):
    rng = np.random.default_rng(11)
    SB, R, n = 2, 9, 12
    z = np.sort(rng.uniform(0.5, 1.5, size=(SB, R, n)), axis=-1).astype(np.float32)
    sig = rng.uniform(0.0, 8.0, size=(SB, R, n, 1)).astype(np.float32)
    sig[0, 0, 3] = 1e5  # alpha == 1 in float32: 1 - alpha is exactly 0
    sig[1, 2, 0] = 1e5
    rad = rng.uniform(size=(SB, R, n, 3)).astype(np.float32)
    cots = [rng.normal(size=s).astype(np.float32) for s in ((SB, R, 3), (SB, R, 1), (SB, R, n, 1))]

    _, vjp = jax.vjp(lambda a, b, c: jax_volume_integral(a, b, c, white_back=white_back),
                     jnp.asarray(z), jnp.asarray(sig), jnp.asarray(rad))
    want = vjp(tuple(jnp.asarray(c) for c in cots))
    t = [_t(a) for a in (z, sig, rad)]
    outs = volume_integral(*t, white_back=white_back)
    got = torch.autograd.grad(outs, t, [_t(c, False) for c in cots])
    for name, a, b in zip(("z", "sigma", "radiance"), got, want):
        assert np.isfinite(a.numpy()).all(), name
        _close(a.numpy(), b, 1e-5, name)
