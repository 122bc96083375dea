"""K2 at JAX's widths: the port's decoder against ``avr_tpu``'s Pallas kernel.

JAX's fused decoder takes any ``d_hidden % 128 == 0`` and any latent and
input width (``avr_tpu/ops/pallas/resnetfc.py supports``); on the card the
port sends the shapes past its register-resident kernels to the wide
kernels (``csrc/resnetfc_wide.cu``), chosen by ``forward_route`` and
``backward_route``, and pads a latent of any width to a multiple of 64
lanes (``pad_latent``).  Here, on the CPU:

* Flax ``ResnetFC`` initialised and perturbed (every block live), its
  weights carried by ``load_flax_variables``; the same numpy inputs through
  JAX's ``fused_resnetfc`` (interpret mode, the stash backward's VJP) and the
  port's ``fused_resnetfc`` on CPU tensors (the plain version and autograd):
  d_hidden 640 and 1,024, latents of 612, 640 and 1,152 lanes, 24
  frequencies (150 encoded lanes, past the bf16 tail's 128), NS 1 and 2.
  Forward 1e-4 absolute; gradients 1e-4 of each array's largest value
  (float32 on both sides, sums in another order).
* The routes: every shipped shape keeps its kernel; everything JAX fuses
  (d_hidden up to 4,096, latents up to 4,096 lanes) has a kernel that
  takes it, in both dtypes, forward and backward; bf16 d_hidden 256..1,024
  takes the TMA cluster kernels where their shared memory fits
  (``wide_tma_fits``), every other wide shape up to d_hidden 1,024 the
  first version where its shared memory fits, and the chain
  (``csrc/resnetfc_chain.cu``) past it and past 1,024: the shapes the
  wrapper refused before it and the range where it was measured faster.
* The wide kernels' shared-memory budgets, their constants read from the
  source, and the latent padding: the padded operands give the unpadded
  function (its forward bit for bit where the injections' sums are exact).
"""

import itertools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu.models.mlp import ResnetFC as FlaxResnetFC
from avr_tpu.ops.pallas.resnetfc import supports as jax_supports
from avr_tpu.ops.pallas.resnetfc import CodeSpec as FlaxCodeSpec
from avr_tpu.ops.pallas.resnetfc import fused_resnetfc as pallas_resnetfc
from avr_tpu_torch.models.flax_import import load_flax_variables, to_flax_tree
from avr_tpu_torch.models.mlp import ResnetFC
from avr_tpu_torch.ops.kernels import resnetfc as K2

torch.set_num_threads(2)

CSRC = Path(K2.__file__).resolve().parents[2] / "csrc"
N_BLOCKS, N_LIN_Z, N = 3, 2, 29


def _spec(num_freqs):
    return dict(num_freqs=num_freqs, freq_factor=1.5, include_input=True, d_coded=3, d_pass=3)


def _close(got, want, rel, name=""):
    """Within ``rel`` of the reference's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale, err_msg=name)


def _decoder(d_hidden, d_latent, num_freqs, seed):
    """Flax ResnetFC with its weights perturbed at 0.05 of a 128-lane fan-in
    (so the zero-initialised fc_1 is live and the trunk keeps its scale at
    any width), and the port's module carrying them."""
    rng = np.random.default_rng(seed)
    spec = FlaxCodeSpec(**_spec(num_freqs))
    mod = FlaxResnetFC(d_in=spec.d_enc, d_out=4, n_blocks=N_BLOCKS, d_latent=d_latent,
                       d_hidden=d_hidden, combine_layer=N_LIN_Z, fused="never",
                       code_spec=spec, activate_out=True)
    variables = mod.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 2, spec.d_raw)),
                         jnp.zeros((1, 1, 2, d_latent)))
    variables = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * (128 / a.shape[-2] if a.ndim > 1 else 1.0) ** 0.5
        * rng.normal(size=a.shape).astype(np.float32), variables)
    port = ResnetFC(spec.d_enc, 4, N_BLOCKS, d_latent, d_hidden, N_LIN_Z,
                    code_spec=K2.CodeSpec(**_spec(num_freqs)), activate_out=True)
    load_flax_variables(port, variables)
    return variables, port


# (d_hidden, d_latent, frequencies, views): d_hidden 640 and 1,024; a latent
# of 612 (a global latent_size of 100 beside the spatial 512), 640 (the
# global encoder's 128) and 1,152 (a 5-stage encoder's 1,024 and the
# global 128); 24 frequencies: 150 encoded lanes, 192 as padded; and at
# the shipped d_hidden 512 the latents the bf16 wgmma forward takes in
# pieces (the global encoder's 640, a 5-stage encoder's 1,024); d_hidden
# 1,280 (the chain's on the card)
WIDE = [(640, 612, 24, 1), (640, 1152, 6, 2), (1024, 1152, 24, 2), (1024, 640, 24, 1),
        (1024, 612, 6, 2), (512, 640, 6, 1), (512, 1024, 6, 2), (1280, 1152, 6, 2)]


@pytest.mark.parametrize("d_hidden,d_latent,num_freqs,ns", WIDE)
def test_wide_decoder_matches_pallas(d_hidden, d_latent, num_freqs, ns):
    variables, port = _decoder(d_hidden, d_latent, num_freqs, d_hidden + d_latent + ns)
    assert port.fuses(ns, True)  # JAX's supports: the port takes K2
    rng = np.random.default_rng(num_freqs + ns)
    x = rng.uniform(-1.2, 1.2, size=(ns, N, 6)).astype(np.float32)
    if num_freqs > 6:
        # 24 frequencies multiply a coordinate by up to 1.5 * 2^23: a sin
        # argument of ~1e7, where one float32 ulp of the coordinate moves the
        # sin by O(1), and JAX's interpret-mode one-hot select does not keep
        # every bit of an arbitrary coordinate (its result moves by 0.26 at
        # the output with uniform draws).  Coordinates on a 1/64 grid are
        # exact in every precision, so both sides encode the same values
        x = np.round(x * 64) / 64
    z = rng.normal(size=(ns, N, d_latent)).astype(np.float32)
    g = (rng.normal(size=(N, 4)) + 0.5).astype(np.float32)
    spec = FlaxCodeSpec(**_spec(num_freqs))
    fn = lambda x, z, p: pallas_resnetfc(x, z, p, n_blocks=N_BLOCKS, n_lin_z=N_LIN_Z,
                                         compute_dtype=jnp.float32, interpret=True, code=spec,
                                         activate_out=True, stash=True)
    params = jax.tree.map(jnp.asarray, variables["params"])
    want_out, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(z), params)
    want_x, want_z, want_p = vjp(jnp.asarray(g))

    xt, zt = (torch.from_numpy(a).requires_grad_(True) for a in (x, z))
    out = K2.fused_resnetfc(xt, zt, port.weights(), n_blocks=N_BLOCKS, n_lin_z=N_LIN_Z,
                            compute_dtype=torch.float32, code=K2.CodeSpec(**_spec(num_freqs)),
                            activate_out=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=0, atol=1e-4)
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(out, [xt, zt, *port.parameters()], torch.from_numpy(g))
    _close(grads[0].numpy(), want_x, 1e-4, "dx")
    _close(grads[1].numpy(), want_z, 1e-4, "dz")
    got_p = to_flax_tree(dict(zip(names, grads[2:])))["params"]
    flat_want = jax.tree_util.tree_flatten_with_path(want_p)[0]
    assert len(flat_want) == len(names)
    for path, want in flat_want:
        keys = [p.key for p in path]
        got = got_p
        for k in keys:
            got = got[k]
        _close(got, want, 1e-4, "/".join(keys))


# ---------------------------------------------------------------------------
# the routes
# ---------------------------------------------------------------------------

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("cd,want_fwd,want_bwd", [(BF16, "wgmma", "wgmma"), (F32, "fma", "fma")])
def test_shipped_shapes_keep_their_kernels(cd, want_fwd, want_bwd):
    """conf/default_mv.conf's decoders: d_hidden 512, latent 512, 6
    frequencies (64 lanes as padded), the route they took before the wide
    kernels."""
    assert K2.forward_route(cd, 512, 64, 512) == K2.forward_route(cd, 512, 64) == want_fwd
    assert K2.backward_route(cd, 512, 512, 64) == want_bwd
    # narrower trunks and latents too
    for dh, dl, k_in in ((64, 64, 64), (256, 512, 128), (512, 128, 64)):
        assert K2.forward_route(cd, dl, k_in, dh) == want_fwd
        assert K2.backward_route(cd, dh, dl, k_in) == want_bwd


def test_wide_routes():
    # d_hidden past 512: the wide forward and dgrad in both dtypes, bf16 on
    # the TMA cluster kernels up to 1,024, float32 on its cluster kernels up
    # to 1,024, on the chain past them
    for cd, want in ((BF16, "wide_tma"), (F32, "wide_f32")):
        for dh in (576, 640, 1024):
            assert K2.forward_route(cd, 512, 64, dh) == want
            assert K2.backward_route(cd, dh, 512, 64) == want
    assert K2.forward_route(F32, 1152, 64, 1024) == "wide_f32"
    # past 1,024 the chain, measured faster than the retired first wide
    # version there
    for dh in (1088, 1152, 1792):
        assert K2.forward_route(F32, 512, 64, dh) == "chain"
        assert K2.backward_route(F32, dh, 512, 64) == "chain"
    # bf16 at 512 past the tail's latent or input lanes: the forward is the
    # wgmma one (its operands in pieces), the dgrad the TMA cluster
    # one; float32 keeps both
    assert K2.forward_route(BF16, 640, 64, 512) == "wgmma"
    assert K2.backward_route(BF16, 512, 640, 64) == "wide_tma"
    assert K2.backward_route(BF16, 512, 512, 192) == "wide_tma"
    assert K2.forward_route(BF16, 512, 192, 512) == "wgmma"
    assert K2.backward_route(F32, 512, 1152, 576) == "fma"
    # bf16 past the TMA cluster kernels' two trunk groups a warp, and below
    # the dgrad tail's d-encoding chunk: the chain (measured faster than the
    # retired first wide version, chip_smoke.py --chain-sweep family C)
    assert K2.forward_route(BF16, 1152, 64, 1152) == "chain"
    assert K2.backward_route(BF16, 1152, 1152, 64) == "chain"
    assert K2.backward_route(BF16, 128, 640, 64) == "chain"
    # past the cluster kernels' shared memory: the chain
    for dh in (1280, 2048):
        assert K2.forward_route(BF16, 1152, 64, dh) == "chain"
        assert K2.backward_route(BF16, dh, 1152, 64) == "chain"
    assert K2.forward_route(BF16, 4096, 64, 1024) == "chain"
    assert K2.backward_route(BF16, 1024, 4096, 64) == "wide_tma"
    assert K2.forward_route(F32, 1152, 64, 1920) == "chain"
    assert K2.backward_route(F32, 1920, 1152, 64) == "chain"


# bf16 at d_hidden 512 and 256 past the wgmma forward's 512-lane A tile (in
# pieces of up to 768 lanes):
# (d_hidden, d_latent, k_in as padded); every one was measured faster on the
# wgmma forward's pieces than on resnetfc_kernel (PERF.md, the sweep in
# turns at the band chunk), so each takes "wgmma"
PIECED = [(dh, dl, 64) for dh in (512, 256) for dl in (640, 1024, 1152)] + [
    (512, 512, 576), (256, 512, 576)]


@pytest.mark.parametrize("d_hidden,d_latent,k_in", PIECED)
def test_pieced_shapes_take_the_wgmma_forward(d_hidden, d_latent, k_in):
    assert K2.forward_route(BF16, d_latent, k_in, d_hidden) == "wgmma"
    # the dgrad is unchanged: the TMA cluster one past the tail's lanes
    assert K2.backward_route(BF16, d_hidden, d_latent, k_in) == (
        "wide_tma" if d_hidden >= 256 else "chain")


@pytest.mark.parametrize("d_latent,k_in", [(1216, 64), (64, 1216), (2048, 576), (1152, 1216)])
def test_past_the_pieces_limit_the_chain_takes_the_forward(d_latent, k_in):
    """Past the C entry's FWD_OPERAND_MAX lanes the chain takes every bf16
    forward at d_hidden up to 512 (it was measured faster than the retired
    ``resnetfc_kernel`` at every corner of that family: chip_smoke.py
    --chain-sweep A1-A6): nothing is refused; float32 keeps its FMA
    kernel."""
    for dh in (64, 256, 512):
        assert K2.forward_route(BF16, d_latent, k_in, dh) == "chain"
        assert K2.chain_takes(BF16, dh, d_latent, k_in)
    assert K2.forward_route(F32, d_latent, k_in, 512) == "fma"


def test_pieces_match_the_source():
    """The wgmma forward's A tile, its pieces past it and the C entry's limit
    are the wrapper's (csrc/resnetfc_hopper.cu FWD_K_MAX, FWD_K_EXT,
    FWD_OPERAND_MAX); a piece is the A tile's 8 boxes and the park tiles' 4
    (fwd_box: the ninth box starts the park tiles, 1,024-byte aligned); the
    C entry refuses past the limit and takes the pieced instantiation past
    512 lanes; the producer streams a product's weight k-slabs in the
    consumers' order: piece, half, k-chunk.  Every operand width up to the
    limit splits into pieces that cover its lanes once, each whole 64-lane
    boxes, at most two."""
    src = (CSRC / "resnetfc_hopper.cu").read_text()
    env = {"GOUT_W": K2.GOUT_W}
    for n, e in re.findall(r"^constexpr (?:int|uint32_t) ((?:DG|FW|FWD)_\w+) = ([^;]+);", src,
                           re.M):
        env[n] = eval(e, {}, dict(env))  # noqa: S307 - the repo's own constants
    assert (env["FWD_K_MAX"], env["FWD_K_EXT"], env["FWD_OPERAND_MAX"]) == (
        K2.FWD_K_MAX, K2.FWD_K_EXT, K2.FWD_OPERAND_MAX)
    # the park tiles: 4 boxes after the ring, the A tile's boxes 9-12
    assert env["FWD_K_EXT"] == env["FWD_K_MAX"] + 4 * 64
    assert env["FW_JUMP"] == env["FW_PARK"] - (env["DG_A"] + 8 * env["DG_BOX"])
    assert env["FW_PARK"] % 1024 == 0 and env["FW_PARK"] + 4 * env["DG_BOX"] <= env["DG_BAR"]
    assert "d_latent > FWD_OPERAND_MAX" in src and "k_in > FWD_OPERAND_MAX" in src
    assert "const bool pieces = dl > FWD_K_MAX || k_in > FWD_K_MAX;" in src
    producer = " ".join(src.split("auto stream = [&]")[1].split("++ws;")[0].split())
    assert producer.index("k0 += FWD_K_EXT") < producer.index("++h") < producer.index("kc += 64")
    consumer = src.split("resnetfc_fwd_wgmma_kernel(const __grid_constant__")[1]
    assert "j0 += FWD_K_EXT" in consumer and "l0 += FWD_K_EXT" in consumer
    for k in range(64, K2.FWD_OPERAND_MAX + 1, 64):
        pieces = [(k0, min(K2.FWD_K_EXT, k - k0)) for k0 in range(0, k, K2.FWD_K_EXT)]
        lanes = [lane for k0, width in pieces for lane in range(k0, k0 + width)]
        assert lanes == list(range(k)) and all(w % 64 == 0 for _, w in pieces)
        assert len(pieces) == -(-k // K2.FWD_K_EXT) <= 2
        assert len(pieces) == 1 or k > K2.FWD_K_EXT


def _fits(cd, route, dh, dl, k_in, backward):
    """Whether ``route``'s kernel takes the shape: the cluster kernels within
    their shared memory; the chain and the register kernels take what the
    rule sends them."""
    if route == "wide_tma":
        return K2.wide_tma_smem(dh, dl, k_in, backward) <= K2.SMEM_MAX
    if route == "wide_f32":
        return K2.wide_f32_smem(dh, k_in) <= K2.SMEM_MAX
    return True


@pytest.mark.parametrize("cd", [BF16, F32])
def test_everything_jax_fuses_has_a_kernel(cd):
    """Every decoder JAX's ``supports`` takes with d_hidden up to 4,096, a
    latent up to 4,096 lanes and up to 576 encoded lanes (85 frequencies)
    has a route whose kernel takes it, forward and backward: no shape is
    refused."""
    for dh in range(128, 4097, 128):
        for dl in (1, 63, 100, 612, 640, 1024, 1152, 2048, 4096):
            for d_enc in (42, 150, 516):
                assert jax_supports(n_blocks=5, n_lin_z=3, d_hidden=dh, d_latent=dl,
                                    d_in=d_enc, bn=False, beta=0.0)
                dlp, k_in = K2.d_enc_padded(dl), K2.d_enc_padded(d_enc)
                fwd = K2.forward_route(cd, dlp, k_in, dh)
                bwd = K2.backward_route(cd, dh, dlp, k_in)
                assert fwd in ("wgmma", "fma", "wide_tma", "wide_f32", "chain")
                assert bwd in ("wgmma", "fma", "wide_tma", "wide_f32", "chain")
                assert _fits(cd, fwd, dh, dlp, k_in, False)
                assert _fits(cd, bwd, dh, dlp, k_in, True)


# The retired first versions' shared memory, as their sources had it (the
# rule before the chain took their shapes): resnetfc_kernel's at NS > 1
# (csrc/resnetfc.cu fwd_smem_bytes<bf16>), the first wide version's forward
# and dgrad (csrc/resnetfc_wide.cu wide_fwd_smem, wide_dgrad_smem: a tile of
# 32 bf16 or 16 float32 points).
def _resnetfc_kernel_smem(dh, dl, k_in):
    rows = lambda k: -(-k // 64) * 64 + 32
    return 32 * (rows(max(k_in, dh)) + rows(dl)) * 2 + 32 * dh * 4


def _first_wide_smem(cd, dh, dl, k_in, backward):
    tm, item = (32, 2) if cd == BF16 else (16, 4)
    lda = (lambda k: -(-k // 64) * 64 + 32) if cd == BF16 else (lambda k: k + 4)
    k = dh if backward else max(dh, dl, k_in)
    return tm * (dh + 4) * 4 + tm * lda(k) * item + (tm * K2.GOUT_W * 4 if backward else 0)


def _route_before(cd, dh, dl, k_in, backward):
    """The rule before the chain took the first versions' shapes: the
    register kernels, the cluster kernels, ``resnetfc_kernel`` ("mma_sync")
    for bf16 forwards at d_hidden up to 512 past FWD_OPERAND_MAX lanes where
    its shared memory fit, the first wide version ("wide") for the other
    shapes up to d_hidden 1,024 where its shared memory fit, the chain past
    1,024 and past those memories."""
    if backward:
        if cd == F32 and dh <= K2.REG_DH_MAX:
            return "fma"
        if cd == F32 and K2.wide_f32_fits(cd, dh, k_in):
            return "wide_f32"
        if cd == BF16 and dh <= K2.REG_DH_MAX and dl <= K2.TAIL_DL_MAX and \
                k_in <= K2.TAIL_KIN_MAX:
            return "wgmma"
        if cd == BF16 and K2.wide_tma_fits(cd, dh, dl, k_in, True):
            return "wide_tma"
    elif dh > K2.REG_DH_MAX:
        if K2.wide_f32_fits(cd, dh, k_in):
            return "wide_f32"
        if K2.wide_tma_fits(cd, dh, dl, k_in):
            return "wide_tma"
    elif cd == F32:
        return "fma"
    elif max(dl, k_in) <= K2.FWD_OPERAND_MAX:
        return "wgmma"
    else:
        return "mma_sync" if _resnetfc_kernel_smem(dh, dl, k_in) <= K2.SMEM_MAX else "chain"
    first = dh <= 1024 and _first_wide_smem(cd, dh, dl, k_in, backward) <= K2.SMEM_MAX
    return "wide" if first else "chain"


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("cd", [BF16, F32])
def test_the_chain_takes_what_was_refused_and_the_measured_range(cd, backward):
    """The chain's rule (``chain_takes``) is one function of the shape: a
    shape goes to the chain exactly where it went before, where the wrapper
    refused it before that (past the first versions' shared memory), and
    where the retired first versions took it (the chain measured faster at
    every corner of their four families: chip_smoke.py --chain-sweep);
    every shipped, pieced and cluster shape keeps its route."""
    route = (lambda dh, dl, k_in: K2.backward_route(cd, dh, dl, k_in)) if backward else \
        (lambda dh, dl, k_in: K2.forward_route(cd, dl, k_in, dh))
    chained = moved = 0
    for dh in range(64, 4097, 64):
        for dl in (64, 512, 640, 1152, 1216, 2048, 4096):
            for k_in in (64, 192, 576, 1216):
                before = _route_before(cd, dh, dl, k_in, backward)
                r = route(dh, dl, k_in)
                assert r == ("chain" if before in ("chain", "mma_sync", "wide") else before), \
                    (dh, dl, k_in)
                assert (r == "chain") == K2.chain_takes(cd, dh, dl, k_in, backward)
                chained += r == "chain"
                moved += before in ("mma_sync", "wide")
    assert chained and moved


# The four families of shapes the retired first versions took, with the
# corners chip_smoke.py --chain-sweep timed (CHAIN_SWEEP, in turns at the band
# chunk on an H100 80GB HBM3 at 700 W: the chain faster at every one):
# (dtype, the retired route, the passes it took, corners as (d_hidden,
# latent, encoded lanes as padded) by name)
FAMILIES = {
    "A": (BF16, "mma_sync", ("forward",), {
        "A1": (64, 1216, 64), "A2": (64, 3328, 64), "A3": (512, 1216, 64),
        "A4": (512, 1984, 64), "A5": (512, 512, 1216), "A6": (512, 1280, 64)}),
    "B": (BF16, "wide", ("forward",), {"B1": (576, 2112, 64), "B2": (704, 2176, 64)}),
    "C": (BF16, "wide", ("dgrad",), {
        "C1": (64, 576, 64), "C2": (64, 4096, 64), "C3": (192, 576, 64),
        "C4": (192, 4096, 64), "C5": (128, 512, 192)}),
    "D": (F32, "wide", ("forward", "dgrad"), {
        "D1": (1024, 1152, 1088), "D2": (576, 1152, 2176), "D3": (768, 1152, 2048),
        "D4": (1024, 1152, 3072)}),
}
GRID_K_IN = (64, 128, 192, 256, 512, 1024, 2048, 4096)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_no_shape_takes_a_retired_route_and_each_family_moved(family):
    """Over d_hidden and latents in multiples of 64 up to 4,096 and the
    encoded widths of GRID_K_IN, no shape of the family's dtype routes to a
    retired kernel (``"mma_sync"``: csrc/resnetfc.cu resnetfc_kernel;
    ``"wide"``: the first wide version), every shape the family's retired
    route took goes to the chain, and every corner the sweep timed took
    that route before and takes the chain now."""
    cd, retired, passes, corners = FAMILIES[family]
    live = ("wgmma", "fma", "wide_tma", "wide_f32", "chain")
    moved = 0
    for backward in (False, True):
        for dh, dl, k_in in itertools.product(range(64, 4097, 64), range(64, 4097, 64),
                                              GRID_K_IN):
            r = (K2.backward_route(cd, dh, dl, k_in) if backward else
                 K2.forward_route(cd, dl, k_in, dh))
            assert r in live
            if ("dgrad" if backward else "forward") in passes and \
                    _route_before(cd, dh, dl, k_in, backward) == retired:
                assert r == "chain", (dh, dl, k_in)
                moved += 1
    assert moved
    for name, (dh, dl, k_in) in corners.items():
        for kind in passes:
            backward = kind == "dgrad"
            if name == "D4" and not backward:
                continue  # its forward was the chain's already
            assert _route_before(cd, dh, dl, k_in, backward) == retired, name
            assert (K2.backward_route(cd, dh, dl, k_in) if backward else
                    K2.forward_route(cd, dl, k_in, dh)) == "chain", name


# ---------------------------------------------------------------------------
# the wide kernels' layout, read from csrc/resnetfc_wide.cu
# ---------------------------------------------------------------------------


def _source():
    return (CSRC / "resnetfc_wide.cu").read_text()


def _wt():
    """The TMA cluster kernels' WT_* constants, evaluated in source order."""
    env = {"GOUT_W": K2.GOUT_W}
    for name, expr in re.findall(r"^constexpr (?:int|uint32_t) (WT_\w+) = ([^;]+);", _source(),
                                 re.M):
        if "," not in expr:  # WT_DH_MIN and WT_DH_MAX share a line: read below
            env[name] = eval(expr, {}, dict(env))  # noqa: S307 - the repo's own constants
    m = re.search(r"constexpr int WT_DH_MIN = (\d+), WT_DH_MAX = (\d+);", _source())
    env["WT_DH_MIN"], env["WT_DH_MAX"] = int(m.group(1)), int(m.group(2))
    return env


@pytest.mark.parametrize("type_name,cd", [("tma", BF16)])
def test_wide_tile_matches_the_source(type_name, cd):
    """The tile the wrapper sizes its view-sum scratch by is the kernel's.
    The TMA cluster kernels: 32 points a CTA, the grid whole clusters (the
    view-sum scratch and the dgrad's pool by a cluster's points), a stage a
    pass of 8 consumer warps' 64 columns of 32 k (4 TMA boxes of 128 rows,
    shared equally by the cluster's CTAs), a producer warp beside eight consumer
    warps, and a warp's trunk two 64-column groups at most (d_hidden up to
    1,024)."""
    assert type_name == "tma"
    wt = _wt()
    assert (wt["WT_TM"], wt["WT_CLUSTER"], wt["WT_STAGES"]) == (
        K2.WIDE_TMA_TM, K2.WIDE_TMA_CLUSTER, K2.WIDE_TMA_STAGES)
    assert (wt["WT_PASS"], wt["WT_KS"], wt["WT_STAGE"]) == (
        K2.WIDE_TMA_PASS, K2.WIDE_TMA_KS, K2.WIDE_TMA_STAGE)
    assert K2.dgrad_tile(cd, "wide_tma") == wt["WT_TM"] * wt["WT_CLUSTER"]
    assert wt["WT_PASS"] == (wt["WT_CONSUMERS"] // 32) * 64
    pieces = wt["WT_PASS"] // wt["WT_PIECE"]
    assert wt["WT_STAGE"] == pieces * wt["WT_PIECE_BYTES"] and pieces % wt["WT_CLUSTER"] == 0
    assert 2 <= wt["WT_CLUSTER"] <= 4 and wt["WT_THREADS"] == wt["WT_CONSUMERS"] + 32
    assert (wt["WT_DH_MIN"], wt["WT_DH_MAX"]) == K2.WIDE_TMA_DH
    assert wt["WT_DH_MAX"] == 2 * wt["WT_PASS"]


def test_smem_max_matches_the_source():
    """The shared memory a block can use, which both cluster kernels' rules
    size by, is the source's ``SMEM_MAX``."""
    assert int(re.search(r"constexpr int SMEM_MAX = (\d+);", _source()).group(1)) == K2.SMEM_MAX


def test_wide_tma_smem_matches_the_source():
    """``wide_tma_smem`` mirrors ``wt_smem`` (the ring, the A region of two
    d_hidden tiles, the forward's as wide as its widest operand, the output
    cotangent tile, the barriers) with the source's constants; the dgrad
    tail's d-encoding chunk (``wt_cw``) fits the second tile as float32 rows
    ``cw + 4`` apart; stages and A boxes are 1,024-byte aligned."""
    wt, src = _wt(), _source()
    body = re.search(r"inline size_t wt_smem\(int dh, int dl, int k_in, bool bwd\) \{\s*"
                     r"return ([^;]+);", src).group(1)
    ka = re.search(r"inline int wt_ka\(int dh, int dl, int k_in, bool bwd\) \{(.+?)\n\}",
                   src, re.S).group(1)
    assert "2 * dh" in ka and "!bwd && dl > k" in ka and "!bwd && k_in > k" in ka
    cw = re.search(r"inline int wt_cw\(int dh\) \{ return ([^;]+); \}", src).group(1)
    for dh in range(wt["WT_DH_MIN"], wt["WT_DH_MAX"] + 1, 64):
        for dl, k_in in ((64, 64), (1152, 576), (640, 64), (2048, 1216)):
            for bwd in (False, True):
                k = 2 * dh if bwd else max(2 * dh, dl, k_in)
                env = dict(wt, dh=dh, dl=dl, k_in=k_in, bwd=bwd,
                           wt_ka=lambda *_: k)
                expr = " ".join(body.replace("(size_t)", "").split()).replace(
                    "wt_ka(dh, dl, k_in, bwd)", "wt_ka()")
                assert eval(expr, {}, env) == K2.wide_tma_smem(dh, dl, k_in, bwd)  # noqa: S307
        c = eval(cw.replace("/", "//"), {}, {"dh": dh})  # noqa: S307
        assert c >= 64 and c % 64 == 0 and (c + 4) * 4 <= dh * 2
    assert wt["WT_STAGE"] % 1024 == 0 and wt["WT_BOX"] % 1024 == 0
    # phase 11's decoder fits: d_hidden 1,024, a latent of 1,152, 576 lanes
    assert K2.wide_tma_smem(1024, 1152, 576) == 230_472 <= K2.SMEM_MAX
    assert K2.wide_tma_smem(1024, 1152, 576, backward=True) == 230_472


@pytest.mark.parametrize("backward", [False, True])
def test_wide_tma_route_rule(backward):
    """The rule between the bf16 kernels past the register kernels is one
    function of the shape, and the envelope does not narrow: every bf16
    shape the first wide version took (d_hidden 576..1,152, and for the
    dgrad 64 to 512 with a latent past 512 or more than 128 lanes; latents
    and inputs to 2,048 lanes) still has a kernel, the TMA cluster one
    exactly where ``wide_tma_fits``, the chain everywhere else (measured
    faster than the retired first version: chip_smoke.py --chain-sweep), and
    the wrapper refuses none of them."""
    route = (lambda dh, dl, k_in: K2.backward_route(BF16, dh, dl, k_in)) if backward else \
        (lambda dh, dl, k_in: K2.forward_route(BF16, dl, k_in, dh))
    dhs = range(64 if backward else 576, 1153, 64)
    for dh in dhs:
        for dl in range(64, 2049, 64):
            for k_in in (64, 128, 192, 576, 1216, 2048):
                r = route(dh, dl, k_in)
                if dh <= 512 and dl <= 512 and k_in <= 128:
                    assert r == "wgmma"
                    continue
                fits = K2.wide_tma_fits(BF16, dh, dl, k_in, backward)
                assert r == ("wide_tma" if fits else "chain")
                assert fits != K2.chain_takes(BF16, dh, dl, k_in, backward)
                if r == "wide_tma":
                    assert 256 <= dh <= 1024
                    assert K2.wide_tma_smem(dh, dl, k_in, backward) <= K2.SMEM_MAX


def _wf():
    """The float32 cluster kernels' WF_* constants."""
    env = {}
    for line in re.findall(r"^constexpr int (WF_\w+ = [^;]+);", _source(), re.M):
        for part in line.split(", "):
            name, expr = part.split(" = ")
            env[name] = eval(expr, {}, dict(env))  # noqa: S307 - the repo's own constants
    return env


def _wf_fn(name):
    """The source text of the body of one of the float32 cluster kernels'
    host-and-device helpers."""
    return re.search(r"inline \w+ " + name + r"\(([^)]*)\) \{(.+?)\n?\}\n", _source(),
                     re.S).group(2)


def test_wide_f32_tile_matches_the_source():
    """The float32 cluster kernels' constants are the wrapper's: 16 points a
    CTA, 8 weight rows a stage, clusters of 2 (the grid, the view-sum scratch
    and the dgrad's pool by a cluster's points), 3 to 8 stages, d_hidden up
    to 1,024: four consumer warps of 16 points x 8 columns a thread (1,024
    columns) beside a producer warp, one launch bound for both kernels."""
    wf = _wf()
    assert (wf["WF_TM"], wf["WF_KS"], wf["WF_CLUSTER"]) == (
        K2.WIDE_F32_TM, K2.WIDE_F32_KS, K2.WIDE_F32_CLUSTER)
    assert (wf["WF_STAGES_MIN"], wf["WF_STAGES_MAX"], wf["WF_DH_MAX"]) == (
        K2.WIDE_F32_STAGES_MIN, K2.WIDE_F32_STAGES_MAX, K2.WIDE_F32_DH_MAX)
    assert K2.dgrad_tile(F32, "wide_f32") == wf["WF_TM"] * wf["WF_CLUSTER"]
    assert wf["WF_KS"] % 4 == 0 and wf["WF_TM"] == 16
    assert wf["WF_CONSUMERS"] * 8 == wf["WF_DH_MAX"] and wf["WF_CONSUMERS"] % 32 == 0
    assert wf["WF_THREADS"] == wf["WF_CONSUMERS"] + 32
    assert _source().count("__launch_bounds__(WF_THREADS, 1)") == 2


def _wf_cover(cw, pt, threads):
    """A numpy mirror of ``wf_map<PT>``: the (point, column) outputs the
    active consumer threads own in a product ``cw`` columns wide, each
    thread PT points x 8 columns (8 PT threads a point set)."""
    seen = np.zeros((16, cw), np.int64)
    s, per_set = 16 // pt, 8 * pt
    for t in range(threads):
        tp, tc = t // per_set, t % per_set
        if not tc < cw // 8:
            continue
        for i in range(pt):
            for c in (4 * tc, cw // 2 + 4 * tc):
                seen[tp + s * i, c:c + 4] += 1
    return seen


@pytest.mark.parametrize("dh", [576, 640, 768, 1024])
def test_wide_f32_threads_cover_each_output_once(dh):
    """Every product's outputs have one owner: a d_hidden-wide product at 16
    points a thread, and the dgrad's windows (lin_in and the latent in
    windows of d_hidden columns, the last narrower) at ``wf_pt``'s points a
    thread (the source's rule mirrored), every (point, column) once on the
    128 consumer threads; at 16 points a warp's 32 column threads read 512
    contiguous bytes of a weight row."""
    threads = _wf()["WF_CONSUMERS"]
    pt_rule = _wf_fn("wf_pt")
    assert "while (pt < 16 && 64 * pt < cw) pt *= 2;" in pt_rule
    assert "const int tc = threadIdx.x % T;" in _source()

    def wf_pt(cw):
        pt = 1
        while pt < 16 and 64 * pt < cw:
            pt *= 2
        return pt

    assert wf_pt(dh) == 16
    assert (_wf_cover(dh, 16, threads) == 1).all()
    for n in (64, 576, 612 // 64 * 64 + 64, 1152, 2048):
        for cb in range(0, n, dh):
            cw = min(dh, n - cb)
            pt = wf_pt(cw)
            assert (16 // pt) * 8 * pt == threads
            assert (_wf_cover(cw, pt, threads) == 1).all(), (n, cb, cw)


def test_wide_f32_smem_matches_the_source():
    """``wide_f32_stages`` / ``wide_f32_smem`` mirror ``wf_stages`` /
    ``wf_smem`` (the ring of 8-row weight stages, the trunk, the operand
    tile as wide as d_hidden or the encoded input,
    g_epi and the barriers); every shape the route rule sends there fits the
    card's 232,448 bytes with at least 3 stages."""
    wf, src = _wf(), _source()
    assert "return (dh > k_in ? dh : k_in) + 4;" in _wf_fn("wf_lda")
    assert "return WF_KS * dh;" in _wf_fn("wf_stage_floats")
    fixed = " ".join(_wf_fn("wf_fixed").split())
    assert fixed == ("return 4 * ((size_t)WF_TM * (dh + 4) + (size_t)WF_TM * wf_lda(dh, k_in) + "
                     "WF_TM * GOUT_W) + 2 * WF_STAGES_MAX * 8;")
    assert "room / (4ll * wf_stage_floats(dh))" in _wf_fn("wf_stages")
    assert "wf_stages(dh, k_in) * 4 * wf_stage_floats(dh) + wf_fixed(dh, k_in)" in \
        " ".join(_wf_fn("wf_smem").replace("(size_t)", "").split())
    assert "wf_stages(d_hidden, k_in) >= WF_STAGES_MIN" in src
    for dh in range(64, 1793, 64):
        for k_in in (64, 128, 576, 1216, 2048):
            lda = max(dh, k_in) + 4
            fix = 4 * (wf["WF_TM"] * (dh + 4) + wf["WF_TM"] * lda + wf["WF_TM"] * K2.GOUT_W) \
                + 2 * wf["WF_STAGES_MAX"] * 8
            stage = 4 * wf["WF_KS"] * dh
            stages = max(0, min(wf["WF_STAGES_MAX"], (K2.SMEM_MAX - fix) // stage))
            assert K2.wide_f32_stages(dh, k_in) == stages
            assert K2.wide_f32_smem(dh, k_in) == stages * stage + fix
            if K2.wide_f32_fits(F32, dh, k_in):
                assert K2.wide_f32_smem(dh, k_in) <= K2.SMEM_MAX and stages >= 3
    # phase 11's decoder: d_hidden 1,024 and 576 encoded lanes, three stages
    assert K2.wide_f32_stages(1024, 576) == 3
    assert K2.wide_f32_smem(1024, 576) == 230_528 <= K2.SMEM_MAX


@pytest.mark.parametrize("backward", [False, True])
def test_wide_f32_route_rule(backward):
    """The float32 rule is one function of the shape, and the envelope does
    not narrow: every float32 shape the first wide version took (d_hidden
    576 to 1,792; latents and inputs to 2,048 lanes) still has a kernel,
    the cluster one exactly where ``wide_f32_fits`` (d_hidden up to 1,024
    with three stages), the chain everywhere else (measured faster than the
    retired first version: chip_smoke.py --chain-sweep family D); none is
    refused."""
    route = (lambda dh, dl, k_in: K2.backward_route(F32, dh, dl, k_in)) if backward else \
        (lambda dh, dl, k_in: K2.forward_route(F32, dl, k_in, dh))
    for dh in range(576, 1793, 64):
        for dl in range(64, 2049, 128):
            for k_in in (64, 128, 576, 1216, 2048):
                r = route(dh, dl, k_in)
                fits = K2.wide_f32_fits(F32, dh, k_in)
                assert r == ("wide_f32" if fits else "chain")
                assert fits != K2.chain_takes(F32, dh, dl, k_in, backward)
                assert fits == (dh <= 1024 and K2.wide_f32_stages(dh, k_in) >= 3)
    # the narrow float32 kernels keep d_hidden 512 and below
    assert route(512, 1152, 576) == "fma" and not K2.wide_f32_fits(F32, 512, 64)
    assert not K2.wide_f32_fits(BF16, 1024, 64)


# ---------------------------------------------------------------------------
# the latent padding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d_latent", [612, 100])
def test_padded_latent_is_the_same_function(d_latent):
    """``pad_latent`` appends zero lanes to ``z`` and ``wz``'s columns up to a
    multiple of 64: the plain version on the padded operands is the same
    function.  The latents and latent weights are eighths in [-2, 2], so
    each injection's sum is exact in any order and the padded call's
    forward equals the unpadded one's bit for bit (every other product has
    the same shape in both); the gradients of the real lanes agree to the
    float32 sum order of the padded products' shapes, and the padded lanes'
    gradients, which the wrapper slices away, are exactly zero."""
    rng = np.random.default_rng(d_latent)
    _, port = _decoder(128, d_latent, 6, 3)
    w = [t.detach() for t in port.weights()]
    eighths = lambda *shape: torch.from_numpy(rng.integers(-16, 17, size=shape) / 8.0).float()
    w[2] = eighths(*w[2].shape)
    x = torch.from_numpy(rng.uniform(-1, 1, size=(2, N, 6)).astype(np.float32))
    z = eighths(2, N, d_latent)
    zp, wzp = K2.pad_latent(z, w[2])
    assert zp.shape[-1] == wzp.shape[-1] == K2.d_enc_padded(d_latent)
    assert torch.equal(zp[..., :d_latent], z) and not zp[..., d_latent:].any()
    assert torch.equal(wzp[..., :d_latent], w[2]) and not wzp[..., d_latent:].any()
    kw = dict(n_blocks=N_BLOCKS, n_lin_z=N_LIN_Z, code=K2.CodeSpec(**_spec(6)),
              activate_out=True)
    g = torch.from_numpy((rng.normal(size=(N, 4)) + 0.5).astype(np.float32))
    for cd in (F32, BF16):
        leaves = [t.clone().requires_grad_(True) for t in (z, w[2], zp, wzp)]
        want = K2.resnetfc_plain(x, leaves[0], K2.DecoderWeights(*w[:2], leaves[1], *w[3:]),
                                 compute_dtype=cd, **kw)
        got = K2.resnetfc_plain(x, leaves[2], K2.DecoderWeights(*w[:2], leaves[3], *w[3:]),
                                compute_dtype=cd, **kw)
        assert torch.equal(got, want)
        dz, dwz = torch.autograd.grad(want, leaves[:2], g)
        dzp, dwzp = torch.autograd.grad(got, leaves[2:], g)
        _close(dzp[..., :d_latent].numpy(), dz.numpy(), 1e-6, "dz")
        _close(dwzp[..., :d_latent].numpy(), dwz.numpy(), 1e-6, "dwz")
        assert not dzp[..., d_latent:].any() and not dwzp[..., d_latent:].any()


def test_pad_latent_keeps_a_multiple_of_64():
    z, wz = torch.zeros(1, 3, 640), torch.zeros(2, 8, 640)
    zp, wzp = K2.pad_latent(z, wz)
    assert zp is z and wzp is wz
