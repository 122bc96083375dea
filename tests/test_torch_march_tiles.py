"""K3's bf16 tile kernels: the route, the gate layout and the latent cotangent.

``avr_tpu_torch/csrc/march.cu`` marches bf16 rays in tiles of ``TILE_RAYS``
on the tensor cores (``lstm_march_tile_kernel``, ``lstm_march_tile_bwd_kernel``);
float32 keeps the warp-per-ray kernels.  This file holds, on the CPU:

* ``march_route`` (``ops/kernels/march.py``): bf16 to the tiles, float32 to
  the warp-per-ray kernels, hidden outside 1 .. 62 raised;
* the gate permutation and its inverse, and ``b_fragments``' lane order,
  against the plain gates: through ``mma.sync.m16n8k16``'s A, B and
  accumulator layouts as the PTX ISA gives them (one index map,
  ``_lane_elements``), one forward cell step and the backward's two gate
  products are held to the plain arithmetic, with ``UNIT_BLOCK`` and
  ``TILE_RAYS`` read from ``march.cu``;
* the forward's weight fragments kept per weight, and gathered anew on
  every change the wrapper can see;
* the backward's decomposition of the latent cotangent: every ray-step's
  ``dv_t / NS`` from the plain version's autograd, added through
  ``tests/test_torch_gather_bins.py``'s numpy mirror of the bins at the
  ray-step's projected point, against the Pallas kernel's VJP ``dfeat``
  (interpret mode, float32), within 1e-5 of the largest value.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu.ops.pallas.march import fused_lstm_march as pallas_march
from avr_tpu.ops.pallas.march import pack_projection as jax_pack_projection
from avr_tpu_torch.ops.kernels import march as K3
from tests.test_torch_gather_bins import _accumulate, _sort, _taps

torch.set_num_threads(2)

SRC = Path(K3.__file__).resolve().parents[2] / "csrc" / "march.cu"
CONST = {m[1]: int(m[2]) for m in re.finditer(r"constexpr int (\w+) = (\d+);", SRC.read_text())}


def test_constants_match_the_kernel_source():
    assert (K3.UNIT_BLOCK, K3.TILE_RAYS, K3.MAX_HIDDEN) == (
        CONST["UNIT_BLOCK"], CONST["TILE_RAYS"], CONST["MAX_HIDDEN"])
    assert CONST["TILE_RAYS"] == 16  # the m16 of mma.sync.m16n8k16


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hidden", [1, 8, 16, 17, 32, 48, 62])
def test_bf16_takes_the_tiles_and_float32_the_warp_kernels(hidden):
    assert K3.march_route(torch.bfloat16, hidden) == "tiles"
    assert K3.march_route(torch.float32, hidden) == "warp"


@pytest.mark.parametrize("hidden", [0, 63, 64, 1024])
def test_hidden_outside_the_kernels_raises(hidden):
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="hidden"):
            K3.march_route(dtype, hidden)


def test_another_dtype_raises():
    with pytest.raises(TypeError):
        K3.march_route(torch.float16, 16)


# ---------------------------------------------------------------------------
# the gate layout, mirrored lane by lane
# ---------------------------------------------------------------------------

B16 = lambda a: torch.as_tensor(a, dtype=torch.float32).to(torch.bfloat16).float().numpy()


def _b_matrix(frags, K, N):
    """``b_fragments`` read back through the PTX B layout: lane l's b0 holds
    (k = 2 (l % 4) + {0, 1}, n = l // 4), b1 the same 8 rows down."""
    frags = np.asarray(frags.float())
    out = np.zeros((frags.shape[0] * 16, frags.shape[1] * 16), np.float32)
    for kc, j, lane, e in np.ndindex(frags.shape):
        k = 16 * kc + 8 * (e % 4 // 2) + 2 * (lane % 4) + e % 2
        n = 16 * j + 8 * (e // 4) + lane // 4
        out[k, n] = frags[kc, j, lane, e]
    return out[:K, :N]


def _lane_elements(HP):
    """The PTX accumulator layout over the permuted gates, the one index map
    the tests below share: element e of lane ``lane``'s n8 tiles 4 blk + k
    is (row, unit) of gate k, at permuted column ``col0 + 8 k``."""
    for lane, blk, e in np.ndindex(32, HP // K3.UNIT_BLOCK, 4):
        q = lane % 4
        row, c = lane // 4 + 8 * (e >> 1), 2 * q + (e & 1)
        yield lane, blk, e, row, blk * K3.UNIT_BLOCK + c, 4 * blk * K3.UNIT_BLOCK + c


def _acc(a, b, j, lane, e):
    """Element e of lane ``lane``'s accumulator of n8 tile j of ``a @ b``."""
    return (a @ b)[lane // 4 + 8 * (e >> 1), 8 * j + 2 * (lane % 4) + (e & 1)]


def _a_matrix(frag, KK):
    """A fragments ``frag[lane][kk][r]`` (pairs of values) read back through
    the PTX A layout: a0 (g, 2 q..), a1 (g + 8, 2 q..), a2 (g, 8 + 2 q..),
    a3 (g + 8, 8 + 2 q..)."""
    out = np.zeros((16, 16 * KK), np.float32)
    for lane in range(32):
        g, q = lane // 4, lane % 4
        for kk in range(KK):
            for r in range(4):
                row, col = g + 8 * (r & 1), 16 * kk + 8 * (r >> 1) + 2 * q
                out[row, col:col + 2] = frag[lane][kk][r]
    return out


@pytest.mark.parametrize("hid", [16, 5, 62, 24])
def test_permutation_and_inverse(hid):
    """Every gate column once, the padding zero, and a lane's accumulator
    elements hold all four gates of one unit; the inverse undoes it."""
    perm = K3.gate_permutation(hid)
    HP = K3.padded_hidden(hid)
    assert perm.shape == (4 * HP,) and HP % 16 == 0 and HP - hid < 16
    live = perm[perm < 4 * hid]
    assert sorted(live.tolist()) == list(range(4 * hid))  # every gate column once
    for _, _, _, _, u, col0 in _lane_elements(HP):
        for k in range(4):
            assert perm[col0 + 8 * k] == (k * hid + u if u < hid else 4 * hid)
    w = torch.randn(3, 4 * hid)
    wp = K3.permute_gates(w, hid)
    assert (wp[:, perm == 4 * hid] == 0).all()
    assert torch.equal(K3.unpermute_gates(wp, hid), w)


@pytest.mark.parametrize("K,N", [(512, 64), (16, 64), (20, 24), (64, 512)])
def test_b_fragments_follow_the_ptx_layout(K, N):
    b = torch.randn(K, N).to(torch.bfloat16)
    frags = K3.b_fragments(b)
    assert frags.shape == (-(-K // 16), -(-N // 16), 32, 8)
    np.testing.assert_array_equal(_b_matrix(frags, K, N), b.float().numpy())


@pytest.mark.parametrize("hid,C", [(16, 512), (5, 40), (62, 24)])
@pytest.mark.parametrize("backward", [False, True])
def test_tile_operands_are_one_gather_of_the_fragments(hid, C, backward):
    """The wrapper's cached gather indices give the permuted gates' B
    fragments (the backward's: of their transpose)."""
    a = dict(w_ih=torch.randn(C, 4 * hid).bfloat16(), w_hh=torch.randn(hid, 4 * hid).bfloat16())
    t = K3._tile_operands(a, hid, backward)
    frag = lambda w: K3.b_fragments(K3.permute_gates(w, hid).t() if backward
                                    else K3.permute_gates(w, hid))
    names = ("wihT", "whhT") if backward else ("wih", "whh")
    assert sorted(t) == sorted(names)
    assert torch.equal(t[names[0]], frag(a["w_ih"])) and torch.equal(t[names[1]], frag(a["w_hh"]))


def _kept(w_ih, w_hh, hid):
    a = dict(w_ih=w_ih.detach().bfloat16(), w_hh=w_hh.detach().bfloat16())
    return K3._kept_fragments(w_ih, w_hh, a, hid), K3._tile_operands(a, hid, backward=False)


@pytest.mark.parametrize("change", ["in place", "views of one base", "another tensor"])
def test_kept_fragments_follow_the_weights(change):
    """The forward's fragments are kept per pair of weights: a second call
    with the same tensors gathers nothing, and every change the wrapper can
    see (a version bump, another tensor) gathers them anew."""
    hid, C = 16, 48
    w_ih = torch.nn.Parameter(torch.randn(C, 4 * hid))
    w_hh = torch.nn.Parameter(torch.randn(hid, 4 * hid))
    first, _ = _kept(w_ih, w_hh, hid)
    again, want = _kept(w_ih, w_hh, hid)
    assert again is first and torch.equal(again["wih"], want["wih"])
    if change == "in place":
        with torch.no_grad():
            w_hh.mul_(-2.0)
        got, want = _kept(w_ih, w_hh, hid)
    elif change == "views of one base":  # a view made anew each call, as weight.T is
        base = torch.nn.Parameter(torch.randn(4 * hid, C))
        first, _ = _kept(base.t(), w_hh, hid)
        got, want = _kept(base.t(), w_hh, hid)
        assert got is first
        with torch.no_grad():
            base.add_(1.0)
        got, want = _kept(base.t(), w_hh, hid)
    else:
        got, want = _kept(w_ih.detach().clone() + 1.0, w_hh, hid)
    assert got is not first
    assert torch.equal(got["wih"], want["wih"]) and torch.equal(got["whh"], want["whh"])


def test_inference_tensors_are_not_kept():
    hid, C = 5, 24
    with torch.inference_mode():
        w_ih, w_hh = torch.randn(C, 4 * hid), torch.randn(hid, 4 * hid)
        first, _ = _kept(w_ih, w_hh, hid)
        again, want = _kept(w_ih, w_hh, hid)
    assert again is not first and torch.equal(again["whh"], want["whh"])


@pytest.mark.parametrize("hid", [16, 5, 62])
def test_tile_cell_matches_the_plain_gates(hid):
    """lstm_march_tile_kernel's indexing: a lane's gate k at element e of
    its n8 tile 4 blk + k (acc + hac) plus the bias staged in the permuted
    layout is gate k of the unit ``_lane_elements`` gives; the cell run
    there, and round(h) packed as hn[G][2 ub + row] (blk = 2 G + ub), give
    the plain cell's h and c and the next step's A fragments."""
    rng = np.random.default_rng(hid)
    C, HP = 48, K3.padded_hidden(hid)
    v, h = B16(rng.normal(size=(16, C))), B16(rng.normal(size=(16, hid)) * 0.5)
    c = rng.normal(size=(16, hid)).astype(np.float32)
    w_ih, w_hh = B16(rng.normal(size=(C, 4 * hid)) * 0.2), B16(rng.normal(size=(hid, 4 * hid)))
    bias = B16(rng.normal(size=4 * hid) * 0.1)
    gates = v @ w_ih + h @ w_hh + bias
    sig = lambda x: 1 / (1 + np.exp(-x))
    i, f, g, o = np.split(gates, 4, axis=-1)
    c_want = sig(f) * c + sig(i) * np.tanh(g)
    h_want = sig(o) * np.tanh(c_want)
    tt = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    wih_b = _b_matrix(K3.b_fragments(K3.permute_gates(tt(w_ih), hid)), C, 4 * HP)
    whh_b = _b_matrix(K3.b_fragments(K3.permute_gates(tt(w_hh), hid)), HP, 4 * HP)
    bias_s = K3.permute_gates(torch.from_numpy(bias), hid).numpy()
    h_pad = np.zeros((16, HP), np.float32)
    h_pad[:, :hid] = h
    c_pad = np.zeros((16, HP), np.float32)
    c_pad[:, :hid] = c
    h_got, c_got = np.zeros((16, HP), np.float32), np.zeros((16, HP), np.float32)
    hv = {}
    for lane, blk, e, row, u, col0 in _lane_elements(HP):
        pre = [_acc(v, wih_b, 4 * blk + k, lane, e) + _acc(h_pad, whh_b, 4 * blk + k, lane, e)
               + bias_s[col0 + 8 * k] for k in range(4)]
        c_got[row, u] = sig(pre[1]) * c_pad[row, u] + sig(pre[0]) * np.tanh(pre[2])
        h_got[row, u] = sig(pre[3]) * np.tanh(c_got[row, u])
        hv[lane, blk, e] = B16(h_got[row, u])
    np.testing.assert_allclose(h_got[:, :hid], h_want, atol=2e-5)
    np.testing.assert_allclose(c_got[:, :hid], c_want, atol=2e-5)
    assert (h_got[:, hid:] == 0).all() and (c_got[:, hid:] == 0).all()  # padded units stay 0
    # hn[G] is the A fragment of k16 chunk G of the next h W_hh product
    hn = [[[(hv[lane, 2 * G + r // 2, 2 * (r % 2)], hv[lane, 2 * G + r // 2, 2 * (r % 2) + 1])
            for r in range(4)] for G in range(HP // 16)] for lane in range(32)]
    np.testing.assert_array_equal(_a_matrix(hn, HP // 16), B16(h_got))


@pytest.mark.parametrize("hid", [16, 5, 62])
def test_tile_backward_products_match_the_plain_gates(hid):
    """lstm_march_tile_bwd_kernel's indexing: the lane's dgates of tile
    4 blk + k as dgf[2 blk + k / 2][2 (k & 1) + row] are round(dgates) in the
    permuted layout; dgf times W_ih^T's and W_hh^T's fragments gives dv and
    gh (n8 tile blk of gh at the unit ``_lane_elements`` gives); the dgates
    rows come back to the plain order through unpermute_gates."""
    rng = np.random.default_rng(100 + hid)
    C, HP = 40, K3.padded_hidden(hid)
    dg = B16(rng.normal(size=(16, 4 * hid)))
    w_ih, w_hh = B16(rng.normal(size=(C, 4 * hid))), B16(rng.normal(size=(hid, 4 * hid)))
    dg_perm = K3.permute_gates(torch.from_numpy(dg), hid).numpy()
    val = {}
    for lane, blk, e, row, _, col0 in _lane_elements(HP):
        for k in range(4):
            val[lane, blk, k, e] = dg_perm[row, col0 + 8 * k]
    frag = [[[(val[lane, kk // 2, 2 * (kk % 2) + r // 2, 2 * (r % 2)],
               val[lane, kk // 2, 2 * (kk % 2) + r // 2, 2 * (r % 2) + 1]) for r in range(4)]
             for kk in range(HP // 4)] for lane in range(32)]
    a = _a_matrix(frag, HP // 4)
    np.testing.assert_array_equal(a, dg_perm)
    tt = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    wihT = _b_matrix(K3.b_fragments(K3.permute_gates(tt(w_ih), hid).t()), 4 * HP, C)
    whhT = _b_matrix(K3.b_fragments(K3.permute_gates(tt(w_hh), hid).t()), 4 * HP, HP)
    np.testing.assert_allclose(a @ wihT, dg @ w_ih.T, rtol=1e-5, atol=1e-4)
    gh_want = dg @ w_hh.T
    for lane, blk, e, row, u, _ in _lane_elements(HP):
        want = gh_want[row, u] if u < hid else 0.0
        assert _acc(a, whhT, blk, lane, e) == pytest.approx(want, abs=1e-4)
    np.testing.assert_array_equal(K3.unpermute_gates(torch.from_numpy(dg_perm), hid).numpy(), dg)


# ---------------------------------------------------------------------------
# the latent cotangent through the bins, against the Pallas kernel's VJP
# ---------------------------------------------------------------------------

SB, R, H, W, C, HID, STEPS = 2, 40, 16, 16, 32, 16, 3


def _march_case(ns, seed=3):
    rng = np.random.default_rng(seed)
    rot = lambda a: np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    poses = np.concatenate([np.stack([rot(a) for a in rng.uniform(-0.3, 0.3, SB * ns)]),
                            rng.uniform(-0.05, 0.05, (SB * ns, 3, 1)) + [[0], [0], [1.3]]],
                           axis=-1).astype(np.float32)
    rds = rng.normal(size=(SB, R, 3))
    rds[..., 2] = np.abs(rds[..., 2]) + 0.5
    rds = (rds / np.linalg.norm(rds, axis=-1, keepdims=True)).astype(np.float32)
    coords0 = (rng.normal(scale=0.05, size=(SB, R, 3))
               + rds * rng.normal(0.8, 0.05, (SB, R, 1))).astype(np.float32)
    cam = [np.asarray(x, np.float32) for x in
           (poses, [[40.0, -38.0]], [[32.0, 31.0]], [2.0, 2.0], [64.0, 64.0])]
    return dict(
        proj=np.asarray(jax_pack_projection(*(jnp.asarray(x) for x in cam))).reshape(SB, ns, 16),
        coords0=coords0, rds=rds,
        feat=rng.normal(size=(SB, ns, H, W, C)).astype(np.float32),
        w_ih=(rng.normal(size=(C, 4 * HID)) * 0.1).astype(np.float32),
        w_hh=(rng.normal(size=(HID, 4 * HID)) * 0.3).astype(np.float32),
        bias=(rng.normal(size=4 * HID) * 0.1).astype(np.float32),
        w_out=(rng.normal(size=(HID, 1)) * 0.5).astype(np.float32),
        b_out=np.asarray([0.01], np.float32))


def _plain_dv_rows(inp, g, eps, monkeypatch):
    """Every ray-step's projected grid and the plain version's cotangent of
    each view's gather output (dv_t / NS in float32), by step and view."""
    seen = []
    gather = K3.bilinear_f32

    def recorded(feat, grid):
        out = gather(feat, grid)
        out.retain_grad()
        seen.append((grid.detach().numpy(), out))
        return out

    monkeypatch.setattr(K3, "bilinear_f32", recorded)
    t = {k: torch.tensor(v, requires_grad=k != "proj") for k, v in inp.items()}
    out = K3.lstm_march_plain(*(t[k] for k in ("proj", "coords0", "rds", "feat", "w_ih", "w_hh",
                                               "bias", "w_out", "b_out")),
                              steps=STEPS, early_stop_eps=eps, compute_dtype=torch.float32)
    out.backward(torch.from_numpy(g))
    return [(grid, o.grad.numpy()) for grid, o in seen]


@pytest.mark.parametrize("ns,eps", [(1, 0.0), (2, 0.0), (1, 0.1), (2, 0.1)])
def test_binned_march_dfeat_matches_pallas_vjp(ns, eps, monkeypatch):
    inp = _march_case(ns)
    g = np.random.default_rng(9).normal(size=(SB, R, 3)).astype(np.float32)
    rows = _plain_dv_rows(inp, g, eps, monkeypatch)  # step-major, then view
    # map b = sb * NS + view lists the scene's ray-steps, point r * steps + t
    grid = np.zeros((SB, ns, R, STEPS, 2), np.float32)
    dv = np.zeros((SB, ns, R, STEPS, C), np.float32)
    for i, (gr, d) in enumerate(rows):
        t, view = divmod(i, ns)
        grid[:, view, :, t], dv[:, view, :, t] = gr, d
    for view in range(1, ns):  # the views share one dv row, as the kernel's do
        np.testing.assert_array_equal(dv[:, view], dv[:, 0])
    frozen = (dv == 0).all(-1)
    if eps:  # some ray-steps froze: their rows are exact zeros
        assert frozen.any() and not frozen.all()
    else:
        assert not frozen.any()
    maps = SB * ns
    grid, dv = grid.reshape(maps, R * STEPS, 2), dv.reshape(maps, R * STEPS, C)
    idx, w = _taps(grid, H, W)
    got, _ = _accumulate(idx, w, dv, H, W, _sort(idx, H, W))
    args = [jnp.asarray(inp[k]) for k in ("proj", "coords0", "rds", "feat", "w_ih", "w_hh",
                                          "bias", "w_out", "b_out")]
    _, vjp = jax.vjp(lambda *a: pallas_march(*a, steps=STEPS, compute_dtype=jnp.float32,
                                             early_stop_eps=eps, interpret=True), *args)
    want = np.asarray(vjp(jnp.asarray(g))[3])
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
