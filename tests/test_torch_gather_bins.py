"""The gather backward's bin plan (``avr_tpu_torch/csrc/gather.cu``).

K1's and K5's backward kernels accumulate ``dfeat`` without float atomics:
a stable counting sort lists every point in the 8 x 8 map tiles its four
taps touch, and one CTA per (bin chunk, channel slice) adds ``round(w) *
g`` over its bin in order.  This file mirrors that plan in numpy, naming
the lines of ``gather.cu`` each step mirrors:

* ``_taps``: ``bilinear_taps`` (``csrc/common.cuh``), each operation
  rounded to float32 on its own;
* ``_codes``: ``tile_code`` (``_sort`` lists ``code_tile``'s slots);
* ``_sort``: ``gather_bin_count_kernel`` (a block's count in each tile it
  touches), ``gather_bin_scan_kernel`` (offsets within the bin, sizes),
  ``sort_block_entries`` (a sort block's entries keyed by tile and point,
  its bitonic network) and ``gather_bin_scatter_kernel`` (rank within the
  block: position less the tile's first);
* ``_plan``: ``gather_bin_plan_kernel`` (starts, chunks under the
  ``PARTIAL_CHUNKS`` budget, work items, partial slots);
* ``_accumulate``: ``AccItem`` (item to bin, chunk bounds), then
  ``gather_bin_accum_kernel``, the float32 maps' kernel (taps in the tile
  with nonzero rounded weight, added entry after entry), and
  ``gather_bin_reduce_kernel`` (partials in chunk order).  bf16 maps take
  ``gather_bin_mma_kernel``: the same entries in the same order, 16 to a
  tensor-core product.

On the mirror: every (point, tap) of nonzero weight is added exactly once,
in the tile holding its pixel, each pixel's points in ascending order, at
tile edges and the map border too, on a map past 1,024 tiles; a bin longer than ``CHUNK_MIN`` is
split, and the split bins' chunks stay within the budget; summing ``dfeat``
bin by bin in that order matches JAX's ``gather_bilinear_windowed`` VJP
(``_wbwd``) and ``gather_bilinear_projected``'s (``_pbwd``), Pallas in
interpret mode as ``tests/test_torch_grads.py`` runs it, within 1e-5 of
the largest value (float32: the same products summed in another order).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu.ops.pallas.gather import gather_bilinear_projected as pallas_projected
from avr_tpu.ops.pallas.gather import gather_bilinear_windowed
from avr_tpu.ops.pallas.march import pack_projection as jax_pack_projection
from avr_tpu_torch.ops.kernels import gather as K1
from avr_tpu_torch.ops.kernels.gather import project_packed
from avr_tpu_torch.ops.kernels.march import pack_projection
from tests.test_torch_gather_proj import _proj_case

SRC = Path(K1.__file__).resolve().parents[2] / "csrc" / "gather.cu"
CONST = {m[1]: int(m[2]) for m in
         re.finditer(r"constexpr int (\w+) = (\d+);", SRC.read_text())}
TILE, SEG, CHUNK_MIN, PARTIAL = (CONST[k] for k in ("TILE", "SEG", "CHUNK_MIN",
                                                    "PARTIAL_CHUNKS"))
F32 = np.float32


def test_constants_match_the_kernel_source():
    assert (K1.TILE, K1.SEG, K1.PARTIAL_CHUNKS) == (TILE, SEG, PARTIAL)
    assert CONST["SLICE"] == 128 and CHUNK_MIN > 0


def _taps(grid, H, W):
    """``bilinear_taps``: flat tap indices ``(P, 4)`` and weights, each
    float32 operation rounded on its own in the kernel's order."""
    gx, gy = grid[..., 0].astype(F32), grid[..., 1].astype(F32)
    x = np.clip((gx + F32(1)) * F32(0.5) * F32(W - 1), F32(0), F32(W - 1))
    y = np.clip((gy + F32(1)) * F32(0.5) * F32(H - 1), F32(0), F32(H - 1))
    x0, y0 = np.floor(x), np.floor(y)
    wx, wy = x - x0, y - y0
    x0i, y0i = x0.astype(np.int64), y0.astype(np.int64)
    x1i, y1i = np.minimum(x0i + 1, W - 1), np.minimum(y0i + 1, H - 1)
    idx = np.stack([y0i * W + x0i, y0i * W + x1i, y1i * W + x0i, y1i * W + x1i], -1)
    ux, uy = F32(1) - wx, F32(1) - wy
    w = np.stack([uy * ux, uy * wx, wy * ux, wy * wx], -1).astype(F32)
    return idx, w


def _codes(idx, W, TX):
    """``tile_code``: the top-left tap's tile << 2 | down << 1 | right."""
    y0, x0 = idx[..., 0] // W, idx[..., 0] % W
    x1, y1 = idx[..., 1] % W, idx[..., 2] // W
    tx0, ty0 = x0 // TILE, y0 // TILE
    sx, sy = (x1 // TILE != tx0), (y1 // TILE != ty0)
    return (ty0 * TX + tx0) << 2 | sy.astype(np.int64) << 1 | sx.astype(np.int64)


def _plan(totals):
    """``gather_bin_plan_kernel``: starts, chunks, first work items (and
    their count last), partial slots."""
    totals = np.asarray(totals, np.int64)
    start = np.concatenate([[0], np.cumsum(totals)[:-1]])
    d = np.where(totals > CHUNK_MIN, -(-totals // CHUNK_MIN), 1)
    wanted = int(d[d > 1].sum())
    k = d if wanted <= PARTIAL else np.where(d == 1, 1, np.maximum(1, d * PARTIAL // wanted))
    wstart = np.concatenate([[0], np.cumsum(k)])
    split = np.where(k > 1, k, 0)
    pslot = np.concatenate([[0], np.cumsum(split)[:-1]])
    return start, k, wstart, pslot


def _bitonic(keys):
    """``sort_block_entries``'s network: the source's compare-and-swap steps
    over the last axis (a power of two)."""
    keys = keys.copy()
    n = keys.shape[-1]
    p = np.arange(n // 2)
    size = 2
    while size <= n:
        stride = size >> 1
        while stride > 0:
            i = 2 * p - (p & (stride - 1))
            j = i + stride
            a, c = keys[..., i], keys[..., j]
            swap = (a > c) == ((i & size) == 0)
            keys[..., i], keys[..., j] = np.where(swap, c, a), np.where(swap, a, c)
            stride >>= 1
        size <<= 1
    return keys


def _sort(idx, H, W):
    """count, scan and scatter: the sorted entries (a point index within
    its view per entry), the bin sizes and the plan.  ``idx`` is (B, N, 4).
    count adds a sort block's entries to its (bin, block) counts; scatter
    keys them (tile << 10) | (4 * local point + slot), compacted in thread
    order, padded with ~0 to the least power of two that holds them and
    sorted by the block's bitonic network; a key's rank is its position less
    its tile's first."""
    B, N = idx.shape[:2]
    TX, T = -(-W // TILE), -(-W // TILE) * -(-H // TILE)
    nseg = -(-N // SEG)
    code = np.full((B, nseg * SEG), -1, np.int64)  # points past N have no tile
    code[:, :N] = _codes(idx, W, TX)
    t, sx, sy = code >> 2, code & 1, code >> 1 & 1
    tiles = np.stack([t, np.where(sx, t + 1, -1), np.where(sy, t + TX, -1),
                      np.where(sx & sy, t + TX + 1, -1)], -1)  # code_tile's slots
    tiles[code < 0] = -1
    none = np.uint64(2 ** 64 - 1)
    local = np.arange(4 * SEG, dtype=np.uint64)
    tiles = tiles.reshape(B, nseg, 4 * SEG)  # thread-major, slot-minor: the compaction's order
    hist = np.zeros((B * T, nseg), np.int64)
    placed = []  # (view, block, tile, rank, point)
    for b in range(B):
        for s in range(nseg):
            on = tiles[b, s] >= 0
            k = tiles[b, s][on].astype(np.uint64) << np.uint64(10) | local[on]
            total = len(k)
            size = 1
            while size < total:
                size *= 2
            k = _bitonic(np.concatenate([k, np.full(size - total, none)]))
            assert (k == np.sort(k)).all() and (k[total:] == none).all()  # the network sorts
            k = k[:total]
            tile = (k >> np.uint64(10)).astype(np.int64)
            first = np.searchsorted(tile, tile, "left")
            rank = np.arange(len(tile)) - first
            np.add.at(hist[:, s], b * T + tile, 1)  # count: integer adds per (bin, block)
            last = np.append(tile[1:] != tile[:-1], True)  # a tile's last key: rank count - 1
            assert (rank[last] + 1 == hist[b * T + tile[last], s]).all()
            pts = s * SEG + (k & np.uint64(1023)).astype(np.int64) // 4
            placed += [(b, s, tt, r, p) for tt, r, p in zip(tile, rank, pts)]
    # scan: offsets within the bin; plan
    offsets = np.cumsum(hist, 1) - hist
    totals = hist.sum(1)
    start, k, wstart, pslot = _plan(totals)
    # scatter: an entry's place, its rank after the bin's earlier blocks
    entries = np.full(int(totals.sum()), -1, np.int64)
    pos = [start[b * T + tt] + offsets[b * T + tt, s] + r for b, s, tt, r, _ in placed]
    entries[pos] = [p for *_, p in placed]
    assert (entries >= 0).all() and len(np.unique(pos)) == len(pos)
    return entries, totals, (start, k, wstart, pslot), (TX, T)


def _accumulate(idx, w, g, H, W, sort):
    """accumulate and reduce: dfeat (B, H, W, C) float32, and the additions
    as (view, pixel, point, tap) in the order they are made."""
    entries, totals, (start, k, wstart, pslot), (TX, T) = sort
    B, N, C = g.shape
    NB = B * T
    dfeat = np.zeros((B, H * W, C), F32)
    partial = {}
    adds = []
    for item in range(int(wstart[NB])):
        bin_ = int(np.searchsorted(wstart[:NB], item, "right") - 1)
        b, t = divmod(bin_, T)
        y_org, x_org = t // TX * TILE, t % TX * TILE
        c = item - wstart[bin_]
        length = -(-totals[bin_] // k[bin_])
        e0 = start[bin_] + c * length
        e1 = min(start[bin_] + totals[bin_], e0 + length)
        acc = np.zeros((TILE * TILE, C), F32)
        for n in entries[e0:e1]:
            for tap in range(4):
                y, x = divmod(int(idx[b, n, tap]), W)
                if w[b, n, tap] == 0 or not (0 <= y - y_org < TILE and 0 <= x - x_org < TILE):
                    continue
                lp = (y - y_org) * TILE + (x - x_org)
                acc[lp] = acc[lp] + w[b, n, tap] * g[b, n]
                adds.append((b, y * W + x, int(n), tap))
        partial.setdefault(bin_, []).append(acc)
    for bin_, accs in partial.items():
        b, t = divmod(bin_, T)
        y_org, x_org = t // TX * TILE, t % TX * TILE
        total = accs[0]
        for a in accs[1:]:
            total = total + a
        for lp in range(TILE * TILE):
            y, x = y_org + lp // TILE, x_org + lp % TILE
            if y < H and x < W:
                dfeat[b, y * W + x] = total[lp]
    return dfeat.reshape(B, H, W, C), adds


def _edge_coords(rng, B, N, H, W):
    """Uniform points over and beyond the map, then points on tile edges
    (a pixel coordinate of 7, 7.5, 8, 15.5), on the border and its corners."""
    grid = rng.uniform(-1.2, 1.2, size=(B, N, 2)).astype(F32)
    to_grid = lambda u, S: F32(u / (S - 1) * 2 - 1)
    special = [(7.0, 3.0), (7.5, 3.2), (8.0, 7.5), (7.5, 7.5), (15.5, 8.0), (0.0, 5.0),
               (W - 1, 4.0), (3.0, H - 1), (W - 1, H - 1), (0.0, 0.0), (W - 1.5, H - 1.5)]
    for i, (u, v) in enumerate(special):
        grid[:, i] = [to_grid(u, W), to_grid(v, H)]
    return grid


def _skewed_coords(rng, B, N, H, W):
    """Every point inside one tile's interior (pixels 8..15 of a 16 x 16
    map): one bin longer than CHUNK_MIN, split into chunks."""
    u = rng.uniform(8.05, 14.95, size=(B, N, 2)).astype(F32)
    return np.stack([u[..., 0] / (W - 1) * 2 - 1, u[..., 1] / (H - 1) * 2 - 1], -1).astype(F32)


CASES = {"edges": (_edge_coords, dict(B=2, H=20, W=28, C=16, N=700)),
         "skewed": (_skewed_coords, dict(B=1, H=16, W=16, C=8, N=CHUNK_MIN + 500)),
         "ragged": (_edge_coords, dict(B=3, H=9, W=13, C=8, N=SEG + 37)),
         # past the 1,024 tiles a view that a first sort held: 33 x 33 tiles
         "past_1024_tiles": (_edge_coords, dict(B=2, H=264, W=260, C=8, N=SEG + 300))}


def _case(name, seed=0):
    make, s = CASES[name]
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(s["B"], s["H"], s["W"], s["C"])).astype(F32)
    grid = make(rng, s["B"], s["N"], s["H"], s["W"])
    g = rng.normal(size=(s["B"], s["N"], s["C"])).astype(F32)
    return feats, grid, g


@pytest.mark.parametrize("name", list(CASES))
def test_every_point_tap_is_added_once_in_point_order(name):
    feats, grid, g = _case(name)
    B, H, W, C = feats.shape
    idx, w = _taps(grid, H, W)
    sort = _sort(idx, H, W)
    entries, totals, (start, k, wstart, pslot), (TX, T) = sort
    # each bin lists its points once each, in ascending order
    for bin_ in range(B * T):
        listed = entries[start[bin_]:start[bin_] + totals[bin_]]
        assert (np.diff(listed) > 0).all()
    _, adds = _accumulate(idx, w, g, H, W, sort)
    seen = {}
    for b, px, n, tap in adds:
        assert idx[b, n, tap] == px
        seen[(b, n, tap)] = seen.get((b, n, tap), 0) + 1
        seen.setdefault(("order", b, px), []).append(n)
    live = {(b, n, tap) for b, n, tap in zip(*np.nonzero(w != 0))}
    assert {key for key in seen if key[0] != "order"} == live
    assert all(v == 1 for key, v in seen.items() if key[0] != "order")
    for key, pts in seen.items():
        if key[0] == "order":
            assert pts == sorted(pts), f"pixel {key[1:]} summed out of point order"
    if name == "edges":  # the points on tile edges are listed in both tiles
        assert (totals.sum() > B * grid.shape[1]) and (wstart[-1] == B * T)
    if name == "skewed":  # one bin, split; the reduce adds its partials in order
        assert totals.max() == grid.shape[1] * B and k.max() >= 2


def test_the_split_stays_within_the_partial_budget():
    rng = np.random.default_rng(3)
    for totals in (rng.integers(0, 3 * CHUNK_MIN, size=40),  # budget not reached
                   rng.integers(CHUNK_MIN + 1, 4 * CHUNK_MIN, size=300),  # cut pro rata
                   [0] * 63 + [50 * CHUNK_MIN * PARTIAL]):  # one huge bin
        totals = np.asarray(totals)
        start, k, wstart, pslot = _plan(totals)
        d = np.where(totals > CHUNK_MIN, -(-totals // CHUNK_MIN), 1)
        assert (k >= 1).all() and (k <= d).all()
        assert k[k > 1].sum() <= PARTIAL
        assert wstart[-1] <= len(totals) + PARTIAL  # the accumulate grid's bound
        if d[d > 1].sum() <= PARTIAL:  # no bin's chunk is longer than CHUNK_MIN
            assert (-(-totals // k) <= CHUNK_MIN).all()
        # split bins get partial slots of their own, within the budget
        slots = [s for p, kk in zip(pslot, k) if kk > 1 for s in range(p, p + kk)]
        assert len(slots) == len(set(slots)) and all(s < PARTIAL for s in slots)
        # the chunks of a bin cover its entries once
        for n, kk in zip(totals, k):
            length = -(-n // kk)
            covered = [min(n, c * length + length) - min(n, c * length) for c in range(kk)]
            assert sum(covered) == n


def test_workspace_holds_the_layout():
    B, H, W, C, N = 3, 20, 28, 16, 700
    ints, floats = K1.bin_workspace(B, H, W, C, N)
    T = -(-H // TILE) * -(-W // TILE)
    nseg = -(-N // SEG)
    # hist, totals, plan (start, chunks, wstart + 1, pslot), 4 entries a point
    assert ints == B * T * nseg + B * T + 4 * B * T + 1 + 4 * B * N
    assert floats == PARTIAL * TILE * TILE * C


@pytest.mark.parametrize("name", list(CASES))
def test_binned_dfeat_matches_pallas_vjp(name):
    feats, grid, g = _case(name, seed=1)
    B, H, W, C = feats.shape
    _, vjp = jax.vjp(lambda f, c: gather_bilinear_windowed(f, c, True), jnp.asarray(feats),
                     jnp.asarray(grid))
    want, _ = vjp(jnp.asarray(g))
    idx, w = _taps(grid, H, W)
    got, _ = _accumulate(idx, w, g, H, W, _sort(idx, H, W))
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("seed,shape", [(0, dict()), (2, dict(B=3, H=20, W=12, C=16, N=500))])
def test_binned_dfeat_matches_pallas_projected_vjp(seed, shape):
    feats, poses, focal, c, scale, img, pts, g = _proj_case(seed, **shape)
    B, H, W, C = feats.shape
    jproj = jax_pack_projection(*(jnp.asarray(a) for a in (poses, focal, c, scale, img)))
    _, vjp = jax.vjp(lambda f, p: pallas_projected(f, p, jproj, True), jnp.asarray(feats),
                     jnp.asarray(pts))
    want, _ = vjp(jnp.asarray(g))
    proj = pack_projection(*(torch.from_numpy(np.asarray(a))
                             for a in (poses, focal, c, scale, img)))
    # the kernels' projection (project_point), as the port's plain version
    grid = project_packed(proj, torch.from_numpy(pts)).numpy()
    idx, w = _taps(grid, H, W)
    got, _ = _accumulate(idx, w, g, H, W, _sort(idx, H, W))
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
