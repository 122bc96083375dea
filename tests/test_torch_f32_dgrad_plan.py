"""K2's float32 dgrad launch (``ops/kernels/resnetfc.py f32_dgrad_plan``)
against its kernel (``csrc/resnetfc.cu resnetfc_dgrad_f32_kernel``).

The kernel's constants are read from the source.  For every ``d_hidden``
from 64 to 512 (step 64), ``d_latent`` from 64 to 1,024, NS 1 to 4 and the
shipped decoder's 64 encoded lanes: the ring of weight slabs, the A tile,
lin_in's output chunk, g_epi and the barriers lie in order, every bulk
copy's destination 16-byte aligned, and the block fits 227 KB; the CTAs
take every point once and their threads every (point, column) of each
product once (``dg_role`` mirrored: d_hidden-, latent- and lin_in-wide
products at their points a thread), so a block product's mask reads are
every value of its tile's stash rows once; the plan's products, in the
order the kernel's ``dg_product`` lines fix (read from the source), are
the reverse chain's, each weight's rows and columns streamed once per view
in consecutive column chunks; the masks read are every stash slot once and
the cotangents written every cotangent slot once.
"""

import pathlib
import re

import pytest

from avr_tpu_torch.ops.kernels import resnetfc as K2

SRC = (pathlib.Path(K2.__file__).resolve().parents[2] / "csrc" / "resnetfc.cu").read_text()
SHIPPED = K2.CodeSpec(num_freqs=6, freq_factor=1.5, include_input=True, d_coded=3, d_pass=3)
K_IN = K2.d_enc_padded(SHIPPED.d_enc)
SMEM_LIMIT = 232_448  # bytes of shared memory a Hopper block can use (227 KB)
WIDTHS = list(range(64, 513, 64))
LATENTS = list(range(64, 1025, 64))
TILE, SLAB, STAGES = K2.F32_FWD_TILE, K2.F32_FWD_SLAB, K2.F32_FWD_STAGES


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+)", SRC).group(1))


def _layout(dh):
    """Byte offsets of the kernel's dynamic shared memory (its order): a
    stage's size, the A tile, lin_in's chunk, g_epi, the barriers, the end."""
    stage = 4 * SLAB * dh
    a_tile = STAGES * stage
    es = a_tile + 4 * TILE * (dh + 4)
    gs = es + 4 * TILE * (K2.F32_DGRAD_IN_W + 4)
    bars = gs + 4 * TILE * K2.GOUT_W
    return stage, a_tile, es, gs, bars, bars + 16 * STAGES


def _role(tid, cols, points):
    """``dg_role<P>``: (points, columns, has outputs) of thread ``tid``."""
    wr, lane, warp = 8 // points, tid % 32, tid // 32
    tc = 8 * (warp // wr) + lane % 8
    tp = lane // 8 + 4 * (warp % wr)
    pts = [tp + (32 // points) * i for i in range(points)]
    cs = [4 * tc + q for q in range(4)] + [cols // 2 + 4 * tc + q for q in range(4)]
    return pts, cs, warp < wr * (cols // 64)


def test_constants_are_the_kernels():
    assert (TILE, SLAB, STAGES, K2.F32_DGRAD_IN_W) == (
        _const("F32_TM"), _const("F32_KS"), _const("F32_STAGES"), _const("F32_IN_W"))
    assert "F32_ELD = F32_IN_W + 4;" in SRC
    assert "inline int dg_stage_floats(int dh) { return F32_KS * dh; }" in SRC
    assert "while (p < 8 && p * dh < 8 * cw) p *= 2;" in SRC  # dg_mode
    assert "__launch_bounds__(256, 1)\nresnetfc_dgrad_f32_kernel" in SRC
    assert "resnetfc_dgrad_f32_kernel<<<blocks, d_hidden / 2, smem" in SRC
    # the first port's dgrad and its helpers are gone
    for dead in ("resnetfc_dgrad_kernel", "res_block_bwd", "dgrad_smem_bytes",
                 "resnetfc_dgrad_tile", "store_frag", "gemm_tile(const float*"):
        assert dead not in SRC
    assert K2.dgrad_tile(K2.torch.float32) == TILE
    assert K2.f32_dgrad_plan(1, 1, 512, 512, K_IN, 5, 3).threads == 256


@pytest.mark.parametrize("dh", WIDTHS)
def test_shared_memory_fits_every_shape(dh):
    stage, a_tile, es, gs, bars, end = _layout(dh)
    assert stage % 16 == 0 and a_tile % 16 == 0 and es % 16 == 0 and gs % 16 == 0
    assert bars % 8 == 0
    # a stage: F32_KS weight rows of at most d_hidden columns (a column
    # chunk's rows cols apart, each 16-byte aligned)
    for cols in range(64, dh + 1, 64):
        assert (4 * cols) % 16 == 0 and 4 * SLAB * cols <= stage
    for dl in LATENTS:
        for ns in range(1, 5):
            plan = K2.f32_dgrad_plan(4_096 + 37, ns, dh, dl, K_IN, 5, 3)
            assert plan.smem == end <= SMEM_LIMIT
            assert plan.threads == dh // 2 and plan.tile == TILE


@pytest.mark.parametrize("n", [1, 31, 32, 33, 4_096, 4_096 + 37, 327_680])
def test_the_grid_takes_every_point_once(n):
    plan = K2.f32_dgrad_plan(n, 1, 512, 512, K_IN, 5, 3)
    owner = [0] * n
    for b in range(plan.blocks):
        for r in range(plan.tile):
            if b * plan.tile + r < n:
                owner[b * plan.tile + r] += 1
    assert owner == [1] * n and (plan.blocks - 1) * plan.tile < n


@pytest.mark.parametrize("dh", WIDTHS)
def test_threads_own_every_output_of_each_product_once(dh):
    """Each product width the kernel meets: d_hidden (the blocks), the
    latent chunks of every d_latent, lin_in's chunk."""
    widths = {(dh, 8), (K2.F32_DGRAD_IN_W, K2.f32_dgrad_mode(K2.F32_DGRAD_IN_W, dh))}
    for dl in LATENTS:
        plan = K2.f32_dgrad_plan(100, 1, dh, dl, K_IN, 5, 3)
        widths |= {(p[4], p[5]) for p in plan.products if p[0] == "wz"}
    for cols, points in widths:
        assert points in (1, 2, 4, 8) and cols % 64 == 0 and cols <= dh
        seen = {}
        for tid in range(dh // 2):
            pts, cs, on = _role(tid, cols, points)
            if not on:
                continue
            for p in pts:
                for c in cs:
                    seen[(p, c)] = seen.get((p, c), 0) + 1
        assert seen == {(p, c): 1 for p in range(TILE) for c in range(cols)}, (cols, points)
        if cols == dh:  # the blocks' products: the forward's layout, every thread
            assert points == 8


@pytest.mark.parametrize("dh", WIDTHS)
def test_shared_reads_hit_distinct_banks(dh):
    """Per 16-byte load of a warp: the A tile's and lin_in chunk's rows at
    4 distinct bank groups; a slab row's 8 column groups of a quarter warp
    in 8 (128 contiguous bytes)."""
    for ld in (dh + 4, K2.F32_DGRAD_IN_W + 4):
        for points in (1, 2, 4, 8):
            for warp_tp0 in range(0, 32 // points, 4):
                for k4 in range(0, SLAB, 4):
                    groups = {((warp_tp0 + lt) * ld + k4) // 4 % 8 for lt in range(4)}
                    assert len(groups) == 4
    for lane0 in range(0, 32, 8):
        assert len({(4 * (lane % 8)) // 4 % 8 for lane in range(lane0, lane0 + 8)}) == 8


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1_037])
@pytest.mark.parametrize("dh", [64, 192, 512])
def test_mask_prefetch_covers_the_tile_rows(n, dh):
    """A block product's first slab prefetches its stash slot's rows of the
    tile below N (dg_issue: min(32, N - r0) rows of dh floats, contiguous,
    16-byte multiples); the mask reads (dg_mask) of every thread fall inside
    them."""
    for r0 in range(0, n, TILE):
        rows = min(TILE, n - r0)
        nbytes = rows * dh * 4
        assert nbytes % 16 == 0 and 0 < nbytes
        for tid in range(dh // 2):
            pts, cs, _ = _role(tid, dh, 8)
            for p in pts:
                if r0 + p < n:
                    assert all(0 <= (p * dh + c) * 4 < nbytes for c in cs)
    assert "min(F32_TM, a.N - p.r0) * dh * 4" in SRC


# csrc/resnetfc.cu dg_products and dg_product, the lines that fix the
# kernel's product order: the count; the pooled blocks first, W1 then W0, k
# descending; then the views in order, each k descending with block k's W1,
# W0 and injection k's latent chunks, then lin_in's chunks
ORDER_LINES = (
    "return 2 * (a.n_blocks - a.n_lin_z) +\n"
    "         a.ns * (a.n_lin_z * (2 + dg_latent_chunks(a)) + a.k_in / F32_IN_W);",
    "return (a.d_latent + a.d_hidden - 1) / a.d_hidden;",
    "const int per_block = 2 + dg_latent_chunks(a), per_view = nlz * per_block + a.k_in / F32_IN_W;",
    "q.kind = p & 1 ? DG_W0 : DG_W1;\n    q.k = a.n_blocks - 1 - p / 2;",
    "q.v = p / per_view;",
    "if (r < nlz * per_block) {\n    const int t = r % per_block;\n"
    "    q.k = nlz - 1 - r / per_block;\n    q.kind = t == 0 ? DG_W1 : t == 1 ? DG_W0 : DG_WZ;",
    "q.cb = t < 2 ? 0 : (t - 2) * dh;\n    q.cw = t < 2 ? dh : min(dh, a.d_latent - q.cb);",
    "q.kind = DG_WI;\n    q.k = 0;\n    q.cb = (r - nlz * per_block) * F32_IN_W;\n"
    "    q.cw = F32_IN_W;",
)


def test_the_kernels_product_order_is_the_plans_statement():
    for line in ORDER_LINES:
        assert line in SRC, line


@pytest.mark.parametrize("ns", [1, 2, 3, 4])
@pytest.mark.parametrize("n_blocks,n_lin_z", [(5, 3), (5, 5), (3, 1)])
@pytest.mark.parametrize("dh,dl,k_in", [(512, 512, 64), (512, 1_024, 128), (64, 64, 64),
                                        (192, 576, 576)])
def test_products_stream_the_reverse_chain(ns, n_blocks, n_lin_z, dh, dl, k_in):
    plan = K2.f32_dgrad_plan(1_000, ns, dh, dl, k_in, n_blocks, n_lin_z)
    streamed = [p for p in plan.products if p[6]]
    # dg_products' count (ORDER_LINES)
    assert len(streamed) == 2 * (n_blocks - n_lin_z) + ns * (n_lin_z * (2 + -(-dl // dh))
                                                             + k_in // K2.F32_DGRAD_IN_W)
    assert all(p[6] == dh // SLAB for p in streamed)
    # a product's column chunks follow one another: the first at column 0,
    # each the next one's start, d_hidden wide (a latent chunk) or
    # F32_DGRAD_IN_W (lin_in's), the last ending at the weight's width
    widths = dict(w1=dh, w0=dh, wz=dl, wi=k_in)
    for a, b in zip(streamed, streamed[1:] + [None]):
        chunk = dh if a[0] != "wi" else K2.F32_DGRAD_IN_W
        if b is not None and b[:3] == a[:3]:
            assert a[4] == chunk and b[3] == a[3] + a[4]
        else:
            assert a[3] + a[4] == widths[a[0]] and a[4] <= chunk
    assert plan.slabs == len(streamed) * (dh // SLAB)
    # each weight's rows and columns once per view (the pooled blocks once)
    cover = {}
    for name, k, v, cb, cw, *_ in streamed:
        for c in range(cb, cb + cw):
            cover[(name, k, v, c)] = cover.get((name, k, v, c), 0) + 1
    want = {}
    views = lambda k: range(ns) if k < n_lin_z else [0]
    for k in range(n_blocks):
        for v in views(k):
            for name in ("w1", "w0"):
                want.update({(name, k, v, c): 1 for c in range(dh)})
    for v in range(ns):
        want.update({("wz", k, v, c): 1 for k in range(n_lin_z) for c in range(dl)})
        want.update({("wi", None, v, c): 1 for c in range(k_in)})
    assert cover == want
    # the reverse chain: k descending, a block's W1 before its W0, a view's
    # injection after its block, lin_in last in the view
    order = [(p[0], p[1], p[2]) for p in streamed if p[3] == 0]
    pooled = [(n, k, 0) for k in range(n_blocks - 1, n_lin_z - 1, -1) for n in ("w1", "w0")]
    per_view = lambda v: [(n, k, v) for k in range(n_lin_z - 1, -1, -1)
                          for n in ("w1", "w0", "wz")] + [("wi", None, v)]
    assert order == pooled + [x for v in range(ns) for x in per_view(v)]


@pytest.mark.parametrize("ns", [1, 2, 3, 4])
@pytest.mark.parametrize("n_blocks,n_lin_z", [(5, 3), (5, 5), (3, 1)])
def test_masks_and_cotangents_every_slot_once(ns, n_blocks, n_lin_z):
    plan = K2.f32_dgrad_plan(1_000, ns, 512, 1_024, K_IN, n_blocks, n_lin_z)
    masks = [p[7] for p in plan.products if p[7] is not None]
    assert sorted(masks) == list(range(K2.stash_slots(ns, n_blocks, n_lin_z)))
    cots = [p[8] for p in plan.products if p[8] is not None]
    assert sorted(cots) == list(range(K2.cot_slots(ns, n_blocks, n_lin_z)))
    for name, k, v, cb, _, _, _, mask, cot in plan.products:
        if name == "w1":
            assert mask == K2.stash_slot(k, 1, v, ns, n_lin_z)
        elif name == "w0":
            assert mask == cot == K2.stash_slot(k, 0, v, ns, n_lin_z)
        elif name == "wz" and cb == 0:  # G_k: block k - 1's cot1, or lin_in's output cotangent
            assert cot == (K2.stash_slot(k - 1, 1, v, ns, n_lin_z) if k else
                           K2.cot_slots(ns, n_blocks, n_lin_z) - ns + v)
