"""K2's float32 forward launch (``ops/kernels/resnetfc.py f32_forward_plan``)
against its kernel (``csrc/resnetfc.cu resnetfc_fwd_f32_kernel``).

The kernel's constants are read from the source.  For every ``d_hidden``
from 64 to 512 (step 64), ``d_latent`` from 64 to 1,024, NS 1 to 4 and the
shipped decoder's 64 encoded lanes: the ring, the A tile and the barriers
lie in order, every bulk copy's destination 16-byte aligned, and the block
fits 227 KB; the CTAs take every point once and their threads every
(point, column) of a product once, a warp's shared reads free of bank
conflicts; the slabs that the warps' cursor issues (``f32_issue``, mirrored)
are the products' in order, and the stash slots of their A operands are
every slot of ``stash_slots`` once, as ``stash_slot`` places them.
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


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+)", SRC).group(1))


def _layout(dh):
    """Byte offsets of the kernel's dynamic shared memory (its order)."""
    stage = 4 * (K2.F32_FWD_SLAB * dh + K2.F32_FWD_TILE * (K2.F32_FWD_SLAB + 4))
    a_tile = K2.F32_FWD_STAGES * stage
    bars = a_tile + 4 * K2.F32_FWD_TILE * (dh + 4)
    return stage, a_tile, bars, bars + 16 * K2.F32_FWD_STAGES


def test_constants_are_the_kernels():
    assert (K2.F32_FWD_TILE, K2.F32_FWD_SLAB, K2.F32_FWD_STAGES) == (
        _const("F32_TM"), _const("F32_KS"), _const("F32_STAGES"))
    assert "F32_ZLD = F32_KS + 4;" in SRC
    # the launch bound holds the widest CTA: 256 threads, eight warps
    assert "__launch_bounds__(256, 1)\nresnetfc_fwd_f32_kernel" in SRC
    assert "<<<blocks, d_hidden / 2, smem" in SRC
    assert K2.f32_forward_plan(1, 1, 512, 64, 64, 5, 3).threads == 256


@pytest.mark.parametrize("dh", WIDTHS)
def test_shared_memory_fits_every_shape(dh):
    stage, a_tile, bars, end = _layout(dh)
    assert stage % 16 == 0 and a_tile % 16 == 0 and bars % 8 == 0
    # a stage's latent rows follow its weight slab, each row 16-byte aligned
    assert (4 * K2.F32_FWD_SLAB * dh) % 16 == 0 and (4 * (K2.F32_FWD_SLAB + 4)) % 16 == 0
    for dl in LATENTS:
        for ns in range(1, 5):
            plan = K2.f32_forward_plan(4_096 + 37, ns, dh, dl, K_IN, 5, 3)
            assert plan.smem == end <= SMEM_LIMIT
            assert plan.cluster == 1 and plan.threads == dh // 2


@pytest.mark.parametrize("n", [1, 31, 32, 33, 4_096, 4_096 + 37, 81_920])
def test_the_grid_takes_every_point_once(n):
    plan = K2.f32_forward_plan(n, 1, 512, 512, K_IN, 5, 3)
    owner = [0] * n
    for b in range(plan.blocks):
        for r in range(plan.tile):
            if b * plan.tile + r < n:
                owner[b * plan.tile + r] += 1
    assert owner == [1] * n and (plan.blocks - 1) * plan.tile < n


@pytest.mark.parametrize("dh", WIDTHS)
def test_threads_own_every_output_once(dh):
    """Thread t of warp w < dh / 64: points tp + 4 i (tp = lane / 8), columns
    4 tc + {0..3} and dh / 2 + 4 tc + {0..3} (tc = 8 w + lane % 8)."""
    seen = {}
    for tid in range(dh // 2):
        lane, warp = tid % 32, tid // 32
        tp, tc = lane // 8, warp * 8 + lane % 8
        for i in range(8):
            for c in [4 * tc + q for q in range(4)] + [dh // 2 + 4 * tc + q for q in range(4)]:
                seen[(tp + 4 * i, c)] = seen.get((tp + 4 * i, c), 0) + 1
    assert seen == {(p, c): 1 for p in range(K2.F32_FWD_TILE) for c in range(dh)}


@pytest.mark.parametrize("dh", WIDTHS)
def test_shared_reads_hit_distinct_banks(dh):
    """Per 16-byte load of a warp: the A tile's and the latent rows' 4 point
    rows (tp = 0..3 at one i and k) in 4 distinct bank groups; the weight
    slab's 8 column groups of a quarter warp in 8."""
    for ld in (dh + 4, K2.F32_FWD_SLAB + 4):
        for i in range(8):
            for k4 in range(0, K2.F32_FWD_SLAB, 4):
                groups = {((tp + 4 * i) * ld + k4) // 4 % 8 for tp in range(4)}
                assert len(groups) == 4, (ld, i, k4)
    for base in (0, dh // 2):  # a quarter warp: one tp, tc % 8 = 0..7
        assert len({(base + 4 * lc) // 4 % 8 for lc in range(8)}) == 8


def _issued(ns, n_blocks, n_lin_z, k_in, dl, dh):
    """The slabs the warps' cursor issues (csrc/resnetfc.cu f32_slabs and
    f32_issue, mirrored): (weight, block, view) a slab, the pooled blocks'
    view 0."""
    total = (ns * (k_in + n_lin_z * (dl + 2 * dh)) + (n_blocks - n_lin_z) * 2 * dh) // 16
    v = k = seg = k0 = 0
    out = []
    for _ in range(total):
        rows = {0: k_in, 1: dl}.get(seg, dh)
        out.append((("wi", "wz", "w0", "w1")[seg], None if seg == 0 else k,
                    v if k < n_lin_z else 0))
        k0 += 16
        if k0 < rows:
            continue
        k0 = 0
        if seg == 0:
            seg = 1
        elif seg < 3:
            seg += 1
        else:
            k += 1
            if k < n_lin_z:
                seg = 1
            elif k == n_lin_z and v + 1 < ns:
                v, k, seg = v + 1, 0, 0
            else:
                seg = 2
    return out


@pytest.mark.parametrize("ns", [1, 2, 3, 4])
@pytest.mark.parametrize("n_blocks,n_lin_z", [(5, 3), (5, 5), (3, 1)])
def test_products_stream_every_slab_and_stash_slot(ns, n_blocks, n_lin_z):
    dh, dl = 512, 1_024
    plan = K2.f32_forward_plan(1_000, ns, dh, dl, K_IN, n_blocks, n_lin_z)
    consumed = [p[:3] for p in plan.products for _ in range(p[3])]
    assert consumed == _issued(ns, n_blocks, n_lin_z, K_IN, dl, dh)
    assert plan.slabs == len(consumed)
    written = [p[4] for p in plan.products if p[4] is not None]
    assert sorted(written) == list(range(K2.stash_slots(ns, n_blocks, n_lin_z)))
    for name, k, v, _, slot in plan.products:
        if name in ("w0", "w1"):
            assert slot == K2.stash_slot(k, int(name[1]), v, ns, n_lin_z)
