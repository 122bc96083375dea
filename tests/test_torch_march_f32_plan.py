"""K3's float32 kernels (``csrc/march.cu lstm_march_f32_tile_kernel`` and
``lstm_march_f32_walk_kernel``): their host plan and lane layouts, mirrored
in Python, with the kernels' constants read from the source.

A warp carries a tile of ``F32_TILE`` rays; ``ops/kernels/march.py
f32_plan`` gives the warps a CTA and the CTAs, CTA ``b``'s warp ``w`` taking
tile ``b * warps + w``.  This file holds, on the CPU:

* every ray, and every ray-step row, taken exactly once, for ray counts 1,
  7, 1,000, 4,096, 16,384 and 16,387 on 132, 114 and 1 SMs, both kernels;
* the walk's lane-owned partial sums (lane ``k``: units ``k`` and ``k +
  32``; at hidden <= 16 lanes ``k`` and ``k + 16``: unit ``k`` of the even
  and the odd rays) each read once by the CTA's reduction from the lane and
  slot that holds it, hidden 1 to 62;
* both kernels' shared memory within 232,448 bytes at the planned warps, for
  hidden 1 to 62 at C 512 (NS 1 and 2) and at the CPU tests' width (C 32);
* the forward's plan filling the card at 4,096 and 16,384 rays: a warp on
  each of an SM's four schedulers, every SM busy, the fewest waves;
* the register tiles: every (ray, column) of a product, every (ray, unit)
  of the walk's gh product, once, and their 16-byte reads in distinct bank
  groups.
"""

import pathlib
import re

import pytest

from avr_tpu_torch.ops.kernels import march as K3

CSRC = pathlib.Path(__file__).resolve().parents[1] / "avr_tpu_torch" / "csrc"
SRC = (CSRC / "march.cu").read_text()
RAYS = (1, 7, 1_000, 4_096, 16_384, 16_387)
SMS = (132, 114, 1)
STEPS = 10


def _const(name):
    m = re.search(rf"constexpr (?:int|size_t) {name} = ([\d\s*]+);", SRC)
    return eval(m.group(1))  # a product of integer literals


def test_constants_match_the_source():
    for name in ("F32_TILE", "F32_BLOCK", "F32_CHUNK", "F32_DOTS", "F32_WARPS_MAX",
                 "WIH_SMEM_MAX", "SMEM_MAX"):
        assert getattr(K3, name) == _const(name), name
    assert _const("F32_OWN_SLOTS") == 11 and _const("MAX_HIDDEN") == K3.MAX_HIDDEN
    taps = re.search(r"struct Taps \{(.*?)\};", (CSRC / "common.cuh").read_text(), re.S).group(1)
    fields = re.findall(r"\b(?:int|float)\s+([\w\s,]+);", taps)
    assert K3.TAPS_BYTES == 4 * sum(len(f.split(",")) for f in fields)
    # the pitch and the launch bound the plan relies on
    assert "inline int f32_pitch(int k) { return (k + 7) / 8 * 8 + 4; }" in SRC
    assert SRC.count("__launch_bounds__(F32_WARPS_MAX * 32, 1)") == 2


@pytest.mark.parametrize("kind", ("forward", "walk"))
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("rays", RAYS)
def test_every_ray_and_row_is_taken_once(rays, sms, kind):
    warps, ctas = K3.f32_plan(kind, rays, sms, 512, 16, 1)
    assert 1 <= warps <= K3.F32_WARPS_MAX
    seen = [0] * rays
    rows = [0] * (rays * STEPS)
    for b in range(ctas):
        for w in range(warps):
            tile0 = (b * warps + w) * K3.F32_TILE
            for r in range(K3.F32_TILE):
                ray = tile0 + r
                if ray < rays:  # lane r < F32_TILE carries ray tile0 + r
                    seen[ray] += 1
                    for t in range(STEPS):
                        rows[ray * STEPS + t] += 1
    assert seen == [1] * rays and rows == [1] * (rays * STEPS)
    # no CTA without a ray
    assert (ctas - 1) * warps * K3.F32_TILE < rays


def _stored(hid):
    """(slot, lane) -> what the walk's lanes store there: dbias of gate k
    and unit u, dw_out of unit u, db_out.  Lane k takes units k and k + 32
    of a ray; at hidden <= 16 the cell takes two rays at a time, lane 16 h +
    k unit k of the pair's ray h, so lanes k and k + 16 both hold unit k."""
    out = {}
    for lane in range(32):
        for uu in range(2):
            u = lane % 16 if hid <= 16 else lane + 32 * uu
            if u < hid and (uu == 0 or hid > 16):
                for k in range(4):
                    out[(2 * k + uu, lane)] = ("dbias", k * hid + u)
                out[(8 + uu, lane)] = ("dw_out", u)
    out[(10, 0)] = ("db_out", 0)
    return out


def _read(o, hid):
    """The CTA reduction's (slot, lane) pairs for output o of 5 hid + 1
    (csrc/march.cu lstm_march_f32_walk_kernel: lane u % 32, and at hidden
    <= 16 also lane u + 16)."""
    if o < 4 * hid:
        u = o % hid
        slot = 2 * (o // hid) + u // 32
    elif o < 5 * hid:
        u = o - 4 * hid
        slot = 8 + u // 32
    else:
        return [(10, 0)]
    return [(slot, u % 32)] + ([(slot, u + 16)] if hid <= 16 else [])


@pytest.mark.parametrize("hid", range(1, 63))
def test_each_partial_is_read_from_the_lanes_that_hold_it(hid):
    stored = _stored(hid)
    read = [key for o in range(5 * hid + 1) for key in _read(o, hid)]
    assert len(set(read)) == len(read) == len(stored)  # every stored slot read once
    for o in range(5 * hid + 1):
        want = ("dbias", o) if o < 4 * hid else ("dw_out", o - 4 * hid) if o < 5 * hid else (
            "db_out", 0)
        for key in _read(o, hid):
            assert stored[key] == want
            assert key[0] < _const("F32_OWN_SLOTS")
    # the slots sit over the warp's gh, c cotangent and rows, which hold them
    up = -(-hid // 16) * 16
    assert _const("F32_OWN_SLOTS") * 32 <= K3.F32_TILE * (K3.f32_pitch(up) + up
                                                          + K3.aux_width(hid))


@pytest.mark.parametrize("hid", range(1, 63))
def test_shared_memory_fits(hid):
    for C in (512, 32):
        for NS in (1, 2):
            for kind in ("forward", "walk"):
                for rays in (4_096, 16_384):
                    warps, _ = K3.f32_plan(kind, rays, 132, C, hid, NS)
                    assert K3.f32_smem(kind, C, hid, NS, warps) <= K3.SMEM_MAX
                # every region a multiple of 16 bytes: the 16-byte reads stay aligned
                assert K3.f32_smem(kind, C, hid, NS, 1) % 16 == 0
                assert (K3.f32_smem(kind, C, hid, NS, 2) - K3.f32_smem(kind, C, hid, NS, 1)) % 16 == 0
    # W_ih (W_ih^T) stays in shared memory at the main path's width, and is
    # read through L2 where it would not fit (hidden 62: 508 KB)
    gp = -(-4 * hid // 64) * 64
    assert (512 * gp * 4 <= K3.WIH_SMEM_MAX) == (hid <= 16)


@pytest.mark.parametrize("sms", (132, 114))
@pytest.mark.parametrize("rays", (4_096, 16_384))
def test_the_forward_plan_fills_the_card(rays, sms):
    warps, ctas = K3.f32_plan("forward", rays, sms, 512, 16, 1)
    tiles = rays // K3.F32_TILE
    assert warps >= 4  # a warp on each of an SM's four schedulers
    # the fewest waves (one CTA an SM: W_ih takes 128 KB), a served chunk in
    # one on the H100 SXM's 132 SMs, and every SM, or nearly, busy in each
    waves = -(-ctas // sms)
    assert waves == -(-tiles // (sms * K3.F32_WARPS_MAX))
    assert waves == 1 or sms != 132 or rays > 4_096
    assert ctas >= 0.9 * sms * waves
    assert ctas * warps >= tiles


@pytest.mark.parametrize("nb", (1, 2, 3, 4))
def test_a_product_covers_every_ray_and_column_once(nb):
    """f32_tile_fma: lane (rg = lane & 1, cg = lane >> 1) holds rays rg + 2 i
    and columns 64 b + 4 cg + j."""
    got = []
    for lane in range(32):
        rg, cg = lane & 1, lane >> 1
        got += [(rg + 2 * i, 64 * b + 4 * cg + j) for b in range(nb) for i in range(4)
                for j in range(4)]
    assert sorted(got) == [(r, c) for r in range(K3.F32_TILE) for c in range(64 * nb)]


@pytest.mark.parametrize("nu", (1, 2, 3, 4))
def test_the_gh_product_covers_every_ray_and_unit_once(nu):
    """The walk's gh: lane (ray lane & 7, units 16 n + 4 (lane >> 3) + j)."""
    got = [(lane & 7, 16 * n + 4 * (lane >> 3) + j) for lane in range(32) for n in range(nu)
           for j in range(4)]
    assert sorted(got) == [(r, u) for r in range(K3.F32_TILE) for u in range(16 * nu)]


def test_the_tiles_read_in_distinct_bank_groups():
    """A 16-byte read of a product's two ray groups (rows r and r + 1) and of
    the gh product's eight rays (rows 0..7) hit distinct groups of 4 banks."""
    for k in list(range(1, 257)) + [K3.F32_CHUNK]:
        ld = K3.f32_pitch(k)
        assert ld % 4 == 0 and ld >= -(-k // 4) * 4
        assert len({(r * ld // 4) % 8 for r in (0, 1)}) == 2
        assert len({(r * ld // 4) % 8 for r in range(8)}) == 8
