"""K4's forward launch and walk (``csrc/integrate.cu volume_integral_kernel``),
mirrored in numpy: its warps' rays, their staging (``stage_rows``) and their
lanes' doubling (``shift_up``, ``doubling_step``): four lanes a ray,
eight rays a warp.

The kernel's constants are read from the source.  For ray counts 0, 1, 3,
17, 1,000, 4,096 (a served chunk) and 16,384 (the train step's band) the
CTAs' warps take every ray once, eight a warp; for every sample count ``n`` from 1 to 64
each group's staging copies every field row of a warp's rays exactly once
into a slot of its own, and every z the group reads (its samples and the
next group's first), and every read of a lane's slots, those past the
group's end included, stays inside its ray's shared row; a warp's z reads
hit 32 distinct banks and a quarter warp's field rows 8 distinct 16-byte
bank groups; and the exclusive transmittance product over a ray's lanes
(sample p on lane p % LANES, slot p / LANES) equals the TPU kernel's
doubling (``avr_tpu/ops/pallas/integrate.py``: its steps and its
association) bit for bit, for every group size 1 to 32.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from avr_tpu.ops.pallas.integrate import _shift_steps
from avr_tpu_torch.ops.kernels import integrate as K4

SRC = (pathlib.Path(__file__).resolve().parents[1] / "avr_tpu_torch" / "csrc"
       / "integrate.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


GROUP, WARPS, LANES = _const("FWD_GROUP"), _const("FWD_WARPS"), _const("FWD_LANES")
PITCH = GROUP + LANES  # FWD_PITCH


def test_constants():
    assert (GROUP, WARPS, LANES) == (32, 4, 4)
    assert "FWD_PITCH = FWD_GROUP + FWD_LANES;" in SRC


@pytest.mark.parametrize("rays", (0, 1, 3, 17, 1_000, 4_096, 16_384))
def test_warps_take_every_ray_once(rays):
    """``avr_volume_integral`` launches ceil(rays / (4 warps x 8 rays))
    CTAs; warp w of CTA b takes the next 8 rays (those below ``rays``), or
    leaves."""
    lanes = LANES
    warp_rays = 32 // lanes
    cta = WARPS * warp_rays
    owner = np.zeros(rays, int)
    for b in range(-(-rays // cta)):
        for w in range(WARPS):
            ray0 = (b * WARPS + w) * warp_rays
            if ray0 >= rays:
                continue
            owner[ray0:ray0 + min(warp_rays, rays - ray0)] += 1
    assert (owner == 1).all()
    if rays == 4_096:  # a served chunk: 128 CTAs, one an SM
        assert -(-rays // cta) == 128


def _stage(nr, m, pitch):
    """``stage_rows``' walk over one warp: each lane's (i, k) pairs, stepped
    as the kernel steps them (one division, then adds), as (i, k, slot)."""
    di, dk = 32 // m, 32 % m
    out = []
    for lane in range(32):
        i, k = lane // m, lane % m
        for e in range(lane, nr * m, 32):
            assert (i, k) == divmod(e, m)
            out.append((i, k, i * pitch + k))
            k += dk
            i += di
            if k >= m:
                k -= m
                i += 1
    return out


@pytest.mark.parametrize("n", range(1, 65))
def test_staging_copies_every_row_once_and_reads_stay_inside(n):
    lanes, P = LANES, PITCH
    L = -(-min(n, GROUP) // lanes)
    for nr in range(1, 32 // lanes + 1):
        seen = np.zeros(nr * n, int)
        for k0 in range(0, n, GROUP):
            m = min(GROUP, n - k0)
            fo = _stage(nr, m, P)
            z = _stage(nr, min(GROUP + 1, n - k0), P)
            for i, k, _ in fo:
                seen[i * n + k0 + k] += 1
            for pairs in (fo, z):
                slots = [s for _, _, s in pairs]
                assert len(set(slots)) == len(slots) and max(slots) < (32 // lanes) * P
            # the z a ray's samples read: theirs and, but at the band's end, the next one's
            assert {(i, k) for i, k, _ in z} == {
                (i, k) for i in range(nr) for k in range(min(n - k0, m + 1))}
            # a lane's reads, every slot (past the group's end too): fr[k], zr[k], zr[k + 1]
            assert lanes * L < P  # k + 1 at the largest slot
        assert (seen == 1).all()


def test_reads_hit_distinct_banks():
    """Lane t of a warp is lane t % 4 of ray t / 4 and reads sample 4 l +
    its lane of its ray's row (pitch 36): z in 32 banks, the 16-byte field
    rows of each quarter warp in 8 bank groups."""
    lanes, P = LANES, PITCH
    for l in range(GROUP // lanes):
        words = [(t // lanes) * P + lanes * l + t % lanes for t in range(32)]
        assert len({w % 32 for w in words}) == 32
        for q in range(0, 32, 8):
            assert len({w % 8 for w in words[q:q + 8]}) == 8


def _lanes_doubling(q, m, lanes):
    """The kernel's exclusive product over a ray's lanes: ``shift_up`` by 1
    (fill 1), then steps 1, 2, 4, 8, 16 while below m - 1: across the lanes
    below LANES, slots back from there; slot l of lane j is position LANES l
    + j."""
    f32 = np.float32
    L = -(-m // lanes)
    qq = np.concatenate([q, np.ones(lanes * L - m, f32)])  # slots past m: any value
    val = lambda a, p: a[p] if p >= 0 else f32(1.0)
    flat = lambda t: np.array([t[p % lanes][p // lanes] for p in range(lanes * L)], f32)
    t = [[val(qq, lanes * l + j - 1) for l in range(L)] for j in range(lanes)]
    for st in (1, 2, 4, 8, 16):
        if not st < m - 1:
            continue
        if st < lanes:
            old = flat(t)
            t = [[f32(t[j][l] * val(old, lanes * l + j - st)) for l in range(L)]
                 for j in range(lanes)]
        else:
            s = st // lanes
            t = [[f32(t[j][l] * t[j][l - s]) if l >= s else t[j][l] for l in range(L)]
                 for j in range(lanes)]
    return flat(t)[:m]


@pytest.mark.parametrize("m", range(1, 33))
def test_lanes_doubling_is_the_tpu_kernels_bit_for_bit(m):
    rng = np.random.default_rng(m)
    q = rng.uniform(1e-10, 1.0, m).astype(np.float32)
    # the TPU kernel's: t_k = q_{k-1} (1 at 0), then t *= (t shifted by s, 1 below s)
    want = np.concatenate([[np.float32(1.0)], q[:-1]]).astype(np.float32)
    for s in _shift_steps(m):
        want = (want * np.concatenate([np.ones(s, np.float32), want[:-s]])[:m]).astype(
            np.float32)
    assert list(_shift_steps(m)) == [s for s in (1, 2, 4, 8, 16) if s < m - 1]
    np.testing.assert_array_equal(_lanes_doubling(q, m, LANES), want)


def test_zero_rays_pass_the_shape_check():
    """No ray and any n: the wrapper's checks pass to the device check (on
    the card the wrapper then launches nothing)."""
    with pytest.raises(ValueError, match="CUDA"):
        K4._check(torch.zeros(1, 0, 20), torch.zeros(1, 0, 4))
