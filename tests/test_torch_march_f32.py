"""K3's float32 backward walk (``csrc/march.cu lstm_march_bwd_kernel``):
its host plan and its lane-owned partial sums, mirrored in Python.

The walk is persistent, at most one CTA an SM (``ops/kernels/march.py
walk_ctas_f32``), warp ``w`` of CTA ``b`` taking rays ``b * 8 + w``, then
every ``ctas * 8`` on: every ray once, for ray counts 1, 7, 4,096, 16,384
and ones off the CTA's 8 rays, on 132 SMs and on fewer.  Each lane keeps
the bias and step-head sums of its own units (lane ``k``: units ``k`` and
``k + 32``) and the CTA sums them warp by warp into one row of ``5 H + 1``
partials: every output is read from exactly the lane and slot that holds
it (hidden 1 to 62, the kernel's constants read from the source).
"""

import pathlib
import re

import pytest

from avr_tpu_torch.ops.kernels import march as K3

SRC = (pathlib.Path(__file__).resolve().parents[1] / "avr_tpu_torch" / "csrc"
       / "march.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def test_constants_match_the_source():
    assert K3.WARPS_F32 == _const("WARPS")
    assert _const("F32_OWN_SLOTS") == 11 and _const("MAX_HIDDEN") == K3.MAX_HIDDEN


@pytest.mark.parametrize("sms", (132, 114, 1))
@pytest.mark.parametrize("rays", (1, 7, 1_000, 4_096, 16_384, 16_387))
def test_the_walk_takes_every_ray_once(rays, sms):
    ctas = K3.walk_ctas_f32(rays, sms)
    assert 1 <= ctas <= sms
    seen = [0] * rays
    for b in range(ctas):
        for w in range(K3.WARPS_F32):
            for ray in range(b * K3.WARPS_F32 + w, rays, ctas * K3.WARPS_F32):
                seen[ray] += 1
    assert seen == [1] * rays


def _stored(hid):
    """(slot, lane) -> what the kernel's lanes store there: dbias of gate k
    and unit u, dw_out of unit u, db_out."""
    out = {}
    for lane in range(32):
        for uu in range(2):
            u = lane + 32 * uu
            if u < hid:
                for k in range(4):
                    out[(2 * k + uu, lane)] = ("dbias", k * hid + u)
                out[(8 + uu, lane)] = ("dw_out", u)
    out[(10, 0)] = ("db_out", 0)
    return out


def _read(o, hid):
    """The reduction's (slot, lane) for output o of 5 hid + 1."""
    if o < 4 * hid:
        u = o % hid
        return 2 * (o // hid) + u // 32, u % 32
    if o < 5 * hid:
        u = o - 4 * hid
        return 8 + u // 32, u % 32
    return 10, 0


@pytest.mark.parametrize("hid", range(1, 63))
def test_each_partial_is_read_from_the_lane_that_holds_it(hid):
    stored = _stored(hid)
    read = [_read(o, hid) for o in range(5 * hid + 1)]
    assert len(set(read)) == len(read) == len(stored)
    for o, key in enumerate(read):
        kind, idx = stored[key]
        want = ("dbias", o) if o < 4 * hid else ("dw_out", o - 4 * hid) if o < 5 * hid else (
            "db_out", 0)
        assert (kind, idx) == want
        assert key[0] < _const("F32_OWN_SLOTS")
