"""K1's and K5's tiled forward (``avr_tpu_torch/csrc/gather.cu``,
``gather_fwd_tile_kernel``): its launch plan.

The plan (``ops/kernels/gather.py fwd_plan``): tiles of ``P`` consecutive
points of one view, one CTA a tile.  ``_tiles`` decodes each CTA's tile as
the kernel does (``gather_fwd_tile_kernel``'s first lines) and ``_items``
each thread's ``(point, channel group)`` items of a tile, from one division
and then by adding steps; on that decode every point of every view is
written exactly once, and every channel group of a tile's points once (N =
0, 1, partial last tiles, B up to 8, channel groups that do and do not
divide the CTA).  The kernel's constants are read from the source, and its
launch refuses a tile size past its shared slots.  The function itself at
ray-ordered points: ``tests/test_torch_gather_proj.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from avr_tpu_torch.ops.kernels import gather as K1

torch.set_num_threads(2)

SRC = Path(K1.__file__).resolve().parents[2] / "csrc" / "gather.cu"
CONST = {m[1]: int(m[2]) for m in
         re.finditer(r"constexpr int (\w+) = (\d+);", SRC.read_text())}
SMS = 132  # an H100 SXM


def test_constants_match_the_kernel_source():
    assert (K1.FWD_THREADS, K1.FWD_MAX_POINTS) == (CONST["FWD_THREADS"],
                                                   CONST["FWD_MAX_POINTS"])
    assert K1.FWD_MAX_POINTS <= K1.FWD_THREADS, "a point's taps are prepared by one thread"


def test_the_launch_refuses_tiles_past_the_shared_slots():
    """``launch_fwd`` returns ``cudaErrorInvalidValue`` (the wrapper's
    ``_build.check`` raises) for a tile of fewer than 1 or more than
    ``FWD_MAX_POINTS`` points, before it divides by the tile size or
    launches; ``fwd_plan`` stays inside that range at every shape."""
    body = re.search(r"static int launch_fwd\(.*?\n}\n", SRC.read_text(), re.S)[0]
    guard = re.search(r"if \(P < 1 \|\| P > FWD_MAX_POINTS\) return \(int\)cudaErrorInvalidValue;",
                      body)
    assert guard, "launch_fwd must refuse a tile size outside 1..FWD_MAX_POINTS"
    assert guard.start() < body.index("/ P") < body.index("<<<")
    for B in (1, 3, 8):
        for N in (0, 1, 17, 4_096, 81_920, 393_216):
            for C, elt in ((4, 4), (16, 2), (512, 2), (512, 4), (4_096, 4), (8_192, 2)):
                P, _ = K1.fwd_plan(B, N, C, elt, SMS)
                assert 1 <= K1.FWD_MIN_POINTS <= P <= CONST["FWD_MAX_POINTS"], (B, N, C, elt)


def _tiles(B, tpv):
    """Each CTA's tile ``(b, j)``: one division of its index, as
    gather_fwd_tile_kernel decodes ``blockIdx.x``."""
    for t in range(B * tpv):
        yield divmod(t, tpv)


def _items(G, np_):
    """Each thread's ``(point, group)`` items of a tile of ``np_`` points
    and ``G`` groups a point, in the kernel's order: from ``tid`` by one
    division, then by adding the CTA's step of ``FWD_THREADS`` items."""
    T = K1.FWD_THREADS
    p_step, g_step = divmod(T, G)
    for tid in range(T):
        p, g = divmod(tid, G)
        out = []
        while p < np_:
            out.append((p, g))
            p, g = p + p_step, g + g_step
            if g >= G:
                p, g = p + 1, g - G
        yield out


@pytest.mark.parametrize("B,N,C,elt", [
    (1, 81_920, 512, 2),  # the band call, bf16
    (1, 4_096, 512, 2),  # a served chunk's coarse query: 16-point tiles
    (4, 4_096, 512, 2),  # the train step's: 32-point tiles
    (4, 81_920, 512, 4),  # the train step's band, float32
    (8, 1, 512, 2),  # SB 4 x NS 2, one point each
    (8, 1_037, 512, 2),  # a partial last tile in every view
    (3, 33, 16, 2),  # C = 16 bf16: two groups a point, 256-point tiles
    (2, 300, 4, 4),  # C = 4 float32: one group a point
    (4, 393_216, 512, 2),  # the VR fine pass's one-chunk step
    (1, 5, 4_096, 4),  # more groups a point than threads
    (3, 70, 384, 2),  # 48 groups a point: they do not divide the CTA
    (1, 0, 512, 2),  # no point
])
def test_every_point_is_written_once(B, N, C, elt):
    P, tpv = K1.fwd_plan(B, N, C, elt, SMS)
    G = C * elt // 16
    assert K1.FWD_MIN_POINTS <= P <= K1.FWD_MAX_POINTS and tpv == -(-N // P)
    # tiles of about FWD_TILE_ITEMS groups, smaller only to give every SM two CTAs
    assert P * G >= K1.FWD_TILE_ITEMS or P == K1.FWD_MAX_POINTS or B * tpv < 4 * SMS
    seen = np.zeros((B, N), np.int64)
    for b, j in _tiles(B, tpv):
        seen[b, j * P:min(N, j * P + P)] += 1
    assert (seen == 1).all()
    if N == 0:
        assert B * tpv == 0, "no point launches no CTA"
        return
    # within a tile (a full one and the last one of a view): every item once
    for np_ in {min(P, N), N - (tpv - 1) * P}:
        cover = np.zeros((np_, G), np.int64)
        for out in _items(G, np_):
            for p, g in out:
                cover[p, g] += 1
        assert (cover == 1).all()
