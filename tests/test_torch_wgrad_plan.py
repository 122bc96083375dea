"""The wgrad's host plan (``ops/kernels/resnetfc.py wgrad_plan``), bf16 and
float32.

``_blocks`` decodes each CTA's block index as the kernel does
(``csrc/resnetfc_hopper.cu``, ``resnetfc_wgrad_wgmma_kernel``'s first
lines); on that decode every (dW tile, row) pair of every job must be
covered exactly once, each job's partial sums must have a region of the
partials buffer of their own, and the split must fill the card: K2's
fifteen jobs of the band call (N = 327,680: ten fc products and three
latent injections of 512 x 512, lin_in 512 x 64, lin_out 4 x 512), K3's
dW_ih (163,840 ray-steps, 512 x 64), and ragged shapes (row counts off the
64-row stage and the split, widths off the 128-wide tile, more than one
launch of jobs).
"""

import pytest
import torch

from avr_tpu_torch.ops.kernels import resnetfc as K2

N = 327_680
K2_JOBS = [(N, 512, 512, True)] * 13 + [(N, 512, 64, True), (N, 4, 512, True)]
K3_JOB = [(163_840, 512, 64, False)]
RAGGED = [(1_000, 520, 200, True), (70_001, 4, 512, True), (3, 512, 64, False),
          (131_071, 64, 248, True)] * 3


def _blocks(shapes, plan):
    """What each CTA computes, ``(job, o0, i0, row_begin, row_end)`` per
    launch and block, decoded from the plan as resnetfc_wgrad_wgmma_kernel
    decodes ``blockIdx.x`` (csrc/resnetfc_hopper.cu:757-765): the job is the
    last of its launch whose first block is at or below the index, then
    ``split, tile = divmod(local, tiles)`` and ``tile`` row-major over the
    (o, i) tiles."""
    for g, n_blocks in enumerate(plan.blocks):
        members = [j for j, jp in enumerate(plan.jobs) if jp.group == g]
        for b in range(n_blocks):
            j = members[0]
            for m in members[1:]:
                if b >= plan.jobs[m].first_block:
                    j = m
            jp, rows = plan.jobs[j], shapes[j][0]
            local = b - jp.first_block
            split, tile = divmod(local, jp.tiles_o * jp.tiles_i)
            rb = split * jp.chunk
            yield (j, tile // jp.tiles_i * K2.WGRAD_TILE, tile % jp.tiles_i * K2.WGRAD_TILE, rb,
                   min(rows, rb + jp.chunk))


def _intervals(shapes, plan):
    cover = {}
    for j, o0, i0, rb, re in _blocks(shapes, plan):
        assert rb < re, "an empty split"
        cover.setdefault((j, o0, i0), []).append((rb, re))
    return cover


@pytest.mark.parametrize("shapes", [K2_JOBS, K3_JOB, RAGGED], ids=["K2", "K3", "ragged"])
def test_every_tile_and_row_is_covered_once(shapes):
    plan = K2.wgrad_plan(shapes)
    cover = _intervals(shapes, plan)
    for j, (rows, mg, ka, _) in enumerate(shapes):
        tiles = {(o0, i0) for o0 in range(0, mg, K2.WGRAD_TILE)
                 for i0 in range(0, ka, K2.WGRAD_TILE)}
        assert {(o0, i0) for (jj, o0, i0) in cover if jj == j} == tiles
        for o0, i0 in tiles:
            spans = sorted(cover[(j, o0, i0)])
            assert spans[0][0] == 0 and spans[-1][1] == rows
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:])), "a gap or an overlap"
        assert plan.jobs[j].chunk % K2.WGRAD_ROWS == 0
    assert sum(plan.blocks) == sum(1 for _ in _blocks(shapes, plan))


@pytest.mark.parametrize("shapes", [K2_JOBS, K3_JOB, RAGGED], ids=["K2", "K3", "ragged"])
def test_partials_regions_are_disjoint(shapes):
    plan = K2.wgrad_plan(shapes)
    regions = []
    for jp, (rows, mg, ka, bias) in zip(plan.jobs, shapes):
        regions.append((jp.part, jp.part + jp.splits * mg * ka))
        assert jp.part % 4 == 0  # the reduction reads float4s
        if bias:
            regions.append((jp.bpart, jp.bpart + jp.splits * jp.tiles_i * mg))
        else:
            assert jp.bpart == -1
    regions.sort()
    assert regions[0][0] == 0 and regions[-1][1] == plan.floats
    assert all(a[1] == b[0] for a, b in zip(regions, regions[1:]))


@pytest.mark.parametrize("shapes", [K2_JOBS, RAGGED], ids=["K2", "ragged"])
def test_launch_groups_hold_at_most_eight_jobs(shapes):
    plan = K2.wgrad_plan(shapes)
    groups = [jp.group for jp in plan.jobs]
    assert groups == sorted(groups) and len(plan.blocks) == len(set(groups))
    assert max(groups.count(g) for g in set(groups)) <= K2.WGRAD_GROUP


@pytest.mark.parametrize("shapes", [K2_JOBS, K3_JOB], ids=["K2", "K3"])
def test_each_large_job_fills_the_card(shapes):
    """Each 512-wide job of the band call, and K3's skinny 512 x 64, runs
    on at least two waves of CTAs (the design this replaces gave dW_ih 32
    CTAs on 132 SMs)."""
    plan = K2.wgrad_plan(shapes)
    for jp, (rows, mg, ka, _) in zip(plan.jobs, shapes):
        if mg >= 512:
            assert jp.tiles_o * jp.tiles_i * jp.splits >= 2 * K2.WGRAD_SMS


# The float32 wgrad (csrc/resnetfc.cu resnetfc_wgrad_f32_kernel): the same
# block decode and partials layout, its own row split (at least
# WGRAD_WAVES_F32 waves of CTAs a job where its rows allow chunks of
# WGRAD_MIN_CHUNK_F32, a multiple of its 32-row step) and one launch.  K2's
# float32 jobs at the train step's band call and at chip_smoke.py's float32
# check shapes (4,096 points, NS 1 and 2), K3's dW_ih and dW_hh over a train
# step's 163,840 ray-steps (v_t | h_prev: 512 and 16 columns), ragged shapes.
F32_K2 = [(N, 512, 512, True)] * 13 + [(N, 512, 64, True), (N, 4, 512, True)]
F32_K2_SMALL = [(4_096 * ns, 512, 512, True) for ns in (1, 2)] + [(4_096, 4, 512, True)]
F32_K3 = [(163_840, 512, 64, False), (163_840, 16, 64, False)]
F32_RAGGED = [(1_000, 520, 200, True), (70_001, 4, 512, True), (3, 512, 64, False),
              (131_071, 64, 248, True), (0, 16, 64, False)] * 2
F32_CASES = [F32_K2, F32_K2_SMALL, F32_K3, F32_RAGGED]
F32_IDS = ["K2", "K2 check shapes", "K3", "ragged"]


@pytest.mark.parametrize("shapes", F32_CASES, ids=F32_IDS)
def test_float32_plan_covers_every_tile_and_row_once(shapes):
    plan = K2.wgrad_plan(shapes, torch.float32)
    cover = {}
    for j, o0, i0, rb, re in _blocks(shapes, plan):
        cover.setdefault((j, o0, i0), []).append((rb, re))
    for j, (rows, mg, ka, _) in enumerate(shapes):
        tiles = {(o0, i0) for o0 in range(0, mg, K2.WGRAD_TILE)
                 for i0 in range(0, ka, K2.WGRAD_TILE)}
        assert {(o0, i0) for (jj, o0, i0) in cover if jj == j} == tiles
        jp = plan.jobs[j]
        assert jp.chunk % K2.WGRAD_ROWS_F32 == 0
        assert jp.splits <= max(1, rows // K2.WGRAD_MIN_CHUNK_F32)
        assert jp.chunk >= min(K2.WGRAD_MIN_CHUNK_F32, rows)
        for o0, i0 in tiles:
            spans = sorted(cover[(j, o0, i0)])
            assert spans[0][0] == 0 and spans[-1][1] == rows
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:])), "a gap or an overlap"
            assert len(spans) == jp.splits  # every split a CTA: its partial tile is written
    assert sum(plan.blocks) == sum(1 for _ in _blocks(shapes, plan))


@pytest.mark.parametrize("shapes", F32_CASES, ids=F32_IDS)
def test_float32_partials_are_disjoint(shapes):
    """Each (split, tile) CTA writes its own partial tile and its own bias
    partial (its column tile's share of the row range's stages), all in one
    launch, so the reduction adds every element's splits in one order."""
    plan = K2.wgrad_plan(shapes, torch.float32)
    assert len(plan.blocks) == 1 and {jp.group for jp in plan.jobs} == {0}  # one launch
    written = {}
    for j, o0, i0, rb, _ in _blocks(shapes, plan):
        jp, (_, mg, ka, bias) = plan.jobs[j], shapes[j]
        split = rb // jp.chunk
        for o in range(o0, min(mg, o0 + K2.WGRAD_TILE)):
            for c in (i0, min(ka, i0 + K2.WGRAD_TILE) - 1):  # the tile's first and last column
                written.setdefault(jp.part + (split * mg + o) * ka + c, []).append(j)
            if bias:
                ti = i0 // K2.WGRAD_TILE
                written.setdefault(jp.bpart + (split * jp.tiles_i + ti) * mg + o, []).append(j)
    assert all(len(v) == 1 for v in written.values()), "two CTAs write one partial"
    assert max(written) < plan.floats
    for jp, (_, mg, ka, bias) in zip(plan.jobs, shapes):
        assert jp.part % 4 == 0 and (mg * ka) % 4 == 0  # the reduction reads float4s


@pytest.mark.parametrize("shapes", [F32_K2, F32_K3], ids=["K2", "K3"])
def test_float32_plan_fills_the_card(shapes):
    """Each float32 job at K2's band call and K3's train step runs on at
    least WGRAD_WAVES_F32 waves of CTAs on the card's SMs, or as many splits
    as its rows allow at WGRAD_MIN_CHUNK_F32 rows a chunk (K3's 16 x 64
    dW_hh), and every chunk but a job's last holds at least that many rows
    (the plan this replaces gave K3's two jobs 40 CTAs on 132 SMs)."""
    plan = K2.wgrad_plan(shapes, torch.float32)
    for jp, (rows, mg, ka, _) in zip(plan.jobs, shapes):
        ctas = jp.tiles_o * jp.tiles_i * jp.splits
        assert ctas >= K2.WGRAD_WAVES_F32 * K2.WGRAD_SMS or \
            jp.splits == rows // K2.WGRAD_MIN_CHUNK_F32
        assert jp.chunk >= K2.WGRAD_MIN_CHUNK_F32
        assert rows - (jp.splits - 1) * jp.chunk > 0  # the last split is not empty
    if shapes is F32_K3:
        assert sum(plan.blocks) >= K2.WGRAD_WAVES_F32 * K2.WGRAD_SMS > 40
