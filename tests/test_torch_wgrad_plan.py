"""The bf16 wgrad's host plan (``ops/kernels/resnetfc.py wgrad_plan``).

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
