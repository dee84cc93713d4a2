"""The launch planner of the CUDA deformable-attention kernel, on the CPU.

``plan_launch`` is plain Python and decides everything the kernel's grid
depends on: query chunk, work items, persistent CTAs, V stages and shared
memory.  ``cta_tiles`` restates the kernel's walk over a plan.  These tests
hold both to the kernel's contract: every (slot, head, query) is computed
exactly once, the shared memory fits an sm_90 block, two V stages where
two fit, and a tile that cannot fit raises.
"""

import numpy as np
import pytest

from vln_ver_tpu_torch.ops.deform_cuda import (CHUNK_STEP, CTAS_PER_SM,
                                               HEADER_BYTES, MAX_SMEM_BYTES,
                                               cta_tiles, plan_launch)

# the encoder shapes of configs/verformer/get_occ.py
MAIN = dict(heads=8, nq=900, hw=14 * 14, d=96)

# (name, bs, heads, nq, hw, d, element size, stages expected)
CASES = [
    ("main B=1 fp32", 6, 8, 900, 196, 96, 4, 2),
    ("main B=1 bf16", 6, 8, 900, 196, 96, 2, 2),
    ("main B=4 fp32", 24, 8, 900, 196, 96, 4, 2),
    ("main B=4 bf16", 24, 8, 900, 196, 96, 2, 2),
    ("main B=8 fp32", 48, 8, 900, 196, 96, 4, 2),
    ("main B=8 bf16", 48, 8, 900, 196, 96, 2, 2),
    ("nq=57 fp32", 6, 8, 57, 196, 96, 4, 2),
    ("nq=57 bf16", 6, 8, 57, 196, 96, 2, 2),
    ("nq=901 fp32", 6, 8, 901, 196, 96, 4, 2),
    ("nq=901 bf16", 6, 8, 901, 196, 96, 2, 2),
    ("bs=1 fp32", 1, 8, 900, 196, 96, 4, 2),
    ("bs=1 few items", 1, 4, 57, 196, 16, 4, 2),
    ("10x20 fp32", 4, 8, 57, 200, 96, 4, 2),
    ("10x20 bf16", 4, 8, 900, 200, 96, 2, 2),
    ("d=256 fp32 single stage", 6, 8, 900, 196, 256, 4, 1),
    ("d=3 fp32 unaligned rows", 4, 8, 57, 196, 3, 4, 2),
    ("d=3 bf16 unaligned rows", 4, 8, 57, 196, 3, 2, 2),
    ("d=40 P>32 fp32", 4, 4, 65, 196, 40, 4, 2),
]


@pytest.mark.parametrize("sm_count", [132, 114])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plan_covers_every_query_once_and_fits(case, sm_count):
    _, bs, heads, nq, hw, d, elt, stages = case
    plan = plan_launch(bs, heads, nq, hw, d, elt, sm_count)
    pairs = bs * heads
    chunks = -(-nq // plan.chunk)

    # items and runs: each item in exactly one CTA's run, none empty
    assert plan.chunk % CHUNK_STEP == 0
    assert plan.items == pairs * chunks
    assert plan.ctas <= CTAS_PER_SM * sm_count
    assert (plan.ctas - 1) * plan.items_per_cta < plan.items
    assert plan.ctas * plan.items_per_cta >= plan.items

    # the kernel's walk: consecutive (slot, head) pairs, each query once
    seen = np.zeros((pairs, nq), np.int32)
    longest = 0
    for cta in range(plan.ctas):
        tiles = cta_tiles(plan, nq, cta)
        assert [t[0] for t in tiles] == list(range(tiles[0][0],
                                                   tiles[-1][0] + 1))
        for pair, q0, q1 in tiles:
            assert 0 <= q0 < q1 <= nq
            seen[pair, q0:q1] += 1
        longest = max(longest, sum(q1 - q0 for _, q0, q1 in tiles))
    assert (seen == 1).all()
    # every SM gets an equal share, to within one chunk step
    assert longest <= pairs * (nq + CHUNK_STEP - 1) / (
        CTAS_PER_SM * sm_count) + CHUNK_STEP

    # shared memory: header + stages, each stage holding hw rows and the
    # slack a lane's last 128-byte load reads past the last row
    loads = -(-d // (32 * (4 // elt)))
    assert plan.row_stride >= d and plan.row_stride * elt % 4 == 0
    assert plan.stage_bytes % 128 == 0
    assert plan.stage_bytes >= (hw - 1) * plan.row_stride * elt + 128 * loads
    assert plan.stage_bytes >= hw * d * elt
    assert plan.smem_bytes == HEADER_BYTES + plan.stages * plan.stage_bytes
    assert plan.smem_bytes <= MAX_SMEM_BYTES
    assert plan.stages == stages


@pytest.mark.parametrize("shape", [
    dict(hw=400, d=256, elt=4),      # 400 KB fp32 tile
    dict(hw=900, d=96, elt=4),       # 30 x 30 map
    dict(hw=1600, d=96, elt=2),      # 40 x 40 map in bf16
    dict(hw=196, d=257, elt=4),      # head_dim over 256
    dict(hw=196, d=96, elt=8),       # not fp32 or bf16
])
def test_plan_refuses_what_does_not_fit(shape):
    with pytest.raises(ValueError):
        plan_launch(6, 8, 900, shape["hw"], shape["d"], shape["elt"], 132)


def test_plan_at_the_shared_memory_limit():
    """Rows of 96 fp32 (384 B) up to the limit: the most that fit one
    stage plan one, a row more raises; the most that fit twice plan two,
    a row more plans one."""
    room = MAX_SMEM_BYTES - HEADER_BYTES
    one, two = room // 384, room // 2 // 384
    plan = plan_launch(6, 8, 900, one, 96, 4, 132)
    assert plan.stages == 1 and plan.smem_bytes <= MAX_SMEM_BYTES
    with pytest.raises(ValueError):
        plan_launch(6, 8, 900, one + 1, 96, 4, 132)
    assert plan_launch(6, 8, 900, two, 96, 4, 132).stages == 2
    assert plan_launch(6, 8, 900, two + 1, 96, 4, 132).stages == 1


def test_main_shape_spreads_over_every_sm():
    """B=1 has 48 (slot, head) pairs for 132 SMs: the chunk splits them
    so that every SM but at most one chunk's worth gets a run."""
    plan = plan_launch(6, MAIN["heads"], MAIN["nq"], MAIN["hw"], MAIN["d"],
                       4, 132)
    assert plan.ctas >= 132 - 1
    assert plan.items_per_cta * plan.chunk <= 6 * 8 * 900 / 132 + CHUNK_STEP
    # each CTA stages at most two V tiles, against 15 per pair for a grid
    # of 64-query tiles
    assert max(len(cta_tiles(plan, 900, c)) for c in range(plan.ctas)) <= 2
