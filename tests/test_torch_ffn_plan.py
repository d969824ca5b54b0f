"""The FFN kernel's host side, on the CPU: its plan.

The kernel (``csrc/fused_bert.cu ffn_ln_kernel``) runs only on the card
(``tests/test_torch_kernels_cuda.py``); what ``ffn_plan`` decides for it is
checked here for every width it takes and for row counts from one row to
the rerank shape.
"""

from __future__ import annotations

import pytest

from financial_rag_system_tpu_torch.ops import fused_bert as tfb

H100_SMS = 132
WIDTHS = range(64, tfb.MAX_HIDDEN + 1, 64)
ROWS = (1, 65, 1024, 64 * 137 + 5, 192_000)
CONSUMER_REGS = 240  # the consumer warpgroups' setmaxnreg budget
UP_REGS = 16         # a GEMM1 accumulator: 64 rows x 32 up columns


@pytest.mark.parametrize("h", WIDTHS)
@pytest.mark.parametrize("r", ROWS)
def test_ffn_plan_fits_the_card(h, r):
    i = 4 * h
    plan = tfb.ffn_plan(h, i, r, H100_SMS)
    chunk = tfb.ffn_chunk(plan.rows)
    # tiles of 128 rows where a warpgroup holds 64 x H f32, else 64 (H split);
    # at H 384 the H split also where 128-row tiles would split I
    few = 2 * -(-r // 128) <= H100_SMS
    assert plan.rows == (128 if h < tfb.FFN_WIDE or (h == tfb.FFN_WIDE and not few) else 64)
    assert plan.tiles == -(-r // plan.rows)
    # shared memory: the kernel's sum, within a block's limit, two pieces at least
    assert plan.smem == tfb.ffn_smem(h, plan.rows, plan.ring, plan.stages)
    assert plan.smem <= tfb.SMEM_LIMIT
    assert 2 <= plan.ring <= tfb.FFN_MAX_RING and plan.stages in (1, 2)
    assert (plan.ring == tfb.FFN_MAX_RING
            or tfb.ffn_smem(h, plan.rows, plan.ring + 1, plan.stages) > tfb.SMEM_LIMIT)
    # registers: a consumer thread's accumulator and GEMM1's (one, whose two
    # chains over K take turns in it, with 128-row tiles; two with H split)
    acc = (h if plan.rows == 128 else h // 2) // 2
    up = UP_REGS if plan.rows == 128 else 2 * UP_REGS
    assert acc <= 192 and acc + up + 32 <= CONSUMER_REGS
    # the I split: whole chunks, none empty, every split within one wave
    pieces = i // chunk
    assert i % chunk == 0 and 1 <= plan.splits <= pieces
    lengths = [pieces // plan.splits + (k < pieces % plan.splits) for k in range(plan.splits)]
    assert sum(lengths) == pieces and min(lengths) >= 1 and max(lengths) - min(lengths) <= 1
    if plan.splits > 1:
        assert plan.ctas == plan.tiles * plan.splits <= H100_SMS
        assert plan.workspace == plan.splits * plan.tiles * plan.rows * h
    else:
        assert plan.ctas == min(plan.tiles, H100_SMS) and plan.workspace == 0
    # few tiles: the split fills at least 3/4 of the card where I has the chunks
    if 4 * plan.tiles <= H100_SMS:
        assert plan.ctas >= min(0.75 * H100_SMS, plan.tiles * pieces)


def test_ffn_plan_at_the_main_path_shapes():
    """BGE-small and MiniLM-L6 (H 384, I 1536): the rerank shape walks
    1,500 tiles of 128 rows on one block a multiprocessor; the embed shape
    (32 queries x 32 tokens) takes 16 tiles of 64 rows with H split, and
    splits each tile's 24 chunks of 64 over 8 blocks, 128 in all, with
    12.6 MB of partial sums."""
    rerank = tfb.ffn_plan(384, 1536, 480 * 400, H100_SMS)
    assert rerank == tfb.FFNPlan(rows=128, tiles=1500, splits=1, ctas=132, ring=3, stages=2,
                                 smem=222_568, workspace=0)
    embed = tfb.ffn_plan(384, 1536, 32 * 32, H100_SMS)
    assert (embed.rows, embed.tiles, embed.splits, embed.ctas) == (64, 16, 8, 128)
    assert embed.workspace * 4 == 12_582_912
    # 69 tiles of 128 need no split: they stay
    assert tfb.ffn_plan(384, 1536, 64 * 137 + 5, H100_SMS).rows == 128
    assert tfb.ffn_plan(512, 2048, 1, H100_SMS).rows == 64
    # either plan at H 384 on request (the variants tool compares the two)
    split = tfb._ffn_plan_rows(384, 1536, 480 * 400, H100_SMS, 64)
    assert (split.rows, split.tiles, split.ring) == (64, 3000, 2)
    assert tfb._ffn_plan_rows(384, 1536, 32 * 32, H100_SMS, 128).splits == 16


def test_ffn_smem_is_the_kernel_layout():
    """The sum the kernel's static layout asserts, term by term, at H 384."""
    # 1 KB alignment, x tile 128 x 384 bf16, three pieces of 32 x 384 bf16,
    # two f32 x slots a warpgroup, each warpgroup's GEMM1 sums over half of
    # K (64 x 32 f32), barriers (3 pieces x 6 boxes + 3 + 8 + 2 x (4 + 3)
    # reduction slots), the flag
    assert tfb.ffn_smem(384, 128, 3, 2) == (1024 + 98_304 + 3 * 24_576 + 4 * 8192 + 2 * 8192
                                            + 8 * (18 + 3 + 8 + 14) + 16)
    # the H split: a 64-row x tile, pieces of 64 x H, two up tiles, row sums
    assert tfb.ffn_smem(512, 64, 2, 1) == (1024 + 65_536 + 2 * 65_536 + 2 * 8192 + 16_384
                                           + 1024 + 8 * (16 + 2 + 4 + 6) + 16)
