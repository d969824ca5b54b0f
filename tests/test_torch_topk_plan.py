"""Kernels 1 and 3's host side, on the CPU: their launch plans, and a numpy
model of the walk, the selection and the merge the kernels run.

The kernels (``csrc/masked_topk.cu`` and ``csrc/ivf_probe.cu``, built from
``csrc/topk_common.cuh``) run only on the card
(``tests/test_torch_kernels_cuda.py``).  What ``topk_plan`` and
``probe_plan`` decide for them is checked here for every width they take,
for batch sizes across query blocks and for corpus sizes from one row to
the IVF tier's million; the model walks the tiles the way a plan deals
them out, keeps each block's list the way a warp does (threshold, then
insert), merges the blocks' lists in rounds that drop a list once its
entry fails to enter, and must give the plain versions' top k.
"""

from __future__ import annotations

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from financial_rag_system_tpu_torch.index.ivf import ivf_probe_plain, probe_plan
from financial_rag_system_tpu_torch.ops import topk as ttk

H100_SMS = 132
COMMON = Path(ttk.__file__).resolve().parent.parent / "csrc" / "topk_common.cuh"
ELEMENT = {torch.bfloat16: 2, torch.int8: 1}
# the widths at which two blocks share an SM in both types (bf16 rows of
# at most 2,048 bytes); wider rows are WIDE_WIDTHS
WIDTHS = [(dtype, d) for dtype in ELEMENT for d in range(64, 1024 + 1, ttk.DIM_STEP[dtype])]
WIDE_WIDTHS = [(torch.bfloat16, d) for d in (1040, 1536, 2048, 3072, 3136)] + [
    (torch.int8, d) for d in (2048, 2080, 4096, 6272)]
BATCHES = (1, 33, 64)
NO_ID = 2**31 - 1


def cuh_constants() -> dict[str, int]:
    """The literal integer constants of ``csrc/topk_common.cuh``."""
    text = COMMON.read_text()
    return {m[1]: int(m[2]) for m in re.finditer(r"constexpr int (k\w+) = (\d+);", text)}


def test_plan_constants_are_the_kernels():
    c = cuh_constants()
    assert (c["kQB"], c["kRows"], c["kBoxBytes"]) == (ttk.QUERY_BLOCK, ttk.TILE_ROWS,
                                                      ttk.BOX_BYTES)
    assert (c["kSlots"], c["kSlotBytes"]) == (ttk.SLOTS, ttk.SLOT_BYTES)
    assert (c["kMaxStages"], c["kSmemLimit"], c["kMaxRowBytes"]) == (
        ttk.MAX_STAGES, ttk.SMEM_LIMIT, ttk.MAX_ROW_BYTES)
    assert "kMaxK" not in c and "kMaxD" not in c  # any k, and D up to the row bytes
    assert c["kMergeWarps"] * 32 * c["kMaxChunks"] == ttk.MAX_BLOCKS
    assert c["kRoundK"] == ttk.ROUND_K == 32
    assert "constexpr int kScStride = kRows + 4;" in COMMON.read_text()
    assert ttk.SCORE_STRIDE == ttk.TILE_ROWS + 4


def carved(row_bytes: int, stages: int) -> tuple[int, dict[str, int]]:
    """The kernel's carve of its dynamic shared memory (``carve`` in
    ``topk_common.cuh``) from a base known only to be 16-byte aligned:
    its end and each region's offset from the aligned start."""
    at, offsets = 0, {}
    for name, size in (("q", -(-row_bytes // 128) * 32 * 128), ("ring", stages * 64 * 128),
                       ("slots", ttk.SLOTS * ttk.SLOT_BYTES),
                       ("sc", 4 * 2 * 32 * ttk.SCORE_STRIDE),
                       ("bars", 8 * (2 * stages + 2 * ttk.SLOTS + 1))):
        offsets[name] = at
        at += size
    return 1024 - 16 + at, offsets


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("dtype,d", WIDTHS)
def test_topk_plan_fits_the_card(dtype, d, b):
    k = 15
    row_bytes = d * ELEMENT[dtype]
    plan = ttk.topk_plan(b, 131_072, d, ELEMENT[dtype], k, H100_SMS)
    # shared memory: the kernel's carve (the slack pads a 16-byte-aligned
    # base to 1024), within a block's limit; TMA boxes 1024-aligned
    end, offsets = carved(row_bytes, plan.stages)
    assert plan.smem == ttk.topk_smem(row_bytes, plan.stages) <= ttk.SMEM_LIMIT
    assert end <= plan.smem
    assert offsets["q"] % 1024 == 0 and offsets["ring"] % 1024 == 0
    assert offsets["slots"] % 128 == 0 and ttk.SLOT_BYTES % 128 == 0 and offsets["bars"] % 8 == 0
    # two blocks an SM: each within half an SM's shared memory
    assert plan.smem <= ttk.SM_SMEM // 2 - 1024
    # the ring: the plan's depth, at least three boxes in flight
    room = (ttk.SM_SMEM // 2 - 1024 - ttk.topk_smem(row_bytes, 0)) // (64 * 128)
    assert plan.stages == min(ttk.TOPK_STAGES, room) and plan.stages >= 3
    # the grid: two blocks an SM shared by the query blocks
    assert plan.qblocks == -(-b // 32)
    assert plan.blocks == 2 * H100_SMS // plan.qblocks <= ttk.MAX_BLOCKS
    # scratch: scores and ids of every block's list, all read by pass 2
    assert plan.candidates == plan.blocks * k
    assert plan.scratch == 2 * b * k * plan.blocks


@pytest.mark.parametrize("dtype,d", WIDTHS)
def test_probe_plan_fits_the_card(dtype, d):
    plan = probe_plan(32, 16_384, 128, d, ELEMENT[dtype], 15, H100_SMS)
    assert plan.smem == ttk.topk_smem(d * ELEMENT[dtype], plan.stages) <= ttk.SMEM_LIMIT
    assert plan.stages >= 3 and plan.blocks == 2 * H100_SMS and plan.tiles == 16_384 * 2


def test_plans_at_the_main_path_shapes():
    """B 32 over the flat corpus (131,072 rows, and the IVF corpus's
    1,048,580 flat rows) and over a 16,384-entry probe list of 128-row
    tiles: two blocks an SM, 8 stages, 264 x 15 candidates a query for
    pass 2, which 4 warps share (the design before swept 128 x 15, 1,024 x
    15 and 512 x 15 with one warp, K times)."""
    for elt in (2, 1):
        flat = ttk.topk_plan(32, 131_072, 384, elt, 15, H100_SMS)
        big = ttk.topk_plan(32, 1_048_580, 384, elt, 15, H100_SMS)
        probe = probe_plan(32, 16_384, 128, 384, elt, 15, H100_SMS)
        for plan in (flat, big, probe):
            assert (plan.blocks, plan.qblocks, plan.stages, plan.candidates) == (264, 1, 8, 3960)
        assert (flat.tiles, big.tiles) == (2048, 16_385)
    assert ttk.topk_plan(32, 131_072, 384, 2, 15, H100_SMS).smem == 113_352


@pytest.mark.parametrize("n", [1, 5, 63, 64, 65, 777, 5000])
@pytest.mark.parametrize("b", BATCHES)
def test_topk_plan_small_corpora(n, b):
    """The staged path's gathered subsets: never more blocks than tiles."""
    plan = ttk.topk_plan(b, n, 384, 2, 15, H100_SMS)
    assert plan.tiles == math.ceil(n / 64)
    assert plan.blocks == min(plan.tiles, 2 * H100_SMS // plan.qblocks)


@pytest.mark.parametrize("tile", [64, 128, 256])
@pytest.mark.parametrize("b", BATCHES)
def test_probe_plan_tiles(tile, b):
    plan = probe_plan(b, 3, tile, 384, 2, 32, H100_SMS)
    assert plan.tiles == 3 * tile // 64
    assert plan.blocks == min(plan.tiles, 2 * H100_SMS // plan.qblocks)
    assert plan.candidates == plan.blocks * 32


@pytest.mark.parametrize("row_bytes", [128, 768, 2048])
def test_plan_blocks_an_sm(row_bytes):
    """One block an SM takes the whole limit and the plan's full ring; two
    keep at least three stages at every width."""
    one = ttk.plan_for(32, 2048, row_bytes, 15, H100_SMS, per_sm=1)
    assert one.blocks == H100_SMS and one.stages == ttk.TOPK_STAGES
    two = ttk.plan_for(32, 2048, row_bytes, 15, H100_SMS, per_sm=2)
    assert two.blocks == 2 * H100_SMS and 3 <= two.stages <= ttk.TOPK_STAGES
    assert two.smem <= ttk.SM_SMEM // 2 - 1024


@pytest.mark.parametrize("dtype,d", WIDE_WIDTHS)
def test_wide_rows_take_one_block_an_sm(dtype, d):
    """Past two blocks an SM with three stages, a plan takes one block an
    SM and the ring the rest of its shared memory holds, up to
    MAX_ROW_BYTES (one stage); kernels 1 and 3 alike."""
    row_bytes = d * ELEMENT[dtype]
    for plan in (ttk.topk_plan(32, 131_072, d, ELEMENT[dtype], 15, H100_SMS),
                 probe_plan(32, 16_384, 128, d, ELEMENT[dtype], 15, H100_SMS)):
        two = (ttk.SM_SMEM // 2 - 1024 - ttk.topk_smem(row_bytes, 0)) // (64 * 128)
        room = (ttk.SMEM_LIMIT - ttk.topk_smem(row_bytes, 0)) // (64 * 128)
        per_sm = 1 if two < ttk.MIN_SHARED_STAGES else 2
        assert plan.blocks == per_sm * H100_SMS
        assert plan.stages == min(ttk.TOPK_STAGES, room if per_sm == 1 else two) >= 1
        end, _ = carved(row_bytes, plan.stages)
        assert end <= plan.smem == ttk.topk_smem(row_bytes, plan.stages) <= ttk.SMEM_LIMIT
    assert per_sm == 1 or row_bytes == 2048  # int8 at D 2048 still fits two
    ttk.check_dims(d, d, dtype)


@pytest.mark.parametrize("dtype", list(ELEMENT))
def test_rows_past_the_widest_are_refused(dtype):
    elt = ELEMENT[dtype]
    widest = ttk.MAX_ROW_BYTES // elt
    ttk.check_dims(widest, widest, dtype)
    assert ttk.plan_for(32, 2048, widest * elt, 15, H100_SMS).stages == 1
    wider = widest + ttk.DIM_STEP[dtype]
    with pytest.raises(ValueError, match="dims"):
        ttk.check_dims(wider, wider, dtype)
    with pytest.raises(ValueError, match="no ring stage"):
        ttk.plan_for(32, 2048, wider * elt + 128, 15, H100_SMS)


def test_plan_many_query_blocks():
    plan = ttk.topk_plan(8192, 131_072, 384, 2, 15, H100_SMS)
    assert plan.qblocks == 256 and plan.blocks == 1


# -- a numpy model of the kernels' selection and merge ------------------------


def before(a, b) -> bool:
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


class WarpList:
    """A query's best list as a warp keeps it: k entries, best first."""

    def __init__(self, k: int):
        self.k, self.e = k, [(-np.inf, NO_ID)] * k

    def offer(self, lanes: list) -> list[bool]:
        """One candidate (or None) a lane: those ranking before entry k - 1
        when offered enter, each placed by the count of entries before it."""
        last = self.e[-1]
        enter = [c is not None and before(c, last) for c in lanes]
        for c, e in zip(lanes, enter):
            if e:
                pos = sum(before(x, c) for x in self.e)
                if pos < self.k:
                    self.e = self.e[:pos] + [c] + self.e[pos:-1]
        return enter


def block_list(cands: dict[int, float], pieces: list[int], k: int) -> list:
    """A block's walk: each 64-row piece from `base`, rows lane and
    lane + 32 offered a half at a time."""
    lst = WarpList(k)
    for base in pieces:
        for h in (0, 1):
            rows = [base + lane + 32 * h for lane in range(32)]
            lst.offer([(cands[r], r) if r in cands else None for r in rows])
    return lst.e


def merge(lists: list[list], k: int) -> list:
    """Pass 2: warp w merges lists w, w + 4, ...; the warps' lists then
    merge pairwise (each keeps the best k of two)."""
    warps = cuh_constants()["kMergeWarps"]
    merged = [warp_merge(lists[w::warps], k) for w in range(warps)]
    while len(merged) > 1:
        half = len(merged) // 2
        merged = [sorted(merged[w] + merged[w + half], key=lambda e: (-e[0], e[1]))[:k]
                  for w in range(half)]
    return merged[0]


def warp_merge(lists: list[list], k: int) -> list:
    """A warp's rounds: round j offers entry j of every list still in the
    running, 32 lists a batch; a list whose entry fails leaves."""
    out, alive = WarpList(k), [True] * len(lists)
    for j in range(k):
        if not any(alive):
            break
        for c0 in range(0, len(lists), 32):
            group = range(c0, min(c0 + 32, len(lists)))
            enter = out.offer([lists[g][j] if alive[g] else None for g in group])
            for g, e in zip(group, enter):
                alive[g] = e
    return out.e


def as_result(entries: list, id_map=None):
    s = np.array([e[0] for e in entries], np.float32)
    i = np.array([-1 if e[0] == -np.inf else (e[1] if id_map is None else id_map[e[1]])
                  for e in entries], np.int32)
    return s, i


def tie_heavy_int8(rng, n, d, distinct=6):
    return rng.integers(-3, 4, (distinct, d))[rng.integers(0, distinct, n)].astype(np.int8)


@pytest.mark.parametrize("blocks", [1, 5, 47, 300])
@pytest.mark.parametrize("k", [1, 15, 32])
def test_model_of_kernel_1_equals_plain(blocks, k):
    """Tie-heavy int8 rows (six distinct vectors) dealt to `blocks` blocks
    in contiguous shares of 64-row tiles (47: one tile each; 300: most
    blocks empty, and a warp of pass 2 takes three lists a lane): the
    model's top k equals masked_topk_plain's bit for bit."""
    rng = np.random.default_rng(blocks * 100 + k)
    b, n, d, n_valid = 3, 3000, 64, 2990
    q, c = tie_heavy_int8(rng, b, d, 3), tie_heavy_int8(rng, n, d)
    codes = np.stack([rng.integers(0, 3, n), rng.integers(0, 2, n)]).astype(np.int32)
    codes[:, n_valid:] = -2
    qf = np.array([[-1, -1], [1, -1], [2, 0]], np.int32)
    s_ref, i_ref = ttk.masked_topk_plain(*(torch.from_numpy(a) for a in (q, c, codes, qf)),
                                         n_valid, k)
    scores = q.astype(np.int64) @ c.astype(np.int64).T
    tiles = -(-n // 64)
    for qi in range(b):
        ok = [r for r in range(n_valid)
              if qf[qi, 0] in (-1, codes[0, r]) and qf[qi, 1] in (-1, codes[1, r])]
        cands = {r: float(scores[qi, r]) for r in ok}
        lists = [block_list(cands, [64 * t for t in range(tiles * g // blocks,
                                                          tiles * (g + 1) // blocks)], k)
                 for g in range(blocks)]
        s, i = as_result(merge(lists, k))
        assert s.tobytes() == s_ref[qi].numpy().tobytes()
        assert i.tobytes() == i_ref[qi].numpy().tobytes()


@pytest.mark.parametrize("k", [33, 64, 100, 256, 1024])
@pytest.mark.parametrize("b", BATCHES)
def test_plans_for_k_above_a_round(k, b):
    """k above 32 takes ceil(k / 32) rounds of lists of 32: the grid, the
    ring and the shared memory are those of k 32, the scratch holds one
    round's lists (kernel 3's also the result's packed positions, read
    back as floors)."""
    for elt in (2, 1):
        one = ttk.topk_plan(b, 131_072, 384, elt, 32, H100_SMS)
        plan = ttk.topk_plan(b, 131_072, 384, elt, k, H100_SMS)
        assert plan.rounds == -(-k // 32) and one.rounds == 1
        assert plan[:5] == one[:5] and plan.scratch == one.scratch
        assert plan.candidates == plan.blocks * 32
        probe = probe_plan(b, 16_384, 128, 384, elt, k, H100_SMS)
        probe32 = probe_plan(b, 16_384, 128, 384, elt, 32, H100_SMS)
        assert probe.scratch == probe32.scratch + b * k and probe.rounds == plan.rounds


def rounds(lists_of, k: int) -> list:
    """The wrapper's rounds: round r runs the walk and the merge over the
    candidates that rank after round r - 1's last entry (its floor), with
    lists of min(32, k - 32 r); the rounds laid end to end."""
    out, floor = [], None
    for r0 in range(0, k, 32):
        kr = min(32, k - r0)
        entries = merge(lists_of(kr, floor), kr)
        out += entries
        floor = entries[-1]
    return out


def after(floor, cands: dict[int, float]) -> dict[int, float]:
    return cands if floor is None else {r: s for r, s in cands.items()
                                        if before(floor, (s, r))}


@pytest.mark.parametrize("blocks", [1, 5, 47, 300])
@pytest.mark.parametrize("k", [33, 64, 100])
def test_model_of_kernel_1_rounds_equals_plain(blocks, k):
    """Kernel 1 at k above 32, tie-heavy int8 rows: the rounds' result
    equals masked_topk_plain's bit for bit, ties in row order across the
    rounds' seams."""
    rng = np.random.default_rng(blocks * 100 + k)
    b, n, d, n_valid = 3, 3000, 64, 2990
    q, c = tie_heavy_int8(rng, b, d, 3), tie_heavy_int8(rng, n, d)
    codes = np.stack([rng.integers(0, 3, n), rng.integers(0, 2, n)]).astype(np.int32)
    codes[:, n_valid:] = -2
    qf = np.array([[-1, -1], [1, -1], [2, 0]], np.int32)
    s_ref, i_ref = ttk.masked_topk_plain(*(torch.from_numpy(a) for a in (q, c, codes, qf)),
                                         n_valid, k)
    scores = q.astype(np.int64) @ c.astype(np.int64).T
    tiles = -(-n // 64)
    shares = [[64 * t for t in range(tiles * g // blocks, tiles * (g + 1) // blocks)]
              for g in range(blocks)]
    for qi in range(b):
        ok = [r for r in range(n_valid)
              if qf[qi, 0] in (-1, codes[0, r]) and qf[qi, 1] in (-1, codes[1, r])]
        cands = {r: float(scores[qi, r]) for r in ok}
        s, i = as_result(rounds(
            lambda kr, floor: [block_list(after(floor, cands), mine, kr) for mine in shares], k))
        assert s.tobytes() == s_ref[qi].numpy().tobytes()
        assert i.tobytes() == i_ref[qi].numpy().tobytes()


@pytest.mark.parametrize("k", [33, 64, 100])
def test_model_of_kernel_3_rounds_equals_plain(k):
    """Kernel 3 at k above 32: floors are packed positions, mapped to gids
    only at the end, so ties keep packed order across the seams."""
    rng = np.random.default_rng(k)
    b, d, tile, n_tiles, blocks = 2, 64, 128, 12, 7
    n = n_tiles * tile
    emb = tie_heavy_int8(rng, n, d, 4)
    gids = rng.permutation(4 * n)[:n].astype(np.int32)
    gids[rng.random(n) < 0.3] = -1
    codes = np.stack([rng.integers(0, 2, n), rng.integers(0, 2, n)]).astype(np.int32)
    q = tie_heavy_int8(rng, b, d, 2)
    qf = np.array([[-1, -1], [1, -1]], np.int32)
    tile_ids = np.full(n_tiles, -1, np.int32)
    tile_ids[:9] = sorted(rng.choice(n_tiles, 9, replace=False))
    s_ref, i_ref = ivf_probe_plain(*(torch.from_numpy(a) for a in (
        q, qf, emb, codes, gids[None, :], tile_ids)), k, tile=tile)
    scores = q.astype(np.int64) @ emb.astype(np.int64).T
    pieces = [t * tile + 64 * p for t in tile_ids[:9] for p in range(tile // 64)]
    share = [pieces[len(pieces) * g // blocks: len(pieces) * (g + 1) // blocks]
             for g in range(blocks)]
    for qi in range(b):
        cands = {r: float(scores[qi, r]) for r in range(n) if gids[r] >= 0
                 and qf[qi, 0] in (-1, codes[0, r]) and qf[qi, 1] in (-1, codes[1, r])}
        s, i = as_result(rounds(
            lambda kr, floor: [block_list(after(floor, cands), mine, kr) for mine in share],
            k), gids)
        assert s.tobytes() == s_ref[qi].numpy().tobytes()
        assert i.tobytes() == i_ref[qi].numpy().tobytes()


@pytest.mark.parametrize("active", [0, 1, 9])
def test_model_of_kernel_3_equals_plain(active):
    """Kernel 3's walk: the active count found on the list, its tiles'
    64-row pieces dealt in even contiguous shares, padding-only pieces
    skipped, ids as packed positions mapped to gids at the end."""
    rng = np.random.default_rng(active)
    b, d, tile, n_tiles, k, blocks = 2, 64, 128, 12, 15, 7
    n = n_tiles * tile
    emb = tie_heavy_int8(rng, n, d, 4)
    gids = rng.permutation(4 * n)[:n].astype(np.int32)
    gids[rng.random(n) < 0.3] = -1
    gids[2 * tile + 64: 3 * tile] = -1  # a padding-only piece
    codes = np.stack([rng.integers(0, 2, n), rng.integers(0, 2, n)]).astype(np.int32)
    q = tie_heavy_int8(rng, b, d, 2)
    qf = np.array([[-1, -1], [1, -1]], np.int32)
    tile_ids = np.full(n_tiles, -1, np.int32)
    tile_ids[:active] = sorted(rng.choice(n_tiles, active, replace=False))
    s_ref, i_ref = ivf_probe_plain(*(torch.from_numpy(a) for a in (
        q, qf, emb, codes, gids[None, :], tile_ids)), k, tile=tile)
    scores = q.astype(np.int64) @ emb.astype(np.int64).T
    pieces = [t * tile + 64 * p for t in tile_ids[:active] for p in range(tile // 64)]
    share = [pieces[len(pieces) * g // blocks: len(pieces) * (g + 1) // blocks]
             for g in range(blocks)]
    for qi in range(b):
        cands = {r: float(scores[qi, r]) for r in range(n) if gids[r] >= 0
                 and qf[qi, 0] in (-1, codes[0, r]) and qf[qi, 1] in (-1, codes[1, r])}
        live = [[p for p in mine if (gids[p:p + 64] >= 0).any()] for mine in share]
        s, i = as_result(merge([block_list(cands, mine, k) for mine in live], k), gids)
        assert s.tobytes() == s_ref[qi].numpy().tobytes()
        assert i.tobytes() == i_ref[qi].numpy().tobytes()
