"""Kernels 1 and 3's host side, on the CPU: their launch plans, and numpy
models of the two ways the kernels select.

The kernels (``csrc/masked_topk.cu`` and ``csrc/ivf_probe.cu``, built from
``csrc/topk_common.cuh`` and ``csrc/topk_select.cuh``) run only on the card
(``tests/test_torch_kernels_cuda.py``).  What ``topk_plan`` and
``probe_plan`` decide for them is checked here for every width they take,
for batch sizes across query blocks and for corpus sizes from one row to
the IVF tier's million.  Up to k 32 the model walks the tiles the way a
plan deals them out, keeps each block's list the way a warp does
(threshold, then insert), merges the blocks' lists in rounds that drop a
list once its entry fails to enter, and must give the plain versions' top
k.  Above it the model of the select path writes the walk's score table
(64 columns a tile or piece, garbage where the walk writes nothing),
settles the threshold digit by digit from chunked histograms, collects the
survivors (those above the threshold's bin in any order, its ties by their
rank in column order from the chunks' counts), sorts them in runs and
merges the runs by rank, and must give the plain versions' top k bit for
bit.
"""

from __future__ import annotations

import bisect
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
SELECT = COMMON.with_name("topk_select.cuh")
ELEMENT = {torch.bfloat16: 2, torch.int8: 1}
# the widths at which two blocks share an SM in both types (at most
# WIDE_ABOVE_D values: bf16 rows of at most 2,048 bytes); wider rows take
# the wide kernel, WIDE_WIDTHS
WIDTHS = [(dtype, d) for dtype in ELEMENT for d in range(64, 1024 + 1, ttk.DIM_STEP[dtype])]
WIDE_WIDTHS = [(torch.bfloat16, d) for d in (1040, 1536, 2048, 3072, 3136)] + [
    (torch.int8, d) for d in (2048, 2080, 4096, 6272)]
# the wide kernel's widths whose shared memory is checked at every batch:
# the first wide bf16 width, D 1536 and the widest, in both types
WIDE_FITS = [(torch.bfloat16, d) for d in (1040, 1536, 2048, 3136)] + [
    (torch.int8, d) for d in (2080, 4096, 6272)]
BATCHES = (1, 33, 64)
NO_ID = 2**31 - 1


def cuh_constants(path: Path = COMMON) -> dict[str, int]:
    """The literal integer constants of ``csrc/topk_common.cuh`` (or of
    another header)."""
    text = path.read_text()
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
    assert c["kListK"] == ttk.LIST_K == 32
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


def carved_wide(row_bytes: int, stages: int, bufs: int) -> tuple[int, dict[str, int]]:
    """The wide kernel's carve (``carve_wide``): carve's regions with
    ``bufs`` score buffers and their full and empty barriers."""
    at, offsets = 0, {}
    for name, size in (("q", -(-row_bytes // 128) * 32 * 128), ("ring", stages * 64 * 128),
                       ("slots", ttk.SLOTS * ttk.SLOT_BYTES),
                       ("sc", 4 * bufs * 32 * ttk.SCORE_STRIDE),
                       ("bars", 8 * (2 * stages + 2 * ttk.SLOTS + 2 * bufs + 1))):
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
    """Rows of more than WIDE_ABOVE_D values take the wide kernel: one
    block an SM, and the ring the rest of its shared memory holds beside
    the query block and two score buffers, up to MAX_STAGES (one buffer
    where two would leave fewer than two stages: rows above 6,016 bytes);
    kernels 1 and 3 alike."""
    row_bytes = d * ELEMENT[dtype]
    assert d > ttk.WIDE_ABOVE_D
    for plan in (ttk.topk_plan(32, 131_072, d, ELEMENT[dtype], 15, H100_SMS),
                 probe_plan(32, 16_384, 128, d, ELEMENT[dtype], 15, H100_SMS)):
        bufs = 2 if row_bytes <= 6016 else 1
        room = (ttk.SMEM_LIMIT - carved_wide(row_bytes, 0, bufs)[0] - 16) // (64 * 128)
        assert plan.wide and plan.blocks == H100_SMS
        assert plan.stages == min(ttk.MAX_STAGES, room) >= 2
        assert ttk.wide_bufs(row_bytes, plan.stages) == bufs
        end, _ = carved_wide(row_bytes, plan.stages, bufs)
        assert end <= plan.smem == ttk.wide_smem(row_bytes, plan.stages) <= ttk.SMEM_LIMIT
    ttk.check_dims(d, d, dtype)


def test_wide_plan_constants_are_the_kernels():
    """The wide kernel's constants and rule as both kernels' sources hold
    them: rows of more than WIDE_ABOVE_D values in either type, sixteen
    selecting warps of two queries each, one scoring warpgroup, then the
    producer's warp; SCORE_BUFS score buffers."""
    c = cuh_constants()
    text = COMMON.read_text()
    assert c["kWideAboveD"] == ttk.WIDE_ABOVE_D == 1024
    assert c["kScBufs"] == ttk.SCORE_BUFS == 2 and c["kScoreWarps"] == 4
    assert c["kSelectors"] == 16 and c["kQB"] // c["kSelectors"] == 2
    for line in ("constexpr int kWideQPW = kQB / kSelectors;",
                 "constexpr int kWideProducer = kSelectors + kScoreWarps;",
                 "constexpr int kWideThreads = (kWideProducer + 1) * 32;"):
        assert line in text
    for name in ("masked_topk.cu", "ivf_probe.cu"):
        src = COMMON.with_name(name).read_text()
        assert "const bool wide = D > kWideAboveD;" in src
        assert "wide ? wide_smem_bytes(boxes_for(row_bytes), stages)" in src
    # the host's shared memory is the kernel's formula (carve_wide's
    # regions): smem_bytes' with `bufs` score buffers and their barriers
    formula = re.search(r"wide_smem_with\(int nbox, int stages, int bufs\) \{\n\s*return (.*?);",
                        text, re.S)[1]
    assert " ".join(formula.split()) == (
        "1024 + (size_t)nbox * kQBox + (size_t)stages * kBox + kSlots * kSlotBytes + "
        "sizeof(float) * bufs * kQB * kScStride + "
        "sizeof(uint64_t) * (2 * stages + 2 * kSlots + 2 * bufs + 1)")
    assert ttk.wide_smem_with(3072, 13, 2) == (1024 + 24 * 4096 + 13 * 8192 + 4 * 1152
                                               + 4 * 2 * 32 * 68 + 8 * (26 + 8 + 4 + 1))


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("dtype,d", WIDE_FITS)
def test_wide_plan_fits_the_card(dtype, d, b):
    """Every wide width at every batch, on both paths: the carve within a
    block's limit, TMA boxes 1024-aligned, at least two ring stages, one
    block an SM shared by the query blocks."""
    row_bytes = d * ELEMENT[dtype]
    for k in (15, 1024):
        plan = ttk.topk_plan(b, 131_072, d, ELEMENT[dtype], k, H100_SMS)
        bufs = ttk.wide_bufs(row_bytes, plan.stages)
        end, offsets = carved_wide(row_bytes, plan.stages, bufs)
        assert plan.wide and end <= plan.smem <= ttk.SMEM_LIMIT and plan.stages >= 2
        assert offsets["q"] % 1024 == 0 and offsets["ring"] % 1024 == 0
        assert offsets["slots"] % 128 == 0 and offsets["bars"] % 8 == 0
        assert plan.qblocks == -(-b // 32) and plan.blocks == H100_SMS // plan.qblocks
        assert plan.path == ("lists" if k <= ttk.LIST_K else "select")


@pytest.mark.parametrize("dtype", list(ELEMENT))
def test_rows_past_the_widest_are_refused(dtype):
    elt = ELEMENT[dtype]
    widest = ttk.MAX_ROW_BYTES // elt
    ttk.check_dims(widest, widest, dtype)
    assert ttk.topk_plan(32, 131_072, widest, elt, 15, H100_SMS).stages == 2
    wider = widest + ttk.DIM_STEP[dtype]
    with pytest.raises(ValueError, match="dims"):
        ttk.check_dims(wider, wider, dtype)
    with pytest.raises(ValueError, match="no ring stage"):
        ttk.plan_for(32, 2048, 2 * ttk.MAX_ROW_BYTES, 15, H100_SMS, wide=True)
    with pytest.raises(ValueError, match="no ring stage"):  # two blocks an SM
        ttk.plan_for(32, 2048, ttk.MAX_ROW_BYTES, 15, H100_SMS)


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



def exact_wide(rng, n, d, distinct, dtype):
    """Tie-heavy exact rows of d values (entries in -3..3) as the kernel
    takes them, and their integer values: int8 as they are, bf16 as v / 16
    (products and f32 sums exact, the score the integer one over 256)."""
    a = rng.integers(-3, 4, (distinct, d))[rng.integers(0, distinct, n)]
    return (torch.from_numpy(a.astype(np.int8)) if dtype == torch.int8
            else torch.from_numpy(a.astype(np.float32) / 16).bfloat16()), a


@pytest.mark.parametrize("k", [1, 15, 32])
@pytest.mark.parametrize("dtype", list(ELEMENT))
def test_model_of_the_wide_kernel_1_equals_plain(dtype, k):
    """The wide kernel at D 1536 deals tiles and keeps lists as the kernel
    of two blocks an SM does (its selecting warps take each tile's scores
    from the scoring warpgroup's buffer, in the walk's order): over the
    wide plan's 132 blocks (one an SM, a tile or two each), tie-heavy
    exact rows, the model's top k equals masked_topk_plain's bit for bit."""
    rng = np.random.default_rng(k)
    b, n, d, n_valid = 3, 9000, 1536, 8990
    plan = ttk.topk_plan(b, n, d, ELEMENT[dtype], k, H100_SMS)
    assert plan.wide and plan.blocks == H100_SMS
    (q, qi), (c, ci) = exact_wide(rng, b, d, 3, dtype), exact_wide(rng, n, d, 6, dtype)
    codes = np.stack([rng.integers(0, 3, n), rng.integers(0, 2, n)]).astype(np.int32)
    codes[:, n_valid:] = -2
    qf = np.array([[-1, -1], [1, -1], [2, 0]], np.int32)
    s_ref, i_ref = ttk.masked_topk_plain(q, c, torch.from_numpy(codes), torch.from_numpy(qf),
                                         n_valid, k)
    scale = 1.0 if dtype == torch.int8 else 1 / 256
    scores = (qi.astype(np.int64) @ ci.astype(np.int64).T) * scale
    for r in range(b):
        cands = {j: float(scores[r, j]) for j in range(n_valid)
                 if qf[r, 0] in (-1, codes[0, j]) and qf[r, 1] in (-1, codes[1, j])}
        lists = [block_list(cands, [64 * t for t in range(plan.tiles * g // plan.blocks,
                                                          plan.tiles * (g + 1) // plan.blocks)], k)
                 for g in range(plan.blocks)]
        s, i = as_result(merge(lists, k))
        assert s.tobytes() == s_ref[r].numpy().tobytes()
        assert i.tobytes() == i_ref[r].numpy().tobytes()


@pytest.mark.parametrize("k", [1, 15, 32])
@pytest.mark.parametrize("dtype", list(ELEMENT))
def test_model_of_the_wide_kernel_3_equals_plain(dtype, k):
    """Kernel 3 on the wide kernel at D 1536: the probe plan's 132 blocks
    take even contiguous shares of the active tiles' 64-row pieces,
    padding-only pieces skipped, ids packed positions mapped to gids at
    the end; the model equals ivf_probe_plain bit for bit."""
    rng = np.random.default_rng(100 + k)
    b, d, tile, n_tiles = 2, 1536, 128, 80
    n = n_tiles * tile
    plan = probe_plan(b, n_tiles, tile, d, ELEMENT[dtype], k, H100_SMS)
    assert plan.wide and plan.blocks == H100_SMS
    emb, ei = exact_wide(rng, n, d, 4, dtype)
    gids = rng.permutation(4 * n)[:n].astype(np.int32)
    gids[rng.random(n) < 0.3] = -1
    gids[2 * tile + 64: 3 * tile] = -1  # a padding-only piece
    codes = np.stack([rng.integers(0, 2, n), rng.integers(0, 2, n)]).astype(np.int32)
    q, qi = exact_wide(rng, b, d, 2, dtype)
    qf = np.array([[-1, -1], [1, -1]], np.int32)
    tile_ids = np.full(n_tiles, -1, np.int32)
    active = 70
    tile_ids[:active] = sorted(rng.choice(n_tiles, active, replace=False))
    s_ref, i_ref = ivf_probe_plain(q, torch.from_numpy(qf), emb, *(torch.from_numpy(a) for a in (
        codes, gids[None, :], tile_ids)), k, tile=tile)
    scale = 1.0 if dtype == torch.int8 else 1 / 256
    scores = (qi.astype(np.int64) @ ei.astype(np.int64).T) * scale
    pieces = [t * tile + 64 * p for t in tile_ids[:active] for p in range(tile // 64)]
    share = [pieces[len(pieces) * g // plan.blocks: len(pieces) * (g + 1) // plan.blocks]
             for g in range(plan.blocks)]
    for r in range(b):
        cands = {j: float(scores[r, j]) for j in range(n) if gids[j] >= 0
                 and qf[r, 0] in (-1, codes[0, j]) and qf[r, 1] in (-1, codes[1, j])}
        live = [[p for p in mine if (gids[p:p + 64] >= 0).any()] for mine in share]
        s, i = as_result(merge([block_list(cands, mine, k) for mine in live], k), gids)
        assert s.tobytes() == s_ref[r].numpy().tobytes()
        assert i.tobytes() == i_ref[r].numpy().tobytes()


# -- the select path above k 32 (csrc/topk_select.cuh) -------------------------

KEY_NEG_INF = 0x007FFFFF


def select_constants(b: int, n: int) -> dict[str, int]:
    """The kernel's constants, and its sweeping blocks a query for b
    queries over n table columns (the walk's grid from topk_plan)."""
    c = cuh_constants(SELECT)
    walk = ttk.topk_plan(b, n, 64, 1, 15, H100_SMS)
    return {"bits": c["kDigitBits"], "chunk": c["kChunk"], "cap": c["kSortCap"],
            "sweeps": ttk.select_sweeps(b, n, walk.blocks * walk.qblocks)}


# small constants that give a few thousand columns many chunks, uneven
# shares of them, several runs and four digits of 8 bits
SMALL = {"bits": 8, "chunk": 256, "cap": 64, "sweeps": 5}
SELECT_CONSTS = ["kernel", "small"]


def test_select_constants_are_the_kernels():
    c = cuh_constants(SELECT)
    assert (c["kDigitBits"], c["kChunk"], c["kSortCap"]) == (
        ttk.DIGIT_BITS, ttk.SELECT_CHUNK, ttk.SORT_CAP)
    assert (c["kStateWords"], c["kSweepsAnSm"]) == (ttk.STATE_WORDS, ttk.SWEEPS_AN_SM)
    text = SELECT.read_text()
    assert "constexpr int kBins = 1 << kDigitBits;" in text
    assert "constexpr int kLastBits = 32 - kDigitBits * (31 / kDigitBits);" in text
    assert ttk.LAST_BITS == 10
    assert c["kChunk"] % (4 * c["kSelThreads"]) == 0 and c["kSortCap"] % c["kSortThreads"] == 0


def order_keys(scores: np.ndarray) -> np.ndarray:
    """The kernel's order_key: f32 to a u32 of the same order, -0 as +0."""
    u = np.where(scores == 0, np.float32(0), scores).astype(np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def shares(n_cols: int, chunk: int, sweeps: int) -> list[slice]:
    """Each sweeping block's columns: an even contiguous share of the
    chunks the walk scored (my_chunks)."""
    chunks = -(-n_cols // chunk)
    return [slice(chunk * (chunks * g // sweeps), chunk * (chunks * (g + 1) // sweeps))
            for g in range(sweeps)]


def settle(keys, scored, k: int, bits: int, blocks: list[slice]):
    """The digit passes over one query's table row: each block's histogram
    of the next digit of the finite keys under the prefix, summed, and the
    bin where the count from the top reaches the entries still wanted.
    Returns (depth, prefix, above, ties, bin count) and the blocks'
    histograms of the last digit's pass, if it ran."""
    fin = scored & (keys != KEY_NEG_INF)
    depth = prefix = above = 0
    while True:
        width = min(bits, 32 - depth)
        shift = 32 - depth - width
        under = fin if depth == 0 else fin & ((keys >> np.uint32(32 - depth)) == prefix)
        digit = (keys >> np.uint32(shift)) & np.uint32((1 << width) - 1)
        own = [np.bincount(digit[part][under[part]], minlength=1 << width) for part in blocks]
        hist = np.sum(own, axis=0)
        need = k - above
        if hist.sum() < need:  # fewer finite scores than wanted: all of them
            return (32, KEY_NEG_INF, above + int(hist.sum()), 0, 0), None
        acc = 0
        for b in range((1 << width) - 1, -1, -1):
            if acc + hist[b] >= need:
                break
            acc += int(hist[b])
        above, prefix, depth = above + acc, (prefix << width) | b, depth + width
        rem = need - acc
        if depth == 32 or rem == hist[b]:
            return (depth, prefix, above, rem, int(hist[b])), own if depth == 32 else None


def before_key(e) -> tuple[int, int]:
    """(key desc, column asc) as an ascending sort key."""
    return (-int(e[0]), int(e[1]))


def select_row(row, scored, n_cols: int, k: int, consts: dict, rng) -> list:
    """One query of the select path over its table row (garbage where not
    scored; the walk scored n_cols columns): the threshold, the survivors
    (those above its bin in a random order, as the atomics place them; its
    ties by their rank in column order from the blocks' last-digit
    histograms), sorted in runs of `cap` and merged by rank.  Returns the
    sorted (key, column) survivors."""
    bits, cap = consts["bits"], consts["cap"]
    blocks = shares(n_cols, consts["chunk"], consts["sweeps"])
    keys = order_keys(np.where(scored, row, -np.inf).astype(np.float32))
    (depth, prefix, above, ties, held), last = settle(keys, scored, k, bits, blocks)
    fin = scored & (keys != KEY_NEG_INF)
    hi = keys >> np.uint32(32 - depth)
    ordered, whole = 0 < ties < held, 0 < ties == held
    up = np.flatnonzero(fin & ((hi > prefix) | (whole & (hi == prefix))))
    tie = fin & ordered & (hi == prefix)
    assert up.size == above + (ties if whole else 0)
    surv = [None] * (above + ties)
    for slot, col in zip(range(up.size), rng.permutation(up)):
        surv[slot] = (keys[col], col)
    if ordered:  # only a full key splits a bin: T's own count in each block before
        tb = prefix & ((1 << (32 - (32 - 1) // bits * bits)) - 1)
        for g, part in enumerate(blocks):
            start = sum(int(h[tb]) for h in last[:g])
            assert int(last[g][tb]) == int(tie[part].sum())
            for r, col in enumerate(np.flatnonzero(tie[part]) + part.start, start):
                if r < ties:
                    surv[above + r] = (keys[col], col)
    assert all(e is not None for e in surv)
    runs = [sorted(surv[r0:r0 + cap], key=before_key) for r0 in range(0, len(surv), cap)]
    while len(runs) > 1:  # pairwise merges: an entry's place is its index plus its rank
        merged = []
        for a, b in zip(runs[0::2], runs[1::2] + [[]]):
            ka, kb = [before_key(e) for e in a], [before_key(e) for e in b]
            out = [None] * (len(a) + len(b))
            for mine, keys_mine, keys_other in ((a, ka, kb), (b, kb, ka)):
                for i, e in enumerate(mine):
                    out[i + bisect.bisect_left(keys_other, keys_mine[i])] = e
            merged.append(out)
        runs = merged
    return runs[0] if runs else []


def emit(entries, row, k: int, id_of):
    """The result: scores read back from the table row, ids by `id_of`,
    then -inf / -1."""
    s = np.full(k, -np.inf, np.float32)
    i = np.full(k, -1, np.int32)
    for j, (_, col) in enumerate(entries):
        s[j], i[j] = row[col], id_of(col)
    return s, i


def flat_table(scores, ok, n: int):
    """Kernel 1's walk: a row a query of 64 columns a tile, -inf where a row
    is not a candidate (rows past N too); every column scored."""
    cols = -(-n // 64) * 64
    table = np.full((scores.shape[0], cols), -np.inf, np.float32)
    table[:, :n] = np.where(ok, scores, -np.inf)
    return table, np.ones(cols, bool), cols


FILTERS = {"straddle": [[-1, -1], [1, -1], [2, 0]],
           "few": [[0, -1], [1, -1], [-1, 1]]}


def select_flat_case(case: str, k: int, seed: int):
    """Tie-heavy int8 rows (six distinct vectors, so ties straddle every
    threshold) under three filters: `straddle` (n_valid below N), `few`
    (tickers on 10 and 700 rows: fewer rows than k), `k_eq_n` (N = k) and
    `k_gt_n` (N = k // 2 + 5)."""
    rng = np.random.default_rng(seed)
    n = {"k_eq_n": k, "k_gt_n": k // 2 + 5}.get(case, 3000)
    n_valid = n - 10 if case == "straddle" else n
    b, d = 3, 64
    q, c = tie_heavy_int8(rng, b, d, 3), tie_heavy_int8(rng, n, d)
    codes = np.stack([rng.integers(0, 3, n), rng.integers(0, 2, n)]).astype(np.int32)
    if case == "few":
        codes[0] = 2
        codes[0, rng.choice(n, 710, replace=False)] = [0] * 10 + [1] * 700
    codes[:, n_valid:] = -2
    qf = np.array(FILTERS.get(case, [[-1, -1]] * 3), np.int32)
    return q, c, codes, qf, n_valid


@pytest.mark.parametrize("consts", list(SELECT_CONSTS))
@pytest.mark.parametrize("case", ["straddle", "few", "k_eq_n", "k_gt_n"])
@pytest.mark.parametrize("k", [33, 100, 1024, 2048])
def test_select_model_of_kernel_1_equals_plain(k, case, consts):
    """Kernel 1 above k 32, tie-heavy int8 rows: the select path's model
    gives masked_topk_plain's scores and ids bit for bit, with ties
    straddling the threshold, filters that leave fewer than k rows, and k
    equal to or above N."""
    q, c, codes, qf, n_valid = select_flat_case(case, k, seed=k)
    n = c.shape[0]
    s_ref, i_ref = ttk.masked_topk_plain(*(torch.from_numpy(a) for a in (q, c, codes, qf)),
                                         n_valid, k)
    scores = (q.astype(np.int64) @ c.astype(np.int64).T).astype(np.float32)
    ok = (np.arange(n) < n_valid) & ((qf[:, :1] == -1) | (qf[:, :1] == codes[0])) & (
        (qf[:, 1:] == -1) | (qf[:, 1:] == codes[1]))
    table, scored, n_cols = flat_table(scores, ok, n)
    rng = np.random.default_rng(k + 1)
    const = SMALL if consts == "small" else select_constants(q.shape[0], n_cols)
    for qi in range(q.shape[0]):
        entries = select_row(table[qi], scored, n_cols, k, const, rng)
        s, i = emit(entries, table[qi], k, int)
        assert s.tobytes() == s_ref[qi].numpy().tobytes()
        assert i.tobytes() == i_ref[qi].numpy().tobytes()
    if case == "few":
        assert np.isfinite(s_ref[0].numpy()).sum() == min(10, k)


def probe_table(scores, ok, gids, tile_ids, tile: int):
    """Kernel 3's walk: 64 columns a piece of the active tiles in list
    order, the table's width the whole list's; garbage (1e30) where the
    walk writes nothing (pieces of padding only, columns past the active
    pieces), each piece's first packed position (-1 for those) and the
    columns of the active pieces."""
    per = tile // 64
    active = int((tile_ids >= 0).sum())
    cols = tile_ids.size * tile
    table = np.full((scores.shape[0], cols), 1e30, np.float32)
    scored = np.zeros(cols, bool)
    pieces = np.full(cols // 64, -1, np.int64)
    for p in range(active * per):
        base = int(tile_ids[p // per]) * tile + (p % per) * 64
        if (gids[base:base + 64] >= 0).any():
            pieces[p] = base
            rows = np.arange(base, base + 64)
            table[:, 64 * p:64 * p + 64] = np.where(ok[:, rows], scores[:, rows], -np.inf)
            scored[64 * p:64 * p + 64] = True
    return table, scored, pieces, 64 * active * per


@pytest.mark.parametrize("consts", list(SELECT_CONSTS))
@pytest.mark.parametrize("which", ["some", "all"])
@pytest.mark.parametrize("k", [33, 100, 1024, 2048])
def test_select_model_of_kernel_3_equals_plain(k, which, consts):
    """Kernel 3 above k 32: columns in the probe list's order, pieces of
    padding only left unwritten, gids unrelated to packed order and mapped
    only when written: bit for bit with ivf_probe_plain on tie-heavy int8
    rows (k 2048 above the 1,536 probed rows of `some`)."""
    rng = np.random.default_rng(k + (which == "all"))
    b, d, tile, n_tiles = 3, 64, 128, 24
    n = n_tiles * tile
    emb = tie_heavy_int8(rng, n, d, 4)
    gids = rng.permutation(4 * n)[:n].astype(np.int32)
    gids[rng.random(n) < 0.3] = -1
    gids[2 * tile + 64: 3 * tile] = -1  # a padding-only piece
    codes = np.stack([rng.integers(0, 2, n), rng.integers(0, 2, n)]).astype(np.int32)
    q = tie_heavy_int8(rng, b, d, 2)
    qf = np.array([[-1, -1], [1, -1], [0, 1]], np.int32)
    active = n_tiles if which == "all" else 12
    tile_ids = np.full(n_tiles + 3, -1, np.int32)
    tile_ids[:active] = sorted(rng.choice(n_tiles, active, replace=False))
    s_ref, i_ref = ivf_probe_plain(*(torch.from_numpy(a) for a in (
        q, qf, emb, codes, gids[None, :], tile_ids)), k, tile=tile)
    scores = (q.astype(np.int64) @ emb.astype(np.int64).T).astype(np.float32)
    ok = (gids >= 0) & ((qf[:, :1] == -1) | (qf[:, :1] == codes[0])) & (
        (qf[:, 1:] == -1) | (qf[:, 1:] == codes[1]))
    table, scored, pieces, n_cols = probe_table(scores, ok, gids, tile_ids, tile)
    gid_of = lambda col: gids[pieces[col // 64] + col % 64]  # noqa: E731
    rng = np.random.default_rng(k)
    const = SMALL if consts == "small" else select_constants(b, table.shape[1])
    for qi in range(b):
        entries = select_row(table[qi], scored, n_cols, k, const, rng)
        s, i = emit(entries, table[qi], k, gid_of)
        assert s.tobytes() == s_ref[qi].numpy().tobytes()
        assert i.tobytes() == i_ref[qi].numpy().tobytes()


@pytest.mark.parametrize("exact", ["int8", "bf16"])
@pytest.mark.parametrize("k", [100, 1024])
def test_select_model_matches_xla(k, exact):
    """The select path's model against the JAX package's masked_topk_xla
    wherever the score is finite, on exact rows (int8, and bf16 values v /
    16 whose f32 sums are exact in any order)."""
    import jax.numpy as jnp

    from financial_rag_system_tpu.ops.topk import masked_topk_xla

    q, c, codes, qf, n_valid = select_flat_case("straddle", k, seed=k + 7)
    if exact == "bf16":
        q, c = (torch.from_numpy(a.astype(np.float32) / 16).bfloat16() for a in (q, c))
        scores = (q.float() @ c.float().T).numpy()
        jq, jc = (jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in (q, c))
    else:
        scores = (q.astype(np.int64) @ c.astype(np.int64).T).astype(np.float32)
        jq, jc = jnp.asarray(q), jnp.asarray(c)
    n = c.shape[0]
    ok = (np.arange(n) < n_valid) & ((qf[:, :1] == -1) | (qf[:, :1] == codes[0])) & (
        (qf[:, 1:] == -1) | (qf[:, 1:] == codes[1]))
    table, scored, n_cols = flat_table(scores, ok, n)
    s_x, i_x = (np.asarray(a) for a in masked_topk_xla(jq, jc, jnp.asarray(codes),
                                                       jnp.asarray(qf), n_valid, k))
    rng = np.random.default_rng(0)
    for qi in range(q.shape[0]):
        s, i = emit(select_row(table[qi], scored, n_cols, k, select_constants(3, n_cols), rng),
                    table[qi], k, int)
        fin = np.isfinite(s_x[qi])
        assert (np.isfinite(s) == fin).all()
        assert s[fin].tobytes() == s_x[qi][fin].astype(np.float32).tobytes()
        assert (i[fin] == i_x[qi][fin]).all()


@pytest.mark.parametrize("k", [1, 15, 32, 33, 64, 2048])
def test_plan_path_by_k(k):
    """Lists up to k 32 (the main paths' plans, unchanged), the select path
    above, on the same walk: grid, ring and shared memory."""
    for plan_at in (lambda kk: ttk.topk_plan(32, 131_072, 384, 2, kk, H100_SMS),
                    lambda kk: probe_plan(32, 16_384, 128, 384, 1, kk, H100_SMS)):
        plan = plan_at(k)
        assert plan.path == ("lists" if k <= ttk.LIST_K else "select")
        assert plan[:5] == plan_at(32)[:5]
        if plan.path == "lists":
            assert (plan.candidates, plan.scratch) == (plan.blocks * k, 2 * 32 * k * plan.blocks)
            assert (plan.cols, plan.sweeps, plan.runs) == (0, 0, 0)
        else:
            assert plan.candidates == 0 and plan.cols == plan.tiles * 64


@pytest.mark.parametrize("k", [33, 1024, 2048, 5000])
@pytest.mark.parametrize("b", BATCHES)
def test_select_plan_scratch(k, b):
    """The select path's scratch, region by region as carve_select lays it
    out: the (b, cols) f32 table; histograms of 2^11 bins, 8 state words a
    query and the column count; each sweeping block's histogram of the
    10-bit last digit; the (b, k) survivors, twice past one run of 4,096;
    kernel 3's piece table.  The sweeping blocks: 8 an SM over the walk's
    two an SM, at most a chunk of 4,096 columns each."""
    def r4(w):
        return -(-w // 4) * 4

    for n in (3000, 131_072, 1_048_580):
        plan = ttk.topk_plan(b, n, 384, 2, k, H100_SMS)
        cols = -(-n // 64) * 64
        sweeps = min(-(-cols // 4096), -(-4 * plan.blocks * plan.qblocks // b))
        runs = -(-k // 4096)
        assert (plan.cols, plan.sweeps, plan.runs) == (cols, sweeps, runs)
        assert plan.scratch == (b * cols + r4(b * (2048 + 8) + 1) + r4(b * sweeps * 1024)
                                + 2 * b * k * (2 if runs > 1 else 1))
    probe = probe_plan(b, 2048, 128, 384, 1, k, H100_SMS)
    cols = 2048 * 128
    assert probe.cols == cols and probe.sweeps == min(64, -(-4 * 2 * H100_SMS // b))
    assert probe.scratch == ttk.select_scratch(b, cols, k, probe.sweeps) + r4(cols // 64)


def test_select_scratch_at_the_large_k_shapes():
    """B 32, k 1024: 21.5 MB at 131,072 rows (16.8 MB of it the table,
    4.3 MB the 33 sweeping blocks' last-digit histograms a query), 139.1
    MB at 1,048,580; kernel 3 over phase 2's list of 2,048 tiles of 128
    rows, 38.4 MB."""
    mb = [4 * p.scratch / 1e6 for p in (ttk.topk_plan(32, 131_072, 384, 2, 1024, H100_SMS),
                                        ttk.topk_plan(32, 1_048_580, 384, 2, 1024, H100_SMS),
                                        probe_plan(32, 2048, 128, 384, 2, 1024, H100_SMS))]
    assert [round(x, 1) for x in mb] == [21.5, 139.1, 38.4]
