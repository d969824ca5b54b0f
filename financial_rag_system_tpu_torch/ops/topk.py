"""Fused masked similarity + top-k — the retrieval hot kernel.

Port of ``financial_rag_system_tpu/ops/topk.py``: cosine scores of a
query batch against the device-resident corpus, the metadata filter as a
mask, and top-k selection, with the semantics of ``masked_topk_xla``
plus the Pallas kernel's tie rule (equal scores go to the lower row id).

- :func:`masked_topk` is the entry point.  On a CUDA tensor it launches
  the hand-written kernel ``csrc/masked_topk.cu`` (or raises), on the
  plan :func:`topk_plan` makes; on a CPU tensor it runs
  :func:`masked_topk_plain`.
- :func:`masked_topk_plain` is the same function in plain PyTorch: f32
  sums of the products, the mask, and a stable descending sort, so ties
  keep ascending row order.

A corpus is bf16 or int8 (``FlatIndex(dtype=torch.int8)``: symmetric
quantization of unit rows, ``round(v * 127)``), with queries of the same
type.  An int8 score is the integer dot product cast to f32 once, as
JAX's int8 x int8 -> int32 -> f32: the kernel sums in s32, the plain
version in f64, both exact (|sum| <= 127^2 * D), so the two agree bit for
bit on the CPU and the card.  Up to D 1040 (127^2 * D < 2^24) the cast
is exact too; above it, it rounds to the nearest f32.  The int8 branch
counts its launches in ``masked_topk.launches_int8``.

Any k runs, and any D of at most ``MAX_ROW_BYTES`` bytes a row: 3,136
bf16 or 6,272 int8 values.  Up to ``LIST_K`` the kernel keeps best lists
(the main paths' k 15); above it, the same walk writes the masked scores
to a table in device memory and an exact threshold selection finds the
top k there (``csrc/topk_select.cuh``; counted in
``masked_topk.launches_select``, either type).  Rows of more than
``WIDE_ABOVE_D`` values (bf16 rows above 2,048 bytes, int8 rows above
1,024) take the wide kernel, one block an SM whose scoring warpgroup
scores each tile on ``wgmma`` while its selecting warps select from the
tile before (``csrc/topk_common.cuh``; counted in
``masked_topk.launches_wide``, either type and path).

Filter encoding: each corpus row carries int32 ``[ticker_code,
doc_type_code]``; each query carries required codes where ``-1`` means
wildcard.  Padding rows use code ``-2`` and are also masked by
``n_valid``.  Empty slots come out as score ``-inf`` and id ``-1``.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from financial_rag_system_tpu_torch.ops import _cuda

NEG_INF = float("-inf")
LIST_K = 32  # the largest k kernels 1 and 3 keep lists for (csrc/topk_common.cuh kListK)
MAX_ROW_BYTES = 6272  # 49 boxes of 128 bytes: the query block's, in shared memory
# D must be a multiple of one tensor-core step: m16n8k16 (bf16), m16n8k32 (int8)
DIM_STEP = {torch.bfloat16: 16, torch.int8: 32}

# the kernels' block layout (csrc/topk_common.cuh)
QUERY_BLOCK = 32     # queries a block
TILE_ROWS = 64       # rows a tile (kernel 3: a piece of a probed tile)
BOX_BYTES = 128      # bytes of a row in one TMA box (128-byte swizzle)
SLOTS, SLOT_BYTES = 4, 1152   # tile slots: codes, gids, position
SCORE_STRIDE = TILE_ROWS + 4  # floats a query's row of a tile's scores
MAX_STAGES = 16
MAX_BLOCKS = 384     # pass 2: 4 warps a query, 3 lists a lane
SMEM_LIMIT = 232_448          # dynamic shared memory a block may take
SM_SMEM = 233_472             # shared memory of an SM, 1 KB of it a block's
# the plan's defaults: ring stages (boxes of 64 rows x 128 bytes) and blocks an SM
TOPK_STAGES = 8
TOPK_PER_SM = 2
# the wide kernel (csrc/topk_common.cuh): rows of more than WIDE_ABOVE_D
# values, either type, one block an SM; SCORE_BUFS score buffers, one
# where two would leave the ring a single stage
WIDE_ABOVE_D = 1024
SCORE_BUFS = 2
# the select path above LIST_K (csrc/topk_select.cuh)
DIGIT_BITS = 11        # bits of the order key a digit pass settles: 11, 11, 10
LAST_BITS = 32 - DIGIT_BITS * (31 // DIGIT_BITS)  # the last digit's
SELECT_CHUNK = 4096    # score-table columns a block of the passes over the table loads at once
SWEEPS_AN_SM = 8       # blocks of the passes over the table an SM holds
SORT_CAP = 4096        # survivors one block sorts in shared memory; more merge in runs
STATE_WORDS = 8        # a query's selection state


def _check_dtype(corpus: torch.Tensor) -> None:
    if corpus.dtype not in DIM_STEP:
        raise ValueError(f"masked_topk takes a bf16 or int8 corpus, got {corpus.dtype}")


def check_dims(d: int, d_corpus: int, dtype: torch.dtype) -> None:
    """Raise unless query and corpus rows are both D wide, D a multiple of
    the dtype's tensor-core step and its rows at most MAX_ROW_BYTES (the
    kernels' rule)."""
    step = DIM_STEP[dtype]
    elt = torch.empty((), dtype=dtype).element_size()
    if d_corpus != d or d % step or d * elt > MAX_ROW_BYTES:
        raise ValueError(f"dims: queries {d}, corpus {d_corpus} "
                         f"({step} | D <= {MAX_ROW_BYTES // elt} for {dtype})")


def _scores(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(B, N) f32 scores of the kernels: bf16 products summed in f32, or
    int8 products summed exactly (f64 holds every sum) and cast to f32
    once, as the kernels' s32 sums are."""
    if rows.dtype == torch.int8:
        return (queries.to(torch.int8).double() @ rows.double().T).float()
    return queries.to(rows.dtype).float() @ rows.float().T


def _match_mask(codes: torch.Tensor, query_filter: torch.Tensor) -> torch.Tensor:
    """(B, N) bool — row passes the query's metadata filter."""
    tick_q, dt_q = query_filter[:, 0:1], query_filter[:, 1:2]
    tick_c, dt_c = codes[0:1, :], codes[1:2, :]
    return ((tick_q == -1) | (tick_q == tick_c)) & ((dt_q == -1) | (dt_q == dt_c))


def masked_topk_plain(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    codes: torch.Tensor,
    query_filter: torch.Tensor,
    n_valid: int,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version. queries (B, D), corpus (N, D), codes (2, N)."""
    _check_dtype(corpus)
    scores = _scores(queries, corpus)
    n = corpus.shape[0]
    valid = torch.arange(n, device=corpus.device)[None, :] < int(n_valid)
    mask = _match_mask(codes, query_filter) & valid
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    kk = min(k, n)
    top_s, order = torch.sort(scores, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :kk], order[:, :kk].to(torch.int32)
    if kk < k:
        b = scores.shape[0]
        top_s = torch.cat([top_s, top_s.new_full((b, k - kk), NEG_INF)], dim=1)
        top_i = torch.cat([top_i, top_i.new_full((b, k - kk), -1)], dim=1)
    top_i = torch.where(torch.isfinite(top_s), top_i, torch.full_like(top_i, -1))
    return top_s, top_i


class TopkPlan(NamedTuple):
    blocks: int      # persistent blocks a query block (pass 2's lists a query)
    qblocks: int     # query blocks of 32
    stages: int      # ring stages, a box of 64 rows x 128 bytes each
    smem: int        # bytes of dynamic shared memory a block takes
    tiles: int       # 64-row tiles dealt out (kernel 3: pieces of every entry, at most)
    candidates: int  # entries of the blocks' lists pass 2 may read a query (0: select path)
    scratch: int     # int32 words of scratch: the lists, or the select path's table and more
    cols: int        # select path: score-table columns a query, 64 a tile (0: lists)
    sweeps: int      # select path: blocks a query of the digit and collect passes
    runs: int        # select path: runs of SORT_CAP survivors, sorted apart then merged
    wide: bool = False  # the wide kernel (rows of more than WIDE_ABOVE_D values)

    @property
    def path(self) -> str:
        """``lists`` (k <= LIST_K: pass 1 and the merge) or ``select``."""
        return "select" if self.cols else "lists"


def _round4(words: int) -> int:
    return -(-words // 4) * 4


def select_sweeps(b: int, cols: int, walk_blocks: int) -> int:
    """Blocks a query of the passes over the score table (``select_sweeps``
    in ``csrc/topk_select.cuh``): SWEEPS_AN_SM an SM over the SMs of the
    walk's grid (two an SM), at most a chunk of SELECT_CHUNK columns each."""
    fill = -(-SWEEPS_AN_SM // 2 * walk_blocks // b)
    return min(-(-cols // SELECT_CHUNK), max(fill, 1))


def select_scratch(b: int, cols: int, k: int, sweeps: int, ivf: bool = False) -> int:
    """int32 words of scratch the select path takes (``select_words`` in
    ``csrc/topk_select.cuh``): the (b, cols) f32 score table; the
    histograms, the state and the column count; each sweeping block's
    histogram of the last digit; the (b, k) survivors, twice when they
    sort in more than one run; kernel 3's first packed position of each
    64-row piece."""
    runs = -(-k // SORT_CAP)
    return (b * cols + _round4(b * ((1 << DIGIT_BITS) + STATE_WORDS) + 1)
            + _round4(b * sweeps << LAST_BITS) + 2 * b * k * (2 if runs > 1 else 1)
            + (_round4(cols // TILE_ROWS) if ivf else 0))


def topk_smem(row_bytes: int, stages: int) -> int:
    """Bytes of dynamic shared memory a block of kernel 1 or 3 takes
    (``smem_bytes`` in ``csrc/topk_common.cuh``): alignment, the query
    block's boxes, the ring, the tile slots, two tiles' scores and the
    mbarriers."""
    boxes = -(-row_bytes // BOX_BYTES)
    return (1024 + boxes * QUERY_BLOCK * BOX_BYTES + stages * TILE_ROWS * BOX_BYTES
            + SLOTS * SLOT_BYTES + 4 * 2 * QUERY_BLOCK * SCORE_STRIDE
            + 8 * (2 * stages + 2 * SLOTS + 1))


def wide_smem_with(row_bytes: int, stages: int, bufs: int) -> int:
    """Bytes of dynamic shared memory a block of the wide kernel takes with
    ``bufs`` score buffers (``wide_smem_with`` in ``csrc/topk_common.cuh``):
    ``topk_smem``'s regions with ``bufs`` buffers in place of two, and
    their full and empty barriers."""
    boxes = -(-row_bytes // BOX_BYTES)
    return (1024 + boxes * QUERY_BLOCK * BOX_BYTES + stages * TILE_ROWS * BOX_BYTES
            + SLOTS * SLOT_BYTES + 4 * bufs * QUERY_BLOCK * SCORE_STRIDE
            + 8 * (2 * stages + 2 * SLOTS + 2 * bufs + 1))


def wide_bufs(row_bytes: int, stages: int) -> int:
    """The wide kernel's score buffers (``wide_bufs``): SCORE_BUFS where
    they fit beside the ring, else one."""
    return SCORE_BUFS if wide_smem_with(row_bytes, stages, SCORE_BUFS) <= SMEM_LIMIT else 1


def wide_smem(row_bytes: int, stages: int) -> int:
    """Bytes of dynamic shared memory a block of the wide kernel takes
    (``wide_smem_bytes``)."""
    return wide_smem_with(row_bytes, stages, wide_bufs(row_bytes, stages))


def wide_room(row_bytes: int) -> int:
    """Ring stages the wide kernel's block holds beside the query block:
    with SCORE_BUFS buffers, or with one where that leaves fewer than two
    (rows above 6,016 bytes)."""
    def room(bufs: int) -> int:
        return (SMEM_LIMIT - wide_smem_with(row_bytes, 0, bufs)) // (TILE_ROWS * BOX_BYTES)
    return room(SCORE_BUFS) if room(SCORE_BUFS) >= 2 else room(1)


def plan_for(b: int, tiles: int, row_bytes: int, k: int, sms: int,
             per_sm: int = TOPK_PER_SM, stages: int | None = None,
             ivf: bool = False, wide: bool = False) -> TopkPlan:
    """The launch of kernel 1 or 3 for ``b`` queries over ``tiles`` 64-row
    tiles of ``row_bytes`` bytes a row, on a card of ``sms`` multiprocessors:
    ``per_sm`` blocks an SM shared by the query blocks, never more blocks
    than tiles or than pass 2 merges, each with as many ring stages as its
    share of the SM's shared memory holds, up to ``stages`` (TOPK_STAGES
    by default: two blocks an SM keep three at D 1024 in bf16, eight at D
    384).  ``wide`` (rows of more than WIDE_ABOVE_D values, up to
    MAX_ROW_BYTES) plans the wide kernel: one block an SM, and the ring its
    shared memory holds beside the query block and the score buffers
    (``wide_room``: 13 stages at D 1536 in bf16, 2 at D 3136), up to
    ``stages`` (MAX_STAGES by default).  A k above LIST_K takes the select
    path: the same walk (grid, ring and shared memory) writes a table of
    64 columns a tile, which ``sweeps`` blocks a query pass over, and the
    survivors sort in ``runs`` runs (``ivf``: kernel 3's scratch also maps
    its pieces)."""
    qblocks = -(-b // QUERY_BLOCK)
    if wide:
        per_sm = 1
        n_stages = min(stages or MAX_STAGES, MAX_STAGES, wide_room(row_bytes))
        smem = wide_smem(row_bytes, n_stages)
    else:
        budget = min(SM_SMEM // per_sm - 1024, SMEM_LIMIT)
        room = (budget - topk_smem(row_bytes, 0)) // (TILE_ROWS * BOX_BYTES)
        n_stages = min(stages or TOPK_STAGES, MAX_STAGES, room)
        smem = topk_smem(row_bytes, n_stages)
    if n_stages < 1:
        raise ValueError(f"rows of {row_bytes} bytes leave no ring stage "
                         f"(at most {MAX_ROW_BYTES})")
    blocks = max(1, min(tiles, sms * per_sm // qblocks, MAX_BLOCKS))
    walk = (blocks, qblocks, n_stages, smem, tiles)
    if k <= LIST_K:
        return TopkPlan(*walk, blocks * k, 2 * b * k * blocks, 0, 0, 0, wide)
    cols = tiles * TILE_ROWS
    sweeps = select_sweeps(b, cols, blocks * qblocks)
    return TopkPlan(*walk, 0, select_scratch(b, cols, k, sweeps, ivf), cols, sweeps,
                    -(-k // SORT_CAP), wide)


@functools.lru_cache(maxsize=256)
def topk_plan(b: int, n: int, d: int, elt: int, k: int, sms: int) -> TopkPlan:
    """Kernel 1's plan for ``b`` queries over ``n`` rows of ``d`` values of
    ``elt`` bytes: the 64-row tiles dealt out in contiguous shares (the
    wide kernel's above WIDE_ABOVE_D values)."""
    return plan_for(b, -(-n // TILE_ROWS), d * elt, k, sms, wide=d > WIDE_ABOVE_D)


@functools.cache
def _library():
    lib = _cuda.library("masked_topk")
    for fn in (lib.masked_topk, lib.masked_topk_s8):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    return lib


def masked_topk_cuda(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    codes: torch.Tensor,
    query_filter: torch.Tensor,
    n_valid: int,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/masked_topk.cu`` on the current stream: two launches up
    to LIST_K, the walk and the select path's passes above."""
    _check_dtype(corpus)
    b, d = queries.shape
    n = corpus.shape[0]
    dev = corpus.device
    if queries.dtype != corpus.dtype:
        raise ValueError(f"queries {queries.dtype} != corpus {corpus.dtype}")
    check_dims(d, corpus.shape[1], corpus.dtype)
    if codes.shape != (2, n) or codes.dtype != torch.int32:
        raise ValueError(f"codes must be (2, {n}) int32")
    if query_filter.shape != (b, 2) or query_filter.dtype != torch.int32:
        raise ValueError(f"query_filter must be ({b}, 2) int32")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    for t in (queries, corpus, codes, query_filter):
        if t.get_device() != dev.index or not t.is_contiguous():
            raise ValueError("inputs must be contiguous and on one CUDA device")
    if corpus.data_ptr() % 16 or queries.data_ptr() % 16 or codes.data_ptr() % 16:
        raise ValueError("queries, corpus and codes must be 16-byte aligned")
    plan = topk_plan(b, n, d, corpus.element_size(), k, _cuda.sm_count(dev))
    lib = _library()
    out = torch.empty((2, b, k), dtype=torch.float32, device=dev)  # scores, then ids
    with _cuda.on_device(dev):
        scratch = _cuda.stream_scratch(dev, plan.scratch)
        _cuda.launch(
            lib.masked_topk_s8 if corpus.dtype == torch.int8 else lib.masked_topk,
            "masked_topk", queries.data_ptr(), corpus.data_ptr(), codes.data_ptr(),
            query_filter.data_ptr(), b, n, d, max(0, min(int(n_valid), n)), k, plan.blocks,
            plan.stages, scratch.data_ptr(), out.data_ptr(),
        )
    with _launch_lock:  # batches run in worker threads
        if plan.wide:
            masked_topk.launches_wide += 1
        elif plan.path == "select":
            masked_topk.launches_select += 1
        elif corpus.dtype == torch.int8:
            masked_topk.launches_int8 += 1
        else:
            masked_topk.launches += 1
    return out[0], out[1].view(torch.int32)


def masked_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    codes: torch.Tensor,
    query_filter: torch.Tensor,
    n_valid: int,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, k) f32 scores and int32 row ids.  The CUDA kernel for a CUDA
    corpus, the plain version for a CPU corpus; nothing else."""
    if corpus.device.type == "cpu":
        return masked_topk_plain(queries, corpus, codes, query_filter, n_valid, k)
    if corpus.device.type != "cuda":
        raise ValueError(f"unsupported device {corpus.device}")
    _cuda.refuse_grad("masked_topk", queries, corpus)
    return masked_topk_cuda(queries, corpus, codes, query_filter, n_valid, k)


# kernel launches since the last reset, by branch (chip_smoke.py reads
# and resets them): the lists' bf16 and int8 branches, the select path,
# and the wide kernel (either type and path)
masked_topk.launches = 0
masked_topk.launches_int8 = 0
masked_topk.launches_select = 0
masked_topk.launches_wide = 0
_launch_lock = threading.Lock()
