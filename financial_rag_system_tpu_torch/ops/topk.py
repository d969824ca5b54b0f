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

Any k runs (in ceil(k / 32) rounds on the card), and any D of at most
``MAX_ROW_BYTES`` bytes a row: 3,136 bf16 or 6,272 int8 values.

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
ROUND_K = 32  # entries a round of kernels 1 and 3 finds (csrc/topk_common.cuh)
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
# the fewest ring stages two blocks an SM may keep; wider rows take one block an SM
MIN_SHARED_STAGES = 3


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
    candidates: int  # entries of the blocks' lists pass 2 may read a query, a round
    scratch: int     # int32 words of scratch: a round's lists' scores and ids
    rounds: int      # rounds of ROUND_K entries (two launches each) that find the top k


def topk_smem(row_bytes: int, stages: int) -> int:
    """Bytes of dynamic shared memory a block of kernel 1 or 3 takes
    (``smem_bytes`` in ``csrc/topk_common.cuh``): alignment, the query
    block's boxes, the ring, the tile slots, two tiles' scores and the
    mbarriers."""
    boxes = -(-row_bytes // BOX_BYTES)
    return (1024 + boxes * QUERY_BLOCK * BOX_BYTES + stages * TILE_ROWS * BOX_BYTES
            + SLOTS * SLOT_BYTES + 4 * 2 * QUERY_BLOCK * SCORE_STRIDE
            + 8 * (2 * stages + 2 * SLOTS + 1))


def plan_for(b: int, tiles: int, row_bytes: int, k: int, sms: int,
             per_sm: int = TOPK_PER_SM, stages: int = TOPK_STAGES) -> TopkPlan:
    """The launch of kernel 1 or 3 for ``b`` queries over ``tiles`` 64-row
    tiles of ``row_bytes`` bytes a row, on a card of ``sms`` multiprocessors:
    ``per_sm`` blocks an SM shared by the query blocks, never more blocks
    than tiles or than pass 2 merges, each with as many ring stages as its
    share of the SM's shared memory holds, up to ``stages`` (two blocks an
    SM keep three at D 1024 in bf16, eight at D 384).  Rows too wide for
    MIN_SHARED_STAGES stages at ``per_sm`` blocks an SM take one block an
    SM (up to MAX_ROW_BYTES, where one stage is left).  A k above ROUND_K
    takes ceil(k / ROUND_K) rounds, each finding the next ROUND_K entries
    with lists of one entry a lane, so the lists, the shared memory and the
    scratch are a round's whatever k is."""
    qblocks = -(-b // QUERY_BLOCK)

    def room(blocks_an_sm: int) -> int:
        budget = min(SM_SMEM // blocks_an_sm - 1024, SMEM_LIMIT)
        return (budget - topk_smem(row_bytes, 0)) // (TILE_ROWS * BOX_BYTES)

    if per_sm > 1 and room(per_sm) < MIN_SHARED_STAGES:
        per_sm = 1
    n_stages = min(stages, MAX_STAGES, room(per_sm))
    if n_stages < 1:
        raise ValueError(f"rows of {row_bytes} bytes leave no ring stage "
                         f"(at most {MAX_ROW_BYTES})")
    blocks = max(1, min(tiles, sms * per_sm // qblocks, MAX_BLOCKS))
    kr = min(k, ROUND_K)
    return TopkPlan(blocks, qblocks, n_stages, topk_smem(row_bytes, n_stages), tiles,
                    blocks * kr, 2 * b * kr * blocks, -(-k // ROUND_K))


@functools.lru_cache(maxsize=256)
def topk_plan(b: int, n: int, d: int, elt: int, k: int, sms: int) -> TopkPlan:
    """Kernel 1's plan for ``b`` queries over ``n`` rows of ``d`` values of
    ``elt`` bytes: the 64-row tiles dealt out in contiguous shares."""
    return plan_for(b, -(-n // TILE_ROWS), d * elt, k, sms)


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
    """Launch ``csrc/masked_topk.cu`` (two launches) on the current stream."""
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
        if corpus.dtype == torch.int8:
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
    return masked_topk_cuda(queries, corpus, codes, query_filter, n_valid, k)


# kernel launches since the last reset, by branch (chip_smoke.py reads
# and resets them)
masked_topk.launches = 0
masked_topk.launches_int8 = 0
_launch_lock = threading.Lock()
