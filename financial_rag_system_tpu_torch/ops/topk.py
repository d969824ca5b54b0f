"""Fused masked similarity + top-k — the retrieval hot kernel.

Port of ``financial_rag_system_tpu/ops/topk.py``: cosine scores of a
query batch against the device-resident corpus, the metadata filter as a
mask, and top-k selection, with the semantics of ``masked_topk_xla``
plus the Pallas kernel's tie rule (equal scores go to the lower row id).

- :func:`masked_topk` is the entry point.  On a CUDA tensor it launches
  the hand-written kernel ``csrc/masked_topk.cu`` (or raises); on a CPU
  tensor it runs :func:`masked_topk_plain`.
- :func:`masked_topk_plain` is the same function in plain PyTorch: f32
  sums of the products, the mask, and a stable descending sort, so ties
  keep ascending row order.

A corpus is bf16 or int8 (``FlatIndex(dtype=torch.int8)``: symmetric
quantization of unit rows, ``round(v * 127)``), with queries of the same
type.  An int8 score is the integer dot product as f32: every partial
sum is an integer of magnitude at most 127^2 * D < 2^24 (D <= 1024), so
the f32 sum is exact in any order and equals JAX's int8 x int8 -> int32
-> f32 bit for bit, on the CPU and in the kernel alike.  The int8 branch
counts its launches in ``masked_topk.launches_int8``.

Filter encoding: each corpus row carries int32 ``[ticker_code,
doc_type_code]``; each query carries required codes where ``-1`` means
wildcard.  Padding rows use code ``-2`` and are also masked by
``n_valid``.  Empty slots come out as score ``-inf`` and id ``-1``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from financial_rag_system_tpu_torch.ops import _cuda

NEG_INF = float("-inf")
MAX_K = 32
MAX_DIM = 1024
ROWS_PER_SPLIT = 1024  # pass-1 rows per block: N = 131,072 -> 128 blocks
# D must be a multiple of one tensor-core step: m16n8k16 (bf16), m16n8k32 (int8)
DIM_STEP = {torch.bfloat16: 16, torch.int8: 32}


def _check_dtype(corpus: torch.Tensor) -> None:
    if corpus.dtype not in DIM_STEP:
        raise ValueError(f"masked_topk takes a bf16 or int8 corpus, got {corpus.dtype}")


def check_dims(d: int, d_corpus: int, dtype: torch.dtype) -> None:
    """Raise unless query and corpus rows are both D wide, D a multiple of
    the dtype's tensor-core step and at most MAX_DIM (the kernels' rule)."""
    step = DIM_STEP[dtype]
    if d_corpus != d or d % step or d > MAX_DIM:
        raise ValueError(f"dims: queries {d}, corpus {d_corpus} "
                         f"({step} | D <= {MAX_DIM} for {dtype})")


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
    q = queries.to(corpus.dtype).float()
    # each product exact; f32 sums (exact for int8: integers below 2^24)
    scores = q @ corpus.float().T
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


def _kernel_fn(dtype: torch.dtype):
    lib = _cuda.library("masked_topk")
    fn = lib.masked_topk_s8 if dtype == torch.int8 else lib.masked_topk
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5
    )
    fn.restype = ctypes.c_int
    return fn


def masked_topk_cuda(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    codes: torch.Tensor,
    query_filter: torch.Tensor,
    n_valid: int,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/masked_topk.cu`` (two passes) on the current stream."""
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
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    for t in (queries, corpus, codes, query_filter):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("inputs must be contiguous and on one CUDA device")
    if corpus.data_ptr() % 16 or queries.data_ptr() % 16:
        raise ValueError("queries and corpus must be 16-byte aligned")
    splits = -(-n // ROWS_PER_SPLIT)
    part_s = torch.empty((b, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, splits, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _cuda.check(
        _kernel_fn(corpus.dtype)(
            queries.data_ptr(), corpus.data_ptr(), codes.data_ptr(),
            query_filter.data_ptr(), b, n, d, max(0, min(int(n_valid), n)), k,
            ROWS_PER_SPLIT, part_s.data_ptr(), part_i.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), stream,
        ),
        "masked_topk",
    )
    with _launch_lock:  # batches run in worker threads
        if corpus.dtype == torch.int8:
            masked_topk.launches_int8 += 1
        else:
            masked_topk.launches += 1
    return out_s, out_i


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
