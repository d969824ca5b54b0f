"""Shared search surface for the index engines.

Port of ``financial_rag_system_tpu/index/base.py``: the host-level API
over any engine that exposes ``search_device(query_vecs, query_filter,
k)`` and a ``store`` (``SearchMixin``) — single-filter search and
batched per-query-filter search, where the whole dynamic batch retrieves
in one device pass even when every request filters a different ticker —
and the candidate helpers the sub-linear tiers share: exact scoring of a
row subset (:func:`score_rows`, kernel 1 on the card), selective-filter
inverted lists and the duplicate-aware merge of candidate sets.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from financial_rag_system_tpu_torch.ops.topk import NEG_INF, masked_topk

_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


def _as_host(query_vecs: np.ndarray | torch.Tensor) -> np.ndarray:
    """(B, D) float32 numpy view of host or device query vectors."""
    if isinstance(query_vecs, torch.Tensor):
        query_vecs = query_vecs.detach().float().cpu().numpy()
    q = np.asarray(query_vecs, np.float32)
    return q[None, :] if q.ndim == 1 else q


def _bucket(b: int) -> int:
    for x in _BATCH_BUCKETS:
        if b <= x:
            return x
    return ((b + 127) // 128) * 128


def merge_candidates(
    s: torch.Tensor, i: torch.Tensor, extras, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge (B, k) primary results with extra (scores, ids) candidate
    sets, masking duplicate (query, row) pairs BEFORE the final top-k so a
    row reached by two paths can't crowd out distinct rows.  Equal scores
    keep concatenation order, as ``lax.top_k`` does."""
    if not extras:
        return s, i
    s = torch.cat([s, *(e[0] for e in extras)], dim=1)
    i = torch.cat([i, *(e[1] for e in extras)], dim=1)
    eq = (i[:, :, None] == i[:, None, :]) & (i[:, :, None] >= 0)
    w = i.shape[1]
    earlier = torch.ones((w, w), dtype=torch.bool, device=i.device).tril(-1)
    is_dup = (eq & earlier).any(dim=2)
    s = torch.where(is_dup, torch.full_like(s, NEG_INF), s)
    i = torch.where(is_dup, torch.full_like(i, -1), i)
    s, pos = torch.sort(s, dim=1, descending=True, stable=True)
    return s[:, :k], torch.gather(i, 1, pos[:, :k])


def selective_rows(
    rows_by_ticker: dict[int, np.ndarray],
    host_codes,
    limit: int,
) -> np.ndarray | None:
    """Union of the batch's inverted lists for filters selective enough
    to score exactly (<= limit matching rows); None when no query
    qualifies.

    The union is capped at 4x the per-filter limit for the whole batch:
    smallest lists first, larger ones fall back to the ANN path —
    otherwise a 32-query batch of distinct near-limit tickers would
    brute-force a quarter of a 1M corpus.
    """
    if not host_codes:
        return None
    lists = []
    seen: set[int] = set()
    for tcode, _dt in host_codes:
        code = int(tcode)
        rows = rows_by_ticker.get(code)
        if rows is not None and len(rows) <= limit and code not in seen:
            seen.add(code)
            lists.append(rows)
    if not lists:
        return None
    cap = 4 * limit
    lists.sort(key=len)
    union, total = [], 0
    for rows in lists:
        if total + len(rows) > cap and union:
            break
        union.append(rows)
        total += len(rows)
    return np.unique(np.concatenate(union))


def build_ticker_lists(flat, n: int) -> dict[int, np.ndarray]:
    """Inverted row lists per ticker code over rows [0, n) — one (n,)
    int32 host readback per build."""
    codes0 = flat._codes[0, :n].cpu().numpy()
    return {
        int(c): np.where(codes0 == c)[0].astype(np.int32)
        for c in np.unique(codes0)
    }


def score_rows(flat, rows: np.ndarray, q_prepped, qf, k):
    """Exact masked top-k over an explicit row subset of a flat index
    (tail rows or selective-filter inverted lists), through
    :func:`ops.topk.masked_topk` — kernel 1 on the card.  ``q_prepped``
    must already match the corpus representation (FlatIndex.prep_queries)
    so scores share the ANN path's scale.  Returns (B, min(k, len(rows)))
    scores and global row ids (-1 where the score is -inf)."""
    emb, codes, _ = flat._arrays
    r = torch.as_tensor(np.asarray(rows), dtype=torch.long, device=emb.device)
    s, local = masked_topk(
        q_prepped, emb[r], codes[:, r].contiguous(), qf, len(rows),
        min(k, len(rows)),
    )
    gids = r.to(torch.int32)[local.clamp_min(0).long()]
    return s, torch.where(s > NEG_INF, gids, torch.full_like(gids, -1))


class SearchMixin:
    store: Any  # DocumentStore
    device: torch.device

    def search_device(
        self,
        query_vecs: torch.Tensor,
        query_filter: torch.Tensor,
        k: int,
        *,
        host_codes: list[tuple[int, int]] | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """host_codes mirrors query_filter on the host so engines can make
        selectivity decisions without a device round-trip."""
        raise NotImplementedError

    def _hits(self, scores: np.ndarray, rows: np.ndarray) -> list[list[dict]]:
        out: list[list[dict]] = []
        for bi in range(scores.shape[0]):
            hits = []
            for s, r in zip(scores[bi], rows[bi]):
                if not np.isfinite(s):
                    continue
                payload = self.store.get(int(r))
                payload["score"] = float(s)
                payload["row"] = int(r)
                hits.append(payload)
            out.append(hits)
        return out

    def search_batch(
        self,
        query_vecs: np.ndarray | torch.Tensor,
        filters: Sequence[tuple[str | None, str | None]],
        k: int = 15,
    ) -> list[list[dict[str, Any]]]:
        """One device pass for a mixed-filter batch.

        filters[i] = (ticker, document_type) for query i; None = wildcard.
        """
        q = _as_host(query_vecs)
        b = q.shape[0]
        if b != len(filters):
            raise ValueError(f"{b} queries but {len(filters)} filters")
        # pad the batch to a bucket, as the JAX package does for its
        # compile cache, so both engines score the same padded batch
        bpad = _bucket(b)
        if bpad != b:
            q = np.concatenate([q, np.zeros((bpad - b, q.shape[1]), np.float32)])
        codes = [self.store.query_codes(t, d) for t, d in filters]
        codes += [(-3, -3)] * (bpad - b)  # padding queries match nothing
        scores, rows = self.search_device(
            torch.as_tensor(q, device=self.device),
            torch.as_tensor(codes, dtype=torch.int32, device=self.device),
            k,
            host_codes=codes,
        )
        return self._hits(scores.cpu().numpy()[:b], rows.cpu().numpy()[:b])

    def search(
        self,
        query_vecs: np.ndarray | torch.Tensor,
        *,
        ticker: str | None = None,
        document_type: str | None = None,
        k: int = 15,
    ) -> list[list[dict[str, Any]]]:
        q = _as_host(query_vecs)
        return self.search_batch(q, [(ticker, document_type)] * q.shape[0], k)
