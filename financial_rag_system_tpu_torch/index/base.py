"""Shared search surface for the index engines.

Port of ``financial_rag_system_tpu/index/base.py`` (``SearchMixin``):
the host-level API over any engine that exposes
``search_device(query_vecs, query_filter, k)`` and a ``store`` —
single-filter search and batched per-query-filter search, where the
whole dynamic batch retrieves in one device pass even when every
request filters a different ticker.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

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
