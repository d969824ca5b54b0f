"""Device-resident flat (exact) vector index.

Port of ``financial_rag_system_tpu/index/flat.py``: corpus embeddings
live on the device as one padded (capacity, D) bf16 or int8 tensor with
a parallel (2, capacity) int32 metadata-code tensor and an optional
(capacity, DLEN) int32 token store; search is the masked top-k of
:mod:`ops.topk` (the CUDA kernel on the card), so a query batch costs
one kernel launch and no host round-trips.

An int8 index (``dtype=torch.int8``) stores each L2-normalized row as
``round(v * 127)`` (half to even, clipped to +-127) and quantizes its
queries the same way (:func:`quantize_int8`), so a score is cosine *
127^2, a constant scale that leaves the ranking intact, at half the
bytes of bf16.

Capacity is padded to the tile size and grows geometrically on
overflow; padding rows carry code ``-2`` and are masked by ``n_valid``.
Persistence is the JAX package's format — ``flat_index.npz`` plus the
JSON document store — so either package loads the other's index.

Unlike the JAX package's immutable arrays, upserts write rows in place
when the capacity does not change (no copy of a multi-GB corpus per
ingest); a grow or a token-store resize swaps in new tensors.
"""

from __future__ import annotations

import os
from typing import Any, Sequence

import numpy as np
import torch

from financial_rag_system_tpu_torch.index.base import SearchMixin
from financial_rag_system_tpu_torch.index.store import PAD_CODE, DocumentStore
from financial_rag_system_tpu_torch.ops.topk import masked_topk
from financial_rag_system_tpu_torch.utils.device import resolve_device

DEFAULT_TILE = 1024

# ceiling for auto-sized token stores: a 1000-char reference chunk is
# ~200-260 wordpieces, and the fused rerank truncates pairs at the
# reranker's max_seq_length anyway (ops/fused_query._assemble_pairs)
DEFAULT_TOKEN_STORE_MAX = 384


def quantize_int8(x: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantization of unit vectors, the JAX package's for
    rows (``index/flat.py:207-208``) and queries (``:321-327``):
    ``round(x * 127)`` in f32, half to even, clipped to +-127."""
    return torch.clamp(torch.round(x.float() * 127.0), -127, 127).to(torch.int8)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def auto_token_width(
    lengths, *, cap: int = DEFAULT_TOKEN_STORE_MAX, multiple: int = 8,
    floor: int = 16,
) -> int:
    """Token-store width from measured wordpiece lengths: p99 rounded up.

    Store width IS rerank latency when rerank dominates batch FLOPs, and
    a static width silently truncates realistic 1000-char chunks.
    ``lengths`` must already include the trailing SEP.
    """
    if not len(lengths):
        return floor
    p99 = int(np.percentile(np.asarray(lengths), 99))
    return max(floor, min(cap, _round_up(p99, multiple)))


class FlatIndex(SearchMixin):
    """Exact cosine search over a device-resident corpus."""

    def __init__(
        self,
        dim: int = 384,
        *,
        capacity: int = 8192,
        tile: int = DEFAULT_TILE,
        dtype: torch.dtype = torch.bfloat16,
        token_store_len: int | str | None = None,
        tokenizer=None,
        token_store_max: int = DEFAULT_TOKEN_STORE_MAX,
        device: str | torch.device = "cuda",
    ):
        if dtype not in (torch.bfloat16, torch.int8):
            raise ValueError(f"FlatIndex stores bf16 or int8 rows, not {dtype}")
        self.device = resolve_device(device)
        self.dim = dim
        self.tile = tile
        self.dtype = dtype
        self.quantized = dtype == torch.int8
        self.capacity = _round_up(max(capacity, tile), tile)
        self.store = DocumentStore()
        # "auto": the store materializes on the first upsert at the
        # measured p99 wordpiece width (auto_token_width) and widens in
        # 32-token steps if later ingests measure longer
        self._auto_dlen = token_store_len == "auto" and tokenizer is not None
        if token_store_len == "auto":
            token_store_len = None
        self.token_store_len = token_store_len
        self.token_store_max = token_store_max
        self._tok_lengths: list[int] = []
        self.tokenizer = tokenizer
        # device tensors live in ONE tuple (emb, codes, doc_tok) swapped
        # as a unit: writers (upsert/_grow, which may change capacity) and
        # readers run in different threads, and a reader pairing a grown
        # emb with an ungrown codes would crash the whole batch.
        # Consistency-critical readers take self._arrays once.
        self._arrays = (
            torch.zeros((self.capacity, dim), dtype=dtype, device=self.device),
            torch.full((2, self.capacity), PAD_CODE, dtype=torch.int32,
                       device=self.device),
            self._zeros_tok(self.capacity, token_store_len)
            if token_store_len else None,
        )

    def _zeros_tok(self, rows: int, width: int) -> torch.Tensor:
        return torch.zeros((rows, width), dtype=torch.int32, device=self.device)

    # -- device-array views (see _arrays comment) -------------------------
    @property
    def _emb(self):
        return self._arrays[0]

    @property
    def _codes(self):
        return self._arrays[1]

    @property
    def _doc_tok(self):
        return self._arrays[2]

    # ------------------------------------------------------------------
    @property
    def n_valid(self) -> int:
        return len(self.store)

    @property
    def token_store_enabled(self) -> bool:
        """True when a device token store exists OR will materialize on
        the first ingest (auto mode)."""
        return self._doc_tok is not None or self._auto_dlen

    def _grow(self, needed: int) -> None:
        new_cap = self.capacity
        while new_cap < needed:
            new_cap *= 2
        new_cap = _round_up(new_cap, self.tile)
        old_emb, old_codes, old_dtok = self._arrays
        n = old_emb.shape[0]
        emb = torch.zeros((new_cap, self.dim), dtype=self.dtype, device=self.device)
        emb[:n] = old_emb
        codes = torch.full((2, new_cap), PAD_CODE, dtype=torch.int32, device=self.device)
        codes[:, :n] = old_codes
        dtok = None
        if old_dtok is not None:
            dtok = self._zeros_tok(new_cap, self.token_store_len)
            dtok[:n] = old_dtok
        self._arrays = (emb, codes, dtok)  # one swap
        self.capacity = new_cap

    def upsert(
        self,
        ids: Sequence[str],
        vectors: np.ndarray,
        texts: Sequence[str],
        payloads: Sequence[dict[str, Any]],
    ) -> int:
        """Idempotent batched upsert.  Returns the number of *new* rows.
        Vectors are L2-normalized on the way in so search is pure
        dot-product cosine (and then quantized for an int8 index)."""
        if not len(ids) == len(vectors) == len(texts) == len(payloads):
            raise ValueError("ids/vectors/texts/payloads length mismatch")
        if not len(ids):
            return 0
        vecs = np.asarray(vectors, np.float32)
        norms = np.linalg.norm(vecs, axis=1, keepdims=True)
        vecs = vecs / np.maximum(norms, 1e-12)

        rows, code_rows, new_count = [], [], 0
        for pid, text, payload in zip(ids, texts, payloads):
            row, is_new = self.store.upsert(pid, text, payload)
            new_count += is_new
            rows.append(row)
            code_rows.append(self.store.codes_for(payload))
        if len(self.store) > self.capacity:
            self._grow(len(self.store))

        tok_rows = None
        if self.tokenizer is not None and (
            self._doc_tok is not None or self._auto_dlen
        ):
            from financial_rag_system_tpu_torch.models.tokenizer import SEP_ID

            tid_lists = [self.tokenizer.tokenize_ids(t) for t in texts]
            if self._auto_dlen:
                # sizes/widens the token store BEFORE the batch rows are
                # written below
                self._autosize_token_store([len(t) + 1 for t in tid_lists])
            dlen = self.token_store_len
            tok_rows = np.zeros((len(texts), dlen), np.int32)
            for i, tids in enumerate(tid_lists):
                tids = tids[: dlen - 1] + [SEP_ID]
                tok_rows[i, : len(tids)] = tids

        rows_a = np.asarray(rows, np.int64)
        emb, codes, dtok = self._arrays
        new_emb = torch.as_tensor(vecs, device=self.device)
        new_emb = quantize_int8(new_emb) if self.quantized else new_emb.to(self.dtype)
        new_codes = torch.as_tensor(
            np.asarray(code_rows, np.int32).T.copy(), device=self.device
        )
        new_tok = (
            torch.as_tensor(tok_rows, device=self.device)
            if tok_rows is not None else None
        )
        # contiguous appends take the slice path, the rest scatter
        if np.array_equal(rows_a, np.arange(rows_a[0], rows_a[0] + len(rows_a))):
            sl = slice(int(rows_a[0]), int(rows_a[0]) + len(rows_a))
        else:
            sl = torch.as_tensor(rows_a, device=self.device)
        emb[sl] = new_emb
        codes[:, sl] = new_codes
        if new_tok is not None:
            dtok[sl] = new_tok
        return new_count

    def _autosize_token_store(self, lengths: list[int]) -> None:
        """Auto mode: materialize the store at the measured p99 width, or
        widen it when later ingests measure longer chunks.

        Widening rounds up to 32-token steps and rebuilds every stored row
        from the host-resident texts so earlier rows aren't left truncated
        at the old width.
        """
        self._tok_lengths.extend(lengths)
        want = auto_token_width(self._tok_lengths, cap=self.token_store_max)
        cur = self.token_store_len or 0
        emb, codes, dtok = self._arrays
        if dtok is None:
            self.token_store_len = want
            self._arrays = (emb, codes, self._zeros_tok(self.capacity, want))
            return
        if want <= cur:
            return
        new_w = min(_round_up(want, 32), self.token_store_max)
        if new_w <= cur:
            return
        from financial_rag_system_tpu_torch.models.tokenizer import SEP_ID

        self.token_store_len = new_w
        rebuilt = np.zeros((self.capacity, new_w), np.int32)
        for r in range(len(self.store)):
            tids = self.tokenizer.tokenize_ids(
                self.store.texts[r]
            )[: new_w - 1] + [SEP_ID]
            rebuilt[r, : len(tids)] = tids
        self._arrays = (emb, codes, torch.as_tensor(rebuilt, device=self.device))

    # ------------------------------------------------------------------
    def search_device(
        self,
        query_vecs: torch.Tensor,
        query_filter: torch.Tensor,
        k: int,
        *,
        host_codes=None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Device-level search: (B, D) x (B, 2) codes -> (B, k) scores/rows."""
        emb, codes, _ = self._arrays  # one read: emb/codes stay paired
        return masked_topk(
            self.prep_queries(query_vecs),
            emb,
            codes,
            query_filter,
            min(self.n_valid, emb.shape[0]),
            k,
        )

    def take_rows(self, rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(R, D) rows and their (2, R) codes, for exact scoring of a
        row subset (index/base.py score_rows)."""
        emb, codes, _ = self._arrays  # one read: emb/codes stay paired
        return emb[rows], codes[:, rows].contiguous()

    def ticker_codes(self, n: int) -> np.ndarray:
        """(n,) host copy of the ticker codes of rows [0, n)."""
        return self._codes[0, :n].cpu().numpy()

    def prep_queries(self, query_vecs: torch.Tensor) -> torch.Tensor:
        """Match queries to the corpus representation (a cast, or the
        rows' int8 quantization)."""
        if self.quantized:
            return quantize_int8(query_vecs)
        return query_vecs.to(self.dtype).contiguous()

    # search()/search_batch() come from SearchMixin.

    # ------------------------------------------------------------------
    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        emb, codes, dtok = self._arrays
        arrays = {
            "emb": emb.float().cpu().numpy(),
            "codes": codes.cpu().numpy(),
            "meta": np.asarray(
                [
                    self.dim, self.tile, self.capacity,
                    self.token_store_len or 0, int(self.quantized),
                ]
            ),
        }
        if dtok is not None:
            arrays["doc_tok"] = dtok.cpu().numpy()
        # uncompressed: np.load reads either kind, and zlib over a large
        # token store takes most of a save's time
        np.savez(os.path.join(directory, "flat_index.npz"), **arrays)
        self.store.save(os.path.join(directory, "store.json"))

    @staticmethod
    def load(
        directory: str, *, tokenizer=None, device: str | torch.device = "cuda"
    ) -> "FlatIndex":
        data = np.load(os.path.join(directory, "flat_index.npz"))
        meta = [int(x) for x in data["meta"]]
        dim, tile, capacity = meta[:3]
        dlen = meta[3] if len(meta) > 3 and meta[3] else None
        quantized = bool(meta[4]) if len(meta) > 4 else False
        idx = FlatIndex(
            dim, capacity=capacity, tile=tile, token_store_len=dlen,
            tokenizer=tokenizer, device=device,
            dtype=torch.int8 if quantized else torch.bfloat16,
        )
        dtok = None
        if dlen and "doc_tok" in data:
            dtok = torch.as_tensor(data["doc_tok"], device=idx.device)
        idx._arrays = (
            torch.as_tensor(data["emb"], device=idx.device).to(idx.dtype),
            torch.as_tensor(data["codes"], device=idx.device),
            dtok if dtok is not None else idx._doc_tok,
        )
        idx.store = DocumentStore.load(os.path.join(directory, "store.json"))
        return idx
