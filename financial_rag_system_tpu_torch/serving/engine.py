"""The RAG engine: cache -> route -> embed+retrieve -> rerank -> generate.

Port of ``financial_rag_system_tpu/serving/engine.py`` for the flat tier
with the full model stack.  The reference's behavioral surface is kept:

- cache key ``sha256(f"{ticker}_{query.lower()}")``; a hit returns
  provider "Cache" with the sentinel source
- miss: SIMPLE/COMPLEX routing, retrieve 15 candidates (ticker must /
  optional document_type filters), cross-encoder rerank ->
  ``argsort[::-1][:top_k]``, breaker-guarded LLM generation with the
  degraded fallback, write-behind cache save skipped for degraded
  answers
- response schema {query_hash, query, answer, sources[{score, text,
  document_type}], cached, provider}

In "batched" mode the dynamic batcher hands each batch to the fused
device path (:mod:`ops.fused_query`, ``fused_kind == "full"``): embed,
masked top-k, token gather and cross-encoder rerank are queued on the
device with one host readback per batch.  The staged path (embed, then
search, then a host-driven rerank) serves batches the fused path cannot
take.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Any

import numpy as np
import torch

from financial_rag_system_tpu_torch.index.flat import FlatIndex
from financial_rag_system_tpu_torch.models.embedder import BiEncoder
from financial_rag_system_tpu_torch.models.reranker import CrossEncoderReranker
from financial_rag_system_tpu_torch.models.tokenizer import pad_batch
from financial_rag_system_tpu_torch.obs.tracing import get_tracer
from financial_rag_system_tpu_torch.serving.batcher import DynamicBatcher
from financial_rag_system_tpu_torch.serving.breaker import CircuitBreaker
from financial_rag_system_tpu_torch.serving.cache import CacheDB
from financial_rag_system_tpu_torch.serving.llm import (
    LLMClient,
    MockLLMClient,
    generate_answer,
)
from financial_rag_system_tpu_torch.serving.router import route_query
from financial_rag_system_tpu_torch.utils.config import Config
from financial_rag_system_tpu_torch.utils.hashing import cache_key


class RAGEngine:
    def __init__(
        self,
        cfg: Config,
        index,
        embedder,
        reranker,
        *,
        mode: str = "batched",
        llm: LLMClient | None = None,
        cache: CacheDB | None = None,
        breaker: CircuitBreaker | None = None,
    ):
        if mode not in ("batched", "sequential"):
            raise ValueError(f"unknown mode {mode!r}")
        self.cfg = cfg
        self.index = index
        self.embedder = embedder
        self.reranker = reranker
        self.mode = mode
        # lazy: opening the cache DB is deferred to the first request
        self._cache = cache
        self._cache_lock = threading.Lock()
        self.breaker = breaker or CircuitBreaker(
            cfg.breaker_state_path, cfg.breaker_cooldown_s
        )
        self.llm = llm or (MockLLMClient(cfg) if cfg.testing else LLMClient(cfg))
        self.llm_semaphore = asyncio.Semaphore(cfg.max_concurrent_llm)
        self.tracer = get_tracer()
        self._fused_kind: str | None = None
        self._fused_hash_rerank = False  # hash stack: not ported yet
        self._fused_fn = self._maybe_build_fused()
        # strong refs to fire-and-forget tasks (an unreferenced asyncio
        # task can be garbage-collected before it runs)
        self._bg_tasks: set[asyncio.Task] = set()
        self.batcher: DynamicBatcher | None = None
        if mode == "batched":
            self.batcher = DynamicBatcher(
                self._dispatch_batch,
                window_s=cfg.batch_window_s,
                max_batch=cfg.max_batch_size,
                eager_idle_s=cfg.batch_eager_idle_s,
            )

    @property
    def cache(self) -> CacheDB:
        if self._cache is None:
            with self._cache_lock:
                if self._cache is None:
                    self._cache = CacheDB(self.cfg.database_url)
        return self._cache

    def _dispatch_batch(self, queries, filters):
        """Late-bound batch fn: try the fused path, fall back to the
        staged pipeline whenever the batch is ineligible."""
        out = self._fused_batch(queries, filters)
        if out is not None:
            return out
        return self._embed_retrieve_batch(queries, filters)

    def _maybe_build_fused(self):
        """The "full" fused pipeline (ops/fused_query.py): a flat index
        with a device token store (or an auto store that materializes on
        the first ingest) under the full model stack.  Every other
        combination serves staged (None)."""
        from financial_rag_system_tpu_torch.ops.fused_query import make_fused_query

        self._fused_kind = None
        index = self.index
        if not (
            isinstance(index, FlatIndex)
            and isinstance(self.embedder, BiEncoder)
            and isinstance(self.reranker, CrossEncoderReranker)
            and index.token_store_enabled
        ):
            return None
        self._fused_kind = "full"
        return make_fused_query(self.reranker.cfg, k=self.cfg.retrieve_k)

    # -- lifecycle ---------------------------------------------------------

    async def startup(self) -> None:
        if self.batcher is not None:
            self.batcher.start()

    async def shutdown(self) -> None:
        if self.batcher is not None:
            await self.batcher.stop()
        await self.llm.aclose()

    # -- batched device work -------------------------------------------------

    def _embed_retrieve_batch(
        self,
        queries: list[str],
        filters: list[tuple[str | None, str | None]],
    ) -> list[tuple[np.ndarray, list[dict[str, Any]]]]:
        """Staged path: embed the batch, then one batched search."""
        vecs = self.embedder.encode(queries)
        hits = self.index.search_batch(vecs, filters, k=self.cfg.retrieve_k)
        return list(zip(vecs, hits))

    def _fused_batch(
        self,
        queries: list[str],
        filters: list[tuple[str | None, str | None]],
    ) -> list[tuple[Any, list[dict[str, Any]]]] | None:
        """Fused batch with one host readback: tokenize on the host, run
        the device pipeline, then assemble payload hits.  Returns None
        when no fused program exists or the batch is ineligible."""
        if self._fused_fn is None:
            return None
        index = self.index
        tok = self.embedder.tokenizer
        # queries truncate at 64 (p95 is ~22 tokens) capped by the
        # embedder's trained length
        lq = min(64, getattr(self.embedder, "max_len", 64) or 64)
        t0 = time.time()
        encs = [tok.encode(q, lq) for q in queries]
        ids, types, mask = pad_batch(encs)
        codes = [index.store.query_codes(t, d) for t, d in filters]
        t_tok = time.time()
        res = self._fused_exec(ids, types, mask, codes)
        if res is None:
            return None
        rows, bi, ce = res
        # the batch's one readback: rows travel bit-cast inside the f32 block
        host = torch.cat([bi, ce, rows.view(torch.float32)], dim=1).cpu()
        k = rows.shape[1]
        bi, ce = host[:, :k].numpy(), host[:, k : 2 * k].numpy()
        rows = host[:, 2 * k :].contiguous().view(torch.int32).numpy()
        t_dev = time.time()
        self.tracer.log_metric("fused_tokenize_ms", (t_tok - t0) * 1000)
        self.tracer.log_metric("fused_device_ms", (t_dev - t_tok) * 1000)
        store = index.store
        out = []
        for i in range(len(queries)):
            hits = []
            for r, s, c in zip(rows[i], bi[i], ce[i]):
                if r < 0 or not np.isfinite(s):
                    continue
                payload = store.get(int(r))
                payload["score"] = float(s)
                payload["row"] = int(r)
                # device-computed stage-2 score: the per-request rerank
                # reduces to a sort + slice
                payload["rerank_score"] = float(c)
                hits.append(payload)
            # the fused path returns no query vectors (the staged one does)
            out.append((None, hits))
        self.tracer.log_metric("fused_assemble_ms", (time.time() - t_dev) * 1000)
        return out

    def _fused_exec(self, ids, types, mask, codes):
        """Device portion of the fused batch.  Captures (fused_fn, kind)
        together and reads the index's tensor tuple once: a concurrent
        upsert/grow must not pair a new emb with old codes or token store
        mid-batch.  Returns (rows, bi, ce) device tensors, or None when the
        batch is ineligible."""
        fused, kind = self._fused_fn, self._fused_kind
        index = self.index
        if fused is None or kind != "full" or not isinstance(index, FlatIndex):
            return None
        emb, idx_codes, doc_tok = index._arrays
        if doc_tok is None:
            return None  # auto token store not yet materialized
        dev = index.device
        b = len(codes)
        bpad = ids.shape[0]
        qf = torch.as_tensor(
            list(codes) + [(-3, -3)] * (bpad - b), dtype=torch.int32, device=dev
        )
        t_ids, t_types, t_mask = (
            torch.as_tensor(a, device=dev) for a in (ids, types, mask)
        )
        nv = min(index.n_valid, emb.shape[0])
        return fused(
            self.embedder.model, self.reranker.model,
            t_ids, t_types, t_mask, qf, emb, idx_codes, doc_tok, nv,
        )

    # -- public API -----------------------------------------------------------

    async def embed(self, texts: list[str]) -> list[list[float]]:
        """The /embed endpoint used by ingestion."""
        vecs = await asyncio.to_thread(self.embedder.encode, texts)
        return np.asarray(vecs).tolist()

    async def ask(
        self,
        query: str,
        ticker: str,
        top_k: int = 5,
        document_type: str | None = None,
    ) -> dict[str, Any]:
        arrival = time.time()
        q_hash = cache_key(ticker, query)

        cached = await asyncio.to_thread(self.cache.lookup, q_hash, ticker.upper())
        if cached is not None:
            return {
                "query_hash": q_hash,
                "query": query,
                "answer": cached,
                "sources": [
                    {"score": 1.0, "text": "Semantic Cache", "document_type": "Cache"}
                ],
                "cached": True,
                "provider": "Cache",
            }

        with self.tracer.span(
            "RAG_Workflow", kind="CHAIN",
            inputs={"user_query": query, "ticker": ticker},
        ) as root:
            async with self.llm_semaphore:
                with self.tracer.span("1_Query_Routing", kind="TOOL"):
                    t0 = time.time()
                    complexity = route_query(query)
                    self.tracer.log_metric("router_ms", (time.time() - t0) * 1000)

                t0 = time.time()
                with self.tracer.span(
                    "2_Vector_Retrieval", kind="RETRIEVER",
                    inputs={"ticker": ticker, "k": self.cfg.retrieve_k},
                ) as sp:
                    if self.batcher is not None:
                        _vec, hits = await self.batcher.submit(
                            query, ticker, document_type
                        )
                    else:  # sequential baseline path
                        _vec, hits = (
                            await asyncio.to_thread(
                                self._dispatch_batch,
                                [query],
                                [(ticker, document_type)],
                            )
                        )[0]
                    sp.outputs = [h["text"] for h in hits]
                self.tracer.log_metric("retrieval_ms", (time.time() - t0) * 1000)
                self.tracer.log_metric("retrieved_docs", len(hits))

                t0 = time.time()
                with self.tracer.span("3_Reranking", kind="TOOL") as sp:
                    if hits and "rerank_score" in hits[0]:
                        # fused path scored the pairs on device already
                        sp.attrs["fused"] = True
                        scores = np.asarray([h["rerank_score"] for h in hits])
                        order = np.argsort(scores)[::-1][:top_k]
                        top = [hits[int(i)] for i in order]
                    elif hits:
                        scores = await asyncio.to_thread(
                            self.reranker.score, query, [h["text"] for h in hits]
                        )
                        order = np.argsort(scores)[::-1][:top_k]
                        top = [
                            {**hits[int(i)], "rerank_score": float(scores[int(i)])}
                            for i in order
                        ]
                    else:
                        top = []
                self.tracer.log_metric("rerank_ms", (time.time() - t0) * 1000)
                self.tracer.log_metric("reranked_docs", len(top))

                context = "\n\n".join(h["text"] for h in top)
                t0 = time.time()
                with self.tracer.span("LLM_Generation", kind="LLM") as sp:
                    answer, provider = await generate_answer(
                        self.llm, self.breaker, query, context, complexity
                    )
                    sp.outputs = answer
                self.tracer.log_metric("llm_ms", (time.time() - t0) * 1000)
                self.tracer.log_metric(
                    "total_e2e_ms", (time.time() - arrival) * 1000
                )
                root.outputs = answer
                root.attrs.update(
                    {"complexity": complexity, "provider": provider, "top_k": top_k}
                )

        if provider != "System Degraded":
            # write-behind
            task = asyncio.get_running_loop().create_task(
                asyncio.to_thread(
                    self.cache.save, q_hash, ticker, query, answer, provider
                )
            )
            self._bg_tasks.add(task)
            task.add_done_callback(self._bg_tasks.discard)

        return {
            "query_hash": q_hash,
            "query": query,
            "answer": answer,
            "sources": [
                {
                    "score": h.get("rerank_score", h.get("score", 0.0)),
                    "text": h["text"],
                    "document_type": h.get("document_type", "SEC Filing"),
                }
                for h in top
            ],
            "cached": False,
            "provider": provider,
        }

    async def ingest_chunks(
        self,
        ids: list[str],
        texts: list[str],
        payloads: list[dict[str, Any]],
    ) -> int:
        """Embed on the device and upsert into the in-process index."""

        def work() -> int:
            vecs = self.embedder.encode(texts)
            return self.index.upsert(ids, vecs, texts, payloads)

        with self.tracer.span("Index_Upsert", kind="TOOL", inputs={"n": len(ids)}):
            return await asyncio.to_thread(work)

    # -- ops surface -----------------------------------------------------------

    def feedback(self, query_hash: str, rating: int) -> None:
        self.cache.add_feedback(query_hash, rating)

    def clear_cache(self, ticker: str) -> int:
        return self.cache.clear_ticker(ticker)

    def queue_status(self) -> dict[str, Any]:
        return {
            "mode": self.mode,
            "queue_size": self.batcher.queue_size if self.batcher else 0,
            # which index tier serves and whether the fused pipeline is on
            "index_tier": type(self.index).__name__,
            "fused_kind": self._fused_kind,
            "fused_hash_rerank": self._fused_hash_rerank,
        }

    def ready(self) -> dict[str, Any]:
        try:
            n = self.index.n_valid
            return {"status": "ready", "indexed_chunks": n}
        except Exception as exc:  # pragma: no cover
            return {"status": "not_ready", "error": str(exc)}
