"""The RAG engine: cache -> route -> embed+retrieve -> rerank -> generate.

Port of ``financial_rag_system_tpu/serving/engine.py`` for the
single-device flat, IVF and HNSW tiers, with the full model stack or the
hermetic hash stack (the reference's TESTING mode, and every start with
no checkpoints).  The reference's behavioral surface is kept:

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
device path (:mod:`ops.fused_query`): embed, masked top-k (flat,
``fused_kind == "full"``), centroid probe and probed-tiles search (IVF,
``"ivf_full"``) or pool routing, descent and graph walk (HNSW,
``"hnsw_full"``), token gather and cross-encoder rerank are queued on the
device with one host readback per batch.  The hash stack fuses the same
way (``"hash"``, ``"ivf_hash"``): its query bag, the same kernels and,
with a token store and a non-identity reranker, the de-aliased hash
rerank (``fused_hash_rerank``); the identity reranker keeps retrieval
order, and without a store the staged ``HashReranker.score`` reranks;
the hash stack on an HNSW index serves staged, as in JAX.  The staged
path (embed, then ``index.search_batch``, then a host-driven rerank)
serves batches the fused path cannot take: IVF or HNSW tail rows, a
selective filter, or a geometry changed by a churn rebuild or a graph
rebuild.  ``rebuild_index`` promotes a flat corpus to the IVF or the
HNSW tier (``POST /index/rebuild``).
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Any

import numpy as np
import torch

from financial_rag_system_tpu_torch.index.base import selective_rows
from financial_rag_system_tpu_torch.index.flat import FlatIndex
from financial_rag_system_tpu_torch.index.hnsw import HNSWIndex
from financial_rag_system_tpu_torch.index.ivf import IVFIndex
from financial_rag_system_tpu_torch.models.embedder import BiEncoder, HashEmbedder
from financial_rag_system_tpu_torch.models.reranker import (
    CrossEncoderReranker,
    HashReranker,
)
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
        # (program, kind, IVF geometry it was built for, whether it runs
        # the hash rerank): one tuple, so a batch never pairs one program
        # with another's kind or geometry
        self._fused = self._maybe_build_fused()
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

    @property
    def _fused_fn(self):
        return self._fused[0]

    @property
    def _fused_kind(self) -> str | None:
        return self._fused[1]

    @property
    def _fused_hash_rerank(self) -> bool:
        return self._fused[3]

    def _maybe_build_fused(self):
        """The fused pipelines (ops/fused_query.py):

        - the full model stack over a flat index with a device token
          store (or an auto store that materializes on the first ingest):
          "full" on the flat tier, "ivf_full" on the IVF tier, with the
          flat scan replaced by centroid probing and the probed-tiles
          kernel, "hnsw_full" on the HNSW tier, with the graph walk;
        - the hash stack: "hash" and "ivf_hash", with the de-aliased hash
          rerank fused where the reranker is not the identity and the
          index has a token store.

        An int8 index fuses too: the programs quantize the query vectors
        as its rows are.  Every other combination serves staged
        (None, None, None, False)."""
        from financial_rag_system_tpu_torch.ops.fused_query import (
            make_fused_hash_query,
            make_fused_hnsw_query,
            make_fused_ivf_hash_query,
            make_fused_ivf_query,
            make_fused_query,
        )

        index = self.index
        flat = index.flat if isinstance(index, (IVFIndex, HNSWIndex)) else index
        full_stack = (
            isinstance(self.embedder, BiEncoder)
            and isinstance(self.reranker, CrossEncoderReranker)
        )
        hash_stack = (
            isinstance(self.embedder, HashEmbedder)
            and isinstance(self.reranker, HashReranker)
        )
        if not isinstance(flat, FlatIndex) or not (
            (full_stack and flat.token_store_enabled) or hash_stack
        ):
            return None, None, None, False
        k = self.cfg.retrieve_k
        if isinstance(index, HNSWIndex):
            if not full_stack:
                return None, None, None, False  # the hash stack serves staged
            state = index._graph_state
            pool = state[7]
            pool_take = pool[3] if pool is not None else 0
            # geometry captured at build: the sentinel and which routing
            # aids the program runs; _fused_exec compares it with each
            # snapshot's and serves staged on a mismatch (a rebuild raced)
            geom = (state[2], state[6] is not None, pool_take)
            fn = make_fused_hnsw_query(
                self.reranker.cfg, k=k, ef=state[3], steps=index.steps,
                frontier=index.frontier, pad_id=state[2],
                descend=index.descend if state[6] is not None else None,
                pool_take=pool_take,
            )
            return fn, "hnsw_full", geom, False
        hash_rerank = hash_stack and not self.reranker.identity and flat.token_store_enabled
        if isinstance(index, IVFIndex):
            # geometry captured at build: a churn-triggered auto-rebuild
            # can re-derive it, and the bound program would then probe the
            # wrong rows, so _fused_exec compares it with each snapshot's
            # and falls back staged
            geom = index._state.geom
            common = dict(
                k=k, tile=index.tile, nprobe=geom.nprobe,
                tiles_per_cluster=geom.tiles_per_cluster,
            )
            if full_stack:
                return make_fused_ivf_query(self.reranker.cfg, **common), "ivf_full", geom, False
            return (make_fused_ivf_hash_query(**common, rerank=hash_rerank), "ivf_hash",
                    geom, hash_rerank)
        if full_stack:
            return make_fused_query(self.reranker.cfg, k=k), "full", None, False
        return make_fused_hash_query(k=k, rerank=hash_rerank), "hash", None, hash_rerank

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
        rows, bi, ce, active = res
        with_ce = ce is not None  # else the staged reranker scores the hits
        # the batch's one readback: int32 rows (and the IVF probe list's
        # active-tile count) travel bit-cast inside the f32 block
        k = rows.shape[1]
        ints = rows if active is None else torch.cat(
            [rows, active.view(1, 1).expand(rows.shape[0], 1)], dim=1
        )
        host = torch.cat([bi, ce if with_ce else bi, ints.view(torch.float32)], dim=1).cpu()
        bi, ce = host[:, :k].numpy(), host[:, k : 2 * k].numpy()
        ints = host[:, 2 * k :].contiguous().view(torch.int32).numpy()
        rows = ints[:, :k]
        t_dev = time.time()
        self.tracer.log_metric("fused_tokenize_ms", (t_tok - t0) * 1000)
        self.tracer.log_metric("fused_device_ms", (t_dev - t_tok) * 1000)
        if active is not None:
            self.tracer.log_metric("ivf_active_tiles", float(ints[0, k]))
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
                if with_ce:
                    # device-computed stage-2 score: the per-request
                    # rerank reduces to a sort + slice
                    payload["rerank_score"] = float(c)
                hits.append(payload)
            # the fused path returns no query vectors (the staged one does)
            out.append((None, hits))
        self.tracer.log_metric("fused_assemble_ms", (time.time() - t_dev) * 1000)
        return out

    def _fused_exec(self, ids, types, mask, codes):
        """Device portion of the fused batch.  Captures (fused_fn, kind,
        index) together, reads each state snapshot once (a concurrent
        upsert/grow/rebuild must not pair new arrays with old ones
        mid-batch) and checks kind against the index type and geometry.
        Returns (rows, bi, ce, active_tiles) device tensors, active_tiles
        None on the flat tier and ce None where the hash stack leaves the
        rerank to the staged reranker, or None when the batch is
        ineligible."""
        fused, kind, geom, hash_rerank = self._fused
        index = self.index
        if fused is None:
            return None
        dev = index.device
        b = len(codes)
        bpad = ids.shape[0]
        qf = torch.as_tensor(
            list(codes) + [(-3, -3)] * (bpad - b), dtype=torch.int32, device=dev
        )
        t_ids, t_types, t_mask = (
            torch.as_tensor(a, device=dev) for a in (ids, types, mask)
        )
        hashed = kind in ("hash", "ivf_hash")
        if hashed:
            tables = (self.embedder.table,) + ((self.reranker.table,) if hash_rerank else ())
            batch = (*tables, t_ids, t_mask, qf)
        else:
            batch = (self.embedder.model, self.reranker.model, t_ids, t_types, t_mask, qf)
        if kind in ("full", "hash") and isinstance(index, FlatIndex):
            emb, idx_codes, doc_tok = index._arrays
            corpus, n_valid = (emb, idx_codes), (min(index.n_valid, emb.shape[0]),)
        elif kind in ("ivf_full", "ivf_hash") and isinstance(index, IVFIndex):
            st = index._state
            if st.tail:
                return None  # tail rows need the exact merge of the staged path
            if st.geom != geom:
                return None  # a churn rebuild re-derived the geometry
            if selective_rows(st.rows_by_ticker, codes, index.SELECTIVE_LIMIT) is not None:
                return None  # a selective filter is scored exactly, staged
            doc_tok = index.flat._arrays[2]
            corpus, n_valid = (st.centroids, st.packed_emb, st.packed_codes, st.packed_gids), ()
        elif kind == "hnsw_full" and isinstance(index, HNSWIndex):
            if index._tail_rows:
                return None  # tail rows need the exact merge of the staged path
            state = index._graph_state  # one read
            adj, entries, pad_id, _ef, rbt, _n, hier, pool = state
            pool_take = pool[3] if pool is not None else 0
            if (pad_id, hier is not None, pool_take) != geom:
                return None  # a rebuild changed the graph's geometry
            if selective_rows(rbt, codes, index.SELECTIVE_LIMIT) is not None:
                return None  # a selective filter is scored exactly, staged
            emb, idx_codes, doc_tok = index.flat._arrays
            if doc_tok is None:
                return None  # auto token store not yet materialized
            rows, bi, ce = fused(
                *batch, emb, idx_codes, adj, entries, doc_tok,
                pool[0] if pool_take > 0 else None, hier,
            )
            return rows, bi, ce, None
        else:
            return None  # a tier promotion raced the program swap
        store = () if hashed and not hash_rerank else (doc_tok,)
        if store and doc_tok is None:
            return None  # auto token store not yet materialized
        out = fused(*batch, *corpus, *store, *n_valid)
        active = out[-1] if kind.startswith("ivf") else None
        if not hashed:
            return (*out[:3], active)
        _qv, bi, rows = out[:3]
        if hash_rerank:
            ce = out[3]
        else:  # the identity reranker keeps retrieval order: ce == bi, exactly
            ce = bi if self.reranker.identity else None
        return rows, bi, ce, active

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

    def rebuild_index(self, tier: str | None = None) -> dict[str, Any]:
        """Promote the flat index to a sub-linear tier, or rebuild the
        current tier after tail growth.  Fusion re-evaluates afterwards.

        tier: "ivf" | "hnsw" | None (None keeps the current tier, or
        defaults a flat index to IVF).
        """
        if tier not in (None, "ivf", "hnsw"):
            return {"status": "error", "reason": f"unknown tier {tier!r}"}
        current = type(self.index).__name__
        if self.index.n_valid == 0:
            return {"status": "noop", "reason": "index empty"}
        flat = getattr(self.index, "flat", self.index)
        if not isinstance(flat, FlatIndex):
            return {"status": "noop", "reason": f"{current} has no tiers"}
        want = tier or {"HNSWIndex": "hnsw"}.get(current, "ivf")
        if want == "ivf":
            if isinstance(self.index, IVFIndex):
                self.index.rebuild()
            else:
                self.index = IVFIndex(flat, tile=min(flat.tile, 128))
        elif isinstance(self.index, HNSWIndex):
            self.index.rebuild()
        else:
            self.index = HNSWIndex(flat)
        self._fused = self._maybe_build_fused()
        return {
            "status": "ok",
            "tier": type(self.index).__name__,
            "clusters": getattr(self.index, "n_clusters", None),
            "tail_rows": len(self.index._tail_rows),
        }

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
