"""HTTP serving shell (aiohttp) and the default engine wiring.

Port of ``financial_rag_system_tpu/serving/app.py`` for the single-device
flat, IVF and HNSW tiers.  Endpoints and semantics follow the reference's
FastAPI surface:

- ``POST /ask``       {query, ticker, document_type?, top_k=5} -> answer doc
- ``POST /embed``     {texts: [...]} -> {embeddings: [[...]]}
- ``POST /feedback``  {query_hash, rating} -> {status: ok}
- ``DELETE /cache/clear/{ticker}`` -> {cleared_entries: N}
- ``POST /index/upsert``, ``POST /index/save`` (the active tier's files;
  other tiers' files in ``INDEX_DIR`` are deleted)
- ``POST /index/rebuild`` {tier?: "ivf" | "hnsw"} -> promote to / rebuild
  the IVF or HNSW tier (400 on a bad body or an unknown tier)
- ``GET /health`` ``/ready`` ``/queue_status`` ``/metrics`` ``/traces``

Validation uses pydantic and returns 422 on schema errors.  ``aiohttp``
and ``pydantic`` are imported inside :func:`create_app` and :func:`main`
only, so :func:`build_default_engine` imports where they are missing.
"""

from __future__ import annotations

import asyncio
import json
import os

import torch

from financial_rag_system_tpu_torch.index.hnsw import HNSWIndex
from financial_rag_system_tpu_torch.index.ivf import IVFIndex
from financial_rag_system_tpu_torch.obs.tracing import get_tracer
from financial_rag_system_tpu_torch.serving.engine import RAGEngine
from financial_rag_system_tpu_torch.utils.device import resolve_device

# tier files the JAX package may also have written to INDEX_DIR: a save
# deletes those that do not describe the saved tier, so a restart (of
# either package) never pairs them with a newer corpus
SHARDED_FILES = ("sharded_index.npz", "sharded_hnsw_graph.npz")
# at most one tier file survives a save; a restart restores the first found
TIER_FILES = ((HNSWIndex, HNSWIndex.GRAPH_FILE), (IVFIndex, IVFIndex.IVF_FILE))


def _models():
    from typing import Optional

    from pydantic import BaseModel

    class QueryRequest(BaseModel):
        query: str
        ticker: str
        document_type: Optional[str] = None
        top_k: int = 5

    class EmbedRequest(BaseModel):
        texts: list[str]

    class FeedbackRequest(BaseModel):
        query_hash: str
        rating: int

    class UpsertRequest(BaseModel):
        ids: list[str]
        texts: list[str]
        payloads: list[dict]

    return QueryRequest, EmbedRequest, FeedbackRequest, UpsertRequest


def create_app(engine: RAGEngine):
    from aiohttp import web
    from pydantic import ValidationError

    QueryRequest, EmbedRequest, FeedbackRequest, UpsertRequest = _models()

    def validation_error(exc: ValidationError) -> web.Response:
        return web.json_response({"detail": json.loads(exc.json())}, status=422)

    app = web.Application()

    async def on_startup(app: web.Application) -> None:
        await engine.startup()

    async def on_cleanup(app: web.Application) -> None:
        await engine.shutdown()

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)

    async def ask(request: web.Request) -> web.Response:
        try:
            req = QueryRequest.model_validate(await request.json())
        except ValidationError as exc:
            return validation_error(exc)
        try:
            result = await asyncio.wait_for(
                engine.ask(req.query, req.ticker, req.top_k, req.document_type),
                timeout=engine.cfg.request_timeout_s,
            )
        except asyncio.TimeoutError:
            return web.json_response({"detail": "request timed out"}, status=504)
        return web.json_response(result)

    async def embed(request: web.Request) -> web.Response:
        try:
            req = EmbedRequest.model_validate(await request.json())
        except ValidationError as exc:
            return validation_error(exc)
        return web.json_response({"embeddings": await engine.embed(req.texts)})

    async def feedback(request: web.Request) -> web.Response:
        try:
            req = FeedbackRequest.model_validate(await request.json())
        except ValidationError as exc:
            return validation_error(exc)
        await asyncio.to_thread(engine.feedback, req.query_hash, req.rating)
        return web.json_response({"status": "ok"})

    async def clear_cache(request: web.Request) -> web.Response:
        ticker = request.match_info["ticker"]
        count = await asyncio.to_thread(engine.clear_cache, ticker)
        return web.json_response({"cleared_entries": count})

    async def index_upsert(request: web.Request) -> web.Response:
        try:
            req = UpsertRequest.model_validate(await request.json())
        except ValidationError as exc:
            return validation_error(exc)
        if not (len(req.ids) == len(req.texts) == len(req.payloads)):
            return web.json_response(
                {"detail": "ids/texts/payloads length mismatch"}, status=422
            )
        new_rows = await engine.ingest_chunks(req.ids, req.texts, req.payloads)
        return web.json_response(
            {"new_rows": new_rows, "indexed_chunks": engine.index.n_valid}
        )

    async def index_save(request: web.Request) -> web.Response:
        directory = engine.cfg.index_dir
        idx = engine.index
        await asyncio.to_thread(idx.save, directory)
        stale = [*SHARDED_FILES] + [f for klass, f in TIER_FILES if not isinstance(idx, klass)]
        for fname in stale:
            path = os.path.join(directory, fname)
            if os.path.exists(path):
                os.unlink(path)
        return web.json_response({"saved_to": directory})

    async def index_rebuild(request: web.Request) -> web.Response:
        tier = None
        if request.can_read_body and await request.read():
            try:
                body = await request.json()
                tier = body.get("tier")
            except (json.JSONDecodeError, AttributeError):
                return web.json_response(
                    {"detail": "body must be a JSON object"}, status=400
                )
        if tier is not None and tier not in ("ivf", "hnsw"):
            return web.json_response(
                {"detail": f"unknown tier {tier!r}; expected ivf|hnsw"},
                status=400,
            )
        out = await asyncio.to_thread(engine.rebuild_index, tier)
        return web.json_response(out)

    async def health(request: web.Request) -> web.Response:
        return web.json_response({"status": "ok"})

    async def ready(request: web.Request) -> web.Response:
        return web.json_response(engine.ready())

    async def queue_status(request: web.Request) -> web.Response:
        return web.json_response(engine.queue_status())

    async def metrics(request: web.Request) -> web.Response:
        return web.json_response(get_tracer().metrics_snapshot())

    async def traces(request: web.Request) -> web.Response:
        n = int(request.query.get("n", 20))
        return web.json_response(get_tracer().recent_traces(n))

    app.add_routes(
        [
            web.post("/ask", ask),
            web.post("/embed", embed),
            web.post("/feedback", feedback),
            web.delete("/cache/clear/{ticker}", clear_cache),
            web.post("/index/upsert", index_upsert),
            web.post("/index/save", index_save),
            web.post("/index/rebuild", index_rebuild),
            web.get("/health", health),
            web.get("/ready", ready),
            web.get("/queue_status", queue_status),
            web.get("/metrics", metrics),
            web.get("/traces", traces),
        ]
    )
    return app


def build_default_engine(
    mode: str = "batched", device: str | torch.device = "cuda"
) -> RAGEngine:
    """Wire an engine from env config on one device: the persisted index
    in ``INDEX_DIR`` if there is one (flat, promoted to the HNSW or the
    IVF tier when an ``hnsw_graph.npz`` or an ``ivf_index.npz`` that
    covers it is there; bf16 or int8 as it was saved), else an empty
    flat index of ``RAG_TPU_INDEX_DTYPE`` (``bfloat16`` or ``int8``).
    Models come from ``RAG_TPU_BGE_DIR`` / ``RAG_TPU_RERANKER_DIR``;
    without them the hermetic hash stack serves, with the identity
    reranker in TESTING mode, so the server starts with no files on
    disk."""
    from financial_rag_system_tpu_torch.index.flat import FlatIndex
    from financial_rag_system_tpu_torch.models.embedder import get_embedder
    from financial_rag_system_tpu_torch.models.reranker import get_reranker
    from financial_rag_system_tpu_torch.utils.config import get_config

    dev = resolve_device(device)
    cfg = get_config()
    dtypes = {"bfloat16": torch.bfloat16, "int8": torch.int8}
    if cfg.index_dtype not in dtypes:
        raise ValueError(f"RAG_TPU_INDEX_DTYPE {cfg.index_dtype!r}: bfloat16 or int8")
    embedder = get_embedder(cfg.embed_dim, device=dev)
    reranker = get_reranker(testing=cfg.testing, device=dev)
    # a device token store lets the fused pipeline rerank without host
    # round trips; 0 = auto: it materializes at the measured p99
    # wordpiece width on the first ingest (index/flat.py auto_token_width)
    tok = embedder.tokenizer
    if os.path.exists(os.path.join(cfg.index_dir, "flat_index.npz")):
        index = FlatIndex.load(cfg.index_dir, tokenizer=tok, device=dev)
        for klass, fname in TIER_FILES:
            if os.path.exists(os.path.join(cfg.index_dir, fname)):
                try:
                    index = klass.load(cfg.index_dir, index)
                except ValueError as exc:  # stale file: serve flat instead
                    print(f"ignoring persisted {klass.__name__}: {exc}")
                break
    else:
        index = FlatIndex(
            embedder.dim, tile=cfg.corpus_tile,
            token_store_len=cfg.token_store_len or "auto", tokenizer=tok,
            token_store_max=cfg.token_store_max, device=dev,
            dtype=dtypes[cfg.index_dtype],
        )
    return RAGEngine(cfg, index, embedder, reranker, mode=mode)


def main() -> None:  # pragma: no cover — needs a card
    from aiohttp import web

    from financial_rag_system_tpu_torch.utils.config import get_config

    cfg = get_config()
    engine = build_default_engine()
    web.run_app(create_app(engine), host=cfg.host, port=cfg.port)


if __name__ == "__main__":  # pragma: no cover
    main()
