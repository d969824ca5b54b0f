"""HTTP serving shell (aiohttp) and the default engine wiring.

Port of ``financial_rag_system_tpu/serving/app.py``: the flat, IVF and
HNSW tiers on one device, or with the corpus sharded over a mesh
(``build_default_engine(mesh_devices=...)``, or every visible card when
there are several), and multi-process serving over ``torch.distributed``
(:func:`main`: the coordinator owns HTTP and the op-broadcast control
plane, the workers run its op stream).  Endpoints and semantics follow
the reference's FastAPI surface:

- ``POST /ask``       {query, ticker, document_type?, top_k=5} -> answer doc
- ``POST /embed``     {texts: [...]} -> {embeddings: [[...]]}
- ``POST /feedback``  {query_hash, rating} -> {status: ok}
- ``DELETE /cache/clear/{ticker}`` -> {cleared_entries: N}
- ``POST /index/upsert``, ``POST /index/save`` (the active tier's files;
  other tiers' and the other family's files in ``INDEX_DIR`` are
  deleted: a sharded save removes ``flat_index.npz`` and the
  single-device tier files, a single-device save the sharded ones)
- ``POST /index/rebuild`` {tier?: "ivf" | "hnsw"} -> promote to / rebuild
  the IVF or HNSW tier (400 on a bad body or an unknown tier)
- ``GET /health`` ``/ready`` ``/queue_status`` ``/metrics`` ``/traces``
- ``GET /traces/mlflow`` and ``/traces/otlp``: the recent spans in
  MLflow's trace schema and as an OTLP/HTTP JSON export body
  (``obs/mlflow_export.py``, ``obs/otlp_export.py``); ``GET /`` the
  browser chat page (``serving/ui.py``)

The app starts the trace-export pump (``obs/export_loop.py``) when the
environment wires an MLflow server or an OTLP collector, and stops it on
cleanup.

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
from financial_rag_system_tpu_torch.index.sharded import ShardedFlatIndex
from financial_rag_system_tpu_torch.index.sharded_hnsw import ShardedHNSWIndex
from financial_rag_system_tpu_torch.obs.tracing import get_tracer
from financial_rag_system_tpu_torch.serving.engine import RAGEngine
from financial_rag_system_tpu_torch.utils.device import resolve_device

# the two families of index files in INDEX_DIR (either package writes
# them): a save deletes the other family's and the other tiers' files,
# so a restart never pairs them with a newer corpus
FLAT_FILES = ("flat_index.npz", HNSWIndex.GRAPH_FILE, IVFIndex.IVF_FILE)
SHARDED_FILES = ("sharded_index.npz", ShardedHNSWIndex.GRAPH_FILE)
# at most one tier file survives a save; a restart restores the first found
TIER_FILES = ((HNSWIndex, HNSWIndex.GRAPH_FILE), (IVFIndex, IVFIndex.IVF_FILE))


def stale_files(index) -> list[str]:
    """The files in INDEX_DIR that a save of ``index`` leaves stale (JAX
    ``app.py:140-165``); a BroadcastIndex is judged by its inner tier."""
    tier = getattr(index, "inner", index)
    if isinstance(getattr(tier, "flat", tier), ShardedFlatIndex):
        keep = {ShardedHNSWIndex.GRAPH_FILE} if isinstance(tier, ShardedHNSWIndex) else set()
        return [*FLAT_FILES, *(f for f in SHARDED_FILES[1:] if f not in keep)]
    return [*SHARDED_FILES, *(f for klass, f in TIER_FILES if not isinstance(tier, klass))]


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
    export_loop = []

    async def on_startup(app: web.Application) -> None:
        await engine.startup()
        # continuous observability export, off the request path; started
        # only when the environment wires a sink
        from financial_rag_system_tpu_torch.obs.export_loop import maybe_start_export_loop

        export_loop.append(maybe_start_export_loop(get_tracer()))

    async def on_cleanup(app: web.Application) -> None:
        await engine.shutdown()
        for loop in export_loop:
            if loop is not None:
                await asyncio.to_thread(loop.stop)
        export_loop.clear()

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
        # the sharded IVF tier persists through its flat index (its
        # packing rebuilds deterministically)
        target = idx if hasattr(idx, "save") else idx.flat
        await asyncio.to_thread(target.save, directory)
        for fname in stale_files(idx):
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

    async def traces_mlflow(request: web.Request) -> web.Response:
        from financial_rag_system_tpu_torch.obs.mlflow_export import to_mlflow_traces

        n = int(request.query.get("n", 100))
        return web.json_response(to_mlflow_traces(get_tracer().recent_traces(n)))

    async def traces_otlp(request: web.Request) -> web.Response:
        from financial_rag_system_tpu_torch.obs.otlp_export import to_otlp

        n = int(request.query.get("n", 100))
        return web.json_response(to_otlp(get_tracer().recent_traces(n)))

    async def ui(request: web.Request) -> web.Response:
        from financial_rag_system_tpu_torch.serving.ui import PAGE

        return web.Response(text=PAGE, content_type="text/html")

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
            web.get("/traces/mlflow", traces_mlflow),
            web.get("/traces/otlp", traces_otlp),
            web.get("/", ui),
        ]
    )
    return app


def build_default_engine(
    mode: str = "batched", device: str | torch.device = "cuda",
    mesh_devices: list[str | torch.device] | None = None,
) -> RAGEngine:
    """Wire an engine from env config: the persisted index in
    ``INDEX_DIR`` if there is one (flat, promoted to the HNSW or the IVF
    tier when an ``hnsw_graph.npz`` or an ``ivf_index.npz`` that covers
    it is there; bf16 or int8 as it was saved), else an empty flat index
    of ``RAG_TPU_INDEX_DTYPE`` (``bfloat16`` or ``int8``).  Models come
    from ``RAG_TPU_BGE_DIR`` / ``RAG_TPU_RERANKER_DIR``; without them the
    hermetic hash stack serves, with the identity reranker in TESTING
    mode, so the server starts with no files on disk.

    The corpus shards over a mesh (``RAG_TPU_MESH``, parallel/mesh.py)
    when ``mesh_devices`` names its devices (one device may repeat:
    ``["cuda:0"] * 4``), or when ``device`` is a card and there are
    several cards or processes (JAX's ``len(jax.devices()) > 1``): then
    ``sharded_index.npz`` is restored, promoted by a
    ``sharded_hnsw_graph.npz`` that covers it, else a fresh
    ``ShardedFlatIndex`` of ``RAG_TPU_MAX_CORPUS`` rows starts.  The
    models live on ``device``, the mesh's first device."""
    from financial_rag_system_tpu_torch.index.flat import FlatIndex
    from financial_rag_system_tpu_torch.models.embedder import get_embedder
    from financial_rag_system_tpu_torch.models.reranker import get_reranker
    from financial_rag_system_tpu_torch.parallel.distributed import process_count
    from financial_rag_system_tpu_torch.parallel.mesh import create_mesh
    from financial_rag_system_tpu_torch.utils.config import get_config

    dev = resolve_device(device)
    cfg = get_config()
    dtypes = {"bfloat16": torch.bfloat16, "int8": torch.int8}
    if cfg.index_dtype not in dtypes:
        raise ValueError(f"RAG_TPU_INDEX_DTYPE {cfg.index_dtype!r}: bfloat16 or int8")
    mesh = None
    if mesh_devices is not None or (
        dev.type == "cuda" and (torch.cuda.device_count() > 1 or process_count() > 1)
    ):
        mesh = create_mesh(cfg.mesh_shape, devices=mesh_devices)
        dev = mesh.home
    embedder = get_embedder(cfg.embed_dim, device=dev)
    reranker = get_reranker(testing=cfg.testing, device=dev)
    # a device token store lets the fused pipeline rerank without host
    # round trips; 0 = auto: it materializes at the measured p99
    # wordpiece width on the first ingest (index/flat.py auto_token_width)
    tok = embedder.tokenizer
    if mesh is not None:
        index = _sharded_index(cfg, mesh, embedder.dim, tok, dtypes[cfg.index_dtype])
    elif os.path.exists(os.path.join(cfg.index_dir, "flat_index.npz")):
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


def _sharded_index(cfg, mesh, dim: int, tok, dtype: torch.dtype):
    """The mesh path of :func:`build_default_engine` (JAX ``app.py:286-335``)."""
    if os.path.exists(os.path.join(cfg.index_dir, "sharded_index.npz")):
        index = ShardedFlatIndex.load(cfg.index_dir, mesh, tokenizer=tok)
        if os.path.exists(os.path.join(cfg.index_dir, ShardedHNSWIndex.GRAPH_FILE)):
            try:
                index = ShardedHNSWIndex.load(cfg.index_dir, index)
            except ValueError as exc:  # stale or mismatched: serve flat
                print(f"ignoring persisted ShardedHNSWIndex: {exc}")
        return index
    if os.path.exists(os.path.join(cfg.index_dir, "flat_index.npz")):
        print("warning: a single-device flat_index.npz exists but sharded serving "
              "starts a fresh sharded index — re-ingest or save under this topology")
    return ShardedFlatIndex(
        mesh, dim, capacity=cfg.max_corpus, tile=cfg.corpus_tile, dtype=dtype,
        token_store_len=cfg.token_store_len or "auto", tokenizer=tok,
        token_store_max=cfg.token_store_max,
    )


def attach_control_plane(engine: RAGEngine, cfg):
    """Coordinator side of multi-process serving: bind the control
    channel, wait for every worker, wrap the index in a BroadcastIndex,
    re-evaluate fusion (the program targets the INNER index and each
    batch becomes one broadcast op) and warm the collectives up with a
    k=1 search while every process is at the rendezvous.  Returns the
    ControlServer (shut it down to release the workers)."""
    import numpy as np

    from financial_rag_system_tpu_torch.parallel.control import BroadcastIndex, ControlServer
    from financial_rag_system_tpu_torch.parallel.distributed import process_count

    # the control channel carries pickled ops: bind it to the pod-internal
    # interface (FRS_CONTROL_HOST), not the public HTTP host;
    # FRS_CONTROL_TOKEN adds the HMAC handshake (parallel/control.py)
    control_host = os.environ.get("FRS_CONTROL_HOST", cfg.host)
    server = ControlServer(control_host, cfg.control_port, process_count() - 1)
    engine.index = BroadcastIndex(server, engine.index)
    engine._fused = engine._maybe_build_fused()
    engine.index.search_device(
        np.zeros((1, engine.embedder.dim), np.float32), np.full((1, 2), -1, np.int32), 1
    )
    return server


def main(argv: list[str] | None = None) -> None:  # pragma: no cover — a server
    """Serve HTTP; under ``JAX_COORDINATOR_ADDRESS`` /
    ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` (parallel/distributed.py)
    rank 0 serves and drives the other ranks through the control plane,
    which run its op stream and bind nothing.  ``--device cpu`` with
    ``--mesh-devices cpu,cpu`` runs a CPU mesh (gloo between processes)."""
    import argparse

    from aiohttp import web

    from financial_rag_system_tpu_torch.parallel.control import worker_loop
    from financial_rag_system_tpu_torch.parallel.distributed import (
        initialize_distributed,
        is_coordinator,
    )
    from financial_rag_system_tpu_torch.utils.config import get_config

    parser = argparse.ArgumentParser(description="financial RAG server (PyTorch port)")
    parser.add_argument("--device", default="cuda", help="the models' device (default cuda)")
    parser.add_argument("--mesh-devices", default=None,
                        help="comma-separated devices of this process's corpus shards, "
                             "e.g. cuda:0,cuda:0 (default: every visible card when there "
                             "are several cards or processes)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    multi = initialize_distributed(backend="gloo" if dev.type == "cpu" else None)
    cfg = get_config()
    engine = build_default_engine(
        device=dev,
        mesh_devices=args.mesh_devices.split(",") if args.mesh_devices else None,
    )
    if multi and is_coordinator():
        server = attach_control_plane(engine, cfg)
        try:
            web.run_app(create_app(engine), host=cfg.host, port=cfg.port)
        finally:
            server.shutdown()  # releases the parked workers
        return
    if multi:
        # workers run the coordinator's op stream so every collective
        # (upsert, search, fused batch, rebuild, save) runs on every
        # process; no HTTP port is bound here
        print("worker process: serving handled by the coordinator", flush=True)
        coord_host = os.environ["JAX_COORDINATOR_ADDRESS"].rsplit(":", 1)[0]
        worker_loop(engine.index, coord_host, cfg.control_port, engine=engine)
        return
    web.run_app(create_app(engine), host=cfg.host, port=cfg.port)


if __name__ == "__main__":  # pragma: no cover
    main()
