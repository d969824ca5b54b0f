"""The port's serving engine and HTTP shell on the CPU.

``build_default_engine(device="cpu")`` over tiny random HF checkpoints
written by the port's own exporter; TESTING mode (mock LLM), an
in-memory cache and an auto-sized token store.  Mirrors the behavioral
assertions of tests/test_serving.py for the fused "full" path.
"""

from __future__ import annotations

import asyncio
import hashlib

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from financial_rag_system_tpu_torch.models import bert
from financial_rag_system_tpu_torch.models.hf_export import save_bert_checkpoint
from financial_rag_system_tpu_torch.obs.tracing import get_tracer
from financial_rag_system_tpu_torch.serving.app import build_default_engine, create_app
from financial_rag_system_tpu_torch.serving.llm import MOCK_ANSWER
from financial_rag_system_tpu_torch.utils.config import reset_config

TINY = dict(vocab_size=30522, hidden=64, layers=2, heads=2, intermediate=128,
            with_pooler=True)
TOPICS = ["revenue", "margin", "supply chain", "cloud growth", "buybacks", "risk"]


def chunks():
    ids, texts, payloads = [], [], []
    for i in range(48):
        ticker = "AAPL" if i % 3 else "MSFT"
        ids.append(f"c{i}")
        texts.append(
            f"{ticker} filing note {i}: {TOPICS[i % len(TOPICS)]} " * (1 + i % 4)
        )
        payloads.append({"ticker": ticker, "document_type": "10-K" if i % 2 else "10-Q",
                         "source_file": f"f{i}"})
    return ids, texts, payloads


def write_checkpoint(path, seed, **extra):
    cfg = bert.BertConfig(**TINY, **extra)
    model = bert.BertModel(cfg, device="cpu")
    bert.load_jax_params(model, bert.init_params(torch.Generator().manual_seed(seed), cfg))
    save_bert_checkpoint(model, cfg, str(path), cross_encoder=bool(extra))


@pytest.fixture()
def env(tmp_path, monkeypatch):
    write_checkpoint(tmp_path / "bge", 0)
    write_checkpoint(tmp_path / "rr", 1, num_labels=1)
    monkeypatch.setenv("RAG_TPU_BGE_DIR", str(tmp_path / "bge"))
    monkeypatch.setenv("RAG_TPU_RERANKER_DIR", str(tmp_path / "rr"))
    monkeypatch.setenv("INDEX_DIR", str(tmp_path / "index"))
    monkeypatch.setenv("DATABASE_URL", ":memory:")
    monkeypatch.setenv("TESTING", "true")
    monkeypatch.setenv("RAG_TPU_CB_PATH", str(tmp_path / "cb.json"))
    monkeypatch.setenv("RAG_TPU_BATCH_WINDOW_S", "0.01")
    reset_config()
    yield tmp_path
    reset_config()


def make_engine(**kw):
    eng = build_default_engine(device="cpu", **kw)
    asyncio.run(eng.ingest_chunks(*chunks()))
    return eng


def test_fused_ask_schema_cache_and_rerank(env):
    eng = make_engine()
    assert eng.queue_status()["fused_kind"] == "full"
    assert eng.index._doc_tok is not None  # auto store materialized
    query = "What was AAPL revenue?"

    async def scenario():
        await eng.startup()
        try:
            r1 = await eng.ask(query, "AAPL", top_k=3)
            await asyncio.sleep(0.05)  # write-behind
            r2 = await eng.ask(query, "AAPL", top_k=3)
        finally:
            await eng.shutdown()
        return r1, r2

    r1, r2 = asyncio.run(scenario())
    assert set(r1) == {"query_hash", "query", "answer", "sources", "cached", "provider"}
    assert r1["query_hash"] == hashlib.sha256(f"AAPL_{query.lower()}".encode()).hexdigest()
    assert r1["cached"] is False and r1["answer"] == MOCK_ANSWER
    assert len(r1["sources"]) == 3
    scores = [s["score"] for s in r1["sources"]]
    assert scores == sorted(scores, reverse=True)
    assert all(set(s) == {"score", "text", "document_type"} for s in r1["sources"])
    assert all("AAPL" in s["text"] for s in r1["sources"])
    assert r2["cached"] is True and r2["provider"] == "Cache"
    assert r2["query_hash"] == r1["query_hash"]
    assert r2["sources"] == [
        {"score": 1.0, "text": "Semantic Cache", "document_type": "Cache"}
    ]


def test_fused_batch_retrieves_15_with_device_rerank(env):
    eng = make_engine()
    out = eng._dispatch_batch(
        ["revenue growth", "cloud", "risk factors"],
        [("AAPL", None), ("MSFT", None), ("AAPL", "10-K")],
    )
    hits = [h for _, h in out]
    assert len(hits[0]) == 15 and len(hits[1]) == 15
    assert all(h["ticker"] == "AAPL" and h["document_type"] == "10-K" for h in hits[2])
    for hs in hits:
        assert all("rerank_score" in h and np.isfinite(h["rerank_score"]) for h in hs)
        assert [h["score"] for h in hs] == sorted((h["score"] for h in hs), reverse=True)
    snap = get_tracer().metrics_snapshot()
    for name in ("fused_tokenize_ms", "fused_device_ms", "fused_assemble_ms"):
        assert snap[name]["count"] >= 1


def test_staged_path_matches_fused_retrieval(env):
    eng = make_engine(mode="sequential")
    queries, filters = ["margin", "buybacks"], [("AAPL", None), (None, "10-Q")]
    fused = eng._fused_batch(queries, filters)
    staged = eng._embed_retrieve_batch(queries, filters)
    for (_, f), (vec, s) in zip(fused, staged):
        assert vec.shape == (64,)
        assert [h["row"] for h in f] == [h["row"] for h in s]
        np.testing.assert_allclose(
            [h["score"] for h in f], [h["score"] for h in s], atol=1e-5
        )
    logits = eng.reranker.score("margin", [h["text"] for h in staged[0][1]])
    assert logits.shape == (15,) and np.isfinite(logits).all()
    resp = asyncio.run(eng.ask("margin trend", "MSFT", top_k=2))
    assert len(resp["sources"]) == 2


def test_persisted_index_reloads(env):
    eng = make_engine()
    eng.index.save(str(env / "index"))
    eng2 = build_default_engine(device="cpu")
    assert eng2.index.n_valid == 48
    assert eng2.queue_status()["fused_kind"] == "full"
    assert torch.equal(eng2.index._doc_tok, eng.index._doc_tok)
    a = eng._fused_batch(["revenue"], [("AAPL", None)])[0][1]
    b = eng2._fused_batch(["revenue"], [("AAPL", None)])[0][1]
    assert [h["row"] for h in a] == [h["row"] for h in b]


def test_http_shell(env):
    eng = make_engine()

    async def scenario():
        async with TestClient(TestServer(create_app(eng))) as client:
            r = await client.post("/ask", json={"query": "no ticker"})
            assert r.status == 422
            body = {"query": "AAPL supply chain", "ticker": "AAPL", "top_k": 2}
            doc = await (await client.post("/ask", json=body)).json()
            assert doc["cached"] is False and len(doc["sources"]) == 2
            st = await (await client.get("/queue_status")).json()
            assert st["fused_kind"] == "full" and st["index_tier"] == "FlatIndex"
            ready = await (await client.get("/ready")).json()
            assert ready == {"status": "ready", "indexed_chunks": 48}
            emb = await (await client.post("/embed", json={"texts": ["a", "b"]})).json()
            v = np.asarray(emb["embeddings"])
            assert v.shape == (2, 64)
            np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, rtol=1e-4)
            r = await client.post("/feedback", json={"query_hash": "x", "rating": 1})
            assert (await r.json())["status"] == "ok"

    asyncio.run(scenario())


def test_concurrent_asks_share_a_batch(env):
    eng = make_engine()
    sizes = []
    inner = eng.batcher.batch_fn

    def batch_fn(queries, filters):
        sizes.append(len(queries))
        return inner(queries, filters)

    eng.batcher.batch_fn = batch_fn

    async def scenario():
        await eng.startup()
        try:
            return await asyncio.gather(*[
                eng.ask(f"question {i} about revenue", "AAPL") for i in range(6)
            ])
        finally:
            await eng.shutdown()

    docs = asyncio.run(scenario())
    assert len({d["query_hash"] for d in docs}) == 6
    assert all(len(d["sources"]) == 5 for d in docs)
    assert sum(sizes) == 6 and max(sizes) >= 2
