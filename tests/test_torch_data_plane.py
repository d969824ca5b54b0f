"""The port's data plane on the CPU: chunker, ingestion (local and over
HTTP, against the port's app), the EDGAR client and the scheduler.

A port of ``tests/test_data_plane.py`` to the port's modules and the
port's app on a CPU engine (the hash stack over a CPU flat index), plus
the same chunk batches as the JAX package's ``chunks_from_file``, the
EDGAR client on a fake transport against JAX's, and the remote
ingestion flow against the port's server on 127.0.0.1.
"""

from __future__ import annotations

import asyncio
import threading
from datetime import datetime, timezone

import pytest
from aiohttp.test_utils import TestClient, TestServer

from financial_rag_system_tpu.data import edgar as jedgar
from financial_rag_system_tpu.data import ingest as jingest
from financial_rag_system_tpu_torch.data import edgar
from financial_rag_system_tpu_torch.data.chunker import split_text
from financial_rag_system_tpu_torch.data.ingest import (
    EMBED_BATCH,
    UPSERT_BATCH,
    ChunkBatch,
    chunks_from_file,
    extract_text_from_html,
    ingest_files,
    ingest_local,
    run_ingestion,
)
from financial_rag_system_tpu_torch.data.scheduler import IngestionScheduler, next_run_at
from financial_rag_system_tpu_torch.index.flat import FlatIndex
from financial_rag_system_tpu_torch.models.embedder import HashEmbedder
from financial_rag_system_tpu_torch.models.reranker import HashReranker
from financial_rag_system_tpu_torch.serving.app import create_app
from financial_rag_system_tpu_torch.serving.cache import CacheDB
from financial_rag_system_tpu_torch.serving.engine import RAGEngine
from financial_rag_system_tpu_torch.utils.config import Config

DOCS = [
    ("Apple reported revenue of 89.5 billion dollars for the quarter", "AAPL"),
    ("Apple gross margin expanded to 45.2 percent on services growth", "AAPL"),
    ("Apple faces supply chain risk concentrated in asia", "AAPL"),
    ("Microsoft cloud revenue grew 24 percent year over year", "MSFT"),
    ("Microsoft operating income increased on azure strength", "MSFT"),
]


def make_engine(tmp_path, mode="batched"):
    """``tests/test_serving.py make_engine`` on the port: TESTING mode, the
    hash stack and a CPU flat index of ``DOCS``."""
    cfg = Config(testing=True, database_url=":memory:", batch_window_s=0.01,
                 breaker_state_path=str(tmp_path / "cb.json"))
    emb = HashEmbedder(dim=cfg.embed_dim, device="cpu")
    index = FlatIndex(cfg.embed_dim, capacity=128, tile=128, device="cpu")
    index.upsert([f"d{i}" for i in range(len(DOCS))], emb.encode([d for d, _ in DOCS]),
                 [d for d, _ in DOCS],
                 [{"ticker": t, "document_type": "10-Q", "source_file": f"f{i}"}
                  for i, (_, t) in enumerate(DOCS)])
    return RAGEngine(cfg, index, emb, HashReranker(device="cpu"), mode=mode)


def test_split_text_sizes():
    text = "\n\n".join(
        " ".join(f"word{i}_{j}" for j in range(40)) for i in range(30)
    )
    chunks = split_text(text, chunk_size=1000, overlap=200)
    assert chunks
    assert all(len(c) <= 1000 for c in chunks)
    assert all(c.strip() for c in chunks)
    # overlap: consecutive chunks share trailing/leading content
    assert any(chunks[i][-50:] in chunks[i + 1] for i in range(len(chunks) - 1))


def test_split_text_hard_wrap():
    # no separators at all: must hard-wrap rather than loop forever
    chunks = split_text("x" * 5000, chunk_size=1000, overlap=200)
    assert all(len(c) <= 1000 for c in chunks)
    assert sum(len(c) for c in chunks) >= 5000  # overlap duplicates allowed


def test_split_drops_blank():
    assert split_text("\n\n \n\n  \n\n", 100, 10) == []


def test_extract_text_from_html():
    html = "<html><body><h1>Report</h1><p>Revenue was $1B.</p></body></html>"
    text = extract_text_from_html(html)
    assert "Report" in text and "Revenue was $1B." in text
    assert "<p>" not in text


def test_chunks_from_file_deterministic_ids(tmp_path):
    p = tmp_path / "filing.html"
    p.write_text("<html><body>" + "Revenue grew. " * 500 + "</body></html>")
    b1 = chunks_from_file(str(p), "AAPL", "10-K")
    b2 = chunks_from_file(str(p), "AAPL", "10-K")
    assert b1.ids == b2.ids  # idempotent re-ingestion (md5 point ids)
    assert len(set(b1.ids)) == len(b1.ids)
    assert all(pl["ticker"] == "AAPL" for pl in b1.payloads)


@pytest.mark.parametrize("suffix", [".html", ".txt"])
def test_chunks_from_file_match_jax(tmp_path, suffix):
    """The same file gives the JAX package's ids, texts and payloads (but
    the ingestion time)."""
    p = tmp_path / f"10k{suffix}"
    body = "\n\n".join(f"Segment {i}: revenue rose {i} percent on services. " * 9
                       for i in range(40))
    p.write_text(f"<html><body><p>{body}</p></body></html>" if suffix == ".html" else body)
    got, want = chunks_from_file(str(p), "nvda", "10-k"), jingest.chunks_from_file(
        str(p), "nvda", "10-k")
    assert len(got.ids) > 5
    assert got.ids == want.ids and got.texts == want.texts
    strip = lambda pays: [{k: v for k, v in d.items() if k != "ingested_at"} for d in pays]
    assert strip(got.payloads) == strip(want.payloads)
    assert got.payloads[0]["ticker"] == "NVDA" and got.payloads[0]["document_type"] == "10-K"
    assert (EMBED_BATCH, UPSERT_BATCH) == (jingest.EMBED_BATCH, jingest.UPSERT_BATCH) == (64, 256)


def test_ingest_files_and_cache_invalidation(tmp_path):
    p = tmp_path / "filing.html"
    p.write_text("<html><body>" + "Apple revenue grew strongly. " * 300 + "</body></html>")
    emb = HashEmbedder(dim=128, device="cpu")
    index = FlatIndex(dim=128, capacity=256, tile=128, device="cpu")
    cache = CacheDB(":memory:")
    cache.save("h1", "AAPL", "q", "a")
    cache.save("h2", "MSFT", "q", "a")
    n = ingest_files(index, emb, "AAPL", "10-K", [str(p)], cache=cache)
    assert n > 0
    assert index.n_valid == n
    # ticker cache invalidated, others kept (reference ingest.py:185-193)
    assert cache.lookup("h1", "AAPL") is None
    assert cache.lookup("h2", "MSFT") == "a"
    # re-ingest: no new rows
    assert ingest_files(index, emb, "AAPL", "10-K", [str(p)]) == 0


def test_ingest_local_upserts_in_batches(tmp_path):
    """``ingest_local`` embeds and upserts ``upsert_batch`` chunks at a
    time, and the rows it adds are the embedder's vectors."""
    import numpy as np

    emb = HashEmbedder(dim=64, device="cpu")
    index = FlatIndex(dim=64, capacity=256, tile=128, device="cpu")
    calls = []
    upsert = index.upsert

    def counted(ids, vecs, texts, payloads):
        calls.append(len(ids))
        return upsert(ids, vecs, texts, payloads)

    index.upsert = counted
    texts = [f"chunk {i} about cloud revenue" for i in range(10)]
    batch = ChunkBatch([f"c{i}" for i in range(10)], texts, [{"ticker": "MSFT"}] * 10)
    assert ingest_local(index, emb, batch, upsert_batch=4) == 10
    assert calls == [4, 4, 2]
    hits = index.search(emb.encode([texts[7]]), k=1)[0]
    assert hits[0]["text"] == texts[7]
    assert np.isclose(hits[0]["score"], 1.0, atol=1e-2)


def test_http_upsert_roundtrip(tmp_path):
    async def t():
        engine = make_engine(tmp_path)
        app = create_app(engine)
        async with TestClient(TestServer(app)) as client:
            before = engine.index.n_valid
            batch = ChunkBatch(
                ids=["x1", "x2"],
                texts=["nvidia data center revenue", "nvidia gaming segment"],
                payloads=[
                    {"ticker": "NVDA", "document_type": "10-K", "source_file": "s"}
                ]
                * 2,
            )
            r = await client.post(
                "/index/upsert",
                json={"ids": batch.ids, "texts": batch.texts, "payloads": batch.payloads},
            )
            body = await r.json()
            assert body["new_rows"] == 2
            assert body["indexed_chunks"] == before + 2
            # now retrievable with the NVDA filter
            ask = await (
                await client.post(
                    "/ask",
                    json={"query": "data center revenue", "ticker": "NVDA"},
                )
            ).json()
            assert ask["sources"]
            assert all("nvidia" in s["text"] for s in ask["sources"])

    asyncio.run(t())


def test_remote_ingestion_against_the_port_server(tmp_path):
    """``run_ingestion``'s reference flow over HTTP (readiness poll,
    chunk batches to ``/index/upsert``, the ticker's cache cleared) from
    already-downloaded files into the port's server on 127.0.0.1."""
    d = tmp_path / "data" / "sec_data" / "NVDA" / "10-K"
    d.mkdir(parents=True)
    (d / "a.txt").write_text("NVIDIA data center revenue tripled on accelerators. " * 60)
    want = chunks_from_file(str(d / "a.txt"), "NVDA", "10-K")

    async def t():
        engine = make_engine(tmp_path)
        app = create_app(engine)
        async with TestClient(TestServer(app, host="127.0.0.1")) as client:
            url = str(client.make_url("")).rstrip("/")
            before = engine.index.n_valid
            n = await asyncio.to_thread(run_ingestion, "NVDA", ("10-K",), backend_url=url,
                                        data_dir=str(tmp_path / "data"), download=False)
            assert n == len(want.ids) and engine.index.n_valid == before + n
            again = await asyncio.to_thread(run_ingestion, "NVDA", ("10-K",), backend_url=url,
                                            data_dir=str(tmp_path / "data"), download=False)
            assert again == 0  # md5 point ids: a re-ingest adds nothing
            ask = await (await client.post(
                "/ask", json={"query": "data center accelerators", "ticker": "NVDA"})).json()
            assert ask["sources"] and all("NVIDIA" in s["text"] for s in ask["sources"])

    asyncio.run(t())


class _Response:
    def __init__(self, payload=None, text=""):
        self.payload, self.text = payload, text

    def raise_for_status(self):
        pass

    def json(self):
        return self.payload


class _FakeSession:
    """The EDGAR endpoints as a fake transport: no network."""

    def __init__(self):
        self.urls = []

    def get(self, url, headers=None, timeout=None):
        self.urls.append(url)
        assert headers["User-Agent"]
        if url == edgar.EDGAR_TICKERS_URL:
            return _Response({"0": {"ticker": "AAPL", "cik_str": 320193},
                              "1": {"ticker": "NVDA", "cik_str": 1045810}})
        if "submissions" in url:
            return _Response({"filings": {"recent": {
                "form": ["10-Q", "10-K", "8-K", "10-K"],
                "accessionNumber": ["0001-23-1", "0001-23-2", "0001-23-3", "0001-22-9"],
                "primaryDocument": ["q.htm", "k.htm", "e.htm", "k22.htm"]}}})
        return _Response(text=f"<html><body>filing at {url}</body></html>")


def test_edgar_client_on_a_fake_transport_matches_jax(tmp_path):
    got_s, want_s = _FakeSession(), _FakeSession()
    assert edgar.ticker_to_cik("nvda", got_s) == jedgar.ticker_to_cik("nvda", want_s) == 1045810
    with pytest.raises(KeyError):
        edgar.ticker_to_cik("NOPE", got_s)
    assert edgar.list_filings(1045810, "10-K", 2, got_s) == jedgar.list_filings(
        1045810, "10-K", 2, want_s) == [{"accession": "0001232", "document": "k.htm"},
                                        {"accession": "0001229", "document": "k22.htm"}]
    paths = edgar.download_filings("NVDA", "10-K", 1, str(tmp_path / "port"), got_s)
    jpaths = jedgar.download_filings("NVDA", "10-K", 1, str(tmp_path / "jax"), want_s)
    assert [p.replace("port", "jax") for p in paths] == jpaths
    assert open(paths[0]).read() == open(jpaths[0]).read()
    assert paths[0].endswith("sec_data/NVDA/10-K/0001232.html")
    assert got_s.urls[-1] == edgar.EDGAR_ARCHIVES_URL.format(cik=1045810, accession="0001232",
                                                             doc="k.htm")


def test_scheduler_lock_skips_overlap():
    started = threading.Event()
    release = threading.Event()

    def slow_ingest(ticker, ftypes):
        started.set()
        release.wait(5)
        return 1

    sched = IngestionScheduler(slow_ingest, ["AAPL"], ["10-K"], backoff_s=0)
    t = threading.Thread(target=sched.run_job)
    t.start()
    started.wait(5)
    assert sched.run_job() is False  # overlapping trigger skipped
    release.set()
    t.join()
    assert sched.runs == 1


def test_scheduler_retries():
    calls = []

    def flaky(ticker, ftypes):
        calls.append(ticker)
        if len(calls) < 3:
            raise RuntimeError("edgar down")
        return 1

    sched = IngestionScheduler(flaky, ["AAPL"], ["10-K"], backoff_s=0.01)
    assert sched.run_job() is True
    assert len(calls) == 3  # 2 failures + success
    assert sched.failures == {}


def test_scheduler_gives_up_after_retries():
    def always_fails(ticker, ftypes):
        raise RuntimeError("nope")

    sched = IngestionScheduler(always_fails, ["AAPL"], ["10-K"], backoff_s=0.0)
    assert sched.run_job() is True
    assert sched.failures["AAPL"] == 1


def test_next_run_at():
    now = datetime(2026, 8, 16, 10, 30, tzinfo=timezone.utc)
    nxt = next_run_at(now, "11:00")
    assert nxt.hour == 11 and nxt.day == 16
    nxt = next_run_at(now, "09:00")
    assert nxt.day == 17  # already past today
