"""Ingestion pipeline: filings -> text -> chunks -> device embeddings -> index.

The reference's flow (ingest.py:109-199): EDGAR download -> BeautifulSoup
HTML->text -> 1000/200 recursive chunking -> embed via the backend's
``POST /embed`` in batches of 64 -> deterministic md5 point ids ->
batched upsert of 256 -> per-ticker cache invalidation.  All of those
stages and constants are preserved; the structural difference is that
the index is in-process with the serving engine (device HBM, not a
Qdrant server), so remote ingestion posts chunks to the backend's
``POST /index/upsert`` and the backend embeds + upserts on device in
one pass.

Two entry styles:
- :func:`ingest_files` / :func:`ingest_local` — in-process (engine or
  index+embedder handle), the hermetic path used by tests, eval and bench.
- :func:`run_ingestion` — the reference-compatible remote flow: wait for
  backend readiness (30 x 3 s, ingest.py:35-47), download from EDGAR,
  post chunk batches, invalidate the ticker's cache.

A copy of ``financial_rag_system_tpu/data/ingest.py`` that imports
``requests`` inside the remote flow's functions, so the in-process path
imports and runs where ``requests`` is not installed.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Sequence

from financial_rag_system_tpu_torch.data.chunker import split_text
from financial_rag_system_tpu_torch.utils.hashing import point_id

UPSERT_BATCH = 256  # reference ingest.py:171
EMBED_BATCH = 64  # reference ingest.py:58


def extract_text_from_html(html: str) -> str:
    """HTML -> text (reference ingest.py:101-104)."""
    from bs4 import BeautifulSoup

    return BeautifulSoup(html, "html.parser").get_text(separator="\n")


@dataclass
class ChunkBatch:
    ids: list[str]
    texts: list[str]
    payloads: list[dict[str, Any]]


def chunks_from_file(
    path: str,
    ticker: str,
    filing_type: str,
    *,
    chunk_size: int = 1000,
    overlap: int = 200,
) -> ChunkBatch:
    """One filing file -> deduplicated chunk batch with payloads."""
    with open(path, encoding="utf-8", errors="ignore") as f:
        raw = f.read()
    text = extract_text_from_html(raw) if path.endswith((".html", ".htm")) else raw
    chunks = split_text(text, chunk_size, overlap)
    src = os.path.basename(path)
    now = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    ids, texts, payloads = [], [], []
    for i, chunk in enumerate(chunks):
        ids.append(point_id(ticker, filing_type, src, i))
        texts.append(chunk)
        payloads.append(
            {
                "ticker": ticker.upper(),
                "document_type": filing_type.upper(),  # reference ingest.py:162
                "source_file": src,
                "ingested_at": now,
            }
        )
    return ChunkBatch(ids, texts, payloads)


def ingest_local(
    index,
    embedder,
    batch: ChunkBatch,
    *,
    embed_batch: int = EMBED_BATCH,
    upsert_batch: int = UPSERT_BATCH,
) -> int:
    """Embed + upsert a chunk batch in-process. Returns new-row count."""
    new_rows = 0
    for start in range(0, len(batch.ids), upsert_batch):
        sl = slice(start, start + upsert_batch)
        texts = batch.texts[sl]
        vecs = embedder.encode(texts)  # embedder batches internally
        new_rows += index.upsert(batch.ids[sl], vecs, texts, batch.payloads[sl])
    return new_rows


def ingest_files(
    index,
    embedder,
    ticker: str,
    filing_type: str,
    paths: Sequence[str],
    *,
    cache=None,
) -> int:
    """Full local ingestion of filing files + cache invalidation."""
    total = 0
    for p in paths:
        total += ingest_local(index, embedder, chunks_from_file(p, ticker, filing_type))
    if cache is not None:
        cache.clear_ticker(ticker)  # reference ingest.py:185-193
    return total


# --- remote (backend HTTP) flow, reference-compatible ------------------------


def wait_for_backend(
    backend_url: str, *, attempts: int = 30, delay_s: float = 3.0
) -> bool:
    """Poll /ready like the reference (ingest.py:35-47)."""
    import requests

    for _ in range(attempts):
        try:
            r = requests.get(f"{backend_url}/ready", timeout=5)
            if r.ok and r.json().get("status") == "ready":
                return True
        except requests.RequestException:
            pass
        time.sleep(delay_s)
    return False


def post_chunks(backend_url: str, batch: ChunkBatch) -> int:
    import requests

    new_rows = 0
    for start in range(0, len(batch.ids), UPSERT_BATCH):
        sl = slice(start, start + UPSERT_BATCH)
        r = requests.post(
            f"{backend_url}/index/upsert",
            json={
                "ids": batch.ids[sl],
                "texts": batch.texts[sl],
                "payloads": batch.payloads[sl],
            },
            timeout=120,
        )
        r.raise_for_status()
        new_rows += r.json().get("new_rows", 0)
    return new_rows


def run_ingestion(
    ticker: str = "AAPL",
    filing_types: Sequence[str] = ("10-K", "10-Q"),
    limit: int = 1,
    *,
    backend_url: str | None = None,
    data_dir: str = "sec_data_cache",
    download: bool = True,
) -> int:
    """Reference-compatible entry (ingest.py:109): download + ingest + invalidate."""
    import requests

    from financial_rag_system_tpu_torch.utils.config import default_backend_url

    backend_url = backend_url or default_backend_url()
    if not wait_for_backend(backend_url):
        raise RuntimeError(f"backend at {backend_url} never became ready")

    total = 0
    for f_type in filing_types:
        if download:
            from financial_rag_system_tpu_torch.data.edgar import download_filings

            paths = download_filings(ticker, f_type, limit, data_dir)
        else:  # use already-downloaded files
            d = os.path.join(data_dir, "sec_data", ticker.upper(), f_type)
            paths = (
                [os.path.join(d, f) for f in sorted(os.listdir(d))]
                if os.path.isdir(d)
                else []
            )
        for p in paths:
            total += post_chunks(backend_url, chunks_from_file(p, ticker, f_type))

    requests.delete(f"{backend_url}/cache/clear/{ticker}", timeout=10)
    return total


if __name__ == "__main__":  # pragma: no cover — manual entry (reference ingest.py:199)
    import argparse

    ap = argparse.ArgumentParser(description="EDGAR -> chunk -> embed -> index")
    ap.add_argument("--ticker", default="AAPL")
    ap.add_argument("--filing-types", default="10-K,10-Q")
    ap.add_argument("--limit", type=int, default=1)
    ap.add_argument("--no-download", action="store_true",
                    help="ingest already-downloaded files only (zero-egress)")
    args = ap.parse_args()
    n = run_ingestion(
        args.ticker,
        tuple(t.strip() for t in args.filing_types.split(",")),
        args.limit,
        download=not args.no_download,
    )
    print(f"ingested {n} chunks for {args.ticker}")
