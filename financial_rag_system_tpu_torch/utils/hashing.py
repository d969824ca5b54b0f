"""Deterministic keys — behavioral invariants of the reference.

- Cache key: ``sha256(f"{ticker}_{query.lower()}")`` (reference
  main.py:337-339, main2.py:320).
- Ingestion point id: ``md5(f"{ticker}_{filing_type}_{source_file}_{chunk_idx}")``
  so re-ingestion upserts instead of duplicating (reference ingest.py:152-158).
"""

from __future__ import annotations

import hashlib


def cache_key(ticker: str, query: str) -> str:
    return hashlib.sha256(f"{ticker}_{query.lower()}".encode()).hexdigest()


def point_id(ticker: str, filing_type: str, source_file: str, chunk_idx: int) -> str:
    raw = f"{ticker}_{filing_type}_{source_file}_{chunk_idx}"
    return hashlib.md5(raw.encode()).hexdigest()
