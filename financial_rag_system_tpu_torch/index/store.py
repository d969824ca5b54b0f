"""Host-side document store: payloads, metadata coding, id bookkeeping.

Replaces the payload half of the reference's Qdrant collection: each
point carries ``{ticker, document_type, text, source_file, ingested_at}``
(reference ingest.py:160-167) addressed by a deterministic md5 point id
(ingest.py:152-158) so re-ingestion upserts instead of duplicating.

Device-side filtering needs integer codes, not strings: the store owns
two growable vocabularies (ticker, document_type) mapping strings to
int32 codes that are baked into the on-device ``codes`` array of the
index.  ``-1`` is the query-side wildcard; ``-2`` marks padding rows.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any

WILDCARD = -1
PAD_CODE = -2


@dataclass
class Vocab:
    """Growable string -> int32 code table."""

    to_code: dict[str, int] = field(default_factory=dict)

    def encode(self, value: str, *, grow: bool = True) -> int:
        if value in self.to_code:
            return self.to_code[value]
        if not grow:
            return WILDCARD  # unknown filter value matches nothing real
        code = len(self.to_code)
        self.to_code[value] = code
        return code

    def lookup(self, value: str | None) -> int:
        """Query-side encode: None -> wildcard, unknown -> impossible code."""
        if value is None:
            return WILDCARD
        # unknown value must match nothing; -3 never equals any stored code
        return self.to_code.get(value, -3)

    def decode(self) -> dict[int, str]:
        return {v: k for k, v in self.to_code.items()}


@dataclass
class DocumentStore:
    """Row-addressed payload storage aligned with the device index rows."""

    texts: list[str] = field(default_factory=list)
    payloads: list[dict[str, Any]] = field(default_factory=list)
    id_to_row: dict[str, int] = field(default_factory=dict)
    tickers: Vocab = field(default_factory=Vocab)
    doc_types: Vocab = field(default_factory=Vocab)

    def __len__(self) -> int:
        return len(self.texts)

    def upsert(self, pid: str, text: str, payload: dict[str, Any]) -> tuple[int, bool]:
        """Insert or overwrite by point id. Returns (row, is_new)."""
        row = self.id_to_row.get(pid)
        if row is None:
            row = len(self.texts)
            self.id_to_row[pid] = row
            self.texts.append(text)
            self.payloads.append(payload)
            return row, True
        self.texts[row] = text
        self.payloads[row] = payload
        return row, False

    def codes_for(self, payload: dict[str, Any]) -> tuple[int, int]:
        # uppercase both vocabularies so filters are case-insensitive,
        # matching the reference (main.py:221,228 uppercase at query time,
        # ingest.py:162 uppercases document_type at ingestion)
        return (
            self.tickers.encode(str(payload.get("ticker", "")).upper()),
            self.doc_types.encode(str(payload.get("document_type", "")).upper()),
        )

    def query_codes(self, ticker: str | None, document_type: str | None) -> tuple[int, int]:
        return (
            self.tickers.lookup(None if ticker is None else ticker.upper()),
            self.doc_types.lookup(
                None if document_type is None else document_type.upper()
            ),
        )

    def get(self, row: int) -> dict[str, Any]:
        p = dict(self.payloads[row])
        p["text"] = self.texts[row]
        return p

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(
                {
                    "texts": self.texts,
                    "payloads": self.payloads,
                    "id_to_row": self.id_to_row,
                    "tickers": self.tickers.to_code,
                    "doc_types": self.doc_types.to_code,
                },
                f,
            )

    @staticmethod
    def load(path: str) -> "DocumentStore":
        with open(path) as f:
            d = json.load(f)
        return DocumentStore(
            texts=d["texts"],
            payloads=d["payloads"],
            id_to_row={k: int(v) for k, v in d["id_to_row"].items()},
            tickers=Vocab(d["tickers"]),
            doc_types=Vocab(d["doc_types"]),
        )
