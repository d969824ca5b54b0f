"""Minimal first-party SEC EDGAR filings client.

A copy of ``financial_rag_system_tpu/data/edgar.py`` that imports
``requests`` inside the functions that fetch, so the module imports
where ``requests`` is not installed.

Replaces the reference's ``sec_edgar_downloader`` dependency (reference
ingest.py:117-123) with two HTTP calls against the public EDGAR APIs:
ticker -> CIK via ``company_tickers.json``, then the submissions feed
``data.sec.gov/submissions/CIK{cik}.json`` to locate the latest filings
of each requested type, downloading each primary document into
``dest/sec_data/{ticker}/{filing_type}/``.  SEC requires a descriptive
User-Agent; set ``EDGAR_USER_AGENT``.

Live downloads are exercised via mocked transports in tests; the
ingestion pipeline also accepts local files directly (data/ingest.py)
which is the hermetic path.
"""

from __future__ import annotations

import json
import os

EDGAR_TICKERS_URL = "https://www.sec.gov/files/company_tickers.json"
EDGAR_SUBMISSIONS_URL = "https://data.sec.gov/submissions/CIK{cik:0>10}.json"
EDGAR_ARCHIVES_URL = (
    "https://www.sec.gov/Archives/edgar/data/{cik}/{accession}/{doc}"
)


def _headers() -> dict[str, str]:
    return {
        "User-Agent": os.environ.get(
            "EDGAR_USER_AGENT", "financial-rag-tpu research client"
        )
    }


def ticker_to_cik(ticker: str, session: requests.Session | None = None) -> int:
    import requests

    s = session or requests
    resp = s.get(EDGAR_TICKERS_URL, headers=_headers(), timeout=30)
    resp.raise_for_status()
    for entry in resp.json().values():
        if entry["ticker"].upper() == ticker.upper():
            return int(entry["cik_str"])
    raise KeyError(f"unknown ticker {ticker}")


def list_filings(
    cik: int,
    filing_type: str,
    limit: int = 1,
    session: requests.Session | None = None,
) -> list[dict[str, str]]:
    """Most-recent filings of ``filing_type``: accession + primary doc."""
    import requests

    s = session or requests
    resp = s.get(
        EDGAR_SUBMISSIONS_URL.format(cik=cik), headers=_headers(), timeout=30
    )
    resp.raise_for_status()
    recent = resp.json()["filings"]["recent"]
    out = []
    for form, accession, doc in zip(
        recent["form"], recent["accessionNumber"], recent["primaryDocument"]
    ):
        if form == filing_type:
            out.append(
                {"accession": accession.replace("-", ""), "document": doc}
            )
            if len(out) >= limit:
                break
    return out


def download_filings(
    ticker: str,
    filing_type: str,
    limit: int,
    dest: str,
    session: requests.Session | None = None,
) -> list[str]:
    """Download primary documents; returns local paths.

    Layout mirrors the reference's walk path (ingest.py:131-135):
    ``dest/sec_data/{ticker}/{filing_type}/{accession}.html``.
    """
    import requests

    s = session or requests
    cik = ticker_to_cik(ticker, session)
    outdir = os.path.join(dest, "sec_data", ticker.upper(), filing_type)
    os.makedirs(outdir, exist_ok=True)
    paths = []
    for f in list_filings(cik, filing_type, limit, session):
        url = EDGAR_ARCHIVES_URL.format(
            cik=cik, accession=f["accession"], doc=f["document"]
        )
        resp = s.get(url, headers=_headers(), timeout=60)
        resp.raise_for_status()
        path = os.path.join(outdir, f"{f['accession']}.html")
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(resp.text)
        paths.append(path)
    return paths
