"""Daily ingestion scheduler (first-party; the `schedule` lib isn't needed).

A copy of ``financial_rag_system_tpu/data/scheduler.py``.

Semantics match reference scheduler.py: tickers + filing types from env
CSV (scheduler.py:17-18), daily run at ``SCHEDULER_TIME`` UTC (93), a
``threading.Lock`` so an overlapping run is skipped rather than queued
(21, 51-55), 3 retries per ticker with 10 s backoff (59-78), an initial
run on start (96), a 30 s poll loop (98-100), and a backend readiness
wait of 60 x 2 s before anything runs (26-45).
"""

from __future__ import annotations

import logging
import threading
import time
from datetime import datetime, timedelta, timezone
from typing import Callable, Sequence

log = logging.getLogger("frs.scheduler")

RETRIES_PER_TICKER = 3
RETRY_BACKOFF_S = 10.0
POLL_INTERVAL_S = 30.0


def next_run_at(now: datetime, hhmm: str) -> datetime:
    """Next UTC datetime matching HH:MM, strictly after ``now``."""
    hour, minute = (int(x) for x in hhmm.split(":"))
    candidate = now.replace(hour=hour, minute=minute, second=0, microsecond=0)
    if candidate <= now:
        candidate += timedelta(days=1)
    return candidate


class IngestionScheduler:
    def __init__(
        self,
        ingest_fn: Callable[[str, Sequence[str]], int],
        tickers: Sequence[str],
        filing_types: Sequence[str],
        *,
        at: str = "00:00",
        retries: int = RETRIES_PER_TICKER,
        backoff_s: float = RETRY_BACKOFF_S,
    ):
        self.ingest_fn = ingest_fn
        self.tickers = list(tickers)
        self.filing_types = list(filing_types)
        self.at = at
        self.retries = retries
        self.backoff_s = backoff_s
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.runs = 0
        self.failures: dict[str, int] = {}

    def run_job(self) -> bool:
        """One full ingestion sweep; returns False if skipped (lock held)."""
        if not self._lock.acquire(blocking=False):
            log.warning("ingestion already running; skipping this trigger")
            return False
        try:
            for ticker in self.tickers:
                for attempt in range(self.retries):
                    try:
                        self.ingest_fn(ticker, self.filing_types)
                        break
                    except Exception as exc:  # noqa: PERF203
                        log.error("ingestion %s attempt %d failed: %s",
                                  ticker, attempt + 1, exc)
                        if attempt == self.retries - 1:
                            self.failures[ticker] = (
                                self.failures.get(ticker, 0) + 1
                            )
                        else:
                            time.sleep(self.backoff_s)
            self.runs += 1
            return True
        finally:
            self._lock.release()

    def run_forever(self, *, initial_run: bool = True) -> None:
        if initial_run:  # reference scheduler.py:96
            self.run_job()
        target = next_run_at(datetime.now(timezone.utc), self.at)
        while not self._stop.wait(POLL_INTERVAL_S):
            now = datetime.now(timezone.utc)
            if now >= target:
                threading.Thread(target=self.run_job, daemon=True).start()
                target = next_run_at(now, self.at)

    def stop(self) -> None:
        self._stop.set()


def start_scheduler() -> IngestionScheduler:  # pragma: no cover — manual entry
    """Reference-compatible entry (scheduler.py:85): env-driven remote runs."""
    import os

    from financial_rag_system_tpu_torch.data.ingest import run_ingestion, wait_for_backend

    from financial_rag_system_tpu_torch.utils.config import default_backend_url

    backend = default_backend_url()
    if not wait_for_backend(backend, attempts=60, delay_s=2.0):
        raise RuntimeError("backend never became ready")
    tickers = os.environ.get("SCHEDULER_TICKERS", "AAPL").split(",")
    ftypes = os.environ.get("SCHEDULER_FILING_TYPES", "10-K,10-Q").split(",")
    at = os.environ.get("SCHEDULER_TIME", "00:00")
    sched = IngestionScheduler(
        lambda t, fts: run_ingestion(t, fts, backend_url=backend),
        tickers,
        ftypes,
        at=at,
    )
    sched.run_forever()
    return sched


if __name__ == "__main__":  # pragma: no cover
    logging.basicConfig(level=logging.INFO)
    start_scheduler()
