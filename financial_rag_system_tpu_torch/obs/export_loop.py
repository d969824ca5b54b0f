"""Continuous trace-export pump: tracer ring -> live observability sinks.

A copy of ``financial_rag_system_tpu/obs/export_loop.py``; it touches no
device.

The reference exports spans as a side effect of request handling (MLflow
span decorators + OTel FastAPI instrumentation, reference main2.py:
306-313, main.py:74-75).  Here export is decoupled from the request
path: a daemon thread polls the tracer's finished-span ring by cursor
(obs/tracing.Tracer.traces_since) and ships COMPLETE traces to whichever
sinks the environment wires —

- MLflow tracking server (``MLFLOW_TRACKING_URI``,
  obs/mlflow_export.try_live_export), and/or
- OTLP collector (``OTEL_EXPORTER_OTLP[_TRACES]_ENDPOINT``,
  obs/otlp_export.try_otlp_export)

— so serving latency never pays for observability RPCs, and a dead
sidecar degrades to dropped exports rather than failed requests (both
sinks' no-raise contract).

Trace completeness: children record before their root (spans record at
context exit), so a freshly-finished child may belong to a trace whose
root is still open.  The pump holds such spans in a pending buffer and
flushes a trace only once its root (parent_id None) arrives; a bounded
age cap evicts orphans (e.g. background spans outside any root) by
exporting them as-is.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

Sink = Callable[[list[dict[str, Any]]], bool]


def env_sinks() -> list[Sink]:
    """Sinks the current environment wires (possibly empty)."""
    import os

    from financial_rag_system_tpu_torch.obs.mlflow_export import try_live_export
    from financial_rag_system_tpu_torch.obs.otlp_export import (
        otlp_endpoint,
        try_otlp_export,
    )

    sinks: list[Sink] = []
    if os.environ.get("MLFLOW_TRACKING_URI"):
        sinks.append(lambda spans: try_live_export(spans=spans))
    if otlp_endpoint():
        sinks.append(lambda spans: try_otlp_export(spans=spans))
    return sinks


class TraceExportLoop:
    """Daemon pump shipping complete traces from a tracer to sinks."""

    def __init__(
        self,
        tracer,
        sinks: list[Sink],
        *,
        interval_s: float = 5.0,
        orphan_age_s: float = 60.0,
    ):
        self.tracer = tracer
        self.sinks = sinks
        self.interval_s = interval_s
        self.orphan_age_s = orphan_age_s
        self._seq = 0
        self._pending: dict[str, list[dict[str, Any]]] = {}
        self._first_seen: dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.exported_spans = 0  # cumulative, for tests / metrics

    # -- trace assembly ------------------------------------------------------

    def _collect_ready(self, now: float | None = None) -> list[dict[str, Any]]:
        """Pull new finished spans and return the batch ready to ship:
        every span of every trace whose root has finished, plus pending
        spans older than the orphan cap."""
        now = time.time() if now is None else now
        self._seq, fresh = self.tracer.traces_since(self._seq)
        for d in fresh:
            tid = d.get("trace_id", "")
            self._pending.setdefault(tid, []).append(d)
            self._first_seen.setdefault(tid, now)
        ready: list[dict[str, Any]] = []
        for tid in list(self._pending):
            group = self._pending[tid]
            rooted = any(not d.get("parent_id") for d in group)
            if rooted or now - self._first_seen[tid] > self.orphan_age_s:
                ready.extend(group)
                del self._pending[tid]
                del self._first_seen[tid]
        return ready

    def pump_once(self) -> int:
        """One poll cycle; returns the number of spans shipped."""
        ready = self._collect_ready()
        if not ready:
            return 0
        for sink in self.sinks:
            sink(ready)
        self.exported_spans += len(ready)
        return len(ready)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="frs-trace-export", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.pump_once()
            except Exception:  # pragma: no cover - belt and braces
                pass
        try:
            self.pump_once()  # final drain on clean shutdown
        except Exception:  # pragma: no cover
            pass

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None


def maybe_start_export_loop(tracer, *, interval_s: float = 5.0):
    """Start the pump iff the environment wires at least one sink.

    Returns the running loop or None — serving/app.py calls this on
    startup and stops it on cleanup."""
    sinks = env_sinks()
    if not sinks:
        return None
    loop = TraceExportLoop(tracer, sinks, interval_s=interval_s)
    loop.start()
    return loop
