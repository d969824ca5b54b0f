"""First-party tracing + metrics (replaces MLflow GenAI traces).

The reference traces every request with MLflow spans — root
``RAG_Workflow`` with typed children ``1_Query_Routing`` (TOOL),
``2_Vector_Retrieval`` (RETRIEVER), ``3_Reranking`` (TOOL),
``LLM_Generation`` (LLM), ``Batch_Embedding`` (TOOL) — and logs
per-stage latency metrics (reference main2.py:207-263, main.py:355-405).
MLflow isn't part of this stack; this module provides the same span
taxonomy and metric names with an in-process collector: contextvar span
nesting, a bounded ring of finished traces, streaming aggregates
(count/mean/p50/p95) per metric, and an optional JSONL sink.

Everything is cheap enough to stay on in production (a dict append per
span), so there is no TESTING no-op variant to diverge from — the
control plane traced in tests is the one traced in prod.
"""

from __future__ import annotations

import bisect
import contextvars
import json
import os
import threading
import time
import uuid
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any

_current_span: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "frs_current_span", default=None
)


@dataclass
class Span:
    name: str
    kind: str = "TOOL"  # TOOL | RETRIEVER | LLM | CHAIN
    trace_id: str = ""
    span_id: str = field(default_factory=lambda: uuid.uuid4().hex[:16])
    parent_id: str | None = None
    start_s: float = 0.0
    end_s: float = 0.0
    inputs: dict[str, Any] = field(default_factory=dict)
    outputs: Any = None
    attrs: dict[str, Any] = field(default_factory=dict)
    status: str = "OK"

    @property
    def duration_ms(self) -> float:
        return (self.end_s - self.start_s) * 1000.0

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "kind": self.kind,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_s": self.start_s,
            "duration_ms": self.duration_ms,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": self.attrs,
            "status": self.status,
        }


class _MetricAgg:
    """Streaming aggregate with a bounded reservoir for percentiles."""

    __slots__ = ("count", "total", "reservoir", "cap")

    def __init__(self, cap: int = 512):
        self.count = 0
        self.total = 0.0
        self.reservoir: list[float] = []
        self.cap = cap

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v
        if len(self.reservoir) < self.cap:
            bisect.insort(self.reservoir, v)
        else:  # replace a deterministic rotating slot, keep sorted
            self.reservoir.pop(self.count % self.cap)
            bisect.insort(self.reservoir, v)

    def snapshot(self) -> dict[str, float]:
        r = self.reservoir
        if not r:
            return {"count": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0}
        return {
            "count": self.count,
            "mean": self.total / self.count,
            "p50": r[int(0.5 * (len(r) - 1))],
            "p95": r[int(0.95 * (len(r) - 1))],
        }


class Tracer:
    """Process-wide span collector + metric registry."""

    def __init__(self, *, max_traces: int = 256, jsonl_path: str | None = None):
        self._lock = threading.Lock()
        self._finished: list[dict[str, Any]] = []
        self._max = max_traces
        self._metrics: dict[str, _MetricAgg] = {}
        self._jsonl_path = jsonl_path or os.environ.get("RAG_TPU_TRACE_PATH")
        self._jsonl_file = None
        self._seq = 0  # monotone finished-span counter (export cursors)

    @contextmanager
    def span(
        self,
        name: str,
        kind: str = "TOOL",
        inputs: dict[str, Any] | None = None,
        **attrs: Any,
    ):
        parent = _current_span.get()
        sp = Span(
            name=name,
            kind=kind,
            trace_id=parent.trace_id if parent else uuid.uuid4().hex,
            parent_id=parent.span_id if parent else None,
            inputs=inputs or {},
            attrs=attrs,
        )
        sp.start_s = time.time()
        token = _current_span.set(sp)
        try:
            yield sp
        except BaseException:
            sp.status = "ERROR"
            raise
        finally:
            sp.end_s = time.time()
            _current_span.reset(token)
            self._record(sp)

    def _record(self, sp: Span) -> None:
        d = sp.to_dict()
        with self._lock:
            self._seq += 1
            self._finished.append(d)
            if len(self._finished) > self._max:
                self._finished.pop(0)
            if self._jsonl_path:
                if self._jsonl_file is None:
                    self._jsonl_file = open(self._jsonl_path, "a")
                self._jsonl_file.write(json.dumps(d, default=str) + "\n")
                self._jsonl_file.flush()

    def log_metric(self, name: str, value: float) -> None:
        with self._lock:
            agg = self._metrics.get(name)
            if agg is None:
                agg = self._metrics[name] = _MetricAgg()
            agg.add(float(value))

    def metrics_snapshot(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {k: v.snapshot() for k, v in self._metrics.items()}

    def recent_traces(self, n: int = 20) -> list[dict[str, Any]]:
        with self._lock:
            return self._finished[-n:]

    def traces_since(self, seq: int) -> tuple[int, list[dict[str, Any]]]:
        """Spans finished after export cursor ``seq`` (0 = from the
        start), plus the new cursor.  The ring is bounded at
        ``max_traces`` spans, so a consumer that falls further behind
        than that loses the overflow — fine for observability pumps
        (obs/export_loop.py), which poll far faster than 256 spans
        accumulate."""
        with self._lock:
            new = min(self._seq - seq, len(self._finished))
            return self._seq, list(self._finished[-new:]) if new > 0 else []

    def reset(self) -> None:
        with self._lock:
            self._finished.clear()
            self._metrics.clear()


_tracer: Tracer | None = None


def get_tracer() -> Tracer:
    global _tracer
    if _tracer is None:
        _tracer = Tracer()
    return _tracer
