"""OpenTelemetry (OTLP/HTTP) trace export — no OTel SDK required.

A copy of ``financial_rag_system_tpu/obs/otlp_export.py``; it touches no
device.

The reference instruments its FastAPI app with OpenTelemetry (reference
main.py:33, 74-75 ``FastAPIInstrumentor.instrument_app``), so existing
OTel collectors can consume its spans.  The first-party tracer
(obs/tracing.py) keeps the same span taxonomy in-process; this module
closes the interop gap by encoding those spans as an OTLP/HTTP JSON
``ExportTraceServiceRequest`` and POSTing it to a collector — stdlib
urllib only, so the exporter works with or without the
``opentelemetry`` package.

Wire-format notes (stable OTLP JSON encoding, proto3 JSON mapping):

- trace ids are 32 lowercase hex chars, span ids 16 — exactly what
  obs/tracing.py already generates (uuid4().hex / hex[:16]);
- timestamps are unix-epoch nanoseconds serialized as STRINGS (proto3
  maps int64 to JSON string);
- span kind: the tracer's CHAIN/TOOL/RETRIEVER/LLM taxonomy maps to
  SPAN_KIND_SERVER for roots and SPAN_KIND_INTERNAL otherwise, with the
  taxonomy preserved in the ``frs.kind`` attribute (OTel has no GenAI
  span kinds; collectors key on attributes).

Standard env contract (the OTel spec's):
``OTEL_EXPORTER_OTLP_TRACES_ENDPOINT`` (full URL) or
``OTEL_EXPORTER_OTLP_ENDPOINT`` (base; ``/v1/traces`` appended).
"""

from __future__ import annotations

import json
import os
import urllib.request
from typing import Any

_NS = 1_000_000_000

_SPAN_KIND_INTERNAL = 1
_SPAN_KIND_SERVER = 2
_STATUS_OK = 1
_STATUS_ERROR = 2


def _attr(key: str, value: Any) -> dict[str, Any]:
    if isinstance(value, bool):
        return {"key": key, "value": {"boolValue": value}}
    if isinstance(value, int):
        return {"key": key, "value": {"intValue": str(value)}}
    if isinstance(value, float):
        return {"key": key, "value": {"doubleValue": value}}
    return {"key": key, "value": {"stringValue": str(value)}}


def _span_to_otlp(d: dict[str, Any]) -> dict[str, Any]:
    start_ns = int(d["start_s"] * _NS)
    end_ns = start_ns + int(d["duration_ms"] * 1_000_000)
    attrs = [
        _attr("frs.kind", d.get("kind", "TOOL")),
        _attr("frs.inputs", json.dumps(d.get("inputs", {}), default=str)),
        _attr("frs.outputs", json.dumps(d.get("outputs"), default=str)),
    ]
    attrs += [
        _attr(f"frs.{k}", v) for k, v in (d.get("attrs") or {}).items()
    ]
    out = {
        "traceId": d["trace_id"],
        "spanId": d["span_id"],
        "name": d["name"],
        "kind": (
            _SPAN_KIND_SERVER if not d.get("parent_id")
            else _SPAN_KIND_INTERNAL
        ),
        "startTimeUnixNano": str(start_ns),
        "endTimeUnixNano": str(end_ns),
        "attributes": attrs,
        "status": {
            "code": (
                _STATUS_OK if d.get("status", "OK") == "OK" else _STATUS_ERROR
            ),
        },
    }
    if d.get("parent_id"):
        out["parentSpanId"] = d["parent_id"]
    return out


def to_otlp(
    spans: list[dict[str, Any]], *, service_name: str = "financial-rag-tpu",
) -> dict[str, Any]:
    """Encode finished tracer spans as an OTLP/HTTP JSON
    ``ExportTraceServiceRequest`` body."""
    return {
        "resourceSpans": [
            {
                "resource": {
                    "attributes": [_attr("service.name", service_name)],
                },
                "scopeSpans": [
                    {
                        "scope": {"name": "financial_rag_system_tpu"},
                        "spans": [_span_to_otlp(d) for d in spans],
                    }
                ],
            }
        ]
    }


def otlp_endpoint() -> str | None:
    """Resolve the collector URL from the standard OTel env contract."""
    full = os.environ.get("OTEL_EXPORTER_OTLP_TRACES_ENDPOINT")
    if full:
        return full
    base = os.environ.get("OTEL_EXPORTER_OTLP_ENDPOINT")
    if base:
        return base.rstrip("/") + "/v1/traces"
    return None


def post_otlp(
    spans: list[dict[str, Any]], endpoint: str, *, timeout_s: float = 5.0,
) -> None:
    """POST one OTLP JSON trace-export request; raises on transport or
    non-2xx failure (callers decide degradation policy)."""
    body = json.dumps(to_otlp(spans)).encode()
    req = urllib.request.Request(
        endpoint, data=body,
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        if not (200 <= resp.status < 300):  # pragma: no cover - urlopen raises
            raise RuntimeError(f"OTLP export HTTP {resp.status}")


def try_otlp_export(
    tracer=None, *, n: int | None = None,
    spans: list[dict[str, Any]] | None = None,
) -> bool:
    """Export spans to the env-configured OTLP collector, if any.

    Never raises: serving must not depend on an observability sidecar
    (same degradation contract as obs/mlflow_export.try_live_export).
    Returns True only when a collector is configured AND accepted the
    batch.
    """
    endpoint = otlp_endpoint()
    if not endpoint:
        return False
    try:
        if spans is None:
            spans = tracer.recent_traces(n or 10**9)
        if not spans:
            return True
        post_otlp(spans, endpoint)
        return True
    except Exception:
        return False
