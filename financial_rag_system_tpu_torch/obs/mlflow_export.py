"""MLflow-compatible trace export.

A copy of ``financial_rag_system_tpu/obs/mlflow_export.py``; it touches
no device.

The reference logs every request as an MLflow GenAI trace (reference
main2.py:306-309 sets the tracking URI + experiment; main.py:74-75 and
the span decorators produce typed spans).  The first-party tracer
(obs/tracing.py) keeps the same span taxonomy in-process; this module
closes the interop gap by exporting those spans in MLflow's trace
schema so existing MLflow tooling (UI import, downstream analyzers) can
consume them:

- :func:`to_mlflow_traces` — group the tracer's finished spans by
  trace_id into MLflow V3 trace objects ({"info": ..., "data":
  {"spans": [...]}}), span types/attribute keys matching what
  ``mlflow.start_span(span_type=...)`` records;
- :func:`export_jsonl` — write one trace JSON per line (the portable
  artifact; ``mlflow traces import``-style tooling reads it);
- :func:`try_live_export` — when the optional ``mlflow`` package is
  installed AND ``MLFLOW_TRACKING_URI`` is set, replay spans into a live
  MLflow server; returns False (never raises) otherwise, so serving
  works identically with or without MLflow in the environment.

Served at ``GET /traces/mlflow`` (serving/app.py).
"""

from __future__ import annotations

import json
import os
from typing import Any

# span kinds used by obs/tracing.py == MLflow span_type names used by
# the reference (main2.py:214-263): CHAIN, TOOL, RETRIEVER, LLM
_NS = 1_000_000_000


def _span_to_mlflow(d: dict[str, Any]) -> dict[str, Any]:
    start_ns = int(d["start_s"] * _NS)
    return {
        "name": d["name"],
        "context": {
            "trace_id": d["trace_id"],
            "span_id": d["span_id"],
        },
        "parent_id": d.get("parent_id"),
        "start_time": start_ns,
        "end_time": start_ns + int(d["duration_ms"] * 1_000_000),
        "status_code": "OK" if d.get("status", "OK") == "OK" else "ERROR",
        "status_message": "",
        "attributes": {
            "mlflow.spanType": d.get("kind", "TOOL"),
            "mlflow.spanInputs": json.dumps(d.get("inputs", {}), default=str),
            "mlflow.spanOutputs": json.dumps(d.get("outputs"), default=str),
            **{f"frs.{k}": str(v) for k, v in (d.get("attrs") or {}).items()},
        },
    }


def to_mlflow_traces(spans: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """Group finished tracer spans into MLflow V3 trace objects."""
    by_trace: dict[str, list[dict[str, Any]]] = {}
    for d in spans:
        by_trace.setdefault(d["trace_id"], []).append(d)
    traces = []
    for trace_id, group in by_trace.items():
        group.sort(key=lambda d: d["start_s"])
        roots = [d for d in group if not d.get("parent_id")] or group
        start_s = min(d["start_s"] for d in group)
        end_s = max(d["start_s"] + d["duration_ms"] / 1000.0 for d in group)
        traces.append(
            {
                "info": {
                    "trace_id": trace_id,
                    "request_time": int(start_s * 1000),
                    "execution_duration_ms": int((end_s - start_s) * 1000),
                    "state": (
                        "ERROR"
                        if any(d.get("status") == "ERROR" for d in group)
                        else "OK"
                    ),
                    "request_preview": json.dumps(
                        roots[0].get("inputs", {}), default=str
                    )[:256],
                    "response_preview": json.dumps(
                        roots[0].get("outputs"), default=str
                    )[:256],
                },
                "data": {"spans": [_span_to_mlflow(d) for d in group]},
            }
        )
    return traces


def export_jsonl(tracer, path: str, *, n: int | None = None) -> int:
    """Write the tracer's recent traces as MLflow-schema JSONL.

    Returns the number of traces written.
    """
    spans = tracer.recent_traces(n or 10**9)
    traces = to_mlflow_traces(spans)
    with open(path, "w") as f:
        for t in traces:
            f.write(json.dumps(t, default=str) + "\n")
    return len(traces)


def try_live_export(
    tracer=None, *, n: int | None = None,
    spans: list[dict[str, Any]] | None = None,
) -> bool:
    """Replay recent spans into a live MLflow server, if one is wired.

    Requires both the ``mlflow`` package (an optional dependency) and
    ``MLFLOW_TRACKING_URI`` — mirroring the reference's opt-in wiring
    (main2.py:306-309).  Never raises: serving must not depend on an
    observability sidecar (the reference's own MLflow calls are wrapped
    in try/except for the same reason, main2.py:310-313).  Pass
    ``spans`` to replay an explicit batch (the continuous export pump,
    obs/export_loop.py) instead of the tracer's recent ring.
    """
    uri = os.environ.get("MLFLOW_TRACKING_URI")
    if not uri:
        return False
    try:
        import mlflow  # type: ignore

        mlflow.set_tracking_uri(uri)
        mlflow.set_experiment(
            os.environ.get("MLFLOW_EXPERIMENT", "financial-rag-tpu")
        )
        if spans is None:
            spans = tracer.recent_traces(n or 10**9)
        for trace in to_mlflow_traces(spans):
            # replay preserving the recorded hierarchy: children open
            # inside their parent's context manager so MLflow nests them
            # under the active span (timestamps are live — recorded
            # start/end ride along as attributes; export_jsonl keeps the
            # faithful originals)
            all_spans = trace["data"]["spans"]
            children: dict = {}
            for sp in all_spans:
                children.setdefault(sp.get("parent_id"), []).append(sp)

            def replay(sp) -> None:
                attrs = sp["attributes"]
                with mlflow.start_span(
                    name=sp["name"],
                    span_type=attrs.get("mlflow.spanType", "TOOL"),
                ) as live:
                    live.set_inputs(attrs.get("mlflow.spanInputs"))
                    live.set_outputs(attrs.get("mlflow.spanOutputs"))
                    live.set_attributes(
                        {
                            "recorded.start": sp.get("start_time"),
                            "recorded.end": sp.get("end_time"),
                        }
                    )
                    for child in children.get(sp["context"]["span_id"], []):
                        replay(child)

            for root in children.get(None, []):
                replay(root)
        return True
    except Exception:
        return False
