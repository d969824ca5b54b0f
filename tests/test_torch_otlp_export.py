"""The port's OTLP exporter and continuous export pump on the CPU.

A port of ``tests/test_otlp_export.py`` to the port's modules and app:
the tracer's spans round-trip onto the OTLP/HTTP wire (against an HTTP
server on 127.0.0.1), the pump ships only complete traces, off the
request path, and the port's app starts and stops it and serves
``GET /traces/otlp``.
"""

import http.server
import json
import threading
import time

from financial_rag_system_tpu_torch.obs.export_loop import (
    TraceExportLoop,
    env_sinks,
    maybe_start_export_loop,
)
from financial_rag_system_tpu_torch.obs.otlp_export import (
    otlp_endpoint,
    to_otlp,
    try_otlp_export,
)
from financial_rag_system_tpu_torch.obs.tracing import Tracer


def _record_reference_trace(t: Tracer) -> None:
    with t.span(
        "RAG_Workflow", kind="CHAIN", inputs={"user_query": "revenue growth"}
    ) as root:
        with t.span("1_Query_Routing", kind="TOOL"):
            pass
        with t.span("4_Context_Retrieval", kind="RETRIEVER", k=15):
            pass
        with t.span("LLM_Generation", kind="LLM") as sp:
            sp.outputs = "the answer"
        root.outputs = "the answer"


def test_to_otlp_wire_shape():
    t = Tracer()
    _record_reference_trace(t)
    body = to_otlp(t.recent_traces(100))

    rs = body["resourceSpans"]
    assert len(rs) == 1
    svc = {a["key"]: a["value"] for a in rs[0]["resource"]["attributes"]}
    assert svc["service.name"] == {"stringValue": "financial-rag-tpu"}
    spans = rs[0]["scopeSpans"][0]["spans"]
    by_name = {s["name"]: s for s in spans}
    assert {
        "RAG_Workflow", "1_Query_Routing", "4_Context_Retrieval",
        "LLM_Generation",
    } <= set(by_name)

    root = by_name["RAG_Workflow"]
    llm = by_name["LLM_Generation"]
    # proto3 JSON mapping: 32/16-hex ids, int64 times as strings
    assert len(root["traceId"]) == 32 and len(root["spanId"]) == 16
    assert llm["traceId"] == root["traceId"]
    assert llm["parentSpanId"] == root["spanId"]
    assert "parentSpanId" not in root
    assert isinstance(root["startTimeUnixNano"], str)
    assert int(root["endTimeUnixNano"]) >= int(root["startTimeUnixNano"])
    # root is SERVER, children INTERNAL; taxonomy rides in attributes
    assert root["kind"] == 2 and llm["kind"] == 1
    attrs = {a["key"]: a["value"] for a in llm["attributes"]}
    assert attrs["frs.kind"] == {"stringValue": "LLM"}
    assert json.loads(attrs["frs.outputs"]["stringValue"]) == "the answer"
    ret = {a["key"]: a["value"] for a in by_name["4_Context_Retrieval"]["attributes"]}
    assert ret["frs.k"] == {"intValue": "15"}
    assert root["status"]["code"] == 1


def test_error_status_maps_to_otlp_error():
    t = Tracer()
    try:
        with t.span("LLM_Generation", kind="LLM"):
            raise RuntimeError("llm down")
    except RuntimeError:
        pass
    (span,) = to_otlp(t.recent_traces(10))["resourceSpans"][0][
        "scopeSpans"
    ][0]["spans"]
    assert span["status"]["code"] == 2


class _Collector(http.server.BaseHTTPRequestHandler):
    received: list[tuple[str, dict]] = []

    def do_POST(self):  # noqa: N802 (stdlib casing)
        body = self.rfile.read(int(self.headers["Content-Length"]))
        _Collector.received.append((self.path, json.loads(body)))
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        self.wfile.write(b"{}")

    def log_message(self, *a):  # silence
        pass


def test_try_otlp_export_against_real_http_server(monkeypatch):
    _Collector.received.clear()
    srv = http.server.HTTPServer(("127.0.0.1", 0), _Collector)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{srv.server_port}"
        monkeypatch.setenv("OTEL_EXPORTER_OTLP_ENDPOINT", base)
        monkeypatch.delenv("OTEL_EXPORTER_OTLP_TRACES_ENDPOINT", raising=False)
        assert otlp_endpoint() == base + "/v1/traces"

        t = Tracer()
        _record_reference_trace(t)
        assert try_otlp_export(t) is True
        path, body = _Collector.received[-1]
        assert path == "/v1/traces"
        names = {
            s["name"]
            for s in body["resourceSpans"][0]["scopeSpans"][0]["spans"]
        }
        assert "RAG_Workflow" in names
    finally:
        srv.shutdown()
        srv.server_close()


def test_try_otlp_export_degrades_on_dead_collector(monkeypatch):
    monkeypatch.setenv(
        "OTEL_EXPORTER_OTLP_TRACES_ENDPOINT", "http://127.0.0.1:9/v1/traces"
    )
    t = Tracer()
    _record_reference_trace(t)
    assert try_otlp_export(t) is False  # refused connection -> False, no raise


def test_try_otlp_export_without_endpoint(monkeypatch):
    monkeypatch.delenv("OTEL_EXPORTER_OTLP_ENDPOINT", raising=False)
    monkeypatch.delenv("OTEL_EXPORTER_OTLP_TRACES_ENDPOINT", raising=False)
    assert try_otlp_export(Tracer()) is False


# --- export pump ------------------------------------------------------------


def test_pump_ships_only_complete_traces():
    t = Tracer()
    shipped: list[list[dict]] = []
    loop = TraceExportLoop(t, [lambda s: shipped.append(s) or True])

    # a trace in flight: child finished, root still open
    with t.span("RAG_Workflow", kind="CHAIN"):
        with t.span("1_Query_Routing"):
            pass
        assert loop.pump_once() == 0  # child held: root not finished
    n = loop.pump_once()
    assert n == 2 and len(shipped) == 1
    names = {d["name"] for d in shipped[0]}
    assert names == {"RAG_Workflow", "1_Query_Routing"}
    assert loop.pump_once() == 0  # cursor advanced; nothing re-ships


def test_pump_evicts_orphans_by_age():
    t = Tracer()
    shipped: list[list[dict]] = []
    loop = TraceExportLoop(
        t, [lambda s: shipped.append(s) or True], orphan_age_s=0.05
    )
    # an orphan child (its root will never record: simulate by recording
    # a child-shaped span directly)
    with t.span("RAG_Workflow", kind="CHAIN"):
        with t.span("stuck_child"):
            pass
        assert loop.pump_once() == 0
        time.sleep(0.08)
        # root STILL open; age cap flushes the child as-is
        assert loop.pump_once() == 1
    assert shipped[0][0]["name"] == "stuck_child"


def test_env_sinks_and_maybe_start(monkeypatch):
    monkeypatch.delenv("MLFLOW_TRACKING_URI", raising=False)
    monkeypatch.delenv("OTEL_EXPORTER_OTLP_ENDPOINT", raising=False)
    monkeypatch.delenv("OTEL_EXPORTER_OTLP_TRACES_ENDPOINT", raising=False)
    assert env_sinks() == []
    assert maybe_start_export_loop(Tracer()) is None

    monkeypatch.setenv("OTEL_EXPORTER_OTLP_ENDPOINT", "http://127.0.0.1:9")
    assert len(env_sinks()) == 1
    monkeypatch.setenv("MLFLOW_TRACKING_URI", "http://127.0.0.1:9")
    assert len(env_sinks()) == 2

    loop = maybe_start_export_loop(Tracer(), interval_s=30.0)
    try:
        assert loop is not None and loop._thread.is_alive()
    finally:
        loop.stop()
    assert loop._thread is None


def test_pump_live_end_to_end(monkeypatch):
    """Thread pump + real collector: spans recorded after start are
    shipped without any request-path involvement."""
    _Collector.received.clear()
    srv = http.server.HTTPServer(("127.0.0.1", 0), _Collector)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        monkeypatch.setenv(
            "OTEL_EXPORTER_OTLP_ENDPOINT",
            f"http://127.0.0.1:{srv.server_port}",
        )
        monkeypatch.delenv("MLFLOW_TRACKING_URI", raising=False)
        monkeypatch.delenv("OTEL_EXPORTER_OTLP_TRACES_ENDPOINT", raising=False)
        t = Tracer()
        loop = maybe_start_export_loop(t, interval_s=0.02)
        try:
            _record_reference_trace(t)
            deadline = time.time() + 5.0
            while not _Collector.received and time.time() < deadline:
                time.sleep(0.02)
            assert _Collector.received, "pump never exported"
        finally:
            loop.stop()
    finally:
        srv.shutdown()
        srv.server_close()


def test_http_surface_traces_otlp(tmp_path):
    """GET /traces/otlp serves the OTLP-JSON body the pump POSTs, and an
    /ask's span taxonomy appears in it (serving/app.py)."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from test_torch_data_plane import make_engine

    from financial_rag_system_tpu_torch.serving.app import create_app

    async def runner():
        engine = make_engine(tmp_path, mode="sequential")
        app = create_app(engine)
        async with TestClient(TestServer(app)) as client:
            r = await client.post(
                "/ask", json={"query": "apple revenue", "ticker": "AAPL"}
            )
            assert r.status == 200
            r = await client.get("/traces/otlp")
            assert r.status == 200
            body = await r.json()
            spans = body["resourceSpans"][0]["scopeSpans"][0]["spans"]
            assert "RAG_Workflow" in {s["name"] for s in spans}

    asyncio.run(runner())


def test_app_runs_the_export_pump(tmp_path, monkeypatch):
    """With a collector in the environment the port's app starts the pump
    on startup (JAX ``serving/app.py:58-75``): an /ask's trace reaches the
    collector with its root, and cleanup stops the pump."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer
    from test_torch_data_plane import make_engine

    from financial_rag_system_tpu_torch.obs import export_loop
    from financial_rag_system_tpu_torch.serving.app import create_app

    _Collector.received.clear()
    srv = http.server.HTTPServer(("127.0.0.1", 0), _Collector)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    started = []
    real = export_loop.maybe_start_export_loop

    def spy(tracer, *, interval_s: float = 5.0):
        loop = real(tracer, interval_s=0.02)
        started.append(loop)
        return loop

    monkeypatch.setattr(export_loop, "maybe_start_export_loop", spy)
    monkeypatch.setenv("OTEL_EXPORTER_OTLP_ENDPOINT", f"http://127.0.0.1:{srv.server_port}")
    monkeypatch.delenv("OTEL_EXPORTER_OTLP_TRACES_ENDPOINT", raising=False)
    monkeypatch.delenv("MLFLOW_TRACKING_URI", raising=False)

    async def runner():
        app = create_app(make_engine(tmp_path, mode="sequential"))
        async with TestClient(TestServer(app)) as client:
            assert started and started[0]._thread.is_alive()
            r = await client.post("/ask", json={"query": "apple revenue", "ticker": "AAPL"})
            assert r.status == 200
            deadline = time.time() + 5.0
            while time.time() < deadline and not any(
                    "RAG_Workflow" in {s["name"] for s in
                                       body["resourceSpans"][0]["scopeSpans"][0]["spans"]}
                    for _, body in _Collector.received):
                await asyncio.sleep(0.02)
        return started[0]

    try:
        loop = asyncio.run(runner())
    finally:
        srv.shutdown()
        srv.server_close()
    assert loop._thread is None  # stopped on cleanup
    spans = [s for _, body in _Collector.received
             for s in body["resourceSpans"][0]["scopeSpans"][0]["spans"]]
    root = [s for s in spans if s["name"] == "RAG_Workflow"]
    assert root and "parentSpanId" not in root[0]
    assert any(s.get("parentSpanId") == root[0]["spanId"] for s in spans)
