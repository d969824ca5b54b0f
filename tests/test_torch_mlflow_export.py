"""The port's MLflow-compatible trace export (``obs/mlflow_export.py``)
on the CPU: schema grouping, JSONL artifact, the live-export guard and
the port's HTTP surface (``GET /traces/mlflow`` and the ``GET /`` page).
A port of ``tests/test_mlflow_export.py``; the JAX package's exporter
gives the same traces for the same spans.
"""

import json

from financial_rag_system_tpu_torch.obs.mlflow_export import (
    export_jsonl,
    to_mlflow_traces,
    try_live_export,
)
from financial_rag_system_tpu_torch.obs.tracing import Tracer


def _traced() -> Tracer:
    t = Tracer()
    with t.span("RAG_Workflow", kind="CHAIN", inputs={"user_query": "q"}) as root:
        with t.span("1_Query_Routing", kind="TOOL"):
            pass
        with t.span("LLM_Generation", kind="LLM") as sp:
            sp.outputs = "answer"
        root.outputs = "answer"
    with t.span("Batch_Embedding", kind="TOOL"):
        pass
    return t


def test_grouping_and_schema():
    t = _traced()
    traces = to_mlflow_traces(t.recent_traces(100))
    assert len(traces) == 2  # one request trace + one standalone span
    big = max(traces, key=lambda tr: len(tr["data"]["spans"]))
    assert len(big["data"]["spans"]) == 3
    info = big["info"]
    assert info["state"] == "OK"
    assert "user_query" in info["request_preview"]
    by_name = {s["name"]: s for s in big["data"]["spans"]}
    root = by_name["RAG_Workflow"]
    llm = by_name["LLM_Generation"]
    # reference span taxonomy: typed spans, child links to root
    assert root["attributes"]["mlflow.spanType"] == "CHAIN"
    assert llm["attributes"]["mlflow.spanType"] == "LLM"
    assert llm["parent_id"] == root["context"]["span_id"]
    assert llm["context"]["trace_id"] == root["context"]["trace_id"]
    assert llm["end_time"] >= llm["start_time"]
    assert json.loads(llm["attributes"]["mlflow.spanOutputs"]) == "answer"


def test_error_state_propagates():
    t = Tracer()
    try:
        with t.span("RAG_Workflow", kind="CHAIN"):
            raise RuntimeError("boom")
    except RuntimeError:
        pass
    traces = to_mlflow_traces(t.recent_traces(10))
    assert traces[0]["info"]["state"] == "ERROR"
    assert traces[0]["data"]["spans"][0]["status_code"] == "ERROR"


def test_export_jsonl(tmp_path):
    t = _traced()
    path = str(tmp_path / "traces.jsonl")
    n = export_jsonl(t, path)
    lines = [json.loads(ln) for ln in open(path)]
    assert n == len(lines) == 2
    assert all("info" in tr and "data" in tr for tr in lines)


def test_live_export_guarded(monkeypatch):
    # no MLFLOW_TRACKING_URI -> no-op False, never raises
    monkeypatch.delenv("MLFLOW_TRACKING_URI", raising=False)
    assert try_live_export(_traced()) is False
    # URI set but mlflow not installed in this image -> still False
    monkeypatch.setenv("MLFLOW_TRACKING_URI", "http://localhost:5000")
    assert try_live_export(_traced()) is False


def test_live_export_preserves_hierarchy(monkeypatch):
    """Replay must open children INSIDE their parent's span context so a
    live MLflow server shows the recorded tree, not a flat list."""
    import contextlib
    import sys
    import types

    events: list[tuple[str, str, int]] = []  # (op, name, depth)
    depth = [0]

    class _FakeSpan:
        def __init__(self, name):
            self.name = name

        def set_inputs(self, _):
            pass

        def set_outputs(self, _):
            pass

        def set_attributes(self, _):
            pass

    fake = types.ModuleType("mlflow")
    fake.set_tracking_uri = lambda uri: None
    fake.set_experiment = lambda name: None

    @contextlib.contextmanager
    def start_span(name, span_type="TOOL"):
        events.append(("open", name, depth[0]))
        depth[0] += 1
        try:
            yield _FakeSpan(name)
        finally:
            depth[0] -= 1
            events.append(("close", name, depth[0]))

    fake.start_span = start_span
    monkeypatch.setitem(sys.modules, "mlflow", fake)
    monkeypatch.setenv("MLFLOW_TRACKING_URI", "http://fake:5000")

    assert try_live_export(_traced()) is True
    opens = {(n, d) for op, n, d in events if op == "open"}
    # the request trace: root at depth 0, its two children at depth 1
    assert ("RAG_Workflow", 0) in opens
    assert ("1_Query_Routing", 1) in opens
    assert ("LLM_Generation", 1) in opens
    # the standalone batcher span is its own root
    assert ("Batch_Embedding", 0) in opens


def test_http_surface(tmp_path):
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
            r = await client.get("/traces/mlflow")
            assert r.status == 200
            traces = await r.json()
            assert traces
            names = {
                s["name"] for tr in traces for s in tr["data"]["spans"]
            }
            assert "RAG_Workflow" in names

    asyncio.run(runner())


def test_same_traces_as_the_jax_exporter():
    from financial_rag_system_tpu.obs import mlflow_export as jml
    from financial_rag_system_tpu.obs import otlp_export as jotlp
    from financial_rag_system_tpu_torch.obs.otlp_export import to_otlp

    spans = _traced().recent_traces(100)
    assert to_mlflow_traces(spans) == jml.to_mlflow_traces(spans)
    assert to_otlp(spans) == jotlp.to_otlp(spans)


def test_ui_page(tmp_path):
    """``GET /`` serves the chat page, which drives /ready and /ask."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer
    from test_torch_data_plane import make_engine

    from financial_rag_system_tpu.serving.ui import PAGE as JAX_PAGE
    from financial_rag_system_tpu_torch.serving.app import create_app
    from financial_rag_system_tpu_torch.serving.ui import PAGE

    async def runner():
        app = create_app(make_engine(tmp_path, mode="sequential"))
        async with TestClient(TestServer(app)) as client:
            r = await client.get("/")
            assert r.status == 200 and r.content_type == "text/html"
            return await r.text()

    text = asyncio.run(runner())
    assert text == PAGE == JAX_PAGE
    assert "fetch('/ask'" in text and "fetch('/ready')" in text
