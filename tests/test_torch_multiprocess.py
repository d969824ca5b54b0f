"""Multi-process serving on the CPU: two gloo ranks of two CPU shards
each against one process of four shards, bit for bit (rows and scores)
for the sharded search (with a growth that redistributes the blocks), the
fused flat program and the work-balanced rerank, and the checkpoint that
rank 0 writes after every rank joined the gather; then the port's
``serving/app.main`` in two processes, the coordinator serving HTTP and
the worker running its op stream.

Each test joins its processes with its own deadline."""

from __future__ import annotations

import json
import multiprocessing
import os
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np

import torch_mesh_worker as worker

from financial_rag_system_tpu_torch.parallel.mesh import create_mesh

JOIN_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_match_one_process(tmp_path):
    want = worker.compute(create_mesh(devices=["cpu"] * 4), str(tmp_path / "one"))
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=worker.run_rank,
                         args=(r, 2, port, str(tmp_path / f"rank{r}.npz"), str(tmp_path / "two")))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.time() + JOIN_S
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.time()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, f"ranks did not finish within {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0, 0]
    assert int(want["capacity"]) == 1024  # the second upsert grew the shards
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        for key, value in want.items():
            assert got[key].tobytes() == np.asarray(value).tobytes(), (r, key)
    assert np.isfinite(want["fused_ce"]).any() and np.isneginf(want["rerank"][:, -1]).all()
    # the checkpoint: rank 0's gather of every rank's shards
    one, two = (np.load(tmp_path / d / "sharded_index.npz") for d in ("one", "two"))
    for key in ("emb", "codes", "meta"):
        np.testing.assert_array_equal(two[key], one[key])


_RUNNER = "from financial_rag_system_tpu_torch.serving import app; app.main({argv!r})"


def test_two_process_main_serves_and_worker_parks(tmp_path):
    """The port's main() in two gloo processes of one CPU shard each
    (JAX ``tests/test_multihost.py``): the corpus is ingested once through
    the coordinator, a query whose row lives on the worker's shard comes
    back, the fused hash batch is one broadcast op, /index/save writes
    the sharded file, and the HNSW promotion is itself a broadcast op."""
    coord_port, dist_port, control_port = _free_port(), _free_port(), _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def env(pid: int) -> dict:
        e = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
        e.update(
            TESTING="True", RAG_TPU_PORT=str(coord_port if pid == 0 else _free_port()),
            FRS_CONTROL_PORT=str(control_port), FRS_CONTROL_TOKEN="multiprocess-test-secret",
            RAG_TPU_CORPUS_TILE="8", RAG_TPU_MAX_CORPUS="32",
            DATABASE_URL=str(tmp_path / "cache.db"), INDEX_DIR=str(tmp_path / "index"),
            RAG_TPU_CB_PATH=str(tmp_path / "cb.json"),
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{dist_port}", JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(pid), PYTHONPATH=repo + os.pathsep + e.get("PYTHONPATH", ""),
        )
        return e

    def post(path: str, body: dict, timeout: float = 120):
        req = urllib.request.Request(
            f"http://127.0.0.1:{coord_port}{path}", data=json.dumps(body).encode(),
            headers={"content-type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.load(r)

    argv = ["--device", "cpu", "--mesh-devices", "cpu"]
    logs = [tmp_path / "coord.log", tmp_path / "worker.log"]
    procs = [subprocess.Popen([sys.executable, "-c", _RUNNER.format(argv=argv)], env=env(pid),
                              stdout=open(logf, "w"), stderr=subprocess.STDOUT)
             for pid, logf in enumerate(logs)]
    try:
        deadline = time.time() + 180
        up = False
        while time.time() < deadline and all(p.poll() is None for p in procs):
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{coord_port}/health",
                                            timeout=2) as r:
                    up = r.status == 200
                    break
            except OSError:
                time.sleep(0.5)
        for p, logf in zip(procs, logs):
            assert p.poll() is None, f"process died:\n{logf.read_text()[-3000:]}"
        assert up, f"coordinator never bound:\n{logs[0].read_text()[-3000:]}"
        n = 24  # capacity 32, tile 8: rows [16, 32) live on the worker's shard
        r = post("/index/upsert", {
            "ids": [f"d{i}" for i in range(n)],
            "texts": [f"filing chunk keyword{i} details" for i in range(n)],
            "payloads": [{"ticker": "AAPL", "document_type": "10-K", "source_file": f"f{i}"}
                         for i in range(n)]})
        assert r["indexed_chunks"] == n
        with urllib.request.urlopen(f"http://127.0.0.1:{coord_port}/queue_status",
                                    timeout=30) as resp:
            qs = json.load(resp)
        assert qs["index_tier"] == "Broadcast[ShardedFlatIndex]" and qs["fused_kind"] == "hash"
        r = post("/ask", {"query": "keyword20", "ticker": "AAPL", "top_k": 3})
        assert r["sources"] and "keyword20" in r["sources"][0]["text"], r
        assert post("/index/save", {})["saved_to"]
        assert (tmp_path / "index" / "sharded_index.npz").exists()
        r = post("/index/rebuild", {"tier": "hnsw"})
        assert r["tier"] == "Broadcast[ShardedHNSWIndex]", r
        r = post("/ask", {"query": "keyword21", "ticker": "AAPL", "top_k": 3})
        assert r["sources"] and "keyword21" in r["sources"][0]["text"], r
        post("/index/save", {})
        assert (tmp_path / "index" / "sharded_hnsw_graph.npz").exists()
        assert "worker process" in logs[1].read_text()
    finally:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait(timeout=10)
