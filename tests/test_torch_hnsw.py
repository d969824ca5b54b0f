"""The port's HNSW tier against the JAX package's, on the CPU.

Same rows, ids and payloads in a JAX and a port FlatIndex; graphs built
by each package's native library (single-threaded below 2,048 rows and
512 inserted rows, so both builds are the same graph) or handed to both.
The walk, the descent and the pool run as torch ops here and as XLA in
JAX: rows must be identical, f32 scores within 1e-6 and int8 scores bit
for bit.  The second half ports each case of the JAX package's
``tests/test_hnsw.py`` and ``tests/test_hnsw_online.py``.
"""

from __future__ import annotations

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from test_torch_fused_query import B, K, N, models
# the IVF tests' checkpoint stack and 96-chunk engine, as a fixture
from test_torch_ivf import env, ivf_engine  # noqa: F401

from financial_rag_system_tpu.index import hnsw as jh
from financial_rag_system_tpu.index.flat import FlatIndex as JFlat
from financial_rag_system_tpu.models import bert as jbert
from financial_rag_system_tpu.ops import fused_query as jfq
from financial_rag_system_tpu_torch.index import hnsw as th
from financial_rag_system_tpu_torch.index.flat import FlatIndex as TFlat
from financial_rag_system_tpu_torch.index.hnsw import HNSWIndex, build_knn_graph, hnsw_walk
from financial_rag_system_tpu_torch.ops import fused_query as tfq
from financial_rag_system_tpu_torch.serving.app import build_default_engine, create_app

TICKERS = ("AAPL", "MSFT")


def _corpus(rng, n=2000, d=64):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _clustered(rng, n, d=64, centers=24):
    c = rng.standard_normal((centers, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    v = c[rng.integers(0, centers, n)] + 0.15 * rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _payloads(n, rare_every=0):
    return [{"ticker": "RARE" if rare_every and i % rare_every == 0 else TICKERS[i % 2],
             "document_type": "10-K" if i % 3 else "10-Q"} for i in range(n)]


def _flat(vecs, capacity=None, *, quantized=False, payloads=None):
    n, d = vecs.shape
    idx = TFlat(d, capacity=capacity or n, tile=128, device="cpu",
                dtype=torch.int8 if quantized else torch.bfloat16)
    idx.upsert([f"p{i}" for i in range(n)], vecs, [f"text {i}" for i in range(n)],
               payloads or _payloads(n))
    return idx


def _both(vecs, capacity=None, *, quantized=False, payloads=None):
    n, d = vecs.shape
    j = JFlat(dim=d, capacity=capacity or n, tile=128, use_pallas=False,
              dtype=jnp.int8 if quantized else jnp.bfloat16)
    j.upsert([f"p{i}" for i in range(n)], vecs, [f"text {i}" for i in range(n)],
             payloads or _payloads(n))
    return j, _flat(vecs, capacity, quantized=quantized, payloads=payloads)


def _queries(rng, b=8, d=64):
    return _corpus(rng, b, d)


def _rows(hits):
    return [[h["row"] for h in hl] for hl in hits]


def _recall(hits_a, hits_b, k):
    return float(np.mean([len({h["row"] for h in a} & {h["row"] for h in b}) / k
                          for a, b in zip(hits_a, hits_b)]))


def _assert_same_graph(j, t):
    js, ts = j._graph_state, t._graph_state
    np.testing.assert_array_equal(ts[0].numpy(), np.asarray(js[0]))
    np.testing.assert_array_equal(ts[1].numpy(), np.asarray(js[1]))
    assert ts[2:4] == js[2:4] and ts[5] == js[5]
    assert set(ts[4]) == set(js[4])
    for code in js[4]:
        np.testing.assert_array_equal(ts[4][code], js[4][code])
    assert (ts[6] is None) == (js[6] is None)
    if js[6] is not None:
        np.testing.assert_array_equal(ts[6][0].numpy(), np.asarray(js[6][0]))
        np.testing.assert_array_equal(ts[6][1].numpy(), np.asarray(js[6][1]))
        assert ts[6][2] == js[6][2]
    np.testing.assert_array_equal(ts[7][0].numpy(), np.asarray(js[7][0]))
    assert ts[7][1:] == js[7][1:]
    assert t._tail_rows == j._tail_rows


# -- the port against the JAX package -----------------------------------------


def test_build_knn_graph_matches_jax():
    v = _corpus(np.random.default_rng(20), n=300)
    for m, cap in ((8, 16), (16, 64)):
        adj_j, ent_j = jh.build_knn_graph(v, m=m, entries_cap=cap, seed=3)
        adj_t, ent_t = build_knn_graph(v, m=m, entries_cap=cap, seed=3)
        np.testing.assert_array_equal(adj_t, adj_j)
        np.testing.assert_array_equal(ent_t, ent_j)
    adj_j, _ = jh.build_knn_graph(v[:5], m=8)
    adj_t, _ = build_knn_graph(v[:5], m=8)
    np.testing.assert_array_equal(adj_t, adj_j)  # -1 padded below 2M neighbours


@pytest.fixture(scope="module")
def built_pair():
    """A JAX and a port HNSWIndex over the same 1,536 clustered rows, each
    built by its own package's native library (one thread: the same
    graph), on a flat capacity of 2,048 for online inserts."""
    v = _clustered(np.random.default_rng(21), 1536)
    j, t = _both(v, capacity=2048, payloads=_payloads(1536, rare_every=40))
    kw = dict(m=8, ef=64, frontier=4, entries_cap=16)
    jx, tx = jh.HNSWIndex(j, **kw), HNSWIndex(t, **kw)
    if jx._native is None or tx._native is None:
        pytest.skip("a native HNSW builder is unavailable (no g++)")
    return v, jx, tx


def test_native_state_matches_jax(built_pair):
    _v, jx, tx = built_pair
    assert tx.native_built and tx._graph_state[2] == tx.flat.capacity == 2048
    _assert_same_graph(jx, tx)
    assert set(tx.build_seconds) == {"graph", "hierarchy", "pool", "upload"}


def walk_inputs(jx, tx, q, qf, quantized):
    """(jax args, port args) of the walk over the two indexes' snapshots."""
    jst, tst = jx._graph_state, tx._graph_state
    if quantized:
        jq = jx.flat.prep_queries(jnp.asarray(q))
        tq = th.walk_queries(torch.from_numpy(q), tx.flat.dtype)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    else:
        jq, tq = jnp.asarray(q), torch.from_numpy(q)
    return ((jq, jnp.asarray(qf), jx.flat._emb, jx.flat._codes, jst),
            (tq, torch.from_numpy(qf), tx.flat._emb, tx.flat._codes, tst))


def assert_walk_equal(got, want, exact):
    (s, i), (s_j, i_j) = (tuple(np.asarray(x) for x in got),
                          tuple(np.asarray(x) for x in want))
    np.testing.assert_array_equal(i, i_j)
    fin = np.isfinite(s_j)
    np.testing.assert_array_equal(np.isfinite(s), fin)
    if exact:
        assert s.tobytes() == s_j.tobytes()
    else:
        np.testing.assert_allclose(s[fin], s_j[fin], atol=1e-6, rtol=0)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_descend_pool_and_walk_match_jax(quantized):
    """hier_descend, pool_take and hnsw_walk on the same graph, entries and
    queries: identical rows; f32 scores within 1e-6, int8 bit for bit."""
    rng = np.random.default_rng(22)
    v = _clustered(rng, 1536)
    j, t = _both(v, capacity=2048, quantized=quantized)
    kw = dict(m=8, ef=64, frontier=4, entries_cap=16)
    jx, tx = jh.HNSWIndex(j, **kw), HNSWIndex(t, **kw)
    if jx._native is None or tx._native is None:
        pytest.skip("a native HNSW builder is unavailable (no g++)")
    q = _clustered(rng, 16)
    qf = np.array([[-1, -1], [0, -1], [1, 1], [-1, 0]] * 4, np.int32)
    codes_t = tx.flat.store.query_codes
    qf[:, 0] = np.where(qf[:, 0] < 0, -1, [codes_t(TICKERS[c % 2], None)[0] for c in qf[:, 0]])
    (jq, jqf, jemb, jcodes, jst), (tq, tqf, temb, tcodes, tst) = walk_inputs(
        jx, tx, q, qf, quantized)
    hi_j, hi_t = jst[6], tst[6]
    d_j = jh.hier_descend(jq, jemb, hi_j[0], hi_j[1], jnp.int32(hi_j[2]), beam=16, steps=4,
                          frontier=4, pad_global=jst[2])
    d_t = th.hier_descend(tq, temb, *hi_t, beam=16, steps=4, frontier=4, pad_global=tst[2])
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    p_j = jh.pool_take(jq, jemb, jst[7][0], take=jst[7][3], pad_global=jst[2])
    p_t = th.pool_take(tq, temb, tst[7][0], take=tst[7][3], pad_global=tst[2])
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    seeds_j = jnp.concatenate([p_j, d_j, jnp.broadcast_to(jst[1], (16, jst[1].shape[0]))], 1)
    seeds_t = torch.cat([p_t, d_t, tst[1][None].expand(16, -1)], 1)
    for k in (15, 40):
        want = jh.hnsw_walk(jq, jqf, jemb, jcodes, jst[0], seeds_j, k, ef=jst[3],
                            steps=tx.steps, frontier=4, pad_id=jst[2])
        got = hnsw_walk(tq, tqf, temb, tcodes, tst[0], seeds_t, k, ef=tst[3],
                        steps=tx.steps, frontier=4, pad_id=tst[2])
        assert_walk_equal(got, want, exact=quantized)
    # the fixed entries alone (a (E,) seed list shared by the batch)
    want = jh.hnsw_walk(jq, jqf, jemb, jcodes, jst[0], jst[1], 15, ef=jst[3], steps=6,
                        frontier=4, pad_id=jst[2])
    got = hnsw_walk(tq, tqf, temb, tcodes, tst[0], tst[1], 15, ef=tst[3], steps=6,
                    frontier=4, pad_id=tst[2])
    assert_walk_equal(got, want, exact=quantized)


def test_search_device_matches_jax(built_pair):
    """search_batch with wildcard, ticker, ticker+type and selective (RARE)
    filters; then online inserts (the same native graph on both sides),
    a capacity-growing upsert that tails, and the tail merged exactly."""
    v, jx, tx = built_pair
    rng = np.random.default_rng(23)
    q = _clustered(rng, 8)
    filters = [(None, None), ("AAPL", None), ("MSFT", "10-K"), ("RARE", None),
               (None, "10-Q"), ("AAPL", "10-Q"), ("RARE", "10-K"), ("NOPE", None)]

    def same():
        hj = jx.search_batch(q, filters, k=10)
        ht = tx.search_batch(q, filters, k=10)
        assert _rows(ht) == _rows(hj)
        for a, b in zip(ht, hj):
            np.testing.assert_allclose([h["score"] for h in a], [h["score"] for h in b],
                                       atol=1e-6, rtol=0)
        return ht

    hits = same()
    assert all(h["ticker"] == "RARE" for h in hits[3]) and hits[3] and hits[7] == []
    # online inserts: identical dirty rows, adjacency, hierarchy and pool
    nv = _clustered(rng, 40)
    for idx in (jx, tx):
        idx.upsert([f"x{i}" for i in range(40)], nv, [f"new {i}" for i in range(40)],
                   _payloads(40, rare_every=7))
    assert tx._tail_rows == [] and tx.n_graph == 1576
    _assert_same_graph(jx, tx)
    hits = same()
    got = tx.search_batch(nv[:4], [(None, None)] * 4, k=3)
    assert [hl[0]["row"] for hl in got] == [1536, 1537, 1538, 1539]
    # past the capacity: the sentinel would alias a row, so the rows tail
    grow = _clustered(rng, 2048 - 1576 + 8)
    for idx in (jx, tx):
        idx.upsert([f"g{i}" for i in range(len(grow))], grow,
                   [f"grow {i}" for i in range(len(grow))], _payloads(len(grow)))
    assert tx._tail_rows == jx._tail_rows and len(tx._tail_rows) == len(grow)
    same()


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_graph_file_loads_across_packages(saver, tmp_path):
    """An hnsw_graph.npz saved by either package (after online inserts)
    loads in the other with the same graph, hierarchy, pool and search;
    the stale-file check holds both ways."""
    rng = np.random.default_rng(24)
    v = _clustered(rng, 1024)
    j, t = _both(v, capacity=2048)
    jx, tx = jh.HNSWIndex(j, m=8, ef=64, frontier=4), HNSWIndex(t, m=8, ef=64, frontier=4)
    if jx._native is None or tx._native is None:
        pytest.skip("a native HNSW builder is unavailable (no g++)")
    nv = _clustered(rng, 8)
    src = jx if saver == "jax" else tx
    src.upsert([f"o{i}" for i in range(8)], nv, [f"online {i}" for i in range(8)],
               _payloads(8))
    src.save(str(tmp_path))
    if saver == "jax":
        loaded = HNSWIndex.load(str(tmp_path), TFlat.load(str(tmp_path), device="cpu"))
    else:
        loaded = jh.HNSWIndex.load(str(tmp_path), JFlat.load(str(tmp_path), use_pallas=False))
    assert loaded.n_graph == 1032 and not loaded._tail_rows
    saved = np.load(tmp_path / "hnsw_graph.npz")
    np.testing.assert_array_equal(saved["adj"], src._native.adjacency())
    np.testing.assert_array_equal(np.asarray(loaded._host_graph[0]), saved["adj"])
    np.testing.assert_array_equal(np.asarray(loaded._host_graph[1]), saved["entries"])
    np.testing.assert_array_equal(np.asarray(loaded._host_pool[0]), src._host_pool[0])
    # the loaded graph (sentinel n, exact-size hierarchy) walks as the live
    # one (sentinel = capacity) does, and finds the inserted rows
    q = np.concatenate([nv[:4], _clustered(rng, 4)])
    rows = _rows(loaded.search_batch(q, [(None, None)] * 8, k=5))
    assert rows == _rows(src.search_batch(q, [(None, None)] * 8, k=5))
    assert [r[0] for r in rows[:4]] == [1024, 1025, 1026, 1027]
    # a graph over more rows than the flat index beside it is stale
    small = TFlat(64, capacity=256, tile=128, device="cpu")
    small.upsert([f"s{i}" for i in range(128)], v[:128], ["s"] * 128, _payloads(128))
    small.save(str(tmp_path))
    with pytest.raises(ValueError, match="stale graph"):
        HNSWIndex.load(str(tmp_path), TFlat.load(str(tmp_path), device="cpu"))
    with pytest.raises(ValueError, match="stale graph"):
        jh.HNSWIndex.load(str(tmp_path), JFlat.load(str(tmp_path), use_pallas=False))


def test_loaded_graph_search_matches_jax(tmp_path):
    """A JAX-built graph loaded by both packages (the tail contract: no
    native handle) serves the same rows, tail rows included."""
    rng = np.random.default_rng(25)
    v = _clustered(rng, 900)
    j, _ = _both(v, capacity=1024)
    jh.HNSWIndex(j, m=8, ef=64, frontier=4).save(str(tmp_path))
    jl = jh.HNSWIndex.load(str(tmp_path), JFlat.load(str(tmp_path), use_pallas=False))
    tl = HNSWIndex.load(str(tmp_path), TFlat.load(str(tmp_path), device="cpu"))
    _assert_same_graph(jl, tl)
    nv = _clustered(rng, 3)
    for idx in (jl, tl):
        idx.upsert(["t0", "t1", "t2"], nv, ["a", "b", "c"], _payloads(3))
    assert tl._tail_rows == jl._tail_rows == [900, 901, 902]
    q = np.concatenate([nv, _clustered(rng, 5)])
    filters = [(None, None), ("AAPL", None), ("MSFT", "10-K")] * 2 + [(None, None)] * 2
    assert _rows(tl.search_batch(q, filters, k=7)) == _rows(jl.search_batch(q, filters, k=7))


# -- the fused HNSW program ---------------------------------------------------


@pytest.fixture(scope="module")
def graph_case():
    """The fused-query test's models and queries over a graph-shaped
    corpus: rows in random directions (scores spread, no near-ties), and
    15 rows planted under each query's ticker at cosines 0.9 - 0.02 j,
    above every random row; one k-NN graph and k-center pool for both
    packages."""
    rng = np.random.default_rng(26)
    e_params, e_jcfg, e_model, _ = models(0)
    r_params, r_jcfg, r_model, r_tcfg = models(1, num_labels=1)
    lq, dlen, n_live = 32, 24, N - 100
    lens = np.array([9, 20, 5, 32])
    q_ids = rng.integers(500, 1000, (B, lq)).astype(np.int32)
    q_mask = (np.arange(lq)[None, :] < lens[:, None]).astype(np.int32)
    q_ids[:, 0] = 101
    q_ids[np.arange(B), lens - 1] = 102
    q_ids *= q_mask
    q = (q_ids, np.zeros_like(q_ids), q_mask)
    h = np.asarray(jbert.encode(e_params, *q, e_jcfg))
    qv = h[:, 0] / np.linalg.norm(h[:, 0], axis=1, keepdims=True)
    c = _corpus(rng, N).astype(np.float64)
    planted = rng.permutation(n_live)[: B * K].reshape(B, K)
    qf = np.array([[0, -1], [1, -1], [2, 1], [3, 0]], np.int32)
    codes = np.stack([rng.integers(0, 4, N), rng.integers(0, 2, N)]).astype(np.int32)
    for i in range(B):
        for j, row in enumerate(planted[i]):
            cos = 0.9 - 0.02 * j
            r = c[row] - (c[row] @ qv[i]) * qv[i]
            c[row] = cos * qv[i] + np.sqrt(1 - cos**2) * r / np.linalg.norm(r)
            codes[0, row], codes[1, row] = qf[i, 0], max(qf[i, 1], 0)
    codes[:, n_live:] = -2
    corpus = torch.from_numpy(c.astype(np.float32)).bfloat16()
    dl = rng.integers(3, dlen + 1, N)
    dtok = rng.integers(500, 1000, (N, dlen)).astype(np.int32)
    dtok[np.arange(N), dl - 1] = 102
    dtok *= np.arange(dlen)[None, :] < dl[:, None]
    vecs = corpus[:n_live].float().numpy()
    adj, ent = build_knn_graph(vecs, m=8, entries_cap=16)
    adj = np.concatenate([np.where(adj < 0, n_live, adj),
                          np.full((1, adj.shape[1]), n_live)]).astype(np.int32)
    pool = np.concatenate([th.kcenter_rows_host(vecs, 64),
                           np.full(16, n_live, np.int32)]).astype(np.int32)
    return dict(e=(e_params, e_jcfg, e_model), r=(r_params, r_jcfg, r_model, r_tcfg), q=q,
                qf=qf, corpus=corpus, codes=codes, dtok=dtok, planted=planted, adj=adj,
                ent=ent, pool=pool, n_live=n_live)


@pytest.mark.parametrize("take", [32, 0])
def test_fused_hnsw_matches_jax(graph_case, take):
    """make_fused_hnsw_query against JAX's on one graph: the same rows,
    bi and ce within the fused tests' bounds, with the k-center pool's
    seeds (then exactly the planted rows) and without them."""
    g = graph_case
    e_params, e_jcfg, e_model = g["e"]
    r_params, r_jcfg, r_model, r_tcfg = g["r"]
    geo = dict(k=K, ef=64 + take, steps=16, frontier=8, pad_id=g["n_live"])
    jfn = jfq.make_fused_hnsw_query(e_jcfg, r_jcfg, pool_take=take, **geo)
    want = jfn(e_params, r_params, *(jnp.asarray(a) for a in g["q"]), jnp.asarray(g["qf"]),
               jnp.asarray(g["corpus"].float().numpy(), jnp.bfloat16), jnp.asarray(g["codes"]),
               jnp.asarray(g["adj"]), jnp.asarray(g["ent"]), jnp.asarray(g["dtok"]),
               **({"pool_rows": jnp.asarray(g["pool"])} if take else {}))
    tfn = tfq.make_fused_hnsw_query(r_tcfg, pool_take=take, **geo)
    got = tfn(e_model, r_model, *(torch.from_numpy(a) for a in g["q"]),
              torch.from_numpy(g["qf"]), g["corpus"], torch.from_numpy(g["codes"]),
              torch.from_numpy(g["adj"]), torch.from_numpy(g["ent"]), torch.from_numpy(g["dtok"]),
              torch.from_numpy(g["pool"]) if take else None, None)
    rows_j, bi_j, ce_j = (np.asarray(x) for x in want)
    rows_t, bi_t, ce_t = (x.numpy() for x in got)
    assert rows_t.shape == bi_t.shape == ce_t.shape == (B, K)
    np.testing.assert_array_equal(rows_t, rows_j)
    if take:  # the pool's seeds route every query to its planted rows
        np.testing.assert_array_equal(rows_t, g["planted"])
    np.testing.assert_allclose(bi_t, bi_j, atol=2e-3, rtol=0)
    np.testing.assert_allclose(ce_t, ce_j, atol=3e-2, rtol=0)
    assert np.isfinite(ce_t).all()


# -- the JAX package's tests/test_hnsw.py, ported ----------------------------------


def test_knn_fallback_graph_shape():
    v = _corpus(np.random.default_rng(0), n=300)
    adj, ent = build_knn_graph(v, m=8, entries_cap=16)
    assert adj.shape == (300, 16) and adj.dtype == np.int32
    assert all(adj[i, 0] != i for i in range(300))
    assert adj.max() < 300 and ent.shape[0] == 16


def test_recall_vs_flat_unfiltered():
    rng = np.random.default_rng(1)
    flat = _flat(_corpus(rng))
    hx = HNSWIndex(flat, m=16, ef=128, frontier=8)
    q = _queries(rng)
    fh = flat.search_batch(q, [(None, None)] * 8, k=10)
    hh = hx.search_batch(q, [(None, None)] * 8, k=10)
    assert _recall(hh, fh, 10) >= 0.9


def test_filtered_search_respects_filter_and_recalls():
    rng = np.random.default_rng(2)
    flat = _flat(_corpus(rng))
    hx = HNSWIndex(flat, m=16, ef=128, frontier=8)
    q = _queries(rng)
    fh = flat.search_batch(q, [("AAPL", None)] * 8, k=10)
    hh = hx.search_batch(q, [("AAPL", None)] * 8, k=10)
    assert all(h["ticker"] == "AAPL" for hits in hh for h in hits)
    assert _recall(hh, fh, 10) >= 0.8


def test_mixed_filter_batch():
    rng = np.random.default_rng(3)
    hx = HNSWIndex(_flat(_corpus(rng, n=1000)), m=16, ef=96, frontier=8)
    filters = [("AAPL", None), ("MSFT", None), (None, None), ("AAPL", "10-K")]
    hh = hx.search_batch(_queries(rng, b=4), filters, k=5)
    assert all(h["ticker"] == "AAPL" for h in hh[0])
    assert all(h["ticker"] == "MSFT" for h in hh[1])
    assert all(h["ticker"] == "AAPL" and h["document_type"] == "10-K" for h in hh[3])


def test_no_duplicate_rows_in_results():
    rng = np.random.default_rng(4)
    hx = HNSWIndex(_flat(_corpus(rng, n=1000)), m=16, ef=128, frontier=8)
    for hits in hx.search_batch(_queries(rng), [(None, None)] * 8, k=10):
        rows = [h["row"] for h in hits]
        assert len(rows) == len(set(rows))


def test_tail_upsert_and_rebuild():
    rng = np.random.default_rng(5)
    hx = HNSWIndex(_flat(_corpus(rng, n=512)), m=8, ef=64, frontier=4)
    nv = _queries(rng, b=1)
    hx.upsert(["new0"], nv, ["new text"], [{"ticker": "NVDA"}])
    assert len(hx._tail_rows) == 1  # the upsert grew the capacity
    hits = hx.search_batch(nv, [("NVDA", None)], k=3)[0]
    assert hits and hits[0]["ticker"] == "NVDA"
    assert hits[0]["score"] == pytest.approx(1.0, abs=5e-2)
    hx.rebuild()
    assert not hx._tail_rows and hx.n_graph == 513
    hits = hx.search_batch(nv, [("NVDA", None)], k=3)[0]
    assert hits and hits[0]["ticker"] == "NVDA"


def test_save_load_round_trip(tmp_path):
    rng = np.random.default_rng(6)
    hx = HNSWIndex(_flat(_corpus(rng, n=512)), m=8, ef=64, frontier=4)
    q = _queries(rng, b=4)
    before = hx.search_batch(q, [(None, None)] * 4, k=5)
    hx.save(str(tmp_path))
    hx2 = HNSWIndex.load(str(tmp_path), TFlat.load(str(tmp_path), device="cpu"))
    assert _rows(hx2.search_batch(q, [(None, None)] * 4, k=5)) == _rows(before)


def test_walk_static_shapes_and_empty_filter():
    rng = np.random.default_rng(7)
    hx = HNSWIndex(_flat(_corpus(rng, n=256)), m=8, ef=64, frontier=4)
    assert hx.search_batch(_queries(rng, b=2), [("NOPE", None)] * 2, k=5) == [[], []]


def test_engine_promote_to_hnsw():
    from financial_rag_system_tpu_torch.models.embedder import get_embedder
    from financial_rag_system_tpu_torch.models.reranker import get_reranker
    from financial_rag_system_tpu_torch.serving.engine import RAGEngine
    from financial_rag_system_tpu_torch.utils.config import get_config

    cfg = get_config()
    emb = get_embedder(cfg.embed_dim, device="cpu")
    flat = TFlat(cfg.embed_dim, capacity=512, tile=128, device="cpu")
    texts = [f"chunk about revenue {i}" for i in range(64)]
    flat.upsert([f"p{i}" for i in range(64)], emb.encode(texts), texts,
                [{"ticker": "AAPL", "document_type": "10-K"}] * 64)
    eng = RAGEngine(cfg, flat, emb, get_reranker(testing=True, device="cpu"),
                    mode="sequential")
    out = eng.rebuild_index("hnsw")
    assert out["status"] == "ok" and out["tier"] == "HNSWIndex"
    assert eng.queue_status()["fused_kind"] is None  # the hash stack serves staged
    assert eng.rebuild_index()["tier"] == "HNSWIndex"  # the generic path keeps the tier
    (_vec, hits), = eng._dispatch_batch(["revenue"], [("AAPL", None)])
    assert hits and all(h["ticker"] == "AAPL" for h in hits)


def test_stale_graph_file_rejected(tmp_path):
    rng = np.random.default_rng(9)
    v = _corpus(rng, n=512)
    HNSWIndex(_flat(v), m=8, ef=64, frontier=4).save(str(tmp_path))
    _flat(v[:128]).save(str(tmp_path))
    with pytest.raises(ValueError, match="stale graph"):
        HNSWIndex.load(str(tmp_path), TFlat.load(str(tmp_path), device="cpu"))


def test_rebuild_keeps_tail_visible_until_swap():
    rng = np.random.default_rng(10)
    hx = HNSWIndex(_flat(_corpus(rng, n=256)), m=8, ef=64, frontier=4)
    nv = _queries(rng, b=1)
    hx.upsert(["new0"], nv, ["new text"], [{"ticker": "NVDA"}])
    hx._tail_rows = [256]
    old = hx._graph_state
    # a search between a build and its publication reads the old snapshot
    # and the old tail
    state = hx._build()
    hx._graph_state, hx._tail_rows = old, [256]
    hits = hx.search_batch(nv, [("NVDA", None)], k=3)[0]
    assert hits and hits[0]["ticker"] == "NVDA"  # old tail still live
    hx._graph_state, hx._tail_rows = state, list(range(state[5], hx.flat.n_valid))
    assert not hx._tail_rows
    hits = hx.search_batch(nv, [("NVDA", None)], k=3)[0]
    assert hits and hits[0]["ticker"] == "NVDA"  # now in the graph


def test_selective_filter_exact_path():
    """A minority ticker (5% of rows) must not lose recall to the walk."""
    rng = np.random.default_rng(11)
    v = _corpus(rng, n=2000)
    flat = _flat(v, payloads=[{"ticker": "RARE" if i % 20 == 0 else "COMMON",
                               "document_type": "10-K"} for i in range(2000)])
    hx = HNSWIndex(flat, m=16, ef=64, frontier=4)
    q = _queries(rng)
    fh = flat.search_batch(q, [("RARE", None)] * 8, k=10)
    hh = hx.search_batch(q, [("RARE", None)] * 8, k=10)
    assert all(h["ticker"] == "RARE" for hl in hh for h in hl)
    assert _recall(hh, fh, 10) == 1.0
    for hl in hh:
        rows = [h["row"] for h in hl]
        assert len(rows) == len(set(rows))


def test_hier_descend_routes_to_outlier_island():
    """Targets in a tiny outlier island with no similarity gradient from
    the corpus bulk are unreachable by a budget-bounded level-0 walk from
    fixed entries, and reachable once the routing aids seed it."""
    from financial_rag_system_tpu_torch.native.loader import native_enabled

    if not native_enabled():
        pytest.skip("needs the native builder (hierarchy export)")
    rng = np.random.default_rng(11)
    d, n_island, n_bulk = 32, 64, 20_000
    bulk = rng.standard_normal((n_bulk, d)).astype(np.float32)
    axis = np.zeros(d, np.float32)
    axis[0] = 1.0
    bulk -= np.outer(bulk @ axis, axis)  # the bulk orthogonal to the island
    island = axis[None, :] + 0.05 * rng.standard_normal((n_island, d)).astype(np.float32)
    v = np.concatenate([island, bulk])  # the island first: later inserts prune its backlinks
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    hx = HNSWIndex(_flat(v), m=16, ef=32, frontier=2, steps=4, entries_cap=4)
    assert hx.native_built
    hier = hx._graph_state[6]
    assert hier is not None and (hier[0][: hier[2]].numpy() < n_island).sum() >= 1
    decoy = rng.standard_normal((8, d)).astype(np.float32)
    decoy -= np.outer(decoy @ axis, axis)
    decoy /= np.linalg.norm(decoy, axis=1, keepdims=True)
    q = axis[None, :] + 0.4 * decoy
    q /= np.linalg.norm(q, axis=1, keepdims=True)

    def island_share(hits):
        return np.mean([np.mean([h["row"] < n_island for h in hl]) for hl in hits])

    hit_with = island_share(hx.search_batch(q, [(None, None)] * 8, k=5))
    hx._graph_state = hx._graph_state[:6] + (None, None)  # no routing aids
    hit_without = island_share(hx.search_batch(q, [(None, None)] * 8, k=5))
    assert hit_with >= 0.9, f"routing aids failed: {hit_with}"
    assert hit_with > hit_without, (hit_with, hit_without)


# -- the JAX package's tests/test_hnsw_online.py, ported ---------------------------


@pytest.fixture()
def built():
    rng = np.random.default_rng(0)
    v = _clustered(rng, 1024)
    hx = HNSWIndex(_flat(v, capacity=2048), m=8, ef=64, frontier=4)
    if hx._native is None:
        pytest.skip("native HNSW builder unavailable")
    return hx, rng


def test_upsert_enters_graph_without_tail(built):
    hx, rng = built
    assert not hx._tail_rows
    n0 = hx.n_graph
    adj0 = hx.adj_pad
    nv = _clustered(rng, 4)
    hx.upsert([f"x{i}" for i in range(4)], nv, [f"new {i}" for i in range(4)],
              [{"ticker": "NVDA", "document_type": "10-K"}] * 4)
    assert hx._tail_rows == [] and hx.n_graph == n0 + 4
    assert hx.adj_pad is not adj0 and (adj0[n0:n0 + 4] == hx._graph_state[2]).all()
    for i, hl in enumerate(hx.search_batch(nv, [(None, None)] * 4, k=5)):
        assert hl and hl[0]["row"] == n0 + i  # found by the walk


def test_online_insert_selective_filter_sees_new_rows(built):
    hx, rng = built
    nv = _clustered(rng, 2)
    hx.upsert(["s0", "s1"], nv, ["sel 0", "sel 1"],
              [{"ticker": "RARE", "document_type": "10-K"}] * 2)
    hits = hx.search_batch(nv[:1], [("RARE", None)], k=2)[0]
    assert {h["ticker"] for h in hits} == {"RARE"} and len(hits) == 2


def test_bulk_online_insert_recall_matches_fresh_build():
    rng = np.random.default_rng(0)
    v = _clustered(rng, 1536)
    flat = _flat(v[:1024], capacity=2048)
    hx = HNSWIndex(flat, m=8, ef=64, frontier=4)
    if hx._native is None:
        pytest.skip("native HNSW builder unavailable")
    hx.upsert([f"b{i}" for i in range(512)], v[1024:], [f"bulk {i}" for i in range(512)],
              [{"ticker": "AAPL", "document_type": "10-K"}] * 512)
    assert not hx._tail_rows and hx.n_graph == 1536
    q = _clustered(rng, 8)
    fh = flat.search_batch(q, [(None, None)] * 8, k=10)
    hh = hx.search_batch(q, [(None, None)] * 8, k=10)
    assert _recall(hh, fh, 10) >= 0.9


def test_capacity_growth_falls_back_to_tail(built):
    hx, rng = built
    cap = hx.flat.capacity
    n_extra = cap - hx.flat.n_valid + 8
    nv = _clustered(rng, n_extra)
    hx.upsert([f"g{i}" for i in range(n_extra)], nv, [f"grow {i}" for i in range(n_extra)],
              [{"ticker": "GROW", "document_type": "10-K"}] * n_extra)
    assert hx.flat.capacity > cap and hx._tail_rows
    hits = hx.search_batch(nv[-1:], [("GROW", None)], k=3)[0]
    assert hits and hits[0]["ticker"] == "GROW"
    hx.rebuild()
    assert not hx._tail_rows
    hits = hx.search_batch(nv[-1:], [("GROW", None)], k=3)[0]
    assert hits and hits[0]["ticker"] == "GROW"


def test_save_load_includes_online_inserts(built, tmp_path):
    hx, rng = built
    nv = _clustered(rng, 8)
    hx.upsert([f"o{i}" for i in range(8)], nv, [f"online {i}" for i in range(8)],
              [{"ticker": "NVDA", "document_type": "10-K"}] * 8)
    hx.save(str(tmp_path))
    hx2 = HNSWIndex.load(str(tmp_path), TFlat.load(str(tmp_path), device="cpu"))
    assert hx2.n_graph == hx.n_graph and not hx2._tail_rows
    hits = hx2.search_batch(nv[:1], [("NVDA", None)], k=3)[0]
    assert hits and hits[0]["ticker"] == "NVDA"


def test_rebuild_is_optional_compaction(built):
    hx, rng = built
    nv = _clustered(rng, 16)
    hx.upsert([f"c{i}" for i in range(16)], nv, [f"compact {i}" for i in range(16)],
              [{"ticker": "AAPL", "document_type": "10-K"}] * 16)
    n = hx.n_graph
    hx.rebuild()
    assert hx.n_graph == n and not hx._tail_rows
    hits = hx.search_batch(nv[:1], [(None, None)], k=3)[0]
    assert hits and hits[0]["row"] == n - 16


def test_searches_during_online_upserts_read_whole_snapshots():
    """More threads than cores search while one thread upserts 16 batches
    online, with a short switch interval: every search reads one snapshot
    (10 distinct live rows a query, scores descending), and in the end
    every batch is in the graph, with no tail, and found by its vectors."""
    import os
    import sys
    import threading

    rng = np.random.default_rng(30)
    v = _clustered(rng, 1536)
    hx = HNSWIndex(_flat(v[:1024], capacity=2048), m=8, ef=64, frontier=4)
    if hx._native is None:
        pytest.skip("native HNSW builder unavailable")
    q = _clustered(rng, 8)
    errors, done = [], threading.Event()

    def search():
        try:
            while not done.is_set():
                for hl in hx.search_batch(q, [(None, None)] * 8, k=10):
                    scores = [h["score"] for h in hl]
                    assert len({h["row"] for h in hl}) == 10
                    assert scores == sorted(scores, reverse=True)
        except Exception as exc:  # reported by the main thread
            errors.append(exc)

    def upsert():
        try:
            for i in range(16):
                lo = 1024 + 32 * i
                hx.upsert([f"u{r}" for r in range(lo, lo + 32)], v[lo : lo + 32],
                          [f"up {r}" for r in range(lo, lo + 32)], _payloads(32))
        except Exception as exc:
            errors.append(exc)
        finally:
            done.set()

    threads = [threading.Thread(target=search) for _ in range((os.cpu_count() or 4) + 2)]
    threads.append(threading.Thread(target=upsert))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert hx.n_graph == 1536 and not hx._tail_rows
    found = hx.search_batch(v[1024::64], [(None, None)] * 8, k=1)
    assert [hl[0]["row"] for hl in found] == list(range(1024, 1536, 64))


# -- no quiet fallback ------------------------------------------------------------


def test_fallback_refuses_large_corpora_without_native(monkeypatch):
    from financial_rag_system_tpu_torch.native import hnsw_loader

    monkeypatch.setattr(hnsw_loader, "build_hnsw_graph_handle", lambda *a, **k: None)
    flat = _flat(_corpus(np.random.default_rng(12), n=300))
    hx = HNSWIndex(flat, m=8, ef=64, frontier=4)
    assert hx._native is None and hx.native_built is False and hx.n_graph == 300
    monkeypatch.setattr(HNSWIndex, "MAX_FALLBACK_ROWS", 200)
    with pytest.raises(RuntimeError, match="refusing at 300 rows"):
        HNSWIndex(flat, m=8)


# -- the engine and the HTTP surface ------------------------------------------


def test_engine_serves_the_hnsw_tier_fused_and_staged(env):
    """rebuild_index("hnsw") over a checkpoint stack: the fused hnsw_full
    batch gives the staged path's rows; tail rows, a selective filter and
    a changed geometry serve staged; an upsert enters the graph online and
    the next fused ask finds it."""
    eng = ivf_engine()
    out = eng.rebuild_index("hnsw")
    assert out == {"status": "ok", "tier": "HNSWIndex", "clusters": None, "tail_rows": 0}
    assert eng.queue_status()["fused_kind"] == "hnsw_full"
    idx = eng.index
    assert idx._native is not None and idx._graph_state[2] == idx.flat.capacity
    queries, filters = ["margin", "cloud growth"], [("AAPL", None), ("MSFT", "10-K")]
    assert eng._fused_batch(queries, filters) is None  # every ticker of 96 rows is selective
    idx.SELECTIVE_LIMIT = 0
    fused = eng._fused_batch(queries, filters)
    staged = eng._embed_retrieve_batch(queries, filters)
    for (_, f), (_, s) in zip(fused, staged):
        assert f and all("rerank_score" in h for h in f)
        assert [h["row"] for h in f] == [h["row"] for h in s]
    assert all(h["ticker"] == "MSFT" and h["document_type"] == "10-K" for h in fused[1][1])
    idx._tail_rows.append(5)
    assert eng._fused_batch(queries, filters) is None
    idx._tail_rows.clear()
    eng._fused = eng._fused[:2] + ((0, True, 0),) + eng._fused[3:]  # as after a rebuild
    assert eng._fused_batch(queries, filters) is None
    eng._fused = eng._maybe_build_fused()

    text = "NVDA datacenter accelerator shipments doubled " * 3

    async def scenario():
        await eng.startup()
        try:
            new = await eng.ingest_chunks(["nv0"], [text],
                                          [{"ticker": "NVDA", "document_type": "8-K"}])
            assert new == 1 and idx._tail_rows == [] and idx.n_graph == 97
            n0 = eng.tracer.metrics_snapshot().get("fused_device_ms", {}).get("count", 0)
            resp = await eng.ask(text, "NVDA", top_k=3)
            n1 = eng.tracer.metrics_snapshot().get("fused_device_ms", {}).get("count", 0)
            return resp, n1 - n0
        finally:
            await eng.shutdown()

    resp, fused_batches = asyncio.run(scenario())
    assert resp["cached"] is False and resp["sources"][0]["text"] == text
    assert all(np.isfinite(s["score"]) for s in resp["sources"])
    assert fused_batches == 1  # found by the fused walk, not the staged path


def test_http_rebuild_save_and_restore_hnsw(env):
    """POST /index/rebuild {"tier": "hnsw"} serves; /index/save writes
    hnsw_graph.npz (and removes an IVF file); a restart restores the HNSW
    tier from disk and searches as before; an IVF save removes the graph."""
    eng = ivf_engine()

    async def scenario(engine, *calls):
        async with TestClient(TestServer(create_app(engine))) as client:
            out = []
            for method, path, body in calls:
                r = await getattr(client, method)(path, **({"json": body} if body else {}))
                assert r.status == 200, (path, r.status)
                out.append(await r.json())
            return out

    rebuilt, status, _ = asyncio.run(scenario(
        eng, ("post", "/index/rebuild", {"tier": "ivf"}), ("get", "/queue_status", None),
        ("post", "/index/save", None)))
    assert (env / "index" / "ivf_index.npz").exists()
    rebuilt, status, _ = asyncio.run(scenario(
        eng, ("post", "/index/rebuild", {"tier": "hnsw"}), ("get", "/queue_status", None),
        ("post", "/index/save", None)))
    assert rebuilt["tier"] == "HNSWIndex" and status["fused_kind"] == "hnsw_full"
    assert (env / "index" / "hnsw_graph.npz").exists()
    assert not (env / "index" / "ivf_index.npz").exists()
    eng2 = build_default_engine(device="cpu")
    assert isinstance(eng2.index, HNSWIndex) and eng2._fused_kind == "hnsw_full"
    q = eng.embedder.encode(["risk", "buybacks"])
    assert _rows(eng2.index.search_batch(q, [(None, None)] * 2)) == _rows(
        eng.index.search_batch(q, [(None, None)] * 2))
    asyncio.run(scenario(eng2, ("post", "/index/rebuild", {"tier": "ivf"}),
                         ("post", "/index/save", None)))
    assert not (env / "index" / "hnsw_graph.npz").exists()
    assert type(build_default_engine(device="cpu").index).__name__ == "IVFIndex"
