"""int8 corpora in the port against the JAX package, on the CPU.

The flat index (rows quantized on upsert, queries quantized for search,
an index saved by either package loaded in the other), the IVF tier over
an int8 flat index (packing, bf16 centroids, online upserts, kernel 3's
plain version against the Pallas kernel's int8 branch in interpret mode,
a JAX-saved ``ivf_index.npz``), the fused flat and IVF pipelines and
``build_default_engine`` with ``RAG_TPU_INDEX_DTYPE=int8``.  An int8 score
is an integer dot product, exact in f32 in both packages, so retrieval
is compared bit for bit wherever both sides score the same int8 queries.
"""

from __future__ import annotations

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the fused flat pipeline's case, as a fixture
from test_torch_fused_query import case  # noqa: F401
from test_torch_fused_query import K, N, port_args
from test_torch_ivf import assert_same_state, chunks, clustered, models, packed_case, rows_of

from financial_rag_system_tpu.index import ivf as jivf
from financial_rag_system_tpu.index.flat import FlatIndex as JFlat
from financial_rag_system_tpu.models import bert as jbert
from financial_rag_system_tpu.ops import fused_query as jfq
from financial_rag_system_tpu_torch.index import ivf as tivf
from financial_rag_system_tpu_torch.index.flat import FlatIndex as TFlat
from financial_rag_system_tpu_torch.index.flat import quantize_int8
from financial_rag_system_tpu_torch.ops import fused_query as tfq
from financial_rag_system_tpu_torch.serving.app import build_default_engine
from financial_rag_system_tpu_torch.utils.config import reset_config


def quant(a: np.ndarray) -> np.ndarray:
    """The JAX package's row quantization (``index/flat.py:207-208``)."""
    return np.clip(np.rint(np.asarray(a, np.float32) * 127.0), -127, 127).astype(np.int8)


def int8_flats(vecs, capacity=None):
    """The same rows, ids and payloads in a JAX and a port int8 FlatIndex."""
    n, d = vecs.shape
    j = JFlat(dim=d, capacity=capacity or n, tile=128, use_pallas=False, dtype=jnp.int8)
    t = TFlat(d, capacity=capacity or n, tile=128, device="cpu", dtype=torch.int8)
    ids, texts, payloads = chunks(n)
    j.upsert(ids, vecs, texts, payloads)
    t.upsert(ids, vecs, texts, payloads)
    return j, t


def search_both(j, t, q, k=15):
    filters = [(None, None), ("AAPL", None), ("MSFT", "10-Q"), ("NVDA", None)] * 2
    q = q[: len(filters)]
    got, want = t.search_batch(q, filters, k=k), j.search_batch(q, filters, k=k)
    assert rows_of(got) == rows_of(want)
    assert [[h["score"] for h in hs] for hs in got] == [[h["score"] for h in hs] for hs in want]
    return got


# -- the flat index ----------------------------------------------------------------


def test_quantized_queries_equal_jax():
    """Rows and queries quantize alike in both packages (half to even),
    in the index and inside the fused pipeline."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((64, 96)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0, :21] = (np.arange(-10, 11) + 0.5) / 127.0  # values near the half steps
    want = np.asarray(jfq._prep_queries(jnp.asarray(q), jnp.int8, True))
    j, t = int8_flats(clustered(rng, 256, 96, 4))
    for got in (t.prep_queries(torch.from_numpy(q)), tfq._prep_queries(torch.from_numpy(q), torch.int8),
                quantize_int8(torch.from_numpy(q))):
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.asarray(j.prep_queries(jnp.asarray(q))))


def test_int8_upsert_rows_equal_jax():
    """Rows after upsert, a re-upsert and a grow past the capacity."""
    rng = np.random.default_rng(1)
    vecs = clustered(rng, 300, 64, 6)
    j, t = int8_flats(vecs, capacity=256)
    assert t.quantized and t.capacity == j.capacity == 512
    again = clustered(rng, 3, 64, 3)
    ids, texts, payloads = chunks(3, start=10)
    j.upsert(ids, again, texts, payloads)
    t.upsert(ids, again, texts, payloads)
    emb = t._emb
    assert emb.dtype == torch.int8
    np.testing.assert_array_equal(emb.numpy(), np.asarray(j._emb))
    np.testing.assert_array_equal(emb[:300].numpy(), quant(
        np.concatenate([vecs[:10], again, vecs[13:]]) / np.linalg.norm(
            np.concatenate([vecs[:10], again, vecs[13:]]), axis=1, keepdims=True)))
    np.testing.assert_array_equal(t._codes.numpy(), np.asarray(j._codes))
    search_both(j, t, vecs[:8] + 0.05)


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_int8_index_loads_in_the_other_package(tmp_path, saved_by):
    rng = np.random.default_rng(2)
    vecs = clustered(rng, 500, 64, 8)
    j, t = int8_flats(vecs)
    (j if saved_by == "jax" else t).save(str(tmp_path))
    meta = np.load(str(tmp_path / "flat_index.npz"))["meta"]
    assert int(meta[4]) == 1
    j2 = JFlat.load(str(tmp_path), use_pallas=False)
    t2 = TFlat.load(str(tmp_path), device="cpu")
    assert j2.quantized and t2.quantized and t2.dtype == torch.int8
    np.testing.assert_array_equal(t2._emb.numpy(), np.asarray(j2._emb))
    np.testing.assert_array_equal(t2._emb.numpy(), t._emb.numpy())
    search_both(j2, t2, vecs[:8] + 0.05)


# -- the IVF tier ---------------------------------------------------------------------


@pytest.mark.parametrize("int8_mxu", [True, False])
@pytest.mark.parametrize("kind", ["index", "wildcard", "ticker_dt", "sparse", "dups"])
def test_int8_ivf_probe_plain_matches_pallas_and_xla(kind, int8_mxu):
    """Kernel 3's plain version on int8 queries and packing against the
    Pallas kernel's int8 branch (both of its variants) in interpret mode
    and ``ivf_probe_xla``: scores bit for bit, ids wherever finite."""
    rng = np.random.default_rng(3)
    q, qf, emb, codes, gids, tile_ids = packed_case(kind, rng)
    q, emb = quant(q), quant(emb)
    k = 5 if kind == "index" else 15
    jargs = (jnp.asarray(q), jnp.asarray(qf), jnp.asarray(emb), jnp.asarray(codes),
             jnp.asarray(gids), jnp.asarray(tile_ids), k)
    s_x, i_x = (np.asarray(a) for a in jivf.ivf_probe_xla(*jargs, tile=128))
    s_p, i_p = (np.asarray(a) for a in jivf.ivf_probe_pallas(
        *jargs, tile=128, probe_budget=len(tile_ids), interpret=True, int8_mxu=int8_mxu))
    s_t, i_t = (a.numpy() for a in tivf.ivf_probe(
        *(torch.from_numpy(a) for a in (q, qf, emb, codes, gids, tile_ids)), k, tile=128))
    fin = np.isfinite(s_x)
    np.testing.assert_array_equal(s_t, s_x)
    np.testing.assert_array_equal(s_t[fin], s_p[fin])
    np.testing.assert_array_equal(np.isfinite(s_p), fin)
    np.testing.assert_array_equal(i_t[fin], i_x[fin])
    np.testing.assert_array_equal(i_t[fin], i_p[fin])
    assert (i_t[~fin] == -1).all()
    if kind in ("wildcard", "dups"):
        # the duplicated row ties: lower packed position first, not lower gid
        assert list(i_t[0, :2]) == [5000, 17] and s_t[0, 0] == s_t[0, 1]


def test_int8_ivf_build_matches_jax():
    """k-center init and Lloyd over the int8 rows' integer values, the
    int8 packing and bf16 centroids, and an online upsert placed by the
    rows' values over 127, all as in JAX."""
    rng = np.random.default_rng(5)
    vecs = clustered(rng, 1024, 64, 16, noise=0.05)
    j, t = int8_flats(vecs, capacity=2048)
    jidx, tidx = jivf.IVFIndex(j, tile=128), tivf.IVFIndex(t, tile=128)
    assert tidx.packed_emb.dtype == torch.int8 and tidx.centroids.dtype == torch.bfloat16
    assert jidx.centroids.dtype == jnp.bfloat16
    assert_same_state(jidx, tidx)
    np.testing.assert_allclose(tidx.centroids.float().numpy(),
                               np.asarray(jidx.centroids, np.float32), atol=1e-2)
    new = clustered(rng, 3, 64, 3)
    args = (["n0", "n1", "n2"], new, ["t0", "t1", "t2"],
            [{"ticker": "AMD", "document_type": "10-K"}] * 3)
    jidx.upsert(*args)
    tidx.upsert(*args)
    assert tidx._tail_rows == [] and len(tidx._state.assign) == 1027
    assert_same_state(jidx, tidx)
    assert tidx.search(new[0], ticker="AMD", k=3)[0][0]["text"] == "t0"
    q = vecs[:8] + 0.02 * rng.standard_normal((8, 64)).astype(np.float32)
    search_both(jidx, tidx, q)


def test_int8_load_of_a_jax_saved_ivf_index(tmp_path):
    rng = np.random.default_rng(11)
    vecs = clustered(rng, 1000, 64, 10)
    j, _ = int8_flats(vecs)
    jivf.IVFIndex(j, nprobe=8, tile=128).save(str(tmp_path))
    jidx = jivf.IVFIndex.load(str(tmp_path), JFlat.load(str(tmp_path), use_pallas=False))
    tidx = tivf.IVFIndex.load(str(tmp_path), TFlat.load(str(tmp_path), device="cpu"))
    assert tidx.flat.quantized and tidx.packed_emb.dtype == torch.int8
    assert_same_state(jidx, tidx)
    np.testing.assert_array_equal(tidx.centroids.float().numpy(),
                                  np.asarray(jidx.centroids, np.float32))
    search_both(jidx, tidx, vecs[:8] + 0.01)


# -- the fused pipelines ----------------------------------------------------------------


def test_int8_fused_two_stage_matches_jax(case):  # noqa: F811
    """The flat pipeline over an int8 corpus: the planted rows in both
    packages, bi scores as integers within 2e-3 * 127^2 (the bf16 test's
    bound on the cosine scale: the two embedders' vectors differ in the
    last f32 digits, which moves a quantized component by one step now
    and then), rerank logits within the bf16 test's 3e-2."""
    corpus = torch.from_numpy(quant(case["corpus"].float().numpy()))
    e_params, e_jcfg = case["e"][:2]
    r_params, r_jcfg = case["r"][:2]
    rows_j, bi_j, ce_j = (np.asarray(x) for x in jfq.fused_two_stage(
        e_params, r_params, *(jnp.asarray(a) for a in case["q"]), jnp.asarray(case["qf"]),
        jnp.asarray(corpus.numpy()), jnp.asarray(case["codes"]), jnp.asarray(case["dtok"]),
        jnp.int32(N - 100), embed_cfg=e_jcfg, rerank_cfg=r_jcfg, k=K, tile=1024,
        use_pallas=False, quantized=True))
    args = list(port_args(case))
    args[6] = corpus
    rows_t, bi_t, ce_t = (x.numpy() for x in tfq.make_fused_query(
        case["r"][3], k=K)(*args))
    np.testing.assert_array_equal(rows_t, case["planted"])
    np.testing.assert_array_equal(rows_t, rows_j)
    assert (bi_t == np.round(bi_t)).all()
    np.testing.assert_allclose(bi_t, bi_j, atol=2e-3 * 127**2, rtol=0)
    np.testing.assert_allclose(ce_t, ce_j, atol=3e-2, rtol=0)


def test_int8_fused_ivf_two_stage_matches_jax():
    """The IVF pipeline over an int8 packing with bf16 centroids: the same
    rows as JAX and the planted answer; scores as in the flat test."""
    b, n, dlen, lq = 4, 2048, 24, 32
    rng = np.random.default_rng(0)
    e_params, e_jcfg, e_model, _ = models(0)
    r_params, r_jcfg, r_model, r_tcfg = models(1, num_labels=1)
    lens = np.array([9, 20, 5, 32])
    q_ids = rng.integers(500, 1000, (b, lq)).astype(np.int32)
    q_mask = (np.arange(lq)[None, :] < lens[:, None]).astype(np.int32)
    q_ids[:, 0] = 101
    q_ids[np.arange(b), lens - 1] = 102
    q_ids *= q_mask
    q_types = np.zeros_like(q_ids)
    h = np.asarray(jbert.encode(e_params, q_ids, q_types, q_mask, e_jcfg))
    qv = h[:, 0] / np.linalg.norm(h[:, 0], axis=1, keepdims=True)
    c = clustered(rng, n, 64, 16)
    planted = rng.permutation(n)[: b * K].reshape(b, K)
    for i in range(b):
        for jj, row in enumerate(planted[i]):
            cos = 0.9 - 0.02 * jj
            noise = rng.standard_normal(64).astype(np.float32)
            noise -= (noise @ qv[i]) * qv[i]
            c[row] = cos * qv[i] + np.sqrt(1 - cos**2) * noise / np.linalg.norm(noise)
    jflat = JFlat(dim=64, capacity=n, tile=128, use_pallas=False, dtype=jnp.int8)
    ids, texts, payloads = chunks(n)
    for i in range(b):
        for row in planted[i]:
            payloads[row] = {"ticker": f"Q{i}", "document_type": "10-K"}
    jflat.upsert(ids, c, texts, payloads)
    jidx = jivf.IVFIndex(jflat, tile=128)
    qf = np.asarray([jflat.store.query_codes(f"Q{i}", None) for i in range(b)], np.int32)
    dl = rng.integers(3, dlen + 1, n)
    dtok = rng.integers(500, 1000, (n, dlen)).astype(np.int32)
    dtok[np.arange(n), dl - 1] = 102
    dtok *= np.arange(dlen)[None, :] < dl[:, None]
    geom = dict(k=K, tile=128, nprobe=jidx.nprobe, tiles_per_cluster=jidx.tiles_per_cluster)
    packing = (jidx.centroids, jidx.packed_emb, jidx.packed_codes, jidx.packed_gids)
    rows_j, bi_j, ce_j = (np.asarray(x) for x in jfq.fused_ivf_two_stage(
        e_params, r_params, q_ids, q_types, q_mask, jnp.asarray(qf), *packing,
        jnp.asarray(dtok), embed_cfg=e_jcfg, rerank_cfg=r_jcfg, use_pallas=False,
        quantized=True, **geom))
    out = tfq.make_fused_ivf_query(r_tcfg, **geom)(
        e_model, r_model, *(torch.from_numpy(a) for a in (q_ids, q_types, q_mask, qf)),
        torch.from_numpy(np.asarray(packing[0], np.float32)).bfloat16(),
        *(torch.from_numpy(np.asarray(a)) for a in packing[1:]), torch.from_numpy(dtok),
    )
    rows_t, bi_t, ce_t = (x.numpy() for x in out[:3])
    np.testing.assert_array_equal(rows_t, rows_j)
    np.testing.assert_array_equal(np.sort(rows_t, axis=1), np.sort(planted, axis=1))
    np.testing.assert_allclose(bi_t, bi_j, atol=2e-3 * 127**2, rtol=0)
    np.testing.assert_allclose(ce_t, ce_j, atol=3e-2, rtol=0)


# -- serving -----------------------------------------------------------------------------


def test_default_engine_serves_an_int8_index(tmp_path, monkeypatch):
    """``RAG_TPU_INDEX_DTYPE=int8``: an empty int8 index that fuses, the
    fused batch retrieving what the staged path retrieves; saved, it
    comes back int8 from its own ``meta[4]`` whatever the env says."""
    from test_torch_serving import chunks as serving_chunks
    from test_torch_serving import write_checkpoint

    write_checkpoint(tmp_path / "bge", 0)
    write_checkpoint(tmp_path / "rr", 1, num_labels=1)
    for name, value in (("RAG_TPU_BGE_DIR", tmp_path / "bge"),
                        ("RAG_TPU_RERANKER_DIR", tmp_path / "rr"),
                        ("INDEX_DIR", tmp_path / "index"), ("DATABASE_URL", ":memory:"),
                        ("TESTING", "true"), ("RAG_TPU_CB_PATH", tmp_path / "cb.json"),
                        ("RAG_TPU_BATCH_WINDOW_S", "0.01"), ("RAG_TPU_INDEX_DTYPE", "int8")):
        monkeypatch.setenv(name, str(value))
    reset_config()
    try:
        eng = build_default_engine(device="cpu")
        assert eng.index.quantized and eng.queue_status()["fused_kind"] == "full"
        asyncio.run(eng.ingest_chunks(*serving_chunks()))
        assert eng.index._emb.dtype == torch.int8
        queries, filters = ["margin", "buybacks"], [("AAPL", None), (None, "10-Q")]
        fused = eng._fused_batch(queries, filters)
        staged = eng._embed_retrieve_batch(queries, filters)
        for (_, f), (_, s) in zip(fused, staged):
            assert len(f) == 15 and all(np.isfinite(h["rerank_score"]) for h in f)
            assert [h["row"] for h in f] == [h["row"] for h in s]
            assert [h["score"] for h in f] == [h["score"] for h in s]

        async def ask():
            await eng.startup()
            try:
                return await eng.ask("margin trend", "MSFT", top_k=2)
            finally:
                await eng.shutdown()

        resp = asyncio.run(ask())
        assert len(resp["sources"]) == 2 and not resp["cached"]
        eng.index.save(str(tmp_path / "index"))
        monkeypatch.setenv("RAG_TPU_INDEX_DTYPE", "bfloat16")
        reset_config()
        eng2 = build_default_engine(device="cpu")
        assert eng2.index.quantized and torch.equal(eng2.index._emb, eng.index._emb)
        a = eng._fused_batch(["revenue"], [("AAPL", None)])[0][1]
        assert [h["row"] for h in a] == [
            h["row"] for h in eng2._fused_batch(["revenue"], [("AAPL", None)])[0][1]]
        monkeypatch.setenv("RAG_TPU_INDEX_DTYPE", "float16")
        reset_config()
        with pytest.raises(ValueError, match="bfloat16 or int8"):
            build_default_engine(device="cpu")
    finally:
        reset_config()
