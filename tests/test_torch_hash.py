"""The hermetic hash stack: the port against the JAX package, on the CPU.

``HashEmbedder`` / ``HashReranker``, the fused hash programs on the flat
and IVF tiers, and the engine's hash branches (TESTING mode with the
identity reranker, and the de-aliased hash rerank).  Both packages draw
the same tables (``tests/test_torch_prng.py`` holds them bit for bit), so
the same texts give the same vectors: within 1e-6, the f32 sums taken in
another order.  The JAX references are its XLA paths, the plain twins of
its Pallas kernels.
"""

from __future__ import annotations

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from financial_rag_system_tpu.index.flat import FlatIndex as JFlat
from financial_rag_system_tpu.index.ivf import IVFIndex as JIVF
from financial_rag_system_tpu.models.embedder import HashEmbedder as JHashEmbedder
from financial_rag_system_tpu.models.reranker import HashReranker as JHashReranker
from financial_rag_system_tpu.models.tokenizer import pad_batch as jpad
from financial_rag_system_tpu.ops import fused_query as jfq
from financial_rag_system_tpu.serving.engine import RAGEngine as JEngine
from financial_rag_system_tpu.utils.config import Config as JConfig
from financial_rag_system_tpu_torch.index.flat import FlatIndex as TFlat
from financial_rag_system_tpu_torch.models.embedder import HashEmbedder as THashEmbedder
from financial_rag_system_tpu_torch.models.reranker import HashReranker as THashReranker
from financial_rag_system_tpu_torch.ops import fused_query as tfq
from financial_rag_system_tpu_torch.serving.engine import RAGEngine as TEngine
from financial_rag_system_tpu_torch.utils.config import Config as TConfig

WORDS = ("revenue margin cloud growth buyback dividend supply chain risk azure iphone "
         "services guidance capex inventory litigation tariff currency debt cash flow "
         "segment operating income gross net quarter fiscal outlook demand pricing").split()
TICKERS = ("AAPL", "MSFT", "NVDA")
DOC_TYPES = ("10-K", "10-Q")
QUERIES = ["what was revenue growth in cloud", "dividend and buyback plans",
           "supply chain risk from tariffs", "gross margin outlook for the quarter",
           "litigation and currency risk", "capex guidance", "azure demand", "debt"]
DLEN = 64


def corpus(n, seed=0):
    rng = np.random.default_rng(seed)
    texts = [" ".join(rng.choice(WORDS, rng.integers(6, 40))) + f" note {i}"
             for i in range(n)]
    payloads = [{"ticker": TICKERS[i % 3], "document_type": DOC_TYPES[(i // 3) % 2],
                 "source_file": f"f{i}"} for i in range(n)]
    return [f"c{i}" for i in range(n)], texts, payloads


@pytest.fixture(scope="module")
def models():
    """(JAX embedder, JAX reranker, port embedder, port reranker), port on the CPU."""
    return JHashEmbedder(), JHashReranker(), THashEmbedder(device="cpu"), \
        THashReranker(device="cpu")


def test_hash_embedder_matches_jax(models):
    jemb, _, temb, _ = models
    texts = QUERIES + corpus(70)[1] + ["", "a the of"]
    got, want = temb.encode(texts), jemb.encode(texts)
    assert got.shape == want.shape == (len(texts), 384) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert torch.equal(temb.table, torch.from_numpy(np.asarray(jemb._table)))
    assert temb.encode([]).shape == (0, 384)


@pytest.mark.parametrize("identity", [False, True])
def test_hash_reranker_matches_jax(models, identity):
    _, jrr, _, trr = models
    texts = corpus(20, seed=1)[1]
    tr = THashReranker(identity=identity, device="cpu") if identity else trr
    jr = JHashReranker(identity=True) if identity else jrr
    got, want = tr.score(QUERIES[0], texts), jr.score(QUERIES[0], texts)
    assert got.dtype == np.float32 and got.shape == (20,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert tr.score(QUERIES[0], []).shape == (0,)
    assert torch.equal(trr.table, torch.from_numpy(np.asarray(jrr.table)))


def flats(models, n, dtype, seed=0):
    """The same chunks, embedded by the JAX hash embedder, in a JAX and a
    port FlatIndex with a token store of DLEN."""
    jemb, _, temb, _ = models
    ids, texts, payloads = corpus(n, seed)
    vecs = jemb.encode(texts)
    j = JFlat(384, capacity=n, tile=128, use_pallas=False, token_store_len=DLEN,
              tokenizer=jemb.tokenizer, dtype=jnp.int8 if dtype == torch.int8 else jnp.bfloat16)
    t = TFlat(384, capacity=n, tile=128, token_store_len=DLEN, tokenizer=temb.tokenizer,
              dtype=dtype, device="cpu")
    j.upsert(ids, vecs, texts, payloads)
    t.upsert(ids, vecs, texts, payloads)
    return j, t


def query_batch(index, tok):
    ids, _, mask = jpad([tok.encode(q, 64) for q in QUERIES])
    filters = [(None, None), ("AAPL", None), ("MSFT", "10-K"), (None, "10-Q"),
               ("NVDA", None), (None, None), ("MSFT", None), ("AAPL", "10-Q")]
    qf = np.asarray([index.store.query_codes(t, d) for t, d in filters], np.int32)
    return ids, mask, qf


def assert_same_hits(got, want, atol=1e-6):
    """(scores, rows, [ce]) of both packages: finite where the other is,
    ids identical where finite, scores within atol."""
    s, i = (np.asarray(x) for x in got[:2])
    s_ref, i_ref = (np.asarray(x) for x in want[:2])
    fin = np.isfinite(s_ref)
    np.testing.assert_array_equal(np.isfinite(s), fin)
    np.testing.assert_array_equal(i[fin], i_ref[fin])
    np.testing.assert_allclose(s[fin], s_ref[fin], atol=atol, rtol=0)
    assert fin.sum() > fin.size // 2 and (i[~fin] == -1).all()
    if len(got) > 2:
        np.testing.assert_allclose(np.asarray(got[2])[fin], np.asarray(want[2])[fin],
                                   atol=atol, rtol=0)
        assert np.isneginf(np.asarray(got[2])[~fin]).all()


@pytest.mark.parametrize("rerank", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_fused_hash_programs_match_jax(models, dtype, rerank):
    """fused_hash_query and fused_hash_rerank_query on bf16 and int8
    corpora: the same rows, bi scores and hash-rerank scores."""
    jemb, jrr, temb, trr = models
    j, t = flats(models, 600, dtype)
    ids, mask, qf = query_batch(t, temb.tokenizer)
    (jx, jc, jd), (tx, tc, td) = j._arrays, t._arrays
    tq = (torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(qf))
    quant = dtype == torch.int8
    if rerank:
        _, bi, rows, ce = jfq.fused_hash_rerank_query(
            jemb._table, jrr.table, ids, mask, qf, jx, jc, jd, j.n_valid, k=15,
            tile=128, use_pallas=False, quantized=quant)
        qv, tbi, trows, tce = tfq.fused_hash_rerank_query(
            temb.table, trr.table, *tq, tx, tc, td, t.n_valid, k=15)
        assert_same_hits((tbi, trows, tce), (bi, rows, ce))
    else:
        _, bi, rows = jfq.fused_hash_query(jemb._table, ids, mask, qf, jx, jc, j.n_valid,
                                           k=15, tile=128, use_pallas=False, quantized=quant)
        qv, tbi, trows = tfq.fused_hash_query(temb.table, *tq, tx, tc, t.n_valid, k=15)
        assert_same_hits((tbi, trows), (bi, rows))
    np.testing.assert_allclose(qv.numpy()[: len(QUERIES)], jemb.encode(QUERIES), atol=1e-6)


@pytest.mark.parametrize("rerank", [False, True])
def test_fused_ivf_hash_programs_match_jax(models, rerank):
    """fused_ivf_hash_query and fused_ivf_hash_rerank_query over one JAX
    IVF packing handed to both: the same probe, rows and scores."""
    jemb, jrr, temb, trr = models
    j, t = flats(models, 1500, torch.bfloat16, seed=3)
    ivf = JIVF(j, n_clusters=8, nprobe=3, tile=128)
    ids, mask, qf = query_batch(t, temb.tokenizer)
    packing = (ivf.centroids, ivf.packed_emb, ivf.packed_codes, ivf.packed_gids)
    geom = dict(k=15, tile=128, nprobe=3, tiles_per_cluster=ivf.tiles_per_cluster)
    tpack = tuple(torch.from_numpy(np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                                              else a)) for a in packing)
    tpack = (tpack[0].bfloat16(), tpack[1].bfloat16(), *tpack[2:])
    tq = (torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(qf))
    if rerank:
        _, bi, rows, ce = jfq.fused_ivf_hash_rerank_query(
            jemb._table, jrr.table, ids, mask, qf, *packing, j._arrays[2],
            use_pallas=False, **geom)
        _, tbi, trows, tce, active = tfq.fused_ivf_hash_rerank_query(
            temb.table, trr.table, *tq, *tpack, t._arrays[2], **geom)
        assert_same_hits((tbi, trows, tce), (bi, rows, ce))
    else:
        _, bi, rows = jfq.fused_ivf_hash_query(jemb._table, ids, mask, qf, *packing,
                                               use_pallas=False, **geom)
        _, tbi, trows, active = tfq.fused_ivf_hash_query(temb.table, *tq, *tpack, **geom)
        assert_same_hits((tbi, trows), (bi, rows))
    assert 0 < int(active) <= 8 * ivf.tiles_per_cluster


def engines(models, tmp_path, identity):
    """A JAX and a port engine over the same 300 chunks, TESTING config
    (mock LLM, in-memory cache), hash stack with a token store."""
    jemb, _, temb, _ = models
    j, t = flats(models, 300, torch.bfloat16, seed=5)
    kw = dict(testing=True, database_url=":memory:", batch_window_s=0.01,
              breaker_state_path=str(tmp_path / "cb.json"))
    jeng = JEngine(JConfig(**kw), j, jemb, JHashReranker(identity=identity))
    teng = TEngine(TConfig(**kw), t, temb, THashReranker(identity=identity, device="cpu"))
    return jeng, teng


def ask_both(jeng, teng, asks):
    """Each engine's answers to ``asks`` (query, ticker, document type),
    in one event loop an engine."""
    async def run(eng):
        await eng.startup()
        try:
            return [await asyncio.wait_for(eng.ask(q, t, top_k=5, document_type=d), 60)
                    for q, t, d in asks]
        finally:
            await eng.shutdown()

    return zip(asyncio.run(run(jeng)), asyncio.run(run(teng)))


@pytest.mark.parametrize("identity", [True, False])
def test_engine_hash_asks_match_jax(models, tmp_path, identity):
    """TESTING mode's identity reranker (sources in retrieval order) and
    the de-aliased hash rerank: both engines fuse the batch ("hash", and
    the rerank on the device with a token store) and answer with the same
    sources in the same order."""
    jeng, teng = engines(models, tmp_path, identity)
    st = teng.queue_status()
    assert st["fused_kind"] == jeng._fused_kind == "hash"
    assert st["fused_hash_rerank"] is jeng._fused_hash_rerank is (not identity)
    asks = [("revenue growth in cloud", "AAPL", None),
            ("dividend and buyback plans", "MSFT", "10-K")]
    for want, got in ask_both(jeng, teng, asks):
        assert [s["text"] for s in got["sources"]] == [s["text"] for s in want["sources"]]
        assert len(got["sources"]) == 5 and got["answer"] == want["answer"]
        np.testing.assert_allclose([s["score"] for s in got["sources"]],
                                   [s["score"] for s in want["sources"]], atol=1e-5)
        scores = [s["score"] for s in got["sources"]]
        assert scores == sorted(scores, reverse=True)


def test_engine_without_a_token_store_reranks_staged(models, tmp_path):
    """A hash stack over an index with no token store fuses retrieval only;
    the staged HashReranker.score reranks the hits, as in the JAX package."""
    jemb, _, temb, _ = models
    ids, texts, payloads = corpus(200, seed=6)
    vecs = jemb.encode(texts)
    j = JFlat(384, capacity=200, tile=128, use_pallas=False)
    t = TFlat(384, capacity=200, tile=128, device="cpu")
    j.upsert(ids, vecs, texts, payloads)
    t.upsert(ids, vecs, texts, payloads)
    kw = dict(testing=True, database_url=":memory:", batch_window_s=0.01,
              breaker_state_path=str(tmp_path / "cb.json"))
    jeng = JEngine(JConfig(**kw), j, jemb, JHashReranker())
    teng = TEngine(TConfig(**kw), t, temb, THashReranker(device="cpu"))
    assert teng.queue_status()["fused_kind"] == "hash"
    assert teng.queue_status()["fused_hash_rerank"] is False
    out = teng._fused_batch(["cloud revenue"], [("AAPL", None)])
    assert out is not None and all("rerank_score" not in h for h in out[0][1])
    [(want, got)] = ask_both(jeng, teng, [("cloud revenue growth", "AAPL", None)])
    assert [s["text"] for s in got["sources"]] == [s["text"] for s in want["sources"]]
    np.testing.assert_allclose([s["score"] for s in got["sources"]],
                               [s["score"] for s in want["sources"]], atol=1e-5)
