"""The port's sharded fused programs against the JAX package's, on the CPU,
and the engine's sharded fused path against its staged path.

The JAX programs run under ``shard_map`` on the conftest's virtual CPU
devices (``create_mesh(devices=jax.devices()[:S])``), the port's on a
mesh that names the CPU S times, at S = 2, 4 and 8, with the same
weights (JAX ``init_params`` through ``load_jax_params``) and the same
seeded inputs.  Rows must be identical and int8 scores bit for bit; bf16
bi scores within ``BI_ATOL`` and cross-encoder logits within
``CE_ATOL``, the tolerances of ``tests/test_torch_fused_query.py``.  The
engine half ports ``tests/test_sharded_fused.py`` (bf16, int8, the hash
stack, TESTING mode, IVF, HNSW, the geometry guard, the tail fall-back).
"""

from __future__ import annotations

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from financial_rag_system_tpu.index.sharded import ShardedFlatIndex as JSharded
from financial_rag_system_tpu.index.sharded_hnsw import ShardedHNSWIndex as JHNSW
from financial_rag_system_tpu.index.sharded_ivf import ShardedIVFIndex as JIVF
from financial_rag_system_tpu.models import bert as jbert
from financial_rag_system_tpu.ops import fused_query as jfq
from financial_rag_system_tpu.parallel import mesh as jmesh
from financial_rag_system_tpu_torch.index.sharded import ShardedFlatIndex, block
from financial_rag_system_tpu_torch.index.sharded_hnsw import ShardedHNSWIndex
from financial_rag_system_tpu_torch.index.sharded_ivf import ShardedIVFIndex
from financial_rag_system_tpu_torch.models import bert as tbert
from financial_rag_system_tpu_torch.ops import fused_query as tfq
from financial_rag_system_tpu_torch.parallel.mesh import create_mesh

SHARDS = (2, 4, 8)
BI_ATOL = 2e-3   # bf16 products summed in f32 in another order
CE_ATOL = 3e-2   # the cross-encoder's f32 arithmetic in another order
TINY = dict(vocab_size=2048, hidden=32, layers=1, heads=2, intermediate=64, with_pooler=True)
K, B, LQ, DLEN, D = 7, 4, 16, 32, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Shapes this small gain nothing from intra-op threads, and the
    suite's parallel workers share the cores: one torch thread here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def models(seed, **extra):
    """The same random weights as a JAX param tree and a port model."""
    jcfg = jbert.BertConfig(**TINY, **extra)
    tcfg = tbert.BertConfig(**TINY, **extra)
    params = jbert.init_params(jax.random.PRNGKey(seed), jcfg)
    model = tbert.BertModel(tcfg, device="cpu")
    tbert.load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    return params, jcfg, model, tcfg


@pytest.fixture(scope="module")
def stack():
    return models(0, max_positions=64), models(1, max_positions=128, num_labels=1)


def meshes(s):
    return jmesh.create_mesh(devices=jax.devices()[:s]), create_mesh(devices=["cpu"] * s)


def shards(tm, full, per_shard, dtype, fill=0, dim=0):
    """The port mesh's blocks of a global array."""
    return tuple(block(full, g * per_shard, per_shard, fill=fill, dtype=dtype,
                       device=torch.device("cpu"), dim=dim) for g in range(len(tm.devices)))


def query_batch(rng, n_tickers=3):
    q_ids = rng.integers(103, 2000, (B, LQ)).astype(np.int32)
    q_ids[:, 0] = 101
    qf = np.stack([rng.integers(0, n_tickers, B), np.full(B, -1)], axis=1).astype(np.int32)
    qf[-1] = (-1, -1)
    return q_ids, np.zeros_like(q_ids), np.ones_like(q_ids), qf


def corpus(rng, n, quantized=False):
    emb = rng.standard_normal((n, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    if quantized:
        emb = np.clip(np.rint(emb * 127.0), -127, 127)
    codes = np.stack([rng.integers(0, 3, n), rng.integers(0, 2, n)]).astype(np.int32)
    dtok = rng.integers(103, 2000, (n, DLEN)).astype(np.int32)
    return emb, codes, dtok


def t_(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def assert_same(got, want, *, exact_bi=False, ce=True):
    """(rows, bi[, ce]) of the port and of JAX."""
    rows, bi = (np.asarray(x) for x in got[:2])
    rows_j, bi_j = (np.asarray(x) for x in want[:2])
    fin = np.isfinite(bi_j)
    np.testing.assert_array_equal(np.isfinite(bi), fin)
    np.testing.assert_array_equal(rows[fin], rows_j[fin])
    assert (rows[~fin] == -1).all()
    if exact_bi:
        assert bi.tobytes() == bi_j.astype(np.float32).tobytes()
    else:
        np.testing.assert_allclose(bi[fin], bi_j[fin], atol=BI_ATOL, rtol=0)
    if ce:
        ce_t, ce_j = np.asarray(got[2]), np.asarray(want[2])
        np.testing.assert_array_equal(np.isfinite(ce_t), np.isfinite(ce_j))
        np.testing.assert_allclose(ce_t[fin], ce_j[fin], atol=CE_ATOL, rtol=0)


# -- the balanced rerank -------------------------------------------------------------


@pytest.mark.parametrize("s", SHARDS)
def test_balanced_rerank_skewed_matches_jax(s, stack):
    """Every merged candidate on ONE shard (the worst skew for the psum
    token fetch), an empty slot per query and B*k (15) not a multiple of
    S: against JAX's program, and against the port's unsharded rerank."""
    _, ((rp, rcfg_j, r_model, rcfg_t)) = stack
    b, k, per_shard = 3, 5, 16
    n = s * per_shard
    rng = np.random.default_rng(3)
    q_ids = rng.integers(103, 2000, (b, LQ)).astype(np.int32)
    dtok = rng.integers(103, 2000, (n, DLEN)).astype(np.int32)
    rows = rng.integers(0, per_shard, (b, k)).astype(np.int32)
    rows[:, -1] = -1
    bi = rng.standard_normal((b, k)).astype(np.float32)
    bi[:, -1] = -np.inf
    jm, tm = meshes(s)
    from financial_rag_system_tpu.parallel.mesh import AXIS_CORPUS

    def local(q_ids, g_rows, top_bi, dtok_shard):
        sid = jax.lax.axis_index(AXIS_CORPUS)
        local_rows = jnp.where(g_rows >= 0, g_rows - sid * per_shard, -1)
        return jfq._sharded_balanced_rerank(
            rp, q_ids, g_rows, top_bi, local_rows, dtok_shard,
            axis=AXIS_CORPUS, n_shards=s, rerank_cfg=rcfg_j)

    want = np.asarray(jax.jit(jax.shard_map(
        local, mesh=jm, in_specs=(P(), P(), P(), P(AXIS_CORPUS, None)), out_specs=P(),
        check_vma=False))(q_ids, rows, bi, dtok))
    with torch.inference_mode():
        got = tfq._sharded_balanced_rerank(
            tm, r_model, *t_(q_ids, rows, bi), shards(tm, dtok, per_shard, torch.int32),
            rows_per_shard=per_shard, rerank_cfg=rcfg_t).numpy()
        single = tfq._cross_rerank(r_model, *t_(q_ids, rows, bi, dtok),
                                   rerank_cfg=rcfg_t).numpy()
    assert np.isneginf(got[:, -1]).all()
    np.testing.assert_allclose(got[:, :-1], want[:, :-1], atol=CE_ATOL, rtol=0)
    np.testing.assert_allclose(got[:, :-1], single[:, :-1], atol=2e-4, rtol=0)


# -- the four sharded programs --------------------------------------------------------


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("s", SHARDS)
def test_sharded_fused_query_matches_jax(s, quantized, stack):
    (ep, ecfg_j, e_model, _), (rp, rcfg_j, r_model, rcfg_t) = stack
    rng = np.random.default_rng(s)
    n = 1024
    emb, codes, dtok = corpus(rng, n, quantized)
    q_ids, q_types, q_mask, qf = query_batch(rng)
    n_valid = n - 37
    jm, tm = meshes(s)
    want = jfq.make_sharded_fused_query(
        jm, ecfg_j, rcfg_j, k=K, tile=64, use_pallas=False, quantized=quantized)(
        ep, rp, q_ids, q_types, q_mask, qf,
        jnp.asarray(emb, jnp.int8 if quantized else jnp.bfloat16), codes, dtok,
        jnp.int32(n_valid))
    p = n // s
    dt = torch.int8 if quantized else torch.bfloat16
    got = tfq.make_sharded_fused_query(tm, rcfg_t, k=K)(
        e_model, r_model, *t_(q_ids, q_types, q_mask, qf), shards(tm, emb, p, dt),
        shards(tm, codes, p, torch.int32, -2, dim=1), shards(tm, dtok, p, torch.int32), n_valid)
    assert_same(got, want, exact_bi=quantized)
    # the port's unsharded program gives the same rows
    single = tfq.fused_two_stage(e_model, r_model, *t_(q_ids, q_types, q_mask, qf),
                                 torch.from_numpy(emb).to(dt), *t_(codes, dtok), n_valid,
                                 rerank_cfg=rcfg_t, k=K)
    np.testing.assert_array_equal(got[0].numpy(), single[0].numpy())


@pytest.mark.parametrize("rerank", [False, True], ids=["identity", "rerank"])
@pytest.mark.parametrize("s", SHARDS)
def test_sharded_fused_hash_query_matches_jax(s, rerank):
    rng = np.random.default_rng(10 + s)
    n = 512
    emb, codes, dtok = corpus(rng, n)
    table = rng.standard_normal((2048, D)).astype(np.float32)
    r_table = rng.standard_normal((2048, D)).astype(np.float32)
    q_ids, _q_types, q_mask, qf = query_batch(rng)
    n_valid = n - 5
    jm, tm = meshes(s)
    qv_j, rows_j, bi_j, ce_j = jfq.make_sharded_fused_hash_query(
        jm, k=K, tile=64, use_pallas=False, rerank=rerank)(
        table, r_table, q_ids, q_mask, qf, jnp.asarray(emb, jnp.bfloat16), codes, dtok,
        jnp.int32(n_valid))
    p = n // s
    corpus_t = [shards(tm, emb, p, torch.bfloat16),
                shards(tm, codes, p, torch.int32, -2, dim=1)]
    fn = tfq.make_sharded_fused_hash_query(tm, k=K, rerank=rerank)
    if rerank:
        qv, bi, rows, ce = fn(*t_(table, r_table, q_ids, q_mask, qf), *corpus_t,
                              shards(tm, dtok, p, torch.int32), n_valid)
    else:
        qv, bi, rows = fn(*t_(table, q_ids, q_mask, qf), *corpus_t, n_valid)
        ce = bi
    np.testing.assert_allclose(qv.numpy(), np.asarray(qv_j), atol=1e-5, rtol=0)
    assert_same((rows, bi, ce), (rows_j, bi_j, ce_j))


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_fused_ivf_query_matches_jax(s, stack):
    """The probe list from the replicated codebook, kernel 3's plain
    version on every shard's packing, the merge and the balanced rerank
    over JAX's and the port's ShardedIVFIndex of the same rows."""
    (ep, ecfg_j, e_model, _), (rp, rcfg_j, r_model, rcfg_t) = stack
    rng = np.random.default_rng(20 + s)
    n = 1024
    emb, codes, dtok = corpus(rng, n)
    jm, tm = meshes(s)
    jf = JSharded(jm, dim=D, capacity=n, tile=64)
    tf = ShardedFlatIndex(tm, D, capacity=n, tile=64)
    ids = [f"p{i}" for i in range(n)]
    pays = [{"ticker": f"T{c}", "document_type": "10-K"} for c in codes[0]]
    for idx in (jf, tf):
        idx.upsert(ids, emb, ["t"] * n, pays)
    jx, tx = JIVF(jf, n_clusters=16, nprobe=4, tile=64), ShardedIVFIndex(tf, n_clusters=16,
                                                                        nprobe=4, tile=64)
    q_ids, q_types, q_mask, _ = query_batch(rng)
    qf = np.asarray([tf.store.query_codes(t, None) for t in ("T0", "T1", "T2", None)],
                    np.int32)
    geom = dict(k=K, tile=64, nprobe=4, tiles_per_cluster=tx.tiles_per_cluster,
                rows_per_shard=tf.per_shard)
    want = jfq.make_sharded_fused_ivf_query(jm, ecfg_j, rcfg_j, use_pallas=False, **geom)(
        ep, rp, q_ids, q_types, q_mask, qf, jx.centroids, jx.packed_emb, jx.packed_codes,
        jx.packed_gids, dtok)
    got = tfq.make_sharded_fused_ivf_query(tm, rcfg_t, **geom)(
        e_model, r_model, *t_(q_ids, q_types, q_mask, qf), tx.centroids, tx.packed_emb,
        tx.packed_codes, tx.packed_gids, shards(tm, dtok, tf.per_shard, torch.int32))
    assert_same(got[:3], want)
    assert 0 < int(got[3]) <= tx.num_tiles_local


@pytest.mark.parametrize("take", [True, False], ids=["pool", "entries"])
@pytest.mark.parametrize("s", SHARDS)
def test_sharded_fused_hnsw_query_matches_jax(s, take, stack):
    """Each shard's walk over its graph (the same graphs: under 2,048 rows
    a shard both native builders insert on one thread), the merge and the
    balanced rerank."""
    (ep, ecfg_j, e_model, _), (rp, rcfg_j, r_model, rcfg_t) = stack
    rng = np.random.default_rng(30 + s)
    n = 1024
    emb, codes, dtok = corpus(rng, n)
    jm, tm = meshes(s)
    jf = JSharded(jm, dim=D, capacity=n, tile=64)
    tf = ShardedFlatIndex(tm, D, capacity=n, tile=64)
    pays = [{"ticker": f"T{c}", "document_type": "10-K"} for c in codes[0]]
    for idx in (jf, tf):
        idx.upsert([f"p{i}" for i in range(n)], emb, ["t"] * n, pays)
    jx, tx = JHNSW(jf), ShardedHNSWIndex(tf)
    q_ids, q_types, q_mask, _ = query_batch(rng)
    qf = np.asarray([tf.store.query_codes(t, None) for t in ("T0", "T1", None, None)],
                    np.int32)
    js, ts = jx._graph_state, tx._graph_state
    pool_take = ts[7] if take else 0
    geom = dict(k=K, ef=max(tx.ef, tx.entries_cap + pool_take), steps=tx.steps,
                frontier=tx.frontier, per_shard=ts[2], pool_take=pool_take)
    j_args = [ep, rp, q_ids, q_types, q_mask, qf, jf._emb, jf._codes, js[0], js[1], dtok]
    want = jfq.make_sharded_fused_hnsw_query(jm, ecfg_j, rcfg_j, **geom)(
        *j_args, *([js[6]] if take else []))
    got = tfq.make_sharded_fused_hnsw_query(tm, rcfg_t, **geom)(
        e_model, r_model, *t_(q_ids, q_types, q_mask, qf), tf._emb, tf._codes, ts[0], ts[1],
        shards(tm, dtok, ts[2], torch.int32), ts[6] if take else None)
    assert_same(got, want)


# -- the engine: sharded fused against staged (JAX tests/test_sharded_fused.py) -------

DOCS = [
    ("Apple revenue grew 8 percent on iphone demand", "AAPL"),
    ("Apple services margin expanded again this quarter", "AAPL"),
    ("Microsoft cloud revenue grew 24 percent", "MSFT"),
    ("Microsoft operating income rose on azure", "MSFT"),
    ("Apple supply chain concentration remains a risk", "AAPL"),
    ("Nvidia data center revenue tripled", "NVDA"),
]
ENGINE_BERT = dict(vocab_size=30522, hidden=32, layers=1, heads=2, intermediate=64,
                   with_pooler=True)


def _config(tmp_path, **kw):
    from financial_rag_system_tpu_torch.utils.config import Config

    return Config(testing=True, database_url=":memory:", batch_window_s=0.01,
                  breaker_state_path=str(tmp_path / "cb.json"), **kw)


def sharded_engine(tmp_path, *, dtype=torch.bfloat16, shards_=8):
    """A full-stack engine over a ShardedFlatIndex of the six documents."""
    from financial_rag_system_tpu_torch.models.embedder import BiEncoder
    from financial_rag_system_tpu_torch.models.reranker import CrossEncoderReranker
    from financial_rag_system_tpu_torch.models.tokenizer import Tokenizer
    from financial_rag_system_tpu_torch.serving.engine import RAGEngine

    tok = Tokenizer()
    mods = []
    for seed, extra in ((0, dict(max_positions=64)), (1, dict(max_positions=160,
                                                               num_labels=1))):
        cfg = tbert.BertConfig(**ENGINE_BERT, **extra)
        model = tbert.BertModel(cfg, device="cpu")
        tbert.load_jax_params(model, tbert.init_params(torch.Generator().manual_seed(seed), cfg))
        mods.append((model, cfg))
    embedder = BiEncoder(*mods[0], tok, pooling="cls", max_len=64)
    reranker = CrossEncoderReranker(*mods[1], tok, max_len=160)
    index = ShardedFlatIndex(create_mesh(devices=["cpu"] * shards_), 32, capacity=512, tile=64,
                             token_store_len=96, tokenizer=tok, dtype=dtype)
    index.upsert([f"d{i}" for i in range(len(DOCS))], embedder.encode([d for d, _ in DOCS]),
                 [d for d, _ in DOCS],
                 [{"ticker": t, "document_type": "10-Q", "source_file": f"f{i}"}
                  for i, (_, t) in enumerate(DOCS)])
    return RAGEngine(_config(tmp_path, embed_dim=32), index, embedder, reranker,
                     mode="sequential")


def assert_fused_is_staged(eng, queries, filters, *, as_set=False):
    fused = eng._fused_batch(queries, filters)
    assert fused is not None
    staged = eng._embed_retrieve_batch(queries, filters)
    for (_fv, f_hits), (_sv, s_hits) in zip(fused, staged):
        f_rows, s_rows = [h["row"] for h in f_hits], [h["row"] for h in s_hits]
        assert (set(f_rows) == set(s_rows)) if as_set else (f_rows == s_rows)
        assert f_hits and all("rerank_score" in h for h in f_hits)
    return fused


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
def test_sharded_engine_fused_matches_staged(tmp_path, dtype):
    eng = sharded_engine(tmp_path, dtype=dtype)
    assert eng._fused_kind == "full" and eng.index.quantized == (dtype == torch.int8)
    fused = assert_fused_is_staged(eng, ["apple services margin", "microsoft cloud growth"],
                                   [("AAPL", None), ("MSFT", None)])
    assert all(h["ticker"] in ("AAPL", "MSFT") for _, hits in fused for h in hits)
    assert eng.queue_status()["index_tier"] == "ShardedFlatIndex"


def test_sharded_fused_via_ask_and_save_load(tmp_path):
    eng = sharded_engine(tmp_path)
    resp = asyncio.run(eng.ask("microsoft cloud growth", "MSFT"))
    assert resp["sources"] and all(s["document_type"] == "10-Q" for s in resp["sources"])
    eng.index.save(str(tmp_path / "idx"))
    from financial_rag_system_tpu_torch.models.tokenizer import Tokenizer

    loaded = ShardedFlatIndex.load(str(tmp_path / "idx"), create_mesh(devices=["cpu"] * 4),
                                   tokenizer=Tokenizer())
    assert loaded.token_store_len == eng.index.token_store_len == 96
    np.testing.assert_array_equal(loaded.gathered(2).numpy()[:6],
                                  eng.index.gathered(2).numpy()[:6])


def sharded_hash_engine(tmp_path, *, identity=False):
    from financial_rag_system_tpu_torch.models.embedder import HashEmbedder
    from financial_rag_system_tpu_torch.models.reranker import HashReranker
    from financial_rag_system_tpu_torch.serving.engine import RAGEngine

    emb = HashEmbedder(dim=64, device="cpu")
    index = ShardedFlatIndex(create_mesh(devices=["cpu"] * 8), 64, capacity=512, tile=64,
                             token_store_len=96, tokenizer=emb.tokenizer)
    docs = DOCS * 3
    index.upsert([f"d{i}" for i in range(len(docs))], emb.encode([d for d, _ in docs]),
                 [f"{d} clause {i}" for i, (d, _) in enumerate(docs)],
                 [{"ticker": t, "document_type": "10-Q", "source_file": f"f{i}"}
                  for i, (_, t) in enumerate(docs)])
    return RAGEngine(_config(tmp_path, embed_dim=64), index, emb,
                     HashReranker(identity=identity, device="cpu"), mode="sequential")


def test_sharded_hash_fused_matches_staged(tmp_path):
    """The hash stack fuses on a sharded mesh with the de-aliased rerank:
    rows and scores as the staged sharded scan, rerank scores as the host
    reranker; TESTING's identity reranker fuses without the rerank."""
    eng = sharded_hash_engine(tmp_path)
    assert eng._fused_kind == "hash" and eng._fused_hash_rerank
    queries = ["apple services margin", "microsoft cloud growth"]
    filters = [("AAPL", None), (None, None)]
    fused = eng._fused_batch(queries, filters)
    staged = eng._embed_retrieve_batch(queries, filters)
    for q, (_, f_hits), (_, s_hits) in zip(queries, fused, staged):
        assert [h["row"] for h in f_hits] == [h["row"] for h in s_hits]
        np.testing.assert_allclose([h["score"] for h in f_hits],
                                   [h["score"] for h in s_hits], atol=BI_ATOL, rtol=0)
        host = eng.reranker.score(q, [h["text"] for h in f_hits])
        np.testing.assert_allclose([h["rerank_score"] for h in f_hits], host, atol=1e-4)
    assert all(h["ticker"] == "AAPL" for h in fused[0][1])
    eng = sharded_hash_engine(tmp_path, identity=True)
    assert eng._fused_kind == "hash" and not eng._fused_hash_rerank
    (_, hits), = eng._fused_batch(["apple supply chain"], [("AAPL", None)])
    assert hits and all(h["rerank_score"] == h["score"] for h in hits)


def _many_docs(n=96):
    topics = ["revenue growth", "dividend payout", "cloud computing", "supply chain",
              "cyber security", "artificial intelligence"]
    tick = ["AAPL", "MSFT", "NVDA"]
    return [(f"filing chunk {i} discussing {topics[i % 6]} details", tick[i % 3])
            for i in range(n)]


def grown_engine(tmp_path):
    eng = sharded_engine(tmp_path)
    docs = _many_docs()
    eng.index.upsert([f"m{i}" for i in range(len(docs))],
                     eng.embedder.encode([d for d, _ in docs]), [d for d, _ in docs],
                     [{"ticker": t, "document_type": "10-K", "source_file": f"m{i}"}
                      for i, (_, t) in enumerate(docs)])
    return eng


def test_sharded_ivf_engine_fused_geometry_guard_and_tail(tmp_path):
    eng = grown_engine(tmp_path)
    out = eng.rebuild_index("ivf")
    assert out["status"] == "ok" and isinstance(eng.index, ShardedIVFIndex)
    assert eng._fused_kind == "ivf_full"
    # a tiny corpus makes every ticker selective (staged); drop the limit
    assert eng._fused_batch(["cloud computing details"], [("MSFT", None)]) is None
    eng.index.SELECTIVE_LIMIT = 0
    fused = assert_fused_is_staged(eng, ["cloud computing details", "dividend payout details"],
                                   [("MSFT", None), (None, None)], as_set=True)
    assert all(h["ticker"] == "MSFT" for h in fused[0][1])
    # a repacking that races the captured tile math forces the staged path
    args = (["cloud computing details"], [(None, None)])
    state = eng.index._state
    geom = state[5]
    eng.index._state = state[:5] + ((geom[0], geom[1] + 1, geom[2], geom[3]),) + state[6:]
    assert eng._fused_batch(*args) is None
    eng.index._state = state
    assert eng._fused_batch(*args) is not None
    # a tail row: the fused program would miss it, dispatch falls back
    text = "fresh tail chunk on buyback plans"
    eng.index.upsert(["tail0"], eng.embedder.encode([text]), [text],
                     [{"ticker": "AMZN", "document_type": "10-K"}])
    assert eng._fused_batch(["buyback plans"], [("AMZN", None)]) is None
    hits = eng._dispatch_batch(["buyback plans"], [("AMZN", None)])[0][1]
    assert hits and hits[0]["ticker"] == "AMZN"


def test_sharded_hnsw_engine_fused_matches_staged(tmp_path):
    eng = grown_engine(tmp_path)
    out = eng.rebuild_index("hnsw")
    assert out["status"] == "ok" and isinstance(eng.index, ShardedHNSWIndex)
    assert eng._fused_kind == "hnsw_full"
    eng.index.SELECTIVE_LIMIT = 0
    fused = assert_fused_is_staged(eng, ["cloud computing details", "supply chain details"],
                                   [("MSFT", None), (None, None)], as_set=True)
    assert all(h["ticker"] == "MSFT" for h in fused[0][1])
    # the hash stack on the sharded graph tier serves staged, as in JAX
    assert eng.rebuild_index()["tier"] == "ShardedHNSWIndex"
    assert eng.rebuild_index("ivf")["tier"] == "ShardedIVFIndex"
