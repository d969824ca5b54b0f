"""The port's mesh-sharded indexes against the JAX package's, on the CPU.

The JAX side runs on the conftest's eight virtual CPU devices
(``create_mesh(devices=jax.devices()[:S])``), the port on a mesh that
names the CPU S times, at S = 2, 4 and 8, with the same seeded rows,
ids and payloads.  Rows must be identical and int8 scores bit for bit;
bf16 scores (f32 sums of the same products in another order) within
``BI_ATOL``.  The HNSW shards hold under 2,048 rows, which the native
builders of both packages insert on one thread: the same graphs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from financial_rag_system_tpu.index.sharded import ShardedFlatIndex as JSharded
from financial_rag_system_tpu.index.sharded_hnsw import ShardedHNSWIndex as JHNSW
from financial_rag_system_tpu.index.sharded_ivf import ShardedIVFIndex as JIVF
from financial_rag_system_tpu.parallel import mesh as jmesh
from financial_rag_system_tpu_torch.index.flat import FlatIndex
from financial_rag_system_tpu_torch.index.sharded import ShardedFlatIndex
from financial_rag_system_tpu_torch.index.sharded_hnsw import ShardedHNSWIndex
from financial_rag_system_tpu_torch.index.sharded_ivf import ShardedIVFIndex
from financial_rag_system_tpu_torch.parallel.control import _rebuild_tier
from financial_rag_system_tpu_torch.parallel.mesh import (
    AXIS_CORPUS,
    AXIS_DATA,
    _parse_mesh_shape,
    create_mesh,
)

SHARDS = (2, 4, 8)
BI_ATOL = 2e-3  # bf16 rows: the same f32 products summed in another order
TICKERS = ("AAPL", "MSFT", "GOOG")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Shapes this small gain nothing from intra-op threads, and the
    suite's parallel workers share the cores: one torch thread here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def meshes(s):
    return jmesh.create_mesh(devices=jax.devices()[:s]), create_mesh(devices=["cpu"] * s)


def clustered(rng, n, d=64, centers=32):
    c = rng.standard_normal((centers, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    v = c[rng.integers(0, centers, n)] + 0.15 * rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def chunk_args(n, start=0, rare_every=0, tag="p"):
    ids = [f"{tag}{i}" for i in range(start, start + n)]
    texts = [f"text {i}" for i in range(start, start + n)]
    payloads = [{"ticker": "RARE" if rare_every and i % rare_every == 0 else TICKERS[i % 3],
                 "document_type": "10-K" if i % 2 else "10-Q"}
                for i in range(start, start + n)]
    return ids, texts, payloads


def both(s, vecs, capacity, *, quantized=False, tile=64, rare_every=0):
    """The same rows in a JAX and a port ShardedFlatIndex of S shards."""
    jm, tm = meshes(s)
    d = vecs.shape[1]
    j = JSharded(jm, dim=d, capacity=capacity, tile=tile,
                 dtype=jnp.int8 if quantized else jnp.bfloat16)
    t = ShardedFlatIndex(tm, d, capacity=capacity, tile=tile,
                         dtype=torch.int8 if quantized else torch.bfloat16)
    ids, texts, payloads = chunk_args(len(vecs), rare_every=rare_every)
    j.upsert(ids, vecs, texts, payloads)
    t.upsert(ids, vecs, texts, payloads)
    return j, t


def rows_of(hits):
    return [[h["row"] for h in hl] for hl in hits]


def assert_same_hits(got, want, exact=False):
    assert rows_of(got) == rows_of(want)
    for a, b in zip(got, want):
        s_a, s_b = np.asarray([h["score"] for h in a]), np.asarray([h["score"] for h in b])
        if exact:
            assert s_a.astype(np.float32).tobytes() == s_b.astype(np.float32).tobytes()
        else:
            np.testing.assert_allclose(s_a, s_b, atol=BI_ATOL, rtol=0)


FILTERS = [(None, None), ("AAPL", None), ("MSFT", "10-K"), ("RARE", None),
           (None, "10-Q"), ("NOPE", None), ("GOOG", None), (None, None)]


# -- mesh ---------------------------------------------------------------------------


def test_mesh_spec_and_axes():
    assert _parse_mesh_shape("data:2, corpus:4") == {"data": 2, "corpus": 4}
    assert _parse_mesh_shape("data:2,corpus:4") == jmesh._parse_mesh_shape("data:2,corpus:4")
    m = create_mesh("data:2,corpus:4", devices=["cpu"] * 8)
    assert m.shape == {AXIS_DATA: 2, AXIS_CORPUS: 4} and len(m.devices) == 4
    assert [m.shard_index(i) for i in range(4)] == [0, 1, 2, 3] and not m.distributed
    assert create_mesh(devices=["cpu"] * 8).shape == {AXIS_DATA: 1, AXIS_CORPUS: 8}
    assert create_mesh("corpus:8", devices=["cpu"] * 8).shape[AXIS_CORPUS] == 8
    with pytest.raises(ValueError, match="devices"):
        create_mesh("data:3", devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            create_mesh()


@pytest.mark.parametrize("local_rank", [None, 3], ids=["process-id", "LOCAL_RANK"])
def test_default_mesh_under_a_process_group_is_this_process_card(monkeypatch, local_rank):
    """Two NCCL ranks on a host of two cards: each binds its own card (by
    LOCAL_RANK where the launcher sets it, else by process id) and its
    default mesh names only that card, so the ranks' meshes are disjoint
    and the corpus axis counts one shard a rank.  Without a group the
    default mesh takes both cards."""
    import torch.distributed as dist

    from financial_rag_system_tpu_torch.parallel import distributed
    from financial_rag_system_tpu_torch.parallel import mesh as tmesh

    bound: list[int] = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: bound[-1])
    monkeypatch.setattr(dist, "init_process_group", lambda *args, **kwargs: None)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    meshes = []
    for rank in (0, 1):
        if local_rank is None:
            monkeypatch.delenv("LOCAL_RANK", raising=False)
        else:
            monkeypatch.setenv("LOCAL_RANK", str(local_rank + rank))
        assert distributed.initialize_distributed("127.0.0.1:1", 2, rank, backend="nccl")
        monkeypatch.setattr(tmesh, "_process_group", lambda rank=rank: (rank, 2))
        meshes.append(create_mesh())
    assert bound == ([0, 1] if local_rank is None else [1, 0])
    cards = [torch.device("cuda", c) for c in bound]
    assert [m.devices for m in meshes] == [[cards[0]], [cards[1]]]
    assert [m.home for m in meshes] == cards and cards[0] != cards[1]
    assert [m.shape[AXIS_CORPUS] for m in meshes] == [2, 2]
    assert [m.shard_index(0) for m in meshes] == [0, 1]
    monkeypatch.setattr(tmesh, "_process_group", lambda: None)
    assert create_mesh().devices == [torch.device("cuda", 0), torch.device("cuda", 1)]


# -- ShardedFlatIndex -----------------------------------------------------------------


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("s", SHARDS)
def test_sharded_flat_matches_jax(s, quantized):
    """Search and filters (wildcard, ticker, ticker + type, a rare ticker,
    no match) at k 10 and at k 40 (more than some shards hold), and the
    port's own single-device FlatIndex rows."""
    rng = np.random.default_rng(s)
    v = clustered(rng, 400)
    j, t = both(s, v, 512, quantized=quantized, rare_every=50)
    assert t.capacity == j.capacity and t.per_shard * s == t.capacity
    flat = FlatIndex(64, capacity=512, tile=64, device="cpu",
                     dtype=torch.int8 if quantized else torch.bfloat16)
    flat.upsert(*chunk_args(400)[:1], v, *chunk_args(400, rare_every=50)[1:])
    q = clustered(rng, 8)
    for k in (10, 40):
        got = t.search_batch(q, FILTERS, k=k)
        assert_same_hits(got, j.search_batch(q, FILTERS, k=k), exact=quantized)
        assert rows_of(got) == rows_of(flat.search_batch(q, FILTERS, k=k))
    assert got[5] == [] and all(h["ticker"] == "RARE" for h in got[3])


@pytest.mark.parametrize("s", SHARDS)
def test_growth_and_reupsert_match_jax(s):
    """An upsert past the capacity doubles each shard's rows (the blocks
    redistribute); re-upserted ids rewrite their rows in place."""
    rng = np.random.default_rng(10 + s)
    v = clustered(rng, 300, d=32)
    j, t = both(s, v, 512)
    cap0 = t.capacity
    more = clustered(rng, cap0, d=32)
    args = chunk_args(cap0, start=300)
    j.upsert(args[0], more, *args[1:])
    t.upsert(args[0], more, *args[1:])
    assert t.capacity == j.capacity > cap0 and t.n_valid == 300 + cap0
    redo = clustered(rng, 5, d=32)
    for idx in (j, t):
        idx.upsert([f"p{i}" for i in range(5)], redo, ["redo"] * 5,
                   [{"ticker": "AAPL", "document_type": "10-K"}] * 5)
    q = np.concatenate([redo[:2], more[:6]])
    assert_same_hits(t.search_batch(q, FILTERS, k=10), j.search_batch(q, FILTERS, k=10))
    assert t.search(more[50], k=3)[0][0]["row"] == 350


def test_partial_and_empty_shards():
    """Block layout fills shard 0 first: with every row on shard 0 the
    other seven shards (no valid rows) give -inf / -1 and nothing else."""
    rng = np.random.default_rng(6)
    v = clustered(rng, 300)
    j, t = both(8, v, 4096)
    assert t.per_shard >= 300
    s_t, i_t = t.search_device(torch.from_numpy(v[:3]), torch.full((3, 2), -1), 40)
    assert (i_t[:, :300 // 1].numpy() < 300).all()
    fin = np.isfinite(s_t.numpy())
    assert fin.all()  # 40 live rows on shard 0
    hits = t.search(v[:3], k=5)
    assert [hl[0]["row"] for hl in hits] == [0, 1, 2]
    assert_same_hits(hits, j.search(v[:3], k=5))
    # filters that match nothing: every slot empty on every shard
    s_t, i_t = t.search_device(torch.from_numpy(v[:2]),
                               torch.tensor([[-3, -3], [-3, -3]], dtype=torch.int32), 15)
    assert np.isneginf(s_t.numpy()).all() and (i_t.numpy() == -1).all()


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_sharded_index_file_across_packages(saver, tmp_path):
    """``sharded_index.npz`` (with a token store) saved by either package
    at S 4 loads in the other at S 4 and, re-padded, at S 2 and 8."""
    from financial_rag_system_tpu.models.tokenizer import Tokenizer as JTok
    from financial_rag_system_tpu_torch.models.tokenizer import Tokenizer as TTok

    rng = np.random.default_rng(7)
    v = clustered(rng, 300)
    jm, tm = meshes(4)
    j = JSharded(jm, dim=64, capacity=512, tile=64, token_store_len=24, tokenizer=JTok())
    t = ShardedFlatIndex(tm, 64, capacity=512, tile=64, token_store_len=24, tokenizer=TTok())
    ids, _texts, payloads = chunk_args(300)
    texts = [f"apple revenue note {i} margin" for i in range(300)]
    j.upsert(ids, v, texts, payloads)
    t.upsert(ids, v, texts, payloads)
    np.testing.assert_array_equal(t.gathered(2).numpy(), np.asarray(j._doc_tok))
    (j if saver == "jax" else t).save(str(tmp_path))
    q = clustered(rng, 8)
    want = j.search_batch(q, FILTERS, k=10)
    for s in (4, 2, 8):
        jm_s, tm_s = meshes(s)
        loaded_t = ShardedFlatIndex.load(str(tmp_path), tm_s, tokenizer=TTok())
        loaded_j = JSharded.load(str(tmp_path), jm_s, tokenizer=JTok())
        assert loaded_t.token_store_len == 24 and loaded_t.n_valid == 300
        np.testing.assert_array_equal(loaded_t.gathered(2).numpy()[:300],
                                      np.asarray(j._doc_tok)[:300])
        assert_same_hits(loaded_t.search_batch(q, FILTERS, k=10), want)
        assert_same_hits(loaded_j.search_batch(q, FILTERS, k=10), want)


# -- ShardedIVFIndex ---------------------------------------------------------------


def assert_same_ivf(j, t):
    """Codebook geometry, packing (each port shard against its block of
    JAX's global packing), row map, tail and inverted lists agree."""
    assert (j.n_clusters, j.nprobe, j.c_max, j.tiles_per_cluster, j.packed_local) == (
        t.n_clusters, t.nprobe, t.c_max, t.tiles_per_cluster, t.packed_local)
    np.testing.assert_allclose(t.centroids.float().numpy(),
                               np.asarray(j.centroids, np.float32), atol=1e-2)
    np.testing.assert_array_equal(t._state[6], j._state[6])
    assert t._tail_rows == j._tail_rows
    pl = t.packed_local
    for g in range(t.n_shards):
        blk = slice(g * pl, (g + 1) * pl)
        np.testing.assert_array_equal(t.packed_gids[g].numpy(), np.asarray(j.packed_gids)[:, blk])
        np.testing.assert_array_equal(t.packed_codes[g].numpy(),
                                      np.asarray(j.packed_codes)[:, blk])
        np.testing.assert_array_equal(t.packed_emb[g].float().numpy(),
                                      np.asarray(j.packed_emb, np.float32)[blk])
    assert set(t._state[4]) == set(j._state[4])
    for code, rows in j._state[4].items():
        np.testing.assert_array_equal(t._state[4][code], rows)


# every shard count in bf16, int8 at S 4; the build and a search go against
# JAX at every count, the upserts and rebuild() after them at S 4 (JAX
# compiles each step's program anew for every mesh) and within the port at
# S 2 and 8
CASES = [(2, False), (4, False), (8, False), (4, True)]
CASE_IDS = ["S2-bf16", "S4-bf16", "S8-bf16", "S4-int8"]


@pytest.mark.parametrize("s,quantized", CASES, ids=CASE_IDS)
def test_sharded_ivf_matches_jax(s, quantized):
    """Packing, probe search with the selective (RARE) exact path, a tail
    upsert, a re-upsert that masks its packed slot, and rebuild(): against
    JAX (at S 2 and 8 the steps after the first search against the port's
    own expectations and a fresh build)."""
    rng = np.random.default_rng(20 + s)
    v = clustered(rng, 1024, centers=16)
    j, t = both(s, v, 1024, quantized=quantized, rare_every=64)
    jx = JIVF(j, n_clusters=16, nprobe=4, tile=64)
    tx = ShardedIVFIndex(t, n_clusters=16, nprobe=4, tile=64)
    assert_same_ivf(jx, tx)
    q = clustered(rng, 8, centers=16)
    assert_same_hits(tx.search_batch(q, FILTERS, k=10), jx.search_batch(q, FILTERS, k=10),
                     exact=quantized)
    with_jax = s == 4
    # new rows tail; re-upserted rows mask their packed slot and tail too
    new = clustered(rng, 6, centers=16)
    ids = ["x0", "x1", "x2", "p1", "p2", "p3"]
    pays = [{"ticker": "NVDA", "document_type": "10-K"}] * 6
    for idx in (jx, tx) if with_jax else (tx,):
        idx.upsert(ids, new, ["new"] * 6, pays)
    assert {1024, 1025, 1026, 1, 2, 3} <= set(tx._tail_rows)
    assert (tx._state[6][[1, 2, 3]] == -1).all()
    for g in range(s):
        assert not np.isin(tx.packed_gids[g].numpy(), [1, 2, 3]).any()
    nv = [(("NVDA", None))] * 6
    got = tx.search_batch(new, nv, k=3)
    assert [hl[0]["row"] for hl in got] == [1024, 1025, 1026, 1, 2, 3]
    if with_jax:
        assert tx._tail_rows == jx._tail_rows
        np.testing.assert_array_equal(tx._state[6], jx._state[6])
        assert_same_hits(got, jx.search_batch(new, nv, k=3), exact=quantized)
    for idx in (jx, tx) if with_jax else (tx,):
        idx.rebuild()
    if with_jax:
        assert_same_ivf(jx, tx)
        want = jx.search_batch(q, FILTERS, k=10)
    else:
        fresh = ShardedIVFIndex(t, n_clusters=16, nprobe=4, tile=64)
        assert tx._tail_rows == fresh._tail_rows
        np.testing.assert_array_equal(tx._state[6], fresh._state[6])
        want = fresh.search_batch(q, FILTERS, k=10)
    assert_same_hits(tx.search_batch(q, FILTERS, k=10), want,
                     exact=quantized or not with_jax)


def test_sharded_ivf_empty_shard_packing():
    """Shards past the corpus pack padding only (every gid -1) and add
    nothing to a search."""
    rng = np.random.default_rng(30)
    v = clustered(rng, 200, centers=8)
    j, t = both(8, v, 2048)
    jx, tx = JIVF(j, n_clusters=8, nprobe=4, tile=64), ShardedIVFIndex(t, n_clusters=8,
                                                                      nprobe=4, tile=64)
    assert_same_ivf(jx, tx)
    assert all((tx.packed_gids[g].numpy() == -1).all() for g in range(1, 8))
    q = clustered(rng, 4, centers=8)
    assert_same_hits(tx.search(q, k=10), jx.search(q, k=10))


# -- ShardedHNSWIndex --------------------------------------------------------------


def assert_same_graphs(j, t):
    adj_j, ent_j = j._host_graphs
    np.testing.assert_array_equal(t._host_graphs[0], adj_j)
    np.testing.assert_array_equal(t._host_graphs[1], ent_j)
    np.testing.assert_array_equal(t._host_pools, j._host_pools)
    js, ts = j._graph_state, t._graph_state
    assert ts[2:5] == js[2:5] and ts[7] == js[7]
    for g in range(t.n_shards):
        np.testing.assert_array_equal(ts[0][g].numpy(), np.asarray(js[0])[g])
    assert t._tail_rows == j._tail_rows


@pytest.mark.parametrize("s,quantized", CASES, ids=CASE_IDS)
def test_sharded_hnsw_matches_jax(s, quantized):
    """Per-shard graphs, pools and walks with the selective exact path
    and a tail upsert: rows identical, scores within BI_ATOL or bit for
    bit (int8)."""
    rng = np.random.default_rng(40 + s)
    v = clustered(rng, 1024)
    j, t = both(s, v, 1024, quantized=quantized, rare_every=64)
    jx, tx = JHNSW(j), ShardedHNSWIndex(t)
    assert_same_graphs(jx, tx)
    q = clustered(rng, 8)
    with_jax = s == 4  # the tail's steps against JAX at S 4 (see CASES)
    for k in (10, 20) if with_jax else (20,):
        assert_same_hits(tx.search_batch(q, FILTERS, k=k), jx.search_batch(q, FILTERS, k=k),
                         exact=quantized)
    new = clustered(rng, 3)
    for idx in (jx, tx) if with_jax else (tx,):
        idx.upsert(["x0", "x1", "x2"], new, ["new"] * 3,
                   [{"ticker": "NVDA", "document_type": "10-K"}] * 3)
    assert tx._tail_rows == [1024, 1025, 1026]
    got = tx.search_batch(new, [("NVDA", None)] * 3, k=3)
    assert [hl[0]["row"] for hl in got] == [1024, 1025, 1026]
    if with_jax:
        assert jx._tail_rows == tx._tail_rows
        assert_same_hits(got, jx.search_batch(new, [("NVDA", None)] * 3, k=3),
                         exact=quantized)


def test_sharded_hnsw_growth_falls_back_and_rebuilds():
    """A capacity-growing upsert serves the exact sharded scan (the flat
    rows, in order) until rebuild() restores the graphs on both sides."""
    rng = np.random.default_rng(50)
    v = clustered(rng, 1024)
    j, t = both(4, v, 1024)
    jx, tx = JHNSW(j), ShardedHNSWIndex(t)
    extra = clustered(rng, 1100)
    args = chunk_args(1100, start=1024, tag="g")
    for idx in (jx, tx):
        idx.upsert(args[0], extra, *args[1:])
    assert t.capacity > tx._graph_state[4]
    q = clustered(rng, 8)
    got = tx.search_batch(q, FILTERS, k=10)
    assert rows_of(got) == rows_of(t.search_batch(q, FILTERS, k=10))
    assert_same_hits(got, jx.search_batch(q, FILTERS, k=10))
    for idx in (jx, tx):
        idx.rebuild()
    assert tx._graph_state[4] == t.capacity and tx.n_graph == t.n_valid == 2124
    assert_same_graphs(jx, tx)
    assert_same_hits(tx.search_batch(q, FILTERS, k=10), jx.search_batch(q, FILTERS, k=10))


def test_sharded_hnsw_partial_and_empty_shards():
    rng = np.random.default_rng(6)
    v = clustered(rng, 300)
    j, t = both(8, v, 4096)
    jx, tx = JHNSW(j), ShardedHNSWIndex(t)
    hits = tx.search_batch(v[:3], [(None, None)] * 3, k=5)
    assert [hl[0]["row"] for hl in hits] == [0, 1, 2]
    assert all(0 <= h["row"] < 300 for hl in hits for h in hl)
    assert_same_hits(hits, jx.search_batch(v[:3], [(None, None)] * 3, k=5))


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_sharded_hnsw_graph_file_across_packages(saver, tmp_path):
    """``sharded_hnsw_graph.npz`` + ``sharded_index.npz`` saved by either
    package load in the other with the same graphs and search; rows past
    the saved graph tail."""
    rng = np.random.default_rng(8)
    v = clustered(rng, 1024)
    j, t = both(4, v, 1024)
    jx, tx = JHNSW(j), ShardedHNSWIndex(t)
    (jx if saver == "jax" else tx).save(str(tmp_path))
    jm, tm = meshes(4)
    jl = JHNSW.load(str(tmp_path), JSharded.load(str(tmp_path), jm))
    tl = ShardedHNSWIndex.load(str(tmp_path), ShardedFlatIndex.load(str(tmp_path), tm))
    assert_same_graphs(jl, tl)
    assert_same_graphs(jx, tl)
    q = clustered(rng, 8)
    assert_same_hits(tl.search_batch(q, FILTERS, k=10), jx.search_batch(q, FILTERS, k=10))
    # a graph saved under a larger corpus is stale
    small = ShardedFlatIndex(tm, 64, capacity=1024, tile=64)
    small.upsert(*chunk_args(10)[:1], v[:10], *chunk_args(10)[1:])
    with pytest.raises(ValueError, match="stale"):
        ShardedHNSWIndex.load(str(tmp_path), small)


def test_rebuild_tier_op_promotes_and_switches():
    """The control plane's tier op: promote to HNSW, rebuild in place,
    switch to IVF and back (JAX ``tests/test_sharded_hnsw.py:243``)."""
    rng = np.random.default_rng(9)
    _j, t = both(4, clustered(rng, 1024), 1024)
    idx = _rebuild_tier(t, "hnsw")
    assert isinstance(idx, ShardedHNSWIndex)
    assert _rebuild_tier(idx, "hnsw") is idx
    ivf = _rebuild_tier(idx, "ivf")
    assert isinstance(ivf, ShardedIVFIndex) and ivf.tile == 64
    assert _rebuild_tier(ivf, None) is ivf
    assert isinstance(_rebuild_tier(ivf, "hnsw"), ShardedHNSWIndex)
