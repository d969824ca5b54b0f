"""The port's IVF tier against the JAX package, on the CPU.

Same numpy inputs from a seed through the JAX functions and their
counterparts in ``financial_rag_system_tpu_torch``: k-means, k-center
init, the probe list, the probed-tiles search (the port's plain version
against ``ivf_probe_xla`` and the Pallas kernel in interpret mode), the
cluster-major packing and its persistence, online upserts, the churn
triggers, the staged candidate helpers, the fused IVF pipeline and the
engine/app surfaces (``device="cpu"``).  Small sizes: D 32-128, up to a
few thousand rows, tile 128.
"""

from __future__ import annotations

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from financial_rag_system_tpu.index import base as jbase
from financial_rag_system_tpu.index import hnsw as jhnsw
from financial_rag_system_tpu.index import ivf as jivf
from financial_rag_system_tpu.index.flat import FlatIndex as JFlat
from financial_rag_system_tpu.models import bert as jbert
from financial_rag_system_tpu.ops import fused_query as jfq
from financial_rag_system_tpu_torch.index import base as tbase
from financial_rag_system_tpu_torch.index import hnsw as thnsw
from financial_rag_system_tpu_torch.index import ivf as tivf
from financial_rag_system_tpu_torch.index.flat import FlatIndex as TFlat
from financial_rag_system_tpu_torch.models import bert as tbert
from financial_rag_system_tpu_torch.ops import fused_query as tfq
from financial_rag_system_tpu_torch.serving.app import build_default_engine, create_app

TICKERS = ("AAPL", "MSFT", "NVDA")
DOC_TYPES = ("10-K", "10-Q")


def clustered(rng, n, d, n_centers, noise=0.15):
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    v = centers[rng.integers(0, n_centers, n)]
    v = v + noise * rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def chunks(n, start=0):
    ids = [f"p{i}" for i in range(start, start + n)]
    texts = [f"text {i}" for i in range(start, start + n)]
    payloads = [{"ticker": TICKERS[i % 3], "document_type": DOC_TYPES[(i // 3) % 2]}
                for i in range(start, start + n)]
    return ids, texts, payloads


def both_flats(vecs, capacity=None):
    """The same rows, ids and payloads in a JAX and a port FlatIndex."""
    n, d = vecs.shape
    j = JFlat(dim=d, capacity=capacity or n, tile=128, use_pallas=False)
    t = TFlat(d, capacity=capacity or n, tile=128, device="cpu")
    ids, texts, payloads = chunks(n)
    j.upsert(ids, vecs, texts, payloads)
    t.upsert(ids, vecs, texts, payloads)
    return j, t


def rows_of(hits):
    return [[h["row"] for h in hl] for hl in hits]


def assert_same_state(j, t):
    """Packing, maps and tail of a JAX and a port IVFIndex agree."""
    assert (j.n_clusters, j.nprobe, j.c_max, j.tiles_per_cluster) == (
        t.n_clusters, t.nprobe, t.c_max, t.tiles_per_cluster)
    np.testing.assert_array_equal(t._state[5], np.asarray(j._state[5]))
    np.testing.assert_array_equal(t._state[6], j._state[6])
    np.testing.assert_array_equal(t._state[7], j._state[7])
    assert t._tail_rows == j._tail_rows
    np.testing.assert_array_equal(
        t.packed_emb.float().numpy(), np.asarray(j.packed_emb, np.float32))
    np.testing.assert_array_equal(t.packed_codes.numpy(), np.asarray(j.packed_codes))
    np.testing.assert_array_equal(t.packed_gids.numpy(), np.asarray(j.packed_gids))
    assert set(t._state[4]) == set(j._state[4])
    for code, rows in j._state[4].items():
        np.testing.assert_array_equal(t._state[4][code], rows)


# -- build pieces ---------------------------------------------------------------


def test_spherical_kmeans_matches_jax():
    rng = np.random.default_rng(0)
    vecs = clustered(rng, 1000, 64, 8, noise=0.1)
    init = vecs[[int(np.argmax(vecs @ c)) for c in clustered(rng, 8, 64, 8, 0.0)]]
    cj, aj = jivf.spherical_kmeans(jnp.asarray(vecs), 8, iters=10,
                                   init_cent=jnp.asarray(init))
    ct, at = tivf.spherical_kmeans(torch.from_numpy(vecs), 8, iters=10,
                                   init_cent=torch.from_numpy(init))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5, rtol=0)


def test_kcenter_rows_matches_jax():
    rng = np.random.default_rng(1)
    n, cap = 900, 1024
    vecs = np.zeros((cap, 64), np.float32)
    vecs[:n] = clustered(rng, n, 64, 12)
    emb_j = jnp.asarray(vecs, jnp.bfloat16)
    emb_t = torch.from_numpy(vecs).bfloat16()
    rows_j, tau_j = jhnsw.kcenter_rows(emb_j, jnp.int32(n), pool=24)
    rows_t, tau_t = thnsw.kcenter_rows(emb_t, n, pool=24)
    assert rows_t.dtype == torch.int32
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    assert abs(float(tau_t) - float(tau_j)) <= 1e-6
    np.testing.assert_array_equal(
        thnsw.kcenter_rows_host(vecs[:n].copy(), 24),
        jhnsw.kcenter_rows_host(vecs[:n].copy(), 24),
    )


@pytest.mark.parametrize("b", [1, 8])
def test_probe_tile_list_matches_jax(b):
    rng = np.random.default_rng(b)
    cent = clustered(rng, 32, 64, 32, 0.0)
    cent[9] = cent[5]  # tied centroid scores: membership follows lax.top_k
    q = clustered(rng, b, 64, 4)
    q[0] = cent[5]
    nprobe, tpc, num_tiles = 3, 2, 64
    budget = min(num_tiles, b * nprobe * tpc)
    ref = jivf.probe_tile_list(jnp.asarray(q), jnp.asarray(cent), nprobe=nprobe,
                               tpc=tpc, budget=budget)
    got = tivf.probe_tile_list(torch.from_numpy(q), torch.from_numpy(cent),
                               nprobe=nprobe, tpc=tpc, budget=budget)
    assert got.dtype == torch.int32 and got.shape == (budget,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref = jfq._probe_tiles(jnp.asarray(q), jnp.asarray(cent), nprobe=nprobe,
                           tiles_per_cluster=tpc, num_tiles=num_tiles)
    got = tfq._probe_tiles(torch.from_numpy(q), torch.from_numpy(cent), nprobe=nprobe,
                           tiles_per_cluster=tpc, num_tiles=num_tiles)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if b == 8:
        assert (got.numpy() == -1).any()  # the union leaves padding


# -- the probed-tiles search -------------------------------------------------------


def packed_case(kind, rng):
    """(q, qf, packed_emb, codes, gids, tile_ids) as numpy.  "index" packs
    a clustered corpus with the JAX IVFIndex; the rest hand-build a
    packing with padding slots, unsorted gids and a duplicated row whose
    packed order is the reverse of its gid order."""
    b, k_tiles, tile, d = 8, 12, 128, 64
    if kind == "index":
        vecs = clustered(rng, 512, 128, 4)
        j, _ = both_flats(vecs)
        ivf = jivf.IVFIndex(j, n_clusters=4, nprobe=2, tile=128)
        q = np.asarray(jnp.asarray(vecs[:b]).astype(ivf.dtype).astype(jnp.float32))
        tile_ids = np.asarray(ivf._tile_list(jnp.asarray(q, ivf.dtype), ivf.num_tiles,
                                             ivf.centroids))
        qf = np.full((b, 2), -1, np.int32)
        return (q, qf, np.asarray(ivf.packed_emb, np.float32),
                np.asarray(ivf.packed_codes), np.asarray(ivf.packed_gids), tile_ids)
    n = k_tiles * tile
    emb = clustered(rng, n, d, 6)
    gids = rng.permutation(4 * n)[:n].astype(np.int32)
    gids[rng.random(n) < 0.2] = -1
    codes = np.stack([rng.integers(0, 3, n), rng.integers(0, 2, n)]).astype(np.int32)
    p1, p2 = 3 * tile + 5, 9 * tile + 7
    emb[p2] = emb[p1]
    gids[p1], gids[p2] = 5000, 17
    q = clustered(rng, b, d, 6)
    q[0] = emb[p1]
    qf = np.full((b, 2), -1, np.int32)
    if kind == "ticker":
        qf[:, 0] = rng.integers(0, 3, b)
    elif kind == "ticker_dt":
        qf[:, 0], qf[:, 1] = rng.integers(0, 3, b), rng.integers(0, 2, b)
    elif kind == "sparse":
        codes[0, [40, 700, 1300]] = 7  # a ticker on 3 rows: fewer than k
        gids[[40, 700, 1300]] = [1, 2, 3]
        qf[1:, 0] = 7
    tile_ids = np.full(16, -1, np.int32)
    tile_ids[:9] = [0, 1, 2, 3, 5, 6, 9, 10, 11]
    q = np.asarray(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
    emb = np.asarray(jnp.asarray(emb, jnp.bfloat16).astype(jnp.float32))
    return q, qf, emb, codes, gids[None, :], tile_ids


@pytest.mark.parametrize("kind", ["index", "wildcard", "ticker", "ticker_dt", "sparse", "dups"])
def test_ivf_probe_plain_matches_xla_and_pallas(kind):
    rng = np.random.default_rng(3)
    q, qf, emb, codes, gids, tile_ids = packed_case(kind, rng)
    k = 5 if kind == "index" else 15
    jargs = (jnp.asarray(q, jnp.bfloat16), jnp.asarray(qf), jnp.asarray(emb, jnp.bfloat16),
             jnp.asarray(codes), jnp.asarray(gids), jnp.asarray(tile_ids), k)
    s_x, i_x = (np.asarray(a) for a in jivf.ivf_probe_xla(*jargs, tile=128))
    s_p, i_p = (np.asarray(a) for a in jivf.ivf_probe_pallas(
        *jargs, tile=128, probe_budget=len(tile_ids), interpret=True))
    s_t, i_t = tivf.ivf_probe_plain(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(qf),
        torch.from_numpy(emb).bfloat16(), torch.from_numpy(codes),
        torch.from_numpy(gids), torch.from_numpy(tile_ids), k, tile=128,
    )
    s_t, i_t = s_t.numpy(), i_t.numpy()
    fin = np.isfinite(s_x)
    np.testing.assert_array_equal(np.isfinite(s_t), fin)
    np.testing.assert_array_equal(np.isfinite(s_p), fin)
    np.testing.assert_allclose(s_t[fin], s_x[fin], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(i_t[fin], i_x[fin])
    np.testing.assert_array_equal(i_t[fin], i_p[fin])
    assert (i_t[~fin] == -1).all()
    if kind == "sparse":
        assert fin[1:].sum(axis=1).max() == 3
    if kind in ("wildcard", "dups"):
        # the duplicated row ties: lower packed position first, not lower gid
        assert list(i_t[0, :2]) == [5000, 17] and s_t[0, 0] == s_t[0, 1]


@pytest.mark.parametrize("k", [33, 64, 100])
@pytest.mark.parametrize("kind", ["wildcard", "ticker_dt", "dups"])
def test_ivf_probe_plain_large_k_matches_xla_and_pallas(kind, k):
    """k above the kernel's 32-entry round: the plain version against
    ivf_probe_xla and the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(k)
    q, qf, emb, codes, gids, tile_ids = packed_case(kind, rng)
    jargs = (jnp.asarray(q, jnp.bfloat16), jnp.asarray(qf), jnp.asarray(emb, jnp.bfloat16),
             jnp.asarray(codes), jnp.asarray(gids), jnp.asarray(tile_ids), k)
    s_x, i_x = (np.asarray(a) for a in jivf.ivf_probe_xla(*jargs, tile=128))
    s_p, i_p = (np.asarray(a) for a in jivf.ivf_probe_pallas(
        *jargs, tile=128, probe_budget=len(tile_ids), interpret=True))
    s_t, i_t = (a.numpy() for a in tivf.ivf_probe_plain(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(qf),
        torch.from_numpy(emb).bfloat16(), torch.from_numpy(codes),
        torch.from_numpy(gids), torch.from_numpy(tile_ids), k, tile=128,
    ))
    fin = np.isfinite(s_x)
    np.testing.assert_array_equal(np.isfinite(s_t), fin)
    np.testing.assert_array_equal(np.isfinite(s_p), fin)
    np.testing.assert_allclose(s_t[fin], s_x[fin], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(i_t[fin], i_x[fin])
    np.testing.assert_array_equal(i_t[fin], i_p[fin])
    assert (i_t[~fin] == -1).all()


# -- the index ---------------------------------------------------------------------


def test_load_of_a_jax_saved_index(tmp_path):
    rng = np.random.default_rng(11)
    vecs = clustered(rng, 1000, 64, 10)
    j, _ = both_flats(vecs)
    jidx = jivf.IVFIndex(j, nprobe=8, tile=128)
    jidx.save(str(tmp_path))
    # a row upserted after the IVF save lands in the tail on load
    extra = clustered(rng, 1, 64, 1)
    j.upsert(["extra"], extra, ["extra text"], [{"ticker": "NVDA"}])
    j.save(str(tmp_path))
    jidx2 = jivf.IVFIndex.load(str(tmp_path), JFlat.load(str(tmp_path), use_pallas=False))
    tidx = tivf.IVFIndex.load(str(tmp_path), TFlat.load(str(tmp_path), device="cpu"))
    assert_same_state(jidx2, tidx)
    assert tidx._tail_rows == [1000]
    q = np.concatenate([vecs[:5] + 0.01, extra])
    filters = [(None, None), ("AAPL", None), ("MSFT", "10-Q"), ("NVDA", None),
               (None, "10-K"), ("NVDA", None)]
    assert rows_of(tidx.search_batch(q, filters, k=10)) == rows_of(
        jidx2.search_batch(q, filters, k=10))


@pytest.mark.parametrize("sample", [None, 512])
def test_fresh_build_matches_jax(sample, monkeypatch):
    """Well-separated clusters: k-center init, Lloyd (on a 512-row sample
    with a chunked assignment when ``sample`` is set) and packing agree."""
    if sample:
        monkeypatch.setattr(jivf.IVFIndex, "KMEANS_SAMPLE", sample)
        monkeypatch.setattr(tivf.IVFIndex, "KMEANS_SAMPLE", sample)
    rng = np.random.default_rng(5)
    vecs = clustered(rng, 1024, 64, 16, noise=0.05)
    j, t = both_flats(vecs)
    jidx, tidx = jivf.IVFIndex(j, tile=128), tivf.IVFIndex(t, tile=128)
    assert tidx.n_clusters == 16
    assert_same_state(jidx, tidx)
    np.testing.assert_allclose(tidx.centroids.float().numpy(),
                               np.asarray(jidx.centroids, np.float32), atol=1e-2)
    assert set(tidx.build_seconds) >= {"kcenter", "lloyd", "pack"}
    q = vecs[:8] + 0.02 * rng.standard_normal((8, 64)).astype(np.float32)
    filters = [(None, None), ("AAPL", None), ("MSFT", "10-K"), (None, "10-Q")] * 2
    assert rows_of(tidx.search_batch(q, filters, k=15)) == rows_of(
        jidx.search_batch(q, filters, k=15))


def test_online_upsert_enters_packing_like_jax():
    rng = np.random.default_rng(6)
    vecs = clustered(rng, 1024, 64, 16, noise=0.05)
    j, t = both_flats(vecs, capacity=2048)
    jidx, tidx = jivf.IVFIndex(j, tile=128), tivf.IVFIndex(t, tile=128)
    new = clustered(rng, 3, 64, 3)
    args = (["n0", "n1", "n2"], new, ["t0", "t1", "t2"],
            [{"ticker": "AMD", "document_type": "10-K"}] * 3)
    jidx.upsert(*args)
    tidx.upsert(*args)
    assert tidx._tail_rows == [] and len(tidx._state[5]) == 1027
    assert_same_state(jidx, tidx)
    hits = tidx.search(new[0], ticker="AMD", k=3)[0]
    assert hits and hits[0]["text"] == "t0"  # the probed search finds it
    tidx.rebuild()
    assert tidx.search(new[0], ticker="AMD", k=3)[0][0]["text"] == "t0"


def test_online_upsert_spills_full_cluster():
    rng = np.random.default_rng(7)
    vecs = clustered(rng, 512, 32, 2)
    _, flat = both_flats(vecs, capacity=1024)
    idx = tivf.IVFIndex(flat, n_clusters=2, nprobe=2, tile=128, c_max=128,
                        auto_rebuild_tail_frac=0.0, auto_rebuild_growth_frac=0.0)
    n_new = (256 - int(idx._state[7].sum())) + 8  # at least 8 spills
    new = clustered(rng, n_new, 32, 4)
    idx.upsert([f"s{i}" for i in range(n_new)], new, [f"spill {i}" for i in range(n_new)],
               [{"ticker": "AMD", "document_type": "10-K"}] * n_new)
    assert (idx._state[7] <= 128).all() and idx._tail_rows
    hits = idx.search(new[-1], ticker="AMD", k=3)[0]
    assert hits and hits[0]["text"] == f"spill {n_new - 1}"
    idx.rebuild()
    hits = idx.search(new[-1], ticker="AMD", k=3)[0]
    assert hits and hits[0]["text"] == f"spill {n_new - 1}"


def test_reupsert_serves_the_fresh_vector():
    rng = np.random.default_rng(8)
    vecs = clustered(rng, 500, 32, 4)
    _, flat = both_flats(vecs)
    idx = tivf.IVFIndex(flat, n_clusters=4, nprobe=1, tile=128)
    nv = clustered(rng, 1, 32, 1)
    idx.upsert(["p7"], nv, ["fresh text"], [{"ticker": "AAPL", "document_type": "10-K"}])
    assert idx._state[6][7] == -1 and 7 in idx._tail_rows
    hits = idx.search(nv, k=3)[0]
    assert hits[0]["row"] == 7 and hits[0]["text"] == "fresh text"
    for h in idx.search(vecs[7], k=10)[0]:
        if h["row"] == 7:  # only with the fresh vector's score
            assert abs(h["score"] - float(vecs[7] @ nv[0])) < 0.05
    idx.upsert(["p7"], vecs[7:8], ["back again"], [{"ticker": "AAPL"}])
    hits = idx.search(vecs[7], k=3)[0]
    assert hits[0]["row"] == 7 and hits[0]["text"] == "back again"
    idx.rebuild()
    assert idx.search(vecs[7], k=3)[0][0]["row"] == 7


def test_search_during_a_growth_rebuild_reads_one_snapshot():
    """A growth rebuild that re-derives the geometry keeps serving the old
    snapshot whole until its swap: a search made mid-build (here from
    inside the packing step, where a concurrent reader lands) answers as
    before the rebuild, with the old geometry."""
    rng = np.random.default_rng(12)
    vecs = clustered(rng, 1400, 32, 4)
    _, flat = both_flats(vecs[:400], capacity=2048)
    idx = tivf.IVFIndex(flat, n_clusters=4, nprobe=2, tile=128)
    ids, texts, payloads = chunks(1000, start=400)
    flat.upsert(ids, vecs[400:], texts, payloads)  # grown behind the index
    q = torch.from_numpy(vecs[:8] + 0.01)
    qf = torch.full((8, 2), -1, dtype=torch.int32)
    before = [x.clone() for x in idx.search_device(q, qf, 5)]
    old_geom = idx._state.geom
    mid = []
    pack = idx._pack

    def pack_then_search(*args):
        mid.append((idx.c_max, idx.num_tiles, idx.search_device(q, qf, 5)))
        return pack(*args)

    idx._pack = pack_then_search
    idx.rebuild()
    (c_max, num_tiles, (s, i)), = mid
    assert (c_max, num_tiles) == (old_geom.c_max, old_geom.num_tiles)
    torch.testing.assert_close(s, before[0], rtol=0, atol=0)
    assert torch.equal(i, before[1])
    assert idx._state.geom.c_max > old_geom.c_max  # the rebuild did re-derive it
    assert idx._state.geom == idx._derive_geometry(1400)


def test_save_load_round_trip_and_stale_file(tmp_path):
    rng = np.random.default_rng(9)
    vecs = clustered(rng, 600, 64, 6)
    _, flat = both_flats(vecs)
    idx = tivf.IVFIndex(flat, tile=128)
    before = rows_of(idx.search_batch(vecs[:4] + 0.01, [(None, None)] * 4, k=5))
    idx.save(str(tmp_path))
    idx2 = tivf.IVFIndex.load(str(tmp_path), TFlat.load(str(tmp_path), device="cpu"))
    assert rows_of(idx2.search_batch(vecs[:4] + 0.01, [(None, None)] * 4, k=5)) == before
    assert (idx2.n_clusters, idx2.c_max) == (idx.n_clusters, idx.c_max)
    _, small = both_flats(vecs[:100])
    small.save(str(tmp_path))
    with pytest.raises(ValueError, match="stale ivf"):
        tivf.IVFIndex.load(str(tmp_path), TFlat.load(str(tmp_path), device="cpu"))


# -- churn triggers (mirror tests/test_ivf_churn.py, same data) ----------------------


def centers(rng, n, d):
    c = rng.standard_normal((n, d)).astype(np.float32)
    return c / np.linalg.norm(c, axis=1, keepdims=True)


def draw(rng, cents, n):
    v = cents[rng.integers(0, len(cents), n)]
    v = v + 0.15 * rng.standard_normal(v.shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def churn_flat(vecs, capacity):
    flat = TFlat(vecs.shape[1], capacity=capacity, tile=128, device="cpu")
    n = len(vecs)
    flat.upsert([f"p{i}" for i in range(n)], vecs, [f"text {i}" for i in range(n)],
                [{"ticker": "AAPL", "document_type": "10-K"}] * n)
    return flat


def churn(idx, mix, tag):
    ids = [f"{tag}{i}" for i in range(len(mix))]
    idx.upsert(ids, mix, ids, [{"ticker": "AAPL", "document_type": "10-Q"}] * len(mix))


def test_churn_recall_bounded_without_manual_rebuild():
    rng = np.random.default_rng(0)
    old_topics, new_topics = centers(rng, 16, 64), centers(rng, 8, 64)
    idx = tivf.IVFIndex(churn_flat(draw(rng, old_topics, 2048), 8192), tile=128)
    queries = np.concatenate([draw(rng, old_topics, 16), draw(rng, new_topics, 16)])

    def recall(qs):
        emb = idx.flat._emb[: idx.n_valid].float().numpy()
        exact = np.argsort(-(qs @ emb.T), axis=1)[:, :15]
        qf = torch.full((len(qs), 2), -1, dtype=torch.int32)
        _, rows = idx.search_device(torch.from_numpy(qs), qf, 15)
        return np.mean([len(set(r) & set(e)) / 15 for r, e in zip(rows.numpy(), exact)])

    fresh = recall(queries[:16])
    recalls = []
    for b in range(6):  # 6 x 256 = +75% of the corpus, half from unseen topics
        churn(idx, np.concatenate([draw(rng, new_topics, 128), draw(rng, old_topics, 128)]),
              f"c{b}-")
        recalls.append(recall(queries))
    assert idx._built_n > 2048, "growth trigger never fired"
    assert idx.n_valid == 2048 + 6 * 256
    assert min(recalls) >= min(0.95, fresh - 0.02), (recalls, fresh)
    assert len(idx._tail_rows) <= max(idx.tile, int(0.10 * idx.n_valid))


def test_tail_trigger_compacts_overflow():
    rng = np.random.default_rng(0)
    topics = centers(rng, 8, 32)
    idx = tivf.IVFIndex(churn_flat(draw(rng, topics, 512), 4096), tile=128)
    for b in range(4):  # every new row in one topic: its block overflows
        churn(idx, draw(rng, topics[:1], 256), f"s{b}-")
        assert len(idx._tail_rows) <= max(idx.tile, int(0.10 * idx.n_valid))
    assert idx._built_n > 512


def test_explicit_geometry_stays_pinned_and_triggers_switch_off():
    rng = np.random.default_rng(0)
    pinned = tivf.IVFIndex(churn_flat(draw(rng, centers(rng, 8, 32), 512), 4096),
                           n_clusters=8, nprobe=4, tile=128)
    churn(pinned, draw(rng, centers(rng, 4, 32), 512), "q")  # +100%: growth trigger
    assert pinned._built_n == 1024
    assert pinned.n_clusters == 8 and pinned.nprobe == 4
    rng = np.random.default_rng(0)
    frozen = tivf.IVFIndex(churn_flat(draw(rng, centers(rng, 8, 32), 512), 4096), tile=128,
                           auto_rebuild_tail_frac=0.0, auto_rebuild_growth_frac=0.0)
    churn(frozen, draw(rng, centers(rng, 8, 32), 512), "q")
    assert frozen._built_n == 512


# -- the staged candidate helpers ----------------------------------------------------


def test_selective_rows_score_rows_and_merge_match_jax():
    rng = np.random.default_rng(4)
    vecs = clustered(rng, 700, 64, 5)
    j, t = both_flats(vecs)
    rbt = tbase.build_ticker_lists(t, 700)
    jrbt = jbase.build_ticker_lists(j, 700)
    assert set(rbt) == set(jrbt)
    for code in rbt:
        np.testing.assert_array_equal(rbt[code], jrbt[code])
    host = [(0, -1), (2, 1), (1, -1)]
    # six 90-row lists under a limit of 100: the batch cap (4 x 100) stops
    # the union after four of them
    many = {c: np.arange(90 * c, 90 * c + 90, dtype=np.int32) for c in range(6)}
    for lists, codes, limit in ((rbt, host, 300), (rbt, host, 100),
                                (many, [(c, -1) for c in range(6)], 100)):
        got = tbase.selective_rows(lists, codes, limit)
        ref = jbase.selective_rows(lists if lists is many else jrbt, codes, limit)
        assert (got is None) == (ref is None)
        if got is not None:
            np.testing.assert_array_equal(got, ref)
    assert len(tbase.selective_rows(many, [(c, -1) for c in range(6)], 100)) == 360

    q = vecs[:4] + 0.01
    qf = np.asarray([[-1, -1], [0, -1], [2, 1], [1, 0]], np.int32)
    rows = np.sort(rng.choice(700, 90, replace=False))
    for kk, sub in ((15, rows), (15, rows[:6]), (4, rows)):
        s_j, i_j = jbase.score_rows(j, sub, jnp.asarray(q, jnp.bfloat16), jnp.asarray(qf), kk)
        s_t, i_t = tbase.score_rows(t, sub, torch.from_numpy(q).bfloat16(),
                                    torch.from_numpy(qf), kk)
        fin = np.isfinite(np.asarray(s_j))
        np.testing.assert_array_equal(np.isfinite(s_t.numpy()), fin)
        np.testing.assert_allclose(s_t.numpy()[fin], np.asarray(s_j)[fin], atol=1e-5)
        np.testing.assert_array_equal(i_t.numpy()[fin], np.asarray(i_j)[fin])
        assert (i_t.numpy()[~fin] == -1).all()

    s = np.sort(rng.random((3, 5)).astype(np.float32), axis=1)[:, ::-1].copy()
    i = rng.integers(0, 20, (3, 5)).astype(np.int32)
    extras = [(s[:, :3] + 0.001, i[:, :3].copy()),
              (np.full((3, 2), -np.inf, np.float32), np.full((3, 2), -1, np.int32)),
              (s[:, :4].copy(), (i[:, :4] + 7) % 20)]
    extras[0][0][0, 1] = s[0, 0]  # an equal score on another path
    ms_j, mi_j = jbase.merge_candidates(
        jnp.asarray(s), jnp.asarray(i), [(jnp.asarray(a), jnp.asarray(b)) for a, b in extras], 5)
    ms_t, mi_t = tbase.merge_candidates(
        torch.from_numpy(s), torch.from_numpy(i),
        [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in extras], 5)
    np.testing.assert_array_equal(ms_t.numpy(), np.asarray(ms_j))
    np.testing.assert_array_equal(mi_t.numpy(), np.asarray(mi_j))
    assert tbase.merge_candidates(torch.from_numpy(s), torch.from_numpy(i), [], 5)[0].shape == (3, 5)


# -- the fused IVF pipeline ----------------------------------------------------------

TINY = dict(vocab_size=1000, hidden=64, layers=2, heads=2, intermediate=128,
            max_positions=512, with_pooler=True)
B, N, DLEN, K, LQ = 4, 2048, 24, 15, 32


def models(seed, **extra):
    jcfg = jbert.BertConfig(**TINY, **extra)
    tcfg = tbert.BertConfig(**TINY, **extra)
    params = jbert.init_params(jax.random.PRNGKey(seed), jcfg)
    model = tbert.BertModel(tcfg, device="cpu")
    tbert.load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    return params, jcfg, model, tcfg


def test_fused_ivf_two_stage_matches_jax():
    rng = np.random.default_rng(0)
    e_params, e_jcfg, e_model, _ = models(0)
    r_params, r_jcfg, r_model, r_tcfg = models(1, num_labels=1)
    lens = np.array([9, 20, 5, 32])
    q_ids = rng.integers(500, 1000, (B, LQ)).astype(np.int32)
    q_mask = (np.arange(LQ)[None, :] < lens[:, None]).astype(np.int32)
    q_ids[:, 0] = 101
    q_ids[np.arange(B), lens - 1] = 102
    q_ids *= q_mask
    q_types = np.zeros_like(q_ids)
    h = np.asarray(jbert.encode(e_params, q_ids, q_types, q_mask, e_jcfg))
    qv = h[:, 0] / np.linalg.norm(h[:, 0], axis=1, keepdims=True)
    # a clustered corpus plus 15 rows per query at cosines 0.02 apart,
    # under that query's ticker
    c = clustered(rng, N, 64, 16)
    planted = rng.permutation(N)[: B * K].reshape(B, K)
    for i in range(B):
        for jj, row in enumerate(planted[i]):
            cos = 0.9 - 0.02 * jj
            noise = rng.standard_normal(64).astype(np.float32)
            noise -= (noise @ qv[i]) * qv[i]
            c[row] = cos * qv[i] + np.sqrt(1 - cos**2) * noise / np.linalg.norm(noise)
    jflat = JFlat(dim=64, capacity=N, tile=128, use_pallas=False)
    ids, texts, payloads = chunks(N)
    for i in range(B):
        for row in planted[i]:
            payloads[row] = {"ticker": f"Q{i}", "document_type": "10-K"}
    jflat.upsert(ids, c, texts, payloads)
    jidx = jivf.IVFIndex(jflat, tile=128)
    qf = np.asarray([jflat.store.query_codes(f"Q{i}", None) for i in range(B)], np.int32)
    dl = rng.integers(3, DLEN + 1, N)
    dtok = rng.integers(500, 1000, (N, DLEN)).astype(np.int32)
    dtok[np.arange(N), dl - 1] = 102
    dtok *= np.arange(DLEN)[None, :] < dl[:, None]
    geom = dict(k=K, tile=128, nprobe=jidx.nprobe, tiles_per_cluster=jidx.tiles_per_cluster)
    packing = (jidx.centroids, jidx.packed_emb, jidx.packed_codes, jidx.packed_gids)
    rows_j, bi_j, ce_j = (np.asarray(x) for x in jfq.fused_ivf_two_stage(
        e_params, r_params, q_ids, q_types, q_mask, jnp.asarray(qf), *packing,
        jnp.asarray(dtok), embed_cfg=e_jcfg, rerank_cfg=r_jcfg, use_pallas=False, **geom))
    to_t = [torch.from_numpy(np.asarray(a, np.float32)).bfloat16() for a in packing[:2]]
    out = tfq.make_fused_ivf_query(r_tcfg, **geom)(
        e_model, r_model, *(torch.from_numpy(a) for a in (q_ids, q_types, q_mask, qf)),
        *to_t, *(torch.from_numpy(np.asarray(a)) for a in packing[2:]), torch.from_numpy(dtok),
    )
    rows_t, bi_t, ce_t = (x.numpy() for x in out[:3])
    np.testing.assert_array_equal(rows_t, rows_j)
    np.testing.assert_array_equal(np.sort(rows_t, axis=1), np.sort(planted, axis=1))
    np.testing.assert_allclose(bi_t, bi_j, atol=2e-3, rtol=0)
    np.testing.assert_allclose(ce_t, ce_j, atol=3e-2, rtol=0)
    assert 0 < int(out[3]) <= jidx.num_tiles


# -- the engine and the HTTP shell -----------------------------------------------------


@pytest.fixture()
def env(tmp_path, monkeypatch):
    from financial_rag_system_tpu_torch.models.hf_export import save_bert_checkpoint
    from financial_rag_system_tpu_torch.utils.config import reset_config

    cfg = dict(vocab_size=30522, hidden=64, layers=2, heads=2, intermediate=128,
               with_pooler=True)
    for name, seed, extra in (("bge", 0, {}), ("rr", 1, {"num_labels": 1})):
        bcfg = tbert.BertConfig(**cfg, **extra)
        model = tbert.BertModel(bcfg, device="cpu")
        tbert.load_jax_params(model, tbert.init_params(torch.Generator().manual_seed(seed), bcfg))
        save_bert_checkpoint(model, bcfg, str(tmp_path / name), cross_encoder=bool(extra))
    monkeypatch.setenv("RAG_TPU_BGE_DIR", str(tmp_path / "bge"))
    monkeypatch.setenv("RAG_TPU_RERANKER_DIR", str(tmp_path / "rr"))
    monkeypatch.setenv("INDEX_DIR", str(tmp_path / "index"))
    monkeypatch.setenv("DATABASE_URL", ":memory:")
    monkeypatch.setenv("TESTING", "true")
    monkeypatch.setenv("RAG_TPU_CB_PATH", str(tmp_path / "cb.json"))
    monkeypatch.setenv("RAG_TPU_BATCH_WINDOW_S", "0.01")
    reset_config()
    yield tmp_path
    reset_config()


TOPICS = ["revenue", "margin", "supply chain", "cloud growth", "buybacks", "risk"]


def ivf_engine(**kw):
    eng = build_default_engine(device="cpu", **kw)
    n = 96
    ids = [f"c{i}" for i in range(n)]
    texts = [f"{'AAPL' if i % 3 else 'MSFT'} note {i}: {TOPICS[i % 6]} " * (1 + i % 3)
             for i in range(n)]
    payloads = [{"ticker": "AAPL" if i % 3 else "MSFT",
                 "document_type": "10-K" if i % 2 else "10-Q"} for i in range(n)]
    asyncio.run(eng.ingest_chunks(ids, texts, payloads))
    return eng


def test_rebuild_promotes_to_fused_ivf(env):
    eng = ivf_engine()
    out = eng.rebuild_index()
    assert out["status"] == "ok" and out["tier"] == "IVFIndex" and out["tail_rows"] == 0
    assert isinstance(eng.index, tivf.IVFIndex)
    st = eng.queue_status()
    assert st["fused_kind"] == "ivf_full" and st["index_tier"] == "IVFIndex"
    eng.index.SELECTIVE_LIMIT = 0  # a tiny corpus: every ticker is selective
    queries, filters = ["margin", "cloud"], [("AAPL", None), ("MSFT", "10-K")]
    fused = eng._fused_batch(queries, filters)
    assert fused is not None
    staged = eng._embed_retrieve_batch(queries, filters)
    for (_, f), (_, s) in zip(fused, staged):
        assert f and all("rerank_score" in h for h in f)
        assert [h["row"] for h in f] == [h["row"] for h in s]
    assert all(h["ticker"] == "MSFT" and h["document_type"] == "10-K" for h in fused[1][1])

    async def ask():
        await eng.startup()
        try:
            return await eng.ask("margin trend", "AAPL", top_k=3)
        finally:
            await eng.shutdown()

    resp = asyncio.run(ask())
    assert len(resp["sources"]) == 3 and resp["cached"] is False
    assert all(np.isfinite(s["score"]) for s in resp["sources"])
    # the HNSW tier serves too, fused, and back to IVF
    out = eng.rebuild_index("hnsw")
    assert out["status"] == "ok" and out["tier"] == "HNSWIndex" and out["tail_rows"] == 0
    assert eng.queue_status()["fused_kind"] == "hnsw_full"
    eng.index.SELECTIVE_LIMIT = 0
    fused = eng._fused_batch(queries, filters)
    assert fused is not None and all(f and "rerank_score" in f[0] for _, f in fused)
    assert eng.rebuild_index("ivf")["tier"] == "IVFIndex"


def test_tail_rows_and_selective_filters_take_the_staged_path(env):
    eng = ivf_engine()
    eng.rebuild_index("ivf")
    # a selective ticker (every ticker of a 96-row corpus is)
    assert eng._fused_batch(["margin"], [("AAPL", None)]) is None
    out = eng._dispatch_batch(["margin"], [("AAPL", None)])
    assert out[0][0] is not None and out[0][1]  # staged: query vectors come back
    eng.index.SELECTIVE_LIMIT = 0
    assert eng._fused_batch(["margin"], [("AAPL", None)]) is not None
    eng.index._tail_rows.append(5)
    assert eng._fused_batch(["margin"], [("AAPL", None)]) is None
    eng.index._tail_rows.clear()
    eng._fused = eng._fused[:2] + (tivf.IVFGeometry(0, 0, 0, 0),) + eng._fused[3:]  # as after a churn rebuild
    assert eng._fused_batch(["margin"], [("AAPL", None)]) is None


def test_http_rebuild_save_and_restore(env):
    eng = ivf_engine()

    async def scenario():
        async with TestClient(TestServer(create_app(eng))) as client:
            r = await client.post("/index/rebuild", json={"tier": "bogus"})
            assert r.status == 400
            r = await client.post("/index/rebuild", data="[1, 2]")
            assert r.status == 400
            r = await client.post("/index/rebuild", json={"tier": "hnsw"})
            assert r.status == 200 and (await r.json())["tier"] == "HNSWIndex"
            st = await (await client.get("/queue_status")).json()
            assert st["index_tier"] == "HNSWIndex" and st["fused_kind"] == "hnsw_full"
            r = await client.post("/index/rebuild", json={"tier": "ivf"})
            assert r.status == 200 and (await r.json())["tier"] == "IVFIndex"
            st = await (await client.get("/queue_status")).json()
            assert st["index_tier"] == "IVFIndex" and st["fused_kind"] == "ivf_full"
            r = await client.post("/index/save")
            assert r.status == 200

    asyncio.run(scenario())
    assert (env / "index" / "ivf_index.npz").exists()
    eng2 = build_default_engine(device="cpu")
    assert isinstance(eng2.index, tivf.IVFIndex) and eng2._fused_kind == "ivf_full"
    assert_rows = rows_of(eng2.index.search_batch(eng.embedder.encode(["risk"]), [(None, None)]))
    assert assert_rows == rows_of(eng.index.search_batch(eng.embedder.encode(["risk"]), [(None, None)]))

    # a flat save removes the IVF file, so a restart serves flat
    from financial_rag_system_tpu_torch.serving.engine import RAGEngine

    flat_eng = RAGEngine(eng2.cfg, eng2.index.flat, eng2.embedder, eng2.reranker)

    async def save_flat():
        async with TestClient(TestServer(create_app(flat_eng))) as client:
            assert (await client.post("/index/save")).status == 200

    asyncio.run(save_flat())
    assert not (env / "index" / "ivf_index.npz").exists()
    assert type(build_default_engine(device="cpu").index).__name__ == "FlatIndex"
