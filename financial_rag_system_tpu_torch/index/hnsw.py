"""HNSW index tier: native host-side build, batched device-side walk.

Port of ``financial_rag_system_tpu/index/hnsw.py``, the graph tier that
``RAGEngine.rebuild_index("hnsw")`` promotes a flat corpus to:

- **Build** (host, ``native/hnsw.cpp`` built with g++ at first use):
  hierarchical insertion with an efConstruction beam and heuristic
  neighbour selection.  The graph is flattened for the device: a
  fixed-degree level-0 adjacency (N, 2M), the upper levels as a packed
  hierarchy for the descent, and a short list of entry nodes.  Without
  g++, an exact-kNN numpy graph (:func:`build_knn_graph`) up to
  ``HNSWIndex.MAX_FALLBACK_ROWS`` rows; above that the build refuses.
- **Query** (device, this file): a batched best-first beam walk with a
  fixed step count (:func:`hnsw_walk`), seeded by the k-center entry
  pool (:func:`pool_take`) and the descent over the upper levels
  (:func:`hier_descend`).  Each step expands the best ``frontier``
  unexpanded beam nodes of each query, gathers their neighbours' rows
  and merges them by score.  The visited set is a ring of every id that
  entered the candidates; membership is one compare and any.  The JAX
  package writes the walk in XLA (``lax.scan``), not Pallas, so there is
  no kernel here: each step is a Python loop of torch ops queued on the
  device's stream with no host synchronisation.
- **Arithmetic, as JAX computes it.** Scores are f32 sums of elementwise
  products of the gathered rows and the f32 queries (never a matmul, so
  no TF32, whatever the global flags), which for int8 rows are integers
  below 2^24 and exact in any order.  Every top-k is a stable descending
  sort, so equal scores go to the lower position, as ``lax.top_k``: the
  beam and the results feed the next step, and one tie broken the other
  way would change which nodes expand.
- **Filters** are result-side: traversal ranks by raw similarity, and a
  separate result list masks rows that fail the query's filter.  A
  filter matching at most ``SELECTIVE_LIMIT`` graph rows is also scored
  exactly over its inverted list (kernel 1), as are tail rows.
- **Upserts** enter the graph online while the native handle lives:
  ``frs_hnsw_add`` inserts the rows, and only the level-0 rows whose
  neighbour lists changed are copied into a NEW adjacency tensor, which
  is published with the rest of the snapshot in one assignment, so a
  batch in flight on another thread keeps reading the old one.  The
  adjacency is padded to the flat capacity, so the walk's sentinel never
  changes.  Loaded graphs and the exact-kNN fallback keep the tail
  contract: upserts are scored exactly until ``rebuild()``.

Persistence is the JAX package's ``hnsw_graph.npz``: either package loads
the other's graph.
"""

from __future__ import annotations

import math
import os
import threading
import time

import numpy as np
import torch

from financial_rag_system_tpu_torch.index.base import (
    SearchMixin,
    build_ticker_lists,
    merge_candidates,
    score_rows,
    selective_rows,
)
from financial_rag_system_tpu_torch.index.flat import quantize_int8

NEG_INF = float("-inf")


def walk_queries(query_vecs: torch.Tensor, corpus_dtype: torch.dtype) -> torch.Tensor:
    """Queries as the walk scores them: the rows' int8 quantization for an
    int8 corpus (walk and exact scores then share one scale, cos * 127^2),
    else f32 (JAX ``hnsw.py:873-877``, ``fused_query.py:985``)."""
    if corpus_dtype == torch.int8:
        return quantize_int8(query_vecs)
    return query_vecs.float()


def _top(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along dim 1: the k largest, equal values in index
    order (a stable descending sort)."""
    s, pos = torch.sort(x, dim=1, descending=True, stable=True)
    return s[:, :k], pos[:, :k]


def _dedup_sorted(ids: torch.Tensor, sentinel: int) -> torch.Tensor:
    """Sort each row's ids and replace repeats by ``sentinel`` (no scatter)."""
    ids = torch.sort(ids, dim=1).values
    dup = torch.zeros_like(ids, dtype=torch.bool)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    return ids.masked_fill(dup, sentinel)


def _row_scores(emb: torch.Tensor, rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(B, C) f32 scores of the gathered rows ``emb[rows]`` against the
    (B, D) f32 queries: elementwise products summed in f32.  A row index
    past the corpus (the walk's sentinel may equal its row count) is read
    from the last row; callers mask it."""
    safe = rows.clamp(max=emb.shape[0] - 1).long()
    return (emb[safe].float() * q[:, None, :]).sum(-1)


# ---------------------------------------------------------------------------
# fallback host build (exact kNN graph) — used when native code is off
# ---------------------------------------------------------------------------


def build_knn_graph(
    vecs: np.ndarray, *, m: int = 16, entries_cap: int = 64, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Exact 2M-NN graph + random entry sample.

    O(N^2), for the corpus sizes that run without the native builder.
    Adjacency shape matches the native export: (N, 2M) int32, -1 padded.
    """
    n = vecs.shape[0]
    w = min(2 * m, max(1, n - 1))
    sims = vecs @ vecs.T
    np.fill_diagonal(sims, -np.inf)
    nbrs = np.argpartition(-sims, kth=w - 1, axis=1)[:, :w]
    row_s = np.take_along_axis(sims, nbrs, axis=1)
    order = np.argsort(-row_s, axis=1)
    adj = np.take_along_axis(nbrs, order, axis=1).astype(np.int32)
    if w < 2 * m:
        adj = np.pad(adj, ((0, 0), (0, 2 * m - w)), constant_values=-1)
    rng = np.random.default_rng(seed)
    ent = rng.choice(n, size=min(entries_cap, n), replace=False)
    return adj, ent.astype(np.int32)


# ---------------------------------------------------------------------------
# device descent over the exported upper levels
# ---------------------------------------------------------------------------


@torch.inference_mode()
def hier_descend(
    queries: torch.Tensor,  # (B, D) prepped like the walk's queries
    emb: torch.Tensor,      # corpus rows (shared with the flat tier)
    hi_ids: torch.Tensor,   # (HC+1,) int32 global id per hi-local node,
                            #  level-sorted desc; slot HC is a safe-gather pad
    hi_adj: torch.Tensor,   # (L, HC+1, M) int32 hi-local adjacency per
                            #  level (index 0 <=> level 1), pad == HC
    hi_n: int,              # live hi-node count (<= HC)
    *,
    beam: int,
    steps: int,
    frontier: int,
    pad_global: int,
) -> torch.Tensor:
    """Coarse-to-fine routing: beam-walk each upper level top-down; the
    survivors of level l seed level l-1.  Returns (B, beam) GLOBAL ids
    (sentinel slots == ``pad_global``) that seed the level-0 walk.

    The level-0 walk explores a budget of nodes independent of the corpus
    size, so on a large corpus its recall rests on entry points that land
    near the answer; the upper levels are HNSW's long-range routing
    structure.  Each level is walked with fixed shapes and step count, the
    top level first.  No visited ring here: upper levels are small and a
    revisit only costs a wasted gather.
    """
    b = queries.shape[0]
    hc = hi_ids.shape[0] - 1
    m = hi_adj.shape[2]
    q = queries.float()
    c_w = frontier * m

    def score(ids):  # hi-local ids -> similarity, pad = -inf
        s = _row_scores(emb, hi_ids[ids.long()], q)
        return s.masked_fill(ids == hc, NEG_INF)

    # the first `beam` hi-local slots hold the highest-level nodes (the
    # level-sorted export): the classic HNSW global entry and its peers
    iota = torch.arange(beam, dtype=torch.int32, device=q.device)
    beam_ids = torch.where(iota < hi_n, iota, hc)[None, :].expand(b, beam).contiguous()
    beam_s = score(beam_ids)
    for level in reversed(range(hi_adj.shape[0])):  # hi_adj[0] is level 1
        adj_l = hi_adj[level]
        expanded = beam_ids == hc  # re-expand at every level: new edges
        for _ in range(steps):
            top_s, slot = _top(beam_s.masked_fill(expanded, NEG_INF), frontier)
            src = torch.gather(beam_ids, 1, slot)
            src = torch.where(top_s > NEG_INF, src, hc)
            expanded = expanded.scatter(1, slot, True)
            cand = adj_l[src.long()].reshape(b, c_w)
            # dedup against the beam and within the step, so duplicates
            # cannot crowd the beam
            in_beam = (cand[:, :, None] == beam_ids[:, None, :]).any(dim=2)
            cand = _dedup_sorted(cand.masked_fill(in_beam, hc), hc)
            all_s = torch.cat([beam_s, score(cand)], dim=1)
            all_i = torch.cat([beam_ids, cand], dim=1)
            all_e = torch.cat([expanded, cand == hc], dim=1)
            beam_s, pos = _top(all_s, beam)
            beam_ids = torch.gather(all_i, 1, pos)
            expanded = torch.gather(all_e, 1, pos)
    return torch.where(beam_ids == hc, pad_global, hi_ids[beam_ids.long()])


def pack_hier(
    hi_ids: np.ndarray,
    hi_levels: np.ndarray,
    hi_adj: np.ndarray,
    *,
    hc_cap: int,
    l_cap: int,
    m: int,
    device: str | torch.device = "cpu",
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Pad the native hierarchy export to fixed device shapes.

    Returns ``(hi_ids (hc_cap+1,), hi_adj (l_cap, hc_cap+1, m), hi_n)``.
    Sentinel == hc_cap: pad slots of hi_ids hold 0 (a safe gather; scores
    are masked on the hi-local id) and pad adjacency points at the
    sentinel.  Fixed caps let online inserts re-export the (small)
    hierarchy into the same shapes.
    """
    hi_n = len(hi_ids)
    if hi_n > hc_cap or hi_adj.shape[0] > l_cap:
        raise ValueError(
            f"hierarchy ({hi_n} nodes, {hi_adj.shape[0]} levels) exceeds "
            f"caps ({hc_cap}, {l_cap})"
        )
    ids = np.zeros(hc_cap + 1, np.int32)
    ids[:hi_n] = hi_ids
    adj = np.full((l_cap, hc_cap + 1, m), hc_cap, np.int32)
    if hi_n:
        adj[: hi_adj.shape[0], :hi_n, :] = np.where(hi_adj < 0, hc_cap, hi_adj)
    return (torch.as_tensor(ids, device=device), torch.as_tensor(adj, device=device),
            hi_n)


def hier_caps(capacity: int, m: int) -> tuple[int, int]:
    """Fixed (hc_cap, l_cap) for a corpus capacity: the expected hi count
    is capacity/m under geometric level sampling; the slack covers
    sampling variance so online inserts virtually never overflow."""
    mu = capacity / max(2, m)
    hc_cap = int(mu + 6 * math.sqrt(mu + 1)) + 64
    l_cap = int(math.log(max(capacity, 2)) / math.log(max(2, m))) + 2
    return hc_cap, l_cap


# ---------------------------------------------------------------------------
# k-center entry pool: coverage-guaranteed seeds for the walk
# ---------------------------------------------------------------------------
#
# HNSW's own structure cannot route to tight outlier clusters that get
# almost no in-edges from the corpus bulk (heuristic neighbour selection
# prunes remote backlinks as the bulk densifies).  A greedy k-center
# (farthest-point) sample covers every row within its radius and picks
# the most isolated clusters first; scoring the pool for each query and
# seeding the beam with its best rows reaches them.


@torch.inference_mode()
def kcenter_rows(
    emb: torch.Tensor, n: int, *, pool: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy farthest-point sample of rows [0, n) of ``emb`` (cap, D).

    Returns ``(rows (pool,) int32, tau ())`` where ``tau`` is the final
    coverage (min over rows of max similarity to the pool).  Scores are
    f32 sums of the rows' products, as the JAX function's
    ``preferred_element_type=f32``; ties go to the lowest row (first
    arg-min).  If pool > n, the tail repeats rows.  Runs on ``emb``'s
    device with no host synchronisation.  The IVF build seeds k-means
    with it too.
    """
    vecs = emb[:n].float()
    dev = vecs.device
    iota = torch.arange(n, device=dev)
    inf = torch.tensor(float("inf"), device=dev)

    def sim_to(idx: torch.Tensor) -> torch.Tensor:
        return vecs @ vecs.index_select(0, idx.view(1))[0]

    first = torch.zeros((), dtype=torch.long, device=dev)
    maxsim = torch.where(iota != first, sim_to(first), inf)
    ents = torch.zeros(pool, dtype=torch.long, device=dev)
    for i in range(1, pool):
        nxt = torch.argmin(maxsim)
        ents[i] = nxt
        maxsim = torch.maximum(maxsim, torch.where(iota != nxt, sim_to(nxt), inf))
    return ents.to(torch.int32), maxsim.min()


@torch.inference_mode()
def pool_take(
    queries: torch.Tensor,    # (B, D) prepped like the walk's queries
    emb: torch.Tensor,
    pool_rows: torch.Tensor,  # (P,) int32, sentinel == pad_global for spares
    *,
    take: int,
    pad_global: int,
) -> torch.Tensor:
    """Top-``take`` pool rows of each query, (B, take) global ids
    (sentinel slots == ``pad_global``): one score of each query against
    the gathered pool rows, the routing step that replaces blind entries."""
    b = queries.shape[0]
    rows = pool_rows.clamp(max=pad_global - 1)[None, :].expand(b, -1)
    s = _row_scores(emb, rows, queries.float())
    s = s.masked_fill(pool_rows[None, :] >= pad_global, NEG_INF)
    top_s, idx = _top(s, take)
    return torch.where(top_s > NEG_INF, pool_rows[idx], pad_global)


def kcenter_rows_host(vecs: np.ndarray, size: int) -> np.ndarray:
    """NumPy twin of :func:`kcenter_rows` for host-side builds."""
    n = vecs.shape[0]
    size = max(1, min(size, n))
    ents = np.empty(size, np.int32)
    ents[0] = 0
    maxsim = vecs @ vecs[0]
    maxsim[0] = np.inf
    for i in range(1, size):
        nxt = int(np.argmin(maxsim))
        ents[i] = nxt
        np.maximum(maxsim, vecs @ vecs[nxt], out=maxsim)
        maxsim[nxt] = np.inf
    return ents


def pool_size_for(n: int) -> int:
    """Default pool size: enough entries that isolated clusters of a few
    hundred rows get their own representative (n/512, clamped for tiny
    and huge corpora)."""
    return max(64, min(4096, n // 512))


# ---------------------------------------------------------------------------
# device walk
# ---------------------------------------------------------------------------


@torch.inference_mode()
def hnsw_walk(
    queries: torch.Tensor,       # (B, D) f32 (int8 corpora: the int8 queries)
    query_filter: torch.Tensor,  # (B, 2) int32
    emb: torch.Tensor,           # corpus rows (shared with the flat index:
                                 #  rows past the graph are never referenced)
    codes: torch.Tensor,         # (2, >= pad_id) filter codes
    adj_pad: torch.Tensor,       # (pad_id+1, M0) int32, pad neighbour == pad_id
    entries: torch.Tensor,       # (E,) int32 shared, or (B, E) seeds a query
    k: int,
    *,
    ef: int,
    steps: int,
    frontier: int,
    pad_id: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched fixed-step beam search.  Returns (scores, rows) (B, k),
    -inf / -1 in empty slots.

    ``pad_id`` is the sentinel candidate id (the graph's row count, or
    the flat capacity for a live native graph).  Every score at the
    sentinel is masked to -inf before it can reach the beam or the
    results, so the row it names may hold anything (or lie past the
    corpus).

    The visited set is a ring of every id that entered the candidates:
    the beam's seeds in its first ``ef`` slots, step t's deduplicated
    candidates at ``ef + t * C``.  A candidate is compared with the slots
    filled so far (the JAX ring's other slots hold only the sentinel,
    which matches only sentinel candidates), one (B, C, filled) boolean a
    step, never materialised as ids.
    """
    b = queries.shape[0]
    n = pad_id
    e = entries.shape[-1]
    m0 = adj_pad.shape[1]
    q = queries.float()
    dev = q.device
    if ef < e:
        raise ValueError(f"ef={ef} must cover the {e} entry nodes")

    def score(ids):  # (B, C) -> (B, C) raw similarity, pad = -inf
        return _row_scores(emb, ids, q).masked_fill(ids == n, NEG_INF)

    tick_q, dt_q = query_filter[:, 0:1], query_filter[:, 1:2]

    def filtered(ids, s):  # mask by each query's metadata filter
        safe = ids.clamp(max=codes.shape[1] - 1).long()
        ok = ((tick_q == -1) | (tick_q == codes[0][safe])) & (
            (dt_q == -1) | (dt_q == codes[1][safe]))
        return s.masked_fill(~ok, NEG_INF)

    # init: the beam and the results seeded from the entry nodes, deduped
    # (descent seeds can repeat the fixed entries, and a duplicate seed
    # would reach the result list twice)
    ent = entries[None, :].expand(b, e) if entries.dim() == 1 else entries
    ent = _dedup_sorted(ent.to(torch.int32), n)
    beam_ids = torch.cat(
        [ent, torch.full((b, ef - e), n, dtype=torch.int32, device=dev)], dim=1)
    beam_s = score(beam_ids)
    expanded = beam_ids == n  # pad slots never expand

    c_w = frontier * m0
    ring = torch.full((b, ef + steps * c_w), n, dtype=torch.int32, device=dev)
    ring[:, :ef] = beam_ids

    ent_f = filtered(beam_ids, beam_s)
    res_s, pos = _top(torch.cat([
        torch.full((b, k), NEG_INF, device=dev), ent_f], dim=1), k)
    res_i = torch.gather(torch.cat([
        torch.full((b, k), -1, dtype=torch.int32, device=dev),
        torch.where(ent_f > NEG_INF, beam_ids, -1)], dim=1), 1, pos)

    for t in range(steps):
        # the best `frontier` unexpanded beam nodes of each query
        top_s, slot = _top(beam_s.masked_fill(expanded, NEG_INF), frontier)
        src = torch.where(top_s > NEG_INF, torch.gather(beam_ids, 1, slot), n)
        expanded = expanded.scatter(1, slot, True)

        # expand: neighbour gather, ring-membership dedup, score
        cand = adj_pad[src.long()].reshape(b, c_w)
        filled = ef + t * c_w
        seen = (cand[:, :, None] == ring[:, None, :filled]).any(dim=2)
        # within-step dedup (two frontier nodes sharing a neighbour);
        # candidate order is irrelevant downstream, every consumer merges
        cand = _dedup_sorted(cand.masked_fill(seen, n), n)
        ring[:, filled : filled + c_w] = cand
        cs = score(cand)

        # result accumulation under the metadata filter
        fs = filtered(cand, cs)
        res_s, pos = _top(torch.cat([res_s, fs], dim=1), k)
        res_i = torch.gather(
            torch.cat([res_i, torch.where(fs > NEG_INF, cand, -1)], dim=1), 1, pos)

        # beam merge on raw similarity: fresh candidates are unexpanded,
        # pads stay expanded
        beam_s, pos = _top(torch.cat([beam_s, cs], dim=1), ef)
        beam_ids = torch.gather(torch.cat([beam_ids, cand], dim=1), 1, pos)
        expanded = torch.gather(torch.cat([expanded, cand == n], dim=1), 1, pos)
    return res_s, res_i


@torch.inference_mode()
def hnsw_routed_walk(
    queries: torch.Tensor,
    query_filter: torch.Tensor,
    emb: torch.Tensor,
    codes: torch.Tensor,
    adj_pad: torch.Tensor,
    entries: torch.Tensor,  # (E,) fixed entries
    pool_rows,              # (P,) int32 or None
    hier,                   # (hi_ids, hi_adj, hi_n) or None
    k: int,
    *,
    ef: int,
    steps: int,
    frontier: int,
    pad_id: int,
    take: int = 0,
    descend: tuple[int, int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pool routing (``take`` > 0), hierarchy descent (``descend`` =
    (beam, steps, frontier)) and the level-0 walk, queued as one device
    sequence: each query's seeds are its pool rows, then its descent
    survivors, then the fixed entries."""
    b = queries.shape[0]
    seeds = []
    if take > 0 and pool_rows is not None:
        seeds.append(pool_take(queries, emb, pool_rows, take=take, pad_global=pad_id))
    if descend is not None and hier is not None:
        d_beam, d_steps, d_frontier = descend
        seeds.append(hier_descend(
            queries, emb, *hier, beam=d_beam, steps=d_steps, frontier=d_frontier,
            pad_global=pad_id,
        ))
    ent = entries
    if seeds:
        seeds.append(entries[None, :].expand(b, entries.shape[0]))
        ent = torch.cat([s.to(torch.int32) for s in seeds], dim=1)
    return hnsw_walk(
        queries, query_filter, emb, codes, adj_pad, ent, k,
        ef=ef, steps=steps, frontier=frontier, pad_id=pad_id,
    )


# ---------------------------------------------------------------------------
# index tier
# ---------------------------------------------------------------------------


class HNSWIndex(SearchMixin):
    """Graph tier built from (and sharing the store of) a FlatIndex.

    The graph lives in ``_graph_state``, one tuple published by a single
    assignment (``adj_pad, entries, pad_id, ef, rows_by_ticker, n_graph,
    hier, pool``, the JAX package's layout), so a concurrent search reads
    one consistent snapshot."""

    def __init__(
        self,
        flat,
        *,
        m: int = 16,
        ef_construction: int = 100,
        ef: int = 64,
        frontier: int = 8,
        steps: int | None = None,
        entries_cap: int = 32,
        seed: int = 0,
        graph: tuple[np.ndarray, np.ndarray] | None = None,
        hier: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None,
        descend_beam: int = 16,
        descend_steps: int = 4,
        descend_frontier: int = 4,
        entry_pool: int | None = None,
        pool_seeds: int = 32,
        pool: tuple[np.ndarray, float] | None = None,
    ):
        self.flat = flat
        self.store = flat.store
        self.device = flat.device
        self.m = m
        self.ef_construction = ef_construction
        self.ef = ef
        self.frontier = frontier
        # upper-level descent (long-range routing): its survivors seed the
        # level-0 walk of each query
        self.descend_beam = descend_beam
        self.descend_steps = descend_steps
        self.descend_frontier = descend_frontier
        # k-center entry pool (coverage-guaranteed seeds)
        self.entry_pool = entry_pool
        self.pool_seeds = pool_seeds
        self._pool_init = pool
        # JAX's defaults: frontier 8, steps = max(8, 2 * ef / frontier)
        # = 16; a wider frontier buys parallel gathers per sequential step
        self.steps = steps if steps is not None else max(8, 2 * ef // frontier)
        self.entries_cap = entries_cap
        self.seed = seed
        self._tail_rows: list[int] = []
        # live native handle (incremental insert); None => tail contract
        self._native = None
        self._native_lock = threading.Lock()
        # seconds of the last build by step (host clock, device synchronised)
        self.build_seconds: dict[str, float] = {}
        if flat.n_valid <= 0:
            raise ValueError("build the flat index first")
        self._graph_state = self._build(graph, hier)

    # -- build ----------------------------------------------------------

    # the exact-kNN fallback is O(N^2) memory; refuse rather than exhaust
    # the serving process when the native builder is unavailable at scale
    MAX_FALLBACK_ROWS = 200_000

    def _lap(self, name: str, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.build_seconds[name] = t1 - t0
        return t1

    def _publish(self, state, native):
        """Publish a freshly built graph: swap the native handle, graph
        snapshot and tail list in ONE ``_native_lock`` critical section.
        The old handle is captured here, so two concurrent rebuilds never
        both close one handle, and ``_online_insert`` (which re-reads
        ``_native`` and ``_graph_state`` under this lock) never sees an
        old snapshot with a new handle."""
        with self._native_lock:
            old_native, self._native = self._native, native
            self._graph_state = state
            self._tail_rows = list(range(state[5], self.flat.n_valid))
            if old_native is not None and old_native is not native:
                old_native.close()
        return state

    def _host_rows(self, start: int, end: int) -> np.ndarray:
        """Rows [start, end) as the native builder takes them: f32 unit
        vectors (an int8 index's rows divided by 127)."""
        vecs = self.flat._emb[start:end].float().cpu().numpy()
        return vecs / 127.0 if self.flat.quantized else vecs

    def _build(self, graph=None, hier=None):
        flat = self.flat
        self.build_seconds = {}
        t0 = time.perf_counter()
        if graph is None:
            n = flat.n_valid
            vecs = self._host_rows(0, n)
            from financial_rag_system_tpu_torch.native.hnsw_loader import (
                build_hnsw_graph_handle,
            )

            native = build_hnsw_graph_handle(
                vecs, m=self.m, ef_construction=self.ef_construction,
                seed=self.seed,
            )
            self.native_built = native is not None
            if native is not None:
                t0 = self._lap("graph", t0)
                return self._publish(self._native_state(native, n, t0), native)
            if n > self.MAX_FALLBACK_ROWS:
                raise RuntimeError(
                    f"native HNSW builder unavailable and the exact-kNN "
                    f"fallback is O(N^2): refusing at {n} rows "
                    f"(> {self.MAX_FALLBACK_ROWS}); install g++ or use "
                    f"the IVF tier"
                )
            graph = build_knn_graph(
                vecs, m=self.m, entries_cap=self.entries_cap, seed=self.seed,
            )
            t0 = self._lap("graph", t0)
        else:
            # loaded graph: it covers the first adj.shape[0] rows; rows
            # upserted after the save become the exactly scored tail
            self.native_built = None
            n = graph[0].shape[0]
        adj, entries = graph
        entries = np.asarray(entries, np.int32)
        # the walk reads the flat index's arrays directly: sentinel id n is
        # score-masked, so no padded corpus copy is made
        adj_np = np.where(adj < 0, n, adj).astype(np.int32)
        hier_dev = None
        if hier is not None:
            # loaded hierarchy: an exact-size pack (no online inserts on a
            # loaded graph, so no slack)
            hi_ids, hi_levels, hi_adj = hier
            hier_dev = pack_hier(
                hi_ids, hi_levels, hi_adj, hc_cap=max(len(hi_ids), 1),
                l_cap=max(hi_adj.shape[0], 1), m=self.m, device=self.device,
            )
            t0 = self._lap("hierarchy", t0)
        pool_state = self._build_pool(n, n, self._pool_init)
        self._pool_init = None
        t0 = self._lap("pool", t0)
        seeds = self.descend_beam if hier is not None else 0
        ef = max(self.ef, int(entries.shape[0]) + seeds + pool_state[3])
        self._host_graph = (np.asarray(adj, np.int32), entries)
        adj_pad = torch.as_tensor(np.concatenate(
            [adj_np, np.full((1, adj_np.shape[1]), n, np.int32)]), device=self.device)
        # inverted lists per ticker code over the graph rows: highly
        # selective filters bypass the walk (see search_device)
        rows_by_ticker = build_ticker_lists(flat, n)
        state = (
            adj_pad, torch.as_tensor(entries, device=self.device), n, ef,
            rows_by_ticker, n, hier_dev, pool_state,
        )
        self._lap("upload", t0)
        return self._publish(state, None)

    def _build_pool(self, n: int, pad_id: int, pool_init=None):
        """K-center entry pool snapshot: ``(rows_dev (P,), tau, live,
        take)``.  ``P`` includes spare sentinel slots, so the online insert
        path can append uncovered rows without a shape change; ``take`` is
        the seed count a query."""
        size = self.entry_pool if self.entry_pool is not None else pool_size_for(n)
        size = max(1, min(size, n))
        if pool_init is not None:
            rows = np.asarray(pool_init[0], np.int32)
            tau = float(pool_init[1])
        else:
            rows_dev, tau_dev = kcenter_rows(self.flat._emb, n, pool=size)
            rows = rows_dev.cpu().numpy()
            # pool > distinct rows: drop repeats, keep first occurrence
            rows = rows[np.sort(np.unique(rows, return_index=True)[1])]
            tau = float(tau_dev)
        live = len(rows)
        p_cap = live + max(64, live // 4)
        full = np.full(p_cap, pad_id, np.int32)
        full[:live] = rows
        self._host_pool = (rows.copy(), tau)
        take = min(self.pool_seeds, live)
        return (torch.as_tensor(full, device=self.device), tau, live, take)

    def _native_state(self, native, n: int, t0: float):
        """Snapshot for a LIVE native graph: the device adjacency is padded
        to the flat capacity, so the sentinel (== capacity) and the shape
        stay constant across incremental inserts; rows in [n, capacity)
        are all-sentinel and unreachable until an insert patches them."""
        flat = self.flat
        cap = flat.capacity
        w = 2 * self.m
        full = native.adjacency()  # (n, w), -1 padded
        ent = native.entries(self.entries_cap)
        # upper-level export at capacity-derived caps: online inserts
        # re-pack the refreshed hierarchy into these same shapes
        hc_cap, l_cap = hier_caps(cap, self.m)
        hier_np = native.hierarchy()
        t0 = self._lap("hierarchy", t0)
        pool_state = self._build_pool(n, cap, self._pool_init)
        self._pool_init = None
        t0 = self._lap("pool", t0)
        adj_np = np.full((cap + 1, w), cap, np.int32)
        adj_np[:n] = np.where(full < 0, cap, full)
        # fixed-width entries, sentinel-padded so re-exports after inserts
        # keep the shape (sentinel seeds score -inf and never expand)
        ent_np = np.full(self.entries_cap, cap, np.int32)
        ent_np[: len(ent)] = ent
        ef = max(self.ef, self.entries_cap + self.descend_beam + pool_state[3])
        self._host_graph = (np.asarray(full, np.int32), np.asarray(ent))
        hier_dev = pack_hier(*hier_np, hc_cap=hc_cap, l_cap=l_cap, m=self.m,
                             device=self.device)
        state = (
            torch.as_tensor(adj_np, device=self.device),
            torch.as_tensor(ent_np, device=self.device), cap, ef,
            build_ticker_lists(flat, n), n, hier_dev, pool_state,
        )
        self._lap("upload", t0)
        return state

    # attribute views over the snapshot
    @property
    def adj_pad(self):
        return self._graph_state[0]

    @property
    def entries(self):
        return self._graph_state[1]

    @property
    def n_graph(self) -> int:
        return self._graph_state[5]

    def rebuild(self) -> None:
        """Fold tail/new rows into a fresh graph.

        The old graph and tail keep serving while the build runs (off the
        GIL in the native library); the handle/snapshot/tail swap is one
        ``_native_lock`` critical section (:meth:`_publish`), and rows
        upserted during the build land in the fresh tail.  With a live
        native handle, rebuild() is optional compaction: online inserts
        keep the graph current.
        """
        self._build()

    @property
    def n_valid(self) -> int:
        return self.flat.n_valid

    # -- query ----------------------------------------------------------

    # a filter matching at most this many graph rows is scored exactly
    # (gather + masked top-k over its inverted list) besides the walk: a
    # result-side-filtered walk loses recall once matching rows are a
    # small fraction of the corpus
    SELECTIVE_LIMIT = 8192

    def search_device(
        self,
        query_vecs: torch.Tensor,
        query_filter: torch.Tensor,
        k: int,
        *,
        host_codes=None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Pool routing, hierarchy descent and the level-0 walk, then
        selective-filter inverted lists and tail rows scored exactly
        (kernel 1), merged without duplicates."""
        state = self._graph_state  # one read
        adj_pad, entries, pad_id, ef, rows_by_ticker, _n, hier, pool = state
        q = walk_queries(query_vecs, self.flat.dtype)
        emb, codes, _ = self.flat._arrays  # live arrays: the walk reads them
        s, i = hnsw_routed_walk(
            q, query_filter, emb, codes, adj_pad, entries,
            pool[0] if pool is not None else None, hier, k,
            ef=ef, steps=self.steps, frontier=self.frontier, pad_id=pad_id,
            take=pool[3] if pool is not None else 0,
            descend=self.descend if hier is not None else None,
        )
        extras = []
        qp = self.flat.prep_queries(query_vecs)  # kernel 1 takes the rows' type
        rows = selective_rows(rows_by_ticker, host_codes, self.SELECTIVE_LIMIT)
        if rows is not None:
            extras.append(score_rows(self.flat, rows, qp, query_filter, k))
        tail = list(self._tail_rows)
        if tail:
            extras.append(score_rows(self.flat, np.asarray(tail), qp, query_filter, k))
        return merge_candidates(s, i, extras, k)

    @property
    def descend(self) -> tuple[int, int, int]:
        return (self.descend_beam, self.descend_steps, self.descend_frontier)

    # -- upserts: online insert with a live native graph, else the tail --

    def upsert(self, ids, vectors, texts, payloads) -> int:
        start = self.flat.n_valid
        added = self.flat.upsert(ids, vectors, texts, payloads)
        end = self.flat.n_valid
        if end == start:
            # pure re-upserts: the flat rows were rewritten, and the walk
            # reads them live
            return added
        if self._online_insert(start, end):
            return added
        self._tail_rows.extend(range(start, end))
        return added

    def _online_insert(self, start: int, end: int) -> bool:
        """Insert rows [start, end) into the live native graph and publish
        a snapshot whose adjacency differs in the changed rows only.
        False => the caller tails them.

        Eligible: a live handle whose node count equals ``start`` (ids
        stay aligned with flat rows) and a flat capacity that still
        matches the snapshot's sentinel (a capacity-growing upsert would
        alias the sentinel with a real row: those rows tail until
        rebuild()).
        """
        if self._native is None:  # cheap pre-check; the read below decides
            return False
        with self._native_lock:
            native = self._native
            if native is None:
                return False
            (adj_pad, _entries, pad_id, ef, rbt, n_graph, hier, pool) = self._graph_state
            if self._tail_rows or n_graph != start or end > pad_id:
                return False
            if self.flat.capacity != pad_id or native.size != start:
                return False
            native.add(self._host_rows(start, end))
            rows, adj_rows = native.drain_dirty()
            ent = native.entries(self.entries_cap)
            # a new adjacency tensor with the changed rows (out of place: a
            # batch in flight keeps its snapshot)
            adj_new = adj_pad.index_copy(
                0, torch.as_tensor(rows, dtype=torch.long, device=self.device),
                torch.as_tensor(np.where(adj_rows < 0, pad_id, adj_rows),
                                device=self.device))
            ent_np = np.full(self.entries_cap, pad_id, np.int32)
            ent_np[: len(ent)] = ent
            # the hierarchy is ~n/m nodes: re-export and re-pack it into the
            # same shapes; on a (statistically negligible) cap overflow keep
            # the old one, the new rows staying reachable at level 0
            if hier is not None:
                try:
                    hier = pack_hier(
                        *native.hierarchy(), hc_cap=hier[0].shape[0] - 1,
                        l_cap=hier[1].shape[0], m=self.m, device=self.device,
                    )
                except ValueError:
                    pass
            # pool coverage: a row less similar to every pool row than the
            # build's coverage radius opens a region the walk cannot route
            # to; it takes a spare sentinel slot of a new pool tensor
            if pool is not None:
                pool_dev, tau, live, take = pool
                host_rows, _ = self._host_pool
                # raw-storage space on both sides: tau came from kcenter_rows
                # over flat._emb (the int8 scale included)
                pv = self.flat._emb[torch.as_tensor(host_rows, dtype=torch.long,
                                                    device=self.device)].float().cpu().numpy()
                nv = self.flat._emb[start:end].float().cpu().numpy()
                cover = (nv @ pv.T).max(axis=1) if len(host_rows) else (
                    np.full(len(nv), -np.inf))
                uncovered = np.where(cover < tau)[0]
                add = [start + int(o) for o in uncovered][: max(0, pool_dev.shape[0] - live)]
                if add:
                    pool_dev = pool_dev.clone()
                    pool_dev[live : live + len(add)] = torch.as_tensor(
                        add, dtype=torch.int32, device=self.device)
                    host_rows = np.append(host_rows, np.asarray(add, np.int32))
                    live += len(add)
                self._host_pool = (host_rows, tau)
                pool = (pool_dev, tau, live, take)
            # extend the inverted ticker lists with the new rows
            new_codes = self.flat._codes[0, start:end].cpu().numpy()
            rbt2 = dict(rbt)
            for code in np.unique(new_codes):
                add_rows = (start + np.where(new_codes == code)[0]).astype(np.int32)
                old = rbt2.get(int(code))
                rbt2[int(code)] = (
                    add_rows if old is None
                    else np.concatenate([old, add_rows]).astype(np.int32)
                )
            self._graph_state = (
                adj_new, torch.as_tensor(ent_np, device=self.device), pad_id, ef,
                rbt2, end, hier, pool,
            )
        return True

    # -- persistence -----------------------------------------------------

    GRAPH_FILE = "hnsw_graph.npz"

    def save(self, directory: str) -> None:
        self.flat.save(directory)
        extra = {}
        # the build's host copy goes stale under online inserts: export the
        # live graph and hierarchy, reading and using the handle under
        # _native_lock (a concurrent rebuild could close it)
        with self._native_lock:
            native = self._native
            if native is not None:
                adj = native.adjacency()
                entries = native.entries(self.entries_cap)
                hi_ids, hi_levels, hi_adj = native.hierarchy()
                extra = dict(hi_ids=hi_ids, hi_levels=hi_levels, hi_adj=hi_adj)
        if not extra:
            adj, entries = self._host_graph
        pool_rows, pool_tau = self._host_pool
        np.savez(
            os.path.join(directory, self.GRAPH_FILE),
            adj=adj, entries=entries, m=self.m, n_graph=self.n_graph,
            pool_rows=pool_rows, pool_tau=pool_tau, **extra,
        )

    @classmethod
    def load(cls, directory: str, flat, **kwargs) -> "HNSWIndex":
        data = np.load(os.path.join(directory, cls.GRAPH_FILE))
        n_graph = int(data["adj"].shape[0])
        if n_graph > flat.n_valid:
            # a graph saved under another corpus would walk rows that no
            # longer exist
            raise ValueError(
                f"{cls.GRAPH_FILE} covers {n_graph} rows but the flat "
                f"index holds only {flat.n_valid} — stale graph"
            )
        hier = None
        if "hi_ids" in data.files:
            hier = (data["hi_ids"], data["hi_levels"], data["hi_adj"])
        pool = None
        if "pool_rows" in data.files:
            pool = (data["pool_rows"], float(data["pool_tau"]))
        idx = cls(
            flat, m=int(data["m"]), graph=(data["adj"], data["entries"]),
            hier=hier, pool=pool, **kwargs,
        )
        # every row past the graph's build is tail, including rows upserted
        # into the flat index after this graph was saved
        idx._tail_rows = list(range(idx.n_graph, flat.n_valid))
        return idx
