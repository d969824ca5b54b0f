"""Mesh-sharded HNSW: one graph per corpus shard, walked shard by shard.

Port of ``financial_rag_system_tpu/index/sharded_hnsw.py``: corpus rows
block-shard over the ``corpus`` mesh axis exactly as in
index/sharded.py, and each shard walks ITS OWN independently built HNSW
graph over its local rows (index/hnsw.py ``hnsw_routed_walk``, seeded by
the shard's own k-center pool) — then the per-shard ``(B, k)`` partials
merge (index/sharded.py ``merge_partials``).  The union of per-shard
top-k holds the global top-k, so the only recall loss is each walk's
own.

Shard-local node ids double as block-offset global rows (global = shard
* per_shard + local), so no id-translation tables exist.  The graphs are
built on the host over the gathered corpus (the port's native builder,
``native/hnsw.cpp``, seed ``seed + shard``), one ``(S, per_shard + 1,
2M)`` adjacency stack whose sentinel row per shard (id == per_shard) is
score-masked inside the walk.

Like the other tiers: post-build upserts land in an exactly scored tail,
selective metadata filters are scored exactly over their inverted lists,
and ``rebuild()`` folds the tail into fresh graphs with a one-tuple
snapshot swap.  If the underlying ShardedFlatIndex *grows* (the block
geometry changes, so node ids no longer map to rows), search falls back
to the exact sharded flat scan until ``rebuild()``.  Persistence is the
JAX package's ``sharded_hnsw_graph.npz``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from financial_rag_system_tpu_torch.index.base import (
    SearchMixin,
    build_ticker_lists,
    merge_candidates,
    score_rows,
    selective_rows,
)
from financial_rag_system_tpu_torch.index.hnsw import (
    build_knn_graph,
    hnsw_routed_walk,
    kcenter_rows_host,
    pool_size_for,
    walk_queries,
)
from financial_rag_system_tpu_torch.index.sharded import merge_partials


class ShardedHNSWIndex(SearchMixin):
    """Graph tier over a ShardedFlatIndex (shares its store and mesh).

    ``_graph_state`` is one tuple, the JAX package's layout: ``(adj,
    entries, per_shard, n_graph, built_capacity, rows_by_ticker, pools,
    pool_take)``, the device parts as tuples of this process's shards."""

    # the exact-kNN fallback build is O(N^2) per shard
    MAX_FALLBACK_ROWS = 200_000
    SELECTIVE_LIMIT = 8192
    GRAPH_FILE = "sharded_hnsw_graph.npz"

    def __init__(
        self,
        sharded_flat,
        *,
        m: int = 16,
        ef_construction: int = 100,
        ef: int = 64,
        frontier: int = 8,
        steps: int | None = None,
        entries_cap: int = 32,
        seed: int = 0,
        graphs: tuple[np.ndarray, np.ndarray] | None = None,
        pools: np.ndarray | None = None,
        pool_seeds: int = 32,
    ):
        self.flat = sharded_flat
        self.mesh = sharded_flat.mesh
        self.store = sharded_flat.store
        self.device = sharded_flat.device
        self.n_shards = sharded_flat.n_shards
        self.m = m
        self.ef_construction = ef_construction
        self.ef = ef
        self.frontier = frontier
        # same default as the single-device tier (index/hnsw.py)
        self.steps = steps if steps is not None else max(8, 2 * ef // frontier)
        self.entries_cap = entries_cap
        self.seed = seed
        self.pool_seeds = pool_seeds
        self._pools_init = pools
        self._tail_rows: list[int] = []
        if sharded_flat.n_valid <= 0:
            raise ValueError("populate the sharded index first")
        self._graph_state = self._build(graphs)

    # -- build ------------------------------------------------------------

    def _shard_rows(self, emb_host: np.ndarray, s: int, per_shard: int) -> np.ndarray:
        return emb_host[s * per_shard : (s + 1) * per_shard]

    def _pools(self, emb_host: np.ndarray, per_shard: int, pool_size: int) -> np.ndarray:
        """Each shard's k-center entry pool (shard-local rows), sentinel
        padded: the outlier-island routing fix, per graph."""
        pools = np.full((self.n_shards, pool_size), per_shard, np.int32)
        for s in range(self.n_shards):
            vecs = self._shard_rows(emb_host, s, per_shard)
            if len(vecs):
                kc = kcenter_rows_host(vecs, pool_size)
                pools[s, : len(kc)] = kc
        return pools

    def _build(self, graphs=None):
        """One-tuple snapshot, read once per search so a concurrent
        rebuild can never mix old node ids with new geometry."""
        from financial_rag_system_tpu_torch.native.hnsw_loader import build_hnsw_graph

        flat = self.flat
        n = flat.n_valid
        capacity = flat.capacity
        per_shard = capacity // self.n_shards
        m0 = 2 * self.m
        pool_size = pool_size_for(per_shard)
        pool_stack = None
        if graphs is None:
            # host copy of the corpus for the native builder (a gather
            # across processes when the mesh spans them)
            emb_host = flat.host_rows(n)
            adj_stack = np.full((self.n_shards, per_shard + 1, m0), per_shard, np.int32)
            ent_stack = np.full((self.n_shards, self.entries_cap), per_shard, np.int32)
            for s in range(self.n_shards):
                vecs = self._shard_rows(emb_host, s, per_shard)
                local_n = len(vecs)
                if local_n == 0:
                    continue
                graph = build_hnsw_graph(
                    vecs, m=self.m, ef_construction=self.ef_construction,
                    seed=self.seed + s, entries_cap=self.entries_cap,
                )
                if graph is None:
                    if local_n > self.MAX_FALLBACK_ROWS:
                        raise RuntimeError(
                            f"native HNSW builder unavailable and the exact-kNN "
                            f"fallback is O(N^2) — refusing at {local_n} rows a "
                            f"shard; use the sharded IVF tier"
                        )
                    graph = build_knn_graph(vecs, m=self.m, entries_cap=self.entries_cap,
                                            seed=self.seed + s)
                adj, entries = graph
                w = min(adj.shape[1], m0)
                adj_stack[s, :local_n, :w] = np.where(adj[:, :w] < 0, per_shard, adj[:, :w])
                ent_stack[s, : entries.shape[0]] = entries
            pool_stack = self._pools(emb_host, per_shard, pool_size)
        else:
            adj_stack, ent_stack = graphs
            if adj_stack.shape[1] != per_shard + 1:
                raise ValueError(
                    f"graph stack covers {adj_stack.shape[1] - 1} rows a shard but "
                    f"the flat index blocks at {per_shard} — mesh or capacity "
                    f"changed since save; rebuild()"
                )
            if self._pools_init is not None and self._pools_init.shape[0] == self.n_shards:
                pool_stack = np.asarray(self._pools_init, np.int32)
        if pool_stack is None:
            # loaded stack without pools: resample from the host corpus
            pool_stack = self._pools(flat.host_rows(n), per_shard, pool_size)
        self._host_graphs = (np.asarray(adj_stack, np.int32), np.asarray(ent_stack, np.int32))
        self._host_pools = pool_stack
        local = [(self.mesh.shard_index(i), dev) for i, dev in enumerate(self.mesh.devices)]
        adj_dev = tuple(torch.as_tensor(self._host_graphs[0][g], device=d) for g, d in local)
        ent_dev = tuple(torch.as_tensor(self._host_graphs[1][g], device=d) for g, d in local)
        pool_dev = tuple(torch.as_tensor(pool_stack[g], device=d) for g, d in local)
        pool_take = min(self.pool_seeds, pool_size)
        return (adj_dev, ent_dev, per_shard, n, capacity, build_ticker_lists(flat, n),
                pool_dev, pool_take)

    @property
    def n_graph(self) -> int:
        return self._graph_state[3]

    @property
    def n_valid(self) -> int:
        return self.flat.n_valid

    def rebuild(self) -> None:
        """Old graphs serve during the build; one-tuple swap at the end."""
        state = self._build()
        self._graph_state, self._tail_rows = state, list(range(state[3], self.flat.n_valid))

    # -- query ------------------------------------------------------------

    def search_device(
        self, query_vecs, query_filter, k: int, *, host_codes=None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        state = self._graph_state  # one atomic read
        adj, entries, per_shard, _n, built_cap, rbt, pools, pool_take = state
        if self.flat.capacity != built_cap:
            # the flat index grew: node ids no longer map to rows.  Exact
            # sharded scan until rebuild() — slower, never wrong.
            return self.flat.search_device(query_vecs, query_filter, k, host_codes=host_codes)
        q = self.flat._home(query_vecs, torch.float32)
        qf = self.flat._home(query_filter, torch.int32)
        qw = walk_queries(q, self.flat.dtype)
        emb, codes, _ = self.flat._arrays  # the walk reads the live rows
        ef = max(self.ef, self.entries_cap + pool_take)
        scores, ids = [], []
        for i, dev in enumerate(self.mesh.devices):
            s, r = hnsw_routed_walk(
                qw.to(dev), qf.to(dev), emb[i], codes[i], adj[i], entries[i], pools[i],
                None, k, ef=ef, steps=self.steps, frontier=self.frontier,
                pad_id=per_shard, take=pool_take,
            )
            scores.append(s)
            ids.append(torch.where(r >= 0, r + self.flat.shard_base(i), -1))
        s, i = merge_partials(self.mesh, scores, ids, k)
        extras = []
        qp = self.flat.prep_queries(q)  # kernel 1 takes the rows' type
        rows = selective_rows(rbt, host_codes, self.SELECTIVE_LIMIT)
        if rows is not None:
            extras.append(score_rows(self.flat, rows, qp, qf, k))
        if self._tail_rows:
            extras.append(score_rows(self.flat, np.asarray(self._tail_rows), qp, qf, k))
        return merge_candidates(s, i, extras, k)

    # -- upserts go to the tail until rebuild -------------------------------

    def upsert(self, ids, vectors, texts, payloads) -> int:
        # re-upserted ids update the flat rows in place and the walk reads
        # them live; only NEW rows (unreachable from the frozen adjacency)
        # need the tail.  A capacity-growing upsert invalidates the graphs;
        # search detects that through built_capacity and falls back.
        start = self.flat.n_valid
        added = self.flat.upsert(ids, vectors, texts, payloads)
        self._tail_rows.extend(range(start, self.flat.n_valid))
        return added

    # -- persistence --------------------------------------------------------

    def save(self, directory: str) -> None:
        self.flat.save(directory)  # gathers across processes; rank 0 writes
        if self.mesh.rank != 0:
            return
        adj_stack, ent_stack = self._host_graphs
        np.savez(
            os.path.join(directory, self.GRAPH_FILE),
            adj=adj_stack, entries=ent_stack, m=self.m,
            n_graph=self.n_graph, pools=self._host_pools,
        )

    @classmethod
    def load(cls, directory: str, sharded_flat, **kwargs) -> "ShardedHNSWIndex":
        data = np.load(os.path.join(directory, cls.GRAPH_FILE))
        n_graph = int(data["n_graph"])
        if n_graph > sharded_flat.n_valid:
            raise ValueError(
                f"{cls.GRAPH_FILE} covers {n_graph} rows but the flat index "
                f"holds only {sharded_flat.n_valid} — stale graph"
            )
        idx = cls(
            sharded_flat, m=int(data["m"]),
            graphs=(data["adj"], data["entries"]),
            pools=data["pools"] if "pools" in data.files else None,
            **kwargs,
        )
        # _build trusted the stack's geometry; pin the row count it covers
        state = idx._graph_state
        idx._graph_state = state[:3] + (n_graph,) + state[4:]
        idx._tail_rows = list(range(n_graph, sharded_flat.n_valid))
        return idx
