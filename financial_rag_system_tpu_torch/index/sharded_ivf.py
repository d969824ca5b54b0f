"""Mesh-sharded IVF: sub-linear probing per shard + all-gather merge.

Port of ``financial_rag_system_tpu/index/sharded_ivf.py``: corpus rows
shard over the ``corpus`` mesh axis (index/sharded.py) AND each shard
probes only its top-nprobe clusters (index/ivf.py).

- **One global codebook.** k-center init over every valid row, then
  spherical k-means on a corpus-wide sample; the centroids are
  replicated, so every shard probes the *same* cluster ids and the probe
  list is computed once a batch, on the home device.  Every process
  gathers the same rows and computes the same codebook.
- **Shard-local packing.** Each shard packs ITS rows cluster-major with
  a fixed per-cluster capacity ``c_max``, in tensors of its own on its
  device (``K * c_max`` rows a shard), so a cluster's tile index is the
  same on every shard.  A shard with no rows packs padding only.
- **Query**: the probed-tiles kernel (kernel 3 on the card) on every
  shard's packing with the one probe list, then the merge of the
  per-shard ``(B, k)`` partials (index/sharded.py ``merge_partials``).
- Overflow rows (a cluster fuller than ``c_max`` on a shard) and
  post-build upserts live in a tail scored exactly (kernel 1 over the
  gathered rows), as are selective filters; ``rebuild()`` folds them in.
"""

from __future__ import annotations

import numpy as np
import torch

from financial_rag_system_tpu_torch.index.base import (
    SearchMixin,
    build_ticker_lists,
    merge_candidates,
    score_rows,
    selective_rows,
)
from financial_rag_system_tpu_torch.index.flat import _round_up
from financial_rag_system_tpu_torch.index.hnsw import kcenter_rows
from financial_rag_system_tpu_torch.index.ivf import ivf_probe, probe_tile_list, spherical_kmeans
from financial_rag_system_tpu_torch.index.sharded import merge_partials
from financial_rag_system_tpu_torch.index.store import PAD_CODE


class ShardedIVFIndex(SearchMixin):
    """IVF tier over a ShardedFlatIndex (shares its store and mesh).

    ``_state`` is one tuple, the JAX package's layout: ``(centroids,
    packed_emb, packed_codes, packed_gids, rows_by_ticker, geom, pos)``,
    the packed tensors as tuples of this process's shards, ``geom =
    (c_max, tiles_per_cluster, packed_local, num_tiles_local)`` and
    ``pos`` the host map from a global row to its global packed position
    (-1 for the tail)."""

    KMEANS_SAMPLE = 131072
    SELECTIVE_LIMIT = 8192

    def __init__(
        self,
        sharded_flat,
        *,
        n_clusters: int | None = None,
        nprobe: int = 8,
        tile: int = 128,
        kmeans_iters: int = 10,
    ):
        self.flat = sharded_flat
        self.mesh = sharded_flat.mesh
        self.store = sharded_flat.store
        self.dtype = sharded_flat.dtype
        self.device = sharded_flat.device
        self.tile = tile
        self.n_shards = sharded_flat.n_shards
        n = sharded_flat.n_valid
        if n <= 0:
            raise ValueError("populate the sharded flat index first")
        self.n_clusters = min(n, n_clusters or max(4, int(np.sqrt(n / 4))))
        self.nprobe = min(nprobe, self.n_clusters)
        self.kmeans_iters = kmeans_iters
        self._state, self._tail_rows = self._build()

    # -- build ------------------------------------------------------------

    def _codebook(self, n: int) -> tuple[torch.Tensor, np.ndarray]:
        """(centroids (K, D) f32, assignment (n,)) of the global rows: the
        k-center init over every valid row, Lloyd iterations on a sample
        (all rows up to ``KMEANS_SAMPLE``), a chunked assignment."""
        vecs = self.flat.gathered(0)[:n].float()  # int8 rows widen to their values
        kc, _ = kcenter_rows(vecs, n, pool=self.n_clusters)
        init = vecs[kc.long()]
        init = init / torch.linalg.norm(init, dim=1, keepdim=True).clamp_min(1e-6)
        sample = np.sort(np.random.default_rng(0).choice(
            n, min(n, self.KMEANS_SAMPLE), replace=False))
        cent, _ = spherical_kmeans(
            vecs[torch.as_tensor(sample, device=vecs.device)], self.n_clusters,
            iters=self.kmeans_iters, init_cent=init,
        )
        assign = torch.cat([
            (vecs[s : s + self.KMEANS_SAMPLE] @ cent.T).argmax(dim=1)
            for s in range(0, n, self.KMEANS_SAMPLE)
        ])
        return cent, assign.cpu().numpy()

    def _build(self):
        """Returns (state, tail) for an atomic snapshot swap — concurrent
        searches must never pair an old packing with new centroids or
        geometry."""
        flat = self.flat
        n = flat.n_valid
        rows_per_shard = flat.per_shard
        cent, assign = self._codebook(n)
        # unit-norm centroid values: an int8 cast would truncate them, so
        # an int8 index keeps bf16 centroids (as a bf16 one does)
        centroids = cent.to(torch.bfloat16)

        # per-shard cluster-major packing positions (host arithmetic; the
        # scatter below stays shard-local)
        shard_of = np.arange(n) // rows_per_shard
        counts = np.zeros((self.n_shards, self.n_clusters), np.int64)
        for s in range(self.n_shards):
            counts[s] = np.bincount(assign[shard_of == s], minlength=self.n_clusters)
        avg = max(1, int(counts.mean() * 2))
        c_max = _round_up(avg, self.tile)
        tiles_per_cluster = c_max // self.tile
        packed_local = self.n_clusters * c_max  # rows a shard

        pos = np.full(n, -1, np.int64)
        tail: list[int] = []
        for s in range(self.n_shards):
            rows = np.nonzero(shard_of == s)[0]
            a = assign[rows]
            order = np.argsort(a, kind="stable")
            sorted_a = a[order]
            starts = np.concatenate([[0], np.cumsum(counts[s])[:-1]])
            within = np.arange(rows.shape[0]) - starts[sorted_a]
            keep = within < c_max
            pos[rows[order[keep]]] = s * packed_local + sorted_a[keep] * c_max + within[keep]
            tail.extend(int(r) for r in rows[order[~keep]])

        emb, codes, _ = flat._arrays
        p_emb, p_codes, p_gids = [], [], []
        for i, dev in enumerate(self.mesh.devices):
            g = self.mesh.shard_index(i)
            mine = np.nonzero((pos >= g * packed_local) & (pos < (g + 1) * packed_local))[0]
            lp = torch.as_tensor(pos[mine] - g * packed_local, device=dev)
            lr = torch.as_tensor(mine - g * rows_per_shard, device=dev)
            pe = torch.zeros((packed_local, flat.dim), dtype=self.dtype, device=dev)
            pe[lp] = emb[i][lr]
            pc = torch.full((2, packed_local), PAD_CODE, dtype=torch.int32, device=dev)
            pc[:, lp] = codes[i][:, lr]
            pg = torch.full((1, packed_local), -1, dtype=torch.int32, device=dev)
            pg[0, lp] = torch.as_tensor(mine, dtype=torch.int32, device=dev)
            p_emb.append(pe)
            p_codes.append(pc)
            p_gids.append(pg)
        geom = (c_max, tiles_per_cluster, packed_local, packed_local // self.tile)
        state = (centroids, tuple(p_emb), tuple(p_codes), tuple(p_gids),
                 build_ticker_lists(flat, n), geom, pos)
        return state, tail

    # attribute views over the atomic snapshot
    @property
    def centroids(self):
        return self._state[0]

    @property
    def packed_emb(self):
        return self._state[1]

    @property
    def packed_codes(self):
        return self._state[2]

    @property
    def packed_gids(self):
        return self._state[3]

    @property
    def c_max(self) -> int:
        return self._state[5][0]

    @property
    def tiles_per_cluster(self) -> int:
        return self._state[5][1]

    @property
    def packed_local(self) -> int:
        return self._state[5][2]

    @property
    def num_tiles_local(self) -> int:
        return self._state[5][3]

    def rebuild(self) -> None:
        """Old packing serves during the build; one-tuple swap."""
        self._state, self._tail_rows = self._build()

    @property
    def n_valid(self) -> int:
        return self.flat.n_valid

    # -- query ------------------------------------------------------------

    def search_device(
        self, query_vecs, query_filter, k: int, *, host_codes=None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The probe list once, kernel 3 on every shard's packing, the
        merge; then selective filters and the tail scored exactly."""
        state = self._state  # one atomic read
        centroids, p_emb, p_codes, p_gids, rbt, geom, _ = state
        _c_max, tiles_per_cluster, _packed_local, num_tiles_local = geom
        tail = list(self._tail_rows)
        q = self.flat.prep_queries(self.flat._home(query_vecs, torch.float32))
        qf = self.flat._home(query_filter, torch.int32)
        nprobe = self.nprobe  # snapshot: mutable tuning attribute
        budget = min(num_tiles_local, q.shape[0] * nprobe * tiles_per_cluster)
        tile_ids = probe_tile_list(q, centroids, nprobe=nprobe, tpc=tiles_per_cluster,
                                   budget=budget)
        scores, ids = [], []
        for i, dev in enumerate(self.mesh.devices):
            s, r = ivf_probe(q.to(dev), qf.to(dev), p_emb[i], p_codes[i], p_gids[i],
                             tile_ids.to(dev), k, tile=self.tile)
            scores.append(s)
            ids.append(r)  # packed gids are global rows already
        s, i = merge_partials(self.mesh, scores, ids, k)
        extras = []
        # same cardinality strategy as the single-device tiers: selective
        # filters are scored exactly (their rows gather across shards)
        rows = selective_rows(rbt, host_codes, self.SELECTIVE_LIMIT)
        if rows is not None:
            extras.append(score_rows(self.flat, rows, q, qf, k))
        if tail:
            extras.append(score_rows(self.flat, np.asarray(tail), q, qf, k))
        return merge_candidates(s, i, extras, k)

    # -- upserts go to the tail until rebuild ------------------------------

    def upsert(self, ids, vectors, texts, payloads) -> int:
        existing = [self.store.id_to_row[p] for p in ids if p in self.store.id_to_row]
        start = self.flat.n_valid
        added = self.flat.upsert(ids, vectors, texts, payloads)
        self._tail_rows.extend(range(start, self.flat.n_valid))
        if existing:
            # re-upserted rows: the flat arrays hold the fresh embedding
            # but the packed copy is stale — mask the packed slot and
            # serve the row from the exactly scored tail until rebuild()
            state = self._state
            row_to_pos = state[6]
            masked = [r for r in existing if r < len(row_to_pos) and row_to_pos[r] >= 0]
            if masked:
                self._tail_rows.extend(masked)  # tail first: seen twice, never not at all
                packed_local = state[5][2]
                for i, dev in enumerate(self.mesh.devices):
                    g = self.mesh.shard_index(i)
                    slots = [int(row_to_pos[r]) - g * packed_local for r in masked
                             if row_to_pos[r] // packed_local == g]
                    if slots:
                        state[3][i][0, torch.as_tensor(slots, device=dev)] = -1
                rtp = row_to_pos.copy()
                rtp[masked] = -1
                self._state = state[:6] + (rtp,)
        return added
