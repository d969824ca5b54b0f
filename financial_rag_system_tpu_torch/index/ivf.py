"""IVF (inverted-file) index tier for million-chunk corpora.

Port of ``financial_rag_system_tpu/index/ivf.py``, the sub-linear tier
that ``RAGEngine.rebuild_index`` promotes a flat corpus to:

- **Build**: k-center init over the full corpus (:mod:`index.hnsw`),
  spherical k-means (Lloyd iterations: assignment is one product and an
  arg-max, the update a one-hot product) on a 131,072-row sample, then a
  chunked assignment of every row, all on the device.
- **Layout**: cluster-major packing with a fixed capacity ``c_max`` per
  cluster (a multiple of the tile), so cluster membership maps to tile
  ids statically.  Rows that overflow their cluster spill to a flat
  *tail* that is scored exactly.
- **Query**: score queries against the centroids, take each query's
  top-``nprobe`` clusters, build the batch-union tile list padded to a
  fixed budget without a host sync (:func:`probe_tile_list`), then the
  probed-tiles kernel (:func:`ivf_probe`: ``csrc/ivf_probe.cu`` on the
  card) reads only those tiles.
- **int8 corpora**: over an int8 flat index the packing is int8 and
  the centroids stay bf16; the probe list scores the int8 queries
  widened to f32 against them, and kernel 3 scores int8 rows exactly.
- **Upserts** are online: a new row goes to a free slot of its nearest
  centroid's packed block, so the next search sees it; a full block
  spills it to the tail, and churn triggers rebuild automatically
  (:meth:`IVFIndex._maintenance_due`).

Unlike the JAX package's immutable arrays, online upserts write the
packed tensors in place (no copy of a 1.6 GB packing per ingest): the
row, its codes, then its gid, so a concurrent search on the same stream
sees either the masked old slot or the whole new row.  Rebuilds build
new tensors and swap the ``_state`` tuple.  Persistence is the JAX
package's ``ivf_index.npz``, so either package loads the other's index.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from financial_rag_system_tpu_torch.index.base import (
    SearchMixin,
    build_ticker_lists,
    merge_candidates,
    score_rows,
    selective_rows,
)
from financial_rag_system_tpu_torch.index.hnsw import kcenter_rows
from financial_rag_system_tpu_torch.index.store import PAD_CODE
from financial_rag_system_tpu_torch.ops import _cuda
from financial_rag_system_tpu_torch.ops.topk import (
    NEG_INF,
    TILE_ROWS,
    WIDE_ABOVE_D,
    TopkPlan,
    _match_mask,
    _scores,
    check_dims,
    plan_for,
)

# ---------------------------------------------------------------------------
# k-means build
# ---------------------------------------------------------------------------


def spherical_kmeans(
    vecs: torch.Tensor, k: int, *, iters: int = 10, seed: int = 0,
    init_cent: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cosine k-means. vecs (N, D) L2-normalized. Returns (centroids, assign).

    ``init_cent`` (k, D) overrides the random-row init (which draws from a
    ``torch.Generator``, so it differs from the JAX package's draw).  The
    Lloyd step keeps a centroid whose cluster goes empty, so k-center init
    points covering clusters absent from a training sample survive.
    Arg-max ties go to the lowest cluster, as ``jnp.argmax``.
    """
    n, d = vecs.shape
    if init_cent is not None:
        cent = init_cent.to(vecs.dtype)
    else:
        gen = torch.Generator().manual_seed(seed)
        cent = vecs[torch.randperm(n, generator=gen)[:k].to(vecs.device)]
    x = vecs.float()
    for _ in range(iters):
        assign = (x @ cent.float().T).argmax(dim=1)
        onehot = torch.zeros((n, k), dtype=torch.float32, device=x.device)
        onehot.scatter_(1, assign[:, None], 1.0)
        sums = onehot.T @ x
        norms = torch.linalg.norm(sums, dim=1, keepdim=True)
        # keep the old centroid when a cluster went empty
        cent = torch.where(
            norms > 1e-6, sums / norms.clamp_min(1e-6), cent.float()
        ).to(vecs.dtype)
    return cent, (x @ cent.float().T).argmax(dim=1)


# ---------------------------------------------------------------------------
# probe list and the probed-tiles kernel
# ---------------------------------------------------------------------------


def _unique_padded(x: torch.Tensor, size: int) -> torch.Tensor:
    """Sorted distinct values of the 1-D ``x``, -1 padded (or cut) to
    ``size``: ``jnp.unique(x, size=size, fill_value=-1)``.  A sort, an
    adjacent-difference mask and a fixed-size scatter, so unlike
    ``torch.unique`` it never synchronises with the device."""
    v = torch.sort(x).values
    first = torch.cat([v.new_ones(1, dtype=torch.bool), v[1:] != v[:-1]])
    slot = torch.where(first, torch.cumsum(first, 0) - 1, size).clamp_max(size)
    out = torch.full((size + 1,), -1, dtype=x.dtype, device=x.device)
    out.scatter_(0, slot, v)  # every dropped value lands in the spare slot
    return out[:size].to(torch.int32)


def probe_tile_list(
    queries: torch.Tensor, centroids: torch.Tensor, *, nprobe: int, tpc: int,
    budget: int,
) -> torch.Tensor:
    """Batch-union probed tile ids, ascending, -1 padded to ``budget``.
    Each query probes its ``nprobe`` best clusters by f32 centroid score;
    equal scores go to the lower cluster, as ``lax.top_k``."""
    scores = queries.float() @ centroids.float().T
    clusters = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :nprobe]
    tiles = clusters[..., None] * tpc + torch.arange(tpc, device=clusters.device)
    return _unique_padded(tiles.reshape(-1), budget)


def ivf_probe_plain(
    queries: torch.Tensor,        # (B, D)
    query_filter: torch.Tensor,   # (B, 2) int32
    packed_emb: torch.Tensor,     # (K_cl * C_max, D)
    packed_codes: torch.Tensor,   # (2, K_cl * C_max) int32
    packed_gids: torch.Tensor,    # (1, K_cl * C_max) int32, -1 = padding
    tile_ids: torch.Tensor,       # (P,) int32, ascending, -1 = inactive
    k: int,
    *,
    tile: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (the port of ``ivf_probe_xla``): gather the
    probed tiles, score (exact products of bf16 or int8 values, f32 sums,
    or exact int8 sums cast to f32 once), mask and take the top k with a
    stable sort, so equal scores go to the earlier position of the
    ascending probe list — the lower packed position.  Empty slots are
    -inf / -1, also past the probed rows when k exceeds them."""
    dev = packed_emb.device
    t = tile_ids.clamp_min(0).long()
    offs = (t[:, None] * tile + torch.arange(tile, device=dev)).reshape(-1)
    active = (tile_ids >= 0)[:, None].expand(-1, tile).reshape(-1)
    pos = torch.where(active, offs, torch.zeros_like(offs))
    emb = packed_emb[pos]
    gids = torch.where(active, packed_gids[0, pos], torch.full_like(pos, -1, dtype=torch.int32))
    scores = _scores(queries, emb)
    match = _match_mask(packed_codes[:, pos], query_filter) & (gids[None, :] >= 0)
    scores = torch.where(match, scores, torch.full_like(scores, NEG_INF))
    top_s, top_pos = torch.sort(scores, dim=1, descending=True, stable=True)
    top_s, top_pos = top_s[:, :k], top_pos[:, :k]
    top_i = torch.where(top_s > NEG_INF, gids[top_pos], torch.full_like(top_pos, -1, dtype=torch.int32))
    if top_s.shape[1] < k:
        pad = k - top_s.shape[1]
        top_s = torch.nn.functional.pad(top_s, (0, pad), value=NEG_INF)
        top_i = torch.nn.functional.pad(top_i, (0, pad), value=-1)
    return top_s, top_i.to(torch.int32)


@functools.lru_cache(maxsize=256)
def probe_plan(b: int, n_probe: int, tile: int, d: int, elt: int, k: int, sms: int) -> TopkPlan:
    """Kernel 3's plan for ``b`` queries over a probe list of ``n_probe``
    entries of ``tile`` rows, ``d`` values of ``elt`` bytes a row.  How many
    entries are active is known only on the card, where each block finds
    it and takes an even share of the active tiles' 64-row pieces; the plan
    sizes the grid, and the select path's score table, for the whole
    list (the wide kernel's above WIDE_ABOVE_D values)."""
    return plan_for(b, n_probe * (tile // TILE_ROWS), d * elt, k, sms, ivf=True,
                    wide=d > WIDE_ABOVE_D)


@functools.cache
def _library():
    lib = _cuda.library("ivf_probe")
    for fn in (lib.ivf_probe, lib.ivf_probe_s8):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    return lib


def ivf_probe_cuda(
    queries, query_filter, packed_emb, packed_codes, packed_gids, tile_ids, k,
    *, tile,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/ivf_probe.cu`` on the current stream (as
    ``masked_topk_cuda`` launches kernel 1).
    ``tile_ids`` lists the active tile ids first, then -1s, as
    :func:`probe_tile_list` makes it."""
    b, d = queries.shape
    n_packed = packed_emb.shape[0]
    dev = packed_emb.device
    if packed_emb.dtype not in (torch.bfloat16, torch.int8) or queries.dtype != packed_emb.dtype:
        raise ValueError(f"ivf_probe takes bf16 or int8 queries and packing of one type, "
                         f"got {queries.dtype} and {packed_emb.dtype}")
    check_dims(d, packed_emb.shape[1], packed_emb.dtype)
    if tile % TILE_ROWS or n_packed % tile:
        raise ValueError(f"tile {tile} must be a multiple of 64 dividing {n_packed}")
    if packed_codes.shape != (2, n_packed) or packed_codes.dtype != torch.int32:
        raise ValueError(f"packed_codes must be (2, {n_packed}) int32")
    if packed_gids.shape != (1, n_packed) or packed_gids.dtype != torch.int32:
        raise ValueError(f"packed_gids must be (1, {n_packed}) int32")
    if query_filter.shape != (b, 2) or query_filter.dtype != torch.int32:
        raise ValueError(f"query_filter must be ({b}, 2) int32")
    if tile_ids.dim() != 1 or tile_ids.dtype != torch.int32 or tile_ids.numel() < 1:
        raise ValueError("tile_ids must be a non-empty 1-D int32 tensor")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    for t in (queries, query_filter, packed_emb, packed_codes, packed_gids, tile_ids):
        if t.get_device() != dev.index or not t.is_contiguous():
            raise ValueError("inputs must be contiguous and on one CUDA device")
    if any(t.data_ptr() % 16 for t in (queries, packed_emb, packed_codes, packed_gids)):
        raise ValueError("queries and packing must be 16-byte aligned")
    n_probe = tile_ids.numel()
    plan = probe_plan(b, n_probe, tile, d, packed_emb.element_size(), k, _cuda.sm_count(dev))
    lib = _library()
    out = torch.empty((2, b, k), dtype=torch.float32, device=dev)  # scores, then ids
    with _cuda.on_device(dev):
        scratch = _cuda.stream_scratch(dev, plan.scratch)
        _cuda.launch(
            lib.ivf_probe_s8 if packed_emb.dtype == torch.int8 else lib.ivf_probe,
            "ivf_probe", queries.data_ptr(), packed_emb.data_ptr(), packed_codes.data_ptr(),
            packed_gids.data_ptr(), tile_ids.data_ptr(), query_filter.data_ptr(),
            b, d, n_packed, tile, n_probe, k, plan.blocks, plan.stages, scratch.data_ptr(),
            out.data_ptr(),
        )
    with _launch_lock:  # batches run in worker threads
        if plan.wide:
            ivf_probe.launches_wide += 1
        elif plan.path == "select":
            ivf_probe.launches_select += 1
        elif packed_emb.dtype == torch.int8:
            ivf_probe.launches_int8 += 1
        else:
            ivf_probe.launches += 1
    return out[0], out[1].view(torch.int32)


def ivf_probe(
    queries, query_filter, packed_emb, packed_codes, packed_gids, tile_ids, k,
    *, tile,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Probed-tiles masked top-k over the cluster-major packing: (B, k)
    f32 scores and int32 row ids.  The CUDA kernel for a CUDA packing,
    the plain version for a CPU packing; nothing else."""
    args = (queries, query_filter, packed_emb, packed_codes, packed_gids, tile_ids, k)
    if packed_emb.device.type == "cpu":
        return ivf_probe_plain(*args, tile=tile)
    if packed_emb.device.type != "cuda":
        raise ValueError(f"unsupported device {packed_emb.device}")
    _cuda.refuse_grad("ivf_probe", queries, packed_emb)
    return ivf_probe_cuda(*args, tile=tile)


# kernel launches since the last reset, by branch (chip_smoke.py reads
# and resets them)
ivf_probe.launches = 0
ivf_probe.launches_int8 = 0
ivf_probe.launches_select = 0
ivf_probe.launches_wide = 0
_launch_lock = threading.Lock()


def ivf_probe_search(
    queries, query_filter, centroids, packed_emb, packed_codes, packed_gids, k,
    *, tile, budget, nprobe, tpc,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Centroid scoring, probe-list union and the probe kernel, queued on
    the device with no host sync in between."""
    tile_ids = probe_tile_list(
        queries, centroids, nprobe=nprobe, tpc=tpc, budget=budget
    )
    return ivf_probe(
        queries, query_filter, packed_emb, packed_codes, packed_gids,
        tile_ids, k, tile=tile,
    )


# ---------------------------------------------------------------------------
# index
# ---------------------------------------------------------------------------


class IVFGeometry(NamedTuple):
    """Codebook and packing sizes of one build."""

    n_clusters: int
    nprobe: int
    c_max: int
    tiles_per_cluster: int

    @property
    def num_tiles(self) -> int:
        return self.n_clusters * self.tiles_per_cluster


class IVFState(NamedTuple):
    """One build's snapshot, published by a single assignment so a
    concurrent search never pairs one build's packing with another's
    geometry.  Online upserts fill ``packed_*`` in place and extend
    ``tail``; everything else is replaced by ``_replace``."""

    centroids: torch.Tensor
    packed_emb: torch.Tensor
    packed_codes: torch.Tensor
    packed_gids: torch.Tensor
    rows_by_ticker: dict
    assign: np.ndarray
    row_to_pos: np.ndarray
    fill: np.ndarray
    geom: IVFGeometry
    tail: list


class IVFIndex(SearchMixin):
    """Sub-linear tier built from (and sharing the store of) a FlatIndex."""

    # filters matching at most this many packed rows bypass probing and
    # are scored exactly over their inverted list (see search_device)
    SELECTIVE_LIMIT = 8192
    # Lloyd iterations run on at most this many sampled rows; the full
    # corpus then gets one assignment pass, in chunks of this many rows
    KMEANS_SAMPLE = 131072
    KMEANS_ITERS = 10
    IVF_FILE = "ivf_index.npz"

    def __init__(
        self,
        flat,
        *,
        n_clusters: int | None = None,
        c_max: int | None = None,
        nprobe: int | None = None,
        tile: int = 128,
        auto_rebuild_tail_frac: float = 0.10,
        auto_rebuild_growth_frac: float = 0.50,
    ):
        self._attach(flat, tile)
        # churn triggers (see _maintenance_due); <= 0 disables one
        self.auto_rebuild_tail_frac = auto_rebuild_tail_frac
        self.auto_rebuild_growth_frac = auto_rebuild_growth_frac
        n = flat.n_valid
        if n <= 0:
            raise ValueError("build the flat index first")
        # explicit geometry pins across rebuilds; auto (None) re-derives
        # from the current corpus size at every (re)build
        self._want_clusters = n_clusters
        self._want_cmax = c_max
        self._want_nprobe = nprobe
        self._state = self._build()
        self._built_n = len(self._state.assign)  # rows covered at last build

    def _attach(self, flat, tile: int) -> None:
        self.flat = flat
        self.store = flat.store
        self.dtype = flat.dtype
        self.device = flat.device
        self.tile = tile
        self._upsert_lock = threading.Lock()
        # seconds of the last build by step (host clock, device synchronised)
        self.build_seconds: dict[str, float] = {}

    # -- build ----------------------------------------------------------

    def _derive_geometry(self, n: int) -> IVFGeometry:
        """Size the codebook/packing for an n-row corpus — pinned
        dimensions (explicit constructor args) stay put."""
        n_clusters = min(n, self._want_clusters or max(4, int(np.sqrt(n / 4))))
        # the default probe width keeps probing 1/32 of a large codebook
        nprobe = (
            self._want_nprobe
            if self._want_nprobe is not None
            else max(8, n_clusters // 32)
        )
        avg = max(1, n // n_clusters)
        want = self._want_cmax or 2 * avg
        c_max = ((want + self.tile - 1) // self.tile) * self.tile
        return IVFGeometry(n_clusters, min(nprobe, n_clusters), c_max, c_max // self.tile)

    def _lap(self, name: str, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.build_seconds[name] = t1 - t0
        return t1

    def _build(self):
        """k-means + packing; returns the new state for an atomic swap.
        The geometry stays local until then: the live index keeps serving
        the old one."""
        flat = self.flat
        n = flat.n_valid
        geom = self._derive_geometry(n)
        self.build_seconds = {}
        t0 = time.perf_counter()
        # an int8 index's rows widen to their integer values, as in JAX
        # (ivf.py:424): k-means is scale-free and its centroids unit-norm
        vecs = flat._emb[:n].float()
        # k-center init over the FULL corpus (not the Lloyd sample): the
        # farthest-point sweep reaches small outlier clusters a random
        # sample misses, and spherical_kmeans keeps a centroid whose
        # sample-cluster is empty
        kc, _ = kcenter_rows(vecs, n, pool=geom.n_clusters)
        init = vecs[kc.long()]
        init = init / torch.linalg.norm(init, dim=1, keepdim=True).clamp_min(1e-6)
        t0 = self._lap("kcenter", t0)
        if n > self.KMEANS_SAMPLE:
            sample = np.random.default_rng(0).choice(n, self.KMEANS_SAMPLE, replace=False)
            cent, _ = spherical_kmeans(
                vecs[torch.as_tensor(sample, device=vecs.device)], geom.n_clusters,
                iters=self.KMEANS_ITERS, init_cent=init,
            )
            t0 = self._lap("lloyd", t0)
            # chunked assignment: the full (N, K) score matrix would be
            # 2 GB at 1M rows and 512 clusters
            assign = torch.cat([
                (vecs[s : s + self.KMEANS_SAMPLE] @ cent.T).argmax(dim=1)
                for s in range(0, n, self.KMEANS_SAMPLE)
            ])
            t0 = self._lap("assign", t0)
        else:
            cent, assign = spherical_kmeans(
                vecs, geom.n_clusters, iters=self.KMEANS_ITERS, init_cent=init,
            )
            t0 = self._lap("lloyd", t0)
        del vecs
        # only the (N,) assignment and the centroids cross to the host; the
        # corpus is packed on the device by a scatter
        out = self._pack(assign.cpu().numpy(), cent.float().cpu().numpy(), geom)
        self._lap("pack", t0)
        return out

    def _pack(self, assign: np.ndarray, cent: np.ndarray, geom: IVFGeometry) -> IVFState:
        """Cluster-major packing of rows [0, len(assign)) from an
        assignment vector — shared by fresh builds and persisted loads."""
        flat = self.flat
        dev = self.device
        n = assign.shape[0]
        assign = assign.astype(np.int32)
        # bf16 centroids for a bf16 and an int8 index alike: an int8 cast
        # would truncate unit-norm values to about zero (JAX ivf.py:486-490)
        centroids = torch.as_tensor(cent, device=dev).to(torch.bfloat16)
        rows_by_ticker = build_ticker_lists(flat, n)
        c_max = geom.c_max
        packed_n = geom.n_clusters * c_max
        # stable-sort rows by cluster, rank each row within its cluster,
        # spill ranks >= c_max to the tail
        order = np.argsort(assign, kind="stable")
        sorted_assign = assign[order].astype(np.int64)
        counts = np.bincount(assign, minlength=geom.n_clusters)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        within = np.arange(n, dtype=np.int64) - starts[sorted_assign]
        keep = within < c_max
        # host-side row -> packed-position map so upsert() can mask the
        # stale packed copy of a re-upserted row (-1 = tail/overflow)
        row_to_pos = np.full(n, -1, np.int64)
        row_to_pos[order[keep]] = sorted_assign[keep] * c_max + within[keep]
        # cluster-overflow spills plus any rows past the packed range
        # (rows upserted after a persisted build) — all scored exactly
        tail = [int(r) for r in order[~keep]] + list(range(n, flat.n_valid))

        emb, codes, _ = flat._arrays
        rows_kept = torch.as_tensor(order[keep], device=dev)
        pos = torch.as_tensor(row_to_pos[order[keep]], device=dev)
        packed_emb = torch.zeros((packed_n, emb.shape[1]), dtype=self.dtype, device=dev)
        packed_emb[pos] = emb[rows_kept].to(self.dtype)
        packed_codes = torch.full((2, packed_n), PAD_CODE, dtype=torch.int32, device=dev)
        packed_codes[:, pos] = codes[:, rows_kept]
        packed_gids = torch.full((1, packed_n), -1, dtype=torch.int32, device=dev)
        packed_gids[0, pos] = rows_kept.to(torch.int32)
        # per-cluster fill counts: the free-slot map for online upserts
        fill = np.minimum(counts, c_max).astype(np.int32)
        return IVFState(
            centroids, packed_emb, packed_codes, packed_gids,
            rows_by_ticker, assign, row_to_pos, fill, geom, tail,
        )

    # attribute views over the atomic snapshot (a reader that needs two
    # of them together takes ``self._state`` once instead)
    @property
    def centroids(self):
        return self._state.centroids

    @property
    def packed_emb(self):
        return self._state.packed_emb

    @property
    def packed_codes(self):
        return self._state.packed_codes

    @property
    def packed_gids(self):
        return self._state.packed_gids

    @property
    def _rows_by_ticker(self):
        return self._state.rows_by_ticker

    @property
    def _assign(self):
        return self._state.assign

    @property
    def _tail_rows(self) -> list:
        return self._state.tail

    @property
    def n_clusters(self) -> int:
        return self._state.geom.n_clusters

    @property
    def nprobe(self) -> int:
        return self._state.geom.nprobe

    @property
    def c_max(self) -> int:
        return self._state.geom.c_max

    @property
    def tiles_per_cluster(self) -> int:
        return self._state.geom.tiles_per_cluster

    @property
    def num_tiles(self) -> int:
        return self._state.geom.num_tiles

    @property
    def n_valid(self) -> int:
        return self.flat.n_valid

    def rebuild(self) -> None:
        """Fold tail/new rows back into the clustered layout.  The old
        packing keeps serving during the build; the swap runs under the
        upsert lock so a concurrent online insert can never publish into
        a snapshot the rebuild is about to replace (lost update)."""
        with self._upsert_lock:
            self._rebuild_locked()

    def _rebuild_locked(self) -> None:
        self._state = self._build()
        self._built_n = len(self._state.assign)

    def _maintenance_due(self) -> bool:
        """Deterministic churn triggers (checked under ``_upsert_lock``):

        - tail bound: the exactly-scored tail exceeding
          ``auto_rebuild_tail_frac`` of the corpus (with a floor of one
          tile so small indexes don't rebuild on noise) costs latency on
          every search;
        - growth bound: ``auto_rebuild_growth_frac`` net new rows since
          the last k-means means the frozen codebook no longer reflects
          the data even when every row found a packed slot.
        """
        n = self.flat.n_valid
        if (
            self.auto_rebuild_tail_frac > 0
            and len(self._tail_rows) > max(self.tile, int(
                self.auto_rebuild_tail_frac * n))
        ):
            return True
        grown = n - self._built_n
        return (
            self.auto_rebuild_growth_frac > 0
            and grown > self.auto_rebuild_growth_frac * max(self._built_n, 1)
        )

    # -- query ------------------------------------------------------------

    def search_device(
        self, query_vecs: torch.Tensor, query_filter: torch.Tensor, k: int,
        *, host_codes=None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Probe the packing, then score selective-filter inverted lists
        and the tail exactly (kernel 1) and merge the candidate sets."""
        st = self._state  # one atomic read: packing and geometry agree
        geom = st.geom
        tail = list(st.tail)
        b = query_vecs.shape[0]
        budget = min(geom.num_tiles, b * geom.nprobe * geom.tiles_per_cluster)
        q = self.flat.prep_queries(query_vecs)
        s, i = ivf_probe_search(
            q, query_filter, st.centroids, st.packed_emb, st.packed_codes,
            st.packed_gids, k, tile=self.tile, budget=budget, nprobe=geom.nprobe,
            tpc=geom.tiles_per_cluster,
        )
        extras = []
        # selective filters are scored exactly over their inverted lists:
        # cluster probing can miss matching rows in unprobed clusters
        rows = selective_rows(st.rows_by_ticker, host_codes, self.SELECTIVE_LIMIT)
        if rows is not None:
            extras.append(score_rows(self.flat, rows, q, query_filter, k))
        if tail:
            extras.append(score_rows(self.flat, np.asarray(tail), q, query_filter, k))
        return merge_candidates(s, i, extras, k)

    # -- upserts: online cluster placement, tail only on overflow ----------

    def upsert(self, ids, vectors, texts, payloads) -> int:
        existing = [
            self.store.id_to_row[p] for p in ids if p in self.store.id_to_row
        ]
        start = self.flat.n_valid
        added = self.flat.upsert(ids, vectors, texts, payloads)
        end = self.flat.n_valid
        with self._upsert_lock:
            if existing:
                # re-upserted rows: the flat arrays are fresh but the
                # packed copy is stale — mask the packed slot and serve the
                # row from the exactly-scored tail until rebuild()
                state = self._state
                row_to_pos = state.row_to_pos
                masked = [
                    r for r in existing
                    if r < len(row_to_pos) and row_to_pos[r] >= 0
                ]
                if masked:
                    # tail first: a search in between sees the row twice
                    # (merge_candidates dedups), never not at all
                    state.tail.extend(masked)
                    slots = torch.as_tensor(row_to_pos[masked], device=self.device)
                    state.packed_gids[0, slots] = -1
                    rtp = row_to_pos.copy()
                    rtp[masked] = -1
                    self._state = state._replace(row_to_pos=rtp)
            if end > start:
                self._online_insert(start, end)
            if self._maintenance_due():
                self._rebuild_locked()
        return added

    def _online_insert(self, start: int, end: int) -> None:
        """Place rows [start, end) into their nearest centroid's packed
        block where free slots remain (the probed search then sees them
        immediately); overflowing rows spill to the tail.  Runs under
        ``_upsert_lock``."""
        flat = self.flat
        st = self._state
        c_max = st.geom.c_max
        if len(st.assign) != start:
            # a persisted load or racing rebuild left a coverage gap:
            # keep the simple contract for these rows
            st.tail.extend(range(start, end))
            return
        rows = np.arange(start, end)
        emb, codes, _ = flat._arrays
        vecs = emb[start:end].float()
        if flat.quantized:
            vecs = vecs / 127.0  # the JAX package's scale (ivf.py:724-725)
        new_assign = (
            (vecs @ st.centroids.float().T).argmax(dim=1).cpu().numpy().astype(np.int32)
        )
        fill = st.fill.copy()
        new_rtp = np.full(end - start, -1, np.int64)
        placed_idx, positions, tail_new = [], [], []
        for i, c in enumerate(new_assign):
            if fill[c] < c_max:
                positions.append(int(c) * c_max + int(fill[c]))
                placed_idx.append(i)
                new_rtp[i] = positions[-1]
                fill[c] += 1
            else:
                tail_new.append(int(rows[i]))
        if placed_idx:
            pos = torch.as_tensor(positions, dtype=torch.long, device=self.device)
            prows = torch.as_tensor(rows[placed_idx], device=self.device)
            # gids last: a search between these writes sees the slot masked
            st.packed_emb[pos] = emb[prows].to(self.dtype)
            st.packed_codes[:, pos] = codes[:, prows]
            st.packed_gids[0, pos] = prows.to(torch.int32)
        # extend the host-side maps for ALL new rows (merge_candidates
        # dedups, so tail rows in the inverted lists are harmless)
        new_codes = codes[0, start:end].cpu().numpy()
        rbt2 = dict(st.rows_by_ticker)
        for code in np.unique(new_codes):
            add_rows = (start + np.where(new_codes == code)[0]).astype(np.int32)
            old = rbt2.get(int(code))
            rbt2[int(code)] = (
                add_rows if old is None
                else np.concatenate([old, add_rows]).astype(np.int32)
            )
        st.tail.extend(tail_new)
        self._state = st._replace(
            rows_by_ticker=rbt2,
            assign=np.concatenate([st.assign, new_assign]),
            row_to_pos=np.concatenate([st.row_to_pos, new_rtp]),
            fill=fill,
        )

    # -- persistence --------------------------------------------------------

    def save(self, directory: str) -> None:
        """Persist centroids + the row assignment; packing is recomputed
        on load by the same device scatter, skipping k-means."""
        st = self._state
        self.flat.save(directory)
        np.savez(
            os.path.join(directory, self.IVF_FILE),
            centroids=st.centroids.float().cpu().numpy(),
            assign=st.assign,
            c_max=st.geom.c_max,
            tile=self.tile,
            nprobe=st.geom.nprobe,
            n_clusters=st.geom.n_clusters,
        )

    @classmethod
    def load(cls, directory: str, flat) -> "IVFIndex":
        data = np.load(os.path.join(directory, cls.IVF_FILE))
        assign = np.asarray(data["assign"], np.int32)
        if assign.shape[0] > flat.n_valid:
            raise ValueError(
                f"{cls.IVF_FILE} covers {assign.shape[0]} rows but the "
                f"flat index holds only {flat.n_valid} — stale ivf"
            )
        idx = cls.__new__(cls)
        idx._attach(flat, int(data["tile"]))
        c_max = int(data["c_max"])
        geom = IVFGeometry(
            int(data["n_clusters"]), int(data["nprobe"]), c_max, c_max // idx.tile
        )
        idx.auto_rebuild_tail_frac = 0.10
        idx.auto_rebuild_growth_frac = 0.50
        # a later (auto-)rebuild re-derives geometry for the grown corpus
        idx._want_clusters = idx._want_cmax = idx._want_nprobe = None
        idx._state = idx._pack(assign, np.asarray(data["centroids"], np.float32), geom)
        idx._built_n = len(assign)
        return idx
