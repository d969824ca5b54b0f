"""ctypes binding for the native HNSW graph builder (hnsw.cpp).

Port of ``financial_rag_system_tpu/native/hnsw_loader.py``, with the
tokenizer loader's build-on-demand pattern: the shared library compiles
with g++ from the port's own ``hnsw.cpp`` at first use into
``build/native/`` (never beside the source).  Returns the arrays the
device walk consumes (level-0 adjacency, entry nodes, the upper-level
hierarchy) or None when native code is unavailable (callers fall back
to the exact-kNN builder in index/hnsw.py, up to its row limit).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from financial_rag_system_tpu_torch.native.loader import (
    BUILD_DIR,
    SRC_DIR,
    load_library,
    native_enabled,
)

_SRC = SRC_DIR / "hnsw.cpp"
_LIB = BUILD_DIR / "libfrs_hnsw.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_failed = False


def _get_lib() -> ctypes.CDLL | None:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    if not native_enabled():
        _build_failed = True
        return None
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        lib = load_library(_SRC, _LIB)
        if lib is None:
            _build_failed = True
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.frs_hnsw_build.restype = ctypes.c_void_p
        lib.frs_hnsw_build.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint, ctypes.c_int,
        ]
        lib.frs_hnsw_max_level.restype = ctypes.c_int
        lib.frs_hnsw_max_level.argtypes = [ctypes.c_void_p]
        lib.frs_hnsw_adjacency0.restype = ctypes.c_int
        lib.frs_hnsw_adjacency0.argtypes = [ctypes.c_void_p, i32p]
        lib.frs_hnsw_entries.restype = ctypes.c_int
        lib.frs_hnsw_entries.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int]
        lib.frs_hnsw_add.restype = ctypes.c_int
        lib.frs_hnsw_add.argtypes = [
            ctypes.c_void_p, f32p, ctypes.c_int, ctypes.c_int,
        ]
        lib.frs_hnsw_size.restype = ctypes.c_int
        lib.frs_hnsw_size.argtypes = [ctypes.c_void_p]
        lib.frs_hnsw_dirty.restype = ctypes.c_int
        lib.frs_hnsw_dirty.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int]
        lib.frs_hnsw_rows.restype = ctypes.c_int
        lib.frs_hnsw_rows.argtypes = [
            ctypes.c_void_p, i32p, ctypes.c_int, i32p,
        ]
        lib.frs_hnsw_levels.restype = ctypes.c_int
        lib.frs_hnsw_levels.argtypes = [ctypes.c_void_p, i32p]
        lib.frs_hnsw_adjacency_l.restype = ctypes.c_int
        lib.frs_hnsw_adjacency_l.argtypes = [
            ctypes.c_void_p, ctypes.c_int, i32p, ctypes.c_int, i32p,
        ]
        lib.frs_hnsw_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class NativeHnswGraph:
    """A live native HNSW handle supporting O(log N) incremental insert.

    Where :func:`build_hnsw_graph` builds, exports, and destroys, this
    class RETAINS the handle so post-build upserts enter the graph via
    the concurrent insert path (hnsw.cpp frs_hnsw_add) instead of piling
    into a brute-forced tail until a full rebuild (Qdrant's online
    upsert semantics — reference ingest.py:171-175).  ``drain_dirty``
    returns exactly the level-0 rows whose neighbor lists changed since
    the last drain, so the caller patches only those rows of the
    device-resident adjacency.

    Not thread-safe; callers serialize access (index/hnsw.py holds a
    lock around add/drain).
    """

    def __init__(self, lib: ctypes.CDLL, handle: int, m: int):
        self._lib = lib
        self._handle = handle
        self.m = m

    @property
    def size(self) -> int:
        return self._lib.frs_hnsw_size(self._handle)

    def add(self, vecs: np.ndarray, *, n_threads: int = 0) -> int:
        """Insert rows; new node ids continue from the current size."""
        v = np.ascontiguousarray(vecs, np.float32)
        out = self._lib.frs_hnsw_add(
            self._handle,
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            v.shape[0], n_threads,
        )
        if out < 0:
            raise RuntimeError("frs_hnsw_add failed")
        return out

    def drain_dirty(self) -> tuple[np.ndarray, np.ndarray]:
        """(rows, adjacency (len(rows), 2M) int32 -1-padded) changed since
        the last drain; clears the dirty set."""
        i32p = ctypes.POINTER(ctypes.c_int32)
        count = self._lib.frs_hnsw_dirty(self._handle, None, 0)
        if count <= 0:
            return (np.empty(0, np.int32), np.empty((0, 2 * self.m), np.int32))
        rows = np.empty(count, np.int32)
        got = self._lib.frs_hnsw_dirty(
            self._handle, rows.ctypes.data_as(i32p), count
        )
        rows = rows[:got]
        adj = np.empty((got, 2 * self.m), np.int32)
        self._lib.frs_hnsw_rows(
            self._handle, rows.ctypes.data_as(i32p), got,
            adj.ctypes.data_as(i32p),
        )
        return rows, adj

    def entries(self, cap: int) -> np.ndarray:
        i32p = ctypes.POINTER(ctypes.c_int32)
        ent = np.empty(cap, np.int32)
        cnt = self._lib.frs_hnsw_entries(
            self._handle, ent.ctypes.data_as(i32p), cap
        )
        return ent[:cnt].copy()

    def adjacency(self) -> np.ndarray:
        i32p = ctypes.POINTER(ctypes.c_int32)
        n = self.size
        adj = np.empty((n, 2 * self.m), np.int32)
        self._lib.frs_hnsw_adjacency0(self._handle, adj.ctypes.data_as(i32p))
        return adj

    def levels(self) -> np.ndarray:
        """Per-node top level, (n,) int32."""
        i32p = ctypes.POINTER(ctypes.c_int32)
        out = np.empty(self.size, np.int32)
        self._lib.frs_hnsw_levels(self._handle, out.ctypes.data_as(i32p))
        return out

    def adjacency_at(self, level: int, nodes: np.ndarray) -> np.ndarray:
        """Adjacency at ``level`` (>= 1) for the listed GLOBAL node ids:
        (len(nodes), m) int32, -1 padded, neighbor ids global.  Nodes
        whose top level is below ``level`` come back all-pad."""
        i32p = ctypes.POINTER(ctypes.c_int32)
        nd = np.ascontiguousarray(nodes, np.int32)
        out = np.empty((len(nd), self.m), np.int32)
        w = self._lib.frs_hnsw_adjacency_l(
            self._handle, level, nd.ctypes.data_as(i32p), len(nd),
            out.ctypes.data_as(i32p),
        )
        if w < 0:
            raise ValueError(f"bad level {level}")
        return out

    def max_level(self) -> int:
        return self._lib.frs_hnsw_max_level(self._handle)

    def hierarchy(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Full upper-level export for the device descent.

        Returns ``(hi_ids, hi_levels, hi_adj)``:

        - ``hi_ids``  (H,) int32 — global ids of every node whose top
          level is >= 1, sorted by level DESCENDING (global entry
          first); H ~ n/m under geometric level sampling.
        - ``hi_levels`` (H,) int32 — top level per hi node (same order).
        - ``hi_adj`` (L, H, m) int32 — adjacency per level l in [1, L]
          (index 0 <=> level 1), neighbor ids HI-LOCAL (position within
          ``hi_ids``), -1 padded.  Because hi_ids is level-sorted, every
          valid neighbor at level l has hi-local id < count(level>=l):
          rows for nodes below the level are all-pad.
        """
        lv = self.levels()
        hi_ids = np.where(lv >= 1)[0].astype(np.int32)
        order = np.argsort(-lv[hi_ids], kind="stable")
        hi_ids = hi_ids[order]
        hi_levels = lv[hi_ids]
        lmax = int(hi_levels[0]) if len(hi_ids) else 0
        # global -> hi-local translation for adjacency values
        g2l = np.full(self.size, -1, np.int32)
        g2l[hi_ids] = np.arange(len(hi_ids), dtype=np.int32)
        layers = []
        for level in range(1, lmax + 1):
            adj = self.adjacency_at(level, hi_ids)
            adj = np.where(adj >= 0, g2l[np.maximum(adj, 0)], -1)
            layers.append(adj)
        hi_adj = (
            np.stack(layers)
            if layers
            else np.empty((0, len(hi_ids), self.m), np.int32)
        )
        return hi_ids, hi_levels, hi_adj

    def close(self) -> None:
        if self._handle:
            self._lib.frs_hnsw_destroy(self._handle)
            self._handle = 0

    def __del__(self):  # pragma: no cover — GC backstop
        try:
            self.close()
        except Exception:
            pass


def build_hnsw_graph_handle(
    vecs: np.ndarray,
    *,
    m: int = 16,
    ef_construction: int = 100,
    seed: int = 0,
    n_threads: int = 0,
) -> NativeHnswGraph | None:
    """Native build that RETAINS the handle for incremental insert.
    Returns None when native code is unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(vecs, np.float32)
    n, d = v.shape
    handle = lib.frs_hnsw_build(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, d, m, ef_construction, seed, n_threads,
    )
    if not handle:
        return None
    return NativeHnswGraph(lib, handle, m)


def build_hnsw_graph(
    vecs: np.ndarray,
    *,
    m: int = 16,
    ef_construction: int = 100,
    seed: int = 0,
    entries_cap: int = 64,
    n_threads: int = 0,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Native HNSW build. vecs (N, D) float32 L2-normalized.

    n_threads=0 uses all hardware threads (striped-lock concurrent
    insertion).  Returns (adjacency0 (N, 2M) int32 with -1 padding,
    entries (E,) int32) or None when the native library is unavailable.
    """
    lib = _get_lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(vecs, np.float32)
    n, d = v.shape
    handle = lib.frs_hnsw_build(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, d, m, ef_construction, seed, n_threads,
    )
    if not handle:
        return None
    try:
        adj = np.empty((n, 2 * m), np.int32)
        lib.frs_hnsw_adjacency0(
            handle, adj.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        )
        ent = np.empty(entries_cap, np.int32)
        cnt = lib.frs_hnsw_entries(
            handle, ent.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            entries_cap,
        )
        return adj, ent[:cnt].copy()
    finally:
        lib.frs_hnsw_destroy(handle)
