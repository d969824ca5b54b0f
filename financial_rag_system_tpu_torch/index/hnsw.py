"""Greedy k-center (farthest-point) sampling of corpus rows.

Port of the routing utilities in ``financial_rag_system_tpu/index/hnsw.py``.
The IVF build seeds k-means over the full corpus with ``kcenter_rows``
(:mod:`index.ivf`); ``kcenter_rows_host``, its host-side twin, has no
caller in the port yet: it waits for the sharded HNSW tier, whose router
uses it in the JAX package.  A greedy k-center
sample has a coverage guarantee: every corpus row is within the final
radius of some picked row, and the most isolated clusters are picked
first, so small outlier clusters a random sample would miss get their
own centroid.

The HNSW tier itself (the device walk, the entry pool, the native graph
build and the fused HNSW program) is not ported yet: ROADMAP Queue 1.
"""

from __future__ import annotations

import numpy as np
import torch


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
    device with no host synchronisation.
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
