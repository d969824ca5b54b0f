"""Key masks for the pair-attention tests, shared by the CPU and card files.

numpy only, so the card tests import it where JAX is not installed.
"""

from __future__ import annotations

import numpy as np


def rerank_mask(p, s, lq=32, seed=0):
    """Key masks laid out as the rerank pairs are (``ops/fused_query.py
    _assemble_pairs``): query tokens, a zero-padded hole up to ``lq``,
    document tokens, tail padding up to ``s``."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((p, s), np.int32)
    for i in range(p):
        mask[i, :rng.integers(3, lq + 1)] = 1
        mask[i, lq:lq + rng.integers(1, s - lq + 1)] = 1
    return mask


def holes_mask(p, s, seed=0):
    """Non-prefix masks: random holes, and a pair (the first) whose valid
    keys are two short runs far apart."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((p, s)) < 0.7).astype(np.int32)
    mask[0] = 0
    mask[0, 5:9] = 1
    mask[0, s - 3:s - 1] = 1
    return mask


def prefix_mask(s, kends):
    """One pair a kend: keys below it valid; kend 0 is a fully masked pair."""
    return (np.arange(s)[None, :] < np.asarray(kends)[:, None]).astype(np.int32)


def segment_mask(p, s, ids, seed=0):
    """Segment ids in runs: each pair cut at random points into runs of 1 to
    s // 3 positions, each run one of ``ids`` (a pair may repeat an id in
    runs apart)."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((p, s), np.int32)
    for i in range(p):
        pos = 0
        while pos < s:
            run = int(rng.integers(1, max(2, s // 3)))
            mask[i, pos:pos + run] = rng.choice(ids)
            pos += run
    return mask
