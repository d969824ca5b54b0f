"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with ``nvcc``; skips without one.  Imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

from __future__ import annotations

import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from financial_rag_system_tpu_torch.index.ivf import ivf_probe, ivf_probe_plain
from financial_rag_system_tpu_torch.ops import fused_bert
from financial_rag_system_tpu_torch.ops.attention import (
    encoder_self_attention,
    encoder_self_attention_plain,
    pair_attention_kernel,
)
from financial_rag_system_tpu_torch.ops.topk import masked_topk, masked_topk_plain
from torch_attn_masks import holes_mask, prefix_mask, rerank_mask

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def topk_case(b, n, d, n_valid, seed=0, n_tickers=5):
    """Unit queries/rows, mixed filters, a sparse ticker and duplicated rows."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    c[n // 2 + 1] = c[n // 2]          # exact duplicates -> tied scores
    c[7] = c[3]
    codes = np.stack([
        rng.integers(0, n_tickers, n), rng.integers(0, 3, n),
    ]).astype(np.int32)
    codes[0, [11, 13, 17]] = n_tickers  # a ticker with fewer than k rows
    codes[:, n_valid:] = -2
    qf = np.stack([
        rng.choice([-1, *range(n_tickers)], b), rng.choice([-1, 0, 1, 2], b),
    ], axis=1).astype(np.int32)
    qf[0] = (-1, -1)
    qf[1] = (n_tickers, -1)
    q[2] = c[n // 2]                    # query 2 hits the duplicated pair
    qf[2] = (-1, -1)
    return q, c, codes, qf


@pytest.mark.parametrize(
    "b,n,d,k", [(8, 4096, 64, 15), (40, 5000, 384, 15), (3, 777, 128, 1),
                (32, 131072, 384, 15), (5, 2048, 64, 32), (8, 4096, 64, 33),
                (40, 5000, 384, 64), (32, 131072, 384, 100), (5, 2048, 64, 256),
                (33, 20000, 384, 1024), (3, 700, 128, 1024), (32, 131072, 384, 2048),
                (3, 700, 128, 2048), (32, 8192, 1536, 15), (5, 2048, 3136, 33)],
)
def test_topk_kernel_matches_plain(cuda, b, n, d, k):
    q, c, codes, qf = topk_case(b, n, d, n_valid=n - 100)
    args = (
        torch.tensor(q, device=cuda).bfloat16(),
        torch.tensor(c, device=cuda).bfloat16(),
        torch.tensor(codes, device=cuda),
        torch.tensor(qf, device=cuda),
        n - 100, k,
    )
    s_ref, i_ref = (x.cpu().numpy() for x in masked_topk_plain(*args))
    s, i = (x.cpu().numpy() for x in masked_topk(*args))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(np.isfinite(s), np.isfinite(s_ref))
    fin = np.isfinite(s_ref)
    np.testing.assert_allclose(s[fin], s_ref[fin], atol=1e-4, rtol=0)
    assert (i[~fin] == -1).all()
    # ids agree wherever no other candidate lies within the score noise
    with np.errstate(invalid="ignore"):  # -inf - -inf in empty slots
        gap = np.abs(s_ref[:, :, None] - s_ref[:, None, :])
    gap[:, np.arange(k), np.arange(k)] = np.inf
    clear = fin & (gap.min(axis=2) > 1e-4)
    np.testing.assert_array_equal(i[clear], i_ref[clear])
    # the duplicated pair ties exactly: lower id first, right after
    if k > 1:
        assert i[2, 0] == n // 2 and i[2, 1] == n // 2 + 1
        assert s[2, 0] == s[2, 1]


def probe_case(b, d, n_tiles, tile, seed=0):
    """A hand-built packing: padding slots, an all-padding tile, gids
    unrelated to packed order, a duplicated row whose packed order is the
    reverse of its gid order, and a probe list with -1 entries."""
    rng = np.random.default_rng(seed)
    n = n_tiles * tile
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    gids = rng.permutation(4 * n)[:n].astype(np.int32)
    gids[rng.random(n) < 0.2] = -1
    gids[2 * tile : 3 * tile] = -1                  # tile 2 holds only padding
    gids[4 * tile : 4 * tile + 64] = -1             # a padding piece before live rows
    codes = np.stack([rng.integers(0, 4, n), rng.integers(0, 3, n)]).astype(np.int32)
    p1, p2 = tile + 5, (n_tiles - 1) * tile + 7     # both in probed tiles
    emb[p2] = emb[p1]
    gids[p1], gids[p2] = 4 * n + 1, 3               # packed order != gid order
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qf = np.stack([rng.choice([-1, 0, 1, 2, 3], b), rng.choice([-1, 0, 1, 2], b)],
                  axis=1).astype(np.int32)
    q[0], qf[0] = emb[p1], (-1, -1)                 # query 0 hits the duplicated pair
    if b > 1:
        qf[1] = (9, -1)                             # a ticker no row carries
    probed = [t for t in range(n_tiles) if t % 4 != 3 or t == n_tiles - 1]
    tile_ids = np.full(len(probed) + 5, -1, np.int32)
    tile_ids[: len(probed)] = probed
    return q, qf, emb, codes, gids[None, :], tile_ids, (gids[p1], gids[p2])


@pytest.mark.parametrize(
    "b,d,n_tiles,tile,k", [(1, 384, 12, 128, 15), (32, 384, 40, 128, 15),
                           (32, 64, 9, 64, 1), (5, 128, 16, 128, 32),
                           (40, 384, 20, 256, 15), (32, 384, 40, 128, 33),
                           (5, 128, 16, 128, 100), (40, 384, 20, 256, 256),
                           (33, 384, 64, 128, 1024), (33, 384, 64, 128, 2048),
                           (32, 1536, 40, 128, 15), (5, 3136, 16, 128, 33)],
)
def test_ivf_probe_kernel_matches_plain(cuda, b, d, n_tiles, tile, k):
    q, qf, emb, codes, gids, tile_ids, dup = probe_case(b, d, n_tiles, tile)
    args = (
        torch.tensor(q, device=cuda).bfloat16(), torch.tensor(qf, device=cuda),
        torch.tensor(emb, device=cuda).bfloat16(), torch.tensor(codes, device=cuda),
        torch.tensor(gids, device=cuda), torch.tensor(tile_ids, device=cuda), k,
    )
    s_ref, i_ref = (x.cpu().numpy() for x in ivf_probe_plain(*args, tile=tile))
    s, i = (x.cpu().numpy() for x in ivf_probe(*args, tile=tile))
    torch.cuda.synchronize()
    fin = np.isfinite(s_ref)
    np.testing.assert_array_equal(np.isfinite(s), fin)
    np.testing.assert_allclose(s[fin], s_ref[fin], atol=1e-4, rtol=0)
    assert (i[~fin] == -1).all()
    with np.errstate(invalid="ignore"):  # -inf - -inf in empty slots
        gap = np.abs(s_ref[:, :, None] - s_ref[:, None, :])
    gap[:, np.arange(k), np.arange(k)] = np.inf
    clear = fin & (gap.min(axis=2) > 1e-4)
    np.testing.assert_array_equal(i[clear], i_ref[clear])
    if b > 1:
        assert not fin[1].any()  # the filter matches nothing
    if k > 1:  # the tie goes to the lower packed position, not the lower gid
        assert (i[0, 0], i[0, 1]) == dup and s[0, 0] == s[0, 1]
        assert (i_ref[0, 0], i_ref[0, 1]) == dup


def test_ivf_probe_kernel_rejects_inputs(cuda):
    q, qf, emb, codes, gids, tile_ids, _ = probe_case(2, 64, 4, 64)
    args = [torch.tensor(a, device=cuda) for a in (q, qf, emb, codes, gids, tile_ids)]
    with pytest.raises(ValueError, match="bf16"):
        ivf_probe(*args, 5, tile=64)  # f32 queries and packing
    args[0], args[2] = args[0].bfloat16(), args[2].bfloat16()
    with pytest.raises(ValueError, match="k must be"):
        ivf_probe(*args, 0, tile=64)
    with pytest.raises(ValueError, match="tile"):
        ivf_probe(*args, 5, tile=96)


def quant(a):
    """Unit rows as an int8 index stores them: round(v * 127), +-127."""
    return np.clip(np.rint(a * 127.0), -127, 127).astype(np.int8)


@pytest.mark.parametrize(
    "b,n,d,k", [(8, 4096, 64, 15), (40, 5000, 384, 15), (3, 777, 1024, 1),
                (32, 131072, 384, 15), (5, 2048, 64, 32), (33, 1500, 1024, 32),
                (8, 4096, 64, 33), (40, 5000, 384, 64), (32, 131072, 384, 100),
                (5, 2048, 64, 256), (33, 20000, 384, 1024), (3, 700, 1024, 1024),
                (32, 131072, 384, 2048), (32, 8192, 1536, 15), (5, 2048, 6272, 33)],
)
def test_topk_int8_kernel_equals_plain(cuda, b, n, d, k):
    """The int8 branch of kernel 1 gives its plain version's scores and
    ids bit for bit: integer sums are exact in any order, and both break
    ties on the lower row (the duplicated pair, and every tie of the
    coarse int8 scores)."""
    q, c, codes, qf = topk_case(b, n, d, n_valid=n - 100)
    args = (torch.tensor(quant(q), device=cuda), torch.tensor(quant(c), device=cuda),
            torch.tensor(codes, device=cuda), torch.tensor(qf, device=cuda), n - 100, k)
    n0 = masked_topk.launches_int8
    s, i = (x.cpu().numpy() for x in masked_topk(*args))
    torch.cuda.synchronize()
    assert masked_topk.launches_int8 == n0 + 1
    s_ref, i_ref = (x.cpu().numpy() for x in masked_topk_plain(*args))
    assert s.tobytes() == s_ref.tobytes() and i.tobytes() == i_ref.tobytes()
    if k > 1:
        assert i[2, 0] == n // 2 and i[2, 1] == n // 2 + 1 and s[2, 0] == s[2, 1]


@pytest.mark.parametrize(
    "b,d,n_tiles,tile,k", [(1, 384, 12, 128, 15), (32, 384, 40, 128, 15),
                           (32, 64, 9, 64, 1), (5, 1024, 16, 128, 32),
                           (40, 384, 20, 256, 15), (32, 384, 40, 128, 33),
                           (5, 1024, 16, 128, 100), (40, 384, 20, 256, 256),
                           (33, 384, 64, 128, 1024), (33, 384, 64, 128, 2048),
                           (32, 1536, 40, 128, 15), (5, 6272, 16, 128, 33)],
)
def test_ivf_probe_int8_kernel_equals_plain(cuda, b, d, n_tiles, tile, k):
    """The int8 branch of kernel 3 against its plain version, bit for bit;
    ties go to the lower packed position."""
    q, qf, emb, codes, gids, tile_ids, dup = probe_case(b, d, n_tiles, tile)
    args = (torch.tensor(quant(q), device=cuda), torch.tensor(qf, device=cuda),
            torch.tensor(quant(emb), device=cuda), torch.tensor(codes, device=cuda),
            torch.tensor(gids, device=cuda), torch.tensor(tile_ids, device=cuda), k)
    n0 = ivf_probe.launches_int8
    s, i = (x.cpu().numpy() for x in ivf_probe(*args, tile=tile))
    torch.cuda.synchronize()
    assert ivf_probe.launches_int8 == n0 + 1
    s_ref, i_ref = (x.cpu().numpy() for x in ivf_probe_plain(*args, tile=tile))
    assert s.tobytes() == s_ref.tobytes() and i.tobytes() == i_ref.tobytes()
    if k > 1:
        assert (i[0, 0], i[0, 1]) == dup and s[0, 0] == s[0, 1]


def test_int8_kernels_reject_inputs(cuda):
    """D must be a multiple of 32 for the int8 branches (16 suffices for
    bf16), and queries and corpus must share a type."""
    q, c, codes, qf = topk_case(4, 256, 48, n_valid=256)
    codes_t, qf_t = torch.tensor(codes, device=cuda), torch.tensor(qf, device=cuda)
    masked_topk(torch.tensor(q, device=cuda).bfloat16(), torch.tensor(c, device=cuda).bfloat16(),
                codes_t, qf_t, 256, 5)
    with pytest.raises(ValueError, match="32"):
        masked_topk(torch.tensor(quant(q), device=cuda), torch.tensor(quant(c), device=cuda),
                    codes_t, qf_t, 256, 5)
    q, c, codes, qf = topk_case(4, 256, 64, n_valid=256)
    with pytest.raises(ValueError, match="!="):
        masked_topk(torch.tensor(q, device=cuda).bfloat16(), torch.tensor(quant(c), device=cuda),
                    torch.tensor(codes, device=cuda), torch.tensor(qf, device=cuda), 256, 5)
    q, qf, emb, codes, gids, tile_ids, _ = probe_case(2, 80, 4, 64)
    rest = [torch.tensor(a, device=cuda) for a in (codes, gids, tile_ids)]
    qf_t = torch.tensor(qf, device=cuda)
    with pytest.raises(ValueError, match="32"):
        ivf_probe(torch.tensor(quant(q), device=cuda), qf_t,
                  torch.tensor(quant(emb), device=cuda), *rest, 5, tile=64)
    q, qf, emb, codes, gids, tile_ids, _ = probe_case(2, 64, 4, 64)
    rest = [torch.tensor(a, device=cuda) for a in (codes, gids, tile_ids)]
    with pytest.raises(ValueError, match="one type"):
        ivf_probe(torch.tensor(q, device=cuda).bfloat16(), torch.tensor(qf, device=cuda),
                  torch.tensor(quant(emb), device=cuda), *rest, 5, tile=64)


# -- kernels 1 and 3 on exact, tie-heavy inputs: both branches bit for bit --

RETRIEVAL_TYPES = [torch.bfloat16, torch.int8]


def exact_rows(rng, n, d, distinct):
    """n rows drawn from `distinct` integer vectors with entries in -3..3:
    their dot products are exact in bf16 (as v / 16) with f32 sums and in
    int8 with s32 sums, in any order, so both branches meet their plain
    versions bit for bit, and repeated rows tie for real around the k-th."""
    return rng.integers(-3, 4, (distinct, d))[rng.integers(0, distinct, n)]


def exact_tensor(a, dtype, dev):
    if dtype == torch.int8:
        return torch.tensor(a.astype(np.int8), device=dev)
    return torch.tensor(a.astype(np.float32) / 16, device=dev).bfloat16()


def exact_topk_args(dtype, dev, b, n, d, n_valid, k, seed=0):
    rng = np.random.default_rng(seed)
    q, c = exact_rows(rng, b, d, 3), exact_rows(rng, n, d, 6)
    codes = np.stack([rng.integers(0, 3, n), rng.integers(0, 2, n)]).astype(np.int32)
    codes[:, n_valid:] = -2
    qf = np.stack([rng.choice([-1, 0, 1, 2], b), rng.choice([-1, 0, 1], b)],
                  axis=1).astype(np.int32)
    qf[0] = (-1, -1)
    return (exact_tensor(q, dtype, dev), exact_tensor(c, dtype, dev),
            torch.tensor(codes, device=dev), torch.tensor(qf, device=dev), n_valid, k)


def assert_same_bits(got, ref):
    s, i = (x.cpu().numpy() for x in got)
    s_ref, i_ref = (x.cpu().numpy() for x in ref)
    assert s.tobytes() == s_ref.tobytes() and i.tobytes() == i_ref.tobytes()
    return s, i


@pytest.mark.parametrize("dtype", RETRIEVAL_TYPES)
@pytest.mark.parametrize(
    "b,n,d,k", [(1, 777, 64, 1), (33, 5000, 128, 16), (65, 777, 384, 17),
                (33, 5000, 64, 32), (3, 3000, 1024, 15), (65, 40000, 384, 15),
                (33, 5000, 64, 33), (65, 777, 384, 100), (3, 3000, 1024, 1024),
                (33, 40000, 128, 256)],
)
def test_topk_kernel_tie_heavy_bit_for_bit(cuda, dtype, b, n, d, k):
    """Six distinct rows repeated over every block's share (N 777 leaves
    the codes' second row off 16-byte alignment), queries across several
    query blocks: scores and ids bit for bit, ties in ascending row order."""
    args = exact_topk_args(dtype, cuda, b, n, d, n - 3, k)
    s, i = assert_same_bits(masked_topk(*args), masked_topk_plain(*args))
    tied = s[0][:-1] == s[0][1:]
    assert np.isfinite(s[0]).all() and (np.diff(i[0])[tied] > 0).all()


@pytest.mark.parametrize("dtype", RETRIEVAL_TYPES)
@pytest.mark.parametrize("n_valid", [0, 1])
def test_topk_kernel_few_valid_rows(cuda, dtype, n_valid):
    args = exact_topk_args(dtype, cuda, 5, 777, 64, n_valid, 15)
    s, i = assert_same_bits(masked_topk(*args), masked_topk_plain(*args))
    assert np.isfinite(s).sum(axis=1).max() <= n_valid and (i[~np.isfinite(s)] == -1).all()


@pytest.mark.parametrize("dtype", RETRIEVAL_TYPES)
def test_topk_kernel_every_query_filtered_out(cuda, dtype):
    q, c, codes, qf, n_valid, k = exact_topk_args(dtype, cuda, 33, 5000, 64, 5000, 15)
    qf = torch.full_like(qf, 7)  # a ticker and a doc type no row carries
    s, i = assert_same_bits(masked_topk(q, c, codes, qf, n_valid, k),
                            masked_topk_plain(q, c, codes, qf, n_valid, k))
    assert np.isneginf(s).all() and (i == -1).all()


def exact_probe_args(dtype, dev, b, d, n_tiles, tile, which, k, seed=0):
    """A packing of exact rows: 30% padding slots, an all-padding tile, a
    padding-only 64-row piece before live rows, gids unrelated to packed
    order; the probe list as probe_tile_list makes it (active ids
    ascending, then -1): every tile, one, none, or 37 of them."""
    rng = np.random.default_rng(seed)
    n = n_tiles * tile
    emb = exact_rows(rng, n, d, 5)
    gids = rng.permutation(4 * n)[:n].astype(np.int32)
    gids[rng.random(n) < 0.3] = -1
    gids[2 * tile: 3 * tile] = -1
    gids[4 * tile: 4 * tile + 64] = -1
    codes = np.stack([rng.integers(0, 3, n), rng.integers(0, 2, n)]).astype(np.int32)
    q = exact_rows(rng, b, d, 4)
    qf = np.stack([rng.choice([-1, 0, 1, 2], b), rng.choice([-1, 0, 1], b)],
                  axis=1).astype(np.int32)
    qf[0] = (-1, -1)
    if which == "some":
        active = sorted(rng.choice(n_tiles, 37, replace=False).tolist())
    else:
        active = {"all": list(range(n_tiles)), "one": [n_tiles // 2], "none": []}[which]
    tile_ids = np.full(n_tiles + 3, -1, np.int32)
    tile_ids[: len(active)] = active
    return (exact_tensor(q, dtype, dev), torch.tensor(qf, device=dev),
            exact_tensor(emb, dtype, dev), torch.tensor(codes, device=dev),
            torch.tensor(gids[None, :], device=dev), torch.tensor(tile_ids, device=dev), k)


@pytest.mark.parametrize("dtype", RETRIEVAL_TYPES)
@pytest.mark.parametrize("tile", [64, 128, 256])
@pytest.mark.parametrize("which", ["all", "one", "none", "some"])
def test_ivf_probe_kernel_tie_heavy_bit_for_bit(cuda, dtype, tile, which):
    """Kernel 3 on tie-heavy exact rows, over lists of every active count
    (none, one, 37: no multiple of the grid, all 48 tiles): bit for bit,
    ties to the lower packed position, across two query blocks."""
    args = exact_probe_args(dtype, cuda, 33, 128, 48, tile, which, 16)
    s, _ = assert_same_bits(ivf_probe(*args, tile=tile), ivf_probe_plain(*args, tile=tile))
    assert np.isneginf(s).all() == (which == "none")


@pytest.mark.parametrize("dtype", RETRIEVAL_TYPES)
@pytest.mark.parametrize("k", [1, 17, 32, 33, 64, 100, 256, 1024])
def test_ivf_probe_kernel_k_and_batch(cuda, dtype, k):
    for b in (1, 65):
        args = exact_probe_args(dtype, cuda, b, 64, 40, 128, "some", k, seed=b)
        assert_same_bits(ivf_probe(*args, tile=128), ivf_probe_plain(*args, tile=128))


@pytest.mark.parametrize("dtype", RETRIEVAL_TYPES)
def test_ivf_probe_kernel_every_query_filtered_out(cuda, dtype):
    q, qf, *rest = exact_probe_args(dtype, cuda, 33, 64, 24, 128, "all", 15)
    qf = torch.full_like(qf, 7)
    s, i = assert_same_bits(ivf_probe(q, qf, *rest, tile=128),
                            ivf_probe_plain(q, qf, *rest, tile=128))
    assert np.isneginf(s).all() and (i == -1).all()


def random_retrieval_args(dtype, dev):
    """Kernel 1's and kernel 3's arguments on random unit rows (scores
    whose f32 sums depend on their order)."""
    q, c, codes, qf = topk_case(40, 20000, 384, n_valid=19990)
    pq, pqf, emb, pcodes, gids, tile_ids, _ = probe_case(40, 384, 40, 128)
    cast = (lambda a: torch.tensor(quant(a), device=dev)) if dtype == torch.int8 else (
        lambda a: torch.tensor(a, device=dev).bfloat16())
    flat = (cast(q), cast(c), torch.tensor(codes, device=dev), torch.tensor(qf, device=dev),
            19990, 15)
    probe = (cast(pq), torch.tensor(pqf, device=dev), cast(emb), torch.tensor(pcodes, device=dev),
             torch.tensor(gids, device=dev), torch.tensor(tile_ids, device=dev), 15)
    return (lambda: masked_topk(*flat)), (lambda: ivf_probe(*probe, tile=128))


def result_bytes(out):
    return b"".join(x.cpu().numpy().tobytes() for x in out)


@pytest.mark.parametrize("dtype", RETRIEVAL_TYPES)
def test_retrieval_kernels_relaunch_bit_identical(cuda, dtype):
    """The merge's result does not depend on which block finishes last."""
    for run in random_retrieval_args(dtype, cuda):
        first = result_bytes(run())
        assert all(result_bytes(run()) == first for _ in range(5))


def test_retrieval_kernels_from_worker_threads(cuda):
    """Launches from worker threads, each on a side stream of its own (a
    scratch buffer and tickets a stream), agree with one on the default."""
    runs = [run for dtype in RETRIEVAL_TYPES for run in random_retrieval_args(dtype, cuda)]
    want = [result_bytes(run()) for run in runs]

    def work(_):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            outs = [[run() for run in runs] for _ in range(4)]
        stream.synchronize()
        return [[result_bytes(o) for o in out] for out in outs]

    with ThreadPoolExecutor(4) as pool:
        for got in pool.map(work, range(8)):
            assert all(g == want for g in got)


@pytest.mark.parametrize("dtype", RETRIEVAL_TYPES)
def test_retrieval_kernels_batches_in_turn(cuda, dtype):
    """Batches of 65, 5 and 65 queries in turn on one stream (a smaller
    batch's lists take the scratch a larger one's ran over) each meet
    the plain version bit for bit."""
    for b in (65, 5, 65):
        args = exact_topk_args(dtype, cuda, b, 5000, 64, 4990, 15, seed=b)
        assert_same_bits(masked_topk(*args), masked_topk_plain(*args))
        pargs = exact_probe_args(dtype, cuda, b, 64, 48, 128, "some", 15, seed=b)
        assert_same_bits(ivf_probe(*pargs, tile=128), ivf_probe_plain(*pargs, tile=128))


@pytest.mark.parametrize("dtype", RETRIEVAL_TYPES)
def test_topk_kernel_after_an_upsert_reallocates(cuda, dtype):
    """An upsert that grows a FlatIndex moves its corpus; the next search
    reads the new tensors and finds the new rows."""
    from financial_rag_system_tpu_torch.index.flat import FlatIndex

    rng = np.random.default_rng(3)
    index = FlatIndex(64, capacity=1024, tile=1024, dtype=dtype, device=cuda)

    def add(n, start):
        vecs = rng.standard_normal((n, 64)).astype(np.float32)
        index.upsert([f"r{start + j}" for j in range(n)], vecs, [""] * n,
                     [{"ticker": "T", "document_type": "10-K"}] * n)
        return vecs

    add(1000, 0)
    qf = torch.full((4, 2), -1, dtype=torch.int32, device=cuda)
    index.search_device(torch.zeros((4, 64), device=cuda), qf, 5)
    old = index._arrays[0].data_ptr()
    new = add(3000, 1000)
    emb, codes, _ = index._arrays
    assert emb.data_ptr() != old
    pick = new[[0, 999, 2000, 2999]]
    q = torch.tensor(pick / np.linalg.norm(pick, axis=1, keepdims=True), device=cuda)
    s, i = index.search_device(q, qf, 5)
    assert (i[:, 0].cpu().numpy() == [1000, 1999, 3000, 3999]).all()
    ref = masked_topk_plain(index.prep_queries(q), emb, codes, qf, index.n_valid, 5)
    if dtype == torch.int8:
        assert_same_bits((s, i), ref)
    else:
        np.testing.assert_allclose(s.cpu().numpy(), ref[0].cpu().numpy(), atol=1e-4, rtol=0)


def attn_case(p, s, h, seed=0, masked_pair=True, d=32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((p, s, h, d)).astype(np.float32)
               for _ in range(3))
    lens = rng.integers(1, s + 1, p)
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    if masked_pair:
        mask[-1] = 0
    return q, k, v, mask


@pytest.mark.parametrize(
    "p,s,h,d", [(4, 50, 12, 32), (3, 130, 4, 32), (2, 400, 12, 32), (2, 512, 2, 32),
                (2, 1, 3, 32), (32, 32, 12, 32), (4, 50, 12, 64), (3, 130, 4, 128),
                (2, 400, 12, 64), (2, 512, 2, 128), (2, 1, 3, 64), (2, 512, 16, 64),
                (3, 200, 2, 16), (3, 200, 2, 48), (3, 200, 2, 80), (3, 200, 2, 96),
                (3, 200, 2, 112), (4, 400, 12, 24), (3, 130, 4, 40), (2, 64, 3, 8),
                (2, 200, 2, 100)],
)
def test_attention_kernel_matches_plain(cuda, p, s, h, d):
    arrs = attn_case(p, s, h, d=d)
    q, k, v, mask = (torch.tensor(a, device=cuda) for a in arrs)
    inv = 1.0 / np.sqrt(d)
    n0 = encoder_self_attention.launches
    ref = encoder_self_attention_plain(q, k, v, mask, inv).cpu().numpy()
    got = encoder_self_attention(q, k, v, mask, inv).cpu().numpy()
    torch.cuda.synchronize()
    assert encoder_self_attention.launches == n0 + 1
    assert got.shape == (p, s, h * d)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=1e-2)


# (p, s, h, mask): kend at 1, at a chunk edge (64, 128) and in mid-chunk,
# S not a multiple of 64, fully masked pairs, and P H = 768 items, so that
# each persistent block takes several
ATTN_MASK_CASES = {
    "rerank": (8, 400, 12, rerank_mask(8, 400)),
    "rerank_s333": (6, 333, 4, rerank_mask(6, 333, seed=1)),
    "holes": (6, 300, 4, holes_mask(6, 300)),
    "all_valid": (4, 400, 12, np.ones((4, 400), np.int32)),
    "kend_1_edges_mid": (6, 400, 3, prefix_mask(400, [1, 64, 128, 100, 37, 399])),
    "s_not_64": (5, 100, 4, prefix_mask(100, [100, 65, 64, 63, 1])),
    "s_65": (3, 65, 2, prefix_mask(65, [65, 64, 0])),
    "fully_masked": (3, 400, 4, prefix_mask(400, [0, 200, 0])),
    "persistent": (64, 400, 12, rerank_mask(64, 400, seed=2)),
}


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("case", sorted(ATTN_MASK_CASES))
def test_attention_kernel_masks(cuda, case, d):
    p, s, h, mask_np = ATTN_MASK_CASES[case]
    q, k, v, _ = attn_case(p, s, h, seed=len(case), d=d)
    q, k, v, mask = (torch.tensor(a, device=cuda) for a in (q, k, v, mask_np))
    inv = 1.0 / np.sqrt(d)
    ref = encoder_self_attention_plain(q, k, v, mask, inv).cpu().numpy()
    got = encoder_self_attention(q, k, v, mask, inv).cpu().numpy()
    torch.cuda.synchronize()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_attention_kernel_relaunch_is_bit_identical(cuda, d):
    q, k, v, _ = attn_case(16, 400, 12, seed=3, d=d)
    q, k, v, mask = (torch.tensor(a, device=cuda) for a in (q, k, v, rerank_mask(16, 400)))
    first = encoder_self_attention(q, k, v, mask, 0.125)
    again = encoder_self_attention(q, k, v, mask, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def test_attention_kernel_from_worker_threads(cuda):
    """The server runs its batches in worker threads (``asyncio.to_thread``):
    launches from four threads at once, from a fresh thread and from a
    thread on a side stream give the main thread's context bit for bit."""
    cases = []
    for i in range(4):
        q, k, v, _ = attn_case(16, 400, 12, seed=10 + i)
        cases.append(tuple(torch.tensor(a, device=cuda)
                           for a in (q, k, v, rerank_mask(16, 400, seed=i))))
    want = [encoder_self_attention(*c, 0.125) for c in cases]
    ref = encoder_self_attention_plain(*cases[0], 0.125)
    torch.cuda.synchronize()
    np.testing.assert_allclose(want[0].cpu().numpy(), ref.cpu().numpy(), atol=1e-2, rtol=1e-2)

    def run(case, side_stream=False):
        if side_stream:
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.default_stream())
            with torch.cuda.stream(stream):
                out = encoder_self_attention(*case, 0.125)
        else:
            out = encoder_self_attention(*case, 0.125)
        torch.cuda.synchronize()
        return out

    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(run, cases))
    results, errors = [], []

    def in_thread(side_stream):
        try:
            results.append(run(cases[1], side_stream))
        except Exception as exc:  # re-raised below, in the test's thread
            errors.append(exc)

    for side_stream in (False, True):
        t = threading.Thread(target=in_thread, args=(side_stream,))
        t.start()
        t.join()
    assert not errors, errors
    assert all(torch.equal(w, g) for w, g in zip(want, got))
    assert all(torch.equal(want[1], r) for r in results)


def test_attention_kernel_first_launches_race(cuda):
    """A process whose first launches of the kernel come from four threads
    at once (the launcher's one-time set-up runs in each of them)."""
    code = (
        "import threading, torch\n"
        "from concurrent.futures import ThreadPoolExecutor\n"
        "from financial_rag_system_tpu_torch.ops import _cuda\n"
        "from financial_rag_system_tpu_torch.ops.attention import (\n"
        "    encoder_self_attention, encoder_self_attention_plain)\n"
        "_cuda.library('pair_attention')  # loaded, not yet launched\n"
        "g = torch.Generator(device='cuda').manual_seed(0)\n"
        "q, k, v = (torch.randn(8, 400, 12, 32, device='cuda', generator=g)\n"
        "           for _ in range(3))\n"
        "mask = torch.ones(8, 400, dtype=torch.int32, device='cuda')\n"
        "start = threading.Barrier(4)\n"
        "def run(_):\n"
        "    start.wait()\n"
        "    out = encoder_self_attention(q, k, v, mask, 0.125)\n"
        "    torch.cuda.synchronize()\n"
        "    return out\n"
        "with ThreadPoolExecutor(4) as pool:\n"
        "    outs = list(pool.map(run, range(4)))\n"
        "assert all(torch.equal(o, outs[0]) for o in outs)\n"
        "ref = encoder_self_attention_plain(q, k, v, mask, 0.125)\n"
        "torch.testing.assert_close(outs[0], ref, atol=1e-2, rtol=1e-2)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.split()[-1:] == ["ok"], out.stderr[-4000:]


def test_attention_kernel_rejects_shapes(cuda):
    x = torch.zeros((1, 600, 2, 32), device=cuda)
    m = torch.ones((1, 600), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        encoder_self_attention(x, x, x, m, 0.1)
    for d in (144, 256):  # wider than any kernel; narrower ones are padded
        y = torch.zeros((1, 8, 2, d), device=cuda)
        with pytest.raises(ValueError, match="head_dim"):
            encoder_self_attention(y, y, y, m[:, :8], 0.1)
    for d in (8, 40, 144, 256):  # head widths no kernel takes unpadded
        y = torch.zeros((1, 8, 2, d), dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="head_dim"):
            pair_attention_kernel(y, y, y, m[:, :8])
    z = torch.zeros(1 + 8 * 2 * 32, dtype=torch.bfloat16, device=cuda)[1:].view(1, 8, 2, 32)
    with pytest.raises(ValueError, match="aligned"):
        pair_attention_kernel(z, z, z, m[:, :8])


def block_case(r, h, i, dev, seed=0):
    """x, ctx and one encoder layer's weights (nn.Linear layout) at the
    scales of a random-init encoder, made on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def f(*shape, scale=1.0, loc=0.0):
        return loc + scale * torch.randn(shape, generator=g, device=dev)

    return dict(
        x=f(r, h), ctx=f(r, h), w=[f(h, h, scale=0.05) for _ in range(4)],
        b=[f(h, scale=0.01) for _ in range(4)], w_in=f(i, h, scale=0.05),
        b_in=f(i, scale=0.01), w_out=f(h, i, scale=0.05), b_out=f(h, scale=0.01),
        s=f(h, scale=0.1, loc=1.0), lb=f(h, scale=0.1),
    )


def qkv_args(c):
    return (c["x"], c["w"][0], c["b"][0], c["w"][1], c["b"][1], c["w"][2], c["b"][2])


# the rerank shape of the main path (480 pairs x 400 tokens) and below it
FUSED_CASES = [(r, h, i) for h, i in ((128, 512), (384, 1536))
               for r in (1, 100, 777, 4096, 192_000)]


@pytest.fixture()
def full_f32(monkeypatch):
    """Plain versions in full f32 on the card (no TF32)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


@pytest.mark.parametrize("r,h,i", FUSED_CASES)
def test_fused_ffn_ln_kernel_matches_plain(cuda, full_f32, r, h, i):
    c = block_case(r, h, i, cuda, seed=r)
    args = (c["x"], c["w_in"], c["b_in"], c["w_out"], c["b_out"], c["s"], c["lb"], 1e-12)
    before = fused_bert.fused_ffn_ln.launches
    got = fused_bert.fused_ffn_ln(*args)
    torch.cuda.synchronize()
    assert fused_bert.fused_ffn_ln.launches == before + 1
    assert got.shape == (r, h) and got.dtype == torch.float32
    torch.testing.assert_close(got, fused_bert.fused_ffn_ln_plain(*args), atol=2e-3, rtol=2e-3)


def ffn_args(c):
    return (c["x"], c["w_in"], c["b_in"], c["w_out"], c["b_out"], c["s"], c["lb"], 1e-12)


# what the FFN kernel's plans can get wrong: blocks walking unequal numbers
# of tiles (64 x 137 + 5: 69 tiles; 20,000 at H 128: 157), the I split
# (1,024, the embed shape: 16 tiles of 64 rows with H split x 8 splits; 65:
# two tiles split over all 24 chunks, the second holding one row; 300: 5
# tiles x 24 splits; 777 at H 256: 7 tiles of 128 x 18 splits of 32
# chunks, some a chunk longer; 1,024 at H 448: 8 splits of 28 chunks), a
# ragged last tile (777), and every accepted width
FFN_CASES = [(777, 384), (64 * 137 + 5, 384), (1024, 384), (65, 384), (300, 384)] + [
    (777, h) for h in range(64, 513, 64) if h != 384] + [
    (64 * 137 + 5, 512), (1024, 448), (20_000, 128)]


@pytest.mark.parametrize("r,h", FFN_CASES)
def test_fused_ffn_ln_kernel_plan_cases(cuda, full_f32, r, h):
    c = block_case(r, h, 4 * h, cuda, seed=r + h)
    args = ffn_args(c)
    before = fused_bert.fused_ffn_ln.launches
    got = fused_bert.fused_ffn_ln(*args)
    torch.cuda.synchronize()
    assert fused_bert.fused_ffn_ln.launches == before + 1
    assert got.shape == (r, h) and got.dtype == torch.float32
    torch.testing.assert_close(got, fused_bert.fused_ffn_ln_plain(*args), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("r", [1024, 64 * 137 + 5])
def test_fused_ffn_ln_kernel_relaunch_is_bit_identical(cuda, r):
    """The split plan sums its partials in split order, whichever block
    draws the last ticket, and leaves the tickets zero: launches on the
    same inputs give the same bits."""
    args = ffn_args(block_case(r, 384, 1536, cuda, seed=5))
    first = fused_bert.fused_ffn_ln(*args)
    again = [fused_bert.fused_ffn_ln(*args) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(first, a) for a in again)


def test_fused_ffn_ln_kernel_from_worker_threads(cuda):
    """Launches from four threads at once (two of them on side streams,
    each with tickets of its own), the embed shape's split plan and the
    rerank's persistent one, give the main thread's bits."""
    cases = [ffn_args(block_case(r, 384, 1536, cuda, seed=20 + i))
             for i, r in enumerate((1024, 1024, 4096, 777))]
    want = [fused_bert.fused_ffn_ln(*c) for c in cases]
    torch.cuda.synchronize()

    def run(i):
        if i % 2:
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.default_stream())
            with torch.cuda.stream(stream):
                out = fused_bert.fused_ffn_ln(*cases[i])
        else:
            out = fused_bert.fused_ffn_ln(*cases[i])
        torch.cuda.synchronize()
        return out

    for _ in range(2):
        with ThreadPoolExecutor(4) as pool:
            got = list(pool.map(run, range(4)))
        assert all(torch.equal(w, g) for w, g in zip(want, got))


@pytest.mark.parametrize("r,h,i", FUSED_CASES)
def test_fused_qkv_kernel_matches_plain(cuda, full_f32, r, h, i):
    c = block_case(r, h, i, cuda, seed=r + 1)
    args = qkv_args(c)
    got = fused_bert.fused_qkv(*args)
    torch.cuda.synchronize()
    for g, want in zip(got, fused_bert.fused_qkv_plain(*args)):
        assert g.shape == (r, h) and g.dtype == torch.float32
        torch.testing.assert_close(g, want, atol=2e-3, rtol=2e-3)


# what a persistent kernel can get wrong: blocks with unequal numbers of
# tiles and a ragged last tile (65, 64 x 137 + 5), fewer units than
# multiprocessors (1,024, the embed shape), and every accepted width, so
# every slice width (64, 128, 192) and ring depth of the plan
QKV_CASES = [(65, 384), (64 * 137 + 5, 384), (1024, 384), (64 * 137 + 5, 512)] + [
    (777, h) for h in range(64, 513, 64)]


@pytest.mark.parametrize("r,h", QKV_CASES)
def test_fused_qkv_kernel_plan_cases(cuda, full_f32, r, h):
    c = block_case(r, h, 4 * h, cuda, seed=r + h)
    args = qkv_args(c)
    before = fused_bert.fused_qkv.launches
    got = fused_bert.fused_qkv(*args)
    torch.cuda.synchronize()
    assert fused_bert.fused_qkv.launches == before + 1
    for g, want in zip(got, fused_bert.fused_qkv_plain(*args)):
        assert g.shape == (r, h) and g.dtype == torch.float32
        torch.testing.assert_close(g, want, atol=2e-3, rtol=2e-3)


def test_fused_qkv_kernel_is_deterministic_and_takes_a_pack(cuda):
    """Two launches on the same inputs give the same bits (no atomics, no
    order that changes between runs), with the weights packed by the
    wrapper or once by the caller."""
    c = block_case(64 * 137 + 5, 384, 1536, cuda, seed=11)
    args = qkv_args(c)
    first = fused_bert.fused_qkv(*args)
    again = fused_bert.fused_qkv(*args, fused_bert.pack_qkv(*args[1:]))
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("ctx_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,h,i", FUSED_CASES)
def test_fused_resid_ln_kernel_matches_plain(cuda, full_f32, r, h, i, ctx_dtype):
    c = block_case(r, h, i, cuda, seed=r + 2)
    args = (c["x"], c["ctx"].to(ctx_dtype), c["w"][3], c["b"][3], c["s"], c["lb"], 1e-12)
    got = fused_bert.fused_resid_ln(*args)
    torch.cuda.synchronize()
    assert got.shape == (r, h) and got.dtype == torch.float32
    torch.testing.assert_close(got, fused_bert.fused_resid_ln_plain(*args), atol=2e-3, rtol=2e-3)


def resid_args(c, ctx_dtype=torch.float32, x_dtype=torch.float32):
    return (c["x"].to(x_dtype), c["ctx"].to(ctx_dtype), c["w"][3], c["b"][3], c["s"], c["lb"],
            1e-12)


def assert_resid_matches_plain(args, packed=None):
    before = fused_bert.fused_resid_ln.launches
    got = fused_bert.fused_resid_ln(*args, packed)
    torch.cuda.synchronize()
    assert fused_bert.fused_resid_ln.launches == before + 1
    assert got.shape == args[0].shape and got.dtype == torch.float32
    torch.testing.assert_close(got, fused_bert.fused_resid_ln_plain(*args), atol=2e-3, rtol=2e-3)
    return got


# every width the o-proj kernel takes, so every slice width (N 64, 80, 96)
# and cluster size (1, 2, 4, 7, 8) of its plans, with either context and
# either activation type
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ctx_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", range(64, 513, 64))
def test_fused_resid_ln_kernel_widths(cuda, full_f32, h, ctx_dtype, x_dtype):
    c = block_case(777, h, 4 * h, cuda, seed=h + 3)
    assert_resid_matches_plain(resid_args(c, ctx_dtype, x_dtype))


# ragged row counts: one row, a short last tile (63, 65, 777), clusters that
# walk unequal numbers of tiles (138 and 201 tiles over the card's clusters)
@pytest.mark.parametrize("ctx_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [1, 63, 65, 777, 64 * 137 + 5, 64 * 200 + 17])
def test_fused_resid_ln_kernel_ragged_rows(cuda, full_f32, r, ctx_dtype):
    c = block_case(r, 384, 1536, cuda, seed=r + 9)
    assert_resid_matches_plain(resid_args(c, ctx_dtype))


@pytest.mark.parametrize("h,ctx_dtype", [(384, torch.bfloat16), (384, torch.float32),
                                         (320, torch.bfloat16), (512, torch.bfloat16)])
def test_fused_resid_ln_kernel_exchanges_row_statistics(cuda, full_f32, h, ctx_dtype):
    """Each block of a cluster sums its own columns of a row; a row's mean
    and variance need every block's part.  A large offset on the columns
    of the cluster's first block (the first H / cluster) and on every
    other row moves both statistics far from what any one block sees."""
    c = block_case(4096, h, 4 * h, cuda, seed=h + 17)
    plan = fused_bert.resid_plan(h, 4096, torch.cuda.get_device_properties(0).multi_processor_count,
                                 ctx_dtype == torch.bfloat16)
    assert plan.cluster > 1
    n = h // plan.cluster
    c["x"][::2, :n] += 40.0
    c["x"][1::2, n:2 * n] -= 25.0
    assert_resid_matches_plain(resid_args(c, ctx_dtype))


@pytest.mark.parametrize("r,ctx_dtype", [(1024, torch.float32), (64 * 137 + 5, torch.bfloat16)])
def test_fused_resid_ln_kernel_relaunch_is_bit_identical(cuda, r, ctx_dtype):
    """The clusters add their row sums in rank order: launches on the same
    inputs give the same bits, with the weights packed by the wrapper or
    once by the caller."""
    args = resid_args(block_case(r, 384, 1536, cuda, seed=6), ctx_dtype)
    first = fused_bert.fused_resid_ln(*args)
    pack = fused_bert.pack_resid(args[2], args[3])
    again = [fused_bert.fused_resid_ln(*args, pack) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(first, a) for a in again)


def test_fused_resid_ln_kernel_from_worker_threads(cuda):
    """Launches from four threads at once, two of them on side streams, at
    the embed shape (f32 context) and a rerank-like one (bf16), give the
    main thread's bits."""
    cases = [resid_args(block_case(r, 384, 1536, cuda, seed=30 + i), dt)
             for i, (r, dt) in enumerate(((1024, torch.float32), (1024, torch.bfloat16),
                                          (4096, torch.bfloat16), (777, torch.float32)))]
    want = [fused_bert.fused_resid_ln(*c) for c in cases]
    torch.cuda.synchronize()

    def run(i):
        if i % 2:
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.default_stream())
            with torch.cuda.stream(stream):
                out = fused_bert.fused_resid_ln(*cases[i])
        else:
            out = fused_bert.fused_resid_ln(*cases[i])
        torch.cuda.synchronize()
        return out

    for _ in range(2):
        with ThreadPoolExecutor(4) as pool:
            got = list(pool.map(run, range(4)))
        assert all(torch.equal(w, g) for w, g in zip(want, got))


def test_fused_resid_ln_kernel_rejects_a_foreign_plan(cuda):
    """The C entry runs only the plans it was compiled for."""
    x, ctx, w, b, s, lb, eps = resid_args(block_case(1024, 384, 1536, cuda, seed=4),
                                          torch.bfloat16)
    pack = fused_bert.pack_resid(w, b)
    plan = fused_bert.resid_plan(384, 1024, torch.cuda.get_device_properties(0).multi_processor_count,
                                 True)
    y = torch.empty_like(x)
    lib = fused_bert._library()

    def launch(p, cluster_map=None):
        return lib.fused_resid_ln(x.data_ptr(), 0, ctx.data_ptr(), 1,
                                  pack.wmap(cluster_map or p.cluster), pack.b.data_ptr(),
                                  s.data_ptr(), lb.data_ptr(), eps, y.data_ptr(), 1024, 384,
                                  p.cluster, p.stages, p.ctas,
                                  torch.cuda.current_stream().cuda_stream)

    assert launch(plan) == 0
    torch.cuda.synchronize()
    for bad in (plan._replace(stages=plan.stages + 1), plan._replace(stages=plan.stages - 1),
                plan._replace(cluster=3, ctas=63), plan._replace(cluster=8, ctas=64),
                plan._replace(ctas=plan.ctas + 1), plan._replace(ctas=4 * 17)):
        assert launch(bad, plan.cluster) == 1  # cudaErrorInvalidValue


def test_fused_kernels_take_a_bf16_activation(cuda):
    """A bf16 x is widened to f32 exactly: the same result as its f32 copy."""
    c = block_case(300, 128, 512, cuda, seed=3)
    xb = c["x"].bfloat16()
    ffn = (c["w_in"], c["b_in"], c["w_out"], c["b_out"], c["s"], c["lb"], 1e-12)
    assert torch.equal(fused_bert.fused_ffn_ln(xb, *ffn), fused_bert.fused_ffn_ln(xb.float(), *ffn))
    res = (c["ctx"], c["w"][3], c["b"][3], c["s"], c["lb"], 1e-12)
    assert torch.equal(fused_bert.fused_resid_ln(xb, *res),
                       fused_bert.fused_resid_ln(xb.float(), *res))
    qkv = qkv_args(c)[1:]
    for a, b in zip(fused_bert.fused_qkv(xb, *qkv), fused_bert.fused_qkv(xb.float(), *qkv)):
        assert torch.equal(a, b)


def test_fused_kernels_reject_shapes(cuda):
    c = block_case(10, 128, 512, cuda)
    ln = (c["s"], c["lb"], 1e-12)
    for bad_h in (96, 576):  # not a multiple of 64; wider than 512
        x = torch.zeros((10, bad_h), device=cuda)
        w = torch.zeros((bad_h, bad_h), device=cuda)
        b = torch.zeros(bad_h, device=cuda)
        with pytest.raises(ValueError):
            fused_bert.fused_qkv(x, w, b, w, b, w, b)
        with pytest.raises(ValueError):
            fused_bert.fused_resid_ln(x, x, w, b, b, b, 1e-12)
    w_in, b_in, w_out = (torch.zeros(s, device=cuda) for s in ((100, 128), (100,), (128, 100)))
    with pytest.raises(ValueError):  # I not a multiple of 64
        fused_bert.fused_ffn_ln(c["x"], w_in, b_in, w_out, c["b_out"], *ln)
    with pytest.raises(ValueError):  # W_out not (H, I)
        fused_bert.fused_ffn_ln(c["x"], c["w_in"], c["b_in"], c["w_in"], c["b_out"], *ln)
    with pytest.raises(ValueError):  # ctx rows differ from x's
        fused_bert.fused_resid_ln(c["x"], c["ctx"][:5], c["w"][3], c["b"][3], *ln)
    with pytest.raises(ValueError):  # x not (R, H)
        fused_bert.fused_qkv(c["x"][None], c["w"][0], c["b"][0], c["w"][1], c["b"][1],
                             c["w"][2], c["b"][2])


# -- the HNSW walk on the card against its CPU run ----------------------------


@pytest.mark.parametrize("dtype", RETRIEVAL_TYPES)
def test_hnsw_walk_on_the_card_matches_the_cpu(cuda, dtype):
    """One natively built graph (its hierarchy and k-center pool) over the
    same 8,192 clustered rows on the CPU and on the card; the routed walk
    of 32 queries under mixed filters: int8 scores and rows bit for bit
    (integer sums), bf16 rows identical wherever neighbouring scores differ
    by more than 1e-5 and scores within 1e-5."""
    from financial_rag_system_tpu_torch.index.flat import FlatIndex
    from financial_rag_system_tpu_torch.index.hnsw import HNSWIndex

    rng = np.random.default_rng(9)
    d, n = 384, 8192
    centers = rng.standard_normal((64, d)).astype(np.float32)
    v = centers[rng.integers(0, 64, n + 32)] + 0.3 * rng.standard_normal((n + 32, d)).astype(
        np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    payloads = [{"ticker": ("AAPL", "MSFT", "NVDA")[i % 3], "document_type": "10-K"}
                for i in range(n)]
    flats = {}
    for dev in ("cpu", cuda):
        flats[str(dev)] = FlatIndex(d, capacity=n, tile=128, device=dev, dtype=dtype)
        flats[str(dev)].upsert([f"p{i}" for i in range(n)], v[:n], ["t"] * n, payloads)
    built = HNSWIndex(flats["cpu"])
    if built._native is None:
        pytest.skip("g++ is unavailable")
    graph = (built._native.adjacency(), built._native.entries(built.entries_cap))
    kw = dict(graph=graph, hier=built._native.hierarchy(), pool=built._host_pool)
    ref, card = HNSWIndex(flats["cpu"], **kw), HNSWIndex(flats["cuda"], **kw)
    ref.SELECTIVE_LIMIT = card.SELECTIVE_LIMIT = 0  # every query walks
    assert card.adj_pad.is_cuda and card._graph_state[6][1].is_cuda
    store = flats["cpu"].store
    codes = [store.query_codes(t, None) for t in (None, "AAPL", "MSFT", "NVDA")] * 8
    qf = torch.tensor(codes, dtype=torch.int32)
    q = torch.from_numpy(v[n:])
    s_r, i_r = (x.numpy() for x in ref.search_device(q, qf, 15, host_codes=codes))
    s_c, i_c = (x.cpu().numpy() for x in card.search_device(q.to(cuda), qf.to(cuda), 15,
                                                             host_codes=codes))
    torch.cuda.synchronize()
    assert np.isfinite(s_c).all()
    if dtype == torch.int8:
        assert s_c.tobytes() == s_r.tobytes() and i_c.tobytes() == i_r.tobytes()
        return
    np.testing.assert_allclose(s_c, s_r, atol=1e-5, rtol=0)
    gap = np.abs(np.diff(s_r, axis=1))
    near = np.zeros(s_r.shape, bool)
    near[:, 1:] |= gap <= 1e-5
    near[:, :-1] |= gap <= 1e-5
    np.testing.assert_array_equal(i_c[~near], i_r[~near])
