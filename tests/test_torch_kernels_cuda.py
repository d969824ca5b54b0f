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
from financial_rag_system_tpu_torch.ops import flash_attention, fused_bert
from financial_rag_system_tpu_torch.ops.attention import (
    encoder_self_attention,
    encoder_self_attention_plain,
    pair_attention_kernel,
    padded_width,
)
from financial_rag_system_tpu_torch.ops.flash_attention import (
    encoder_flash_attention,
    flash_attention_kernel,
    flash_attention_plain,
)
from financial_rag_system_tpu_torch.ops.topk import WIDE_ABOVE_D, masked_topk, masked_topk_plain
from torch_attn_masks import holes_mask, prefix_mask, rerank_mask, segment_mask

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
    n0, s0, w0 = masked_topk.launches_int8, masked_topk.launches_select, masked_topk.launches_wide
    s, i = (x.cpu().numpy() for x in masked_topk(*args))
    torch.cuda.synchronize()
    # the lists' int8 branch up to k 32, the select path above; rows of
    # more than WIDE_ABOVE_D values the wide kernel, either path
    wide = d > WIDE_ABOVE_D
    assert (masked_topk.launches_int8, masked_topk.launches_select, masked_topk.launches_wide) == (
        n0 + (k <= 32 and not wide), s0 + (k > 32 and not wide), w0 + wide)
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
    n0, s0, w0 = ivf_probe.launches_int8, ivf_probe.launches_select, ivf_probe.launches_wide
    s, i = (x.cpu().numpy() for x in ivf_probe(*args, tile=tile))
    torch.cuda.synchronize()
    wide = d > WIDE_ABOVE_D
    assert (ivf_probe.launches_int8, ivf_probe.launches_select, ivf_probe.launches_wide) == (
        n0 + (k <= 32 and not wide), s0 + (k > 32 and not wide), w0 + wide)
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


def random_retrieval_args(dtype, dev, k=15, d=384):
    """Kernel 1's and kernel 3's calls at k on random unit rows of d
    values (scores whose f32 sums depend on their order)."""
    q, c, codes, qf = topk_case(40, 20000, d, n_valid=19990)
    pq, pqf, emb, pcodes, gids, tile_ids, _ = probe_case(40, d, 40, 128)
    cast = (lambda a: torch.tensor(quant(a), device=dev)) if dtype == torch.int8 else (
        lambda a: torch.tensor(a, device=dev).bfloat16())
    flat = (cast(q), cast(c), torch.tensor(codes, device=dev), torch.tensor(qf, device=dev),
            19990, k)
    probe = (cast(pq), torch.tensor(pqf, device=dev), cast(emb), torch.tensor(pcodes, device=dev),
             torch.tensor(gids, device=dev), torch.tensor(tile_ids, device=dev), k)
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



# -- the wide kernel: rows of more than WIDE_ABOVE_D values ------------------

# D 1040 (the first wide bf16 width), 1536 and 3136 (the widest) in bf16;
# 2080 and 6272 (the widest) in int8
WIDE_CASES = [(torch.bfloat16, 1040), (torch.bfloat16, 1536), (torch.bfloat16, 3136),
              (torch.int8, 2080), (torch.int8, 6272)]


def wide_counts():
    return masked_topk.launches_wide, ivf_probe.launches_wide


def assert_close_ids(got, ref):
    """bf16 on random rows: the same empty slots, scores within 1e-4, and
    the same ids wherever no other entry lies within that noise."""
    s, i = (x.cpu().numpy() for x in got)
    s_ref, i_ref = (x.cpu().numpy() for x in ref)
    fin = np.isfinite(s_ref)
    np.testing.assert_array_equal(np.isfinite(s), fin)
    np.testing.assert_allclose(s[fin], s_ref[fin], atol=1e-4, rtol=0)
    assert (i[~fin] == -1).all()
    with np.errstate(invalid="ignore"):  # -inf - -inf in empty slots
        gap = np.abs(s_ref[:, :, None] - s_ref[:, None, :])
    gap[:, np.arange(s.shape[1]), np.arange(s.shape[1])] = np.inf
    clear = fin & (gap.min(axis=2) > 1e-4)
    clear[:, -1] = False  # a row past the list may tie the last entry
    np.testing.assert_array_equal(i[clear], i_ref[clear])


@pytest.mark.parametrize("k", [15, 1024])
@pytest.mark.parametrize("dtype,d", WIDE_CASES)
def test_wide_kernel_matches_plain(cuda, dtype, d, k):
    """Kernels 1 and 3 on the wide kernel, on the lists' path (k 15) and
    the select path (k 1024), each call one launch of its wide counter:
    random unit rows (int8 bit for bit; bf16 within 1e-4, ids where clear
    of that noise, the duplicated pair tied, lower id first) and tie-heavy
    exact rows across two query blocks, bit for bit."""
    q, c, codes, qf = topk_case(40, 20000, d, n_valid=19990)
    cast = (lambda a: torch.tensor(quant(a), device=cuda)) if dtype == torch.int8 else (
        lambda a: torch.tensor(a, device=cuda).bfloat16())
    flat = (cast(q), cast(c), torch.tensor(codes, device=cuda), torch.tensor(qf, device=cuda),
            19990, k)
    pq, pqf, emb, pcodes, gids, tile_ids, dup = probe_case(40, d, 40, 128)
    probe = (cast(pq), torch.tensor(pqf, device=cuda), cast(emb),
             torch.tensor(pcodes, device=cuda), torch.tensor(gids, device=cuda),
             torch.tensor(tile_ids, device=cuda), k)
    w0 = wide_counts()
    got_flat, got_probe = masked_topk(*flat), ivf_probe(*probe, tile=128)
    assert wide_counts() == (w0[0] + 1, w0[1] + 1)
    for got, ref in ((got_flat, masked_topk_plain(*flat)),
                     (got_probe, ivf_probe_plain(*probe, tile=128))):
        if dtype == torch.int8:
            assert_same_bits(got, ref)
        else:
            assert_close_ids(got, ref)
    s, i = (x.cpu().numpy() for x in got_flat)
    assert i[2, 0] == 10000 and i[2, 1] == 10001 and s[2, 0] == s[2, 1]
    s, i = (x.cpu().numpy() for x in got_probe)
    assert (i[0, 0], i[0, 1]) == dup and s[0, 0] == s[0, 1]
    args = exact_topk_args(dtype, cuda, 33, 5000, d, 4990, k)
    s, i = assert_same_bits(masked_topk(*args), masked_topk_plain(*args))
    tied = s[0][:-1] == s[0][1:]
    assert np.isfinite(s[0]).all() and (np.diff(i[0])[tied] > 0).all()
    pargs = exact_probe_args(dtype, cuda, 33, d, 48, 128, "some", k)
    assert_same_bits(ivf_probe(*pargs, tile=128), ivf_probe_plain(*pargs, tile=128))
    assert wide_counts() == (w0[0] + 2, w0[1] + 2)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 1536), (torch.int8, 2080)])
def test_wide_kernel_relaunch_and_threads(cuda, dtype, d):
    """The wide kernel at k 15 and 1024 relaunched, and from two worker
    threads on side streams of their own: bit for bit with the first
    launch on the default stream (the merge's and the selection's result
    does not depend on which block finishes last)."""
    runs = [run for k in (15, 1024) for run in random_retrieval_args(dtype, cuda, k=k, d=d)]
    want = [result_bytes(run()) for run in runs]
    assert all(result_bytes(run()) == w for run, w in zip(runs, want) for _ in range(3))

    def work(_):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            outs = [[run() for run in runs] for _ in range(2)]
        stream.synchronize()
        return [[result_bytes(o) for o in out] for out in outs]

    with ThreadPoolExecutor(2) as pool:
        for got in pool.map(work, range(4)):
            assert all(g == want for g in got)


@pytest.mark.parametrize("dtype", RETRIEVAL_TYPES)
def test_rows_past_the_widest_are_refused_on_the_card(cuda, dtype):
    """Rows above 6,272 bytes (bf16 D 3152, int8 D 6304) are refused by
    both kernels' wrappers, on the card as on the CPU's plan."""
    d = 6272 // torch.empty((), dtype=dtype).element_size() + (16 if dtype != torch.int8 else 32)
    q, c, codes, qf = topk_case(4, 256, d, n_valid=256)
    cast = (lambda a: torch.tensor(quant(a), device=cuda)) if dtype == torch.int8 else (
        lambda a: torch.tensor(a, device=cuda).bfloat16())
    with pytest.raises(ValueError, match="dims"):
        masked_topk(cast(q), cast(c), torch.tensor(codes, device=cuda),
                    torch.tensor(qf, device=cuda), 256, 5)
    pq, pqf, emb, pcodes, gids, tile_ids, _ = probe_case(4, d, 4, 64)
    with pytest.raises(ValueError, match="dims"):
        ivf_probe(cast(pq), torch.tensor(pqf, device=cuda), cast(emb),
                  torch.tensor(pcodes, device=cuda), torch.tensor(gids, device=cuda),
                  torch.tensor(tile_ids, device=cuda), 5, tile=64)


# -- kernels 1 and 3 above k 32: the select path ----------------------------


def select_counts():
    return masked_topk.launches_select, ivf_probe.launches_select


@pytest.mark.parametrize("dtype", RETRIEVAL_TYPES)
def test_select_path_ties_straddle_the_threshold(cuda, dtype):
    """Exact rows from six vectors at k 1024: thousands of rows share the
    k-th score, which the entry after it shares too; both kernels bit for
    bit, each call one launch of the select path."""
    args = exact_topk_args(dtype, cuda, 33, 40_000, 128, 39_990, 1024)
    s0 = select_counts()
    s, i = assert_same_bits(masked_topk(*args), masked_topk_plain(*args))
    assert select_counts() == (s0[0] + 1, s0[1])
    wider = masked_topk_plain(*args[:-1], 1025)[0].cpu().numpy()
    assert (wider[:, 1023] == wider[:, 1024]).all()  # the threshold is straddled
    pargs = exact_probe_args(dtype, cuda, 33, 128, 200, 128, "all", 1024)
    assert_same_bits(ivf_probe(*pargs, tile=128), ivf_probe_plain(*pargs, tile=128))
    assert select_counts() == (s0[0] + 1, s0[1] + 1)


@pytest.mark.parametrize("dtype", RETRIEVAL_TYPES)
def test_select_path_filter_leaves_fewer_than_k(cuda, dtype):
    """A ticker on 500 of 20,000 rows, k 1024: every finite score is taken
    and the rest of the row is -inf / -1."""
    q, c, codes, qf, n_valid, _ = exact_topk_args(dtype, cuda, 5, 20_000, 64, 20_000, 1024)
    codes = codes.clone()
    codes[0] = 1
    codes[0, torch.randperm(20_000, device=cuda)[:500]] = 4
    qf = qf.clone()
    qf[:, 0] = 4
    s, i = assert_same_bits(masked_topk(q, c, codes, qf, n_valid, 1024),
                            masked_topk_plain(q, c, codes, qf, n_valid, 1024))
    fin = np.isfinite(s)
    assert (fin.sum(axis=1) <= 500).all() and fin[0].sum() == 500 and (i[~fin] == -1).all()


@pytest.mark.parametrize("dtype", RETRIEVAL_TYPES)
def test_select_path_k_above_n(cuda, dtype):
    """k 2048 over 777 rows (kernel 1) and over 37 probed tiles of 64 rows
    (kernel 3): the rows there are, then empty slots."""
    args = exact_topk_args(dtype, cuda, 3, 777, 64, 770, 2048)
    s, _ = assert_same_bits(masked_topk(*args), masked_topk_plain(*args))
    assert np.isfinite(s[0]).sum() == 770
    pargs = exact_probe_args(dtype, cuda, 3, 64, 48, 64, "some", 2048)
    assert_same_bits(ivf_probe(*pargs, tile=64), ivf_probe_plain(*pargs, tile=64))


@pytest.mark.parametrize("dtype", RETRIEVAL_TYPES)
def test_select_path_k_above_the_shared_memory_sort(cuda, dtype):
    """k 16,384: four runs of 4,096 survivors sorted in shared memory, then
    two merges in device memory; kernel 3 over 200 tiles of 128."""
    args = exact_topk_args(dtype, cuda, 33, 40_000, 64, 39_990, 16_384)
    assert_same_bits(masked_topk(*args), masked_topk_plain(*args))
    pargs = exact_probe_args(dtype, cuda, 33, 64, 200, 128, "all", 16_384)
    assert_same_bits(ivf_probe(*pargs, tile=128), ivf_probe_plain(*pargs, tile=128))


@pytest.mark.parametrize("rows", ["exact-bf16", "int8", "random-bf16"])
def test_select_path_a_million_rows(cuda, rows):
    """1,048,580 rows of 384 at k 1024 (the IVF corpus's flat size): exact
    rows bit for bit, random unit rows within 1e-4 with ids where clear of
    that noise."""
    n, d, b, k = 1_048_580, 384, 32, 1024
    g = torch.Generator(device=cuda).manual_seed(5)
    if rows == "random-bf16":
        unit = lambda m: torch.nn.functional.normalize(  # noqa: E731
            torch.randn(m, d, generator=g, device=cuda), dim=1).bfloat16()
        q, c = unit(b), unit(n)
    else:
        base = torch.randint(-3, 4, (6, d), generator=g, device=cuda)
        c = base[torch.randint(0, 6, (n,), generator=g, device=cuda)]
        q = base[torch.randint(0, 6, (b,), generator=g, device=cuda)]
        cast = (lambda a: a.to(torch.int8)) if rows == "int8" else (
            lambda a: (a.float() / 16).bfloat16())
        q, c = cast(q), cast(c)
    codes = torch.stack([torch.randint(0, 5, (n,), generator=g, device=cuda),
                         torch.randint(0, 3, (n,), generator=g, device=cuda)]).int()
    qf = torch.full((b, 2), -1, dtype=torch.int32, device=cuda)
    qf[1:8, 0] = torch.arange(7, device=cuda) % 5
    args = (q, c, codes, qf, n - 3, k)
    if rows != "random-bf16":
        assert_same_bits(masked_topk(*args), masked_topk_plain(*args))
        return
    s, i = (x.cpu().numpy() for x in masked_topk(*args))
    s_ref, i_ref = (x.cpu().numpy() for x in masked_topk_plain(*args))
    np.testing.assert_allclose(s, s_ref, atol=1e-4, rtol=0)
    gap = np.abs(np.diff(s_ref, axis=1))
    near = np.minimum(np.r_["1", gap[:, :1], gap], np.r_["1", gap, gap[:, -1:]])
    clear = near > 1e-4
    clear[:, -1] = False  # a row past the list may tie the last entry
    np.testing.assert_array_equal(i[clear], i_ref[clear])


def test_select_path_from_worker_threads(cuda):
    """Calls at k 1024 from worker threads, each on a side stream (its own
    scratch), agree bit for bit with one on the default stream: the
    survivors' places taken by atomics never reach the result."""
    runs = [run for dtype in RETRIEVAL_TYPES
            for run in random_retrieval_args(dtype, cuda, k=1024)]
    s0 = select_counts()
    want = [result_bytes(run()) for run in runs]
    assert select_counts() == (s0[0] + 2, s0[1] + 2)

    def work(_):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            outs = [[run() for run in runs] for _ in range(3)]
        stream.synchronize()
        return [[result_bytes(o) for o in out] for out in outs]

    with ThreadPoolExecutor(4) as pool:
        for got in pool.map(work, range(6)):
            assert all(g == want for g in got)

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
    # heads of 32 (and up to 32) count on the persistent kernel, the rest
    # on the ring kernel
    counter = "launches" if padded_width(d) == 32 else "launches_ring"
    n0 = getattr(encoder_self_attention, counter)
    ref = encoder_self_attention_plain(q, k, v, mask, inv).cpu().numpy()
    got = encoder_self_attention(q, k, v, mask, inv).cpu().numpy()
    torch.cuda.synchronize()
    assert getattr(encoder_self_attention, counter) == n0 + 1
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


@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 112, 128])
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


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 63, 65, 400, 512])
def test_ring_kernel_lengths(cuda, s, d):
    """The ring kernel at S 1 (one row, one key), around one row tile (63,
    65), the rerank length and the longest, on the uniform mask with a
    fully masked last pair, at the 1e-2 tolerance."""
    q, k, v, mask = (torch.tensor(a, device=cuda) for a in attn_case(4, s, 3, seed=s, d=d))
    inv = 1.0 / np.sqrt(d)
    n0 = encoder_self_attention.launches_ring
    ref = encoder_self_attention_plain(q, k, v, mask, inv).cpu().numpy()
    got = encoder_self_attention(q, k, v, mask, inv).cpu().numpy()
    torch.cuda.synchronize()
    assert encoder_self_attention.launches_ring == n0 + 1
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("d", [64, 128])
def test_ring_kernel_from_worker_threads(cuda, d):
    """As ``test_attention_kernel_from_worker_threads`` for the ring
    kernel: four threads at once and a side stream give the main thread's
    context bit for bit."""
    cases = []
    for i in range(4):
        q, k, v, _ = attn_case(16, 400, 6, seed=20 + i, d=d)
        cases.append(tuple(torch.tensor(a, device=cuda)
                           for a in (q, k, v, rerank_mask(16, 400, seed=i))))
    inv = 1.0 / np.sqrt(d)
    want = [encoder_self_attention(*c, inv) for c in cases]
    ref = encoder_self_attention_plain(*cases[0], inv)
    torch.cuda.synchronize()
    np.testing.assert_allclose(want[0].cpu().numpy(), ref.cpu().numpy(), atol=1e-2, rtol=1e-2)

    def run(case, side_stream=False):
        stream = torch.cuda.Stream() if side_stream else torch.cuda.current_stream()
        stream.wait_stream(torch.cuda.default_stream())
        with torch.cuda.stream(stream):
            out = encoder_self_attention(*case, inv)
        torch.cuda.synchronize()
        return out

    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(run, cases))
        side = pool.submit(run, cases[1], True).result()
    assert all(torch.equal(w, g) for w, g in zip(want, got))
    assert torch.equal(want[1], side)


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
    x = torch.zeros((1, 0, 2, 32), device=cuda)
    m = torch.ones((1, 600), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        encoder_self_attention(x, x, x, m[:, :0], 0.1)
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


# (p, s, h, d, mask kind): S 128 (one key block: the plain softmax), 256,
# 384 and 512 (the online softmax over 2-4 blocks); heads of 32 (the
# served rerank, 12 of them), 64, 128 and 256, and 8-100, which the wrapper
# pads to 32, 64 or 128; each mask with an all-padding last pair.  "short"
# pairs' real keys end inside the first key block (most (row tile, key
# block) pairs skipped, whole row tiles of pad rows); "segments" holds ids
# in [0, 32) in runs, "wide_ids" ids outside it (32 and up, negative), where
# the kernel skips nothing.  Heads of 256 (the D-256 kernel) at S 128 (the
# single step), 256, 384 and 512, on every mask, and at 67 pairs of 3
# heads: 201 items, not a multiple of the 132 SMs (the persistent tail)
FLASH_CASES = [
    (4, 128, 12, 32, "prefix"), (3, 256, 4, 32, "rerank"), (2, 512, 12, 32, "rerank"),
    (3, 384, 2, 64, "holes"), (2, 512, 2, 128, "prefix"), (2, 256, 2, 256, "prefix"),
    (3, 256, 2, 24, "prefix"), (2, 128, 3, 16, "holes"), (2, 512, 2, 48, "rerank"),
    (2, 256, 2, 100, "prefix"), (2, 512, 12, 32, "all_valid"),
    (3, 512, 12, 32, "short"), (3, 256, 4, 64, "short"), (3, 512, 4, 32, "segments"),
    (2, 128, 4, 32, "segments"), (3, 384, 2, 64, "wide_ids"), (2, 512, 2, 128, "wide_ids"),
    (3, 512, 2, 128, "segments"), (2, 512, 2, 256, "rerank"), (2, 256, 3, 8, "segments"),
    (2, 512, 2, 80, "short"),
    (3, 128, 2, 256, "holes"), (2, 128, 3, 256, "segments"), (2, 384, 3, 256, "segments"),
    (3, 384, 2, 256, "prefix"), (3, 512, 2, 256, "short"), (2, 512, 2, 256, "all_valid"),
    (3, 256, 2, 256, "holes"), (3, 512, 2, 256, "wide_ids"), (67, 256, 3, 256, "rerank"),
]


def flash_mask(kind, p, s, seed=0):
    if kind == "prefix":
        lens = np.random.default_rng(seed).integers(1, s + 1, p)
        mask = prefix_mask(s, lens)
    elif kind == "short":
        mask = prefix_mask(s, np.random.default_rng(seed).integers(1, 128, p))
    elif kind == "segments":
        mask = segment_mask(p, s, (0, 1, 2, 5, 17, 31), seed=seed)
    elif kind == "wide_ids":
        mask = segment_mask(p, s, (-3, 0, 1, 32, 45, 1 << 20), seed=seed)
    elif kind == "rerank":
        mask = rerank_mask(p, s, seed=seed)
    elif kind == "holes":
        mask = holes_mask(p, s, seed=seed)
    else:
        return np.ones((p, s), np.int32)
    mask[-1] = 0
    return mask


@pytest.mark.parametrize("p,s,h,d,kind", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, p, s, h, d, kind):
    """Kernel 7 against its plain version on every row, pad rows included
    (they attend the pad keys only), at atol 1e-2.  Heads of 256 count on
    the D-256 kernel's own counter."""
    q, k, v, _ = attn_case(p, s, h, seed=s + d, d=d)
    q, k, v, mask = (torch.tensor(a, device=cuda) for a in (q, k, v, flash_mask(kind, p, s)))
    inv = 1.0 / np.sqrt(d)
    counter = "launches_wide" if d == 256 else "launches"
    n0 = getattr(encoder_flash_attention, counter)
    ref = flash_attention_plain(q, k, v, mask, inv).cpu().numpy()
    got = encoder_flash_attention(q, k, v, mask, inv).cpu().numpy()
    torch.cuda.synchronize()
    assert getattr(encoder_flash_attention, counter) == n0 + 1
    assert got.shape == (p, s, h * d)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=0)


def test_flash_attention_kernel_relaunch_and_threads(cuda):
    """Relaunches, launches from worker threads and from a side stream give
    the same context bit for bit."""
    q, k, v, _ = attn_case(8, 512, 12, seed=4)
    q, k, v, mask = (torch.tensor(a, device=cuda) for a in (q, k, v, rerank_mask(8, 512)))
    first = encoder_flash_attention(q, k, v, mask, 0.125)

    def run(side_stream):
        stream = torch.cuda.Stream() if side_stream else torch.cuda.current_stream()
        stream.wait_stream(torch.cuda.default_stream())
        with torch.cuda.stream(stream):
            out = encoder_flash_attention(q, k, v, mask, 0.125)
        torch.cuda.synchronize()
        return out

    with ThreadPoolExecutor(4) as pool:
        outs = list(pool.map(run, [False, True, False, True]))
    torch.cuda.synchronize()
    assert all(torch.equal(first, o) for o in outs)


def test_flash_attention_d256_from_worker_threads(cuda):
    """The D-256 kernel launched from four worker threads at once, two of
    them on side streams, on the served layout: each context bit for bit
    the main thread's, and within 1e-2 of the plain version."""
    q, k, v, _ = attn_case(6, 512, 3, seed=9, d=256)
    q, k, v, mask = (torch.tensor(a, device=cuda) for a in (q, k, v, rerank_mask(6, 512)))
    inv = 1.0 / 16.0
    n0 = encoder_flash_attention.launches_wide
    first = encoder_flash_attention(q, k, v, mask, inv)

    def run(side_stream):
        stream = torch.cuda.Stream() if side_stream else torch.cuda.current_stream()
        stream.wait_stream(torch.cuda.default_stream())
        with torch.cuda.stream(stream):
            out = encoder_flash_attention(q, k, v, mask, inv)
        torch.cuda.synchronize()
        return out

    with ThreadPoolExecutor(4) as pool:
        outs = list(pool.map(run, [False, True, False, True]))
    torch.cuda.synchronize()
    assert encoder_flash_attention.launches_wide == n0 + 5
    assert all(torch.equal(first, o) for o in outs)
    ref = flash_attention_plain(q, k, v, mask, inv)
    np.testing.assert_allclose(first.cpu().numpy(), ref.cpu().numpy(), atol=1e-2, rtol=0)


# S above 512 and heads of 384 and up: the rerank layout of 400 keys
# stretched to S (query part kept, documents, hole and tail scaled) and
# the uniform-length mask (lengths 1..S, the last pair all padding); as
# many pairs as keep the plain version's (P, H, S, S) f32 scores near 1 GB


def stretched_rerank(p, s, lq=32, seed=0):
    base = rerank_mask(p, 400, lq=lq, seed=seed)
    src = lq + (np.arange(s - lq) * (400 - lq)) // (s - lq)
    return np.concatenate([base[:, :lq], base[:, src]], axis=1)


def long_case(s, h, d, kind, seed=0):
    p = int(max(2, min(16, 2 ** 28 // (h * s * s))))
    q, k, v, uniform = attn_case(p, s, h, seed=seed + s + d, d=d)
    return q, k, v, (stretched_rerank(p, s, seed=seed) if kind == "rerank" else uniform)


@pytest.mark.parametrize("kind", ["rerank", "uniform"])
@pytest.mark.parametrize("s", [513, 640, 1024, 2048, 4096])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_attention_kernel_above_512(cuda, d, s, kind):
    """Kernel 2 above S 512: the long-pair kernel at heads of 32, the ring
    kernel at 64 and 128, counted on ``launches_long``, against the plain
    version at the other rows' tolerance."""
    q, k, v, mask = (torch.tensor(a, device=cuda) for a in long_case(s, 4, d, kind))
    inv = 1.0 / np.sqrt(d)
    n0 = encoder_self_attention.launches_long
    got = encoder_self_attention(q, k, v, mask, inv)
    torch.cuda.synchronize()
    assert encoder_self_attention.launches_long == n0 + 1
    ref = encoder_self_attention_plain(q, k, v, mask, inv)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("s", [640, 1024, 2048])
def test_long_pair_kernel_relaunch_and_threads(cuda, s):
    """The long-pair kernel (heads of 32 above S 512) relaunched, from
    four worker threads at once (two on side streams) and from a fresh
    thread: every context bit for bit the first, each launch counted on
    ``launches_long``."""
    q, k, v, mask = (torch.tensor(a, device=cuda) for a in long_case(s, 6, 32, "rerank", seed=5))
    inv = 1.0 / np.sqrt(32)
    n0 = encoder_self_attention.launches_long
    first = encoder_self_attention(q, k, v, mask, inv)
    again = encoder_self_attention(q, k, v, mask, inv)
    torch.cuda.synchronize()
    assert torch.equal(first, again)

    def run(side_stream):
        stream = torch.cuda.Stream() if side_stream else torch.cuda.current_stream()
        stream.wait_stream(torch.cuda.default_stream())
        with torch.cuda.stream(stream):
            out = encoder_self_attention(q, k, v, mask, inv)
        torch.cuda.synchronize()
        return out

    with ThreadPoolExecutor(4) as pool:
        outs = list(pool.map(run, [False, True, False, True]))
    fresh = []
    t = threading.Thread(target=lambda: fresh.append(run(False)))
    t.start()
    t.join()
    assert all(torch.equal(first, o) for o in outs + fresh)
    assert encoder_self_attention.launches_long == n0 + 7


@pytest.mark.parametrize("kind", ["rerank", "uniform"])
@pytest.mark.parametrize("d,s", [(d, s) for d in (32, 64, 128, 256) for s in (640, 1024, 2048)]
                         + [(d, s) for d in (384, 512) for s in (128, 512, 1024, 2048)]
                         + [(192, 128), (320, 128), (640, 256), (640, 1024), (768, 256),
                            (896, 128), (1024, 512), (1152, 256), (1536, 384)])
def test_flash_attention_kernel_long_and_wide(cuda, d, s, kind):
    """Kernel 7 above S 512 (heads of 32 on the long-row kernel, its own
    counter; the skip rule's presence masks made per tile and per block)
    and at heads of 384 and wider (the slab kernel, its own counter: one
    column group up to 512, two at 640-1,024 (640 and 896 in two
    launches, 3 + 2 and 4 + 3), three at 1,152 and 1,536, q staged a block
    above 1,024); heads of 192 and 320 at S 128, which
    jax's single step takes, padded to 256 and 384.  Every row at atol
    1e-2."""
    q, k, v, mask = (torch.tensor(a, device=cuda) for a in long_case(s, 2, d, kind))
    mask[-1] = 0
    inv = 1.0 / np.sqrt(d)
    dp = flash_attention.padded_head_dim(d, s)
    counter = flash_attention.launch_counter(dp, s)
    n0 = getattr(encoder_flash_attention, counter)
    got = encoder_flash_attention(q, k, v, mask, inv)
    torch.cuda.synchronize()
    assert getattr(encoder_flash_attention, counter) == n0 + 1
    ref = flash_attention_plain(q, k, v, mask, inv)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=1e-2, rtol=0)


@pytest.mark.parametrize("d,s", [(32, 1024), (32, 2048), (384, 1024), (384, 128), (512, 256),
                                 (640, 256), (1152, 256)])
def test_long_and_wide_kernels_relaunch_and_threads(cuda, d, s):
    """The long-row kernel (heads of 32 above S 512) and the slab kernel
    (its clusters of two blocks, one column group and several, q staged
    above 1,024) relaunched, from worker threads and on a side stream:
    every context bit for bit the first."""
    q, k, v, mask = (torch.tensor(a, device=cuda) for a in long_case(s, 3, d, "rerank", seed=3))
    inv = 1.0 / np.sqrt(d)
    fns = [lambda: encoder_flash_attention(q, k, v, mask, inv)]
    if d <= 128:
        fns.append(lambda: encoder_self_attention(q, k, v, mask, inv))
    for fn in fns:
        first = fn()

        def run(side_stream, fn=fn):
            stream = torch.cuda.Stream() if side_stream else torch.cuda.current_stream()
            stream.wait_stream(torch.cuda.default_stream())
            with torch.cuda.stream(stream):
                out = fn()
            torch.cuda.synchronize()
            return out

        with ThreadPoolExecutor(4) as pool:
            outs = list(pool.map(run, [False, True, False, True]))
        assert all(torch.equal(first, o) for o in outs)


# -- kernels 8 and 9: the flash attention's backward -----------------------------

FLASH_BWD_CASES = [
    (p, s, h, d, kind)
    for s, d, h in ((128, 32, 4), (256, 32, 4), (512, 32, 12), (1024, 32, 2), (128, 64, 4),
                    (512, 64, 4), (256, 128, 2), (512, 128, 2), (128, 256, 2), (512, 256, 2),
                    (128, 384, 2), (512, 384, 2), (1024, 384, 2))
    for p, kind in ((3, "prefix"), (3, "rerank"), (3, "holes"))
]


def flash_bwd_case(p, s, h, d, kind, dev, seed=0):
    """Kernel inputs at width ``d`` (padded as the forward pads it), the
    forward's context and residuals from the card, a cotangent and di."""
    q, k, v, _ = attn_case(p, s, h, seed=seed + s + d, d=d)
    q, k, v, mask = (torch.tensor(a, device=dev) for a in (q, k, v, flash_mask(kind, p, s)))
    inv = 1.0 / np.sqrt(d)
    qb, kb, vb = flash_attention.kernel_inputs(q, k, v)
    seg = mask.to(torch.int32)
    out, m, l = flash_attention_kernel(qb, kb, vb, seg, inv, residuals=True)
    g = torch.randn(p, s, h, d, device=dev, generator=torch.Generator(dev).manual_seed(seed))
    do = g.to(torch.bfloat16)
    di = (out[..., :d].float() * do.float()).sum(-1).permute(0, 2, 1).contiguous()
    dp = qb.shape[-1]
    dob = torch.nn.functional.pad(do, (0, dp - d)).contiguous()
    return dict(qb=qb, kb=kb, vb=vb, seg=seg, out=out, m=m, l=l, do=do, dob=dob, di=di,
                inv=inv, d=d)


@pytest.mark.parametrize("p,s,h,d,kind", FLASH_BWD_CASES)
def test_flash_backward_kernels_match_plain(cuda, p, s, h, d, kind):
    """Kernels 8 (dK, dV) and 9 (dQ) against ``flash_attention_bwd_plain``
    on the same card inputs (the card's forward residuals), each within
    2^-7 of the plain gradient's largest magnitude (one bf16 step of it:
    the two round p and dS at the same points, their f32 sums in another
    order); the forward's m and l against ``flash_attention_fwd_plain``'s
    (m within 1e-3, l within 1e-3 relative: the kernel's ex2.approx) and
    its context with residuals bit for bit the one without."""
    c = flash_bwd_case(p, s, h, d, kind, cuda)
    counters = [flash_attention.bwd_counter(c["qb"].shape[-1], dkv) for dkv in (True, False)]
    n0 = [getattr(encoder_flash_attention, name) for name in counters]
    got = flash_attention.flash_attention_bwd_kernel(
        c["qb"], c["kb"], c["vb"], c["seg"], c["m"], c["l"], c["dob"], c["di"], c["inv"])
    torch.cuda.synchronize()
    assert [getattr(encoder_flash_attention, name) for name in counters] == [n + 1 for n in n0]
    out_ref, m_ref, l_ref = flash_attention.flash_attention_fwd_plain(
        c["qb"], c["kb"], c["vb"], c["seg"], c["inv"])
    torch.testing.assert_close(c["m"], m_ref, atol=1e-3, rtol=0)
    torch.testing.assert_close(c["l"], l_ref, atol=0, rtol=1e-3)
    assert torch.equal(c["out"], flash_attention_kernel(c["qb"], c["kb"], c["vb"], c["seg"],
                                                         c["inv"]))
    ref = flash_attention.flash_attention_bwd_plain(
        c["qb"], c["kb"], c["vb"], c["seg"], c["dob"], c["m"], c["l"], c["di"], c["inv"])
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == r.shape == c["qb"].shape and a.dtype == torch.bfloat16
        a, r = a.float(), r.float()
        assert torch.isfinite(a).all()
        # the padded columns are zero
        assert not a[..., d:].any()
        err = float((a - r).abs().max())
        assert err <= 2.0 ** -7 * float(r.abs().max()), (name, err, float(r.abs().max()))


def bwd_against_plain(c):
    """Kernels 8 and 9 once each on the case, against the plain twins
    (each gradient within 2^-7 of the plain one's largest magnitude);
    returns the kernels' gradients."""
    args = [c[k] for k in ("qb", "kb", "vb", "seg", "m", "l", "dob", "di")]
    got = flash_attention.flash_attention_bwd_kernel(*args, c["inv"])
    torch.cuda.synchronize()
    ref = flash_attention.flash_attention_bwd_plain(*args[:4], c["dob"], *args[4:6], c["di"],
                                                    c["inv"])
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        a, r = a.float(), r.float()
        assert torch.isfinite(a).all() and not a[..., c["d"]:].any(), name
        err = float((a - r).abs().max())
        assert err <= 2.0 ** -7 * float(r.abs().max()), (name, err, float(r.abs().max()))
    return got


@pytest.mark.parametrize("s", [128, 256, 384, 512, 640, 768, 1024])
@pytest.mark.parametrize("d", [32, 64])
def test_flash_backward_unit_kernel_lengths(cuda, s, d):
    """The unit kernel (heads of 32 and 64) at every S from 128 to 1,024
    on the rerank-layout mask against the plain twins; two launches of
    each kernel give the same bits."""
    c = flash_bwd_case(2, s, 4, d, "rerank", cuda, seed=7)
    first = bwd_against_plain(c)
    again = flash_attention.flash_attention_bwd_kernel(
        *(c[k] for k in ("qb", "kb", "vb", "seg", "m", "l", "dob", "di")), c["inv"])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("s,d", [(128, 128), (256, 128), (1024, 128), (128, 192), (128, 256),
                                 (384, 256), (1024, 256), (128, 320), (256, 384), (640, 384),
                                 (256, 512), (128, 640), (256, 1024)])
@pytest.mark.parametrize("kind", ["rerank", "segments"])
def test_flash_backward_wide_kernel_widths(cuda, s, d, kind):
    """The wide kernel (heads of 128 and wider) at every kind of plan: the
    own tile resident with 64-, 32- and 16-row walked blocks, dK/dV in two
    column groups (384, 512), windows of the head above 512 (640, 1024),
    and heads of 192 and 320 at S 128 (padded to 256 and 384 as the
    forward pads them); on the rerank-layout mask and on
    several segments a pair, against the plain twins and bit for bit over
    two launches, each counted on the wide counters."""
    c = flash_bwd_case(2, s, 2, d, kind, cuda, seed=13)
    counters = ("launches_bwd_wide_dkv", "launches_bwd_wide_dq")
    n0 = [getattr(encoder_flash_attention, name) for name in counters]
    first = bwd_against_plain(c)
    again = flash_attention.flash_attention_bwd_kernel(
        *(c[k] for k in ("qb", "kb", "vb", "seg", "m", "l", "dob", "di")), c["inv"])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert [getattr(encoder_flash_attention, name) for name in counters] == [n + 2 for n in n0]


@pytest.mark.parametrize("s,kind", [(128, "prefix"), (384, "holes"), (640, "wide_ids"),
                                    (896, "segments")])
def test_flash_backward_unit_tiles_past_s(cuda, s, kind):
    """A unit whose last own tiles fall past S: at heads of 32 units of
    four tiles, and S / 64 = 2, 6, 10 and 14 tiles leave an item's last
    unit two tiles short; ids outside [0, 32) and several segments a pair
    in the skip rule; the gradients against the plain twins, and bit for
    bit over two launches."""
    for dkv in (True, False):
        assert (s // 64) % flash_attention.bwd_plan(3, s, 2, 32, dkv).unit != 0
    c = flash_bwd_case(3, s, 2, 32, kind, cuda, seed=11)
    first = bwd_against_plain(c)
    again = flash_attention.flash_attention_bwd_kernel(
        *(c[k] for k in ("qb", "kb", "vb", "seg", "m", "l", "dob", "di")), c["inv"])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_attention_under_grad_runs_its_backward(cuda):
    """``encoder_flash_attention`` on CUDA tensors that require grad runs
    kernel 7 with residuals and, in the backward, kernels 8 and 9 once
    each; the gradients match the CPU's autograd function (its plain
    twins) on the same inputs within 2^-7 of their largest magnitude, and
    two runs give the same bits.  At heads of 24 the padding is sliced
    off the gradients."""
    for p, s, h, d in ((3, 512, 12, 32), (2, 256, 2, 24), (2, 128, 2, 384)):
        q, k, v, _ = attn_case(p, s, h, seed=s + d, d=d)
        mask = flash_mask("rerank", p, s)
        g = np.random.default_rng(d).standard_normal((p, s, h * d)).astype(np.float32)
        inv = 1.0 / np.sqrt(d)
        runs = []
        for dev in ("cuda", "cuda", "cpu"):
            leaves = [torch.tensor(a, device=dev, requires_grad=True) for a in (q, k, v)]
            bwd = [flash_attention.bwd_counter(flash_attention.padded_head_dim(d, s), dkv)
                   for dkv in (True, False)]
            n = (encoder_flash_attention.launches, encoder_flash_attention.launches_slab,
                 *(getattr(encoder_flash_attention, name) for name in bwd))
            out = encoder_flash_attention(*leaves, torch.tensor(mask, device=dev), inv)
            out.backward(torch.tensor(g, device=dev))
            if dev == "cuda":
                torch.cuda.synchronize()
                now = (encoder_flash_attention.launches, encoder_flash_attention.launches_slab,
                       *(getattr(encoder_flash_attention, name) for name in bwd))
                fwd = (0, 1) if d == 384 else (1, 0)
                assert tuple(b - a for a, b in zip(n, now)) == (*fwd, 1, 1)
            runs.append([out.detach().cpu()] + [t.grad.cpu() for t in leaves])
        assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
        torch.testing.assert_close(runs[0][0], runs[2][0], atol=1e-2, rtol=0)
        for a, r in zip(runs[0][1:], runs[2][1:]):
            assert a.shape == (p, s, h, d) and a.dtype == torch.float32
            assert float((a - r).abs().max()) <= 2.0 ** -7 * float(r.abs().max())


def test_flash_backward_kernel_rejects_inputs(cuda):
    c = flash_bwd_case(2, 128, 2, 32, "prefix", cuda)
    args = [c[k] for k in ("qb", "kb", "vb", "seg", "m", "l", "dob", "di")]
    bwd = flash_attention.flash_attention_bwd_kernel
    with pytest.raises(ValueError, match="dO"):
        bwd(*args[:6], c["dob"].float(), args[7], c["inv"])
    with pytest.raises(ValueError, match="m must"):
        bwd(args[0], args[1], args[2], args[3], c["m"][:, :, :64], *args[5:], c["inv"])
    with pytest.raises(ValueError, match="contiguous"):
        bwd(*args[:7], c["di"].transpose(1, 2).contiguous().transpose(1, 2), c["inv"])
    with pytest.raises(ValueError, match="head_dim"):
        y = torch.zeros((2, 128, 2, 24), dtype=torch.bfloat16, device=cuda)
        bwd(y, y, y, args[3], *args[4:6], y, args[7], c["inv"])


def test_flash_attention_kernel_rejects_shapes(cuda):
    m = torch.ones((1, 512), dtype=torch.int32, device=cuda)
    for s, d in ((200, 32), (704, 32), (64, 32), (256, 192), (384, 320)):
        x = torch.zeros((1, s, 2, d), device=cuda)
        with pytest.raises(ValueError):
            encoder_flash_attention(x, x, x, torch.ones((1, s), device=cuda), 0.1)
    y = torch.zeros((1, 128, 2, 24), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_kernel(y, y, y, m[:, :128], 0.1)
    z = torch.zeros(1 + 128 * 2 * 32, dtype=torch.bfloat16, device=cuda)[1:].view(1, 128, 2, 32)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_kernel(z, z, z, m[:, :128], 0.1)


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


# -- training: no kernel under grad, and a step on the card against the CPU --------


def graded_inputs(dev):
    """One call of each kernel wrapper on small CUDA inputs, by name:
    ``call(requires_grad)``, whose first float operand requires grad when
    asked, as a graded forward would hand it over."""

    def leaf(t, rg):
        return t.detach().clone().requires_grad_(rg)

    c = block_case(256, 128, 512, dev)
    q, k, v = (torch.randn(2, 64, 4, 32, device=dev) for _ in range(3))
    mask = torch.ones(2, 64, dtype=torch.int32, device=dev)
    tq, tc, tcodes, tqf = (torch.tensor(a, device=dev) for a in topk_case(4, 2048, 64, 2000))
    pq, pqf, pemb, pcodes, pgids, ptiles, _ = (
        torch.tensor(a, device=dev) if isinstance(a, np.ndarray) else a
        for a in probe_case(4, 64, 8, 128))
    return {
        "pair_attention": lambda rg: encoder_self_attention(leaf(q, rg), k, v, mask, 0.1),
        "fused_qkv": lambda rg: fused_bert.fused_qkv(leaf(c["x"], rg), *qkv_args(c)[1:]),
        "fused_resid_ln": lambda rg: fused_bert.fused_resid_ln(
            c["x"], c["ctx"], leaf(c["w"][3], rg), c["b"][3], c["s"], c["lb"], 1e-12),
        "fused_ffn_ln": lambda rg: fused_bert.fused_ffn_ln(
            *(leaf(t, rg) if n == 1 else t for n, t in enumerate(ffn_args(c)))),
        "masked_topk": lambda rg: masked_topk(leaf(tq.bfloat16(), rg), tc.bfloat16(), tcodes,
                                              tqf, 2000, 5),
        "ivf_probe": lambda rg: ivf_probe(leaf(pq.bfloat16(), rg), pqf, pemb.bfloat16(), pcodes,
                                          pgids, ptiles, 5, tile=128),
    }


@pytest.mark.parametrize("name", ["pair_attention", "fused_qkv", "fused_resid_ln",
                                  "fused_ffn_ln", "masked_topk", "ivf_probe"])
def test_kernel_wrappers_refuse_inputs_that_require_grad(cuda, name):
    """A kernel without a backward: handed a CUDA tensor that requires grad
    under grad mode, its wrapper raises instead of cutting the graph; the
    same call without grad launches.  (The flash attention has a backward,
    kernels 8 and 9: ``test_flash_attention_under_grad_runs_its_backward``.)"""
    call = graded_inputs(cuda)[name]
    with pytest.raises(RuntimeError, match="no backward"):
        call(True)
    with torch.no_grad():
        call(True)
    out = call(False)
    torch.cuda.synchronize()
    assert all(not t.requires_grad for t in (out if isinstance(out, tuple) else (out,)))


TRAIN_LR = 1e-4


def train_case(objective, dev):
    """(loss, grads by name, updated weights by name) of one step of
    ``objective`` on ``dev`` at a tiny width, from weights that 8 steps on
    the CPU took away from the random init (where InfoNCE sits at chance
    and its gradient is mostly rounding noise)."""
    from financial_rag_system_tpu_torch.models import bert
    from financial_rag_system_tpu_torch.models.tokenizer import Tokenizer, pad_batch
    from financial_rag_system_tpu_torch.train import contrastive, cross_encoder, distill
    from financial_rag_system_tpu_torch.train.optim import ClippedAdamW, graded

    cfg = bert.BertConfig(vocab_size=30522, hidden=64, layers=2, heads=2, intermediate=128,
                          max_positions=512, with_pooler=True,
                          num_labels=1 if objective == "bce" else 0)
    tok = Tokenizer()
    texts = [f"question {i} about revenue growth and margin" for i in range(4)]
    docs = [f"the company reported segment {i} results " * (3 + 20 * (i % 2)) for i in range(4)]

    def loss_of(model):
        d = model.device
        if objective == "bce":
            batch = pad_batch([tok.encode_pair(q, x, 512) for q, x in zip(texts, docs)])
            labels = torch.tensor([1.0, 0.0, 0.0, 1.0], device=d)
            return cross_encoder.bce_loss(model, *contrastive.on_device(batch, d), labels, 3.0)
        q, p, n = contrastive.tokenize_pairs(tok, list(zip(texts, docs, docs[1:] + docs[:1])))
        q, p, n = (contrastive.on_device(b, d) for b in (q, p, n))
        if objective == "infonce":
            return contrastive.info_nce_loss(model, q, p, 0.05, n, 0.5)
        return distill.margin_mse_loss(model, q, p, n,
                                       torch.tensor([0.5, -1.0, 2.0, 0.1], device=d))

    start = bert.BertModel(cfg, device="cpu")
    bert.load_jax_params(start, bert.init_params(torch.Generator().manual_seed(0), cfg))
    opt = ClippedAdamW(start, 1e-3)
    for _ in range(8):
        with graded(start):
            loss_of(start).backward()
        opt.step()
    model = bert.BertModel(cfg, device=dev)
    model.load_state_dict(start.state_dict())
    with graded(model):
        loss = loss_of(model)
        loss.backward()
    grads = {k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    ClippedAdamW(model, TRAIN_LR).step()
    return float(loss.detach()), grads, {k: p.detach().cpu() for k, p in model.named_parameters()}


@pytest.mark.parametrize("objective", ["infonce", "bce", "margin_mse"])
def test_training_step_on_the_card_matches_the_cpu(cuda, monkeypatch, objective):
    """One step of each objective on the card (tanh GELU, the tensor-core
    products with their backward) against the CPU with tanh GELU, from the
    same weights, held to ``chip_smoke.py``'s phase-9 tolerances
    (``compare_steps``: the losses, the gradients' L2 difference over
    their norm, and the updated weights in learning rates)."""
    import chip_smoke

    monkeypatch.setenv("RAG_TPU_FAST_GELU", "1")  # the card's default, on the CPU too
    c = chip_smoke.compare_steps(torch, TRAIN_LR, train_case(objective, cuda),
                                 train_case(objective, "cpu"))
    assert c["ok"], c


@pytest.mark.parametrize("rows", [2, 30522], ids=["type", "word"])
def test_graded_embedding_backward_is_the_same_in_every_run(cuda, rows):
    """The graded forward's embedding lookup on the card (``bert._Lookup``)
    adds a row's gradients in one order: over a (32, 512) pair batch, where
    ``F.embedding``'s backward gives the 2-row type table's gradient a
    different sum in each run, ten backwards agree bit for bit, within f32
    rounding of the exact sum."""
    from financial_rag_system_tpu_torch.models import bert

    gen = torch.Generator(device=cuda).manual_seed(0)
    ids = torch.randint(0, rows, (32, 512), device=cuda, generator=gen)
    g = torch.randn(32, 512, 384, device=cuda, generator=gen)
    grads = []
    for _ in range(10):
        table = torch.zeros(rows, 384, device=cuda, requires_grad=True)
        (bert._embedding(ids, table) * g).sum().backward()
        grads.append(table.grad)
    assert all(torch.equal(grads[0], x) for x in grads[1:])
    exact = torch.zeros(rows, 384, dtype=torch.float64, device=cuda).index_add_(
        0, ids.reshape(-1), g.reshape(-1, 384).double())
    torch.testing.assert_close(grads[0].double(), exact, rtol=0,
                               atol=1e-5 * float(exact.abs().max()))


def test_cross_encoder_trains_the_same_twice_on_the_card(cuda):
    """Two runs of the cross-encoder trainer from the same weights on
    (32, 512) pair batches: the same losses and weights, bit for bit."""
    from financial_rag_system_tpu_torch.data.synthetic import expand_chunk
    from financial_rag_system_tpu_torch.models import bert
    from financial_rag_system_tpu_torch.train import cross_encoder

    cfg = bert.BertConfig(vocab_size=30522, hidden=64, layers=2, heads=2, intermediate=128,
                          max_positions=512, with_pooler=True, num_labels=1)
    examples = [(q, expand_chunk(d, 1000), lbl) for q, d, lbl in
                cross_encoder.make_cross_examples(tickers=["AAPL"], seed=1)[:96]]
    runs = []
    for _ in range(2):
        model = bert.BertModel(cfg, device=cuda)
        bert.load_jax_params(model, bert.init_params(torch.Generator().manual_seed(0), cfg))
        _, losses = cross_encoder.train_cross_encoder(model, examples, batch_size=32, lr=1e-3,
                                                      max_len=512, seed=1)
        runs.append((losses, [p.detach().clone() for p in model.parameters()]))
    assert len(runs[0][0]) == 3 and runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
