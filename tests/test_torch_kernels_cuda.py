"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with ``nvcc``; skips without one.  Imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from financial_rag_system_tpu_torch.index.ivf import ivf_probe, ivf_probe_plain
from financial_rag_system_tpu_torch.ops.attention import (
    encoder_self_attention,
    encoder_self_attention_plain,
)
from financial_rag_system_tpu_torch.ops.topk import masked_topk, masked_topk_plain

pytestmark = pytest.mark.cuda


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
                (32, 131072, 384, 15), (5, 2048, 64, 32)],
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
                           (40, 384, 20, 256, 15)],
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
        ivf_probe(*args, 33, tile=64)
    with pytest.raises(ValueError, match="tile"):
        ivf_probe(*args, 5, tile=96)


def attn_case(p, s, h, seed=0, masked_pair=True):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((p, s, h, 32)).astype(np.float32)
               for _ in range(3))
    lens = rng.integers(1, s + 1, p)
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    if masked_pair:
        mask[-1] = 0
    return q, k, v, mask


@pytest.mark.parametrize(
    "p,s,h", [(4, 50, 12), (3, 130, 4), (2, 400, 12), (2, 512, 2), (2, 1, 3),
              (32, 32, 12)],
)
def test_attention_kernel_matches_plain(cuda, p, s, h):
    arrs = attn_case(p, s, h)
    q, k, v, mask = (torch.tensor(a, device=cuda) for a in arrs)
    inv = 1.0 / np.sqrt(32)
    ref = encoder_self_attention_plain(q, k, v, mask, inv).cpu().numpy()
    got = encoder_self_attention(q, k, v, mask, inv).cpu().numpy()
    torch.cuda.synchronize()
    assert got.shape == (p, s, h * 32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=1e-2)


def test_attention_kernel_rejects_shapes(cuda):
    x = torch.zeros((1, 600, 2, 32), device=cuda)
    m = torch.ones((1, 600), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        encoder_self_attention(x, x, x, m, 0.1)
    y = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(ValueError):
        encoder_self_attention(y, y, y, m[:, :8], 0.1)
