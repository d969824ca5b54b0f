"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with ``nvcc``; skips without one.  Imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

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
