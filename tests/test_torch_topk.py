"""The port's masked top-k against the JAX package's, on the CPU.

The port runs its plain version here; the references are JAX
``masked_topk_xla`` and the Pallas kernel in interpret mode (as
tests/test_topk.py runs it).  Same numpy inputs.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from financial_rag_system_tpu.ops.topk import masked_topk_pallas, masked_topk_xla
from financial_rag_system_tpu_torch.ops import topk as ttopk

B, N, D, K = 8, 4096, 64, 15
N_VALID = N - 300


def make_case(seed=0, n_tickers=6):
    """Mixed wildcard / ticker / ticker+doctype filters, a filter with
    fewer than K matches, n_valid < N and duplicated rows (exact ties)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, D)).astype(np.float32)
    c = rng.standard_normal((N, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    c[2001] = c[1500]
    c[3000] = c[1500]
    codes = np.stack([
        rng.integers(0, n_tickers, N), rng.integers(0, 3, N),
    ]).astype(np.int32)
    codes[0, [5, 900, 2500]] = n_tickers        # a ticker on 3 rows only
    codes[:, [1500, 2001, 3000]] = [[0], [1]]
    codes[:, N_VALID:] = -2
    qf = np.array(
        [[-1, -1], [0, -1], [1, 2], [n_tickers, -1], [0, 1], [-1, 2],
         [2, -1], [-1, -1]], np.int32,
    )
    q[7] = c[1500]  # query 7 ties on the duplicated rows
    return q, c, codes, qf


def bf16(a):
    """Round to bf16 in numpy (via torch) so every path scores the same
    bf16 values."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def port(q, c, codes, qf, n_valid=N_VALID, k=K):
    s, i = ttopk.masked_topk(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(c).bfloat16(),
        torch.from_numpy(codes), torch.from_numpy(qf), n_valid, k,
    )
    return s.numpy(), i.numpy()


def jax_args(q, c, codes, qf):
    return (jnp.asarray(bf16(q)), jnp.asarray(bf16(c)), jnp.asarray(codes),
            jnp.asarray(qf), N_VALID, K)


def test_matches_xla():
    q, c, codes, qf = make_case()
    s, i = port(q, c, codes, qf)
    s_ref, i_ref = (np.asarray(x) for x in masked_topk_xla(*jax_args(q, c, codes, qf)))
    np.testing.assert_array_equal(np.isfinite(s), np.isfinite(s_ref))
    fin = np.isfinite(s_ref)
    np.testing.assert_allclose(s[fin], s_ref[fin], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(i[fin], i_ref[fin])
    # empty slots: -inf with id -1
    assert (~fin).any() and (i[~fin] == -1).all()
    assert fin[3].sum() == 3  # the 3-row ticker


def test_ties_match_pallas_interpret():
    q, c, codes, qf = make_case(seed=1)
    s, i = port(q, c, codes, qf)
    s_pal, i_pal = (
        np.asarray(x) for x in masked_topk_pallas(
            *jax_args(q, c, codes, qf), tile=1024, interpret=True
        )
    )
    fin = np.isfinite(s_pal)
    np.testing.assert_array_equal(np.isfinite(s), fin)
    np.testing.assert_allclose(s[fin], s_pal[fin], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(i[fin], i_pal[fin])
    # the duplicated rows tie exactly; the lower row comes first
    assert list(i[7, :3]) == [1500, 2001, 3000]
    assert s[7, 0] == s[7, 1] == s[7, 2]


def test_n_valid_and_small_corpus():
    q, c, codes, qf = make_case(seed=2)
    s, i = port(q, c, codes, qf, n_valid=10)
    assert (i[np.isfinite(s)] < 10).all()
    s, i = port(q[:2], c[:4], codes[:, :4], qf[:2], n_valid=4)
    assert s.shape == (2, K) and (i[:, 4:] == -1).all()
    assert np.isneginf(s[:, 4:]).all()


def test_int8_corpus_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttopk.masked_topk(
            torch.zeros((1, 8), dtype=torch.int8),
            torch.zeros((4, 8), dtype=torch.int8),
            torch.zeros((2, 4), dtype=torch.int32),
            torch.full((1, 2), -1, dtype=torch.int32), 4, 2,
        )
