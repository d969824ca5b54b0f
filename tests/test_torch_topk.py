"""The port's masked top-k against the JAX package's, on the CPU.

The port runs its plain version here; the references are JAX
``masked_topk_xla`` and the Pallas kernel in interpret mode (as
tests/test_topk.py runs it).  Same numpy inputs; bf16 and int8 corpora.
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


def int8_case(seed):
    """make_case quantized as FlatIndex quantizes (round(v * 127), clipped
    to +-127), with a fifth of the rows copies of 20 others, so that equal
    integer scores are frequent, and one query equal to a duplicated row."""
    q, c, codes, qf = make_case(seed)
    rng = np.random.default_rng(seed + 100)
    dup = np.arange(0, N, 5)
    c[dup] = c[rng.integers(1, N, 20)][rng.integers(0, 20, len(dup))]
    q[6], qf[6] = c[dup[3]], -1
    quant = lambda a: np.clip(np.rint(a * 127.0), -127, 127).astype(np.int8)  # noqa: E731
    return quant(q), quant(c), codes, qf


def port_int8(q, c, codes, qf, n_valid=N_VALID, k=K):
    s, i = ttopk.masked_topk(torch.from_numpy(q), torch.from_numpy(c),
                             torch.from_numpy(codes), torch.from_numpy(qf), n_valid, k)
    return s.numpy(), i.numpy()


def assert_bit_equal(got, want):
    """Scores equal bit for bit, ids equal wherever the score is finite,
    empty slots -1 in the port."""
    (s, i), (s_ref, i_ref) = got, want
    assert s.dtype == np.float32 and i.dtype == np.int32
    np.testing.assert_array_equal(s, s_ref)
    fin = np.isfinite(s_ref)
    np.testing.assert_array_equal(i[fin], i_ref[fin])
    assert (i[~fin] == -1).all()


def test_int8_matches_xla_bit_for_bit():
    q, c, codes, qf = int8_case(seed=3)
    got = port_int8(q, c, codes, qf)
    want = masked_topk_xla(jnp.asarray(q), jnp.asarray(c), jnp.asarray(codes),
                           jnp.asarray(qf), N_VALID, K)
    assert_bit_equal(got, tuple(np.asarray(x) for x in want))
    s, i = got
    fin = np.isfinite(s)
    assert (s[fin] == np.round(s[fin])).all()  # integer scores
    # ties: the duplicated row's copies score alike, lower row first
    s6, i6 = s[6][fin[6]], i[6][fin[6]]
    tie = np.diff(s6) == 0
    assert tie.sum() >= 3 and (np.diff(i6)[tie] > 0).all()


@pytest.mark.parametrize("int8_mxu", [True, False])
def test_int8_matches_pallas_interpret(int8_mxu):
    """Both variants of the Pallas kernel's int8 branch (native int8
    products, or both widened to f32) give the port's scores and ids."""
    q, c, codes, qf = int8_case(seed=4)
    want = masked_topk_pallas(jnp.asarray(q), jnp.asarray(c), jnp.asarray(codes),
                              jnp.asarray(qf), N_VALID, K, tile=1024, interpret=True,
                              int8_mxu=int8_mxu)
    assert_bit_equal(port_int8(q, c, codes, qf), tuple(np.asarray(x) for x in want))


@pytest.mark.parametrize("n_valid,rows,k", [(10, N, K), (4, 4, K), (N_VALID, N, 1), (N, N, 32)])
def test_int8_n_valid_small_corpus_and_k(n_valid, rows, k):
    """n_valid below N, a corpus smaller than k (empty slots), k 1 and 32:
    bit for bit against masked_topk_xla."""
    q, c, codes, qf = int8_case(seed=5)
    c, codes = c[:rows], codes[:, :rows].copy()
    got = port_int8(q, c, codes, qf, n_valid=n_valid, k=k)
    want = masked_topk_xla(jnp.asarray(q), jnp.asarray(c), jnp.asarray(codes),
                           jnp.asarray(qf), n_valid, k)
    assert_bit_equal(got, tuple(np.asarray(x) for x in want))
    assert got[0].shape == (B, k)
    assert (got[1][np.isfinite(got[0])] < n_valid).all()


def test_wrapper_refuses_other_dtypes():
    with pytest.raises(ValueError, match="bf16 or int8"):
        ttopk.masked_topk(torch.zeros((1, 32)), torch.zeros((4, 32)),
                          torch.zeros((2, 4), dtype=torch.int32),
                          torch.full((1, 2), -1, dtype=torch.int32), 4, 2)


@pytest.mark.parametrize("k", [33, 64, 100])
def test_k_above_a_round_matches_xla_and_pallas(k):
    """k above the kernel's 32-entry round, bf16: the plain version against
    masked_topk_xla and the Pallas kernel in interpret mode, with the
    duplicated rows in row order."""
    q, c, codes, qf = make_case(seed=k)
    s, i = port(q, c, codes, qf, k=k)
    args = jax_args(q, c, codes, qf)[:-1] + (k,)
    s_x, i_x = (np.asarray(x) for x in masked_topk_xla(*args))
    s_p, i_p = (np.asarray(x) for x in masked_topk_pallas(*args, tile=1024, interpret=True))
    fin = np.isfinite(s_x)
    np.testing.assert_array_equal(np.isfinite(s), fin)
    np.testing.assert_array_equal(np.isfinite(s_p), fin)
    np.testing.assert_allclose(s[fin], s_x[fin], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(i[fin], i_x[fin])
    np.testing.assert_array_equal(i[fin], i_p[fin])
    assert (i[~fin] == -1).all() and fin[3].sum() == 3
    assert list(i[7, :3]) == [1500, 2001, 3000]


@pytest.mark.parametrize("k", [33, 64, 100])
def test_int8_k_above_a_round_matches_pallas_interpret(k):
    """int8 at k above a round: bit for bit against the Pallas kernel."""
    q, c, codes, qf = int8_case(seed=k)
    want = masked_topk_pallas(jnp.asarray(q), jnp.asarray(c), jnp.asarray(codes),
                              jnp.asarray(qf), N_VALID, k, tile=1024, interpret=True)
    assert_bit_equal(port_int8(q, c, codes, qf, k=k), tuple(np.asarray(x) for x in want))
