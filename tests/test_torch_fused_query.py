"""The slice as a whole: the port's fused_two_stage against the JAX one.

Same weights (JAX ``init_params`` through ``load_jax_params``), same
queries, corpus, codes and token store, on the CPU.  The corpus plants
15 rows per query at cosines 0.02 apart, under that query's ticker, and
keeps every other row orthogonal to the queries, so the ranking is not
decided by noise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the fused-block patches of both packages, as fixtures
from test_torch_fused_bert import FUSED_FNS, fresh_jit, fused_block  # noqa: F401

from financial_rag_system_tpu.models import bert as jbert
from financial_rag_system_tpu.ops import fused_query as jfq
from financial_rag_system_tpu_torch.models import bert as tbert
from financial_rag_system_tpu_torch.ops import fused_query as tfq

TINY = dict(vocab_size=1000, hidden=64, layers=2, heads=2, intermediate=128,
            max_positions=512, with_pooler=True)
B, N, DLEN, K, LQ = 4, 2048, 24, 15, 32


def models(seed, **extra):
    jcfg = jbert.BertConfig(**TINY, **extra)
    tcfg = tbert.BertConfig(**TINY, **extra)
    params = jbert.init_params(jax.random.PRNGKey(seed), jcfg)
    model = tbert.BertModel(tcfg, device="cpu")
    tbert.load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    return params, jcfg, model, tcfg


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    e_params, e_jcfg, e_model, e_tcfg = models(0)
    r_params, r_jcfg, r_model, r_tcfg = models(1, num_labels=1)

    lens = np.array([9, 20, 5, 32])
    q_ids = rng.integers(1000 // 2, 1000, (B, LQ)).astype(np.int32)
    q_mask = (np.arange(LQ)[None, :] < lens[:, None]).astype(np.int32)
    q_ids[:, 0] = 101
    q_ids[np.arange(B), lens - 1] = 102
    q_ids *= q_mask
    q_types = np.zeros_like(q_ids)

    h = np.asarray(jbert.encode(e_params, q_ids, q_types, q_mask, e_jcfg))
    qv = h[:, 0] / np.linalg.norm(h[:, 0], axis=1, keepdims=True)

    # rows orthogonal to every query, then 15 planted rows per query
    c = rng.standard_normal((N, 64))
    basis, _ = np.linalg.qr(qv.T)            # (64, B) orthonormal span
    c -= (c @ basis) @ basis.T
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    planted = rng.permutation(N - 100)[: B * K].reshape(B, K)
    for i in range(B):
        for j, row in enumerate(planted[i]):
            cos = 0.9 - 0.02 * j
            c[row] = cos * qv[i] + np.sqrt(1 - cos**2) * c[row]
    codes = np.stack([rng.integers(0, 4, N), rng.integers(0, 2, N)]).astype(np.int32)
    # one ticker per query: random-init encoders give nearly parallel
    # query vectors, so the filter keeps each query to its own planted rows
    qf = np.array([[0, -1], [1, -1], [2, 1], [3, 0]], np.int32)
    for i in range(B):
        for ax in (0, 1):
            if qf[i, ax] >= 0:
                codes[ax, planted[i]] = qf[i, ax]
    codes[:, N - 100 :] = -2

    dl = rng.integers(3, DLEN + 1, N)
    dtok = rng.integers(1000 // 2, 1000, (N, DLEN)).astype(np.int32)
    dtok[np.arange(N), dl - 1] = 102
    dtok *= (np.arange(DLEN)[None, :] < dl[:, None])
    corpus = torch.from_numpy(c.astype(np.float32)).bfloat16()
    return dict(
        e=(e_params, e_jcfg, e_model, e_tcfg), r=(r_params, r_jcfg, r_model, r_tcfg),
        q=(q_ids, q_types, q_mask), qf=qf, corpus=corpus, codes=codes, dtok=dtok,
        planted=planted,
    )


def run_jax(case):
    e_params, e_jcfg, _, _ = case["e"]
    r_params, r_jcfg, _, _ = case["r"]
    out = jfq.fused_two_stage(
        e_params, r_params, *(jnp.asarray(a) for a in case["q"]),
        jnp.asarray(case["qf"]), jnp.asarray(case["corpus"].float().numpy(), jnp.bfloat16),
        jnp.asarray(case["codes"]), jnp.asarray(case["dtok"]), jnp.int32(N - 100),
        embed_cfg=e_jcfg, rerank_cfg=r_jcfg, k=K, tile=1024, use_pallas=False,
    )
    return tuple(np.asarray(x) for x in out)


def port_args(case):
    return (
        case["e"][2], case["r"][2], *(torch.from_numpy(a) for a in case["q"]),
        torch.from_numpy(case["qf"]), case["corpus"],
        torch.from_numpy(case["codes"]), torch.from_numpy(case["dtok"]), N - 100,
    )


def run_port(case, fn=tfq.fused_two_stage, **kw):
    out = fn(*port_args(case), rerank_cfg=case["r"][3], k=K, **kw)
    return tuple(x.numpy() for x in out)


def test_fused_two_stage_matches_jax(case):
    rows_j, bi_j, ce_j = run_jax(case)
    rows_t, bi_t, ce_t = run_port(case)
    assert rows_t.shape == bi_t.shape == ce_t.shape == (B, K)
    np.testing.assert_array_equal(rows_t, case["planted"])
    np.testing.assert_array_equal(rows_t, rows_j)
    np.testing.assert_allclose(bi_t, bi_j, atol=2e-3, rtol=0)
    np.testing.assert_allclose(ce_t, ce_j, atol=3e-2, rtol=0)
    assert np.isfinite(ce_t).all()


def test_fused_block_two_stage_matches_jax(case, fused_block):
    """The slice under the fused-block opt-in (both gates patched on, the
    JAX kernels in interpret mode): the same rows as the JAX fused branch
    and as the planted answer, scores within the bounds of
    :func:`test_fused_two_stage_matches_jax`."""
    rows_j, bi_j, ce_j = run_jax(case)
    rows_t, bi_t, ce_t = run_port(case)
    # both ran their fused branch: the port in each of 2 embed + 2 rerank
    # layers, JAX in each encoder's traced layer
    assert fused_block == {"jax": dict.fromkeys(FUSED_FNS, 2),
                           "port": dict.fromkeys(FUSED_FNS, 4)}
    np.testing.assert_array_equal(rows_t, case["planted"])
    np.testing.assert_array_equal(rows_t, rows_j)
    np.testing.assert_allclose(bi_t, bi_j, atol=2e-3, rtol=0)
    np.testing.assert_allclose(ce_t, ce_j, atol=3e-2, rtol=0)
    assert np.isfinite(ce_t).all()


def test_prefixes_telescope(case):
    full = run_port(case)
    pre = run_port(case, fn=tfq.fused_two_stage_prefix, stop="full")
    for a, b in zip(full, pre):
        np.testing.assert_array_equal(a, b)
    rows, _bi = run_port(case, fn=tfq.fused_two_stage_prefix, stop="search")
    np.testing.assert_array_equal(rows, full[0])
    qv = tfq.fused_two_stage_prefix(
        *port_args(case), rerank_cfg=case["r"][3], k=K, stop="embed",
    )
    assert qv.shape == (B, 64)
    for stop in ("gather", "layers"):
        rows, chk = run_port(case, fn=tfq.fused_two_stage_prefix, stop=stop)
        np.testing.assert_array_equal(rows, full[0])
        assert chk.shape[0] == B


def test_make_fused_query_binds_configs(case):
    fn = tfq.make_fused_query(case["r"][3], k=K)
    for a, b in zip((x.numpy() for x in fn(*port_args(case))), run_port(case)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("p,max_seq", [(13, None), (60, None), (16, 40), (9, 20)])
def test_assemble_pairs_identical(p, max_seq):
    rng = np.random.default_rng(p)
    pair_q = rng.integers(0, 50, (p, LQ)).astype(np.int32)
    pair_d = rng.integers(0, 50, (p, DLEN)).astype(np.int32)
    jcfg = jbert.BertConfig(**TINY, max_seq_length=max_seq)
    tcfg = tbert.BertConfig(**TINY, max_seq_length=max_seq)
    ref = jfq._assemble_pairs(jnp.asarray(pair_q), jnp.asarray(pair_d), rerank_cfg=jcfg)
    got = tfq._assemble_pairs(
        torch.from_numpy(pair_q), torch.from_numpy(pair_d), rerank_cfg=tcfg
    )
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[0].shape[0] % 8 == 0
