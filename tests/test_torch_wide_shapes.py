"""Shapes past the kernels' old limits, on the CPU: kernel 2's plain
version at head widths that are not a multiple of 16, and kernels 1 and
3's plain versions at k 2048 and D 1536 (rows the wide kernel takes, on
the lists' path and at k 1024 on the select path), against the JAX
package.

On the card the attention wrapper pads such heads with zero columns to
the next multiple of 16; here the padded and the unpadded plain versions
must agree, and both match JAX's einsum attention (``models/bert.py``,
the path JAX takes where its Pallas kernel does not run).  The retrieval
references are JAX ``masked_topk_xla`` and ``ivf_probe_xla``, and for
int8 the Pallas kernel's s32 branch in interpret mode, bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from financial_rag_system_tpu.index import ivf as jivf
from financial_rag_system_tpu.ops.topk import masked_topk_pallas, masked_topk_xla
from financial_rag_system_tpu_torch.index import ivf as tivf
from financial_rag_system_tpu_torch.ops import attention as tattn
from financial_rag_system_tpu_torch.ops import topk as ttopk


def jax_einsum_attention(q, k, v, mask, inv_sqrt):
    """The JAX encoder's einsum attention (``models/bert.py`` with neither
    kernel engaged): bf16 operands, f32 logits, softmax and context."""
    b, s, h, d = q.shape
    bias = jnp.where(jnp.asarray(mask)[:, None, None, :] > 0, 0.0, -1e9)
    logits = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q, jnp.bfloat16),
                        jnp.asarray(k, jnp.bfloat16),
                        preferred_element_type=jnp.float32) * inv_sqrt + bias
    probs = jax.nn.softmax(logits, axis=-1)
    ctx = jnp.einsum("bhqk,bkhd->bqhd", probs.astype(jnp.bfloat16),
                     jnp.asarray(v, jnp.bfloat16), preferred_element_type=jnp.float32)
    return np.asarray(ctx.reshape(b, s, h * d))


@pytest.mark.parametrize("d", [8, 24, 40])
def test_odd_head_widths_match_jax_and_padding_is_exact(d):
    rng = np.random.default_rng(d)
    b, s, h = 3, 70, 2
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    mask = (np.arange(s)[None, :] < np.array([70, 33, 1])[:, None]).astype(np.int32)
    inv = 1.0 / np.sqrt(d)
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    got = tattn.encoder_self_attention(tq, tk, tv, tm, inv).numpy()
    np.testing.assert_allclose(got, jax_einsum_attention(q, k, v, mask, inv), atol=1e-2, rtol=0)
    # the card's padding: zero columns up to the next multiple of 16, the
    # true d's scale, the context sliced back
    pad = -d % 16
    padded = tattn.encoder_self_attention_plain(
        *(torch.nn.functional.pad(t, (0, pad)) for t in (tq, tk, tv)), tm, inv)
    padded = padded.reshape(b, s, h, d + pad)[..., :d].reshape(b, s, h * d).numpy()
    np.testing.assert_allclose(padded, got, atol=1e-6, rtol=0)


# K_WIDE: the wide kernel's select path at D_WIDE (phase 2's k 1024)
B, N, K_BIG, D_WIDE, K_WIDE = 8, 4096, 2048, 1536, 1024


def retrieval_case(d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, d)).astype(np.float32)
    c = rng.standard_normal((N, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    c[3001] = c[1200]  # an exact tie
    q[5] = c[1200]
    codes = np.stack([rng.integers(0, 4, N), rng.integers(0, 3, N)]).astype(np.int32)
    codes[:, [1200, 3001]] = [[0], [1]]
    qf = np.array([[-1, -1], [0, -1], [1, 2], [9, -1], [2, 1], [-1, -1], [3, -1],
                   [-1, 0]], np.int32)
    return q, c, codes, qf


def quant(a):
    return np.clip(np.rint(a * 127.0), -127, 127).astype(np.int8)


def clear_ids(s_ref, i_ref, s, i, tol):
    """ids equal wherever no neighbouring score lies within ``tol``."""
    fin = np.isfinite(s_ref)
    np.testing.assert_array_equal(np.isfinite(s), fin)
    with np.errstate(invalid="ignore"):
        gap = np.abs(np.diff(s_ref, axis=1))
    near = np.zeros_like(fin)
    near[:, 1:] |= gap <= tol
    near[:, :-1] |= gap <= tol
    clear = fin & ~near
    np.testing.assert_array_equal(i[clear], i_ref[clear])
    assert (i[~fin] == -1).all()
    return fin


@pytest.mark.parametrize("d,k", [(D_WIDE, 15), (384, K_BIG), (D_WIDE, K_BIG), (D_WIDE, K_WIDE)])
def test_masked_topk_plain_wide_and_deep_match_xla(d, k):
    q, c, codes, qf = retrieval_case(d, seed=d + k)
    n_valid = N - 100
    bf = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    s, i = (x.numpy() for x in ttopk.masked_topk(
        bf(q), bf(c), torch.from_numpy(codes), torch.from_numpy(qf), n_valid, k))
    ref = masked_topk_xla(jnp.asarray(bf(q).float().numpy(), jnp.bfloat16),
                          jnp.asarray(bf(c).float().numpy(), jnp.bfloat16),
                          jnp.asarray(codes), jnp.asarray(qf), n_valid, k)
    s_x, i_x = (np.asarray(x) for x in ref)
    assert s.shape == i.shape == (B, k)
    fin = clear_ids(s_x, i_x, s, i, 1e-5)
    np.testing.assert_allclose(s[fin], s_x[fin], atol=1e-5, rtol=0)
    assert list(i[5, :2]) == [1200, 3001] and s[5, 0] == s[5, 1]
    if k > N - 100:
        assert not fin[:, N - 100:].any()


@pytest.mark.parametrize("d,k", [(D_WIDE, 15), (384, K_BIG), (D_WIDE, K_WIDE)])
def test_masked_topk_int8_wide_and_deep_bit_for_bit(d, k):
    """int8: the plain version's exact sums cast once equal the Pallas
    kernel's s32 branch bit for bit (at D 1536 the cast rounds), and
    match masked_topk_xla, which sums in f32, within its rounding."""
    q, c, codes, qf = retrieval_case(d, seed=d + k + 1)
    q8, c8 = quant(q), quant(c)
    n_valid = N - 100
    s, i = (x.numpy() for x in ttopk.masked_topk(
        torch.from_numpy(q8), torch.from_numpy(c8), torch.from_numpy(codes),
        torch.from_numpy(qf), n_valid, k))
    args = (jnp.asarray(q8), jnp.asarray(c8), jnp.asarray(codes), jnp.asarray(qf), n_valid, k)
    if k <= 32:  # the Pallas kernel in interpret mode at the lists' k (at 1024 it takes minutes)
        s_p, i_p = (np.asarray(x) for x in masked_topk_pallas(
            *args, tile=1024, interpret=True, int8_mxu=True))
        np.testing.assert_array_equal(s, s_p)
        fin = np.isfinite(s_p)
        np.testing.assert_array_equal(i[fin], i_p[fin])
    s_x, i_x = (np.asarray(x) for x in masked_topk_xla(*args))
    fin = clear_ids(s_x, i_x, s, i, 4.0)
    np.testing.assert_allclose(s[fin], s_x[fin], rtol=1e-6, atol=0)
    exact = (q8[:, None, :].astype(np.int64) * c8[None, :, :].astype(np.int64)).sum(-1)
    top = np.where(fin, i, 0)
    np.testing.assert_array_equal(
        s[fin], np.take_along_axis(exact, top, axis=1).astype(np.float32)[fin])


def probe_case(d, seed):
    rng = np.random.default_rng(seed)
    tile, n_tiles = 128, 24
    n = tile * n_tiles
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    gids = rng.permutation(4 * n)[:n].astype(np.int32)
    gids[rng.random(n) < 0.2] = -1
    codes = np.stack([rng.integers(0, 3, n), rng.integers(0, 2, n)]).astype(np.int32)
    q = rng.standard_normal((B, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qf = np.full((B, 2), -1, np.int32)
    qf[1:4, 0] = [0, 1, 2]
    tile_ids = np.full(24, -1, np.int32)
    tile_ids[:20] = np.sort(rng.choice(n_tiles, 20, replace=False))
    return q, qf, emb, codes, gids[None, :], tile_ids, tile


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("d,k", [(D_WIDE, 15), (384, K_BIG), (D_WIDE, K_WIDE)])
def test_ivf_probe_plain_wide_and_deep_match_jax(d, k, dtype):
    q, qf, emb, codes, gids, tile_ids, tile = probe_case(d, seed=d + k)
    if dtype == "int8":
        tq, te = torch.from_numpy(quant(q)), torch.from_numpy(quant(emb))
        jq, je = jnp.asarray(quant(q)), jnp.asarray(quant(emb))
    else:
        tq, te = torch.from_numpy(q).bfloat16(), torch.from_numpy(emb).bfloat16()
        jq, je = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tq, te))
    s, i = (x.numpy() for x in tivf.ivf_probe(
        tq, torch.from_numpy(qf), te, torch.from_numpy(codes), torch.from_numpy(gids),
        torch.from_numpy(tile_ids), k, tile=tile))
    jargs = (jq, jnp.asarray(qf), je, jnp.asarray(codes), jnp.asarray(gids),
             jnp.asarray(tile_ids), k)
    s_x, i_x = (np.asarray(x) for x in jivf.ivf_probe_xla(*jargs, tile=tile))
    assert s.shape == (B, k)
    fin = clear_ids(s_x, i_x, s, i, 4.0 if dtype == "int8" else 1e-5)
    if dtype == "int8":
        np.testing.assert_allclose(s[fin], s_x[fin], rtol=1e-6, atol=0)
    else:
        np.testing.assert_allclose(s[fin], s_x[fin], atol=1e-5, rtol=0)
