"""The port's encoder self-attention against the JAX pair-attention kernel.

On the CPU the port runs its plain version; the JAX Pallas kernel runs in
interpret mode, as tests/test_attention.py runs it.  Same numpy inputs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from financial_rag_system_tpu.ops.attention import (
    encoder_self_attention as jax_attention,
)
from financial_rag_system_tpu_torch.ops import attention as tattn
from torch_attn_masks import holes_mask, rerank_mask


def make_inputs(b=3, s=50, h=4, d=32, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    lens = rng.integers(1, s + 1, b)
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    return q, k, v, mask


def both(q, k, v, mask):
    inv = 1.0 / np.sqrt(q.shape[-1])
    ref = np.asarray(jax_attention(q, k, v, mask, inv, interpret=True))
    got = tattn.encoder_self_attention(
        *(torch.from_numpy(a) for a in (q, k, v, mask)), inv
    ).numpy()
    return got, ref


@pytest.mark.parametrize("s", [50, 130, 400])
def test_matches_jax_kernel(s):
    q, k, v, mask = make_inputs(b=2 if s == 400 else 3, s=s, h=2, seed=s)
    got, ref = both(q, k, v, mask)
    assert got.shape == ref.shape and got.dtype == np.float32
    # bf16 output: one bf16 ulp of an O(1) context is about 4e-3
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=0)


@pytest.mark.parametrize("kind,s", [("rerank", 400), ("rerank", 257), ("holes", 400),
                                    ("holes", 130)])
def test_non_prefix_masks_match_jax_kernel(kind, s):
    q, k, v, _ = make_inputs(b=3, s=s, h=2, seed=s + 1)
    mask = rerank_mask(3, s, seed=s) if kind == "rerank" else holes_mask(3, s, seed=s)
    got, ref = both(q, k, v, mask)
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=0)


def test_fully_masked_pair_is_finite():
    q, k, v, mask = make_inputs(b=2, s=40)
    mask[1, :] = 0
    got, ref = both(q, k, v, mask)
    assert np.isfinite(got).all()
    # only the real pair is compared: the JAX kernel pads S to 128 and a
    # fully masked pair's uniform softmax then also spans the pad keys
    np.testing.assert_allclose(got[0], ref[0], atol=1e-2, rtol=0)


def test_cpu_runs_plain_and_counts_no_launch():
    q, k, v, mask = (torch.from_numpy(a) for a in make_inputs(b=1, s=8))
    before = tattn.encoder_self_attention.launches
    out = tattn.encoder_self_attention(q, k, v, mask, 0.2)
    assert torch.equal(out, tattn.encoder_self_attention_plain(q, k, v, mask, 0.2))
    assert tattn.encoder_self_attention.launches == before


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind,s", [("prefix", 130), ("rerank", 400)])
def test_wide_heads_match_jax_kernel(d, kind, s):
    """Heads of 64 (BERT-base and -large) and 128, which the JAX gate sends
    to the Pallas kernel and the port's wrapper to the streaming kernel:
    the plain version against the Pallas kernel in interpret mode."""
    q, k, v, mask = make_inputs(b=2, s=s, h=2, d=d, seed=d + s)
    if kind == "rerank":
        mask = rerank_mask(2, s, seed=d)
    got, ref = both(q, k, v, mask)
    assert got.shape == ref.shape == (2, s, 2 * d)
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=0)
