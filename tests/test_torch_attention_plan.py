"""The plan of the pair-attention kernel (``csrc/pair_attention.cu``),
emulated in torch on the CPU.

The kernel does not compute the softmax as the plain version writes it.
Per pair it finds kend (1 + the last valid key) and visits the 64-key
chunks below it only, in two sweeps: the row max, then the probs, their
sum and P.V.  A chunk whose keys are all valid takes no bias and evaluates
exp as exp2(fma(s, log2 e, -m log2 e)); any other chunk adds the bias,
computes exp2((s + bias - m) log2 e) and skips the groups of 8 keys at or
past kend.  A pair with no valid key visits all S keys.  This file runs
that plan in f32, with bf16 rounding where the kernel rounds, and holds
it against the plain version and the JAX Pallas kernel (interpret mode),
and shows that stopping at kend gives the same sums and context, bit for
bit, as visiting every key.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from financial_rag_system_tpu.ops.attention import (
    encoder_self_attention as jax_attention,
)
from financial_rag_system_tpu_torch.ops import attention as tattn
from torch_attn_masks import holes_mask, prefix_mask, rerank_mask

CHUNK = 64  # keys of a chunk: the kernel's QK^T wgmma N and TMA box
GROUP = 8   # keys of an accumulator column group: the unit of the skip
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def plan_attention(q, k, v, mask, inv_sqrt, stop_at_kend=True):
    """The kernel's plan over (P, S, H, 32) f32 q, k, v and a (P, S) mask.
    Returns the unnormalised context (P, H, S, 32) f32, the softmax sums
    (P, H, S) f32 and the (P, S, H * 32) output, as the kernel stores it
    (bf16) and the wrapper returns it (f32)."""
    qs, kb, vb = (t.float() for t in tattn._scaled_inputs(q, k, v, inv_sqrt))
    p, s, h, d = qs.shape
    sp = -(-s // CHUNK) * CHUNK
    valid = mask > 0
    bias = torch.full((p, sp), float("-inf"))
    bias[:, :s] = torch.where(valid, 0.0, tattn.NEG)
    kp, vp = torch.zeros((p, sp, h, d)), torch.zeros((p, sp, h, d))
    kp[:, :s], vp[:, :s] = kb, vb
    ctxs, sums = [], []
    for i in range(p):
        keys = valid[i].nonzero()
        kend = int(keys[-1]) + 1 if len(keys) else 0
        klim = kend if kend else s
        nck = -(-klim // CHUNK) if stop_at_kend else sp // CHUNK
        full = [bool(valid[i, c * CHUNK:(c + 1) * CHUNK].all()) and (c + 1) * CHUNK <= s
                for c in range(sp // CHUNK)]
        qh = qs[i].permute(1, 0, 2)  # (H, S, D)

        def chunk(c):
            """Logits of chunk c (H, S, 64), its bias and the keys skipped."""
            cols = slice(c * CHUNK, (c + 1) * CHUNK)
            sc = qh @ kp[i, cols].permute(1, 2, 0)
            group0 = torch.arange(c * CHUNK, (c + 1) * CHUNK) // GROUP * GROUP
            skipped = (group0 >= klim) if stop_at_kend else torch.zeros(CHUNK, dtype=torch.bool)
            return sc, bias[i, cols], skipped

        m = torch.full((h, s), float("-inf"))
        for c in range(nck):  # sweep 1: the row max
            sc, b, skipped = chunk(c)
            x = sc if full[c] else (sc + b).masked_fill(skipped, float("-inf"))
            m = torch.maximum(m, x.amax(dim=-1))
        nml = -m * LOG2E
        ssum = torch.zeros((h, s))
        ctx = torch.zeros((h, s, d))
        for c in range(nck):  # sweep 2: probs, sums, P.V
            sc, b, skipped = chunk(c)
            if full[c]:  # one rounding, as the kernel's FFMA
                arg = (sc.double() * LOG2E.double() + nml[..., None].double()).float()
            else:
                arg = ((sc + b) - m[..., None]) * LOG2E
            pr = torch.exp2(arg)
            if not full[c]:
                pr = pr.masked_fill(skipped, 0.0)
            ssum = ssum + pr.sum(dim=-1)
            ctx = ctx + pr.to(torch.bfloat16).float() @ vp[i, c * CHUNK:(c + 1) * CHUNK].permute(1, 0, 2)
        ctxs.append(ctx)
        sums.append(ssum)
    ctx, ssum = torch.stack(ctxs), torch.stack(sums)
    out = (ctx / ssum[..., None]).to(torch.bfloat16).float()
    return ctx, ssum, out.permute(0, 2, 1, 3).reshape(p, s, h * d)


def plan_masks(s, seed=0):
    """Five pairs: the rerank layout (query tokens, a zero-padded hole up
    to 32, a document run, tail padding; a short prefix where S is 32 or
    less), random holes, no valid key, kend in mid-chunk and kend at a
    chunk edge (or at S when S is shorter)."""
    mid = max(1, (2 * s) // 3 - 5 if s > 70 else s // 2)
    mask = prefix_mask(s, [min(s, 3), 0, 0, mid, min(s, 128)])
    if s > 32:
        mask[0] = rerank_mask(1, s, seed=seed)[0]
    mask[1] = holes_mask(2, s, seed=seed)[1]
    mask[1, 0] = 1
    return mask


def inputs(s, seed=0):
    rng = np.random.default_rng(seed + s)
    q, k, v = (rng.standard_normal((5, s, 2, 32)).astype(np.float32) for _ in range(3))
    return q, k, v, plan_masks(s, seed)


SEQS = [1, 50, 130, 257, 400, 512]


@pytest.mark.parametrize("s", SEQS)
def test_stopping_at_kend_is_bit_exact(s):
    q, k, v, mask = (torch.from_numpy(a) for a in inputs(s))
    inv = 1.0 / np.sqrt(32)
    ctx, ssum, out = plan_attention(q, k, v, mask, inv)
    ctx_all, ssum_all, out_all = plan_attention(q, k, v, mask, inv, stop_at_kend=False)
    assert torch.equal(ssum, ssum_all)
    assert torch.equal(ctx, ctx_all)
    assert torch.equal(out, out_all)


@pytest.mark.parametrize("s", SEQS)
def test_plan_matches_plain_and_jax(s):
    q, k, v, mask = inputs(s)
    inv = 1.0 / np.sqrt(32)
    got = plan_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)), inv)[2].numpy()
    plain = tattn.encoder_self_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v, mask)), inv
    ).numpy()
    assert np.isfinite(got).all()
    # bf16 output: one bf16 ulp of an O(1) context is about 4e-3
    np.testing.assert_allclose(got, plain, atol=1e-2, rtol=0)
    ref = np.asarray(jax_attention(q, k, v, mask, inv, interpret=True))
    # the fully masked pair (2) is held to the plain version only: the JAX
    # kernel pads S to 128 and its uniform softmax then spans the pad keys
    real = mask.any(axis=1)
    np.testing.assert_allclose(got[real], ref[real], atol=1e-2, rtol=0)


def test_fully_masked_pair_is_uniform():
    q, k, v, mask = (torch.from_numpy(a) for a in inputs(400))
    out = plan_attention(q, k, v, mask, 1.0 / np.sqrt(32))[2]
    mean_v = v.to(torch.bfloat16).float()[2].mean(dim=0).reshape(-1)  # (H * 32,)
    assert not mask[2].any()
    np.testing.assert_allclose(out[2].numpy(), np.broadcast_to(mean_v.numpy(), (400, 64)),
                               atol=1e-2, rtol=0)
