"""The ring kernel of ``csrc/pair_attention.cu`` (heads of 64 and 128),
its plan emulated in torch on the CPU, and the wrapper's width rule.

The ring kernel does not compute the softmax as the plain version writes
it.  Per pair it finds kend (1 + the last valid key) and visits the
128-key blocks below it only (below S for a pair with no valid key), in
one sweep with an online softmax: per block the row max m, alpha =
exp2((m_old - m) log2 e), the probs as exp2(fma(s, log2 e, -m log2 e)) on a
block whose keys are all valid and exp2((s + bias - m) log2 e) on any
other, the sum and the context rescaled by alpha, and P.V with the probs
rounded to bf16.  This file runs that plan in f32, with bf16 rounding
where the kernel rounds, and holds it against the plain version and the
JAX Pallas kernel (interpret mode); shows that stopping at kend gives the
same context, bit for bit, as visiting every block; checks the plan's
shared memory and registers (``ring_plan``, the C++'s mirror), the blocks
it loads and the zero-padding of other head widths.  Last, a 2-layer
cross-encoder with heads of 64 at S 256, where the pair gate engages:
the port's plain path against the JAX package's with its kernel.
"""

from __future__ import annotations

import functools
import math

import jax
import numpy as np
import pytest
import torch

from financial_rag_system_tpu.models import bert as jbert
from financial_rag_system_tpu.ops import attention as jattention
from financial_rag_system_tpu.ops.attention import encoder_self_attention as jax_attention
from financial_rag_system_tpu_torch.models import bert as tbert
from financial_rag_system_tpu_torch.ops import attention as tattn
from torch_attn_masks import holes_mask, prefix_mask, rerank_mask

BLOCK = tattn.RING_KEYS
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def ring_attention(q, k, v, mask, inv_sqrt, stop_at_kend=True):
    """The ring kernel's plan over (P, S, H, d) f32 q, k, v and a (P, S)
    mask; the (P, S, H * d) output as the kernel stores it (bf16) and the
    wrapper returns it (f32)."""
    qs, kb, vb = (t.float() for t in tattn._scaled_inputs(q, k, v, inv_sqrt))
    p, s, h, d = qs.shape
    sp = -(-s // BLOCK) * BLOCK
    valid = torch.zeros((p, sp), dtype=torch.bool)
    valid[:, :s] = mask > 0
    bias = torch.full((p, sp), float("-inf"))
    bias[:, :s] = torch.where(mask > 0, 0.0, tattn.NEG)
    kp, vp = torch.zeros((p, sp, h, d)), torch.zeros((p, sp, h, d))
    kp[:, :s], vp[:, :s] = kb, vb
    blocks = tattn.ring_blocks(mask) if stop_at_kend else torch.full((p,), sp // BLOCK)
    ctxs = []
    for i in range(p):
        qh = qs[i].permute(1, 0, 2)  # (H, S, d)
        m = torch.full((h, s), float("-inf"))
        ssum = torch.zeros((h, s))
        ctx = torch.zeros((h, s, d))
        for c in range(int(blocks[i])):
            cols = slice(c * BLOCK, (c + 1) * BLOCK)
            sc = qh @ kp[i, cols].permute(1, 2, 0)  # (H, S, BLOCK)
            full = bool(valid[i, cols].all())
            if not full:
                sc = sc + bias[i, cols]
            mn = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp2((m - mn) * LOG2E)
            if full:  # one rounding, as the kernel's FFMA
                nml = -mn * LOG2E
                arg = (sc.double() * LOG2E.double() + nml[..., None].double()).float()
            else:
                arg = (sc - mn[..., None]) * LOG2E
            pr = torch.exp2(arg)
            ssum = ssum * alpha + pr.sum(dim=-1)
            pv = pr.to(torch.bfloat16).float() @ vp[i, cols].permute(1, 0, 2)
            ctx = ctx * alpha[..., None] + pv
            m = mn
        ctxs.append(ctx / ssum[..., None])
    out = torch.stack(ctxs).to(torch.bfloat16).float()
    return out.permute(0, 2, 1, 3).reshape(p, s, h * d)


def ring_masks(s, seed=0):
    """Six pairs: the rerank layout (a short prefix where S is 32 or
    less), random holes, no valid key, kend in mid-block, valid keys only
    past the first block where S allows (so that block is wiped by alpha
    = 0), and kend at S."""
    mid = max(1, (2 * s) // 3 - 5 if s > 70 else s // 2)
    mask = prefix_mask(s, [min(s, 3), 0, 0, mid, 0, s])
    if s > 32:
        mask[0] = rerank_mask(1, s, seed=seed)[0]
    mask[1] = holes_mask(2, s, seed=seed)[1]
    mask[1, 0] = 1
    if s > BLOCK:
        mask[4, BLOCK + 5:s - 1] = 1
    else:
        mask[4, s // 2:] = 1
    return mask


def inputs(s, d, seed=0):
    rng = np.random.default_rng(seed + s + d)
    q, k, v = (rng.standard_normal((6, s, 2, d)).astype(np.float32) for _ in range(3))
    return q, k, v, ring_masks(s, seed)


SEQS = [1, 63, 65, 130, 257, 400, 512]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", SEQS)
def test_stopping_at_kend_is_bit_exact(s, d):
    """Blocks wholly past kend add exactly 0 (alpha 1, probs exp2 of about
    -1.4e9), so the ring kernel's skip changes no bit."""
    q, k, v, mask = (torch.from_numpy(a) for a in inputs(s, d))
    inv = 1.0 / math.sqrt(d)
    got = ring_attention(q, k, v, mask, inv)
    assert torch.equal(got, ring_attention(q, k, v, mask, inv, stop_at_kend=False))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [63, 257, 400, 512])
def test_ring_plan_matches_plain_and_jax(s, d):
    """The online softmax against the plain version (full-row max first)
    and the Pallas kernel (interpret mode), at the kernel-vs-plain
    tolerance."""
    q, k, v, mask = inputs(s, d)
    inv = 1.0 / math.sqrt(d)
    got = ring_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)), inv).numpy()
    plain = tattn.encoder_self_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v, mask)), inv).numpy()
    assert np.isfinite(got).all()
    # bf16 output: one bf16 ulp of an O(1) context is about 4e-3
    np.testing.assert_allclose(got, plain, atol=1e-2, rtol=0)
    ref = np.asarray(jax_attention(q, k, v, mask, inv, interpret=True))
    # the fully masked pairs are held to the plain version only: the JAX
    # kernel pads S to 128 and its uniform softmax then spans the pad keys
    real = mask.any(axis=1)
    np.testing.assert_allclose(got[real], ref[real], atol=1e-2, rtol=0)


@pytest.mark.parametrize("d", [64, 128])
def test_ring_fully_masked_pair_is_uniform(d):
    q, k, v, mask = (torch.from_numpy(a) for a in inputs(400, d))
    out = ring_attention(q, k, v, mask, 1.0 / math.sqrt(d))
    assert not mask[2].any()
    mean_v = v.to(torch.bfloat16).float()[2].mean(dim=0).reshape(-1)  # (H * d,)
    np.testing.assert_allclose(out[2].numpy(), np.broadcast_to(mean_v.numpy(), (400, 2 * d)),
                               atol=1e-2, rtol=0)


def test_every_width_maps_to_a_kernel_width():
    """Every head width from 1 to 128 runs at the smallest kernel width
    that holds it; wider ones raise."""
    for d in range(1, tattn.MAX_HEAD_DIM + 1):
        w = tattn.padded_width(d)
        assert w in tattn.HEAD_DIMS and w >= d
        assert all(x < d for x in tattn.HEAD_DIMS if x < w)
    assert tattn.HEAD_DIMS == (32, 64, 128)
    with pytest.raises(ValueError, match="head_dim"):
        tattn.padded_width(tattn.MAX_HEAD_DIM + 1)


@pytest.mark.parametrize("d", [1, 8, 16, 24, 31, 33, 40, 48, 63, 65, 80, 96, 100, 112, 127])
def test_padding_to_the_kernel_width_is_bit_exact(d):
    """The plain version over q, k and v zero-padded to the kernel width
    (q scaled by the true d first, as ``kernel_inputs`` does), its context
    sliced back to d, equals the unpadded one bit for bit."""
    rng = np.random.default_rng(d)
    b, s, h = 2, 70, 2
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
               for _ in range(3))
    mask = torch.from_numpy(prefix_mask(s, [70, 33]))
    inv = 1.0 / math.sqrt(d)
    ref = tattn.encoder_self_attention_plain(q, k, v, mask, inv)
    qs, kb, vb = tattn.kernel_inputs(q, k, v, inv)
    w = tattn.padded_width(d)
    assert qs.shape[-1] == kb.shape[-1] == vb.shape[-1] == w
    assert not qs[..., d:].any() and not kb[..., d:].any() and not vb[..., d:].any()
    got = tattn.encoder_self_attention_plain(qs, kb, vb, mask, 1.0)
    assert torch.equal(got.reshape(b, s, h, w)[..., :d].reshape(b, s, h * d), ref)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 63, 65, 256, 400, 512])
def test_ring_plan_fits(d, s):
    """One block an SM at every S up to 512: the ring of 128-key stages
    and the two q tiles of each consumer warpgroup fit in a block's shared
    memory, and the register budgets in the launch's pool."""
    plan = tattn.ring_plan(d)
    assert plan.regs_fit
    assert plan.smem <= tattn.RING_SMEM_LIMIT
    assert plan.stages == {64: 5, 128: 2}[d]
    assert (plan.consumers, plan.threads, plan.consumer_regs) == {
        64: (3, 512, 152), 128: (2, 384, 232)}[d]
    # what one stage holds does not grow with S; S sets only the blocks a
    # unit walks and the row tiles
    assert int(tattn.ring_blocks(torch.ones((1, s), dtype=torch.int32))[0]) == -(-s // BLOCK) <= 4


def test_ring_blocks_count_keys_below_kend():
    """The blocks the producer stages for a pair: those holding a key
    below kend, all of S's for a pair with no valid key, none past."""
    s = 400
    kends = [1, 127, 128, 129, 256, 257, 399, 400, 0]
    mask = torch.from_numpy(prefix_mask(s, kends))
    mask[2, 5] = 0  # a hole below kend changes nothing
    want = [1, 1, 1, 2, 2, 3, 4, 4, 4]
    assert tattn.key_ends(mask).tolist() == kends
    assert tattn.ring_blocks(mask).tolist() == want
    holes = torch.from_numpy(holes_mask(4, s, seed=3))
    for row, n in zip(holes, tattn.ring_blocks(holes).tolist()):
        last = int(row.nonzero().max()) if row.any() else s - 1
        assert (n - 1) * BLOCK <= last < n * BLOCK


@pytest.fixture()
def jax_pair_attn(monkeypatch):
    """The JAX pair-attention kernel forced at every length (interpret
    mode on the CPU), with the JAX jit cache cleared around the patch."""
    jax.clear_caches()
    monkeypatch.setattr(jbert, "_pair_attn_enabled", lambda seq, hd: True)
    monkeypatch.setattr(
        jattention, "encoder_self_attention",
        functools.partial(jattention.encoder_self_attention, interpret=True),
    )
    yield
    jax.clear_caches()


def test_cross_encoder_with_heads_of_64_matches_jax(monkeypatch, jax_pair_attn):
    """A 2-layer, 128-wide cross-encoder with 2 heads of 64 at S 256,
    where the port's default gate takes the kernel arithmetic (the plain
    version on the CPU; the ring kernel on the card): its logits against
    the JAX package's with the Pallas kernel, within 5e-3 as the other
    encoder tests."""
    monkeypatch.delenv("RAG_TPU_PAIR_ATTN", raising=False)
    shape = dict(vocab_size=1000, hidden=128, layers=2, heads=2, intermediate=256,
                 max_positions=512, with_pooler=True, num_labels=1)
    jcfg, tcfg = jbert.BertConfig(**shape), tbert.BertConfig(**shape)
    assert tbert._pair_attn_enabled(256, tcfg.hidden // tcfg.heads)
    params = jbert.init_params(jax.random.PRNGKey(7), jcfg)
    model = tbert.load_jax_params(tbert.BertModel(tcfg, device="cpu"),
                                  jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(7)
    seq = 256
    ids = rng.integers(1, 1000, (3, seq)).astype(np.int32)
    mask = rerank_mask(3, seq, seed=7)
    ids *= mask
    types = np.zeros_like(ids)
    types[:, 32:] = 1
    ref = np.asarray(jbert.cross_score(params, ids, types, mask, jcfg))
    got = tbert.cross_score(model, *(torch.from_numpy(a) for a in (ids, types, mask))).numpy()
    assert got.shape == (3,)
    np.testing.assert_allclose(got, ref, atol=5e-3, rtol=0)
