"""The port's flash-attention path (``RAG_TPU_FLASH``) against the JAX package's.

On the CPU the port runs :func:`flash_attention_plain`; JAX's
``bert._flash_attention`` runs jax's bundled TPU flash kernel in
interpret mode (``force_tpu_interpret_mode``).  JAX's gate tests the
platform, so it is asked with ``jax.devices`` reporting a TPU
(:func:`jax_flash_gate`), and JAX's fused paths run with that gate patched
in and the jit cache cleared around the patch.  Every comparison also
counts the flash calls on both sides: at S 128 the flash arithmetic equals
the einsum path's on the real rows, so a branch that silently did not run
would pass a comparison alone.

Tolerances: the context is bf16, one bf16 step of an O(1) value is about
4e-3, so the kernel function is held to atol 1e-2 on every row, pad rows
included (measured at most 2e-3); the encoder and the slice to the bounds
of ``tests/test_torch_bert.py`` and ``tests/test_torch_fused_query.py``.
"""

from __future__ import annotations

import contextlib
import inspect
import types

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from financial_rag_system_tpu.models import bert as jbert
from financial_rag_system_tpu.ops import fused_query as jfq
from financial_rag_system_tpu_torch.models import bert as tbert
from financial_rag_system_tpu_torch.ops import flash_attention as tflash
from financial_rag_system_tpu_torch.ops import fused_query as tfq
from financial_rag_system_tpu_torch.train.optim import graded
from test_torch_fused_query import B, K, case, run_jax, run_port  # noqa: F401
from torch_attn_masks import holes_mask, prefix_mask, rerank_mask, segment_mask

TINY = dict(vocab_size=1000, hidden=64, layers=2, heads=2, intermediate=128,
            max_positions=512)


@contextlib.contextmanager
def as_tpu():
    """``jax.devices()`` reports a TPU inside the block (JAX's flash gate
    reads the platform; nothing else is asked there)."""
    real = jax.devices
    jax.devices = lambda *a, **k: [types.SimpleNamespace(platform="tpu")]
    try:
        yield
    finally:
        jax.devices = real


def jax_gate(seq: int, heads: int, _gate=jbert._flash_enabled) -> bool:
    """JAX's own ``_flash_enabled``, asked as on a TPU."""
    with as_tpu():
        return _gate(seq, heads)


@pytest.fixture()
def jax_flash_gate(monkeypatch):
    """Both packages on the flash path: ``RAG_TPU_FLASH=1`` and
    ``RAG_TPU_PAIR_ATTN=0`` (the port's pair gate would come first at
    S >= 256; JAX's is off on the CPU), JAX's gate asked as on a TPU, its
    kernel in interpret mode, and each package's flash calls counted
    (JAX's as traced: once an encoder)."""
    jax.clear_caches()
    monkeypatch.setenv("RAG_TPU_FLASH", "1")
    monkeypatch.setenv("RAG_TPU_PAIR_ATTN", "0")
    monkeypatch.setattr(jbert, "_flash_enabled", jax_gate)
    calls = {"jax": 0, "port": 0}

    def spy(side, fn):
        def counted(*a, **k):
            calls[side] += 1
            return fn(*a, **k)
        return counted

    monkeypatch.setattr(jbert, "_flash_attention", spy("jax", jbert._flash_attention))
    monkeypatch.setattr(tbert, "encoder_flash_attention",
                        spy("port", tbert.encoder_flash_attention))
    with pltpu.force_tpu_interpret_mode():
        yield calls
    jax.clear_caches()


def make_qkv(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))


def make_mask(kind, b, s, seed):
    """Key masks: prefix lengths (the last pair all padding), the rerank
    layout's query hole, random holes, prefixes that end in keys 64-127
    (a first row tile wholly real beside key blocks wholly of padding), or
    runs of segment ids in [0, 32) or outside it; each with an all-padding
    pair."""
    rng = np.random.default_rng(seed)
    if kind == "prefix":
        mask = prefix_mask(s, rng.integers(1, s + 1, b))
    elif kind == "short":
        mask = prefix_mask(s, rng.integers(64, 128, b))
    elif kind == "rerank":
        mask = rerank_mask(b, s, seed=seed)
    elif kind == "segments":
        mask = segment_mask(b, s, (0, 1, 2, 5, 17, 31), seed=seed)
    elif kind == "wide_ids":
        mask = segment_mask(b, s, (-3, 0, 1, 32, 45, 1 << 20), seed=seed)
    else:
        mask = holes_mask(b, s, seed=seed)
    mask[-1] = 0
    return mask


def both(q, k, v, mask):
    inv = 1.0 / np.sqrt(q.shape[-1])
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jbert._flash_attention(q, k, v, mask, inv))
    got = tflash.encoder_flash_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)),
                                         inv).numpy()
    return got, ref


# -- the kernel function ------------------------------------------------------------


@pytest.mark.parametrize("s,d,kind", [
    (128, 32, "prefix"), (256, 32, "prefix"), (256, 32, "rerank"), (128, 32, "holes"),
    (256, 64, "holes"), (128, 64, "rerank"), (256, 128, "prefix"), (128, 128, "holes"),
    (256, 24, "rerank"), (256, 256, "prefix"),
])
def test_plain_matches_jax_flash_kernel(s, d, kind):
    """Every row, pad rows included: a pad query row attends the pad keys
    only (segment ids), where kernel 2 and the einsum path give it the
    real keys.  d 24 pads to 32 on the card; d 256 is the one width above
    128 the kernel takes."""
    b = 3
    q, k, v = make_qkv(b, s, 2, d, seed=s + d)
    mask = make_mask(kind, b, s, seed=s + d)
    got, ref = both(q, k, v, mask)
    assert got.shape == ref.shape == (b, s, 2 * d) and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=0)


def test_pad_rows_attend_the_pad_keys_only():
    """The segment-id masking, against the einsum path: real rows agree
    (at S 256, across two key blocks), pad rows do not; an all-padding
    pair is a plain softmax over all its keys."""
    q, k, v = make_qkv(2, 256, 2, 32, seed=5)
    mask = make_mask("prefix", 2, 256, seed=5)
    mask[0, 100:] = 0
    args = [torch.from_numpy(a) for a in (q, k, v, mask)]
    inv = 1.0 / np.sqrt(32)
    got = tflash.encoder_flash_attention(*args, inv)
    einsum = tbert._einsum_attention(*args, inv)
    torch.testing.assert_close(got[0, :100], einsum[0, :100], atol=1e-2, rtol=0)
    assert (got[0, 100:] - einsum[0, 100:]).abs().max() > 0.1
    # the all-padding pair: every key in its one segment
    ones = torch.ones_like(args[3])
    torch.testing.assert_close(got[1], tbert._einsum_attention(*args[:3], ones, inv)[1],
                               atol=1e-2, rtol=0)


def test_cpu_runs_plain_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in make_qkv(1, 128, 2, 16, seed=0))
    mask = torch.ones(1, 128, dtype=torch.int32)
    before = tflash.encoder_flash_attention.launches
    out = tflash.encoder_flash_attention(q, k, v, mask, 0.25)
    assert torch.equal(out, tflash.flash_attention_plain(q, k, v, mask, 0.25))
    assert tflash.encoder_flash_attention.launches == before


@pytest.mark.parametrize("s,d", [(200, 32), (704, 32), (64, 32), (256, 192), (384, 320)])
def test_refuses_shapes_the_kernel_does_not_take(s, d):
    """S not a multiple of 128, and above S 128 heads wider than 128 that
    are not multiples of 128: jax's kernel refuses them too."""
    q = torch.zeros(1, s, 1, d)
    with pytest.raises(ValueError):
        tflash.encoder_flash_attention(q, q, q, torch.ones(1, s), 0.1)


def test_other_devices_raise():
    q = torch.zeros(1, 128, 1, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tflash.encoder_flash_attention(q, q, q, torch.ones(1, 128, device="meta"), 0.1)


# -- the kernel's liberties: skipped (tile, block) pairs and the zero-weight select --


def needed_blocks(seg, rows=64):
    """(B, S // rows, S // 128): whether any query row of a 64-row tile
    shares a segment id with any key of a 128-key block."""
    b, s = seg.shape
    tiles = seg.reshape(b, s // rows, 1, rows, 1)
    blocks = seg.reshape(b, 1, s // tflash.BLOCK, 1, tflash.BLOCK)
    return (tiles == blocks).any(axis=(3, 4))


def skipping_flash(q, k, v, seg, inv_sqrt, *, skip=True, select=False):
    """``flash_attention_plain``'s arithmetic in jax's block order, with the
    kernel's two liberties: with ``skip``, every (64-row tile, 128-key
    block) pair that shares no segment id is left out (its rows keep m, l
    and acc); with ``select``, a masked key's score is -inf in place of
    ``+ MASK_VALUE`` (zero weight), and a row with no key of its segment so
    far keeps m = -inf, l = 0, acc = 0.  Returns the bf16 context as f32."""
    b, s, h, d = q.shape
    qb, kb, vb = (torch.from_numpy(t).to(torch.bfloat16).float().permute(0, 2, 1, 3)
                  for t in (q, k, v))
    segt = torch.from_numpy(seg)
    same = segt[:, None, :, None] == segt[:, None, None, :]
    need = torch.from_numpy(needed_blocks(seg)).repeat_interleave(64, dim=1)  # (B, S, blocks)
    if not skip:
        need[:] = True
    ninf = float("-inf")

    def scores(lo):
        sc = torch.matmul(qb, kb[:, :, lo:lo + tflash.BLOCK].transpose(-1, -2)) * inv_sqrt
        blk = same[..., lo:lo + tflash.BLOCK]
        return torch.where(blk, sc, ninf) if select else sc + torch.where(blk, 0.0, tflash.MASK_VALUE)

    if s == tflash.BLOCK:
        sc = scores(0)
        p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
        acc = torch.matmul((p / p.sum(dim=-1, keepdim=True)).to(torch.bfloat16).float(), vb)
    else:
        m = torch.full((b, h, s, 1), ninf)
        l = torch.zeros((b, h, s, 1))
        acc = torch.zeros((b, h, s, d))
        for blk, lo in enumerate(range(0, s, tflash.BLOCK)):
            sc = scores(lo)
            m_next = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            if select:
                empty = m_next == ninf
                p = torch.exp(sc - torch.where(empty, 0.0, m_next))
                l_corr = torch.where(empty, 1.0, torch.exp(m - m_next)) * l
            else:
                p = torch.exp(sc - m_next)
                l_corr = torch.exp(m - m_next) * l
            l_next = p.sum(dim=-1, keepdim=True) + l_corr
            inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
            new = acc * (l_corr * inv) + torch.matmul(
                p.to(torch.bfloat16).float(), vb[:, :, lo:lo + tflash.BLOCK]) * inv
            keep = need[:, None, :, blk:blk + 1]
            m, l = torch.where(keep, m_next, m), torch.where(keep, l_next, l)
            acc = torch.where(keep, new, acc)
    return acc.to(torch.bfloat16).permute(0, 2, 1, 3).reshape(b, s, h * d).float()


def bf16_steps(got, ref):
    """Elementwise distance between two tensors of bf16 values in bf16
    steps (ulps) of the larger magnitude."""
    big = torch.maximum(got.abs(), ref.abs())
    _, exp = torch.frexp(big)
    ulp = torch.ldexp(torch.ones_like(big), exp - 8)
    return torch.where(big > 0, (got - ref).abs() / ulp, 0.0)


SKIP_CASES = [(256, "prefix"), (512, "prefix"), (512, "rerank"), (384, "holes"),
              (512, "short"), (256, "segments"), (512, "segments"), (384, "wide_ids")]


@pytest.mark.parametrize("s,kind", SKIP_CASES)
def test_skipped_blocks_change_the_context_by_one_bf16_step_at_most(s, kind):
    """The kernel leaves out (64-row tile, 128-key block) pairs that share
    no segment id: against ``flash_attention_plain`` on every row the bf16
    context is equal but for one bf16 step at most (the rescale by
    l * (1 / l) that a skipped block would apply, one f32 ulp), with the
    additive mask and with the zero-weight select alike."""
    b, h, d = 3, 2, 32
    q, k, v = make_qkv(b, s, h, d, seed=s + 7)
    seg = make_mask(kind, b, s, seed=s + 7)
    if kind == "short":  # row tile 0 of each real pair attends key block 0 only
        assert not needed_blocks(seg)[:-1, 0, 1:].any()
    inv = 1.0 / np.sqrt(d)
    ref = tflash.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v, seg)), inv)
    for select in (False, True):
        got = skipping_flash(q, k, v, seg, inv, select=select)
        steps = bf16_steps(got, ref)
        assert steps.max() <= 1.0, (select, float(steps.max()))
        assert (steps == 0).float().mean() > 0.99


@pytest.mark.parametrize("s,kind", SKIP_CASES + [(128, "holes"), (128, "segments")])
def test_zero_weight_select_gives_the_plain_context(s, kind):
    """A masked key's weight as a zero select (score -inf, m = -inf until a
    key of the row's segment appears) in place of jax's finite additive
    mask value: with no block skipped, the context is the plain version's
    bit for bit, pad rows and all-padding pairs included."""
    b, h, d = 3, 2, 32
    q, k, v = make_qkv(b, s, h, d, seed=s + 11)
    seg = make_mask(kind, b, s, seed=s + 11)
    inv = 1.0 / np.sqrt(d)
    ref = tflash.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v, seg)), inv)
    got = skipping_flash(q, k, v, seg, inv, skip=False, select=True)
    assert torch.equal(got, ref)


def test_padded_head_dim_rule():
    """The kernel is built for heads of 32, 64, 128 and 256 and every
    multiple of 128 above; every other width up to 128 pads to the next of
    32, 64 and 128.  Above S 128 other widths over 128 are refused, as
    jax's kernel refuses them; at S 128 (jax's single step takes any
    width) they pad to 256 or the next multiple of 128."""
    for s in (128, 256, 1024):
        for d in range(1, 129):
            want = 32 if d <= 32 else 64 if d <= 64 else 128
            assert tflash.padded_head_dim(d, s) == want, d
        for d in (256, 384, 512, 1024):
            assert tflash.padded_head_dim(d, s) == d
    for d in (0, 129, 192, 255, 257, 320):
        with pytest.raises(ValueError, match="head_dim"):
            tflash.padded_head_dim(d, 256)
    for d, want in ((129, 256), (192, 256), (255, 256), (257, 384), (320, 384)):
        assert tflash.padded_head_dim(d, 128) == want
    with pytest.raises(ValueError, match="head_dim"):
        tflash.padded_head_dim(0, 128)


@pytest.mark.parametrize("d", [8, 24, 32, 48, 64, 80, 100, 128, 256])
def test_kernel_inputs_pad_with_zero_columns(d):
    """q, k and v as the kernel takes them: bf16, contiguous, the head
    padded to ``padded_head_dim`` with zero columns after the d values."""
    q, k, v = (torch.from_numpy(a) for a in make_qkv(2, 128, 3, d, seed=d))
    dp = tflash.padded_head_dim(d, 128)
    for x, y in zip((q, k, v), tflash.kernel_inputs(q, k, v)):
        assert y.shape == (2, 128, 3, dp) and y.dtype == torch.bfloat16 and y.is_contiguous()
        assert torch.equal(y[..., :d], x.to(torch.bfloat16))
        assert not y[..., d:].any()


# -- the gate ---------------------------------------------------------------------


@pytest.mark.parametrize("value", [None, "0", "false", "", "1", "False", "true", "off"])
def test_gate_env_contract_matches_jax(monkeypatch, value):
    """JAX's exact, case-sensitive string test: off only unset, ``0``,
    ``false`` and ``""``; on at multiples of 128 from 128.  Graded or not:
    like JAX's, the gate has no rule for a graded forward (the flash
    attention has jax's backward), and ``encode`` asks it the same way in
    both."""
    if value is None:
        monkeypatch.delenv("RAG_TPU_FLASH", raising=False)
    else:
        monkeypatch.setenv("RAG_TPU_FLASH", value)
    on = value not in (None, "0", "false", "")
    assert list(inspect.signature(tbert._flash_enabled).parameters) == ["seq", "heads"]
    _, _, model = make_models(0)
    for seq in (64, 128, 200, 256, 384, 512):
        want = on and seq % 128 == 0
        assert tbert._flash_enabled(seq, 12) == want == jax_gate(seq, 12), (value, seq)
        with graded(model):
            assert tbert._graded(model)
            assert tbert._flash_enabled(seq, 12) == jax_gate(seq, 12), (value, seq)


def test_encode_routes_pair_then_flash_then_einsum(monkeypatch):
    """The order JAX's ``encode`` takes: the pair-attention gate first,
    then flash, then the einsum path."""
    _, _, model = make_models(0)
    monkeypatch.setenv("RAG_TPU_FLASH", "1")
    taken = []
    for name in ("encoder_self_attention", "encoder_flash_attention", "_einsum_attention"):
        monkeypatch.setattr(tbert, name, lambda *a, _n=name, **k: taken.append(_n) or
                            torch.zeros(a[0].shape[0], a[0].shape[1], 64))
    for pair_attn, seq, want in (("auto", 256, "encoder_self_attention"),
                                 ("0", 256, "encoder_flash_attention"),
                                 ("auto", 128, "encoder_flash_attention"),
                                 ("auto", 64, "_einsum_attention"),
                                 ("1", 128, "encoder_self_attention")):
        monkeypatch.setenv("RAG_TPU_PAIR_ATTN", pair_attn)
        taken.clear()
        model.encode(*(torch.from_numpy(a) for a in make_inputs(seq=seq)))
        assert taken == [want] * 2, (pair_attn, seq, taken)


# -- the pair layout -----------------------------------------------------------------


@pytest.mark.parametrize("p,lq,dlen,max_seq,plen", [
    (13, 32, 24, None, 128), (60, 32, 368, None, 512), (16, 32, 96, None, 128),
    (9, 32, 368, 256, 256), (9, 32, 200, 100, 128), (8, 64, 64, None, 128),
])
def test_assemble_pairs_identical_under_flash(monkeypatch, p, lq, dlen, max_seq, plen):
    """Pairs pad to a multiple of 128 after the trained-length trim, as
    JAX's do: 400 -> 512; a reranker trained at 256 stays at 256."""
    monkeypatch.setenv("RAG_TPU_FLASH", "1")
    monkeypatch.setattr(jbert, "_flash_enabled", jax_gate)
    rng = np.random.default_rng(p + dlen)
    pair_q = rng.integers(0, 50, (p, lq)).astype(np.int32)
    pair_d = rng.integers(0, 50, (p, dlen)).astype(np.int32)
    jcfg = jbert.BertConfig(**TINY, max_seq_length=max_seq)
    tcfg = tbert.BertConfig(**TINY, max_seq_length=max_seq)
    ref = jfq._assemble_pairs(jax.numpy.asarray(pair_q), jax.numpy.asarray(pair_d),
                              rerank_cfg=jcfg)
    got = tfq._assemble_pairs(torch.from_numpy(pair_q), torch.from_numpy(pair_d),
                              rerank_cfg=tcfg)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32 and g.shape == (-(-p // 8) * 8, plen)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# -- the encoder and the slice -------------------------------------------------------


def make_models(seed, **extra):
    jcfg = jbert.BertConfig(**TINY, **extra)
    params = jbert.init_params(jax.random.PRNGKey(seed), jcfg)
    model = tbert.load_jax_params(tbert.BertModel(tbert.BertConfig(**TINY, **extra),
                                                  device="cpu"),
                                  jax.tree_util.tree_map(np.asarray, params))
    return params, jcfg, model


def make_inputs(b=3, seq=256, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1000, (b, seq)).astype(np.int32)
    lens = np.array([seq, 150, 40][:b])
    mask = (np.arange(seq)[None, :] < lens[:, None]).astype(np.int32)
    types = np.zeros_like(ids)
    types[:, 20:] = 1
    return ids * mask, types, mask


def test_encode_matches_jax_flash_branch(jax_flash_gate):
    """S 256 (two key blocks, so the online softmax rescales): every
    position, pad rows included, against JAX's flash branch."""
    params, jcfg, model = make_models(1)
    ids, types, mask = make_inputs()
    want = np.asarray(jbert.encode(params, ids, types, mask, jcfg))
    got = model.encode(*(torch.from_numpy(a) for a in (ids, types, mask))).numpy()
    assert jax_flash_gate == {"jax": 1, "port": 2}
    assert got.shape == (3, 256, 64)
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)


def test_fused_two_stage_matches_jax_under_flash(case, jax_flash_gate):  # noqa: F811
    """The slice: the pairs pad from 56 to 128 and both rerankers take
    their flash branch; rows exact, scores within the bounds of
    ``test_torch_fused_query.py``."""
    rows_j, bi_j, ce_j = run_jax(case)
    rows_t, bi_t, ce_t = run_port(case)
    # JAX traces its rerank layer once; the port runs both rerank layers
    # (the query embed, S 32, takes the einsum path on both sides)
    assert jax_flash_gate == {"jax": 1, "port": 2}
    np.testing.assert_array_equal(rows_t, case["planted"])
    np.testing.assert_array_equal(rows_t, rows_j)
    np.testing.assert_allclose(bi_t, bi_j, atol=2e-3, rtol=0)
    np.testing.assert_allclose(ce_t, ce_j, atol=3e-2, rtol=0)
    assert np.isfinite(ce_t).all() and ce_t.shape == (B, K)


# -- training -------------------------------------------------------------------------


def test_graded_step_takes_no_flash_and_keeps_its_gradients(monkeypatch):
    """A cross-encoder step at a 128 bucket under ``RAG_TPU_FLASH=1
    RAG_TPU_PAIR_ATTN=0``.  Since the flash attention has jax's backward
    (``ops/flash_attention.py _FlashAttention``), the graded forward takes
    the flash function in both layers, and the einsum path not at all; the
    loss and gradients keep those of the einsum step without the variables
    within the bounds ``tests/test_torch_flash_backward.py`` states (the
    loss within 1e-4 relative, the whole gradient within 1e-2 of its norm;
    measured 0 and 1.0e-6 here); outside a graded forward the same
    model takes the flash path too."""
    from financial_rag_system_tpu_torch.train import cross_encoder as tcross

    _, _, model = make_models(2, with_pooler=True, num_labels=1)
    ids, types, mask = make_inputs(b=3, seq=128, seed=3)
    batch = [torch.from_numpy(a) for a in (ids, types, mask)]
    labels = torch.tensor([1.0, 0.0, 1.0])

    def step():
        with graded(model):
            loss = tcross.bce_loss(model, *batch, labels, 3.0)
            loss.backward()
            grads = [None if p.grad is None else p.grad.clone() for p in model.parameters()]
            model.zero_grad(set_to_none=True)
        return loss.detach(), grads

    loss0, grads0 = step()
    calls = {"flash": 0, "einsum": 0}

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(tbert, "encoder_flash_attention",
                        counted("flash", tbert.encoder_flash_attention))
    monkeypatch.setattr(tbert, "_einsum_attention", counted("einsum", tbert._einsum_attention))
    monkeypatch.setenv("RAG_TPU_FLASH", "1")
    monkeypatch.setenv("RAG_TPU_PAIR_ATTN", "0")
    loss1, grads1 = step()
    assert calls == {"flash": 2, "einsum": 0}
    assert abs(float(loss1) - float(loss0)) <= 1e-4 * abs(float(loss0))
    assert [g is None for g in grads0] == [g is None for g in grads1]
    assert sum(g is not None for g in grads0) > 10
    pairs = [(a.double(), b.double()) for a, b in zip(grads0, grads1) if a is not None]
    norm = torch.sqrt(sum((a ** 2).sum() for a, _ in pairs))
    assert torch.sqrt(sum(((a - b) ** 2).sum() for a, b in pairs)) <= 1e-2 * norm
    with torch.no_grad():
        tbert.cross_score(model, *batch)
    assert calls == {"flash": 4, "einsum": 0}
