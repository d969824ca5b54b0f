"""The flash attention's backward (kernels 8 and 9) against jax's, on the CPU.

On the CPU the port's autograd function over the flash attention
(``ops/flash_attention.py _FlashAttention``) runs its plain twins:
``flash_attention_fwd_plain`` (the context with jax's residuals m and l)
and ``flash_attention_bwd_plain`` (jax's dK/dV and dQ kernels step by
step).  JAX's reference is ``jax.grad`` through jax's bundled
``flash_attention`` with every backward block size set to 128, its
kernels in interpret mode (``force_tpu_interpret_mode``).  Inputs come
from numpy with a seed.

Tolerances:
- the gradients of q, k and v within 2^-7 of the reference tensor's
  largest magnitude (one bf16 step of it): both sides round p and dS to
  bf16 at the same points and store bf16 gradients, so they differ by the
  order of the f32 sums and one bf16 step where a rounding tips (measured
  at most 1.8e-3 of the largest magnitude); the context within 1e-2 on
  every row, as ``tests/test_torch_flash_attention.py`` holds it;
- m within 1e-5 absolute (measured at most 1.7e-6) and l within 1e-5 of
  its own magnitude (measured at most 1.6e-6 relative);
- the cross-encoder step under ``RAG_TPU_FLASH=1``, against JAX's step on
  its flash branch (backward blocks patched in) and against JAX's einsum
  step: the gradient's L2 difference within ``GRAD_TOL`` of its norm and
  each leaf within ``LEAF_RTOL`` of its own norm (the key bias, whose
  exact gradient is 0, within ``GRAD_TOL`` of the whole norm), as
  ``tests/test_torch_train.py`` holds the einsum step; the loss within
  ``LOSS_RTOL`` relative of JAX's flash step and ``EINSUM_LOSS_RTOL`` of
  its einsum step.  Measured: the loss equal to JAX's flash step's and the
  whole gradient within 5.4e-6 of its norm (a leaf within 1.0e-3); against
  the einsum step the loss within 8.5e-6 and the gradient within 3.9e-4
  (a leaf 4.0e-3), as far as JAX's own flash and einsum steps are apart
  (bf16(p) of a blockwise softmax against a softmax rounded after
  normalising).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jfa

from financial_rag_system_tpu.models import bert as jbert
from financial_rag_system_tpu.models import hf_export as jexport
from financial_rag_system_tpu.train import cross_encoder as jcross
from financial_rag_system_tpu_torch.models import bert as tbert
from financial_rag_system_tpu_torch.models import hf_loader as tloader
from financial_rag_system_tpu_torch.ops import flash_attention as tflash
from financial_rag_system_tpu_torch.train import cross_encoder as tcross
from financial_rag_system_tpu_torch.train.optim import graded
from test_torch_flash_attention import jax_gate
from test_torch_train import assert_grads_close, grab_grads, grads_of

GRAD_RTOL = 2.0 ** -7
LOSS_RTOL = 1e-5
EINSUM_LOSS_RTOL = 1e-4


def block_sizes(seq: int) -> jfa.BlockSizes:
    """Every block 128 (the whole sequence at S 128), backward blocks too."""
    n = min(128, seq)
    return jfa.BlockSizes(block_q=n, block_k_major=n, block_k=n, block_b=1,
                          block_q_major_dkv=n, block_k_major_dkv=n, block_k_dkv=n,
                          block_q_dkv=n, block_k_major_dq=n, block_k_dq=n, block_q_dq=n)


def jax_flash_with_backward(q, k, v, attention_mask, inv_sqrt):
    """``financial_rag_system_tpu/models/bert.py _flash_attention`` with
    backward block sizes added (its own gives forward blocks only, so
    ``jax.grad`` through it raises)."""
    b, seq, nh, hd = q.shape
    seg = attention_mask.astype(jnp.int32)
    ctx = jfa.flash_attention(
        q.transpose(0, 2, 1, 3).astype(jnp.bfloat16),
        k.transpose(0, 2, 1, 3).astype(jnp.bfloat16),
        v.transpose(0, 2, 1, 3).astype(jnp.bfloat16),
        segment_ids=jfa.SegmentIds(seg, seg), sm_scale=inv_sqrt, block_sizes=block_sizes(seq),
    )
    return ctx.transpose(0, 2, 1, 3).reshape(b, seq, nh * hd).astype(jnp.float32)


def flash_case(b, s, h, d, seed):
    """q, k, v, the context's cotangent and segment ids: pair 0 with a
    masked tail of 77 keys, the last pair all padding."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(4))
    seg = np.ones((b, s), np.int32)
    seg[0, s - 77:] = 0
    seg[-1] = 0
    return q, k, v, g.reshape(b, s, h * d), seg


def jax_grads(q, k, v, g, seg):
    inv = 1.0 / np.sqrt(q.shape[-1])
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda *a: jax_flash_with_backward(*a, seg, inv), q, k, v)
        return np.asarray(out), [np.asarray(t) for t in vjp(g)]


def port_grads(q, k, v, g, seg):
    inv = 1.0 / np.sqrt(q.shape[-1])
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = tflash.encoder_flash_attention(*leaves, torch.from_numpy(seg), inv)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("s,d,h", [
    (128, 32, 2), (256, 32, 2), (128, 64, 2), (256, 64, 2), (128, 128, 1), (256, 128, 1),
    (128, 256, 1), (256, 256, 1), (640, 32, 1),
])
def test_plain_twins_match_jax_grad(s, d, h):
    """dQ, dK and dV through the port's autograd function (the plain twins
    on the CPU) against ``jax.grad`` of jax's flash attention: every width
    the kernels are built for at one and two key blocks, and five blocks
    at S 640; a masked tail and an all-padding pair (its rows attend one
    another)."""
    q, k, v, g, seg = flash_case(2, s, h, d, seed=s + d)
    out_j, grads_j = jax_grads(q, k, v, g, seg)
    out_t, grads_t = port_grads(q, k, v, g, seg)
    np.testing.assert_array_equal(out_t, tflash.flash_attention_plain(
        *(torch.from_numpy(t) for t in (q, k, v, seg)), 1.0 / np.sqrt(d)).numpy())
    np.testing.assert_allclose(out_t, out_j, atol=1e-2, rtol=0)
    for name, got, ref in zip(("dq", "dk", "dv"), grads_t, grads_j):
        assert got.shape == ref.shape == q.shape and got.dtype == np.float32
        assert np.isfinite(got).all()
        # bf16 values: the gradients are stored as bf16
        assert np.array_equal(got, torch.from_numpy(got).bfloat16().float().numpy())
        scale = np.abs(ref).max()
        assert scale > 0.1, name
        err = np.abs(got - ref).max()
        assert err <= GRAD_RTOL * scale, (name, err, scale)


@pytest.mark.parametrize("s,d", [(128, 32), (256, 64), (640, 32), (256, 256)])
def test_residuals_match_jax_forward(s, d):
    """m and l of ``flash_attention_fwd_plain`` against jax's forward with
    ``save_residuals`` (its (B, H, S, 128) broadcast, one value a row)."""
    q, k, v, _, seg = flash_case(2, s, 2, d, seed=s + d + 1)
    inv = 1.0 / np.sqrt(d)
    with pltpu.force_tpu_interpret_mode():
        o, l_j, m_j = jfa._flash_attention(
            *(jnp.asarray(t).transpose(0, 2, 1, 3).astype(jnp.bfloat16) for t in (q, k, v)),
            None, jfa.SegmentIds(seg, seg), True, False, inv, block_sizes(s), False)
    out, m, l = tflash.flash_attention_fwd_plain(*(torch.from_numpy(t) for t in (q, k, v, seg)),
                                                 inv)
    assert m.shape == l.shape == (2, 2, s) and m.dtype == l.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(o.astype(jnp.float32)).transpose(0, 2, 1, 3),
                               atol=1e-2, rtol=0)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(l.numpy(), np.asarray(l_j), atol=0, rtol=1e-5)
    assert (l.numpy() >= 1.0).all()  # every row attends its own key, whose p is 1 at its max


def test_bwd_plain_parts_and_the_autograd_function():
    """``flash_attention_bwd_plain`` asked for dQ alone or dK/dV alone gives
    those of the full call; the autograd function computes only what
    requires grad, pads nothing on the CPU and counts no launch."""
    q, k, v, g, seg = flash_case(2, 256, 2, 32, seed=9)
    t = [torch.from_numpy(a) for a in (q, k, v, seg)]
    inv = 1.0 / np.sqrt(32)
    out, m, l = tflash.flash_attention_fwd_plain(*t, inv)
    do = torch.from_numpy(g).reshape(q.shape).bfloat16()
    di = (out.float() * do.float()).sum(-1).permute(0, 2, 1)
    full = tflash.flash_attention_bwd_plain(*t, do, m, l, di, inv)
    only_q = tflash.flash_attention_bwd_plain(*t, do, m, l, di, inv, dkv=False)
    only_kv = tflash.flash_attention_bwd_plain(*t, do, m, l, di, inv, dq=False)
    assert only_q[1] is None and only_q[2] is None and only_kv[0] is None
    assert torch.equal(only_q[0], full[0])
    assert torch.equal(only_kv[1], full[1]) and torch.equal(only_kv[2], full[2])
    assert all(x.dtype == torch.bfloat16 and x.shape == q.shape for x in full)
    counts = (tflash.encoder_flash_attention.launches_bwd_dkv,
              tflash.encoder_flash_attention.launches_bwd_dq)
    qq = t[0].clone().requires_grad_(True)
    ctx = tflash.encoder_flash_attention(qq, t[1], t[2], t[3], inv)
    assert type(ctx.grad_fn).__name__ == "_FlashAttentionBackward"
    ctx.backward(torch.from_numpy(g))
    assert torch.equal(qq.grad, full[0].float())
    assert counts == (tflash.encoder_flash_attention.launches_bwd_dkv,
                      tflash.encoder_flash_attention.launches_bwd_dq)
    # without grad: the plain forward, no autograd function
    with torch.no_grad():
        assert tflash.encoder_flash_attention(qq, t[1], t[2], t[3], inv).grad_fn is None


# -- the slice: a cross-encoder step under RAG_TPU_FLASH=1 ------------------------------

CROSS = dict(vocab_size=1000, hidden=64, layers=2, heads=2, intermediate=128,
             max_positions=256, with_pooler=True, num_labels=1)


def cross_batch(b, s, seed):
    """Pairs as ``pad_batch`` lays them out: [CLS] query [SEP] document
    [SEP], types 1 from the document on, padding to ``s``; one pair fills
    the bucket, the others end at random lengths."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 1000, (b, s)).astype(np.int32)
    lens = np.concatenate([[s], rng.integers(s // 3, s, b - 1)])
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    types = (np.arange(s)[None, :] >= 12).astype(np.int32) * mask
    labels = np.array([1.0, 0.0, 1.0][:b], np.float32)
    return ids * mask, types, mask, labels


@pytest.fixture()
def weights(tmp_path):
    """JAX's ``init_params`` for ``CROSS``, and the port's model read from
    the checkpoint JAX's ``save_bert_checkpoint`` writes of them."""
    jcfg = jbert.BertConfig(**CROSS)
    params = jax.tree_util.tree_map(np.asarray, jbert.init_params(jax.random.PRNGKey(4), jcfg))
    jexport.save_bert_checkpoint(params, jcfg, str(tmp_path / "ckpt"), cross_encoder=True)
    model, _ = tloader.load_bert_checkpoint(str(tmp_path / "ckpt"), with_pooler=True,
                                            num_labels=1, device="cpu")
    return params, jcfg, model


def jax_step(params, jcfg, batch):
    step = jcross.make_cross_step(jcfg, grab_grads(), pos_weight=3.0)
    _, grads, loss = step(params, grab_grads().init(params), *map(jnp.asarray, batch))
    return float(loss), grads


@pytest.mark.parametrize("s", [128, 256])
def test_cross_encoder_step_under_flash_matches_jax(monkeypatch, weights, s):
    """The port's graded step at a 128 and a 256 bucket under
    ``RAG_TPU_FLASH=1`` takes the flash attention (both layers, through
    the autograd function) and matches JAX's step on its flash branch,
    with JAX's gate asked as on a TPU and its flash attention given
    backward blocks, and JAX's einsum step."""
    params, jcfg, model = weights
    batch = cross_batch(3, s, seed=s)
    jax.clear_caches()
    loss_einsum, grads_einsum = jax_step(params, jcfg, batch)
    monkeypatch.setenv("RAG_TPU_FLASH", "1")
    monkeypatch.setattr(jbert, "_flash_enabled", jax_gate)
    calls = {"jax": 0, "port": 0, "einsum": 0}

    def counted(side, fn):
        def call(*a, **k):
            calls[side] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(jbert, "_flash_attention", counted("jax", jax_flash_with_backward))
    monkeypatch.setattr(tbert, "encoder_flash_attention",
                        counted("port", tbert.encoder_flash_attention))
    monkeypatch.setattr(tbert, "_einsum_attention", counted("einsum", tbert._einsum_attention))
    try:
        with pltpu.force_tpu_interpret_mode():
            loss_flash, grads_flash = jax_step(params, jcfg, batch)
    finally:
        jax.clear_caches()
    with graded(model):
        loss = tcross.bce_loss(model, *(torch.from_numpy(a) for a in batch), 3.0)
        loss.backward()
    loss = float(loss.detach())
    # JAX traces its layer once (a scan over the layers); the port runs both
    assert calls == {"jax": 1, "port": 2, "einsum": 0}
    grads = grads_of(model)
    for ref_loss, ref_grads, rtol in ((loss_flash, grads_flash, LOSS_RTOL),
                                      (loss_einsum, grads_einsum, EINSUM_LOSS_RTOL)):
        assert abs(loss - ref_loss) <= rtol * abs(ref_loss), (loss, ref_loss)
        assert_grads_close(ref_grads, grads)
