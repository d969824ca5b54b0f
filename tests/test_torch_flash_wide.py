"""Kernel 7 at heads of 256 (``d256::flash256_kernel``) on the CPU.

The kernel runs only on the card; here its plan and its arithmetic are
held to what it must compute:

- ``d256_plan`` (``ops/flash_attention.py``), the mirror of the kernel's
  slots, shared memory and register budgets, against the H100's 232,448
  bytes of shared memory a block and 65,536 registers an SM, and against
  the constants and ``static_assert`` s of ``csrc/flash_attention.cu``;
- :func:`kernel_order`, an f32 emulation of the kernel's order (above S
  128 its online softmax in 64-key steps where jax takes 128-key blocks,
  the context accumulated unnormalised and divided by the row sum at the
  end; at S 128 jax's single plain step; the zero-weight select; the
  (64-row tile, 128-key block) skips; P rounded to bf16 where the kernel
  rounds it), against ``flash_attention_plain`` and against jax's flash
  kernel in interpret mode at d 256 on the skip cases' masks and at S
  128;
- a 2-layer cross-encoder with 2 heads of 256 (hidden 512) at S 256
  under ``RAG_TPU_FLASH=1``: the port's plain path against the JAX
  package's flash branch.

Tolerances: the context is bf16 (one bf16 step of an O(1) value is about
4e-3), so the emulation is held to the kernel-vs-plain atol 1e-2 on every
row, pad rows included, against both references, and to at most one bf16
step at the context's largest magnitude from the plain version; the
encoder to ``test_encode_matches_jax_flash_branch``'s 5e-3.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from financial_rag_system_tpu.models import bert as jbert
from financial_rag_system_tpu_torch.models import bert as tbert
from financial_rag_system_tpu_torch.ops import flash_attention as tflash
from test_torch_flash_attention import (  # noqa: F401
    SKIP_CASES,
    jax_flash_gate,
    make_inputs,
    make_mask,
    make_qkv,
    needed_blocks,
)

SOURCE = (Path(__file__).resolve().parent.parent / "financial_rag_system_tpu_torch" / "csrc"
          / "flash_attention.cu")
LOG2E = 1.4426950408889634
STEP = 64  # the kernel's online-softmax step (kSub): half jax's block_k


def d256_source() -> str:
    text = SOURCE.read_text()
    return text[text.index("namespace d256 {"):text.index("}  // namespace d256")]


def kernel_order(q, k, v, seg, inv_sqrt, step=STEP):
    """The D-256 kernel's arithmetic over (B, S, H, d) f32 q, k, v and (B, S)
    segment ids, in f32: scores of bf16 values; a key of another segment
    takes -inf (zero weight); at S 128 the plain softmax, p / sum(p)
    rounded to bf16; above it, steps of ``step`` keys in order, m_next =
    max(m, rowmax), alpha = 2^((m - m_next) c2) (1 while m_next is -inf),
    p = 2^(s c2 - m_next c2), l = l alpha + sum(p), acc = acc alpha +
    bf16(p) . V, every (64-row tile, 128-key block) pair that shares no
    segment id left out; then acc / l (1 where l is 0).  Returns the
    (B, S, H * d) context rounded to bf16, as f32."""
    b, s, h, d = q.shape
    qb, kb, vb = (torch.from_numpy(t).to(torch.bfloat16).float().permute(0, 2, 1, 3)
                  for t in (q, k, v))
    segt = torch.from_numpy(seg)
    same = (segt[:, None, :, None] == segt[:, None, None, :])  # (B, 1, S, S)
    need = torch.from_numpy(needed_blocks(seg)).repeat_interleave(64, dim=1)  # (B, S, blocks)
    c2 = torch.tensor(inv_sqrt * LOG2E, dtype=torch.float32)
    ninf = float("-inf")

    def scores(lo, n):
        sc = torch.matmul(qb, kb[:, :, lo:lo + n].transpose(-1, -2))
        return torch.where(same[..., lo:lo + n], sc, ninf)

    if s == tflash.BLOCK:
        sc = scores(0, s)
        mx = sc.amax(dim=-1, keepdim=True)
        p = torch.exp2(sc * c2 - mx * c2)
        p = p * (1.0 / p.sum(dim=-1, keepdim=True))
        acc = torch.matmul(p.to(torch.bfloat16).float(), vb)
        return acc.to(torch.bfloat16).permute(0, 2, 1, 3).reshape(b, s, h * d).float()
    m = torch.full((b, h, s, 1), ninf)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, d))
    for blk in range(s // tflash.BLOCK):
        keep = need[:, None, :, blk:blk + 1]
        for lo in range(blk * tflash.BLOCK, (blk + 1) * tflash.BLOCK, step):
            sc = scores(lo, step)
            mn = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            empty = mn == ninf
            alpha = torch.where(empty, 1.0, torch.exp2((m - mn) * c2))
            p = torch.exp2(sc * c2 - torch.where(empty, 0.0, mn * c2))
            l_new = l * alpha + p.sum(dim=-1, keepdim=True)
            acc_new = acc * alpha + torch.matmul(p.to(torch.bfloat16).float(),
                                                 vb[:, :, lo:lo + step])
            m = torch.where(keep, mn, m)
            l = torch.where(keep, l_new, l)
            acc = torch.where(keep, acc_new, acc)
    acc = acc * torch.where(l == 0.0, 1.0, 1.0 / l)
    return acc.to(torch.bfloat16).permute(0, 2, 1, 3).reshape(b, s, h * d).float()


def largest_step(x: torch.Tensor) -> float:
    """One bf16 step (ulp) at the largest magnitude in ``x``."""
    _, exp = torch.frexp(x.abs().max())
    return float(torch.ldexp(torch.tensor(1.0), exp - 8))


# -- the plan -------------------------------------------------------------------------


def test_d256_plan_fits_the_block():
    """Five 32 KB slots (a block's 128 keys at half the head's columns, K's
    halves then V's), one 32 KB q tile a consumer warpgroup and two block
    heads fill 231,552 of the 232,448 bytes; a sixth slot would not fit.
    The budgets, 24 registers a producer thread and 240 a consumer's, take
    64,512 of the 65,536 registers, the pool of 384 threads at 168."""
    plan = tflash.d256_plan()
    assert plan.regs_fit
    assert (plan.consumers, plan.threads, plan.producer_regs, plan.consumer_regs) == (2, 384,
                                                                                      24, 240)
    assert 128 * (plan.producer_regs + plan.consumers * plan.consumer_regs) == 64512 <= 65536
    assert plan.threads * (65536 // plan.threads // 8 * 8) == 64512
    assert plan.slot_order == ("K[:, :128]", "K[:, 128:]", "V[:, :128]", "V[:, 128:]")
    assert plan.slot_bytes == tflash.BLOCK * 128 * 2 == 32768
    assert plan.slots == 5
    assert plan.smem == 231552 <= tflash.SMEM_LIMIT == 232448
    assert plan.smem + plan.slot_bytes + 16 > tflash.SMEM_LIMIT
    # a unit is the consumers' row tiles of one item: K and V come from L2
    # S / 128 times an item at every S (4 at S 512)
    for s in (128, 256, 384, 512):
        assert s // (plan.consumers * 64) == s // tflash.BLOCK


def test_d256_plan_mirrors_the_source():
    """The mirror's figures are the kernel's: its constants and the
    ``static_assert`` that pins the ring and its bytes."""
    src = d256_source()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    plan = tflash.d256_plan()
    assert const("kWg") == plan.consumers
    assert const("kProducerRegs") == plan.producer_regs
    assert const("kConsumerRegs") == plan.consumer_regs
    assert const("kSlotsABlock") == len(plan.slot_order)
    assert const("kSub") == STEP == plan.step == tflash.BLOCK // 2
    assert f"ring_slots() == {plan.slots} && smem_bytes(ring_slots()) == {plan.smem}" in src
    assert "static_assert(128 * (kProducerRegs + kWg * kConsumerRegs) <=" in src


# -- the arithmetic -------------------------------------------------------------------


@pytest.mark.parametrize("s,kind", SKIP_CASES + [(128, "holes"), (128, "segments")])
def test_kernel_order_matches_plain_and_jax(s, kind):
    """The kernel's order at d 256 against the plain version (jax's block
    order, normalised after every block; the single plain step at S 128)
    and jax's kernel in interpret mode, on every row, pad rows and
    all-padding pairs included."""
    b, h, d = 3, 2, 256
    q, k, v = make_qkv(b, s, h, d, seed=s + 13)
    seg = make_mask(kind, b, s, seed=s + 13)
    inv = 1.0 / np.sqrt(d)
    got = kernel_order(q, k, v, seg, inv)
    plain = tflash.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v, seg)), inv)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-2, rtol=0)
    assert float((got - plain).abs().max()) <= largest_step(plain)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jbert._flash_attention(q, k, v, seg, inv))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-2, rtol=0)


def test_unnormalised_context_is_the_normalised_one():
    """With jax's 128-key steps, no block skipped and no mask, the
    unnormalised accumulation divided once by l equals jax's per-block
    normalised update up to f32 rounding: the same bf16 P multiplies the
    same V.  The bf16 contexts are equal but for a rounding boundary
    crossed here and there, by one bf16 step of the largest context value
    at most (a value near 0 may then differ by many of its own steps)."""
    q, k, v = make_qkv(2, 512, 2, 256, seed=3)
    seg = np.ones((2, 512), np.int32)
    inv = 1.0 / 16.0
    got = kernel_order(q, k, v, seg, inv, step=tflash.BLOCK)
    plain = tflash.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v, seg)), inv)
    assert float((got - plain).abs().max()) <= largest_step(plain)
    assert (got == plain).float().mean() > 0.99


# -- the encoder ----------------------------------------------------------------------

WIDE = dict(vocab_size=1000, hidden=512, layers=2, heads=2, intermediate=128,
            max_positions=512)


def test_encode_heads_of_256_matches_jax_flash_branch(jax_flash_gate):  # noqa: F811
    """A 2-layer encoder with 2 heads of 256 at S 256 (two key blocks):
    both packages take their flash branch (the pair gates stay off above
    128); every position, pad rows included, against JAX's."""
    jcfg = jbert.BertConfig(**WIDE)
    params = jbert.init_params(jax.random.PRNGKey(4), jcfg)
    model = tbert.load_jax_params(tbert.BertModel(tbert.BertConfig(**WIDE), device="cpu"),
                                  jax.tree_util.tree_map(np.asarray, params))
    ids, types, mask = make_inputs(seed=4)
    assert not tbert._pair_attn_enabled(256, 256)
    want = np.asarray(jbert.encode(params, ids, types, mask, jcfg))
    got = model.encode(*(torch.from_numpy(a) for a in (ids, types, mask))).numpy()
    assert jax_flash_gate == {"jax": 1, "port": 2}
    assert got.shape == (3, 256, 512)
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)
