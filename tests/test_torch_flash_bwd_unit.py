"""Kernels 8 and 9 at heads of 32 and 64 (``unit::walk_kernel``), on the CPU.

The card runs the flash attention's backward at heads of 32 and 64 as
persistent blocks taking units of own 64-row tiles, a ring of walked
64-row blocks serving each unit (``csrc/flash_attention_bwd.cu``,
namespace ``unit``).  Here:

- ``bwd_plan`` against the source's constants and its arithmetic at the
  trainer's shape (B 32, S 512, 12 heads of 32) and at S 1,024;
- the kernels' order of sums and rounding points emulated in torch
  (``unit_backward``: the walked blocks in order, 32 rows for dK/dV at
  heads of 32 and 64 otherwise, p and dS rounded to bf16
  as product operands, ``exp2`` of one fused multiply-add for
  ``ex2.approx``, 1 / l and m log2e made once a row) against
  ``flash_attention_bwd_plain`` and, at one small case, against
  ``jax.vjp`` of jax's flash attention in interpret mode.

Tolerance: each gradient within 2^-7 of the reference's largest
magnitude (one bf16 step of it), as the card holds the kernels to their
plain twins: both round p and dS at the same points and store bf16, and
differ by the order of the f32 sums.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from financial_rag_system_tpu_torch.ops import flash_attention as tflash
from test_torch_flash_backward import flash_case, jax_grads

CSRC = Path(tflash.__file__).resolve().parent.parent / "csrc"
GRAD_RTOL = 2.0 ** -7
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
ROWS = tflash.BWD_ROWS


def unit_source() -> str:
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    return src[src.index("namespace unit {"):src.index("}  // namespace unit")]


def test_bwd_plan_mirrors_the_source():
    """Units of four own tiles at heads of 32 (112 registers a consumer
    thread) and of two at 64 (232); the producer warpgroup at 32; dK/dV at
    heads of 32 walking 32-row blocks in sixteen stages, every other
    launch 64-row blocks in eight; the shared bytes the source pins,
    within the card's 227 KB."""
    body = unit_source()
    for line in ("static constexpr int kUnit = D == 32 ? 4 : 2;",
                 "static constexpr int kWalk = D == 32 && DKV ? 32 : 64;",
                 "static constexpr int kMaxStages = 8 * 64 / kWalk;",
                 "static constexpr int kProducerRegs = 32;", "constexpr int kProducers = 4;",
                 "static_assert(sizeof(Head<64>) == 1296 && sizeof(Head<32>) == 656 &&",
                 "Cfg<32, true>::kConsumerRegs == 112 && Cfg<32, false>::kConsumerRegs == 112 &&",
                 "Cfg<64, true>::kConsumerRegs == 232 && ring_stages<32, true>() == 16 &&",
                 "smem_bytes<32, true>(16) == 142912 && ring_stages<32, false>() == 8 &&",
                 "smem_bytes<32, false>(8) == 142656 && ring_stages<64, true>() == 8 &&",
                 "smem_bytes<64, true>(8) == 208160,"):
        assert line in body, line
    assert tflash.bwd_head_bytes(64) == 1296 and tflash.bwd_head_bytes(32) == 656
    assert tflash.BWD_UNITS == {(32, True): (4, 32), (32, False): (4, 64), (64, True): (2, 64),
                                (64, False): (2, 64)}
    for (d, dkv), (unit, walk, threads, regs, stages, smem) in {
            (32, True): (4, 32, 640, 112, 16, 142912), (32, False): (4, 64, 640, 112, 8, 142656),
            (64, True): (2, 64, 384, 232, 8, 208160),
            (64, False): (2, 64, 384, 232, 8, 208160)}.items():
        plan = tflash.bwd_plan(32, 512, 12, d, dkv)
        assert (plan.unit, plan.walk, plan.threads, plan.producer_regs, plan.consumer_regs,
                plan.regs_fit, plan.stages, plan.smem) == (unit, walk, threads, 32, regs, True,
                                                           stages, smem)
        assert plan.smem <= tflash.SMEM_LIMIT
    for s, d in ((512, 128), (512, 24), (100, 32)):
        with pytest.raises(ValueError):
            tflash.bwd_plan(1, s, 1, d)


@pytest.mark.parametrize("s", [512, 1024])
def test_bwd_plan_units_and_staged_bytes(s):
    """At the trainer's B 32 and 12 heads of 32: ceil(T / 4) units an item
    (T = S / 64 own tiles: 8 at S 512 make two units); each walked block's
    q and dO (dK/dV, 32-row blocks with 16 bytes of values a row) or K and V
    (dQ, 64-row blocks with the row's id) staged once a unit, each own tile
    once: a fifth to a sixth of the first design's bytes, which staged
    every walked block and the own tile again once a (tile, block)."""
    b, h, d = 32, 12, 32
    t = s // ROWS
    tile = ROWS * d * 2
    units = b * h * -(-t // 4)
    for dkv, row in ((True, 16), (False, 4)):
        plan = tflash.bwd_plan(b, s, h, d, dkv)
        assert plan.units == units
        assert plan.staged_bytes == units * s * (4 * d + row) + b * h * t * 2 * tile
        parent = tflash.parent_bwd_staged(b, s, h, d, dkv)
        assert parent == b * h * t * t * (4 * tile + ROWS * row)
        assert 0.15 < plan.staged_bytes / parent < 0.2
    assert tflash.bwd_plan(1, 128, 1, 32).units == 1  # two tiles, a unit of four


def fma32(a, b, c):
    """f32 fma: a b + c rounded once (a b of two f32 is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def unit_backward(qb, kb, vb, seg, dob, m, l, di, inv_sqrt):
    """The unit kernels' arithmetic on (B, S, H, d) bf16 q, k, v, dO, (B,
    S) ids and (B, H, S) f32 m, l, di: per walked block in order (kernel
    8's of 32 rows at heads of 32, kernel 9's of 64), S and dP as f32
    products of bf16 values; p = ex2(s c2 - m log2e) (1 /
    l) with c2 = sm_scale log2e in f32 and one rounding for the
    multiply-add, 0 where the ids differ; dS = (dP - di) p sm_scale; dV +=
    bf16(p)^T dO, dK += bf16(dS)^T q (kernel 8, each key tile's sums over
    the q blocks in order) and dQ += bf16(dS) K (kernel 9, over the key
    blocks in order), in f32; the gradients rounded to bf16.  Returns
    (dQ, dK, dV) as (B, S, H, d) bf16."""
    q, k, v, do = (t.float().permute(0, 2, 1, 3) for t in (qb, kb, vb, dob))
    b, h, s, d = q.shape
    c2 = torch.tensor(inv_sqrt, dtype=torch.float32) * LOG2E
    m2 = (m * LOG2E)[..., None]                     # once a row
    rl = (1.0 / l)[..., None]
    dic = di[..., None]
    ids = seg.to(torch.int32)
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    walk_kv, walk_q = (tflash.BWD_UNITS[d, dkv][1] for dkv in (True, False))

    for lo in range(0, s, walk_kv):
        blk = slice(lo, lo + walk_kv)
        # kernel 8: every key tile against q block `blk` (queries as columns)
        same = (ids[:, None, :, None] == ids[:, None, None, blk])   # (B, 1, keys, 64 q)
        st = torch.matmul(k, q[:, :, blk].transpose(-1, -2))        # S^T
        dpt = torch.matmul(v, do[:, :, blk].transpose(-1, -2))      # dP^T
        pt = torch.exp2(fma32(st, c2, -m2[:, :, blk].transpose(-1, -2)))
        pt = torch.where(same, pt * rl[:, :, blk].transpose(-1, -2), 0.0)
        dst = (dpt - dic[:, :, blk].transpose(-1, -2)) * pt * inv_sqrt
        dv = dv + torch.matmul(pt.bfloat16().float(), do[:, :, blk])
        dk = dk + torch.matmul(dst.bfloat16().float(), q[:, :, blk])
    for lo in range(0, s, walk_q):
        blk = slice(lo, lo + walk_q)
        # kernel 9: every query tile against key block `blk`
        same = (ids[:, None, :, None] == ids[:, None, None, blk])   # (B, 1, queries, 64 keys)
        sc = torch.matmul(q, k[:, :, blk].transpose(-1, -2))
        dp = torch.matmul(do, v[:, :, blk].transpose(-1, -2))
        p = torch.exp2(fma32(sc, c2, -m2.expand_as(sc)))
        p = torch.where(same, p * rl, 0.0)
        ds = (dp - dic) * p * inv_sqrt
        dq = dq + torch.matmul(ds.bfloat16().float(), k[:, :, blk])

    def out(x):
        return x.bfloat16().permute(0, 2, 1, 3)

    return out(dq), out(dk), out(dv)


def card_case(b, s, h, d, seed):
    """flash_case's inputs as the backward takes them: bf16 q, k, v and
    dO, the plain forward's residuals, di from its context."""
    q, k, v, g, seg = flash_case(b, s, h, d, seed)
    inv = 1.0 / np.sqrt(d)
    qb, kb, vb = (torch.from_numpy(t).bfloat16() for t in (q, k, v))
    seg_t = torch.from_numpy(seg)
    out, m, l = tflash.flash_attention_fwd_plain(qb, kb, vb, seg_t, inv)
    dob = torch.from_numpy(g).reshape(q.shape).bfloat16()
    di = (out.float() * dob.float()).sum(-1).permute(0, 2, 1).contiguous()
    return (qb, kb, vb, seg_t, dob, m, l, di, inv), (q, k, v, g, seg)


@pytest.mark.parametrize("s,d,h", [(128, 32, 2), (512, 32, 2), (256, 64, 2), (640, 32, 1)])
def test_unit_order_matches_plain(s, d, h):
    """The emulated kernels against the plain twins on the same residuals:
    each gradient within 2^-7 of the plain one's largest magnitude; a
    masked tail and an all-padding pair (its rows attend one another)."""
    args, _ = card_case(2, s, h, d, seed=s + d)
    qb, kb, vb, seg, dob, m, l, di, inv = args
    got = unit_backward(*args)
    ref = tflash.flash_attention_bwd_plain(qb, kb, vb, seg, dob, m, l, di, inv)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == r.shape == qb.shape and a.dtype == torch.bfloat16, name
        a, r = a.float(), r.float()
        scale = float(r.abs().max())
        assert scale > 0.1, name
        assert float((a - r).abs().max()) <= GRAD_RTOL * scale, name


def test_unit_order_matches_jax_grad():
    """The emulated kernels against ``jax.vjp`` of jax's flash attention
    (interpret mode, backward blocks of 128) at S 256, 2 heads of 32."""
    args, (q, k, v, g, seg) = card_case(2, 256, 2, 32, seed=25)
    _, grads_j = jax_grads(q, k, v, g, seg)
    got = unit_backward(*args)
    for name, a, r in zip(("dq", "dk", "dv"), got, grads_j):
        a = a.float().numpy()
        scale = np.abs(r).max()
        assert scale > 0.1, name
        assert np.abs(a - r).max() <= GRAD_RTOL * scale, name


def test_unit_dispatch_in_the_source():
    """Heads of 32 and 64 take the unit kernel, wider heads the wide kernel
    (the first design's 64-column pieces are gone); the unit kernel waits
    on no cp.async."""
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    assert "if (D == 32) return unit::launch<32, DKV>(" in src
    assert "if (D == 64) return unit::launch<64, DKV>(" in src
    assert "return wide::launch<DKV>(" in src and "bwd_kernel" not in src
    body = unit_source()
    assert "cp_async" not in body and "__syncthreads();" in body
    assert len(re.findall(r"__syncthreads\(\);", body)) == 1  # after the barriers' init only
