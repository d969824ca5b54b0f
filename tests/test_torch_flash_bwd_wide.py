"""Kernels 8 and 9 at heads of 128 and wider (``wide::wide_kernel``), on the CPU.

The card runs the flash attention's backward at heads of 128 and every
wider multiple of 64 as persistent clusters of two blocks taking units of
two own 64-row tiles (one a block) and one column group of their
gradients, a ring of walked blocks over the whole head multicast to both
(``csrc/flash_attention_bwd.cu``, namespace ``wide``).
Here:

- ``wide_bwd_plan`` against the source's constants and the plans it pins
  (``static_assert``), its groups and windows, and its staged bytes at the
  wide trainer's shape (B 32, S 512, 3 heads of 256) against the first
  design's; the clusters do not change the arithmetic;
- the kernel's order of sums and rounding points emulated in torch
  (``wide_backward``: walked blocks of ``wide_walk`` rows in order, each
  split between two warpgroups by rows; S and dP summed over the head's
  64-column chunks in order, or window by window with the unit's own
  group's window last above heads of 512; one pass a column group; p and
  dS rounded to bf16 as product operands, ``exp2`` of one fused
  multiply-add for ``ex2.approx``) against ``flash_attention_bwd_plain``
  and ``jax.vjp`` of jax's flash attention in interpret mode, at heads of
  128, 192 (S 128), 256 and 384, with a masked tail and an all-padding
  pair.

Tolerance: each gradient within 2^-7 of the reference's largest
magnitude (one bf16 step of it), as the card holds the kernels to their
plain twins: both round p and dS at the same points and store bf16, and
differ by the order of the f32 sums.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from financial_rag_system_tpu_torch.ops import flash_attention as tflash
from test_torch_flash_backward import flash_case, jax_grads
from test_torch_flash_bwd_unit import LOG2E, card_case, fma32

CSRC = Path(tflash.__file__).resolve().parent.parent / "csrc"
GRAD_RTOL = 2.0 ** -7
ROWS = tflash.BWD_ROWS


def wide_source() -> str:
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    return src[src.index("namespace wide {"):src.index("}  // namespace wide")]


def test_wide_plan_mirrors_the_source():
    """Two consumer warpgroups at 224 registers beside a producer
    warpgroup at 56; gradient chunks of 2 (dK/dV) and 4 (dQ) a warpgroup;
    up to four stages; the own tile resident up to heads of 512, windows
    of four chunks above; the walked rows by width; the plans the source
    pins, within the card's 227 KB."""
    body = wide_source()
    for line in ("constexpr int kConsumers = 2;",
                 "constexpr int kThreads = 128 * (kConsumers + 1);",
                 "constexpr int kProducerRegs = 56;",
                 "static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= kPool && "
                 "kConsumerRegs == 224,",
                 "constexpr int kMaxStages = 4;", "constexpr int kResidentMax = 512;",
                 "constexpr int kWindow = 4;", "constexpr int kCluster = 2;",
                 "return DKV ? 2 : 4;", "p.pds_b = (DKV ? 2 : 1) * kRows * 2 * W;",
                 "return (r >> 3) * (16 * W) + (k >> 3) * 128 + (r & 7) * 16 + (k & 7) * 2;",
                 "return D <= 256 ? 64 : D <= 384 || D > kResidentMax ? 32 : 16;",
                 "static_assert(sizeof(Head<64>) == 1040 && sizeof(Head<32>) == 528 && "
                 "sizeof(Head<16>) == 272 &&",
                 "plan<64, true>(128).nst == 4 && plan<64, true>(128).smem == 185488 &&",
                 "plan<64, true>(256).nst == 2 && plan<64, true>(256).smem == 216144 &&",
                 "plan<64, false>(256).smem == 207952 && plan<32, true>(384).ng == 2 &&",
                 "plan<32, true>(384).smem == 206928 && plan<32, false>(384).ng == 1 &&",
                 "plan<16, true>(512).nst == 2 && plan<16, true>(512).smem == 202320 &&",
                 "plan<32, true>(640).resident == 0 && plan<32, true>(640).ng == 3 &&",
                 "plan<32, true>(640).smem == 206928,"):
        assert line in body, line
    assert (tflash.WIDE_CONSUMERS, tflash.WIDE_GRAD_CHUNKS, tflash.WIDE_RESIDENT_MAX,
            tflash.WIDE_WINDOW_CHUNKS, tflash.WIDE_MAX_STAGES) == (2, {True: 2, False: 4}, 512,
                                                                   4, 4)
    for (d, dkv), (walk, groups, stages, smem, resident) in {
            (128, True): (64, (2,), 4, 185488, True),
            (256, True): (64, (4,), 2, 216144, True),
            (256, False): (64, (4,), 2, 207952, True),
            (384, True): (32, (4, 2), 2, 206928, True),
            (384, False): (32, (6,), 2, 202832, True),
            (512, True): (16, (4, 4), 2, 202320, True),
            (640, True): (32, (4, 4, 2), 2, 206928, False)}.items():
        plan = tflash.wide_bwd_plan(32, 512, 768 // d if 768 % d == 0 else 1, d, dkv)
        assert (plan.walk, plan.groups, plan.stages, plan.smem, plan.resident) == (
            walk, groups, stages, smem, resident), (d, dkv)
        assert (plan.threads, plan.producer_regs, plan.consumer_regs, plan.regs_fit) == (
            384, 56, 224, True)
        assert plan.smem <= tflash.SMEM_LIMIT
        assert plan.window_chunks == (d // 64 if resident else 4)
    for s, d in ((512, 64), (512, 96), (100, 128)):
        with pytest.raises(ValueError):
            tflash.wide_bwd_plan(1, s, 1, d)


@pytest.mark.parametrize("d", [128, 192, 256, 320, 384, 448, 512, 576, 640, 1024])
def test_wide_plan_fits_every_width(d):
    """Every width the C entries take above 64 has a plan that fits the
    card's shared memory with at least one stage; the groups cover the
    head's chunks in order, each within two warpgroups' gradient chunks
    (or a window)."""
    for dkv in (True, False):
        plan = tflash.wide_bwd_plan(2, 128, 1, d, dkv)
        assert 1 <= plan.stages <= 4 and plan.smem <= tflash.SMEM_LIMIT
        assert sum(plan.groups) == d // 64
        most = 2 * tflash.WIDE_GRAD_CHUNKS[dkv] if plan.resident else 4
        assert all(1 <= g <= most for g in plan.groups)
        assert list(plan.groups[:-1]) == [most] * (len(plan.groups) - 1)
        assert plan.units == 2 * (128 // ROWS // 2) * len(plan.groups)  # B 2, T 2, H 1


def test_wide_staged_bytes_at_the_trainer_shape():
    """At B 32, S 512, 3 heads of 256: units of a cluster's two tiles
    (384), each walked block's q and dO (or K and V) once a unit
    (multicast to both blocks) and its rows' values once a block, each own
    tile once: about a twelfth of the first design's bytes, which staged
    the whole head's own and walked chunks once a (tile, block, 64-column
    piece)."""
    b, s, h, d = 32, 512, 3, 256
    assert tflash.WIDE_CLUSTER == 2
    for dkv, row in ((True, 16), (False, 4)):
        plan = tflash.wide_bwd_plan(b, s, h, d, dkv)
        assert plan.cluster == 2 and plan.units == b * h * (s // ROWS) // 2
        assert plan.staged_bytes == plan.units * (2 * 256 * d + s * (4 * d + 2 * row))
        parent = tflash.parent_bwd_staged(b, s, h, d, dkv)
        assert parent == b * h * (s // ROWS) * 4 * (s // ROWS) * (4 * ROWS * d * 2 + ROWS * row)
        assert 12 < parent / plan.staged_bytes < 13


def window_order(grp: int, ng: int) -> list:
    """The windows a unit of column group ``grp`` walks, its own last."""
    return [(grp + 1 + i) % ng for i in range(ng)]


def wide_backward(qb, kb, vb, seg, dob, m, l, di, inv_sqrt):
    """The wide kernels' arithmetic on (B, S, H, d) bf16 q, k, v, dO, (B,
    S) ids and (B, H, S) f32 m, l, di, d 128 or a wider multiple of 64: for
    each column group, per walked block in order (``wide_walk`` rows, split
    in halves between the two warpgroups), S^T and dP^T (S and dP for dQ)
    summed over the head's 64-column chunks in order, or over windows of
    four chunks in :func:`window_order` above heads of 512; p = ex2(s c2 -
    m log2e) (1 / l) with c2 = sm_scale log2e in f32 and one rounding for
    the multiply-add, 0 where the ids differ; dS = (dP - di) p sm_scale;
    the group's columns of dV += bf16(p)^T dO and dK += bf16(dS)^T q
    (kernel 8), dQ += bf16(dS) K (kernel 9), in f32 over the blocks in
    order; the gradients rounded to bf16.  Returns (dQ, dK, dV) as (B, S,
    H, d) bf16."""
    q, k, v, do = (t.float().permute(0, 2, 1, 3) for t in (qb, kb, vb, dob))
    b, h, s, d = q.shape
    c2 = torch.tensor(inv_sqrt, dtype=torch.float32) * LOG2E
    m2 = (m * LOG2E)[..., None]
    rl = (1.0 / l)[..., None]
    dic = di[..., None]
    ids = seg.to(torch.int32)
    walk, nc = tflash.wide_walk(d), d // 64
    out = {"dq": torch.zeros_like(q), "dk": torch.zeros_like(q), "dv": torch.zeros_like(q)}

    def chunked(a, bm, order):  # a . bm^T over 64-column chunks, summed in `order`
        acc = None
        for c in order:
            cols = slice(64 * c, 64 * c + 64)
            part = torch.matmul(a[..., cols], bm[..., cols].transpose(-1, -2))
            acc = part if acc is None else acc + part
        return acc

    for dkv in (True, False):
        groups = tflash.wide_groups(d, dkv)
        starts = np.cumsum((0,) + groups)
        for grp, gn in enumerate(groups):
            if d <= tflash.WIDE_RESIDENT_MAX:
                order = list(range(nc))
            else:  # windows of the group partition, the group's own last
                order = [c for win in window_order(grp, len(groups))
                         for c in range(starts[win], starts[win] + groups[win])]
            cols = slice(64 * starts[grp], 64 * (starts[grp] + gn))
            for lo in range(0, s, walk):
                halves = (slice(lo, lo + walk // 2), slice(lo + walk // 2, lo + walk))
                if dkv:  # own rows: keys; walked rows: queries (columns)
                    st = torch.cat([chunked(k, q[:, :, hv], order) for hv in halves], -1)
                    dpt = torch.cat([chunked(v, do[:, :, hv], order) for hv in halves], -1)
                    blk = slice(lo, lo + walk)
                    same = ids[:, None, :, None] == ids[:, None, None, blk]
                    pt = torch.exp2(fma32(st, c2, -m2[:, :, blk].transpose(-1, -2)))
                    pt = torch.where(same, pt * rl[:, :, blk].transpose(-1, -2), 0.0)
                    dst = (dpt - dic[:, :, blk].transpose(-1, -2)) * pt * inv_sqrt
                    out["dv"][..., cols] += torch.matmul(pt.bfloat16().float(), do[:, :, blk, cols])
                    out["dk"][..., cols] += torch.matmul(dst.bfloat16().float(), q[:, :, blk, cols])
                else:  # own rows: queries; walked rows: keys
                    sc = torch.cat([chunked(q, k[:, :, hv], order) for hv in halves], -1)
                    dp = torch.cat([chunked(do, v[:, :, hv], order) for hv in halves], -1)
                    blk = slice(lo, lo + walk)
                    same = ids[:, None, :, None] == ids[:, None, None, blk]
                    p = torch.exp2(fma32(sc, c2, -m2.expand_as(sc)))
                    p = torch.where(same, p * rl, 0.0)
                    ds = (dp - dic) * p * inv_sqrt
                    out["dq"][..., cols] += torch.matmul(ds.bfloat16().float(), k[:, :, blk, cols])

    def bf(x):
        return x.bfloat16().permute(0, 2, 1, 3)

    return bf(out["dq"]), bf(out["dk"]), bf(out["dv"])


@pytest.mark.parametrize("s,d,h", [(256, 128, 2), (128, 192, 1), (256, 256, 1), (256, 384, 1),
                                   (128, 640, 1)])
def test_wide_order_matches_plain(s, d, h):
    """The emulated kernels against the plain twins on the same residuals:
    each gradient within 2^-7 of the plain one's largest magnitude; a
    masked tail and an all-padding pair (its rows attend one another);
    heads of 384 in two column groups for dK/dV, 640 in windows."""
    args, _ = card_case(2, s, h, d, seed=s + d)
    qb, kb, vb, seg, dob, m, l, di, inv = args
    got = wide_backward(*args)
    ref = tflash.flash_attention_bwd_plain(qb, kb, vb, seg, dob, m, l, di, inv)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == r.shape == qb.shape and a.dtype == torch.bfloat16, name
        a, r = a.float(), r.float()
        scale = float(r.abs().max())
        assert scale > 0.1, name
        assert float((a - r).abs().max()) <= GRAD_RTOL * scale, name


@pytest.mark.parametrize("s,d", [(256, 128), (128, 192), (256, 256), (256, 384)])
def test_wide_order_matches_jax_grad(s, d):
    """The emulated kernels against ``jax.vjp`` of jax's flash attention
    (interpret mode, backward blocks of 128), one head, a masked tail and
    an all-padding pair."""
    args, (q, k, v, g, seg) = card_case(2, s, 1, d, seed=s + d + 1)
    _, grads_j = jax_grads(q, k, v, g, seg)
    got = wide_backward(*args)
    for name, a, r in zip(("dq", "dk", "dv"), got, grads_j):
        a = a.float().numpy()
        scale = np.abs(r).max()
        assert scale > 0.1, name
        assert np.abs(a - r).max() <= GRAD_RTOL * scale, name


def test_wide_case_has_a_masked_tail_and_a_padding_pair():
    """The cases above hold what the kernel's skips see: pair 0's masked
    tail of 77 keys (a block that shares ids with some tiles only) and
    the last pair all padding (one segment, id 0)."""
    _, _, _, _, seg = flash_case(2, 256, 1, 128, seed=0)
    assert (seg[0, :179] == 1).all() and (seg[0, 179:] == 0).all() and (seg[-1] == 0).all()


def test_wide_counters():
    """A launch at heads of 128 and wider counts on the wide counters,
    apart from the unit kernel's."""
    assert tflash.bwd_counter(32, True) == "launches_bwd_dkv"
    assert tflash.bwd_counter(64, False) == "launches_bwd_dq"
    assert tflash.bwd_counter(128, True) == "launches_bwd_wide_dkv"
    assert tflash.bwd_counter(384, False) == "launches_bwd_wide_dq"
    for name in ("launches_bwd_wide_dkv", "launches_bwd_wide_dq"):
        assert isinstance(getattr(tflash.encoder_flash_attention, name), int)
