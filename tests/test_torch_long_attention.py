"""Kernels 2 and 7 at every sequence length and head width the JAX package
computes: S above 512, and kernel 7's heads of 384 and wider.

On the CPU the port runs the plain versions; the JAX package runs its
pair-attention kernel and jax's flash kernel in interpret mode.  Same
numpy inputs.  Beside them, the kernels' new plans emulated in torch or
numpy:

- kernel 2 above S 512 takes the ring kernel at heads of 64 and 128,
  whose producer finds kend by a loop over the mask and reads each
  block's validity as it stages it; heads of 32 take the long-pair kernel
  (``long_pair_attention``): the same producer, the block holding kend
  cut to 64 keys where kend mod 128 is in (0, 64], 64-key online-softmax
  steps, each row's sum taken over the bf16-rounded probs (on the tensor
  cores, against a column of ones), and its units of four row tiles
  (``tattn.long_pair_plan``);
- kernel 7's skip rule builds presence masks per row tile and per block,
  in place of one 32-position word a lane (which held 1,024 positions at
  most);
- kernel 7's slab kernel (heads of 384 and up) computes each 128-column
  slab of the context from QK^T summed over the head's 128-column pieces.

Tolerances: the contexts are bf16, one bf16 step of an O(1) value is
about 4e-3, so kernel functions are held to atol 1e-2 (as the kernels'
other tests); encoders to 5e-3 (as ``tests/test_torch_bert.py``).  Where
a new plan is claimed to give the parent's bits (S <= 512), the models are
compared exactly.
"""

from __future__ import annotations

import functools
import math
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from financial_rag_system_tpu.models import bert as jbert
from financial_rag_system_tpu.models import hf_loader as jhf
from financial_rag_system_tpu.ops import attention as jattention
from financial_rag_system_tpu.ops import fused_query as jfq
from financial_rag_system_tpu_torch.models import bert as tbert
from financial_rag_system_tpu_torch.models import hf_loader as thf
from financial_rag_system_tpu_torch.models.hf_export import save_bert_checkpoint
from financial_rag_system_tpu_torch.ops import attention as tattn
from financial_rag_system_tpu_torch.ops import flash_attention as tflash
from financial_rag_system_tpu_torch.ops import fused_query as tfq
from test_torch_attention_wide import ring_attention, ring_masks
from test_torch_flash_attention import jax_flash_gate, jax_gate, make_mask  # noqa: F401
from torch_attn_masks import holes_mask, prefix_mask, rerank_mask, segment_mask

CSRC = Path(tattn.__file__).resolve().parent.parent / "csrc"


def qkv(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))


def long_mask(kind, b, s, seed):
    """Masks with padded tails: the rerank layout (query, hole, document,
    tail) or prefixes, the first pair's valid keys reaching past key 512."""
    rng = np.random.default_rng(seed)
    if kind == "rerank":
        mask = rerank_mask(b, s, seed=seed)
    else:
        mask = prefix_mask(s, rng.integers(s // 2, s + 1, b))
    mask[0, :] = 0
    mask[0, :min(s, 520 + seed % 40)] = 1
    return mask


# -- kernel 2: the function ------------------------------------------------------------


@pytest.mark.parametrize("s,d,kind", [(640, 32, "rerank"), (640, 64, "prefix"),
                                      (992, 32, "rerank"), (1024, 32, "prefix"),
                                      (1024, 64, "rerank")])
def test_pair_attention_matches_jax_kernel_above_512(s, d, kind):
    """The plain version against JAX's Pallas kernel (interpret mode) at S
    640 and 1,024, and 992 (phase 15's pairs: a query of 32 and a document
    of 960), 2 pairs of 2 heads; the kernel runs on the card above S 512
    at every width."""
    q, k, v = qkv(2, s, 2, d, seed=s + d)
    mask = long_mask(kind, 2, s, seed=s)
    inv = 1.0 / math.sqrt(d)
    ref = np.asarray(jattention.encoder_self_attention(q, k, v, mask, inv, interpret=True))
    got = tattn.encoder_self_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)),
                                       inv).numpy()
    assert got.shape == ref.shape == (2, s, 2 * d) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=0)


# -- kernel 2: the ring kernel's plan above S 512 ---------------------------------------


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("s", [513, 640, 1024])
def test_ring_plan_above_512_matches_plain_and_jax(one_torch_thread, s, d):
    """The kernels' online softmax over 128-key blocks below kend past S
    512 (kend in mid-block, a pair with no valid key, valid keys only past
    the first block): the ring kernel's at heads of 64, the long-pair
    kernel's at heads of 32 (``long_pair_attention``); against the plain
    version on every pair and JAX's kernel on the pairs with a valid key
    (JAX's pads S to 128s, so a fully masked pair's uniform softmax spans
    its pad keys)."""
    rng = np.random.default_rng(s + d)
    q, k, v = (rng.standard_normal((6, s, 2, d)).astype(np.float32) for _ in range(3))
    mask = ring_masks(s, seed=s)
    inv = 1.0 / math.sqrt(d)
    args = [torch.from_numpy(a) for a in (q, k, v, mask)]
    got = (long_pair_attention if d == 32 else ring_attention)(*args, inv).numpy()
    plain = tattn.encoder_self_attention_plain(*args, inv).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-2, rtol=0)
    ref = np.asarray(jattention.encoder_self_attention(q, k, v, mask, inv, interpret=True))
    real = mask.any(axis=1)
    np.testing.assert_allclose(got[real], ref[real], atol=1e-2, rtol=0)


def parent_stage_heads(mask: np.ndarray):
    """The parent's ring producer, lane by lane: bit u of a lane's
    register is key lane + 32u for u < 16 (S <= 512 only), kend from the
    highest bit, and each block's bias row and all-valid flag from the
    bits.  Returns (kend, [(bias row, full flag)] a block) a pair."""
    out = []
    for row in mask:
        s = row.shape[0]
        valid = [sum(1 << u for u in range(16) if lane + 32 * u < s and row[lane + 32 * u] > 0)
                 for lane in range(32)]
        last = [lane + 32 * (v.bit_length() - 1) + 1 if v else 0 for lane, v in enumerate(valid)]
        kend = max(last)
        nb = -(-(kend if kend else s) // 128)
        blocks = []
        for kb in range(nb):
            bias, whole = np.zeros(128, np.float32), True
            for lane in range(32):
                for j in range(4):
                    u = kb * 4 + j
                    key = lane + 32 * u
                    ok = bool((valid[lane] >> u) & 1)
                    bias[lane + 32 * j] = (0.0 if ok else tattn.NEG) if key < s else -np.inf
                    whole = whole and ok
            blocks.append((bias, whole))
        out.append((kend, blocks))
    return out


def stage_heads(mask: np.ndarray):
    """This ring producer, lane by lane: kend by a loop over the mask's
    32-key words, a block's validity read as the block is staged."""
    out = []
    for row in mask:
        s = row.shape[0]
        last = [max([key + 1 for key in range(lane, s, 32) if row[key] > 0], default=0)
                for lane in range(32)]
        kend = max(last)
        nb = -(-(kend if kend else s) // 128)
        blocks = []
        for kb in range(nb):
            bias, whole = np.zeros(128, np.float32), True
            for lane in range(32):
                for j in range(4):
                    key = kb * 128 + lane + 32 * j
                    ok = key < s and row[key] > 0
                    bias[lane + 32 * j] = (0.0 if ok else tattn.NEG) if key < s else -np.inf
                    whole = whole and ok
            blocks.append((bias, whole))
        out.append((kend, blocks))
    return out


def same_heads(a, b) -> bool:
    return all(ka == kb and len(x) == len(y) and all(
        np.array_equal(bx, by) and fx == fy for (bx, fx), (by, fy) in zip(x, y))
        for (ka, x), (kb, y) in zip(a, b))


@pytest.mark.parametrize("s", [1, 63, 65, 130, 257, 400, 512])
def test_ring_producer_gives_the_parents_stage_heads_up_to_512(s):
    """Up to S 512 the new producer stages what the parent's did: the same
    kend, blocks, bias rows and flags, so heads of 64 and 128 keep their
    contexts bit for bit (the consumers are unchanged)."""
    mask = ring_masks(s, seed=s)
    assert same_heads(stage_heads(mask), parent_stage_heads(mask))


@pytest.mark.parametrize("s", [513, 640, 1000, 2048])
def test_ring_producer_above_512(s):
    """Above S 512 the producer's heads are the definition: kend (1 + the
    last valid key), the blocks below it (all of S's with no valid key),
    0 / -1e9 / -inf past S, and full where every key is valid."""
    mask = ring_masks(s, seed=s)
    heads = stage_heads(mask)
    kends = tattn.key_ends(torch.from_numpy(mask)).tolist()
    blocks = tattn.ring_blocks(torch.from_numpy(mask)).tolist()
    sp = -(-s // 128) * 128
    for row, (kend, staged), want_kend, nb in zip(mask, heads, kends, blocks):
        assert kend == want_kend and len(staged) == nb
        bias = np.full(sp, -np.inf, np.float32)
        bias[:s] = np.where(row > 0, 0.0, tattn.NEG)
        for kb, (b, whole) in enumerate(staged):
            assert np.array_equal(b, bias[kb * 128:(kb + 1) * 128])
            assert whole == bool((bias[kb * 128:(kb + 1) * 128] == 0).all())


# -- kernel 2: dispatch -----------------------------------------------------------------


@pytest.mark.parametrize("d", [32, 64, 128])
def test_pair_attention_dispatch(d):
    """The counter each launch adds to, as the C entry dispatches: up to S
    512 heads of 32 on the persistent kernel and 64 / 128 on the ring;
    above it every width on the ring kernel, counted as ``launches_long``;
    S 0 and widths no kernel is built for are refused."""
    for s in (1, 400, 512):
        want = "launches" if d == 32 else "launches_ring"
        assert tattn.launch_counter(s, d) == want
    for s in (513, 992, 1024, 4096, 1 << 20):
        assert tattn.launch_counter(s, d) == "launches_long"
    for s, w in ((0, d), (400, d + 1), (600, 256)):
        with pytest.raises(ValueError):
            tattn.launch_counter(s, w)
    assert hasattr(tattn.encoder_self_attention, "launches_long")


def test_pair_attention_source_dispatch_and_d32_ring_plan():
    """The C entry sends heads of 32 above ``PERSISTENT_MAX_SEQ`` to the
    long-pair kernel (no longer the ring kernel's D-32 instance, which is
    gone), and takes every S from 1; ``long_pair_plan`` mirrors the
    source's constants: four consumer warpgroups of one row tile at 112
    registers (the producer's 24), eight 16 KB stages with 528-byte
    heads, 169,280 bytes, 64-key steps and tails."""
    src = (CSRC / "pair_attention.cu").read_text()
    assert int(re.search(r"constexpr int kMaxS = (\d+);", src).group(1)) == \
        tattn.PERSISTENT_MAX_SEQ
    assert ("return S <= kMaxS ? launch_persistent(q, k, v, mask, out, P, S, H, stream)\n"
            "                        : longpair::launch(q, k, v, mask, out, P, S, H, stream);"
            in src)
    assert "S > kMaxS" not in src and "launch<32>" not in src and "regs_fit<32>" not in src
    body = src[src.index("namespace longpair {"):src.index("}  // namespace longpair")]
    for line in ("constexpr int kStep = 64;", "constexpr int kWg = 4;", "constexpr int kTiles = 1;",
                 "constexpr int kProducerRegs = 24;", "constexpr int kConsumerRegs = 112;",
                 "constexpr int kMaxStages = 8;",
                 "static_assert(kStages == 8 && sizeof(StageHead) == 528 && "
                 "smem_bytes(kStages) == 169280,",
                 "const bool tail = kend > 0 && (kend - 1) % kKeys < kStep;",
                 "  mma_bf16(sum, pa, kOnes, kOnes);"):
        assert line in body, line
    assert body.count("step<kStep>(") == 2 and "step<kKeys>" not in body
    assert tattn.LONG_PAIR_STEP == 64 and tattn.RING_KEYS == 128
    plan = tattn.long_pair_plan(torch.ones((3, 992), dtype=torch.int32), 12)
    assert (plan.consumers, plan.tiles, plan.unit, plan.threads, plan.producer_regs,
            plan.consumer_regs, plan.regs_fit) == (4, 1, 4, 640, 24, 112, True)
    assert (plan.stages, plan.smem) == (8, 169280) and plan.smem <= tattn.RING_SMEM_LIMIT
    for s, d in ((512, 32), (992, 64), (400, 32)):
        with pytest.raises(ValueError):
            tattn.long_pair_plan(torch.ones((1, s), dtype=torch.int32), 1, d)
    for d in (32, 256):
        with pytest.raises(ValueError):
            tattn.ring_plan(d)


def phase15_mask(p, s=992, lq=32, lo=480, seed=0):
    """Phase 15 (a)'s pairs: query tokens (3 to ``lq``), a hole up to
    ``lq``, a document of ``lo`` to ``s - lq`` tokens."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((p, s), np.int32)
    for i in range(p):
        mask[i, :rng.integers(3, lq + 1)] = 1
        mask[i, lq:lq + rng.integers(lo, s - lq + 1)] = 1
    return mask


@pytest.mark.parametrize("s,idle", [(513, 3), (576, 3), (640, 2), (704, 1), (992, 0),
                                    (1024, 0), (2048, 0), (4096, 0), (4160, 3)])
def test_long_pair_plan_units_and_staged_bytes(s, idle):
    """Units of four row tiles: at phase 15 (a)'s S 992 an item's 16 tiles
    make four full units, so no warpgroup passes through a unit idle (the
    parent's units of three left two idle in the sixth); where T mod 4 is
    r > 0 (S 513-576: 9 tiles) the last unit's 4 - r last warpgroups have
    no tile.  K
    and V are staged once a unit, the block holding kend as 64 keys where
    kend mod 128 is in (0, 64]: never more bytes than the parent's units
    of three staged (``staged_kv_bytes``), at most 2/3 of them where four
    units stand against six (16 tiles: S 961-1,024), and below 2/3 at
    phase 15 (a)'s mask."""
    mask = torch.from_numpy(phase15_mask(48, s, lo=min(480, s // 2), seed=s))
    plan = tattn.long_pair_plan(mask, 12)
    t = -(-s // 64)
    assert plan.units == 48 * 12 * -(-t // 4) and plan.idle == 48 * 12 * idle
    keys = tattn.staged_keys(mask)
    full = tattn.ring_blocks(mask) * 128
    kend = tattn.key_ends(mask)
    assert torch.equal(full - keys, torch.where((kend - 1) % 128 < 64, 64, 0))
    assert plan.kv_bytes == int(keys.sum()) * 12 * -(-t // 4) * 128
    assert plan.q_bytes == 48 * 12 * s * 64
    parent = tattn.staged_kv_bytes(mask, 12, 3, False)
    assert parent == int(full.sum()) * 12 * -(-t // 3) * 128
    assert plan.kv_bytes <= parent
    if -(-t // 4) * 3 <= -(-t // 3) * 2:   # 16 tiles (S 961-1,024): four units against six
        assert plan.kv_bytes * 3 <= parent * 2
    if s == 992:
        assert plan.kv_bytes * 3 < parent * 2
        assert plan.idle == 0 and -(-t // 3) * 3 - t == 2
    full_mask = torch.ones((2, s), dtype=torch.int32)
    assert tattn.long_pair_plan(full_mask, 1).kv_bytes == 2 * -(-t // 4) * -(-s // 128) * 128 * 128 \
        - (2 * -(-t // 4) * 64 * 128 if (s - 1) % 128 < 64 else 0)


def test_long_pair_staged_bytes_at_phase_15_shape():
    """At phase 15 (a)'s shape (480 pairs, S 992, 12 heads, documents of
    480-960 tokens) K and V stage about 2.4 GB against the parent's 3.6."""
    mask = torch.from_numpy(phase15_mask(480))
    plan = tattn.long_pair_plan(mask, 12)
    parent = tattn.staged_kv_bytes(mask, 12, 3, False)
    assert plan.idle == 0 and plan.units == 480 * 12 * 4
    assert 2.2e9 < plan.kv_bytes < 2.5e9 and 3.3e9 < parent < 3.8e9
    assert plan.kv_bytes / parent < 2 / 3


# -- kernel 2: the long-pair kernel's arithmetic (heads of 32 above S 512) ---------------


@pytest.fixture()
def one_torch_thread():
    """Steps this small gain nothing from intra-op threads, and the
    suite's parallel workers share the cores: one torch thread here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
KEYS = tattn.RING_KEYS
TAIL = tattn.LONG_PAIR_STEP


def pair_blocks(row: np.ndarray, tail: bool = True):
    """The long-pair producer for one pair, lane by lane: kend by a loop
    over the mask's 32-key words; a (first key, keys computed, 128-key
    bias row, full flag) a block below kend (below S with no valid key),
    the block holding kend cut to 64 keys where ``tail`` and kend mod 128
    is in (0, 64], its full flag over those keys."""
    s = row.shape[0]
    kend = max(max([key + 1 for key in range(lane, s, 32) if row[key] > 0], default=0)
               for lane in range(32))
    nb = -(-(kend if kend else s) // KEYS)
    cut = tail and kend > 0 and (kend - 1) % KEYS < TAIL
    blocks = []
    for kb in range(nb):
        keys = TAIL if cut and kb == nb - 1 else KEYS
        bias, whole = np.zeros(KEYS, np.float32), True
        for lane in range(32):
            for j in range(4):
                key = kb * KEYS + lane + 32 * j
                ok = key < s and row[key] > 0
                bias[lane + 32 * j] = (0.0 if ok else tattn.NEG) if key < s else -np.inf
                if 32 * j < keys:
                    whole = whole and ok
        blocks.append((kb * KEYS, keys, bias, whole))
    return kend, blocks


def fma32(a, b, c):
    """f32 fma: a b + c rounded once (a b of two f32 is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def long_pair_attention(q, k, v, mask, inv_sqrt, tail=True):
    """The long-pair kernel's arithmetic over (P, S, H, 32) f32 q, k, v and
    a (P, S) mask, in f32 with bf16 rounding where the kernel rounds: each
    block of ``pair_blocks`` in online-softmax steps of 64 keys (a tail is
    one step), per step the biased scores (a block not wholly valid), the
    running max m, alpha = exp2((m_old - m) log2 e), the probs as
    exp2(fma(s, log2 e, -m log2 e)) on a wholly valid block and exp2((s +
    bias - m) log2 e) on any other; the row's sum as fma(l, alpha, the
    step's sum of the bf16-rounded probs) (the tensor cores' sum against a
    column of ones: exact products, summed in f64, rounded to f32); the
    context rescaled by alpha plus P.V of the same probs (likewise); at
    the end the context times 1 / sum, rounded to bf16.  The (P, S, H *
    32) output as the wrapper returns it (f32).  All pairs step together;
    a pair past its last step keeps its state."""
    qs, kb, vb = (t.float() for t in tattn._scaled_inputs(q, k, v, inv_sqrt))
    p, s, h, d = qs.shape
    sp = -(-s // KEYS) * KEYS
    kp, vp = torch.zeros((p, sp, h, d)), torch.zeros((p, sp, h, d))
    kp[:, :s], vp[:, :s] = kb, vb
    blocks = [pair_blocks(np.asarray(mask[i]), tail)[1] for i in range(p)]
    steps = [sum(n for _, n, _, _ in b) // TAIL for b in blocks]  # from key 0, contiguous
    qh = qs.permute(0, 2, 1, 3)  # (P, H, S, d)
    m = torch.full((p, h, s), float("-inf"))
    total = torch.zeros((p, h, s))
    ctx = torch.zeros((p, h, s, d))
    for j in range(max(steps)):
        on = torch.tensor([j < n for n in steps])[:, None, None]
        whole = torch.tensor([j < n and b[j // 2][3] for b, n in zip(blocks, steps)])
        bias = torch.from_numpy(np.stack([
            b[j // 2][2][(j % 2) * TAIL:(j % 2 + 1) * TAIL] if j < n else np.zeros(TAIL, np.float32)
            for b, n in zip(blocks, steps)]))
        cols = slice(j * TAIL, (j + 1) * TAIL)
        sc = qh @ kp[:, cols].permute(0, 2, 3, 1)  # (P, H, S, 64)
        sc = torch.where(whole[:, None, None, None], sc, sc + bias[:, None, None, :])
        mn = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp2((m - mn) * LOG2E)
        pr = torch.where(whole[:, None, None, None],
                         torch.exp2(fma32(sc, LOG2E, (-mn * LOG2E)[..., None])),
                         torch.exp2((sc - mn[..., None]) * LOG2E))
        pb = pr.to(torch.bfloat16).double()
        total = torch.where(on, fma32(total, alpha, pb.sum(dim=-1).float()), total)
        pv = (pb @ vp[:, cols].permute(0, 2, 1, 3).double()).float()
        ctx = torch.where(on[..., None], ctx * alpha[..., None] + pv, ctx)
        m = torch.where(on, mn, m)
    out = (ctx * (1.0 / total)[..., None]).to(torch.bfloat16).float()
    return out.permute(0, 2, 1, 3).reshape(p, s, h * d)


def kend_mask(kind, s, seed):
    """Eight pairs: one of ``kind`` (the rerank layout, a prefix, random
    holes), one with no valid key, and kend at 128k - 1, 128k and 128k + 1
    and at 64 below each (128k the largest multiple of 128 below S - 1),
    two of them with a hole below kend (blocks not wholly valid)."""
    rng = np.random.default_rng(seed)
    b = KEYS * ((s - 2) // KEYS)
    mask = prefix_mask(s, [1, 0, b - 1, b, b + 1, b - 65, b - 64, b - 63])
    if kind == "rerank":
        mask[0] = rerank_mask(1, s, seed=seed)[0]
    elif kind == "prefix":
        mask[0] = prefix_mask(s, [rng.integers(s // 2, s + 1)])[0]
    else:
        mask[0] = holes_mask(2, s, seed=seed)[1]
    mask[2, 10:20] = 0
    mask[7, 200:330] = 0
    return mask


@pytest.mark.parametrize("kind", ["rerank", "prefix", "holes"])
@pytest.mark.parametrize("s", [513, 640, 992, 1024, 2048])
def test_long_pair_matches_plain_and_jax(one_torch_thread, s, kind):
    """The long-pair kernel's arithmetic against the plain version on
    every pair (kend at 64k +- 1 and 128k +- 1, a pair with no valid key,
    holes) and JAX's kernel (interpret mode) on the pairs with a valid key
    up to S 1,024, at atol 1e-2; a fully masked pair finite and uniform."""
    rng = np.random.default_rng(s)
    q, k, v = (rng.standard_normal((8, s, 2, 32)).astype(np.float32) for _ in range(3))
    mask = kend_mask(kind, s, seed=s)
    inv = 1.0 / math.sqrt(32)
    args = [torch.from_numpy(a) for a in (q, k, v, mask)]
    got = long_pair_attention(*args, inv).numpy()
    assert np.isfinite(got).all()
    plain = tattn.encoder_self_attention_plain(*args, inv).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-2, rtol=0)
    uniform = tattn._scaled_inputs(*args[:3], inv)[2].float().mean(dim=1)[1].reshape(-1)
    np.testing.assert_allclose(got[1], np.broadcast_to(uniform.numpy(), (s, 64)), atol=1e-2)
    if s <= 1024:
        ref = np.asarray(jattention.encoder_self_attention(q, k, v, mask, inv, interpret=True))
        real = mask.any(axis=1)
        np.testing.assert_allclose(got[real], ref[real], atol=1e-2, rtol=0)


@pytest.mark.parametrize("s", [513, 640, 992, 2048])
def test_long_pair_tail_is_exact(one_torch_thread, s):
    """The keys a tail leaves out (the 64 past the block's first, all at
    or past kend) would add exactly 0: the 128-key block's max equals the
    tail's, and their probs at it are exactly 0.0; and the emulation with
    the tail gives the context without it bit for bit, but for a tail
    whose 64 keys are all valid (it takes the unbiased form, the whole
    block the biased one: another rounding)."""
    rng = np.random.default_rng(s)
    q, k = (torch.from_numpy(rng.standard_normal((8, s, 2, 32)).astype(np.float32))
            for _ in range(2))
    mask = kend_mask("holes", s, seed=s)
    qs, kb, _ = (t.float() for t in tattn._scaled_inputs(q, k, k, 1.0 / math.sqrt(32)))
    cut, same = 0, []
    for i in range(8):
        kend, blocks = pair_blocks(mask[i])
        _, whole = pair_blocks(mask[i], tail=False)
        assert [b[0] for b in blocks] == [b[0] for b in whole]
        k0, keys, bias, whole_tail = blocks[-1]
        if not whole_tail:
            same.append(i)
        if keys == KEYS:
            continue
        cut += 1
        assert kend - k0 <= TAIL and not (mask[i, k0 + TAIL:k0 + KEYS] > 0).any()
        kp = torch.zeros((KEYS, 2, 32))
        n = min(KEYS, s - k0)
        kp[:n] = kb[i, k0:k0 + n]
        sc = qs[i].permute(1, 0, 2) @ kp.permute(1, 2, 0) + torch.from_numpy(bias)
        m = sc[..., :TAIL].amax(dim=-1)
        assert torch.equal(sc.amax(dim=-1), m)
        assert (torch.exp2((sc[..., TAIL:] - m[..., None]) * LOG2E) == 0).all()
    assert cut >= 3
    v = torch.from_numpy(rng.standard_normal((8, s, 2, 32)).astype(np.float32))
    args = (q, k, v, torch.from_numpy(mask), 1.0 / math.sqrt(32))
    got, ref = long_pair_attention(*args), long_pair_attention(*args, tail=False)
    assert len(same) >= 6 and torch.equal(got[same], ref[same])
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-2, rtol=0)


@pytest.mark.parametrize("s", [513, 640, 1000, 2048])
def test_long_pair_producer_above_512(one_torch_thread, s):
    """The long-pair producer's heads: kend, the blocks below it (all of
    S's with no valid key), 0 / -1e9 / -inf past S, full where every key
    it computes is valid, and the tail exactly where kend mod 128 is in
    (0, 64]."""
    mask = np.concatenate([ring_masks(s, seed=s), kend_mask("rerank", s, seed=s)])
    kends = tattn.key_ends(torch.from_numpy(mask)).tolist()
    nbs = tattn.ring_blocks(torch.from_numpy(mask)).tolist()
    keys = tattn.staged_keys(torch.from_numpy(mask)).tolist()
    sp = -(-s // KEYS) * KEYS
    for row, want_kend, nb, n_keys in zip(mask, kends, nbs, keys):
        kend, blocks = pair_blocks(row)
        assert kend == want_kend and len(blocks) == nb
        assert sum(b[1] for b in blocks) == n_keys
        bias = np.full(sp, -np.inf, np.float32)
        bias[:s] = np.where(row > 0, 0.0, tattn.NEG)
        for kb, (k0, n, b, whole) in enumerate(blocks):
            assert k0 == kb * KEYS
            assert np.array_equal(b, bias[k0:k0 + KEYS])
            assert whole == bool((bias[k0:k0 + n] == 0).all())
            assert n == (TAIL if kb == nb - 1 and kend > 0 and (kend - 1) % KEYS < TAIL
                         else KEYS)


def test_pair_attention_kernel_refuses_cpu_tensors_at_long_s():
    """The kernel wrapper takes CUDA tensors only, at any S: a CPU tensor
    is refused, not computed (the entry point runs the plain version)."""
    x = torch.zeros((1, 1024, 2, 32), dtype=torch.bfloat16)
    m = torch.ones((1, 1024), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.pair_attention_kernel(x, x, x, m)
    before = tattn.encoder_self_attention.launches_long
    out = tattn.encoder_self_attention(x.float(), x.float(), x.float(), m, 0.1)
    assert out.shape == (1, 1024, 64) and tattn.encoder_self_attention.launches_long == before


# -- kernel 7: the function --------------------------------------------------------------


def flash_both(q, k, v, mask):
    inv = 1.0 / math.sqrt(q.shape[-1])
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jbert._flash_attention(q, k, v, mask, inv))
    got = tflash.encoder_flash_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)),
                                         inv).numpy()
    return got, ref


@pytest.mark.parametrize("s,d,kind", [(640, 32, "prefix"), (640, 32, "segments"),
                                      (128, 384, "prefix"), (256, 512, "rerank"),
                                      (128, 192, "holes")])
def test_flash_plain_matches_jax_kernel_long_and_wide(s, d, kind):
    """The plain version against jax's flash kernel (interpret mode) on
    every row: S 640 (five key blocks) at heads of 32; heads of 384 at S
    128 (jax's single step) and 512 at S 256 (the slab kernel on the
    card); heads of 192 at S 128, which jax's single step takes (the card
    pads them to 256)."""
    q, k, v = qkv(2, s, 2, d, seed=s + d)
    mask = make_mask(kind, 2, s, seed=s + d)
    got, ref = flash_both(q, k, v, mask)
    assert got.shape == ref.shape == (2, s, 2 * d) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=0)


@pytest.mark.parametrize("s,d", [(256, 192), (384, 320), (256, 130)])
def test_flash_refuses_what_jax_refuses(s, d):
    """Above S 128 a head wider than 128 that is not a multiple of 128:
    jax's kernel raises, and so does the port, on the CPU as on the card."""
    q, k, v = qkv(1, s, 1, d, seed=d)
    mask = np.ones((1, s), np.int32)
    with pytest.raises(NotImplementedError, match="head_dim"):
        flash_both(q, k, v, mask)
    with pytest.raises(ValueError, match="head_dim"):
        tflash.encoder_flash_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)), 0.1)


# -- kernel 7: the skip rule's presence masks --------------------------------------------


def parent_need(seg: np.ndarray, wg: int) -> np.ndarray:
    """The parent's skip rule, lane by lane (S <= 512): lane j's 32-bit
    presence of ids in [0, 32) of positions 32j .. 32j + 31 and whether
    they hold another id; a (tile, block) pair is needed when either side
    holds another id or their presence bits meet.  (B, tiles, blocks)."""
    b, s = seg.shape
    out = np.zeros((b, s // 64, s // 128), bool)
    for i in range(b):
        words = [seg[i, 32 * j:32 * j + 32] for j in range(s // 32)]
        gp = [sum(1 << int(x) for x in set(w.tolist()) if 0 <= x < 32) for w in words]
        go = [bool(((w < 0) | (w >= 32)).any()) for w in words]
        for t0 in range(0, s // 64, wg):
            for kb in range(s // 128):
                bp = bo = 0
                for u in range(4):
                    bp |= gp[4 * kb + u]
                    bo |= go[4 * kb + u]
                for w in range(wg):
                    tt = t0 + w
                    if tt >= s // 64:
                        continue
                    tp, to = gp[2 * tt] | gp[2 * tt + 1], go[2 * tt] or go[2 * tt + 1]
                    out[i, tt, kb] = bool(to or bo or (tp & bp))
    return out


def presence(ids: np.ndarray) -> int:
    """The kernel's presence mask of a run of ids: bit i for id i in [0,
    32), every bit when any other id is among them."""
    if ((ids < 0) | (ids >= 32)).any():
        return 0xFFFFFFFF
    return sum(1 << int(x) for x in set(ids.tolist()))


def new_need(seg: np.ndarray, wg: int) -> np.ndarray:
    """This skip rule: a unit's tiles' presence masks when the unit
    starts, a block's as it is staged; needed where they meet."""
    b, s = seg.shape
    out = np.zeros((b, s // 64, s // 128), bool)
    for i in range(b):
        for t0 in range(0, s // 64, wg):
            tp = [presence(seg[i, 64 * t:64 * t + 64]) if t < s // 64 else 0
                  for t in range(t0, t0 + wg)]
            for kb in range(s // 128):
                bp = presence(seg[i, 128 * kb:128 * kb + 128])
                for w in range(wg):
                    if t0 + w < s // 64:
                        out[i, t0 + w, kb] = bool(tp[w] & bp)
    return out


def rule_need(seg: np.ndarray) -> np.ndarray:
    """The rule by definition: a tile and a block share an id, or either
    holds an id outside [0, 32)."""
    b, s = seg.shape
    tiles = seg.reshape(b, s // 64, 1, 64, 1)
    blocks = seg.reshape(b, 1, s // 128, 1, 128)
    other = (seg < 0) | (seg >= 32)
    t_other = other.reshape(b, s // 64, 64).any(-1)[:, :, None]
    b_other = other.reshape(b, s // 128, 128).any(-1)[:, None, :]
    return (tiles == blocks).any(axis=(3, 4)) | t_other | b_other


@pytest.mark.parametrize("wg", [3, 2])
@pytest.mark.parametrize("s,kind", [(128, "segments"), (256, "prefix"), (384, "wide_ids"),
                                    (512, "rerank"), (512, "segments"), (512, "short"),
                                    (512, "wide_ids"), (384, "holes")])
def test_presence_masks_keep_the_parents_skips_up_to_512(s, kind, wg):
    """Per tile and per block presence masks (each other id folded into
    every bit) need exactly the (tile, block) pairs the parent's words
    needed, with units of 3 tiles (D 32) and 2 (D 64-256): contexts at S
    <= 512 unchanged bit for bit."""
    seg = make_mask(kind, 4, s, seed=s)
    assert np.array_equal(new_need(seg, wg), parent_need(seg, wg))


@pytest.mark.parametrize("s", [640, 1024, 1152, 2048])
def test_presence_masks_above_1024_positions(s):
    """Past 1,024 positions one word a lane no longer holds a pair's ids;
    the masks made per tile and per block keep the rule at any S, and
    still skip: on runs of ids in [0, 32) some pairs go unneeded."""
    for kind in ("segments", "wide_ids", "prefix"):
        seg = make_mask(kind, 3, s, seed=s)
        need = new_need(seg, 2)
        assert np.array_equal(need, rule_need(seg))
    seg = segment_mask(3, s, (0, 1, 2, 5, 17, 31), seed=s)
    assert not new_need(seg, 3).all()


# -- kernel 7: the slab kernel (heads of 384 and wider) and the long-row kernel ------------


def kernel_flash(q, k, v, seg, inv_sqrt, chunk=64):
    """The order of kernel 7's slab kernel (heads of 384 and wider) and of
    its long-row kernel (heads of 32 above S 512) over (B, S, H, d) f32 q,
    k, v: for each (64-row tile, 128-key block) one QK^T over the whole
    head (summed a 128-column piece at a time, in f32) and one softmax;
    the zero-weight select and the (tile, block) skips; the block's row
    maxima over both 64-key halves (the slab kernel's two warpgroups
    exchange them); p = 2^((s - m) sm_scale log2 e) rounded to bf16 (S 128:
    p / sum(p), jax's single step); the context accumulated unnormalised,
    acc = acc alpha + bf16(p) . V, one 64-column chunk at a time (the slab
    kernel's warpgroups each hold their chunks of it), l = l alpha +
    sum(p), divided by l once at the end.  Returns the (B, S, H * d) bf16
    context as f32, and m (scaled) and l, (B, H, S) each."""
    b, s, h, d = q.shape
    qb, kb, vb = (torch.from_numpy(t).to(torch.bfloat16).float().permute(0, 2, 1, 3)
                  for t in (q, k, v))
    segt = torch.from_numpy(seg)
    same = segt[:, None, :, None] == segt[:, None, None, :]
    need = torch.from_numpy(rule_need(seg)).repeat_interleave(64, dim=1)  # (B, S, blocks)
    ninf = float("-inf")
    c2 = inv_sqrt * math.log2(math.e)
    blk = tflash.BLOCK

    def scores(lo):
        sc = torch.zeros((b, h, s, blk))
        for pc in range(0, d, tflash.SLAB):  # QK^T, a piece of the head a time
            sc = sc + torch.matmul(qb[..., pc:pc + tflash.SLAB],
                                   kb[:, :, lo:lo + blk, pc:pc + tflash.SLAB].transpose(-1, -2))
        return torch.where(same[..., lo:lo + blk], sc, ninf)

    def pv(p, lo):  # P.V a 64-column chunk at a time
        return torch.cat([torch.matmul(p, vb[:, :, lo:lo + blk, c:c + chunk])
                          for c in range(0, d, chunk)], dim=-1)

    m = torch.full((b, h, s, 1), ninf)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, d))
    for i, lo in enumerate(range(0, s, blk)):
        sc = scores(lo)
        m_next = torch.maximum(m, torch.maximum(sc[..., :blk // 2].amax(-1, keepdim=True),
                                                sc[..., blk // 2:].amax(-1, keepdim=True)))
        empty = m_next == ninf
        p = torch.exp2((sc - torch.where(empty, 0.0, m_next)) * c2)
        if s == blk:  # jax's single step
            l_next = p.sum(-1, keepdim=True)
            new_acc = pv((p / l_next).to(torch.bfloat16).float(), lo)
        else:
            alpha = torch.where(empty, 1.0, torch.exp2((m - m_next) * c2))
            l_next = l * alpha + p.sum(-1, keepdim=True)
            new_acc = acc * alpha + pv(p.to(torch.bfloat16).float(), lo)
        keep = need[:, None, :, i:i + 1]
        m, l = torch.where(keep, m_next, m), torch.where(keep, l_next, l)
        acc = torch.where(keep, new_acc, acc)
    if s > blk:
        acc = acc / torch.where(l == 0.0, 1.0, l)
    out = acc.to(torch.bfloat16).permute(0, 2, 1, 3).reshape(b, s, h * d).float()
    return out, (m * inv_sqrt)[..., 0], l[..., 0]


def hold_to_plain_and_jax(q, k, v, seg, jax_too: bool):
    """:func:`kernel_flash` against the plain version on every row (and its
    m and l against jax's residuals as the plain version keeps them), and
    against jax's kernel in interpret mode when ``jax_too``."""
    inv = 1.0 / math.sqrt(q.shape[-1])
    got, m, l = kernel_flash(q, k, v, seg, inv)
    args = tuple(torch.from_numpy(a) for a in (q, k, v, seg))
    plain = tflash.flash_attention_plain(*args, inv)
    _, m_ref, l_ref = tflash.flash_attention_fwd_plain(*args, inv)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-2, rtol=0)
    np.testing.assert_allclose(m.numpy(), m_ref.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(l.numpy(), l_ref.numpy(), rtol=1e-3)
    if jax_too:
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(jbert._flash_attention(q, k, v, seg, inv))
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-2, rtol=0)


@pytest.mark.parametrize("s,d,kind", [(128, 384, "prefix"), (256, 384, "rerank"),
                                      (1024, 384, "segments"), (512, 512, "holes"),
                                      (2048, 512, "rerank"), (256, 640, "wide_ids"),
                                      (768, 640, "prefix")])
def test_slab_order_matches_plain_and_jax(s, d, kind):
    """The slab kernel's order (one QK^T and one softmax a (tile, block),
    split by keys between two warpgroups and by 64-column chunks for P.V,
    the context unnormalised) against the plain version on every row, and
    against jax's kernel (interpret mode) at heads of 384 and 512 up to S
    512."""
    q, k, v = qkv(2, s, 2, d, seed=s + d + 1)
    seg = make_mask(kind, 2, s, seed=s + d + 1)
    hold_to_plain_and_jax(q, k, v, seg, jax_too=d <= 512 and s <= 512)


@pytest.mark.parametrize("s,d,kind", [(640, 32, "prefix"), (1024, 32, "rerank"),
                                      (1152, 24, "segments"), (2048, 32, "holes"),
                                      (768, 32, "wide_ids")])
def test_long_row_order_matches_plain_and_jax(s, d, kind):
    """The long-row kernel's order (heads of 32 above S 512, the 24-wide
    head padded to 32 with zero columns as the wrapper pads it; 128-key
    online-softmax blocks, the context unnormalised) against the plain
    version on every row, and against jax's kernel (interpret mode) up to
    S 768."""
    q, k, v = qkv(2, s, 2, d, seed=s + d + 2)
    seg = make_mask(kind, 2, s, seed=s + d + 2)
    if d < 32:  # the wrapper's zero padding: the context's extra columns are sliced off
        pad = ((0, 0), (0, 0), (0, 0), (0, 32 - d))
        got, _, _ = kernel_flash(*(np.pad(a, pad) for a in (q, k, v)), seg, 1.0 / math.sqrt(d))
        got = got.reshape(2, s, 2, 32)[..., :d].reshape(2, s, 2 * d)
        plain = tflash.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v, seg)),
                                             1.0 / math.sqrt(d))
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-2, rtol=0)
        return
    hold_to_plain_and_jax(q, k, v, seg, jax_too=s <= 768)


def parent_slab_bytes(b, s, h, d):
    """The parent's slab kernel reckoned as the issue reckons it: units of
    (item, 128-column slab, two row tiles), each 128-key block staged as
    2 d / 128 + 1 slots of 32 KB (K's pieces, both tiles' q pieces, V's
    slab)."""
    units = b * h * (d // 128) * (s // 128)
    return units * (s // 128) * (2 * d // 128 + 1) * 32768


def test_slab_plan_mirrors_the_source():
    """Two consumer warpgroups at 224 registers (the producer's 56) in the
    pool of 384 threads; clusters of two row tiles; q resident up to heads
    of 1,024 and a ring of four, four, three and two 32 KB slots at 384,
    512, 640 and 1,024 (six beside q's pieces at 1,152), as the source's
    static_assert pins them; column groups of at most four slabs, so one
    QK^T pass at 384 and 512; at phase 15 (c)'s shape a third or less of
    the parent's L2 -> shared bytes."""
    src = (CSRC / "flash_attention.cu").read_text()
    body = src[src.index("namespace slab {"):src.index("}  // namespace slab")]
    for line in ("constexpr int kCluster = 2;", "constexpr int kWg = 2;",
                 "constexpr int kProducerRegs = 56;", "constexpr int kConsumerRegs = 224;",
                 "constexpr int kMaxGroup = 4;", "constexpr int kMaxSlots = 8;",
                 "const int np = D / 128, ng = (np + kMaxGroup - 1) / kMaxGroup;",
                 "const int base = np / ng, extra = np % ng;",
                 "mbar_init(&empty[s], 4 * kWg * kCluster);",
                 "constexpr int kShare = kKeys / kCluster;"):
        assert line in body, line
    plan = tflash.slab_plan(480, 1024, 2, 384)
    assert (plan.consumers, plan.cluster, plan.threads, plan.producer_regs,
            plan.consumer_regs) == (2, 2, 384, 56, 224)
    assert plan.regs_fit and plan.q_resident and plan.slot_bytes == 32768
    rings = {d: tflash.slab_plan(2, 256, 1, d) for d in (384, 512, 640, 1024, 1152)}
    assert [(r.q_resident, r.slots) for r in rings.values()] == \
        [(True, 4), (True, 4), (True, 3), (True, 2), (False, 6)]
    assert ("static_assert(ring_slots(384) == 4 && ring_slots(512) == 4 && ring_slots(640) == 3 &&\n"
            "                  q_resident(1024) && ring_slots(1024) == 2 && !q_resident(1152) &&\n"
            "                  ring_slots(1152) == 6,") in body
    for r in rings.values():
        assert r.smem <= tflash.SMEM_LIMIT < r.smem + r.slot_bytes + 16
    assert plan.smem == 1024 + 64 * 384 * 2 + 16384 + 4 * 32768 + 2 * 528 + 1024 + 9 * 8
    # one QK^T and one softmax a (tile, block) up to heads of 512; wider heads
    # in column groups of two to four slabs, one pass each
    assert {d: tflash.slab_groups(d) for d in (384, 512, 640, 768, 896, 1024, 1152, 1280)} == {
        384: (3,), 512: (4,), 640: (3, 2), 768: (3, 3), 896: (4, 3), 1024: (4, 4),
        1152: (3, 3, 3), 1280: (4, 3, 3)}
    for d in range(384, 8193, 128):
        groups = tflash.slab_groups(d)
        assert sum(groups) == d // 128 and set(groups) <= {2, 3, 4}
        assert max(groups) - min(groups) <= 1
    assert (plan.qk_passes, tflash.slab_plan(2, 512, 2, 512).qk_passes) == (1, 1)
    assert rings[640].launches == ((3, 1), (2, 1)) and rings[640].qk_passes == 2
    assert plan.slots_a_block == (6,) and plan.acc_floats == 96
    assert tflash.slab_plan(2, 512, 2, 512).acc_floats == 128
    # the staged bytes at phase 15 (c)'s shape: every K and V slot once for
    # two tiles, q once a tile
    assert plan.units == 480 * 2 * 1024 // 128
    assert plan.staged_bytes == plan.units * (8 * 6 * 32768 + 2 * 64 * 384 * 2)
    assert parent_slab_bytes(480, 1024, 2, 384) == 42_278_584_320
    assert plan.staged_bytes * 3 <= parent_slab_bytes(480, 1024, 2, 384)
    single = tflash.slab_plan(2, 128, 2, 384)
    assert single.units == 2 * 2 and single.qk_passes == 1
    for d in (256, 320, 100):
        with pytest.raises(ValueError):
            tflash.slab_plan(1, 256, 1, d)


def test_long_plan_mirrors_the_source():
    """Two consumer warpgroups of two row tiles (a unit of four), 240
    registers (the producer's 24); eight 16 KB stages and two q buffers of
    two 4 KB tiles a warpgroup, 169,248 bytes as the source pins them; at
    phase 15 (b)'s shape (S 1,024: 16 row tiles, four units an item) K and
    V staged four times an item against the parent's six (units of
    three)."""
    src = (CSRC / "flash_attention.cu").read_text()
    body = src[src.index("namespace longrow {"):src.index("}  // namespace longrow")]
    for line in ("constexpr int D = 32;", "constexpr int kWg = 2;", "constexpr int kTiles = 2;",
                 "constexpr int kProducerRegs = 24;", "constexpr int kConsumerRegs = 240;",
                 "static_assert(kStages == 8 && smem_bytes(kStages) == 169248,"):
        assert line in body, line
    plan = tflash.long_plan(480, 1024, 12)
    assert (plan.consumers, plan.tiles, plan.unit, plan.threads, plan.producer_regs,
            plan.consumer_regs, plan.regs_fit) == (2, 2, 4, 384, 24, 240, True)
    assert (plan.stages, plan.smem) == (8, 169248)
    assert plan.units == 480 * 12 * 4
    parent = 480 * 12 * 6 * 8 * 2 * 128 * 32 * 2 + 480 * 12 * 1024 * 32 * 2
    assert plan.staged_bytes == 480 * 12 * 4 * 8 * 16384 + 480 * 12 * 1024 * 64
    assert plan.staged_bytes < 0.7 * parent
    assert tflash.long_plan(1, 640, 1).units == 3  # ten tiles: units of 4, 4, 2
    for s, d in ((512, 32), (1024, 64), (128, 32)):
        with pytest.raises(ValueError):
            tflash.long_plan(1, s, 1, d)
    assert "return S > 512 ? longrow::launch(" in src


def test_flash_dispatch_and_refusals():
    """Each kernel width's counter; the C entry takes every multiple of 128
    above 256 and S without a cap."""
    assert tflash.launch_counter(32) == tflash.launch_counter(128) == "launches"
    assert tflash.launch_counter(32, 512) == tflash.launch_counter(64, 1024) == "launches"
    assert tflash.launch_counter(32, 640) == tflash.launch_counter(32, 4096) == "launches_long"
    assert tflash.launch_counter(256) == tflash.launch_counter(256, 1024) == "launches_wide"
    for d in (384, 512, 1024, 4096):
        assert tflash.launch_counter(d) == "launches_slab"
    for d in (24, 192, 320):
        with pytest.raises(ValueError):
            tflash.launch_counter(d)
    src = (CSRC / "flash_attention.cu").read_text()
    assert "if (head_dim > 256 && head_dim % 128 == 0)" in src
    assert not re.search(r"\bkMaxS\b", src)
    for s in (640, 1024, 4096):
        tflash.check_shape(s, 32)
        tflash.check_shape(s, 768)


# -- the pair layout above 512 --------------------------------------------------------------


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("p,lq,dlen,max_seq,plen", [
    (15, 32, 960, 1024, 992), (9, 32, 960, None, 992), (9, 32, 960, 512, 512),
    (8, 64, 1000, 2048, 1064), (13, 16, 600, 1024, 616),
])
def test_assemble_pairs_identical_above_512(monkeypatch, p, lq, dlen, max_seq, plen, flash):
    """Pairs longer than 512 tokens: the trained-length trim and, under the
    flash gate, the padding to a multiple of 128 (992 -> 1024, 1064 ->
    1152), identical to JAX's arrays."""
    if flash:
        monkeypatch.setenv("RAG_TPU_FLASH", "1")
        monkeypatch.setattr(jbert, "_flash_enabled", jax_gate)
        plen = -(-plen // 128) * 128
    else:
        monkeypatch.delenv("RAG_TPU_FLASH", raising=False)
    rng = np.random.default_rng(p + dlen)
    pair_q = rng.integers(0, 50, (p, lq)).astype(np.int32)
    pair_d = rng.integers(0, 50, (p, dlen)).astype(np.int32)
    shape = dict(vocab_size=1000, hidden=64, layers=2, heads=2, intermediate=128,
                 max_positions=2048, max_seq_length=max_seq)
    ref = jfq._assemble_pairs(jax.numpy.asarray(pair_q), jax.numpy.asarray(pair_d),
                              rerank_cfg=jbert.BertConfig(**shape))
    got = tfq._assemble_pairs(torch.from_numpy(pair_q), torch.from_numpy(pair_d),
                              rerank_cfg=tbert.BertConfig(**shape))
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32 and g.shape == (-(-p // 8) * 8, plen)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# -- the encoder: a 1,024-position checkpoint ---------------------------------------------

LONG = dict(vocab_size=1000, hidden=64, layers=2, heads=2, intermediate=128,
            max_positions=1024, with_pooler=True, num_labels=1)


@pytest.fixture(scope="module")
def long_checkpoint(tmp_path_factory):
    """A 2-layer cross-encoder of 1,024 positions from the port's
    ``init_params`` (seed 5), written by the port's ``hf_export`` with its
    trained length, 1,024."""
    cfg = tbert.BertConfig(**LONG)
    model = tbert.load_jax_params(tbert.BertModel(cfg, device="cpu"),
                                  tbert.init_params(torch.Generator().manual_seed(5), cfg))
    path = tmp_path_factory.mktemp("long_reranker")
    save_bert_checkpoint(model, cfg, str(path), cross_encoder=True, max_seq_length=1024)
    return str(path)


def long_inputs(seq=640, seed=5):
    rng = np.random.default_rng(seed)
    mask = rerank_mask(3, seq, seed=seed)
    mask[0, :] = 0
    mask[0, :3] = 1
    mask[0, 32:600] = 1          # a document past key 512
    ids = rng.integers(1, 1000, (3, seq)).astype(np.int32) * mask
    types = np.zeros_like(ids)
    types[:, 32:] = 1
    return ids, types, mask


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


def load_both(path):
    params, jcfg = jhf.load_bert_checkpoint(path, with_pooler=True, num_labels=1)
    model, tcfg = thf.load_bert_checkpoint(path, num_labels=1, device="cpu")
    assert jcfg.max_positions == tcfg.max_positions == 1024
    assert jhf.saved_max_seq_length(path) == thf.saved_max_seq_length(path) == 1024
    return params, jcfg, model


def test_encode_1024_position_checkpoint_matches_jax(monkeypatch, long_checkpoint,
                                                      jax_pair_attn):
    """Both packages' ``encode`` and ``cross_score`` on the checkpoint at S
    640 under the default gate (kernel 2's arithmetic on both sides: the
    port's plain version, JAX's Pallas kernel in interpret mode), within
    5e-3."""
    monkeypatch.delenv("RAG_TPU_PAIR_ATTN", raising=False)
    monkeypatch.delenv("RAG_TPU_FLASH", raising=False)
    params, jcfg, model = load_both(long_checkpoint)
    ids, types, mask = long_inputs()
    calls = []
    pair = tbert.encoder_self_attention
    monkeypatch.setattr(tbert, "encoder_self_attention",
                        lambda *a, **k: calls.append(a[0].shape) or pair(*a, **k))
    want = np.asarray(jbert.encode(params, ids, types, mask, jcfg))
    got = model.encode(*(torch.from_numpy(a) for a in (ids, types, mask))).numpy()
    assert [c[1] for c in calls] == [640, 640]
    real = mask > 0
    np.testing.assert_allclose(got[real], want[real], atol=5e-3, rtol=0)
    ref = np.asarray(jbert.cross_score(params, ids, types, mask, jcfg))
    score = tbert.cross_score(model, *(torch.from_numpy(a) for a in (ids, types, mask)))
    np.testing.assert_allclose(score.numpy(), ref, atol=5e-3, rtol=0)


def test_encode_1024_position_checkpoint_under_flash(long_checkpoint, jax_flash_gate):  # noqa: F811
    """The same checkpoint at S 640 on the flash path (``RAG_TPU_FLASH=1
    RAG_TPU_PAIR_ATTN=0``): every position, pad rows included, against
    JAX's flash branch (jax's kernel in interpret mode), within 5e-3."""
    params, jcfg, model = load_both(long_checkpoint)
    ids, types, mask = long_inputs(seed=6)
    want = np.asarray(jbert.encode(params, ids, types, mask, jcfg))
    got = model.encode(*(torch.from_numpy(a) for a in (ids, types, mask))).numpy()
    assert jax_flash_gate == {"jax": 1, "port": 2}
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)
