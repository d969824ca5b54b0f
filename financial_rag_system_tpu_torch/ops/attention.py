"""Encoder self-attention for BERT encoders (pair attention).

Port of ``financial_rag_system_tpu/ops/attention.py``.  The cross-encoder
rerank over (query, 1000-character chunk) pairs of about 400 tokens is
attention-traffic bound when the (pairs, heads, S, S) scores go through
device memory; the kernel keeps them on chip.

- :func:`encoder_self_attention` is the entry point, with the JAX
  signature and layout: (B, S, H, D) q/k/v and a (B, S) key mask in,
  (B, S, H*D) f32 context out.  On a CUDA tensor it launches the
  hand-written Hopper kernel ``csrc/pair_attention.cu``, or raises; on a
  CPU tensor it runs :func:`encoder_self_attention_plain`.  Heads of 32
  take the persistent kernel (an item's K and V staged whole by TMA,
  ``wgmma`` products, exp as ``ex2.approx``, two sweeps, no work past a
  pair's last valid key); heads of 64 and 128 (BERT-base and -large: 64)
  take the ring kernel of the same file, which streams 128-key blocks of
  K and V by TMA through a ring with one online-softmax sweep
  (:func:`ring_plan`).  Above S 512 (:data:`PERSISTENT_MAX_SEQ`) the
  persistent kernel's whole item no longer fits a stage: heads of 32 take
  the long-pair kernel (:func:`long_pair_plan`: the ring's streaming,
  four consumer warpgroups a unit of four row tiles, 64-key online-softmax
  steps, each row's sum on the tensor cores, the block holding a pair's
  last valid key cut to 64 keys where that suffices), heads of 64 and 128
  keep the ring kernel, which has no bound on S (:func:`launch_counter`
  names the counter a shape adds to).
  Any other head width up to 128 (JAX's gate sends
  every d <= 128 to its kernel) is padded with zero columns to the next
  of :data:`HEAD_DIMS` (:func:`padded_width`) after q is scaled by the
  true 1/sqrt(d), and the context is sliced back to d: zero columns add
  nothing to QK^T, and the padded V columns are dropped, so the padding
  is exact.
- :func:`encoder_self_attention_plain` is the same arithmetic in plain
  PyTorch: q pre-scaled in f32 then rounded to bf16, bf16 x bf16 logits
  summed in f32 plus a -1e9 key-padding bias, a full-row f32 softmax,
  probs rounded to bf16 for P.V with f32 sums, the 1/sum divide after
  P.V, and a bf16 context.

Both take any S from 1, as JAX's kernel does (it pads S to a multiple of
128 with no cap).  The kernels' bound is 32-bit indexing: P * H below
2^31 and S a 32-bit TMA coordinate; the plain version's is memory, its
(B, H, S, S) f32 logits and probabilities.

The port's encoder calls this where the JAX gate engages the Pallas
kernel (``models/bert.py _pair_attn_enabled``): by default at S >= 256,
which on the main paths is the rerank's S of about 400.  The query
embed (S <= 64) takes the JAX einsum path's arithmetic in plain PyTorch
(``models/bert.py _einsum_attention``), as the JAX package computes it
there with XLA; ``RAG_TPU_PAIR_ATTN=1`` sends every length here.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from financial_rag_system_tpu_torch.ops import _cuda

# head widths the kernels take: 32 (the persistent kernel), 64 and 128
# (the ring kernel); encoder_self_attention pads any other width up to
# MAX_HEAD_DIM to the next of them
HEAD_DIMS = (32, 64, 128)
MAX_HEAD_DIM = HEAD_DIMS[-1]
# the persistent kernel's longest S (an item's K, V and bias a stage);
# above it heads of 32 run the long-pair kernel and 64 and 128 the ring
# kernel, counted on launches_long
PERSISTENT_MAX_SEQ = 512
NEG = -1e9

# the ring kernel's constants (csrc/pair_attention.cu, namespace ring)
RING_KEYS = 128            # keys of a stage
RING_ROWS = 64             # query rows of a tile
RING_SMEM_LIMIT = 232448   # shared memory a block may take
RING_MAX_STAGES = 8

# the long-pair kernel's constants (csrc/pair_attention.cu, namespace
# longpair): heads of 32 above S 512
LONG_PAIR_STEP = 64        # keys of an online-softmax step, and of a tail block: the one
                           # holding kend, where kend mod 128 is in (0, 64]
LONG_PAIR_CONSUMERS = 4    # consumer warpgroups
LONG_PAIR_TILES = 1        # 64-row tiles of a unit a consumer warpgroup takes


def padded_width(d: int) -> int:
    """The kernel width a head of ``d`` values runs at: the smallest of
    :data:`HEAD_DIMS` at least ``d``."""
    for w in HEAD_DIMS:
        if d <= w:
            return w
    raise ValueError(f"pair attention takes head_dim <= {MAX_HEAD_DIM}; got head_dim {d}")


class RingPlan(NamedTuple):
    """The ring kernel's launch at one head width, as the C++ computes it."""

    consumers: int      # consumer warpgroups, one 64-row tile each a unit
    threads: int        # and a producer warpgroup
    producer_regs: int  # registers a thread after setmaxnreg
    consumer_regs: int
    regs_fit: bool      # the budgets fit the launch's register pool
    stages: int         # 128-key K and V stages in the ring
    smem: int           # dynamic shared memory, bytes


def ring_plan(d: int) -> RingPlan:
    """Mirror of ``ring::Cfg``, ``regs_fit``, ``smem_bytes`` and
    ``ring_stages``: one block an SM whatever S is, since the ring holds
    128-key blocks and not a whole item."""
    if d not in (64, 128):
        raise ValueError(f"the ring kernel is built at d 64 and 128; got {d}")
    wg = 2 if d == 128 else 3
    threads = 128 * (wg + 1)
    producer, consumer = 40, (232 if d == 128 else 152)
    pool = threads * (65536 // threads // 8 * 8)
    kv = RING_KEYS * d * 2                               # one of K, V in a stage
    q = RING_ROWS * d * 2                                # one q tile
    head = 8 + 4 * RING_KEYS                             # StageHead: flags and the bias row

    def smem(stages):
        return 1024 + stages * (2 * kv + head + 16) + wg * 2 * (q + 8)

    stages = RING_MAX_STAGES
    while stages > 2 and smem(stages) > RING_SMEM_LIMIT:
        stages -= 1
    return RingPlan(wg, threads, producer, consumer, 128 * (producer + wg * consumer) <= pool,
                    stages, smem(stages))


class LongPairPlan(NamedTuple):
    """The long-pair kernel's launch over one mask, as the C++ computes it."""

    consumers: int      # consumer warpgroups
    tiles: int          # 64-row tiles of a unit each takes
    unit: int           # row tiles a unit: its K and V blocks are staged once for all of them
    threads: int        # and a producer warpgroup
    producer_regs: int  # registers a thread after setmaxnreg
    consumer_regs: int
    regs_fit: bool      # the budgets fit the launch's register pool
    stages: int         # 128-key K and V stages in the ring
    smem: int           # dynamic shared memory, bytes
    units: int          # units over the mask's (pair, head) items
    idle: int           # (unit, consumer warpgroup) pairs with no tile: it passes through the blocks
    kv_bytes: int       # K and V staged from L2 into shared memory, bytes
    q_bytes: int        # q staged likewise: each tile's rows below S once


def staged_keys(mask: torch.Tensor, tail: bool = True) -> torch.Tensor:
    """(P,) keys of K (and of V) a unit of a pair's row tiles stages: its
    :func:`ring_blocks` of 128 keys, the block holding kend as
    :data:`LONG_PAIR_STEP` keys where ``tail`` and kend mod 128 is in (0,
    64] (the keys past kend there add exactly 0)."""
    kend = key_ends(mask)
    keys = ring_blocks(mask) * RING_KEYS
    if tail:
        cut = (kend > 0) & ((kend - 1) % RING_KEYS < LONG_PAIR_STEP)
        keys = keys - torch.where(cut, RING_KEYS - LONG_PAIR_STEP, 0)
    return keys


def staged_kv_bytes(mask: torch.Tensor, h: int, unit: int, tail: bool, d: int = 32) -> int:
    """K and V bytes a kernel stages from L2 into shared memory over a
    (P, S) mask at ``h`` heads of ``d`` when it stages each block once a
    unit of ``unit`` 64-row tiles: :func:`long_pair_plan`'s (units of
    four, the tail), or those of the ring kernel's D-32 instance, which
    took heads of 32 above S 512 before it (units of three, no tail)."""
    t = -(-mask.shape[1] // RING_ROWS)
    return int(staged_keys(mask, tail).sum()) * h * -(-t // unit) * 2 * d * 2


def long_pair_plan(mask: torch.Tensor, h: int, d: int = 32) -> LongPairPlan:
    """Mirror of ``longpair``'s constants, ``smem_bytes`` and
    ``ring_stages``, and of its dealing of row tiles, over a (P, S) mask at
    ``h`` heads of 32: four consumer warpgroups at 112 registers (the
    producer warpgroup's 24), warpgroup w taking tile t0 + w of each unit
    of four; eight 16 KB stages of K and V with their 528-byte heads and
    barriers, two 4 KB q buffers a warpgroup."""
    p, s = mask.shape
    if d != 32 or s <= PERSISTENT_MAX_SEQ:
        raise ValueError(f"the long-pair kernel takes heads of 32 above S "
                         f"{PERSISTENT_MAX_SEQ}; got d {d} at S {s}")
    wg, tiles = LONG_PAIR_CONSUMERS, LONG_PAIR_TILES
    unit = wg * tiles
    threads = 128 * (wg + 1)
    producer, consumer = 24, 112
    pool = threads * (65536 // threads // 8 * 8)
    kv = RING_KEYS * d * 2
    q = RING_ROWS * d * 2
    head = 4 * RING_KEYS + 16   # the bias row and three flags, 16-byte aligned

    def smem(stages):
        return 1024 + stages * (2 * kv + head + 16) + wg * 2 * (tiles * q + 8)

    stages = RING_MAX_STAGES
    while stages > 2 and smem(stages) > RING_SMEM_LIMIT:
        stages -= 1
    t = -(-s // RING_ROWS)
    idle = sum(t0 + w >= t for t0 in range(0, t, unit) for w in range(wg))
    return LongPairPlan(wg, tiles, unit, threads, producer, consumer,
                        128 * (producer + wg * consumer) <= pool, stages, smem(stages),
                        p * h * -(-t // unit), p * h * idle, staged_kv_bytes(mask, h, unit, True, d),
                        p * h * s * d * 2)


def launch_counter(s: int, d: int) -> str:
    """The counter on :func:`encoder_self_attention` that a launch at S
    ``s`` and kernel width ``d`` (one of :data:`HEAD_DIMS`) adds to, as the
    C entry dispatches it: ``launches`` (the persistent kernel, heads of 32
    up to S 512), ``launches_ring`` (the ring kernel, heads of 64 and 128
    up to S 512) or ``launches_long`` (above S 512: the long-pair kernel
    at heads of 32, the ring kernel at 64 and 128)."""
    if d not in HEAD_DIMS or s < 1:
        raise ValueError(f"pair attention takes head_dim in {HEAD_DIMS} and S >= 1; "
                         f"got head_dim {d}, S {s}")
    if s > PERSISTENT_MAX_SEQ:
        return "launches_long"
    return "launches" if d == 32 else "launches_ring"


def key_ends(mask: torch.Tensor) -> torch.Tensor:
    """(P,) kend of each pair: 1 + its last valid key, 0 if it has none."""
    valid = mask > 0
    s = valid.shape[1]
    last = s - torch.argmax(valid.flip(1).to(torch.int32), dim=1)
    return torch.where(valid.any(dim=1), last, 0)


def ring_blocks(mask: torch.Tensor) -> torch.Tensor:
    """(P,) 128-key blocks the ring and long-pair kernels load (per unit
    of row tiles) for each pair: those below kend, or below S for a pair
    with no valid key."""
    kend = key_ends(mask)
    klim = torch.where(kend > 0, kend, mask.shape[1])
    return (klim + RING_KEYS - 1) // RING_KEYS


def _scaled_inputs(q, k, v, inv_sqrt):
    """q pre-scaled in f32 then rounded to bf16 (one multiply on the small
    (B, S, H, D) tensor instead of the (B, H, S, S) logits); k and v bf16."""
    qs = (q.float() * inv_sqrt).to(torch.bfloat16)
    return qs, k.to(torch.bfloat16), v.to(torch.bfloat16)


def kernel_inputs(q, k, v, inv_sqrt):
    """The kernels' contiguous bf16 q, k and v: q scaled by the true d's
    1/sqrt(d) first, then all three padded with zero columns to
    :func:`padded_width` (no copy of the padding when d is one)."""
    pad = padded_width(q.shape[-1]) - q.shape[-1]
    return tuple(
        torch.nn.functional.pad(t, (0, pad)).contiguous() if pad else t.contiguous()
        for t in _scaled_inputs(q, k, v, inv_sqrt)
    )


def encoder_self_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    attention_mask: torch.Tensor,
    inv_sqrt: float,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel (see the module docstring).

    bf16 values are multiplied as f32, which is exact for each product,
    so only the order of the f32 sums differs from the kernel's.
    """
    b, s, h, d = q.shape
    qs, kb, vb = _scaled_inputs(q, k, v, inv_sqrt)
    bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, NEG)
    lg = torch.einsum("bqhd,bkhd->bhqk", qs.float(), kb.float()) + bias
    m = lg.amax(dim=-1, keepdim=True)
    p = torch.exp(lg - m)
    ssum = p.sum(dim=-1, keepdim=True)  # (B, H, S, 1)
    ctx = torch.einsum(
        "bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(), vb.float()
    )
    out = (ctx / ssum).to(torch.bfloat16)
    return out.permute(0, 2, 1, 3).reshape(b, s, h * d).to(out_dtype)


def _kernel_fn():
    fn = _cuda.library("pair_attention").pair_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pair_attention_kernel(
    qs: torch.Tensor,    # (B, S, H, d) bf16, pre-scaled by 1/sqrt(d)
    kb: torch.Tensor,    # (B, S, H, d) bf16
    vb: torch.Tensor,    # (B, S, H, d) bf16
    mask: torch.Tensor,  # (B, S) int32 key validity
) -> torch.Tensor:
    """Launch ``csrc/pair_attention.cu`` on the current stream; returns the
    (B, S, H, d) bf16 context.  Raises on anything the kernels do not
    take (any S from 1; B H below 2^31).  Counts the launch on the
    counter :func:`launch_counter` names."""
    b, s, h, d = qs.shape
    counter = launch_counter(s, d)
    if b * h >= 2 ** 31 or s >= 2 ** 31:
        raise ValueError(f"pair attention indexes (pair, head) items and keys in 32 bits; "
                         f"got B {b}, H {h}, S {s}")
    for name, t in (("q", qs), ("k", kb), ("v", vb)):
        if t.shape != qs.shape or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be {tuple(qs.shape)} bf16")
    if mask.shape != (b, s) or mask.dtype != torch.int32:
        raise ValueError(f"mask must be {(b, s)} int32")
    for t in (qs, kb, vb, mask):
        if t.device != qs.device or t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError("inputs must be contiguous and on one CUDA device")
    if any(t.data_ptr() % 16 for t in (qs, kb, vb)):
        raise ValueError("q, k and v must be 16-byte aligned (TMA loads them)")
    out = torch.empty((b, s, h, d), dtype=torch.bfloat16, device=qs.device)
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    _cuda.check(
        _kernel_fn()(
            qs.data_ptr(), kb.data_ptr(), vb.data_ptr(), mask.data_ptr(),
            out.data_ptr(), b, s, h, d, stream,
        ),
        "pair_attention",
    )
    with _launch_lock:  # batches run in worker threads
        setattr(encoder_self_attention, counter, getattr(encoder_self_attention, counter) + 1)
    return out


def encoder_self_attention(
    q: torch.Tensor,              # (B, S, H, D) any float dtype
    k: torch.Tensor,              # (B, S, H, D)
    v: torch.Tensor,              # (B, S, H, D)
    attention_mask: torch.Tensor,  # (B, S) int/bool — key validity
    inv_sqrt: float,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Returns the (B, S, H*D) context, f32 unless ``out_dtype`` asks for
    bf16 (exact: the kernel stores bf16).  The CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor; nothing else.  A CUDA
    input that requires grad under grad mode raises: the kernel has no
    backward (``_cuda.refuse_grad``)."""
    if q.device.type == "cpu":
        return encoder_self_attention_plain(q, k, v, attention_mask, inv_sqrt, out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _cuda.refuse_grad("pair_attention", q, k, v)
    b, s, h, d = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q {tuple(q.shape)}")
    qs, kb, vb = kernel_inputs(q, k, v, inv_sqrt)
    out = pair_attention_kernel(qs, kb, vb, attention_mask.to(torch.int32).contiguous())
    return out[..., :d].reshape(b, s, h * d).to(out_dtype)


# kernel launches since the last reset (chip_smoke.py reads and resets
# them): the persistent kernel's (heads of 32), the ring kernel's (64 and
# 128) and, above S 512, the long-pair kernel's (32) and the ring
# kernel's (64 and 128)
encoder_self_attention.launches = 0
encoder_self_attention.launches_ring = 0
encoder_self_attention.launches_long = 0
_launch_lock = threading.Lock()
