"""Segment-masked flash attention: the encoder's ``RAG_TPU_FLASH`` path.

Port of ``financial_rag_system_tpu/models/bert.py _flash_attention``
together with the forward kernel it calls, jax's bundled TPU flash
attention (``jax/experimental/pallas/ops/tpu/flash_attention.py``,
``_flash_attention_kernel_single_batch`` and its single-step twin), as
``bert.py`` configures it: 128-row q blocks and 128-key blocks, one
(pair, head) a block, the key-padding mask as segment ids for both q and
kv, ``sm_scale`` 1/sqrt(d), no bias, not causal.

The function, for each pair and head, on (B, S, H, d) q, k and v:

- q, k and v are rounded to bf16; ``s = (q . k^T)`` is summed in f32 and
  multiplied by ``sm_scale`` (after the product, unlike kernel 2, which
  pre-scales q);
- ``MASK_VALUE`` (-0.7 * FLT_MAX, finite) is added wherever the query's
  segment id differs from the key's.  A pad query row (id 0) therefore
  attends the pad keys only, and a real row the real keys only: the pad
  rows are defined, and differ from kernel 2's and the einsum path's,
  which give every row the real keys;
- at S 128 (a single key block, jax's ``..._single_step`` kernel) the
  softmax is the plain one: ``p = exp(s - max)``, ``p / sum(p)`` rounded
  to bf16, then P.V summed in f32;
- above it, an online softmax over 128-key blocks: the running max ``m``
  (from -inf) and sum ``l``, ``p = exp(s - m_next)`` of the block,
  ``l_next = sum(p) + exp(m_prev - m_next) * l_prev``, and the f32
  accumulator kept normalised: ``acc = acc * (l_corr / l_next)``, then
  ``acc += (bf16(p) . V) / l_next`` (both as products with
  ``1 / l_next``, itself 1 where ``l_next`` is 0).  A row whose first
  block is wholly masked gets that block's weight scaled by
  ``exp(MASK_VALUE - m) = 0`` once a key of its segment appears, so the
  finite mask value keeps every row finite;
- the context is rounded to bf16, and returned as (B, S, H*d) f32.

JAX takes S any multiple of 128 and, above S 128, any d <= 128 and the
multiples of 128 above it (jax's multi-block kernel raises on other widths
above 128); at S 128 its single-step kernel takes every d.  The port takes
the same shapes (:func:`check_shape`) and refuses the rest (d 192 or 320
above S 128, S not a multiple of 128).  The kernel is built for heads of
32, 64, 128 and 256 (:data:`KERNEL_WIDTHS`) and for every multiple of 128
from 384 (the slab kernel), and the wrapper zero-pads every other d to the
next of those (:func:`padded_head_dim`: zero columns add nothing to q.k
and only columns that are sliced off to P.V).  The kernel's bound is
32-bit indexing (B H, H d and its work units below 2^31); the plain
version's is memory: a (B, 1, S, S) boolean segment test beside a (B, H,
S, 128) block of f32 scores.

- :func:`encoder_flash_attention` is the entry point: a CPU tensor runs
  :func:`flash_attention_plain`; a CUDA tensor launches the hand-written
  Hopper kernel ``csrc/flash_attention.cu`` or raises; any other device
  raises.  Heads of 32, 64 and 128 run ``flash_kernel<D>`` (a TMA ring of
  128-key K and V stages) and count on ``encoder_flash_attention.launches``;
  heads of 256 run ``d256::flash256_kernel`` and count on
  ``.launches_wide``; heads of 384 and every wider multiple of 128 run
  ``slab::slab_kernel`` and count on ``.launches_slab`` (a column split:
  each unit computes one 128-column slab of the context with
  ``flash_kernel<128>``'s arithmetic, its QK^T summed over the whole
  head's 128-column pieces, so QK^T runs d / 128 times;
  :func:`slab_plan`).  The D-256 kernel stages K and V as 32 KB slots of
  half a head's columns (K 0-127, K 128-255, V 0-127, V 128-255 a block)
  through a ring of five, with two consumer warpgroups and QK^T and P.V
  on ``wgmma``.  Above S 128 its online softmax steps over 64 keys, not
  jax's 128-key blocks, so P is rounded to bf16 against a 64-key step's
  running max, and the context accumulates unnormalised and is divided by
  the row sum once at the end (jax's normalised update rearranged); S 128
  keeps jax's single step in two passes over the block (the row's max
  and sum, then P = p / sum(p)).  These are liberties within the kernel's
  atol 1e-2, emulated on the CPU in ``tests/test_torch_flash_wide.py``;
  :func:`d256_plan` mirrors its shared memory and register budgets.
  A CUDA input that requires grad under grad mode raises
  (``_cuda.refuse_grad``): neither this kernel nor JAX's forward-only
  configuration has a backward, and a graded forward of the encoder takes
  the einsum path (``models/bert.py _flash_enabled``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from financial_rag_system_tpu_torch.ops import _cuda

BLOCK = 128          # jax's block_q, block_k_major and block_k at these lengths
WIDE_HEAD_DIM = 256  # the D-256 kernel's width
KERNEL_WIDTHS = (32, 64, 128, WIDE_HEAD_DIM)  # widths of their own; multiples of 128 above: slab
SLAB = 128           # context columns a unit of the slab kernel computes
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
SMEM_LIMIT = 232448  # shared memory a block may take on the H100


class D256Plan(NamedTuple):
    """The D-256 kernel's launch, as ``csrc/flash_attention.cu`` (namespace
    ``d256``) computes it."""

    consumers: int      # consumer warpgroups, one 64-row tile each a unit
    threads: int        # and a producer warpgroup
    producer_regs: int  # registers a thread after setmaxnreg
    consumer_regs: int
    regs_fit: bool      # the budgets fit the launch's register pool
    slot_order: tuple   # what a block's slots hold, in the order they fill
    slot_bytes: int     # one slot: 128 keys x 128 columns of bf16
    slots: int          # slots in the ring
    smem: int           # dynamic shared memory, bytes
    step: int           # keys of an online-softmax step above S 128


def d256_plan() -> D256Plan:
    """Mirror of ``d256``'s constants, ``smem_bytes`` and ``ring_slots``:
    as many 32 KB slots as fit beside one 32 KB q tile a consumer
    warpgroup, the heads of two blocks (segment ids and flags, 528 bytes
    each) and an 8-byte barrier a slot twice and a q tile once."""
    consumers, producer, consumer = 2, 24, 240
    threads = 128 * (consumers + 1)
    pool = threads * (65536 // threads // 8 * 8)
    order = ("K[:, :128]", "K[:, 128:]", "V[:, :128]", "V[:, 128:]")
    slot = BLOCK * (WIDE_HEAD_DIM // 2) * 2
    q_tile = 64 * WIDE_HEAD_DIM * 2
    head = 16 + 4 * BLOCK

    def smem(slots):
        return 1024 + slots * slot + consumers * q_tile + 2 * head + 16 * slots + 8 * consumers

    slots = 8
    while slots > len(order) and smem(slots) > SMEM_LIMIT:
        slots -= 1
    return D256Plan(consumers, threads, producer, consumer,
                    128 * (producer + consumers * consumer) <= pool, order, slot, slots,
                    smem(slots), BLOCK // 2)


class SlabPlan(NamedTuple):
    """The slab kernel's launch (heads of 384 and wider multiples of 128),
    as ``csrc/flash_attention.cu`` (namespace ``slab``) computes it."""

    consumers: int      # consumer warpgroups, one 64-row tile each a unit
    threads: int        # and a producer warpgroup
    producer_regs: int  # registers a thread after setmaxnreg
    consumer_regs: int
    regs_fit: bool      # the budgets fit the launch's register pool
    slot_bytes: int     # one slot: K's or V's 128 keys x 128 columns, or both tiles' q pieces
    slots: int          # slots in the ring
    smem: int           # dynamic shared memory, bytes
    slots_a_block: int  # per 128-key block: a K and a q slot a piece, then V's slab
    qk_passes: int      # QK^T over the whole head, once a slab
    units: int          # (item, slab, two row tiles) units of the launch


def slab_plan(b: int, s: int, h: int, d: int) -> SlabPlan:
    """Mirror of ``slab``'s constants, ``smem_bytes``, ``ring_slots`` and
    register budgets at (B, S, H, d): ``flash_kernel<128>``'s consumers
    and register pool, the budgets split per instantiation (56 and 224
    above S 128, 40 and 232 at S 128, where ptxas fits each without
    spills); as many 32 KB slots as fit beside the heads of two blocks (528
    bytes each) and two 8-byte barriers a slot; a block's head written with
    its first slot into one of two, which holds while the slots are at most
    2 d / 128 + 2."""
    if d <= WIDE_HEAD_DIM or d % SLAB:
        raise ValueError(f"the slab kernel takes multiples of {SLAB} above "
                         f"{WIDE_HEAD_DIM}; got {d}")
    check_shape(s, d)
    consumers, producer, consumer = (2, 40, 232) if s == BLOCK else (2, 56, 224)
    threads = 128 * (consumers + 1)
    pool = threads * (65536 // threads // 8 * 8)
    slot = BLOCK * SLAB * 2
    head = 16 + 4 * BLOCK

    def smem(slots):
        return 1024 + slots * slot + 2 * head + 16 * slots

    slots = 8
    while slots > 2 and smem(slots) > SMEM_LIMIT:
        slots -= 1
    pieces = d // SLAB
    if slots > 2 * pieces + 2:
        raise AssertionError("a block's head would be written over while it is read")
    return SlabPlan(consumers, threads, producer, consumer,
                    128 * (producer + consumers * consumer) <= pool, slot, slots, smem(slots),
                    2 * pieces + 1, pieces, b * h * pieces * (s // (consumers * 64)))


def check_shape(seq: int, head_dim: int) -> None:
    """Raise unless the kernel (and so the port) takes this shape: jax's
    kernel's rule, S a multiple of 128; above S 128, d up to 128 or a
    multiple of 128 (at S 128, any d)."""
    if seq < BLOCK or seq % BLOCK:
        raise ValueError(f"flash attention takes S a multiple of {BLOCK}; got S {seq}")
    if head_dim < 1 or (seq > BLOCK and head_dim > 128 and head_dim % 128):
        raise ValueError(f"flash attention takes head_dim <= 128 or a multiple of 128 above "
                         f"S {BLOCK}; got head_dim {head_dim} at S {seq}")


def flash_attention_plain(
    q: torch.Tensor,               # (B, S, H, d)
    k: torch.Tensor,
    v: torch.Tensor,
    attention_mask: torch.Tensor,  # (B, S) segment ids (the key-padding mask)
    inv_sqrt: float,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in jax's block order (see the
    module docstring).  bf16 values are multiplied as f32, exact for each
    product, so only the order of the f32 sums differs from the kernel's.
    Holds one (B, H, S, 128) block of scores at a time."""
    b, s, h, d = q.shape
    check_shape(s, d)
    qb, kb, vb = (t.to(torch.bfloat16).float().permute(0, 2, 1, 3) for t in (q, k, v))
    seg = attention_mask.to(torch.int32)
    same = seg[:, None, :, None] == seg[:, None, None, :]  # (B, 1, S, S)

    def scores(lo: int) -> torch.Tensor:
        sc = torch.matmul(qb, kb[:, :, lo:lo + BLOCK].transpose(-1, -2)) * inv_sqrt
        return sc + torch.where(same[..., lo:lo + BLOCK], 0.0, MASK_VALUE)

    if s == BLOCK:  # jax's single-step kernel: the plain softmax
        sc = scores(0)
        p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
        p = p / p.sum(dim=-1, keepdim=True)
        acc = torch.matmul(p.to(torch.bfloat16).float(), vb)
    else:
        m = torch.full((b, h, s, 1), float("-inf"), device=q.device)
        l = torch.zeros((b, h, s, 1), device=q.device)
        acc = torch.zeros((b, h, s, d), device=q.device)
        for lo in range(0, s, BLOCK):
            sc = scores(lo)
            m_next = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            p = torch.exp(sc - m_next)
            del sc
            l_corr = torch.exp(m - m_next) * l
            l_next = p.sum(dim=-1, keepdim=True) + l_corr
            inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
            acc = acc * (l_corr * inv)
            acc = acc + torch.matmul(p.to(torch.bfloat16).float(), vb[:, :, lo:lo + BLOCK]) * inv
            del p
            m, l = m_next, l_next
    out = acc.to(torch.bfloat16).permute(0, 2, 1, 3)
    return out.reshape(b, s, h * d).to(out_dtype)


def padded_head_dim(head_dim: int, seq: int) -> int:
    """The width the kernel takes a head of ``head_dim`` at, at S ``seq``:
    the least of :data:`KERNEL_WIDTHS` that holds it, above 256 the least
    multiple of 128 (the slab kernel): ``head_dim`` itself but at S 128."""
    check_shape(seq, head_dim)
    return next((w for w in KERNEL_WIDTHS if head_dim <= w), -(-head_dim // SLAB) * SLAB)


def launch_counter(head_dim: int) -> str:
    """The counter on :func:`encoder_flash_attention` that a launch at
    kernel width ``head_dim`` adds to: ``launches`` (``flash_kernel<D>``,
    32-128), ``launches_wide`` (the D-256 kernel) or ``launches_slab``
    (the slab kernel, 384 and up)."""
    if head_dim not in KERNEL_WIDTHS and (head_dim <= WIDE_HEAD_DIM or head_dim % SLAB):
        raise ValueError(f"the kernel takes head_dim {KERNEL_WIDTHS} or a multiple of {SLAB} "
                         f"above {WIDE_HEAD_DIM}; got {head_dim}")
    if head_dim > WIDE_HEAD_DIM:
        return "launches_slab"
    return "launches_wide" if head_dim == WIDE_HEAD_DIM else "launches"


def kernel_inputs(q, k, v):
    """The kernel's contiguous bf16 q, k and v, padded with zero columns
    to :func:`padded_head_dim` (no padding copy at a width it takes)."""
    pad = padded_head_dim(q.shape[-1], q.shape[1]) - q.shape[-1]
    bf = (t.to(torch.bfloat16) for t in (q, k, v))
    return tuple((torch.nn.functional.pad(t, (0, pad)) if pad else t).contiguous() for t in bf)


def _kernel_fn():
    fn = _cuda.library("flash_attention").flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_kernel(
    qb: torch.Tensor,   # (B, S, H, dp) bf16, dp one of KERNEL_WIDTHS
    kb: torch.Tensor,   # (B, S, H, dp) bf16
    vb: torch.Tensor,   # (B, S, H, dp) bf16
    seg: torch.Tensor,  # (B, S) int32 segment ids
    inv_sqrt: float,
) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` on the current stream; returns
    the (B, S, H, dp) bf16 context.  Raises on anything the kernel does
    not take.  Counts the launch on the counter :func:`launch_counter`
    names."""
    b, s, h, dp = qb.shape
    check_shape(s, dp)
    counter = launch_counter(dp)
    if b * h >= 2 ** 31 or h * dp >= 2 ** 31 or (dp > WIDE_HEAD_DIM and
                                                b * h * (dp // SLAB) * (s // BLOCK) >= 2 ** 31):
        raise ValueError(f"flash attention indexes in 32 bits; got B {b}, S {s}, H {h}, "
                         f"head_dim {dp}")
    for name, t in (("q", qb), ("k", kb), ("v", vb)):
        if t.shape != qb.shape or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be {tuple(qb.shape)} bf16")
    if seg.shape != (b, s) or seg.dtype != torch.int32:
        raise ValueError(f"segment ids must be {(b, s)} int32")
    for t in (qb, kb, vb, seg):
        if t.device != qb.device or t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError("inputs must be contiguous and on one CUDA device")
    if any(t.data_ptr() % 16 for t in (qb, kb, vb)):
        raise ValueError("q, k and v must be 16-byte aligned")
    out = torch.empty_like(qb)
    with _cuda.on_device(qb.device):
        _cuda.launch(_kernel_fn(), "flash_attention", qb.data_ptr(), kb.data_ptr(),
                     vb.data_ptr(), seg.data_ptr(), out.data_ptr(), b, s, h, dp, inv_sqrt)
    with _launch_lock:  # batches run in worker threads
        setattr(encoder_flash_attention, counter, getattr(encoder_flash_attention, counter) + 1)
    return out


def encoder_flash_attention(
    q: torch.Tensor,               # (B, S, H, d) any float dtype
    k: torch.Tensor,
    v: torch.Tensor,
    attention_mask: torch.Tensor,  # (B, S) int/bool: the segment ids
    inv_sqrt: float,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Returns the (B, S, H*d) context, f32 unless ``out_dtype`` asks for
    bf16 (exact: the kernel stores bf16).  The CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor; nothing else."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, attention_mask, inv_sqrt, out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _cuda.refuse_grad("flash_attention", q, k, v)
    b, s, h, d = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q {tuple(q.shape)}")
    check_shape(s, d)
    qb, kb, vb = kernel_inputs(q, k, v)
    out = flash_attention_kernel(qb, kb, vb, attention_mask.to(torch.int32).contiguous(),
                                 inv_sqrt)
    return out[..., :d].reshape(b, s, h * d).to(out_dtype)


# kernel launches since the last reset (chip_smoke.py reads and resets
# them): heads of 32-128, of 256, and of 384 and wider
encoder_flash_attention.launches = 0
encoder_flash_attention.launches_wide = 0
encoder_flash_attention.launches_slab = 0
_launch_lock = threading.Lock()
