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
  128-key K and V stages) and count on ``encoder_flash_attention.launches``,
  but heads of 32 above S 512, which run ``longrow::long_kernel`` (two
  consumer warpgroups of two row tiles each, both tiles' softmaxes
  interleaved; :func:`long_plan`) and count on ``.launches_long``; heads
  of 256 run ``d256::flash256_kernel`` and count on ``.launches_wide``;
  heads of 384 and every wider multiple of 128 run ``slab::slab_kernel``
  and count on ``.launches_slab`` (one QK^T and one softmax a (64-row
  tile, 128-key block) over the whole head, split by keys between two
  consumer warpgroups that hold the context's 64-column chunks between
  them, P through shared memory; K and V multicast to a cluster of two
  blocks, each a row tile; heads above 512 in column groups of two to
  four slabs, QK^T once a group: :func:`slab_plan`, :func:`slab_groups`).
  The D-256 kernel stages K and V as 32 KB slots of
  half a head's columns (K 0-127, K 128-255, V 0-127, V 128-255 a block)
  through a ring of five, with two consumer warpgroups and QK^T and P.V
  on ``wgmma``.  Above S 128 its online softmax steps over 64 keys, not
  jax's 128-key blocks, so P is rounded to bf16 against a 64-key step's
  running max, and the context accumulates unnormalised and is divided by
  the row sum once at the end (jax's normalised update rearranged); S 128
  keeps jax's single step in two passes over the block (the row's max
  and sum, then P = p / sum(p)).  The slab and long-row kernels keep
  jax's 128-key blocks and accumulate unnormalised too.  These are
  liberties within the kernel's atol 1e-2, emulated on the CPU in
  ``tests/test_torch_flash_wide.py`` and ``tests/test_torch_long_attention.py``;
  :func:`d256_plan` mirrors the D-256 kernel's shared memory and register
  budgets.

The backward (jax's ``custom_vjp`` of its flash attention, ``_flash_attention_bwd``
with its two kernels ``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq``): whenever grad mode is on and q, k or v
requires grad, :func:`encoder_flash_attention` runs :class:`_FlashAttention`,
an autograd function over the same forward.  Its forward keeps jax's
residuals, each row's final max ``m`` of the scaled scores and its sum
``l`` at that max ((B, H, S) f32: the kernel's ``flash_attention_res``
entry, :func:`flash_attention_fwd_plain` on the CPU), with the bf16 q, k,
v, the bf16 context and the segment ids.  Its backward rounds the f32
cotangent to bf16 (the transpose of JAX's ``.astype(jnp.float32)`` of the
bf16 context, ``bert.py:188``), takes ``di = rowsum(f32(o) f32(dO))`` in
torch (jax computes it in XLA, ``flash_attention.py:272-275``), and runs
``csrc/flash_attention_bwd.cu`` on a CUDA tensor (kernel 8, dK and dV, and
kernel 9, dQ, counted on ``encoder_flash_attention.launches_bwd_dkv`` and
``.launches_bwd_dq``; at heads of 32 and 64 ``unit::walk_kernel``:
persistent blocks taking units of own 64-row tiles, each walked block
(32 or 64 rows) staged once a unit by TMA into a ring, every product on
``wgmma``,
:func:`bwd_plan`; wider heads the first design's 64-column pieces) or
:func:`flash_attention_bwd_plain` on a CPU one;
it returns f32 gradients of the bf16 values (the transpose of the
``.astype(jnp.bfloat16)`` casts, ``bert.py:181-183``).  Per (query, key)
pair: ``p = exp(s - m) * (1 / l)`` (0 where the segments differ),
``dV += bf16(p)^T . dO``, ``dP = dO . V^T``, ``dS = (dP - di) * p *
sm_scale``, ``dK += bf16(dS)^T . q``, ``dQ += bf16(dS) . K``, every product
summed in f32 and each gradient stored as bf16.  A width the forward pads
is padded as the forward pads it, and the padded columns of the gradients
(zero) are sliced off.  The serving path (no grad) is unchanged: it asks
the kernel for no residuals.
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
    """The slab kernel's launches (heads of 384 and wider multiples of 128),
    as ``csrc/flash_attention.cu`` (namespace ``slab``) computes them."""

    consumers: int      # consumer warpgroups: 64 keys of a block and half the group's columns each
    cluster: int        # blocks of a cluster: row tiles sharing each K and V slot (multicast)
    threads: int        # and a producer warpgroup
    producer_regs: int  # registers a thread after setmaxnreg
    consumer_regs: int
    regs_fit: bool      # the budgets fit the launch's register pool
    q_resident: bool    # q's tile stays in shared memory, loaded once a tile
    slot_bytes: int     # one slot: 128 keys x 128 columns of K or V (or a q piece)
    slots: int          # slots in the ring
    smem: int           # dynamic shared memory, bytes
    groups: tuple       # 128-column slabs of each column group, in order
    launches: tuple     # (slabs a group, groups) of each launch
    slots_a_block: tuple  # per column group: K's pieces (and q's), then V's slabs
    qk_passes: int      # QK^T and the softmax over the whole head: once a column group
    units: int          # (item, kCluster row tiles, column group) units, all launches
    staged_bytes: int   # L2 -> shared bytes with no (tile, block) skipped (multicast once)
    acc_floats: int     # context values a consumer thread holds: 32 a 64-column chunk


SLAB_CLUSTER = 2
SLAB_MAX_GROUP = 4


def slab_groups(d: int) -> tuple:
    """The head's d / 128 slabs as column groups of at most four, as even
    as they come (``slab::launch``): 3, 4, (3, 2), (3, 3), (4, 3), ..."""
    np_ = d // SLAB
    ng = -(-np_ // SLAB_MAX_GROUP)
    base, extra = divmod(np_, ng)
    return (base + 1,) * extra + (base,) * (ng - extra)


def slab_plan(b: int, s: int, h: int, d: int) -> SlabPlan:
    """Mirror of ``slab``'s constants, ``smem_bytes``, ``q_resident``,
    ``ring_slots``, register budgets and column groups at (B, S, H, d): two
    consumer warpgroups at 224 registers (the producer's 56: its loop state
    spilled at 24) in the pool of 384 threads at 168; q resident while two 32 KB slots still fit
    beside it, P (16 KB), the heads of two blocks (528 bytes each), the
    two warpgroups' row maxima and sums (1 KB) and the barriers; as many
    slots as fit, up to eight.  ``staged_bytes``: every K and V slot of a
    unit's blocks once for the cluster's two tiles, q once a tile (or its
    pieces a block when not resident)."""
    if d <= WIDE_HEAD_DIM or d % SLAB:
        raise ValueError(f"the slab kernel takes multiples of {SLAB} above "
                         f"{WIDE_HEAD_DIM}; got {d}")
    check_shape(s, d)
    consumers, producer, consumer = 2, 56, 224
    threads = 128 * (consumers + 1)
    pool = threads * (65536 // threads // 8 * 8)
    slot = BLOCK * SLAB * 2
    p_bytes = 64 * BLOCK * 2
    head = 16 + 4 * BLOCK

    def smem(qres, slots):
        return (1024 + (64 * d * 2 if qres else 0) + p_bytes + slots * slot + 2 * head
                + 2 * consumers * 64 * 4 + (2 * slots + 1) * 8)

    qres = smem(True, 2) <= SMEM_LIMIT
    slots = 8
    while slots > 2 and smem(qres, slots) > SMEM_LIMIT:
        slots -= 1
    groups = slab_groups(d)
    launches = tuple((g, groups.count(g)) for g in dict.fromkeys(groups))
    pieces = d // SLAB
    per_block = tuple((pieces if qres else 2 * pieces) + g for g in groups)
    if slots > min(per_block) + 1:
        raise AssertionError("a block's head would be written over while it is read")
    units_a_group = b * h * (s // (64 * SLAB_CLUSTER))
    q_unit = SLAB_CLUSTER * 64 * d * 2
    staged = sum(units_a_group * ((s // BLOCK) * ((pieces + g) * slot
                                                  + (0 if qres else SLAB_CLUSTER * pieces * slot // 2))
                                  + (q_unit if qres else 0))
                 for g in groups)
    return SlabPlan(consumers, SLAB_CLUSTER, threads, producer, consumer,
                    128 * (producer + consumers * consumer) <= pool, qres, slot, slots,
                    smem(qres, slots), groups, launches, per_block, len(groups),
                    units_a_group * len(groups), staged, 32 * max(groups))


class LongPlan(NamedTuple):
    """The long-row kernel's launch (heads of 32 above S 512), as
    ``csrc/flash_attention.cu`` (namespace ``longrow``) computes it."""

    consumers: int      # consumer warpgroups
    tiles: int          # 64-row tiles a consumer warpgroup takes a unit
    unit: int           # row tiles a unit: each 128-key block staged once for them
    threads: int        # and a producer warpgroup
    producer_regs: int  # registers a thread after setmaxnreg
    consumer_regs: int
    regs_fit: bool
    stages: int         # ring stages of a 128-key block's K and V
    smem: int           # dynamic shared memory, bytes
    units: int          # units of the launch
    staged_bytes: int   # L2 -> shared bytes with no (tile, block) skipped


LONG_MIN_SEQ = 512   # the long-row kernel takes heads of 32 above this S
LONG_HEAD_DIM = 32


def long_plan(b: int, s: int, h: int, d: int = LONG_HEAD_DIM) -> LongPlan:
    """Mirror of ``longrow``'s constants, ``smem_bytes`` and ``ring_stages``
    at (B, S, H, 32): two consumer warpgroups at 240 registers (the
    producer's 24), each taking two 64-row tiles of a unit of four; eight
    stages of K and V (8 KB each) and their heads and barriers, two q
    buffers of two 4 KB tiles a warpgroup.  ``staged_bytes``: each block's
    K and V once a unit, q once a tile."""
    if d != LONG_HEAD_DIM or s <= LONG_MIN_SEQ:
        raise ValueError(f"the long-row kernel takes heads of {LONG_HEAD_DIM} above S "
                         f"{LONG_MIN_SEQ}; got d {d} at S {s}")
    check_shape(s, d)
    consumers, tiles, producer, consumer = 2, 2, 24, 240
    threads = 128 * (consumers + 1)
    pool = threads * (65536 // threads // 8 * 8)
    kv = BLOCK * d * 2
    q_tile = 64 * d * 2
    head = 16 + 4 * BLOCK

    def smem(stages):
        return 1024 + stages * (2 * kv + head + 16) + consumers * 2 * (tiles * q_tile + 8)

    stages = 8
    while stages > 2 and smem(stages) > SMEM_LIMIT:
        stages -= 1
    unit = consumers * tiles
    units = b * h * -(-(s // 64) // unit)
    return LongPlan(consumers, tiles, unit, threads, producer, consumer,
                    128 * (producer + consumers * consumer) <= pool, stages, smem(stages), units,
                    units * (s // BLOCK) * 2 * kv + b * h * s * d * 2)


class BwdPlan(NamedTuple):
    """A launch of kernel 8 or 9 at heads of 32 or 64, as
    ``csrc/flash_attention_bwd.cu`` (namespace ``unit``) computes it."""

    unit: int           # own 64-row tiles a unit: one a consumer warpgroup
    walk: int           # rows of a walked block (S's and dP's N)
    threads: int        # and a producer warpgroup
    producer_regs: int  # registers a thread after setmaxnreg
    consumer_regs: int
    regs_fit: bool      # the budgets fit the launch's register pool
    stages: int         # ring stages of a walked block
    smem: int           # dynamic shared memory, bytes
    units: int          # (item, unit) pairs of the launch
    staged_bytes: int   # L2 -> shared bytes with no (tile, block) skipped


# the unit kernel's (head width, dK/dV): its own tiles a unit, and a walked block's rows
BWD_UNITS = {(32, True): (4, 32), (32, False): (4, 64), (64, True): (2, 64), (64, False): (2, 64)}
BWD_ROWS = 64                     # rows of an own tile
BWD_WIDE_MIN = 128                # the wide kernel's heads: 128 and every wider multiple of 64


def bwd_head_bytes(walk: int) -> int:
    """A stage's head: need bits, and ``walk`` ids and rows' four values."""
    return 16 + 20 * walk


def bwd_plan(b: int, s: int, h: int, d: int, dkv: bool = True) -> BwdPlan:
    """Mirror of ``unit``'s ``Cfg``, ``smem_bytes`` and ``ring_stages`` at
    (B, S, H, d), d 32 or 64: U consumer warpgroups (4 at d 32, 2 at 64),
    the producer warpgroup at 32 registers and the
    consumers at their share of the launch's pool; walked blocks of 32 rows
    (dK/dV at d 32) or 64; as many stages of a walked block (its two tiles,
    its head and two barriers) as fit, up to eight 64-row blocks' worth,
    beside two buffers of a warpgroup's two own tiles.  ``staged_bytes``:
    each walked block's two tiles once a unit, the rows' values the
    producer writes beside them (dK/dV: m log2e, 1 / l, di and the id, 16
    bytes a row; dQ: the id), and each own tile once."""
    if (d, dkv) not in BWD_UNITS:
        raise ValueError(f"the unit kernel takes heads of 32 and 64; got {d}")
    check_shape(s, d)
    u, walk = BWD_UNITS[d, dkv]
    threads = 128 * (u + 1)
    pool = threads * (65536 // threads // 8 * 8)
    producer = 32
    consumer = min(240, (pool // 128 - producer) // u // 8 * 8)
    tile = BWD_ROWS * d * 2

    def smem(stages):
        return (1024 + stages * (2 * walk * d * 2 + bwd_head_bytes(walk) + 16)
                + u * 2 * (2 * tile + 8))

    stages = 8 * 64 // walk
    while stages > 2 and smem(stages) > SMEM_LIMIT:
        stages -= 1
    t = s // BWD_ROWS
    units = b * h * -(-t // u)
    row_values = 16 if dkv else 4
    return BwdPlan(u, walk, threads, producer, consumer, 128 * (producer + u * consumer) <= pool,
                   stages, smem(stages), units,
                   units * (s // walk) * walk * (4 * d + row_values) + b * h * t * 2 * tile)


class WideBwdPlan(NamedTuple):
    """A launch of kernel 8 or 9 at heads of 128 and wider, as
    ``csrc/flash_attention_bwd.cu`` (namespace ``wide``) computes it."""

    walk: int           # rows of a walked block (S's and dP's N, split between the warpgroups)
    resident: bool      # the own tile's two tiles stay in shared memory for a unit's walk
    groups: tuple       # 64-column chunks of each column group of the gradients, in order
    group_chunks: int   # chunks of the largest group (its warpgroups' share alternates)
    window_chunks: int  # chunks of the head a stage holds: all of them when resident
    threads: int        # two consumer warpgroups and a producer warpgroup
    producer_regs: int  # registers a thread after setmaxnreg
    consumer_regs: int
    regs_fit: bool      # the budgets fit the launch's register pool
    stages: int         # ring stages of a walked block (or of a window of one)
    smem: int           # dynamic shared memory, bytes
    cluster: int        # blocks of a cluster: own tiles sharing each walked block (multicast)
    units: int          # (item, cluster's own tiles, column group) units of the launch
    staged_bytes: int   # L2 -> shared bytes with no (tile, block) skipped (multicast once)


WIDE_CONSUMERS = 2          # consumer warpgroups: each S and dP over half a walked block's rows
WIDE_GRAD_CHUNKS = {True: 2, False: 4}  # 64-column gradient chunks a warpgroup holds (dK/dV, dQ)
WIDE_RESIDENT_MAX = 512     # above, the own tile is staged with each window of the head
WIDE_WINDOW_CHUNKS = 4      # a window's chunks (and a column group's) when not resident
WIDE_MAX_STAGES = 4
WIDE_CLUSTER = 2            # blocks of a cluster, each an own tile, sharing the walked blocks


def wide_walk(d: int) -> int:
    """The wide kernel's walked block at heads of ``d`` (``walk_rows``): 64
    rows up to 256, 32 up to 384 and above 512 (a stage a window of the
    head), 16 at 448 and 512 (a stage the block over the whole head)."""
    return 64 if d <= 256 else 32 if d <= 384 or d > WIDE_RESIDENT_MAX else 16


def wide_groups(d: int, dkv: bool) -> tuple:
    """The head's d / 64 chunks as the wide kernel's column groups, in
    order: runs of two warpgroups' chunks (2 x ``WIDE_GRAD_CHUNKS``), or of
    a window's when the own tile is not resident, the last one shorter."""
    nc = d // 64
    most = (2 * WIDE_GRAD_CHUNKS[dkv] if d <= WIDE_RESIDENT_MAX else WIDE_WINDOW_CHUNKS)
    return tuple(min(most, nc - lo) for lo in range(0, nc, most))


def wide_bwd_plan(b: int, s: int, h: int, d: int, dkv: bool = True) -> WideBwdPlan:
    """Mirror of ``wide``'s constants and ``plan`` at (B, S, H, d), d 128 or
    any wider multiple of 64: two consumer warpgroups at 224 registers and
    the producer warpgroup at 56 in the pool of 384 threads; clusters of
    two blocks taking units of two own 64-row tiles (one a block) and one
    column group, each walked block multicast to both; up to 512 the own
    tile resident and a stage one walked block over the whole head, above
    it a stage a window of four chunks of the own tile and of the walked
    block; bf16 p and dS a (tile, block) in shared memory, in wgmma's core
    matrices; as many stages as fit, up to four.  ``staged_bytes``:
    resident, each own tile once a unit, each walked block's two tiles once
    a unit (multicast) and its rows' values once a block of the cluster;
    otherwise the own tiles and the walked block once a unit and block."""
    if d < BWD_WIDE_MIN or d % 64:
        raise ValueError(f"the wide kernel takes heads of {BWD_WIDE_MIN} and wider multiples "
                         f"of 64; got {d}")
    if s < BLOCK or s % BLOCK:
        raise ValueError(f"the backward takes S a multiple of {BLOCK}; got S {s}")
    threads = 128 * (WIDE_CONSUMERS + 1)
    pool = threads * (65536 // threads // 8 * 8)
    producer = 56
    consumer = (pool // 128 - producer) // WIDE_CONSUMERS // 8 * 8
    walk, nc, chunk = wide_walk(d), d // 64, BWD_ROWS * 64 * 2
    resident = d <= WIDE_RESIDENT_MAX
    groups = wide_groups(d, dkv)
    window = nc if resident else max(groups)
    stage = 2 * window * ((0 if resident else chunk) + walk * 128)
    head = 16 + 16 * walk
    own = 2 * nc * chunk if resident else 0
    pds = (2 if dkv else 1) * BWD_ROWS * 2 * walk  # bf16 p and dS in core matrices

    def smem(stages):
        return 1024 + stages * (stage + head + 16) + own + pds + 16

    stages = WIDE_MAX_STAGES
    while stages > 1 and smem(stages) > SMEM_LIMIT:
        stages -= 1
    if smem(stages) > SMEM_LIMIT:
        raise AssertionError(f"the wide kernel does not fit at heads of {d}")
    cl = WIDE_CLUSTER
    units = b * h * (s // BWD_ROWS // cl) * len(groups)
    row = 16 if dkv else 4
    if resident:
        staged = units * (cl * 256 * d + s * (4 * d + cl * row))
    else:
        staged = units * (s // walk) * (cl * 256 * d + walk * (4 * d + cl * row))
    return WideBwdPlan(walk, resident, groups, max(groups), window, threads, producer, consumer,
                       128 * (producer + WIDE_CONSUMERS * consumer) <= pool, stages,
                       smem(stages), cl, units, staged)


def parent_bwd_staged(b: int, s: int, h: int, d: int, dkv: bool = True) -> int:
    """L2 -> shared bytes the first design (``bwd_kernel<W, DKV>``, a block
    a (pair, head, 64-row tile, piece of 64 head columns); one piece at
    heads of 32 and 64) staged with no (tile, block) skipped: for each
    piece and each walked block, the head's chunks of the own tile's two
    tiles and of the walked block's two, and the walked rows' ids and
    (dK/dV) m, l and di."""
    t = s // BWD_ROWS
    tile = BWD_ROWS * d * 2
    pieces = max(1, d // 64)
    return b * h * t * pieces * t * (4 * tile + BWD_ROWS * (16 if dkv else 4))


def check_shape(seq: int, head_dim: int) -> None:
    """Raise unless the kernel (and so the port) takes this shape: jax's
    kernel's rule, S a multiple of 128; above S 128, d up to 128 or a
    multiple of 128 (at S 128, any d)."""
    if seq < BLOCK or seq % BLOCK:
        raise ValueError(f"flash attention takes S a multiple of {BLOCK}; got S {seq}")
    if head_dim < 1 or (seq > BLOCK and head_dim > 128 and head_dim % 128):
        raise ValueError(f"flash attention takes head_dim <= 128 or a multiple of 128 above "
                         f"S {BLOCK}; got head_dim {head_dim} at S {seq}")


def _bf16_heads(*tensors) -> tuple:
    """(B, S, H, d) tensors as f32 holding their bf16 values, (B, H, S, d)."""
    return tuple(t.to(torch.bfloat16).float().permute(0, 2, 1, 3) for t in tensors)


def _block_scores(qb, kb, same, inv_sqrt: float, lo: int) -> torch.Tensor:
    """jax's scores of keys lo .. lo + 127: sm_scale (q . k^T) plus
    ``MASK_VALUE`` where the segments differ; (B, H, S, 128) f32."""
    sc = torch.matmul(qb, kb[:, :, lo:lo + BLOCK].transpose(-1, -2)) * inv_sqrt
    return sc + torch.where(same[..., lo:lo + BLOCK], 0.0, MASK_VALUE)


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
    out, _, _ = flash_attention_fwd_plain(q, k, v, attention_mask, inv_sqrt)
    return out.reshape(b, s, h * d).to(out_dtype)


def flash_attention_fwd_plain(
    q: torch.Tensor,               # (B, S, H, d)
    k: torch.Tensor,
    v: torch.Tensor,
    attention_mask: torch.Tensor,  # (B, S) segment ids
    inv_sqrt: float,
) -> tuple:
    """:func:`flash_attention_plain`'s arithmetic with jax's saved
    residuals (``_flash_attention_fwd``, ``save_residuals=True``): the
    (B, S, H, d) bf16 context, and each row's final max ``m`` of the
    scaled, masked scores and its sum ``l`` of ``exp(s - m)``, (B, H, S)
    f32 each (at S 128 the plain softmax's max and sum)."""
    b, s, h, d = q.shape
    check_shape(s, d)
    qb, kb, vb = _bf16_heads(q, k, v)
    seg = attention_mask.to(torch.int32)
    same = seg[:, None, :, None] == seg[:, None, None, :]  # (B, 1, S, S)

    if s == BLOCK:  # jax's single-step kernel: the plain softmax
        sc = _block_scores(qb, kb, same, inv_sqrt, 0)
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.exp(sc - m)
        l = p.sum(dim=-1, keepdim=True)
        p = p / l
        acc = torch.matmul(p.to(torch.bfloat16).float(), vb)
    else:
        m = torch.full((b, h, s, 1), float("-inf"), device=q.device)
        l = torch.zeros((b, h, s, 1), device=q.device)
        acc = torch.zeros((b, h, s, d), device=q.device)
        for lo in range(0, s, BLOCK):
            sc = _block_scores(qb, kb, same, inv_sqrt, lo)
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
    return out, m[..., 0], l[..., 0]


def flash_attention_bwd_plain(
    q: torch.Tensor,               # (B, S, H, d) the forward's q, k, v
    k: torch.Tensor,
    v: torch.Tensor,
    attention_mask: torch.Tensor,  # (B, S) segment ids
    do: torch.Tensor,              # (B, S, H, d) the context's cotangent
    m: torch.Tensor,               # (B, H, S) f32 residuals of the forward
    l: torch.Tensor,
    di: torch.Tensor,              # (B, H, S) f32: rowsum(f32(o) f32(dO))
    inv_sqrt: float,
    dq: bool = True,
    dkv: bool = True,
) -> tuple:
    """Plain PyTorch version of kernels 8 and 9: jax's
    ``_flash_attention_dkv_kernel`` and ``_flash_attention_dq_kernel``
    step by step, a 128-key block at a time, with their bf16 rounding
    points: ``p = exp(s - m) * (1 / l)``; ``dV = bf16(p)^T . dO``; ``dP =
    dO . V^T``; ``dS = (dP - di) * p * sm_scale``; ``dK = bf16(dS)^T . q``;
    ``dQ = sum over key blocks of bf16(dS) . K``; bf16 operands multiplied
    as f32 (exact), the sums in f32.  Returns (dQ, dK, dV), each (B, S, H,
    d) bf16, None where not asked for (``dq``, ``dkv``)."""
    b, s, h, d = q.shape
    check_shape(s, d)
    qb, kb, vb, dob = _bf16_heads(q, k, v, do)
    seg = attention_mask.to(torch.int32)
    same = seg[:, None, :, None] == seg[:, None, None, :]
    m, inv_l, di = m[..., None], 1.0 / l[..., None], di[..., None]
    g_q = torch.zeros_like(qb) if dq else None
    g_k, g_v = [], []
    for lo in range(0, s, BLOCK):
        p = torch.exp(_block_scores(qb, kb, same, inv_sqrt, lo) - m) * inv_l
        if dkv:
            g_v.append(torch.matmul(p.transpose(-1, -2).to(torch.bfloat16).float(), dob))
        dp = torch.matmul(dob, vb[:, :, lo:lo + BLOCK].transpose(-1, -2))
        ds = ((dp - di) * p * inv_sqrt).to(torch.bfloat16).float()
        del p, dp
        if dkv:
            g_k.append(torch.matmul(ds.transpose(-1, -2), qb))
        if dq:
            g_q = g_q + torch.matmul(ds, kb[:, :, lo:lo + BLOCK])
        del ds

    def out(t):
        return None if t is None else t.to(torch.bfloat16).permute(0, 2, 1, 3)

    return (out(g_q), out(torch.cat(g_k, dim=2) if dkv else None),
            out(torch.cat(g_v, dim=2) if dkv else None))


def padded_head_dim(head_dim: int, seq: int) -> int:
    """The width the kernel takes a head of ``head_dim`` at, at S ``seq``:
    the least of :data:`KERNEL_WIDTHS` that holds it, above 256 the least
    multiple of 128 (the slab kernel): ``head_dim`` itself but at S 128."""
    check_shape(seq, head_dim)
    return next((w for w in KERNEL_WIDTHS if head_dim <= w), -(-head_dim // SLAB) * SLAB)


def launch_counter(head_dim: int, seq: int = BLOCK) -> str:
    """The counter on :func:`encoder_flash_attention` that a launch at
    kernel width ``head_dim`` and S ``seq`` adds to: ``launches``
    (``flash_kernel<D>``, 32-128; 32 up to S 512), ``launches_long`` (the
    long-row kernel, 32 above S 512), ``launches_wide`` (the D-256 kernel)
    or ``launches_slab`` (the slab kernel, 384 and up)."""
    if head_dim not in KERNEL_WIDTHS and (head_dim <= WIDE_HEAD_DIM or head_dim % SLAB):
        raise ValueError(f"the kernel takes head_dim {KERNEL_WIDTHS} or a multiple of {SLAB} "
                         f"above {WIDE_HEAD_DIM}; got {head_dim}")
    if head_dim > WIDE_HEAD_DIM:
        return "launches_slab"
    if head_dim == LONG_HEAD_DIM and seq > LONG_MIN_SEQ:
        return "launches_long"
    return "launches_wide" if head_dim == WIDE_HEAD_DIM else "launches"


def kernel_inputs(q, k, v):
    """The kernel's contiguous bf16 q, k and v, padded with zero columns
    to :func:`padded_head_dim` (no padding copy at a width it takes)."""
    pad = padded_head_dim(q.shape[-1], q.shape[1]) - q.shape[-1]
    bf = (t.to(torch.bfloat16) for t in (q, k, v))
    return tuple((torch.nn.functional.pad(t, (0, pad)) if pad else t).contiguous() for t in bf)


def _kernel_fn(residuals: bool = False):
    lib = _cuda.library("flash_attention")
    fn = lib.flash_attention_res if residuals else lib.flash_attention
    fn.argtypes = ([ctypes.c_void_p] * (7 if residuals else 5) + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_kernel(
    qb: torch.Tensor,   # (B, S, H, dp) bf16, dp one of KERNEL_WIDTHS
    kb: torch.Tensor,   # (B, S, H, dp) bf16
    vb: torch.Tensor,   # (B, S, H, dp) bf16
    seg: torch.Tensor,  # (B, S) int32 segment ids
    inv_sqrt: float,
    residuals: bool = False,
):
    """Launch ``csrc/flash_attention.cu`` on the current stream; returns
    the (B, S, H, dp) bf16 context, and with ``residuals`` also jax's m
    and l, (B, H, S) f32 each (the C entry ``flash_attention_res``).
    Raises on anything the kernel does not take.  Counts the launch on the
    counter :func:`launch_counter` names."""
    b, s, h, dp = qb.shape
    check_shape(s, dp)
    counter = launch_counter(dp, s)
    if b * h >= 2 ** 31 or h * dp >= 2 ** 31 or (dp > WIDE_HEAD_DIM and
                                                b * h * (s // BLOCK) * len(slab_groups(dp))
                                                >= 2 ** 31):
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
    res = ()
    if residuals:
        res = tuple(torch.empty((b, h, s), dtype=torch.float32, device=qb.device)
                    for _ in range(2))
    with _cuda.on_device(qb.device):
        _cuda.launch(_kernel_fn(residuals), "flash_attention", qb.data_ptr(), kb.data_ptr(),
                     vb.data_ptr(), seg.data_ptr(), out.data_ptr(),
                     *(t.data_ptr() for t in res), b, s, h, dp, inv_sqrt)
    _count(counter)
    return (out, *res) if residuals else out


def _count(counter: str) -> None:
    with _launch_lock:  # batches run in worker threads
        setattr(encoder_flash_attention, counter, getattr(encoder_flash_attention, counter) + 1)


def _bwd_fn(name: str):
    fn = getattr(_cuda.library("flash_attention_bwd"), name)
    outputs = 2 if name == "flash_attention_bwd_dkv" else 1
    fn.argtypes = ([ctypes.c_void_p] * (8 + outputs) + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd_kernel(
    qb: torch.Tensor,   # (B, S, H, dp) bf16: the forward's kernel inputs
    kb: torch.Tensor,
    vb: torch.Tensor,
    seg: torch.Tensor,  # (B, S) int32 segment ids
    m: torch.Tensor,    # (B, H, S) f32: the forward's residuals
    l: torch.Tensor,
    dob: torch.Tensor,  # (B, S, H, dp) bf16: the context's cotangent
    di: torch.Tensor,   # (B, H, S) f32: rowsum(f32(o) f32(dO))
    inv_sqrt: float,
    dq: bool = True,
    dkv: bool = True,
) -> tuple:
    """Launch ``csrc/flash_attention_bwd.cu`` on the current stream: kernel
    9 (``flash_attention_bwd_dq``) when ``dq``, kernel 8
    (``flash_attention_bwd_dkv``) when ``dkv``; returns (dQ, dK, dV), each
    (B, S, H, dp) bf16, None where not asked for.  Raises on anything the
    kernels do not take.  Counts each launch on
    ``encoder_flash_attention.launches_bwd_dq`` / ``.launches_bwd_dkv``."""
    b, s, h, dp = qb.shape
    check_shape(s, dp)
    launch_counter(dp)  # the forward's widths only
    if b * h >= 2 ** 31 or h * dp >= 2 ** 31 or b * h * (s // 64) * max(1, dp // 64) >= 2 ** 31:
        raise ValueError(f"the flash backward indexes in 32 bits; got B {b}, S {s}, H {h}, "
                         f"head_dim {dp}")
    for name, t in (("q", qb), ("k", kb), ("v", vb), ("dO", dob)):
        if t.shape != qb.shape or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be {tuple(qb.shape)} bf16")
    for name, t in (("m", m), ("l", l), ("di", di)):
        if t.shape != (b, h, s) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {(b, h, s)} f32")
    if seg.shape != (b, s) or seg.dtype != torch.int32:
        raise ValueError(f"segment ids must be {(b, s)} int32")
    for t in (qb, kb, vb, dob, seg, m, l, di):
        if t.device != qb.device or t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError("inputs must be contiguous and on one CUDA device")
    if any(t.data_ptr() % 16 for t in (qb, kb, vb, dob)):
        raise ValueError("q, k, v and dO must be 16-byte aligned")
    args = (qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), seg.data_ptr(), m.data_ptr(),
            l.data_ptr(), dob.data_ptr(), di.data_ptr())
    g_q = torch.empty_like(qb) if dq else None
    g_k, g_v = (torch.empty_like(qb), torch.empty_like(qb)) if dkv else (None, None)
    with _cuda.on_device(qb.device):
        if dkv:
            _cuda.launch(_bwd_fn("flash_attention_bwd_dkv"), "flash_attention_bwd_dkv", *args,
                         g_k.data_ptr(), g_v.data_ptr(), b, s, h, dp, inv_sqrt)
            _count(bwd_counter(dp, True))
        if dq:
            _cuda.launch(_bwd_fn("flash_attention_bwd_dq"), "flash_attention_bwd_dq", *args,
                         g_q.data_ptr(), b, s, h, dp, inv_sqrt)
            _count(bwd_counter(dp, False))
    return g_q, g_k, g_v


def bwd_counter(head_dim: int, dkv: bool) -> str:
    """The counter on :func:`encoder_flash_attention` that a launch of
    kernel 8 (``dkv``) or 9 at kernel width ``head_dim`` adds to:
    ``launches_bwd_dkv`` / ``launches_bwd_dq`` at heads of 32 and 64,
    ``launches_bwd_wide_dkv`` / ``launches_bwd_wide_dq`` at 128 and wider."""
    wide = "_wide" if head_dim >= BWD_WIDE_MIN else ""
    return f"launches_bwd{wide}_{'dkv' if dkv else 'dq'}"


class _FlashAttention(torch.autograd.Function):
    """The flash attention with jax's VJP (``flash_attention.py:204-318``):
    (B, S, H, d) q, k, v of any float dtype and (B, S) int32 segment ids
    in, the (B, S, H*d) f32 context out.  The forward saves the bf16 q, k,
    v (as the kernel takes them: padded), the bf16 context, the segment
    ids and m, l; the backward returns the gradients of q, k and v in their
    dtypes (see the module docstring).  The kernels on a CUDA tensor, the
    plain versions on a CPU one."""

    @staticmethod
    def forward(ctx, q, k, v, seg, inv_sqrt):
        b, s, h, d = q.shape
        if q.device.type == "cuda":
            qb, kb, vb = kernel_inputs(q, k, v)
            out, m, l = flash_attention_kernel(qb, kb, vb, seg, inv_sqrt, residuals=True)
        else:
            qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
            out, m, l = flash_attention_fwd_plain(qb, kb, vb, seg, inv_sqrt)
        ctx.save_for_backward(qb, kb, vb, out, seg, m, l)
        ctx.inv_sqrt, ctx.d, ctx.dtypes = inv_sqrt, d, (q.dtype, k.dtype, v.dtype)
        return out[..., :d].reshape(b, s, h * d).float()

    @staticmethod
    def backward(ctx, g):
        qb, kb, vb, out, seg, m, l = ctx.saved_tensors
        b, s, h, dp = qb.shape
        d, inv_sqrt = ctx.d, ctx.inv_sqrt
        do = g.reshape(b, s, h, d).to(torch.bfloat16)  # the transpose of the f32 cast
        di = (out[..., :d].float() * do.float()).sum(-1).permute(0, 2, 1).contiguous()
        want_q = ctx.needs_input_grad[0]
        want_kv = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        if qb.device.type == "cuda":
            dob = (torch.nn.functional.pad(do, (0, dp - d)) if dp > d else do).contiguous()
            grads = flash_attention_bwd_kernel(qb, kb, vb, seg, m, l, dob, di, inv_sqrt,
                                               dq=want_q, dkv=want_kv)
        else:
            grads = flash_attention_bwd_plain(qb, kb, vb, seg, do, m, l, di, inv_sqrt,
                                              dq=want_q, dkv=want_kv)
        return (*(None if t is None else t[..., :d].to(dt)
                  for t, dt in zip(grads, ctx.dtypes)), None, None)


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
    tensor, the plain version for a CPU tensor; nothing else.  Under grad
    mode with q, k or v requiring grad, :class:`_FlashAttention` (the same
    forward with jax's backward: kernels 7, 8 and 9 on the card)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    b, s, h, d = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q {tuple(q.shape)}")
    check_shape(s, d)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        seg = attention_mask.to(torch.int32).contiguous()
        return _FlashAttention.apply(q, k, v, seg, inv_sqrt).to(out_dtype)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, attention_mask, inv_sqrt, out_dtype)
    qb, kb, vb = kernel_inputs(q, k, v)
    out = flash_attention_kernel(qb, kb, vb, attention_mask.to(torch.int32).contiguous(),
                                 inv_sqrt)
    return out[..., :d].reshape(b, s, h * d).to(out_dtype)


# kernel launches since the last reset (chip_smoke.py reads and resets
# them): heads of 32-128 (32 up to S 512), of 32 above S 512, of 256, and
# of 384 and wider; the backward's dK/dV (kernel 8) and dQ (kernel 9) at
# heads of 32 and 64, and at 128 and wider
encoder_flash_attention.launches = 0
encoder_flash_attention.launches_long = 0
encoder_flash_attention.launches_wide = 0
encoder_flash_attention.launches_slab = 0
encoder_flash_attention.launches_bwd_dkv = 0
encoder_flash_attention.launches_bwd_dq = 0
encoder_flash_attention.launches_bwd_wide_dkv = 0
encoder_flash_attention.launches_bwd_wide_dq = 0
_launch_lock = threading.Lock()
