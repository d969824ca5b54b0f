"""Fused encoder-block kernels: QKV, o-proj + LayerNorm, FFN + LayerNorm.

Port of ``financial_rag_system_tpu/ops/fused_bert.py``.  Each function
makes one pass over the (R, H) activation instead of the unfused layer's
chain of dense products and f32 elementwise passes (bias adds, casts,
GELU, residual adds, layernorm), and the FFN's (R, I) activation never
reaches device memory:

- :func:`fused_qkv`:      q, k, v = x W{q,k,v}^T + b{q,k,v}
- :func:`fused_resid_ln`: y = LN(x + ctx W_o^T + b_o)
- :func:`fused_ffn_ln`:   y = LN(x + gelu_tanh(x W_in^T + b_in) W_out^T + b_out)

Arguments follow the JAX functions' order, with (R, H) activations,
``nn.Linear`` weights (out, in) and an ``eps`` float.  On a CUDA tensor
each launches its hand-written kernel in ``csrc/fused_bert.cu`` (or
raises); on a CPU tensor it runs its ``*_plain`` twin, the same
arithmetic in plain PyTorch: operands rounded to bf16 and multiplied as
f32 (exact for each product), f32 sums, bias, tanh GELU with its output
rounded to bf16 for the second product, and a two-pass f32 layernorm.
A bf16 activation is widened to f32 exactly, as the TPU kernels do with
``astype(f32)``; outputs are f32.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F

from financial_rag_system_tpu_torch.ops import _cuda

MAX_HIDDEN = 512
WIDTH_STEP = 64  # H and I must be multiples of it (the kernels' 64-wide pieces)

# the QKV kernel's tile plan (csrc/fused_bert.cu qkv_kernel)
SMEM_LIMIT = 232_448          # shared memory a block may use on the H100
QKV_ROWS = 64                 # rows of a tile: one wgmma M
QKV_BOX_BYTES = QKV_ROWS * 32 * 4  # one x or output box: 64 rows x 32 f32
QKV_SLICE_WIDTHS = (192, 128, 64)  # wgmma N widths the kernel is built for
QKV_CONSUMERS = 2  # consumer warpgroups, each with an output box for its TMA stores

# the FFN kernel's plan (csrc/fused_bert.cu ffn_ln_kernel)
FFN_X_BOX = 8192      # an f32 x box: 64 rows x 32
FFN_WIDE = 384        # widest H whose 64 x H f32 accumulator a warpgroup holds (H / 2 registers)
FFN_MAX_RING = 8      # weight pieces in flight, at most

# the o-proj kernel's plan (csrc/fused_bert.cu resid_ln_kernel)
RESID_ROWS = 64           # rows of a tile: one wgmma M
RESID_STAGE = 8192        # a ctx stage: 64 rows x 128 B
RESID_MAX_STAGES = 8      # ctx stages a consumer warpgroup, at most
RESID_MAX_CLUSTER = 8     # blocks a cluster, at most (the portable limit)
RESID_MAX_SLICE = 96      # output columns a block: two 64 x N f32 accumulators a thread fit
RESID_XCHG = 4            # row-sum exchange buffers a consumer warpgroup
RESID_XTILES = 1          # x tiles (64 x N f32) a consumer warpgroup


def ffn_chunk(rows: int) -> int:
    """I columns of the FFN kernel's chunks: 32 with row tiles of 128, 64
    with tiles of 64 (H split)."""
    return 32 if rows == 128 else 64


def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16(x) bf16(w)^T summed in f32, plus b."""
    return _bf(x) @ _bf(w).t() + b.float()


def _layer_norm(v: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """f32 layernorm, the unfused layer's (``models/bert.py _ln``), so the
    plain versions compute the unfused layer's function bit for bit."""
    return F.layer_norm(v, (v.shape[-1],), scale.float(), bias.float(), eps)


def fused_qkv_plain(x, wq, bq, wk, bk, wv, bv):
    """Plain PyTorch version of :func:`fused_qkv`."""
    return tuple(_dense(x, w, b) for w, b in ((wq, bq), (wk, bk), (wv, bv)))


def pack_qkv(wq, bq, wk, bk, wv, bv) -> tuple[torch.Tensor, torch.Tensor]:
    """The QKV kernel's operands: W_q, W_k and W_v stacked into one (3H, H)
    bf16 weight, and their biases into one (3H,) f32 bias."""
    w = torch.cat([wq, wk, wv]).to(torch.bfloat16).contiguous()
    return w, torch.cat([bq, bk, bv]).float().contiguous()


class QKVPlan(NamedTuple):
    bn: int      # output columns of a slice; a slice lies inside one of q, k, v
    slices: int  # 3H / bn
    stages: int  # x boxes in flight, half in each consumer warpgroup's ring
    ctas: int    # persistent blocks: a multiple of slices
    smem: int    # bytes of dynamic shared memory a block takes


@functools.lru_cache(maxsize=256)
def qkv_plan(h: int, r: int, sms: int) -> QKVPlan:
    """The tile plan of the QKV kernel for an (r, h) activation on a card
    with ``sms`` multiprocessors: the widest slice whose bf16 weights leave
    room for the consumers' output boxes and at least four x boxes, as
    many x boxes as fit (an even number), and one block a multiprocessor,
    each slice taking the same number of blocks, never more than there are
    row tiles."""
    def stages(bn: int) -> int:  # even: the two consumer warpgroups' rings
        room = SMEM_LIMIT - 1024 - 8 - bn * h * 2 - QKV_CONSUMERS * QKV_BOX_BYTES
        return room // (QKV_BOX_BYTES + 16) // 2 * 2

    bn = next(n for n in QKV_SLICE_WIDTHS if h % n == 0 and stages(n) >= 4)
    slices, n_stages = 3 * h // bn, stages(bn)
    ctas = slices * max(1, min(sms // slices, -(-r // QKV_ROWS)))
    smem = (1024 + bn * h * 2 + (n_stages + QKV_CONSUMERS) * QKV_BOX_BYTES
            + (2 * n_stages + 1) * 8)
    return QKVPlan(bn, slices, n_stages, ctas, smem)


def ffn_smem(h: int, rows: int, ring: int, stages: int) -> int:
    """Bytes of dynamic shared memory the FFN kernel takes (``ffn_smem`` in
    ``csrc/fused_bert.cu``): alignment, the bf16 x tile, the weight ring,
    both consumer warpgroups' f32 x slots, two 8 KB buffers (GEMM1's sums
    over the first half of K with 128-row tiles, the up tiles with H
    split), the H split's row sums, the barriers and the ticket's flag."""
    chunk = ffn_chunk(rows)
    slots = rows // chunk + ring  # the I split's reduction parts in flight
    buffers = 2 * 8192 + (1024 if rows == 64 else 0)
    return (1024 + rows * h * 2 + ring * chunk * h * 2 + 2 * stages * FFN_X_BOX + buffers
            + 8 * (ring * (h // 64) + ring + 4 * stages + 2 * slots) + 16)


class FFNPlan(NamedTuple):
    rows: int       # rows of a tile: 128 (each consumer warpgroup 64 rows x all H) or 64 (H split)
    tiles: int      # row tiles
    splits: int     # blocks a tile's I is split over (1: none)
    ctas: int       # blocks: tiles x splits with a split, else persistent, one an SM at most
    ring: int       # weight pieces (a chunk's rows of W_in or columns of W_out) in flight
    stages: int     # f32 x boxes (64 rows x 32) in flight for each consumer warpgroup
    smem: int       # bytes of dynamic shared memory a block takes
    workspace: int  # f32 values of the split's partial sums (0 without one)


@functools.lru_cache(maxsize=256)
def ffn_plan(h: int, i: int, r: int, sms: int) -> FFNPlan:
    """The plan of the FFN kernel for an (r, h) activation and I = ``i`` on
    a card with ``sms`` multiprocessors.  Tiles of 128 rows where a
    warpgroup's 64 x H f32 accumulator fits in registers (H <= 384; I in
    chunks of 32), else 64 rows with the two warpgroups splitting H (chunks
    of 64); at H 384 also 64 where 128-row tiles would be too few to fill
    the card without splitting I (the embed shape: a tile's partial sums
    are then half as large, and the kernel twice as fast).  Two x slots a
    warpgroup where they fit beside two weight pieces, and as many pieces
    as fit.  With fewer tiles than multiprocessors, I is split over as many
    blocks a tile as fill the card, each a whole number of chunks; the
    blocks store partial sums (splits x tiles x rows x H f32) and the last
    of a tile sums them.  The kernel is compiled for these plans and checks
    them."""
    rows = 128 if h <= FFN_WIDE else 64
    if h == FFN_WIDE and 2 * -(-r // 128) <= sms:
        rows = 64  # the 128-row plan would split I
    return _ffn_plan_rows(h, i, r, sms, rows)


def _ffn_plan_rows(h: int, i: int, r: int, sms: int, rows: int) -> FFNPlan:
    """:func:`ffn_plan`'s plan with tiles of ``rows`` (at H 384 either
    plan runs: the variants tool compares the two)."""
    stages = 2 if ffn_smem(h, rows, 2, 2) <= SMEM_LIMIT else 1
    ring = max(n for n in range(FFN_MAX_RING + 1) if ffn_smem(h, rows, n, stages) <= SMEM_LIMIT)
    tiles = -(-r // rows)
    splits = max(1, min(i // ffn_chunk(rows), sms // tiles))
    ctas = tiles * splits if splits > 1 else min(tiles, sms)
    workspace = splits * tiles * rows * h if splits > 1 else 0
    return FFNPlan(rows, tiles, splits, ctas, ring, stages, ffn_smem(h, rows, ring, stages),
                   workspace)


def resid_smem(h: int, n: int, ctx_bf16: bool, stages: int) -> int:
    """Bytes of dynamic shared memory the o-proj kernel takes (``resid_smem``
    in ``csrc/fused_bert.cu``): alignment, the N x H bf16 W_o slice, two
    consumer warpgroups' ctx rings, with an f32 ctx a conversion box each,
    their x tiles (64 x N f32), the row sums the cluster exchanges (four
    buffers a warpgroup) and the barriers."""
    cluster = h // n
    return (1024 + n * h * 2 + 2 * stages * RESID_STAGE + (0 if ctx_bf16 else 2 * RESID_STAGE)
            + 2 * RESID_XTILES * RESID_ROWS * n * 4 + 2 * RESID_XCHG * cluster * RESID_ROWS * 4
            + 8 * (1 + 4 * stages + 4 * RESID_XTILES + 2 * RESID_XCHG))


def _resid_stages(h: int, cluster: int, ctx_bf16: bool) -> int:
    """ctx stages a warpgroup of the o-proj kernel takes with clusters of
    ``cluster`` blocks (as many as fit, up to RESID_MAX_STAGES), or 0 where
    its slice is no multiple of 16 up to RESID_MAX_SLICE wide or two stages
    do not fit."""
    n = h // cluster
    if h % cluster or n > RESID_MAX_SLICE or n % 16:
        return 0
    return max((s for s in range(2, RESID_MAX_STAGES + 1)
                if resid_smem(h, n, ctx_bf16, s) <= SMEM_LIMIT), default=0)


class ResidPlan(NamedTuple):
    cluster: int  # blocks of a cluster; each owns H / cluster output columns
    rows: int     # rows of a tile
    tiles: int    # row tiles; a cluster walks tile id, + clusters, ...
    ctas: int     # blocks: a multiple of the cluster, at most a cluster a tile and a block an SM
    stages: int   # ctx stages (8 KB) of each consumer warpgroup's ring
    smem: int     # bytes of dynamic shared memory a block takes


@functools.lru_cache(maxsize=256)
def resid_plan(h: int, r: int, sms: int, ctx_bf16: bool) -> ResidPlan:
    """The plan of the o-proj kernel for an (r, h) activation on a card
    with ``sms`` multiprocessors and a bf16 (or f32) context: the smallest
    cluster whose blocks' W_o slices (H / cluster columns, a multiple of 16
    up to 96), x tiles and two ctx stages fit (H 384: 4 blocks of 96
    columns; H 448: 7 of 64), as many stages as fit, then one cluster a
    tile, up to a block an SM.  The kernel is compiled for these plans and
    checks them, and runs at most as many clusters as the card holds at
    once."""
    tiles = -(-r // RESID_ROWS)
    cluster = next(c for c in range(1, RESID_MAX_CLUSTER + 1) if _resid_stages(h, c, ctx_bf16))
    stages = _resid_stages(h, cluster, ctx_bf16)
    return ResidPlan(cluster, RESID_ROWS, tiles, cluster * min(tiles, sms // cluster), stages,
                     resid_smem(h, h // cluster, ctx_bf16, stages))


class ResidPack(NamedTuple):
    """W_o and b_o as the o-proj kernel takes them: the (H, H) bf16 weight,
    the (H,) f32 bias, and W_o's tensor maps, encoded on the card once for
    each cluster size a plan asks for (:meth:`wmap`)."""
    w: torch.Tensor
    b: torch.Tensor
    maps: dict

    def wmap(self, cluster: int) -> int:
        """The address of W_o's tensor map for clusters of ``cluster``
        blocks (host memory, 128 bytes, kept by the pack), encoded at first
        use; of two threads that encode it at once, both get the one kept."""
        m = self.maps.get(cluster)
        if m is None:
            new = ctypes.create_string_buffer(128)
            _cuda.check(_library().resid_ln_wmap(self.w.data_ptr(), self.w.shape[0], cluster,
                                                 new), "resid_ln_wmap")
            m = self.maps.setdefault(cluster, new)
        return ctypes.addressof(m)


def pack_resid(w, b) -> ResidPack:
    """The o-proj kernel's operands: W_o (H, H) as a contiguous bf16 weight
    at a 16-byte-aligned address, b_o (H,) as an f32 vector, on W_o's
    device."""
    h = w.shape[0]
    if w.dim() != 2 or w.shape[1] != h or tuple(b.shape) != (h,) or b.device != w.device:
        raise ValueError(f"W_o must be (H, H) and b_o (H,) on one device; got "
                         f"{tuple(w.shape)} on {w.device}, {tuple(b.shape)} on {b.device}")
    wb = _aligned(w.to(torch.bfloat16).contiguous())
    return ResidPack(wb, b.float().contiguous(), {})


def fused_resid_ln_plain(x, ctx, w, b, ln_scale, ln_bias, eps: float):
    """Plain PyTorch version of :func:`fused_resid_ln`."""
    return _layer_norm(x.float() + _dense(ctx, w, b), ln_scale, ln_bias, eps)


def fused_ffn_ln_plain(x, w_in, b_in, w_out, b_out, ln_scale, ln_bias, eps: float):
    """Plain PyTorch version of :func:`fused_ffn_ln`."""
    x = x.float()
    up = F.gelu(_dense(x, w_in, b_in), approximate="tanh")
    return _layer_norm(x + _dense(up, w_out, b_out), ln_scale, ln_bias, eps)


@functools.cache
def _library():
    lib = _cuda.library("fused_bert")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_qkv.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.fused_resid_ln.argtypes = [p, i, p, i] + [p] * 4 + [ctypes.c_float, p] + [i] * 5 + [p]
    lib.resid_ln_wmap.argtypes = [p, i, i, p]
    lib.resid_ln_clusters.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.fused_ffn_ln.argtypes = [p] * 7 + [ctypes.c_float, p] + [i] * 8 + [p, p, p]
    for fn in (lib.fused_qkv, lib.fused_resid_ln, lib.resid_ln_wmap, lib.resid_ln_clusters,
               lib.fused_ffn_ln):
        fn.restype = ctypes.c_int
    return lib


def _check_width(name: str, n: int) -> None:
    if n < WIDTH_STEP or n % WIDTH_STEP:
        raise ValueError(f"the fused-block kernels take {name} a multiple of "
                         f"{WIDTH_STEP}; got {n}")


def _rows(x: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    """x as a contiguous (R, H) f32 CUDA tensor the kernels take."""
    if x.dim() != 2:
        raise ValueError(f"x must be (R, H); got {tuple(x.shape)}")
    r, h = x.shape
    _check_width("H", h)
    if h > MAX_HIDDEN or r < 1:
        raise ValueError(f"the fused-block kernels take H <= {MAX_HIDDEN} and R >= 1; "
                         f"got R {r}, H {h}")
    return x.float().contiguous(), r, h


def _check(t: torch.Tensor, shape: tuple, device, name: str) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}; got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")


def _operand(t: torch.Tensor, shape: tuple, dtype: torch.dtype, device, name: str):
    _check(t, shape, device, name)
    return t.to(dtype).contiguous()


def _count(fn) -> None:
    with _launch_lock:  # batches run in worker threads
        fn.launches += 1


def _on_cpu(x: torch.Tensor, what: str, *operands) -> bool:
    """Whether ``x`` is a CPU tensor (the plain version runs); for a CUDA
    one, refuse operands that require grad (the kernels have no backward,
    ``_cuda.refuse_grad``)."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _cuda.refuse_grad(what, x, *operands)
    return False


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` at a 16-byte-aligned address, as TMA reads it."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_qkv(x, wq, bq, wk, bk, wv, bv, packed=None):
    """(q, k, v), each (R, H) f32 (on the card, views of one (3, R, H)
    tensor).  The kernel for a CUDA tensor, the plain version for a CPU
    tensor; nothing else.  ``packed`` is
    :func:`pack_qkv` of these weights, made once by a caller that keeps
    it (``BertLayer.qkv_pack``); without it each call packs them."""
    if _on_cpu(x, "fused_qkv", wq, bq, wk, bk, wv, bv):
        if packed is None:
            return fused_qkv_plain(x, wq, bq, wk, bk, wv, bv)
        h = x.shape[-1]
        w, b = packed
        return fused_qkv_plain(x, *(t for i in range(3) for t in (w[i * h:(i + 1) * h],
                                                                 b[i * h:(i + 1) * h])))
    xf, r, h = _rows(x)
    dev = xf.device
    if packed is None:
        for name, t in zip(("wq", "bq", "wk", "bk", "wv", "bv"), (wq, bq, wk, bk, wv, bv)):
            _check(t, (h, h) if name[0] == "w" else (h,), dev, name)
        packed = pack_qkv(wq, bq, wk, bk, wv, bv)
    w, b = packed
    if not (w.dtype == torch.bfloat16 and b.dtype == torch.float32 and w.shape == (3 * h, h)
            and b.shape == (3 * h,) and w.device == dev and b.device == dev
            and w.is_contiguous() and b.is_contiguous() and w.data_ptr() % 16 == 0):
        raise ValueError("packed must be pack_qkv's (3H, H) bf16 weight and (3H,) f32 bias "
                         f"on {dev}")
    xf = _aligned(xf)
    plan = qkv_plan(h, r, _cuda.sm_count(dev))
    out = torch.empty((3, r, h), dtype=torch.float32, device=dev)
    with _cuda.on_device(dev):
        _cuda.launch(_library().fused_qkv, "fused_qkv", xf.data_ptr(), w.data_ptr(),
                     b.data_ptr(), out.data_ptr(), r, h, plan.bn, plan.stages, plan.ctas)
    _count(fused_qkv)
    return out.unbind(0)


def fused_resid_ln(x, ctx, w, b, ln_scale, ln_bias, eps: float, packed=None):
    """LN(x + ctx W^T + b): (R, H) f32.  ``x`` and ``ctx`` may be f32 or
    bf16: the kernel widens a bf16 x exactly and rounds ctx to bf16 either
    way.  ``packed`` is :func:`pack_resid` of ``w`` and ``b``, made once by
    a caller that keeps it (``BertLayer.o_pack``); without it each call
    packs them.  On the main path nothing is cast or copied: the kernel
    reads x, ctx and the layernorm's f32 vectors as they are."""
    if _on_cpu(x, "fused_resid_ln", ctx, w, b, ln_scale, ln_bias):
        if packed is not None:
            w, b = packed.w, packed.b
        return fused_resid_ln_plain(x, ctx, w, b, ln_scale, ln_bias, eps)
    if x.dim() != 2:
        raise ValueError(f"x must be (R, H); got {tuple(x.shape)}")
    r, h = x.shape
    _check_width("H", h)
    if h > MAX_HIDDEN or r < 1:
        raise ValueError(f"the fused-block kernels take H <= {MAX_HIDDEN} and R >= 1; "
                         f"got R {r}, H {h}")
    dev = x.device
    _check(ctx, (r, h), dev, "ctx")
    if packed is None:
        _check(w, (h, h), dev, "w")
        packed = pack_resid(w, b)
    elif packed.w.shape[0] != h or packed.w.device != dev:
        raise ValueError(f"packed must be pack_resid's (H, H) weight on {dev}")
    s, lb = (t if t.dtype == torch.float32 and t.is_contiguous() else t.float().contiguous()
             for t in (ln_scale, ln_bias))
    if s.shape != (h,) or lb.shape != (h,) or s.device != dev or lb.device != dev:
        raise ValueError(f"ln_scale and ln_bias must be ({h},) on {dev}")
    y = _resid_launch(_kernel_rows(x), _kernel_rows(ctx), packed, s, lb, eps,
                      resid_plan(h, r, _cuda.sm_count(dev), ctx.dtype == torch.bfloat16))
    _count(fused_resid_ln)
    return y


def _kernel_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the o-proj kernel reads it: f32 or bf16 (anything else as
    f32), contiguous, 16-byte aligned; ``t`` itself where it is."""
    if t.dtype not in (torch.float32, torch.bfloat16):
        t = t.float()
    return t if t.is_contiguous() and t.data_ptr() % 16 == 0 else _aligned(t.contiguous())


def _resid_launch(x, ctx, packed: ResidPack, ln_scale, ln_bias, eps: float,
                  plan: ResidPlan) -> torch.Tensor:
    """One launch of the o-proj kernel on ``plan``, on operands as the
    kernel takes them (contiguous, 16-byte aligned, x and ctx f32 or
    bf16)."""
    (r, h), dev = x.shape, x.device
    y = torch.empty((r, h), dtype=torch.float32, device=dev)
    with _cuda.on_device(dev):
        _cuda.launch(_library().fused_resid_ln, "fused_resid_ln", x.data_ptr(),
                     int(x.dtype == torch.bfloat16), ctx.data_ptr(),
                     int(ctx.dtype == torch.bfloat16), packed.wmap(plan.cluster),
                     packed.b.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), float(eps),
                     y.data_ptr(), r, h, plan.cluster, plan.stages, plan.ctas)
    return y


def fused_ffn_ln(x, w_in, b_in, w_out, b_out, ln_scale, ln_bias, eps: float):
    """LN(x + gelu_tanh(x W_in^T + b_in) W_out^T + b_out): (R, H) f32, by
    the kernel on :func:`ffn_plan`'s plan for a CUDA tensor, by the plain
    version for a CPU tensor."""
    if _on_cpu(x, "fused_ffn_ln", w_in, b_in, w_out, b_out, ln_scale, ln_bias):
        return fused_ffn_ln_plain(x, w_in, b_in, w_out, b_out, ln_scale, ln_bias, eps)
    xf, ops = _ffn_operands(x, w_in, b_in, w_out, b_out, ln_scale, ln_bias)
    r, h = xf.shape
    y = _ffn_launch(xf, ops, eps, ffn_plan(h, ops[0].shape[0], r, _cuda.sm_count(xf.device)))
    _count(fused_ffn_ln)
    return y


def _ffn_operands(x, w_in, b_in, w_out, b_out, ln_scale, ln_bias):
    """x as the kernel takes it, and its six other operands: bf16 weights,
    f32 vectors, all contiguous and 16-byte aligned on x's device."""
    xf, r, h = _rows(x)
    i = w_in.shape[0]
    _check_width("I", i)
    bf, f32, dev = torch.bfloat16, torch.float32, xf.device
    ops = [
        _operand(w_in, (i, h), bf, dev, "w_in"), _operand(b_in, (i,), f32, dev, "b_in"),
        _operand(w_out, (h, i), bf, dev, "w_out"), _operand(b_out, (h,), f32, dev, "b_out"),
        _operand(ln_scale, (h,), f32, dev, "ln_scale"), _operand(ln_bias, (h,), f32, dev, "ln_bias"),
    ]
    return _aligned(xf), [_aligned(t) for t in ops]


def _ffn_launch(xf, ops, eps: float, plan: FFNPlan) -> torch.Tensor:
    """One launch of the FFN kernel on ``plan``; a split plan's workspace
    is allocated here and its tickets are the stream's."""
    (r, h), i, dev = xf.shape, ops[0].shape[0], xf.device
    y = torch.empty((r, h), dtype=torch.float32, device=dev)
    with _cuda.on_device(dev):
        split = [None, None]  # the workspace and the tickets, held over the launch
        if plan.splits > 1:
            split = [torch.empty(plan.workspace, dtype=torch.float32, device=dev),
                     _tickets(dev, plan.tiles)]
        _cuda.launch(_library().fused_ffn_ln, "fused_ffn_ln", xf.data_ptr(),
                     *(t.data_ptr() for t in ops), float(eps), y.data_ptr(), r, h, i, plan.rows,
                     plan.splits, plan.ctas, plan.ring, plan.stages,
                     *(None if t is None else t.data_ptr() for t in split))
    return y


def _tickets(dev: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zero int32 tickets for the FFN kernel's split plan,
    one buffer a (device, stream): launches on one stream run in order, and
    each leaves its tickets zero for the next."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    with _launch_lock:
        t = _ticket_buffers.get(key)
        if t is None or t.numel() < n:
            t = torch.zeros(max(n, 64), dtype=torch.int32, device=dev)
            _ticket_buffers[key] = t
        return t


# kernel launches since the last reset (chip_smoke.py reads and resets them)
fused_qkv.launches = 0
fused_resid_ln.launches = 0
fused_ffn_ln.launches = 0
_launch_lock = threading.Lock()
_ticket_buffers: dict[tuple[int, int], torch.Tensor] = {}
