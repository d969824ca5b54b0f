"""Encoder self-attention for short-sequence BERTs.

Port of ``financial_rag_system_tpu/ops/attention.py``.  The cross-encoder
rerank over (query, 1000-character chunk) pairs of about 400 tokens is
attention-traffic bound when the (pairs, heads, S, S) scores go through
device memory; the kernel keeps them on chip.

- :func:`encoder_self_attention` is the entry point, with the JAX
  signature and layout: (B, S, H, D) q/k/v and a (B, S) key mask in,
  (B, S, H*D) f32 context out.  On a CUDA tensor it launches the
  hand-written Hopper kernel ``csrc/pair_attention.cu``, or raises; on a
  CPU tensor it runs :func:`encoder_self_attention_plain`.  Heads of 32
  take the persistent kernel (TMA-staged K and V, ``wgmma`` products, exp
  as ``ex2.approx``, no work past a pair's last valid key); heads of any
  other multiple of 16 up to 128 (BERT-base and -large: 64) take the
  streaming kernel of the same file, templated on the head width, which
  stages K and V in 64-key chunks and keeps the same two sweeps and
  arithmetic.  Any other head width up to 128 (JAX's gate sends every
  d <= 128 to its kernel) is padded with zero columns to the next
  multiple of 16 after q is scaled by the true 1/sqrt(d), and the
  context is sliced back to d: zero columns add nothing to QK^T, and the
  padded V columns are dropped, so the padding is exact.
- :func:`encoder_self_attention_plain` is the same arithmetic in plain
  PyTorch: q pre-scaled in f32 then rounded to bf16, bf16 x bf16 logits
  summed in f32 plus a -1e9 key-padding bias, a full-row f32 softmax,
  probs rounded to bf16 for P.V with f32 sums, the 1/sum divide after
  P.V, and a bf16 context.

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

import torch

from financial_rag_system_tpu_torch.ops import _cuda

# head widths the kernels take: 32 (the persistent kernel), the rest the
# streaming kernel (pair_attention_wide); encoder_self_attention pads any
# other width up to MAX_HEAD_DIM to the next of them
HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
MAX_HEAD_DIM = HEAD_DIMS[-1]
MAX_SEQ = 512
NEG = -1e9


def _scaled_inputs(q, k, v, inv_sqrt):
    """q pre-scaled in f32 then rounded to bf16 (one multiply on the small
    (B, S, H, D) tensor instead of the (B, H, S, S) logits); k and v bf16."""
    qs = (q.float() * inv_sqrt).to(torch.bfloat16)
    return qs, k.to(torch.bfloat16), v.to(torch.bfloat16)


def kernel_inputs(q, k, v, inv_sqrt):
    """The kernels' contiguous bf16 q, k and v: q scaled by the true d's
    1/sqrt(d) first, then all three padded with zero columns to the next
    multiple of 16 (no copy of the padding when d is one)."""
    pad = -q.shape[-1] % 16
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


def _kernel_fn(head_dim: int):
    lib = _cuda.library("pair_attention")
    fn = lib.pair_attention if head_dim == 32 else lib.pair_attention_wide
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
    take."""
    b, s, h, d = qs.shape
    if d not in HEAD_DIMS or not 1 <= s <= MAX_SEQ:
        raise ValueError(
            f"pair attention takes head_dim in {HEAD_DIMS} and 1 <= S <= "
            f"{MAX_SEQ}; got head_dim {d}, S {s}"
        )
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
        _kernel_fn(d)(
            qs.data_ptr(), kb.data_ptr(), vb.data_ptr(), mask.data_ptr(),
            out.data_ptr(), b, s, h, d, stream,
        ),
        "pair_attention",
    )
    with _launch_lock:  # batches run in worker threads
        encoder_self_attention.launches += 1
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
    tensor, the plain version for a CPU tensor; nothing else."""
    if q.device.type == "cpu":
        return encoder_self_attention_plain(q, k, v, attention_mask, inv_sqrt, out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, s, h, d = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q {tuple(q.shape)}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"pair attention takes head_dim <= {MAX_HEAD_DIM}; got head_dim {d}")
    qs, kb, vb = kernel_inputs(q, k, v, inv_sqrt)
    out = pair_attention_kernel(qs, kb, vb, attention_mask.to(torch.int32).contiguous())
    return out[..., :d].reshape(b, s, h * d).to(out_dtype)


# kernel launches since the last reset (chip_smoke.py reads and resets it)
encoder_self_attention.launches = 0
_launch_lock = threading.Lock()
