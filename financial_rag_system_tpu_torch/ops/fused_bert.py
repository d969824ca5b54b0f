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
import threading

import torch
import torch.nn.functional as F

from financial_rag_system_tpu_torch.ops import _cuda

MAX_HIDDEN = 512
WIDTH_STEP = 64  # H and I must be multiples of it (the kernels' 64-wide pieces)


def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16(x) bf16(w)^T summed in f32, plus b."""
    return _bf(x) @ _bf(w).t() + b.float()


def _layer_norm(v: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    mu = v.mean(dim=-1, keepdim=True)
    var = ((v - mu) ** 2).mean(dim=-1, keepdim=True)
    return (v - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def fused_qkv_plain(x, wq, bq, wk, bk, wv, bv):
    """Plain PyTorch version of :func:`fused_qkv`."""
    return tuple(_dense(x, w, b) for w, b in ((wq, bq), (wk, bk), (wv, bv)))


def fused_resid_ln_plain(x, ctx, w, b, ln_scale, ln_bias, eps: float):
    """Plain PyTorch version of :func:`fused_resid_ln`."""
    return _layer_norm(x.float() + _dense(ctx, w, b), ln_scale, ln_bias, eps)


def fused_ffn_ln_plain(x, w_in, b_in, w_out, b_out, ln_scale, ln_bias, eps: float):
    """Plain PyTorch version of :func:`fused_ffn_ln`."""
    x = x.float()
    up = F.gelu(_dense(x, w_in, b_in), approximate="tanh")
    return _layer_norm(x + _dense(up, w_out, b_out), ln_scale, ln_bias, eps)


def _library():
    lib = _cuda.library("fused_bert")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_qkv.argtypes = [p] * 10 + [i, i, p]
    lib.fused_resid_ln.argtypes = [p, p, i, p, p, p, p, ctypes.c_float, p, i, i, p]
    lib.fused_ffn_ln.argtypes = [p] * 7 + [ctypes.c_float, p, i, i, i, p]
    for fn in (lib.fused_qkv, lib.fused_resid_ln, lib.fused_ffn_ln):
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


def _operand(t: torch.Tensor, shape: tuple, dtype: torch.dtype, device, name: str):
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}; got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")
    return t.to(dtype).contiguous()


def _launch(fn, name: str, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    _cuda.check(fn(*args, stream), name)


def _count(fn) -> None:
    with _launch_lock:  # batches run in worker threads
        fn.launches += 1


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return False


def fused_qkv(x, wq, bq, wk, bk, wv, bv):
    """(q, k, v), each (R, H) f32.  The kernel for a CUDA tensor, the
    plain version for a CPU tensor; nothing else."""
    if _on_cpu(x):
        return fused_qkv_plain(x, wq, bq, wk, bk, wv, bv)
    xf, r, h = _rows(x)
    bf, f32, dev = torch.bfloat16, torch.float32, xf.device
    ops = []
    for tag, w, b in (("q", wq, bq), ("k", wk, bk), ("v", wv, bv)):
        ops += [_operand(w, (h, h), bf, dev, f"w{tag}"), _operand(b, (h,), f32, dev, f"b{tag}")]
    q, k, v = (torch.empty((r, h), dtype=f32, device=dev) for _ in range(3))
    with torch.cuda.device(dev):
        _launch(_library().fused_qkv, "fused_qkv", xf.data_ptr(),
                *(t.data_ptr() for t in ops), q.data_ptr(), k.data_ptr(), v.data_ptr(), r, h)
    _count(fused_qkv)
    return q, k, v


def fused_resid_ln(x, ctx, w, b, ln_scale, ln_bias, eps: float):
    """LN(x + ctx W^T + b): (R, H) f32.  ``ctx`` may be f32 or bf16 (the
    kernel rounds it to bf16 either way)."""
    if _on_cpu(x):
        return fused_resid_ln_plain(x, ctx, w, b, ln_scale, ln_bias, eps)
    xf, r, h = _rows(x)
    bf, f32, dev = torch.bfloat16, torch.float32, xf.device
    ctx_bf16 = ctx.dtype == bf
    c = _operand(ctx, (r, h), bf if ctx_bf16 else f32, dev, "ctx")
    ops = [_operand(w, (h, h), bf, dev, "w")] + [
        _operand(t, (h,), f32, dev, n) for t, n in ((b, "b"), (ln_scale, "ln_scale"),
                                                    (ln_bias, "ln_bias"))
    ]
    y = torch.empty((r, h), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        _launch(_library().fused_resid_ln, "fused_resid_ln", xf.data_ptr(), c.data_ptr(),
                int(ctx_bf16), *(t.data_ptr() for t in ops), float(eps), y.data_ptr(), r, h)
    _count(fused_resid_ln)
    return y


def fused_ffn_ln(x, w_in, b_in, w_out, b_out, ln_scale, ln_bias, eps: float):
    """LN(x + gelu_tanh(x W_in^T + b_in) W_out^T + b_out): (R, H) f32."""
    if _on_cpu(x):
        return fused_ffn_ln_plain(x, w_in, b_in, w_out, b_out, ln_scale, ln_bias, eps)
    xf, r, h = _rows(x)
    i = w_in.shape[0]
    _check_width("I", i)
    bf, f32, dev = torch.bfloat16, torch.float32, xf.device
    ops = [
        _operand(w_in, (i, h), bf, dev, "w_in"), _operand(b_in, (i,), f32, dev, "b_in"),
        _operand(w_out, (h, i), bf, dev, "w_out"), _operand(b_out, (h,), f32, dev, "b_out"),
        _operand(ln_scale, (h,), f32, dev, "ln_scale"), _operand(ln_bias, (h,), f32, dev, "ln_bias"),
    ]
    y = torch.empty((r, h), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        _launch(_library().fused_ffn_ln, "fused_ffn_ln", xf.data_ptr(),
                *(t.data_ptr() for t in ops), float(eps), y.data_ptr(), r, h, i)
    _count(fused_ffn_ln)
    return y


# kernel launches since the last reset (chip_smoke.py reads and resets them)
fused_qkv.launches = 0
fused_resid_ln.launches = 0
fused_ffn_ln.launches = 0
_launch_lock = threading.Lock()
