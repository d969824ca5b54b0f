"""BERT encoder — the forward pass behind both serving models.

Port of ``financial_rag_system_tpu/models/bert.py`` to a PyTorch
``nn.Module``: the 12-layer BGE-small bi-encoder and the 6-layer MiniLM
cross-encoder share it.  Numerics follow the JAX default path:

- dense products are bf16 x bf16 with f32 sums and no bf16 rounding of
  the result (:func:`_matmul`); on the card that is
  ``torch.mm(..., out_dtype=torch.float32)`` on the tensor cores, on the
  CPU the f32 product of bf16-rounded operands, exact for each product;
  TF32 is switched off so no f32 product on the card loses precision;
- activations, layernorm and softmax are f32;
- GELU follows the JAX package's rule (:func:`_fast_gelu`): by default
  the tanh form on the card and exact erf on the CPU;
  ``RAG_TPU_FAST_GELU=1`` forces tanh and ``0`` forces erf;
- attention follows the JAX gate (:func:`_pair_attn_enabled`) as it acts
  on the accelerator, on the card and the CPU alike: at S >= 256 (the
  rerank pairs) :func:`ops.attention.encoder_self_attention`, the CUDA
  kernel on the card and its plain version on the CPU; below it (the
  query embed) the JAX einsum path's arithmetic in plain PyTorch
  (:func:`_einsum_attention`);
- a forward that is being differentiated (:func:`_graded`: grad mode on
  and a parameter requires grad, as the trainers of :mod:`train` run it)
  takes the einsum attention at every length and the unfused layer, with
  one bf16 cast per projection and, on the card, a dense product whose
  backward gives JAX's cotangents (:class:`_BF16Product`) and embedding
  lookups whose backward sums in a fixed order (:class:`_Lookup`); the JAX
  kernels have no backward (see :func:`_pair_attn_enabled`).

Three opt-ins, each off by default, as in the JAX package:

- ``RAG_TPU_FUSED_BLOCK=1`` (on the card, unless ``RAG_TPU_FAST_GELU``
  forces erf, and for widths the kernels take): each layer runs the
  fused-block kernels of :mod:`ops.fused_bert` (QKV, o-proj + LN, FFN +
  LN) around the attention kernel; see :func:`_fused_block_enabled`;
- ``RAG_TPU_BF16_ACT=1``: activations between ops are stored as bf16
  (:func:`_act_dtype`);
- int8 weight-only PTQ of the six encoder weight stacks
  (:func:`quantize_params`; the reranker applies it under
  ``RAG_TPU_INT8_RERANK=1``).

Parameters are ``nn.Linear`` weights, (out, in); :func:`load_jax_params`
fills a model from the JAX package's pytree (layer stacks on axis 0,
weights (in, out)), its int8-PTQ form included; :func:`export_jax_params`
is its inverse.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from financial_rag_system_tpu_torch.ops.attention import NEG, encoder_self_attention
from financial_rag_system_tpu_torch.ops.fused_bert import (
    MAX_HIDDEN,
    WIDTH_STEP,
    ResidPack,
    fused_ffn_ln,
    fused_qkv,
    fused_resid_ln,
    pack_qkv,
    pack_resid,
)
from financial_rag_system_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 384
    layers: int = 12
    heads: int = 12
    intermediate: int = 1536
    max_positions: int = 512
    type_vocab: int = 2
    ln_eps: float = 1e-12
    # heads attached on top of the encoder
    with_pooler: bool = False
    num_labels: int = 0  # >0 => classification head (cross-encoder)
    # serving truncation hint: the sequence length the weights were
    # TRAINED at, when shorter than max_positions (None = no hint)
    max_seq_length: int | None = None


# BAAI/bge-small-en-v1.5 — 12-layer BERT-small, CLS pooling, dim 384
BGE_SMALL = BertConfig(layers=12, with_pooler=True)
# cross-encoder/ms-marco-MiniLM-L-6-v2 — 6 layers, single-logit classifier
MINILM_L6_CROSS = BertConfig(layers=6, with_pooler=True, num_labels=1)


def init_params(generator: torch.Generator, cfg: BertConfig) -> dict:
    """Random-init parameter tree in the JAX package's layout (layer
    weights stacked on axis 0, dense weights (in, out)), as f32 CPU
    tensors drawn from ``generator``: N(0, 0.02) weights, zero biases,
    unit layernorm scales.  Load it with :func:`load_jax_params`."""
    h, i, l = cfg.hidden, cfg.intermediate, cfg.layers

    def dense(*shape):
        return 0.02 * torch.randn(shape, generator=generator, dtype=torch.float32)

    p = {
        "embeddings": {
            "word": dense(cfg.vocab_size, h),
            "position": dense(cfg.max_positions, h),
            "type": dense(cfg.type_vocab, h),
            "ln_scale": torch.ones(h),
            "ln_bias": torch.zeros(h),
        },
        "layers": {
            "q_w": dense(l, h, h), "q_b": torch.zeros(l, h),
            "k_w": dense(l, h, h), "k_b": torch.zeros(l, h),
            "v_w": dense(l, h, h), "v_b": torch.zeros(l, h),
            "o_w": dense(l, h, h), "o_b": torch.zeros(l, h),
            "attn_ln_scale": torch.ones(l, h), "attn_ln_bias": torch.zeros(l, h),
            "in_w": dense(l, h, i), "in_b": torch.zeros(l, i),
            "out_w": dense(l, i, h), "out_b": torch.zeros(l, h),
            "mlp_ln_scale": torch.ones(l, h), "mlp_ln_bias": torch.zeros(l, h),
        },
    }
    if cfg.with_pooler:
        p["pooler"] = {"w": dense(h, h), "b": torch.zeros(h)}
    if cfg.num_labels:
        p["classifier"] = {"w": dense(h, cfg.num_labels), "b": torch.zeros(cfg.num_labels)}
    return p


def _env_on(name: str) -> bool:
    return os.environ.get(name, "auto").lower() in ("1", "true")


def _fast_gelu(device: torch.device) -> bool:
    """Whether GELU takes its tanh form on ``device``: the JAX package's
    ``RAG_TPU_FAST_GELU`` rule (``bert.py:259-268``), accelerator against
    CPU.  ``1`` or ``true`` forces tanh, ``0`` or ``false`` forces exact
    erf (HF BERT's); unset, ``auto`` or anything else is tanh on the
    accelerator (the card here) and erf on the CPU.  Unlike the attention
    gate (:func:`_pair_attn_enabled`), this one keeps JAX's platform test,
    because JAX's rule itself depends on the platform: the card computes
    what the JAX package serves on its accelerator, and the CPU what it
    computes on the CPU."""
    mode = os.environ.get("RAG_TPU_FAST_GELU", "auto").lower()
    if mode in ("0", "false"):
        return False
    if mode in ("1", "true"):
        return True
    return device.type == "cuda"


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU in the form :func:`_fast_gelu` picks for ``x``'s device."""
    return F.gelu(x, approximate="tanh" if _fast_gelu(x.device) else "none")


def _act_dtype() -> torch.dtype:
    """Inter-op activation dtype of the encoder stack: f32, or bf16 with
    RAG_TPU_BF16_ACT=1 (the JAX ``_act_dtype``).  Products still sum in
    f32 and layernorm and softmax still compute in f32; only the tensors
    handed between ops are stored as bf16, at the JAX package's points."""
    return torch.bfloat16 if _env_on("RAG_TPU_BF16_ACT") else torch.float32


def _pair_attn_enabled(seq: int, head_dim: int, graded: bool = False) -> bool:
    """Whether attention at this sequence length runs the pair-attention
    kernel's arithmetic (:func:`ops.attention.encoder_self_attention`) or
    the JAX einsum path's (:func:`_einsum_attention`), read once per
    :meth:`BertModel.encode`.  The JAX gate (``bert.py:129-157``) as it
    acts on the accelerator, without its platform test, so the port's CPU
    result is what its card computes:

    - ``RAG_TPU_PAIR_ATTN`` unset or ``auto``: the kernel at ``seq >= 256``
      (the rerank pairs, S about 400), the einsum below (the query embed,
      S <= 64);
    - ``0``, ``false`` or ``off``: never the kernel;
    - anything else (``1``): the kernel at every length;
    - never for a head wider than 128;
    - never in a graded forward (``graded``, :func:`_graded`): the kernel
      has no backward, in the port or in JAX, whose Pallas kernel under
      ``jax.grad`` raises ``ValueError: Linearization failed to produce
      known values for all output primals``.  The JAX trainers therefore
      run the einsum path (on the CPU, or with ``RAG_TPU_PAIR_ATTN=0``),
      and so does a graded forward here, at every length.
    """
    mode = os.environ.get("RAG_TPU_PAIR_ATTN", "auto").lower()
    if graded or mode in ("0", "false", "off") or head_dim > 128:
        return False
    return seq >= 256 if mode == "auto" else True


def _einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      attention_mask: torch.Tensor, inv_sqrt: float) -> torch.Tensor:
    """The JAX package's attention below the gate (``bert.py:412-429``),
    in plain PyTorch: (B, S, H, D) q, k, v and a (B, S) key mask in, the
    (B, S, H*D) f32 context out.  The logits are bf16-rounded q and k
    multiplied and summed in f32, times 1/sqrt(d), plus a -1e9 key-padding
    bias; the f32 softmax is normalised before its probabilities are
    rounded to bf16; P.V is summed in f32 and the context stays f32.  The
    operands are f32 tensors holding bf16 values, so each product is
    exact and nothing rounds the sums: a bf16 einsum on the card would
    return bf16 logits (and TF32 is off, ``BertModel.__init__``)."""
    b, s, h, d = q.shape
    qb, kb, vb = (t.to(torch.bfloat16).float() for t in (q, k, v))
    bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, NEG)
    logits = torch.einsum("bqhd,bkhd->bhqk", qb, kb) * inv_sqrt + bias
    probs = torch.softmax(logits, dim=-1).to(torch.bfloat16).float()
    return torch.einsum("bhqk,bkhd->bqhd", probs, vb).reshape(b, s, h * d)


def _fused_block_enabled(model: "BertModel") -> bool:
    """Gate of the fused encoder-block kernels (:mod:`ops.fused_bert`),
    read once per :meth:`BertModel.encode`.  The JAX gate's rules
    (``bert.py:191-222``), on this card:

    - ``RAG_TPU_FUSED_BLOCK`` is ``1`` or ``true``: an explicit opt-in
      (unset, ``auto``, ``0`` and ``false`` mean off);
    - ``RAG_TPU_FAST_GELU`` is not ``0`` or ``false``: the kernels bake
      the tanh GELU in, which is the card's default (:func:`_fast_gelu`),
      so the fused branch engages only where the unfused layer computes
      tanh too.  The opt-in never changes the function, only how it runs;
    - no layer holds int8-PTQ weights (the kernels take bf16 weights; the
      per-channel dequant is not plumbed through them);
    - the model is on the card: on the CPU the unfused layer runs;
    - and one rule of the port's own, which the JAX gate does not have:
      the hidden width is at most ``ops.fused_bert.MAX_HIDDEN`` (512) and
      the hidden and intermediate widths are multiples of
      ``WIDTH_STEP`` (64), the widths the kernels are built for.  A wider
      model (BERT-base, 768) runs the unfused layer under the opt-in,
      which computes the same function.

    :meth:`BertModel.encode` never asks it in a graded forward
    (:func:`_graded`): kernels 4-6 have no backward, and neither have
    JAX's (``jax.grad`` through its fused block fails with ``Linearization
    failed``, as through the attention kernel, :func:`_pair_attn_enabled`),
    so a trainer's forward takes the unfused layer, the one JAX's trainers
    differentiate.
    """
    h, i = model.cfg.hidden, model.cfg.intermediate
    return (
        _env_on("RAG_TPU_FUSED_BLOCK")
        and model.device.type == "cuda"
        and _fast_gelu(model.device)
        and not model.quantized
        and h <= MAX_HIDDEN and h % WIDTH_STEP == 0 and i % WIDTH_STEP == 0
    )


def _graded(model: "BertModel") -> bool:
    """Whether ``model``'s forward is being differentiated: grad mode is
    on and a parameter requires grad (the trainers' steps,
    :func:`train.optim.graded`).  Serving runs with no parameter requiring
    grad (``BertModel.__init__``), under ``torch.inference_mode`` on the
    fused paths."""
    return torch.is_grad_enabled() and any(p.requires_grad for p in model.parameters())


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), scale, bias, eps)


class _BF16Product(torch.autograd.Function):
    """(M, K) bf16 x times the (N, K) bf16 weight's transpose, summed in
    f32 on the card's tensor cores (``torch.mm(..., out_dtype=f32)``, which
    has no derivative of its own), with the cotangents JAX's
    ``dot_general`` transpose gives a bf16 x bf16 -> f32 product:
    ``dx = g W`` and ``dW = g^T x`` as f32 products (TF32 is off,
    ``BertModel.__init__``), each rounded to bf16, the operand's dtype;
    the casts' own backward widens them to f32 again.  On the CPU the f32
    product of bf16-rounded operands rounds at the same points through the
    casts' backward, so it needs no such function."""

    @staticmethod
    def forward(ctx, x2: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x2, wb)
        return torch.mm(x2, wb.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x2, wb = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(g, wb.float()).to(torch.bfloat16)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(g.t(), x2.float()).to(torch.bfloat16)
        return dx, dw


ONE_HOT_ROWS = 16  # a table this small takes its lookup's gradient as a product


class _Lookup(torch.autograd.Function):
    """``F.embedding`` with a backward that adds each row's gradients in a
    fixed order.  On the card ``F.embedding``'s own backward sums a row in
    a varying order once its id repeats thousands of times: the token-type
    table's gradient over a (32, 512) pair batch came out 20 ways in 20
    runs on an H100, so two runs of the cross-encoder trainer from the
    same weights parted after their first step.  Here a table of at most
    ``ONE_HOT_ROWS`` rows (the token types) takes ``one_hot(ids)^T @ g``,
    one f32 product; a larger one (the words) ``index_put_`` with
    accumulate, which sorts the ids and sums each one's rows in turn (for
    the type table that serial sum cost 10 ms a cross-encoder step)."""

    @staticmethod
    def forward(ctx, ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (ids,) = ctx.saved_tensors
        ids, g = ids.reshape(-1), g.reshape(-1, g.shape[-1])
        if ctx.rows <= ONE_HOT_ROWS:
            return None, F.one_hot(ids, ctx.rows).to(g.dtype).t() @ g
        return None, g.new_zeros(ctx.rows, g.shape[1]).index_put_((ids,), g, accumulate=True)


def _embedding(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``ids``: :class:`_Lookup` when a graded forward
    on the card differentiates ``table``, else ``F.embedding``, which
    gathers what indexing does and whose backward adds the rows'
    gradients in a fixed order on the CPU (indexing's and ``index_put_``'s
    do not there)."""
    if table.is_cuda and torch.is_grad_enabled() and table.requires_grad:
        return _Lookup.apply(ids, table)
    return F.embedding(ids, table)


def _matmul(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """bf16 x bf16 -> f32, plus bias.  ``w`` is an ``nn.Linear`` weight
    (out, in).  No bf16 rounding of the product (see the module note)."""
    x2 = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
    wb = w.to(torch.bfloat16)
    if x2.is_cuda and torch.is_grad_enabled() and (x2.requires_grad or wb.requires_grad):
        y = _BF16Product.apply(x2, wb)
    elif x2.is_cuda:
        y = torch.mm(x2, wb.t(), out_dtype=torch.float32)
    else:
        y = x2.float() @ wb.float().t()
    y = y.reshape(*x.shape[:-1], w.shape[0])
    return y if b is None else y + b


# --- int8 post-training quantization (opt-in serving path) -----------------

_QUANT_LINEARS = ("q", "k", "v", "o", "inter", "out")
_QUANT_KEYS = ("q_w", "k_w", "v_w", "o_w", "in_w", "out_w")  # their JAX names
_SCALE_SUFFIX = "__scale"


def _matmul_q(x: torch.Tensor, w_q: torch.Tensor, s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Weight-only int8 product: the int8 weight widened to bf16 (exact),
    the bf16 product summed in f32, then the per-output-channel scale and
    the bias (JAX ``_matmul_q``)."""
    return _matmul(x, w_q, None) * s + b


def _proj(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """One dense layer: :func:`_matmul`, or :func:`_matmul_q` for a
    quantized one (it carries ``weight_scale``)."""
    scale = getattr(lin, "weight_scale", None)
    if scale is None:
        return _matmul(x, lin.weight, lin.bias)
    return _matmul_q(x, lin.weight, scale, lin.bias)


def _set_int8(lin: nn.Linear, w_q: torch.Tensor, scale: torch.Tensor) -> None:
    lin.weight = nn.Parameter(w_q, requires_grad=False)
    lin.register_buffer("weight_scale", scale)


@torch.no_grad()
def quantize_params(model: "BertModel") -> "BertModel":
    """In place: per-output-channel symmetric int8 PTQ of the six encoder
    weight stacks (JAX ``quantize_params``, ``bert.py:294-327``).  Each
    weight becomes int8 ``round(w / s)`` (half to even, clipped to +-127)
    with ``s = max |w| / 127`` over its input axis (at least 1e-8), kept
    as an f32 ``weight_scale`` of shape (out,).  Embeddings, layernorms,
    pooler and classifier stay as they are.  Returns ``model``."""
    for lp in model.layers:
        for name in _QUANT_LINEARS:
            lin = getattr(lp, name)
            if lin.weight.dtype == torch.int8:
                raise ValueError("the model is quantized already")
            w = lin.weight.float()
            s = (w.abs().amax(dim=1) / 127.0).clamp_min(1e-8)
            _set_int8(lin, torch.clamp(torch.round(w / s[:, None]), -127, 127).to(torch.int8), s)
    model.weights_changed()
    return model


class _LayerNorm(nn.Module):
    def __init__(self, h: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(h, device=device))
        self.bias = nn.Parameter(torch.zeros(h, device=device))


def _linear(i: int, o: int, device) -> nn.Linear:
    # zeros, not torch's default init from the global generator: the
    # weights come from load_jax_params or the HF loader
    lin = nn.utils.skip_init(nn.Linear, i, o, device=device)
    nn.init.zeros_(lin.weight)
    nn.init.zeros_(lin.bias)
    return lin


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        h, i = cfg.hidden, cfg.intermediate
        self.q, self.k, self.v, self.o = (_linear(h, h, device) for _ in range(4))
        self.attn_ln = _LayerNorm(h, device)
        self.inter = _linear(h, i, device)
        self.out = _linear(i, h, device)
        self.mlp_ln = _LayerNorm(h, device)
        self._qkv_pack = None
        self._o_pack = None

    def qkv_pack(self) -> tuple[torch.Tensor, torch.Tensor]:
        """W_q, W_k, W_v and their biases as the QKV kernel takes them
        (:func:`ops.fused_bert.pack_qkv`), cast once and kept until the
        weights change (:meth:`BertModel.weights_changed`)."""
        if self._qkv_pack is None:
            self._qkv_pack = pack_qkv(self.q.weight, self.q.bias, self.k.weight, self.k.bias,
                                      self.v.weight, self.v.bias)
        return self._qkv_pack

    def o_pack(self) -> ResidPack:
        """W_o and b_o as the o-proj kernel takes them
        (:func:`ops.fused_bert.pack_resid`: bf16 W_o, f32 b_o, W_o's tensor
        maps), cast once and kept until the weights change
        (:meth:`BertModel.weights_changed`)."""
        if self._o_pack is None:
            self._o_pack = pack_resid(self.o.weight, self.o.bias)
        return self._o_pack


class BertModel(nn.Module):
    """BERT encoder; ``forward`` is :meth:`encode`."""

    def __init__(self, cfg: BertConfig, *, device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        if dev.type == "cuda":
            # full-f32 products wherever f32 tensors meet on the card
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        h = cfg.hidden
        self.word_emb = nn.Parameter(torch.zeros(cfg.vocab_size, h, device=dev))
        self.position_emb = nn.Parameter(torch.zeros(cfg.max_positions, h, device=dev))
        self.type_emb = nn.Parameter(torch.zeros(cfg.type_vocab, h, device=dev))
        self.emb_ln = _LayerNorm(h, dev)
        self.layers = nn.ModuleList(BertLayer(cfg, dev) for _ in range(cfg.layers))
        self.pooler = _linear(h, h, dev) if cfg.with_pooler else None
        self.classifier = (
            _linear(h, cfg.num_labels, dev) if cfg.num_labels else None
        )
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.word_emb.device

    def weights_changed(self) -> None:
        """Drop what was derived from the weights (the layers' QKV and
        o-proj packs); every loader calls it after it writes them."""
        for lp in self.layers:
            lp._qkv_pack = None
            lp._o_pack = None

    @property
    def quantized(self) -> bool:
        """Whether a layer holds int8-PTQ weights (:func:`quantize_params`)."""
        return any(lp.q.weight.dtype == torch.int8 for lp in self.layers)

    def encode(
        self,
        input_ids: torch.Tensor,       # (B, L) int
        token_type_ids: torch.Tensor,  # (B, L) int
        attention_mask: torch.Tensor,  # (B, L) int/bool
    ) -> torch.Tensor:
        """Returns final hidden states (B, L, H) float32."""
        cfg = self.cfg
        act = _act_dtype()
        graded = _graded(self)
        fused = not graded and _fused_block_enabled(self)
        b, seq = input_ids.shape
        nh, hd = cfg.heads, cfg.hidden // cfg.heads
        pair_attn = _pair_attn_enabled(seq, hd, graded)
        h = (
            _embedding(input_ids.long(), self.word_emb)
            + self.position_emb[:seq][None, :, :]
            + _embedding(token_type_ids.long(), self.type_emb)
        )
        h = _ln(h, self.emb_ln.weight, self.emb_ln.bias, cfg.ln_eps).to(act)
        inv_sqrt = 1.0 / (hd**0.5)
        attend = encoder_self_attention if pair_attn else _einsum_attention
        for lp in self.layers:
            if fused:
                h = self._fused_layer(lp, h, attention_mask, act, pair_attn)
                continue
            # one cast feeds all three projections; a graded forward casts
            # in each (JAX's _matmul), so their input gradients add in f32
            hb = h if graded else h.to(torch.bfloat16)
            q = _proj(hb, lp.q).to(act).reshape(b, seq, nh, hd)
            k = _proj(hb, lp.k).to(act).reshape(b, seq, nh, hd)
            v = _proj(hb, lp.v).to(act).reshape(b, seq, nh, hd)
            ctx = attend(q, k, v, attention_mask, inv_sqrt)
            attn_out = _proj(ctx, lp.o).to(act)
            h = _ln(h + attn_out, lp.attn_ln.weight, lp.attn_ln.bias, cfg.ln_eps).to(act)
            mlp = _proj(_gelu(_proj(h, lp.inter).to(act)), lp.out).to(act)
            h = _ln(h + mlp, lp.mlp_ln.weight, lp.mlp_ln.bias, cfg.ln_eps).to(act)
        return h.float()

    forward = encode

    def _fused_layer(self, lp: BertLayer, h: torch.Tensor, attention_mask: torch.Tensor,
                     act: torch.dtype, pair_attn: bool) -> torch.Tensor:
        """One layer through the fused-block kernels (JAX ``bert.py:389-399``
        and ``:430-449``): QKV in one pass over the hidden state, attention
        as the gate chose it (``pair_attn``), then o-proj + residual + LN
        and FFN + residual + LN.  The attention kernel's context goes to
        the o-proj kernel as bf16, which is exact: the kernel rounds it to
        bf16 first either way; the einsum path's goes as f32, as in JAX."""
        cfg = self.cfg
        b, seq, hid = h.shape
        nh, hd = cfg.heads, hid // cfg.heads
        x = h.reshape(b * seq, hid)
        q, k, v = (
            t.to(act).reshape(b, seq, nh, hd)
            for t in fused_qkv(x, lp.q.weight, lp.q.bias, lp.k.weight, lp.k.bias,
                               lp.v.weight, lp.v.bias, lp.qkv_pack())
        )
        inv_sqrt = 1.0 / (hd**0.5)
        if pair_attn:
            ctx = encoder_self_attention(q, k, v, attention_mask, inv_sqrt,
                                         out_dtype=torch.bfloat16)
        else:
            ctx = _einsum_attention(q, k, v, attention_mask, inv_sqrt)
        h2 = fused_resid_ln(x, ctx.reshape(b * seq, hid), lp.o.weight, lp.o.bias,
                            lp.attn_ln.weight, lp.attn_ln.bias, cfg.ln_eps, lp.o_pack())
        h2 = fused_ffn_ln(h2, lp.inter.weight, lp.inter.bias, lp.out.weight, lp.out.bias,
                          lp.mlp_ln.weight, lp.mlp_ln.bias, cfg.ln_eps)
        return h2.reshape(b, seq, hid).to(act)


def _cls(model: BertModel, input_ids, token_type_ids, attention_mask):
    return model.encode(input_ids, token_type_ids, attention_mask)[:, 0, :]


def embed_cls(model: BertModel, input_ids, token_type_ids, attention_mask) -> torch.Tensor:
    """CLS-pooled, L2-normalized sentence embedding (BGE convention)."""
    cls = _cls(model, input_ids, token_type_ids, attention_mask)
    return cls / torch.linalg.norm(cls, dim=-1, keepdim=True).clamp_min(1e-12)


def embed_mean(model: BertModel, input_ids, token_type_ids, attention_mask) -> torch.Tensor:
    """Mean-pooled, L2-normalized embedding (MiniLM bi-encoder convention)."""
    h = model.encode(input_ids, token_type_ids, attention_mask)
    m = attention_mask[:, :, None].float()
    mean = (h * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-9)
    return mean / torch.linalg.norm(mean, dim=-1, keepdim=True).clamp_min(1e-12)


def pair_head(model: BertModel, cls: torch.Tensor) -> torch.Tensor:
    """tanh pooler + classifier over (P, H) CLS states -> (P,) logits."""
    pooled = torch.tanh(_matmul(cls, model.pooler.weight, model.pooler.bias))
    return _matmul(pooled, model.classifier.weight, model.classifier.bias)[:, 0]


def cross_score(model: BertModel, input_ids, token_type_ids, attention_mask) -> torch.Tensor:
    """Cross-encoder relevance logit per pair (B,) — MiniLM rerank head."""
    return pair_head(model, _cls(model, input_ids, token_type_ids, attention_mask))


_LAYER_MAP = (
    # JAX pytree key, module path, transpose
    ("q_w", "q.weight", True), ("q_b", "q.bias", False),
    ("k_w", "k.weight", True), ("k_b", "k.bias", False),
    ("v_w", "v.weight", True), ("v_b", "v.bias", False),
    ("o_w", "o.weight", True), ("o_b", "o.bias", False),
    ("attn_ln_scale", "attn_ln.weight", False),
    ("attn_ln_bias", "attn_ln.bias", False),
    ("in_w", "inter.weight", True), ("in_b", "inter.bias", False),
    ("out_w", "out.weight", True), ("out_b", "out.bias", False),
    ("mlp_ln_scale", "mlp_ln.weight", False),
    ("mlp_ln_bias", "mlp_ln.bias", False),
)


@torch.no_grad()
def load_jax_params(model: BertModel, tree: dict) -> BertModel:
    """Fill ``model`` from the JAX package's parameter pytree (numpy
    arrays or tensors): unstack the layers and transpose dense weights
    from (in, out) to ``nn.Linear``'s (out, in).  An int8-PTQ tree (JAX
    ``quantize_params``: int8 weights beside ``<name>__scale`` arrays of
    shape (L, 1, out)) makes the model's six weight stacks int8 with those
    scales, as :func:`quantize_params` would."""

    def put(path: str, arr, transpose: bool = False) -> None:
        a = np.asarray(arr, np.float32)
        if transpose:
            a = a.T
        dst = model.get_buffer(path) if path.endswith("_scale") else model.get_parameter(path)
        if tuple(a.shape) != tuple(dst.shape):
            raise ValueError(f"{path}: shape {a.shape} != {tuple(dst.shape)}")
        dst.copy_(torch.tensor(a))

    emb = tree["embeddings"]
    put("word_emb", emb["word"])
    put("position_emb", emb["position"])
    put("type_emb", emb["type"])
    put("emb_ln.weight", emb["ln_scale"])
    put("emb_ln.bias", emb["ln_bias"])
    lp = tree["layers"]
    int8 = any(k.endswith(_SCALE_SUFFIX) for k in lp)
    if model.quantized and not int8:
        raise ValueError("a float parameter tree cannot fill a quantized model")
    for i in range(model.cfg.layers):
        if int8 and model.layers[i].q.weight.dtype != torch.int8:  # the int8 layout first
            for name in _QUANT_LINEARS:
                lin = getattr(model.layers[i], name)
                _set_int8(lin, torch.zeros_like(lin.weight, dtype=torch.int8),
                          torch.ones_like(lin.bias))
        for key, path, transpose in _LAYER_MAP:
            put(f"layers.{i}.{path}", np.asarray(lp[key])[i], transpose)
        if int8:
            for key, name in zip(_QUANT_KEYS, _QUANT_LINEARS):
                put(f"layers.{i}.{name}.weight_scale", np.asarray(lp[key + _SCALE_SUFFIX])[i, 0])
    if model.pooler is not None and "pooler" in tree:
        put("pooler.weight", tree["pooler"]["w"], True)
        put("pooler.bias", tree["pooler"]["b"])
    if model.classifier is not None and "classifier" in tree:
        put("classifier.weight", tree["classifier"]["w"], True)
        put("classifier.bias", tree["classifier"]["b"])
    model.weights_changed()
    return model


def export_jax_params(model: BertModel) -> dict:
    """The JAX package's parameter pytree of ``model``'s weights as f32
    numpy arrays: the inverse of :func:`load_jax_params` for a float
    model (layers stacked on axis 0, dense weights (in, out))."""
    if model.quantized:
        raise ValueError("export_jax_params takes a float model")

    def get(path: str, transpose: bool = False) -> np.ndarray:
        a = model.get_parameter(path).detach().to("cpu", torch.float32).numpy()
        return np.ascontiguousarray(a.T if transpose else a)

    tree = {
        "embeddings": {
            "word": get("word_emb"), "position": get("position_emb"),
            "type": get("type_emb"), "ln_scale": get("emb_ln.weight"),
            "ln_bias": get("emb_ln.bias"),
        },
        "layers": {
            key: np.stack([get(f"layers.{i}.{path}", transpose)
                           for i in range(model.cfg.layers)])
            for key, path, transpose in _LAYER_MAP
        },
    }
    if model.pooler is not None:
        tree["pooler"] = {"w": get("pooler.weight", True), "b": get("pooler.bias")}
    if model.classifier is not None:
        tree["classifier"] = {"w": get("classifier.weight", True),
                              "b": get("classifier.bias")}
    return tree
