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
- GELU is exact erf everywhere (``RAG_TPU_FAST_GELU=1`` selects tanh,
  the JAX package's env contract);
- attention is :func:`ops.attention.encoder_self_attention` at every
  sequence length: the CUDA kernel on the card, its plain version on the
  CPU.

Parameters are ``nn.Linear`` weights, (out, in); :func:`load_jax_params`
fills a model from the JAX package's pytree (layer stacks on axis 0,
weights (in, out)).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from financial_rag_system_tpu_torch.ops.attention import encoder_self_attention
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


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU (HF BERT's), or tanh with RAG_TPU_FAST_GELU=1."""
    v = os.environ.get("RAG_TPU_FAST_GELU", "auto").lower()
    return F.gelu(x, approximate="tanh" if v in ("1", "true") else "none")


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), scale, bias, eps)


def _matmul(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 -> f32, plus bias.  ``w`` is an ``nn.Linear`` weight
    (out, in).  No bf16 rounding of the product (see the module note)."""
    x2 = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
    wb = w.to(torch.bfloat16)
    if x2.is_cuda:
        y = torch.mm(x2, wb.t(), out_dtype=torch.float32)
    else:
        y = x2.float() @ wb.float().t()
    return y.reshape(*x.shape[:-1], w.shape[0]) + b


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

    def encode(
        self,
        input_ids: torch.Tensor,       # (B, L) int
        token_type_ids: torch.Tensor,  # (B, L) int
        attention_mask: torch.Tensor,  # (B, L) int/bool
    ) -> torch.Tensor:
        """Returns final hidden states (B, L, H) float32."""
        cfg = self.cfg
        b, seq = input_ids.shape
        h = (
            self.word_emb[input_ids.long()]
            + self.position_emb[:seq][None, :, :]
            + self.type_emb[token_type_ids.long()]
        )
        h = _ln(h, self.emb_ln.weight, self.emb_ln.bias, cfg.ln_eps)
        nh, hd = cfg.heads, cfg.hidden // cfg.heads
        inv_sqrt = 1.0 / (hd**0.5)
        for lp in self.layers:
            hb = h.to(torch.bfloat16)  # one cast feeds all three projections
            q = _matmul(hb, lp.q.weight, lp.q.bias).reshape(b, seq, nh, hd)
            k = _matmul(hb, lp.k.weight, lp.k.bias).reshape(b, seq, nh, hd)
            v = _matmul(hb, lp.v.weight, lp.v.bias).reshape(b, seq, nh, hd)
            ctx = encoder_self_attention(q, k, v, attention_mask, inv_sqrt)
            attn_out = _matmul(ctx, lp.o.weight, lp.o.bias)
            h = _ln(h + attn_out, lp.attn_ln.weight, lp.attn_ln.bias, cfg.ln_eps)
            mlp = _matmul(
                _gelu(_matmul(h, lp.inter.weight, lp.inter.bias)),
                lp.out.weight, lp.out.bias,
            )
            h = _ln(h + mlp, lp.mlp_ln.weight, lp.mlp_ln.bias, cfg.ln_eps)
        return h

    forward = encode


def _cls(model: BertModel, input_ids, token_type_ids, attention_mask):
    return model.encode(input_ids, token_type_ids, attention_mask)[:, 0, :]


def embed_cls(model: BertModel, input_ids, token_type_ids, attention_mask) -> torch.Tensor:
    """CLS-pooled, L2-normalized sentence embedding (BGE convention)."""
    cls = _cls(model, input_ids, token_type_ids, attention_mask)
    return cls / torch.linalg.norm(cls, dim=-1, keepdim=True).clamp_min(1e-12)


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
    from (in, out) to ``nn.Linear``'s (out, in)."""

    def put(path: str, arr, transpose: bool = False) -> None:
        a = np.asarray(arr, np.float32)
        if transpose:
            a = a.T
        dst = model.get_parameter(path)
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
    for i in range(model.cfg.layers):
        for key, path, transpose in _LAYER_MAP:
            put(f"layers.{i}.{path}", np.asarray(lp[key])[i], transpose)
    if model.pooler is not None and "pooler" in tree:
        put("pooler.weight", tree["pooler"]["w"], True)
        put("pooler.bias", tree["pooler"]["b"])
    if model.classifier is not None and "classifier" in tree:
        put("classifier.weight", tree["classifier"]["w"], True)
        put("classifier.bias", tree["classifier"]["b"])
    return model
