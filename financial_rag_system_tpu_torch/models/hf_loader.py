"""Load locally stored HF BERT checkpoints into the port's ``BertModel``.

Port of ``financial_rag_system_tpu/models/hf_loader.py``.  A checkpoint
directory holds ``config.json`` + ``pytorch_model.bin`` (or
``model.safetensors``) + an optional ``vocab.txt``, the format that both
packages' ``hf_export.save_bert_checkpoint`` write.  HF stores
``Linear`` weights (out, in), which is ``nn.Linear``'s own layout, so the
state dict copies over by name with no transpose.  No network access is
ever attempted.
"""

from __future__ import annotations

import json
import os

import torch

from financial_rag_system_tpu_torch.models.bert import BertConfig, BertModel

_LAYER_NAMES = (
    # HF name under encoder.layer.{i}., BertModel path under layers.{i}.
    ("attention.self.query", "q"),
    ("attention.self.key", "k"),
    ("attention.self.value", "v"),
    ("attention.output.dense", "o"),
    ("attention.output.LayerNorm", "attn_ln"),
    ("intermediate.dense", "inter"),
    ("output.dense", "out"),
    ("output.LayerNorm", "mlp_ln"),
)


def hf_names(cfg: BertConfig) -> list[tuple[str, str]]:
    """(HF state-dict name without the ``bert.`` prefix, BertModel
    parameter path) for the encoder and pooler; the classifier is
    handled by the callers (it sits outside the prefix)."""
    out = [
        ("embeddings.word_embeddings.weight", "word_emb"),
        ("embeddings.position_embeddings.weight", "position_emb"),
        ("embeddings.token_type_embeddings.weight", "type_emb"),
        ("embeddings.LayerNorm.weight", "emb_ln.weight"),
        ("embeddings.LayerNorm.bias", "emb_ln.bias"),
    ]
    for i in range(cfg.layers):
        for hf, mine in _LAYER_NAMES:
            for leaf in ("weight", "bias"):
                out.append((f"encoder.layer.{i}.{hf}.{leaf}", f"layers.{i}.{mine}.{leaf}"))
    if cfg.with_pooler:
        out += [("pooler.dense.weight", "pooler.weight"), ("pooler.dense.bias", "pooler.bias")]
    return out


def _read_state_dict(ckpt_dir: str) -> dict[str, torch.Tensor]:
    st = os.path.join(ckpt_dir, "model.safetensors")
    if os.path.exists(st):
        try:
            from safetensors.torch import load_file

            return dict(load_file(st))
        except ImportError:
            pass
    bins = [
        f for f in ("pytorch_model.bin", "pytorch_model.pt")
        if os.path.exists(os.path.join(ckpt_dir, f))
    ]
    if not bins:
        raise FileNotFoundError(f"no weights file in {ckpt_dir}")
    return torch.load(
        os.path.join(ckpt_dir, bins[0]), map_location="cpu", weights_only=True
    )


def saved_max_seq_length(ckpt_dir: str, default: int = 512) -> int:
    """Trained sequence length from sentence_bert_config.json (the
    sentence-transformers convention; models/hf_export.py writes it) —
    serving must truncate where training did, or untrained position
    embeddings shift the score distribution."""
    path = os.path.join(ckpt_dir, "sentence_bert_config.json")
    try:
        with open(path) as f:
            return int(json.load(f)["max_seq_length"])
    except (OSError, KeyError, ValueError, TypeError):
        # sentence-transformers writes null when unset; non-dict roots
        # and missing files mean the same thing: no hint
        return default


@torch.no_grad()
def load_bert_checkpoint(
    ckpt_dir: str,
    *,
    with_pooler: bool = True,
    num_labels: int = 0,
    device: str | torch.device = "cuda",
) -> tuple[BertModel, BertConfig]:
    """Returns (model, cfg) with the weights on ``device``."""
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        hf = json.load(f)
    sd = _read_state_dict(ckpt_dir)
    # cross-encoders ship as BertForSequenceClassification with a bert. prefix
    prefix = "bert." if any(k.startswith("bert.") for k in sd) else ""
    cfg = BertConfig(
        vocab_size=hf["vocab_size"],
        hidden=hf["hidden_size"],
        layers=hf["num_hidden_layers"],
        heads=hf["num_attention_heads"],
        intermediate=hf["intermediate_size"],
        max_positions=hf["max_position_embeddings"],
        type_vocab=hf.get("type_vocab_size", 2),
        ln_eps=hf.get("layer_norm_eps", 1e-12),
        with_pooler=with_pooler and (prefix + "pooler.dense.weight") in sd,
        num_labels=num_labels if "classifier.weight" in sd else 0,
    )
    model = BertModel(cfg, device=device)
    names = hf_names(cfg)
    if cfg.num_labels:
        names += [("classifier.weight", "classifier.weight"),
                  ("classifier.bias", "classifier.bias")]
    for hf_name, path in names:
        key = hf_name if hf_name.startswith("classifier.") else prefix + hf_name
        src = sd[key].to(torch.float32)
        dst = model.get_parameter(path)
        if src.shape != dst.shape:
            raise ValueError(f"{key}: shape {tuple(src.shape)} != {tuple(dst.shape)}")
        dst.copy_(src)
    model.weights_changed()
    return model, cfg
