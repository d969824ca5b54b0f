"""Export the port's ``BertModel`` as an HF-format checkpoint dir.

Port of ``financial_rag_system_tpu/models/hf_export.py`` and the inverse
of :mod:`models.hf_loader`: writes ``config.json`` +
``pytorch_model.bin`` (and, with a trained-length hint,
``sentence_bert_config.json``) in the same format the JAX package's
exporter writes, so either package serves the other's checkpoints
through ``RAG_TPU_BGE_DIR`` / ``RAG_TPU_RERANKER_DIR``.  ``nn.Linear``
already stores (out, in), HF's layout, so nothing transposes.

No ``vocab.txt`` is written: ``Tokenizer.from_dir`` falls back to the
deterministic hash vocab on a missing file.
"""

from __future__ import annotations

import json
import os

import torch

from financial_rag_system_tpu_torch.models.bert import BertConfig, BertModel
from financial_rag_system_tpu_torch.models.hf_loader import hf_names


def save_bert_checkpoint(
    model: BertModel,
    cfg: BertConfig,
    ckpt_dir: str,
    *,
    cross_encoder: bool = False,
    max_seq_length: int | None = None,
) -> None:
    """Write config.json + pytorch_model.bin for ``load_bert_checkpoint``.

    ``cross_encoder`` uses the ``bert.``-prefixed
    BertForSequenceClassification layout (classifier stays unprefixed),
    matching how HF ships ms-marco cross-encoders.  ``max_seq_length``
    persists the TRAINED sequence length in sentence_bert_config.json
    (the sentence-transformers convention) so serving truncates where
    training did.
    """
    if model.quantized:
        raise ValueError("HF checkpoints hold float weights: save the model "
                         "before quantize_params")
    os.makedirs(ckpt_dir, exist_ok=True)
    if max_seq_length:
        with open(os.path.join(ckpt_dir, "sentence_bert_config.json"), "w") as f:
            json.dump({"max_seq_length": int(max_seq_length)}, f)
    hf_cfg = {
        "architectures": [
            "BertForSequenceClassification" if cross_encoder else "BertModel"
        ],
        "model_type": "bert",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden,
        "num_hidden_layers": cfg.layers,
        "num_attention_heads": cfg.heads,
        "intermediate_size": cfg.intermediate,
        "max_position_embeddings": cfg.max_positions,
        "type_vocab_size": cfg.type_vocab,
        "layer_norm_eps": cfg.ln_eps,
        "hidden_act": "gelu",
    }
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=1)

    prefix = "bert." if cross_encoder else ""

    def tensor(path: str) -> torch.Tensor:
        return model.get_parameter(path).detach().to("cpu", torch.float32).contiguous()

    sd = {prefix + hf: tensor(path) for hf, path in hf_names(model.cfg)}
    if model.classifier is not None:
        # classifier lives OUTSIDE the bert. prefix (HF sequence
        # classification layout — hf_loader reads it unprefixed)
        sd["classifier.weight"] = tensor("classifier.weight")
        sd["classifier.bias"] = tensor("classifier.bias")
    torch.save(sd, os.path.join(ckpt_dir, "pytorch_model.bin"))
