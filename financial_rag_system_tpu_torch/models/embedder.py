"""Bi-encoder embedding service (the reference's ``get_embedder``).

Port of ``financial_rag_system_tpu/models/embedder.py``: tokenize ->
bucketed padding -> BERT forward on the device -> CLS pool ->
L2-normalize, exposed to ingestion through the ``/embed`` endpoint.

Weights come from ``RAG_TPU_BGE_DIR``, a local HF checkpoint directory
(vocab.txt + pytorch_model.bin).  The hermetic hash embedder is not
ported yet (ROADMAP Queue 1), so without that directory
:func:`get_embedder` raises.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from financial_rag_system_tpu_torch.models import bert
from financial_rag_system_tpu_torch.models.tokenizer import Tokenizer, pad_batch

MAX_DEVICE_BATCH = 64


class BiEncoder:
    """Full BERT bi-encoder with CLS ('bge') or mean pooling."""

    def __init__(
        self,
        model: bert.BertModel,
        cfg: bert.BertConfig,
        tokenizer: Tokenizer,
        *,
        pooling: str = "cls",
        max_len: int = 512,
    ):
        self.model = model
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.pooling = pooling
        self.max_len = max_len
        self.dim = cfg.hidden

    @property
    def device(self) -> torch.device:
        return self.model.device

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        fwd = bert.embed_cls if self.pooling == "cls" else bert.embed_mean
        out: list[np.ndarray] = []
        for start in range(0, len(texts), MAX_DEVICE_BATCH):
            chunk = texts[start : start + MAX_DEVICE_BATCH]
            encs = [self.tokenizer.encode(t, self.max_len) for t in chunk]
            ids, types, mask = (
                torch.as_tensor(a, device=self.device) for a in pad_batch(encs)
            )
            vecs = fwd(self.model, ids, types, mask)
            out.append(vecs[: len(chunk)].cpu().numpy().astype(np.float32))
        return np.concatenate(out, axis=0)


def get_embedder(*, device: str | torch.device = "cuda") -> BiEncoder:
    """Factory mirroring the reference's get_embedder, for a checkpoint
    directory only (the hash embedder is not ported yet)."""
    ckpt = os.environ.get("RAG_TPU_BGE_DIR", "")
    if not (ckpt and os.path.isdir(ckpt)):
        raise RuntimeError(
            "RAG_TPU_BGE_DIR must name a local HF checkpoint directory: the "
            "port has no hash embedder yet"
        )
    from financial_rag_system_tpu_torch.models.hf_loader import (
        load_bert_checkpoint,
        saved_max_seq_length,
    )

    model, cfg = load_bert_checkpoint(ckpt, with_pooler=True, device=device)
    return BiEncoder(
        model, cfg, Tokenizer.from_dir(ckpt), pooling="cls",
        max_len=saved_max_seq_length(ckpt),
    )
