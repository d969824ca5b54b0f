"""Cross-encoder reranker (the reference's ``get_reranker``).

Port of ``financial_rag_system_tpu/models/reranker.py``: each (query,
text) pair runs through the 6-layer MiniLM BERT with a single-logit
classification head on the device.  The selection rule downstream is the
reference's exact ``np.argsort(scores)[::-1][:top_k]``.

:meth:`CrossEncoderReranker.score` is the staged path, which packs each
pair compactly ([CLS] q [SEP] doc [SEP]); the fused program lays pairs
out with the doc at a fixed offset instead, so the two give different
logits, as they do in the JAX package.  Weights come from
``RAG_TPU_RERANKER_DIR``; without it :func:`get_reranker` returns the
hermetic :class:`HashReranker`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

from financial_rag_system_tpu_torch.models import bert
from financial_rag_system_tpu_torch.models.embedder import HashEmbedder
from financial_rag_system_tpu_torch.models.tokenizer import Tokenizer, pad_batch

MAX_DEVICE_BATCH = 32


class CrossEncoderReranker:
    """Full MiniLM cross-encoder scoring on the device."""

    _DOC_CACHE_MAX = 65536

    def __init__(
        self,
        model: bert.BertModel,
        cfg: bert.BertConfig,
        tokenizer: Tokenizer,
        *,
        max_len: int = 512,
    ):
        if os.environ.get("RAG_TPU_INT8_RERANK", "0") in ("1", "true"):
            # int8 PTQ of the encoder weight stacks, in place; the staged
            # path (cross_score here) and the fused program both use it
            bert.quantize_params(model)
        self.model = model
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_len = max_len
        # corpus chunks recur across queries; memoize their token ids
        self._doc_ids: dict[str, list[int]] = {}

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _doc_token_ids(self, text: str) -> list[int]:
        ids = self._doc_ids.get(text)
        if ids is None:
            ids = self.tokenizer.tokenize_ids(text)
            if len(self._doc_ids) < self._DOC_CACHE_MAX:
                self._doc_ids[text] = ids
        return ids

    def score(self, query: str, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0,), np.float32)
        q_ids = self.tokenizer.tokenize_ids(query)
        out: list[np.ndarray] = []
        for start in range(0, len(texts), MAX_DEVICE_BATCH):
            chunk = texts[start : start + MAX_DEVICE_BATCH]
            encs = [
                self.tokenizer.encode_pair_from_ids(
                    q_ids, self._doc_token_ids(t), self.max_len
                )
                for t in chunk
            ]
            ids, types, mask = (
                torch.as_tensor(a, device=self.device) for a in pad_batch(encs)
            )
            logits = bert.cross_score(self.model, ids, types, mask)
            out.append(logits[: len(chunk)].cpu().numpy().astype(np.float32))
        return np.concatenate(out)


class HashReranker:
    """Deterministic fallback: hash-embedding cosine as relevance.

    The table seed is de-aliased from :class:`HashEmbedder`'s (13 against
    7): with one seed, rerank scores would equal the retrieval cosines by
    construction, and a dropped or permuted rerank stage would be
    invisible.  With ``identity`` (the reference's TESTING mode) the
    scores keep retrieval order.
    """

    SEED = 13

    def __init__(self, *, identity: bool = False, device: str | torch.device = "cuda"):
        self.identity = identity
        self._emb = HashEmbedder(seed=self.SEED, device=device)

    @property
    def table(self) -> torch.Tensor:
        """The device table the fused hash rerank reads
        (ops/fused_query.fused_hash_rerank_query)."""
        return self._emb.table

    @property
    def device(self) -> torch.device:
        return self._emb.device

    def score(self, query: str, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0,), np.float32)
        if self.identity:
            # reference TESTING mode: preserve retrieval order
            return np.arange(len(texts), 0, -1, dtype=np.float32)
        vecs = self._emb.encode([query, *texts])
        return (vecs[1:] @ vecs[0]).astype(np.float32)


def get_reranker(*, testing: bool = False, device: str | torch.device = "cuda"):
    """Factory mirroring the reference's get_reranker: the checkpoint in
    ``RAG_TPU_RERANKER_DIR`` when it names a directory, else the hash
    reranker (the identity one in TESTING mode)."""
    ckpt = os.environ.get("RAG_TPU_RERANKER_DIR", "")
    if not (ckpt and os.path.isdir(ckpt)):
        return HashReranker(identity=testing, device=device)
    from financial_rag_system_tpu_torch.models.hf_loader import (
        load_bert_checkpoint,
        saved_max_seq_length,
    )

    # layer count comes from the checkpoint's config.json (6 for the
    # reference ms-marco MiniLM; trained exports may differ)
    model, cfg = load_bert_checkpoint(
        ckpt, with_pooler=True, num_labels=1, device=device
    )
    trained_len = saved_max_seq_length(ckpt)
    if trained_len < cfg.max_positions:
        # carry the hint on the cfg so the FUSED pipeline truncates pairs
        # where training did too (ops/fused_query._assemble_pairs)
        cfg = dataclasses.replace(cfg, max_seq_length=trained_len)
    return CrossEncoderReranker(
        model, cfg, Tokenizer.from_dir(ckpt), max_len=trained_len,
    )
