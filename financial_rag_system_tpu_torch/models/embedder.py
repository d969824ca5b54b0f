"""Bi-encoder embedding service (the reference's ``get_embedder``).

Port of ``financial_rag_system_tpu/models/embedder.py``: tokenize ->
bucketed padding -> BERT forward on the device -> CLS pool ->
L2-normalize, exposed to ingestion through the ``/embed`` endpoint.

Weight sources, in priority order (as in the JAX package):
1. ``RAG_TPU_BGE_DIR``: a local HF checkpoint directory (vocab.txt +
   pytorch_model.bin), converted by :mod:`models.hf_loader`.
2. :class:`HashEmbedder`: a seeded embedding-table bag-of-words model,
   hermetic and deterministic, whose table is the JAX package's own
   (``jax.random.normal(PRNGKey(7))``, drawn in numpy by
   :mod:`utils.prng`), so both packages embed a text to the same vector.
"""

from __future__ import annotations

import functools
import os
from typing import Sequence

import numpy as np
import torch

from financial_rag_system_tpu_torch.models import bert
from financial_rag_system_tpu_torch.models.tokenizer import Tokenizer, pad_batch
from financial_rag_system_tpu_torch.utils import prng
from financial_rag_system_tpu_torch.utils.device import resolve_device

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


# High-frequency terms whose overlap carries little relevance signal;
# their table rows are scaled down so rare-token overlap dominates cosine.
_STOPWORDS = (
    "a an and are as at be been but by did do does for from had has have he "
    "her his how i if in into is it its of on or our she so such that the "
    "their them then there these they this to was we were what when which "
    "who will with you your not no nor than too very can could would should "
    "percent billion million dollars company report period year quarter "
    "during other may also prior consistent"
).split()
_STOPWORD_SCALE = np.float32(0.15)


@functools.lru_cache(maxsize=4)
def _hash_table(vocab_size: int, dim: int, seed: int, stopword_ids: tuple[int, ...]) -> np.ndarray:
    """The JAX package's table (JAX ``embedder.py:81-91``): a standard
    normal (vocab_size, dim) f32 draw from ``PRNGKey(seed)``, the stopword
    rows times 0.15 in f32.  Read-only: engines and tests share it (a
    draw takes seconds)."""
    table = prng.normal(seed, (vocab_size, dim))
    table[list(stopword_ids)] *= _STOPWORD_SCALE
    table.setflags(write=False)
    return table


def _hash_embed(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean-pool of the tokens' table rows, L2-normalized (JAX
    ``embedder.py:94-100``), over (..., L) token ids.  The gather and the
    pool are one ``embedding_bag`` with the mask as weights, so no
    (..., L, D) block is made."""
    lead, n = ids.shape[:-1], ids.shape[-1]
    m = mask.reshape(-1, n).to(torch.float32)
    total = torch.nn.functional.embedding_bag(
        ids.reshape(-1, n).long(), table, mode="sum", per_sample_weights=m
    )
    mean = total / m.sum(dim=1, keepdim=True).clamp_min(1.0)
    out = mean / torch.linalg.norm(mean, dim=-1, keepdim=True).clamp_min(1e-12)
    return out.reshape(*lead, table.shape[1])


class HashEmbedder:
    """Deterministic seeded bag-of-words embedder (the hermetic stack).

    Token ids index a fixed Gaussian table on the device, masked mean
    pool, L2 normalize: cosine similarity then reflects lexical overlap,
    enough for retrieval to do real work without trained weights.
    """

    def __init__(self, dim: int = 384, *, max_len: int = 512, seed: int = 7,
                 device: str | torch.device = "cuda"):
        self.dim = dim
        self.max_len = max_len
        self.tokenizer = Tokenizer()
        stop_ids = tuple(sorted(
            {i for w in _STOPWORDS for i in self.tokenizer.tokenize_ids(w)}
        ))
        self.table = torch.tensor(
            _hash_table(self.tokenizer.vocab.vocab_size, dim, seed, stop_ids),
            device=resolve_device(device),
        )

    @property
    def device(self) -> torch.device:
        return self.table.device

    @torch.inference_mode()
    def encode(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        out: list[np.ndarray] = []
        for start in range(0, len(texts), MAX_DEVICE_BATCH):
            chunk = texts[start : start + MAX_DEVICE_BATCH]
            encs = [self.tokenizer.encode(t, self.max_len) for t in chunk]
            ids, _, mask = pad_batch(encs)
            vecs = _hash_embed(
                self.table, torch.as_tensor(ids, device=self.device),
                torch.as_tensor(mask, device=self.device),
            )
            out.append(vecs[: len(chunk)].cpu().numpy())
        return np.concatenate(out, axis=0)


def get_embedder(dim: int = 384, *, device: str | torch.device = "cuda"):
    """Factory mirroring the reference's get_embedder: the checkpoint in
    ``RAG_TPU_BGE_DIR`` when it names a directory, else the hash embedder."""
    ckpt = os.environ.get("RAG_TPU_BGE_DIR", "")
    if not (ckpt and os.path.isdir(ckpt)):
        return HashEmbedder(dim, device=device)
    from financial_rag_system_tpu_torch.models.hf_loader import (
        load_bert_checkpoint,
        saved_max_seq_length,
    )

    model, cfg = load_bert_checkpoint(ckpt, with_pooler=True, device=device)
    return BiEncoder(
        model, cfg, Tokenizer.from_dir(ckpt), pooling="cls",
        max_len=saved_max_seq_length(ckpt),
    )
