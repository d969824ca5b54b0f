"""Cross-encoder (reranker) fine-tuning: pointwise BCE over labeled pairs.

Port of ``financial_rag_system_tpu/train/cross_encoder.py`` to torch
autograd.  The reference's second stage is a pretrained ms-marco MiniLM
cross-encoder; with no model egress the same ARCHITECTURE trains from
random init on first-party supervision: for every (ticker, intent,
paraphrase) the intent's positive chunk is a 1-label pair, and its
lexical BAIT chunks (they share the query's surface words and never
hold the scoring keywords, ``data/synthetic.py HARD_INTENTS``) and
seeded filler distractors are 0-label pairs.  The eval queries
(``make_hard_set``) are never seen.

The graded forward (``models/bert.py _graded``) takes the einsum
attention at every pair length, 512-token buckets included, where
serving takes the pair-attention kernel.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from financial_rag_system_tpu_torch.models import bert
from financial_rag_system_tpu_torch.models.tokenizer import Tokenizer, pad_batch
from financial_rag_system_tpu_torch.train.contrastive import on_device
from financial_rag_system_tpu_torch.train.optim import ClippedAdamW, graded


def make_cross_examples(
    tickers: list[str] | None = None,
    *,
    fillers_per_intent: int = 2,
    seed: int = 0,
    chunk_chars: int | None = None,
) -> list[tuple[str, str, float]]:
    """(query, chunk, label) triples from the paraphrase supervision.

    ``chunk_chars`` pads every chunk with the corpus builders' boilerplate
    (data/synthetic.py expand_chunk) so the reranker trains at the pair
    lengths it will score at serving time."""
    import random

    from financial_rag_system_tpu_torch.data.synthetic import (
        _COMPANY,
        _TICKERS,
        _distractor,
        expand_chunk,
        AAPL_TOPICS,
        EASY_TRAIN_PARAPHRASES,
        HARD_INTENTS,
        TRAIN_PARAPHRASES,
    )

    rng = random.Random(seed)
    tickers = tickers or _TICKERS
    ex = lambda s: expand_chunk(s, chunk_chars)  # noqa: E731
    out: list[tuple[str, str, float]] = []
    for t in tickers:
        company = _COMPANY[t]
        for intent in HARD_INTENTS:
            pos = ex(intent["positive"].format(company=company))
            baits = [ex(b.format(company=company)) for b in intent["baits"]]
            for q in TRAIN_PARAPHRASES[intent["name"]]:
                query = q.format(company=company)
                out.append((query, pos, 1.0))
                for b in baits:
                    out.append((query, b, 0.0))
                for j in range(fillers_per_intent):
                    out.append(
                        (query,
                         ex(_distractor(rng, t, rng.randrange(1 << 30))),
                         0.0)
                    )
        # easy golden-set domains: positive = the parity-topic paragraph,
        # negatives = fillers AND the other topics' paragraphs (the easy
        # corpus's natural confusables)
        for name, qs in EASY_TRAIN_PARAPHRASES.items():
            pos = ex(AAPL_TOPICS[name])
            others = [ex(v) for k, v in AAPL_TOPICS.items() if k != name]
            for q in qs:
                query = q.format(company=company)
                out.append((query, pos, 1.0))
                out.append((query, rng.choice(others), 0.0))
                out.append(
                    (query,
                     ex(_distractor(rng, t, rng.randrange(1 << 30))), 0.0)
                )
    return out


def bce_loss(model: bert.BertModel, ids, types, mask, labels,
             pos_weight: float = 1.0) -> torch.Tensor:
    """Weighted pointwise BCE on the cross-encoder's logits (JAX
    ``make_cross_step``'s ``loss_fn``): positives weigh ``pos_weight``,
    everything else 1, pad rows included."""
    logits = bert.cross_score(model, ids, types, mask)
    per = -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)
    w = torch.where(labels > 0.5, pos_weight, 1.0)
    return torch.sum(per * w) / torch.sum(w)


def make_cross_step(
    model: bert.BertModel, optimizer: ClippedAdamW, *, pos_weight: float = 1.0,
) -> Callable[..., torch.Tensor]:
    """``step(ids, types, mask, labels) -> loss``: one graded forward and
    backward of :func:`bce_loss` and one update of ``model`` in place.

    ``pos_weight`` rebalances the heavy negative skew (each positive pair
    ships with several bait + filler negatives) so the model can't sit at
    the base rate."""
    dev = model.device

    def step(ids, types, mask, labels) -> torch.Tensor:
        with graded(model):
            loss = bce_loss(model, *on_device((ids, types, mask, labels), dev), pos_weight)
            loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def train_cross_encoder(
    model: bert.BertModel,
    examples: list[tuple[str, str, float]],
    *,
    tokenizer: Tokenizer | None = None,
    epochs: int = 1,
    batch_size: int = 32,
    lr: float = 5e-5,
    max_len: int = 128,
    seed: int = 0,
) -> tuple[bert.BertModel, list[float]]:
    """Returns (``model``, trained in place, and the per-step losses).
    The batch rows that ``pad_batch`` adds to reach a bucket are labelled
    0 with weight 1, as in JAX."""
    tok = tokenizer or Tokenizer()
    # global-norm clipping: at this lr the pointwise BCE run is
    # trajectory-sensitive; clipping makes convergence order-insensitive
    optimizer = ClippedAdamW(model, lr)
    n_pos = sum(1 for _, _, lbl in examples if lbl > 0.5) or 1
    pos_weight = max(1.0, (len(examples) - n_pos) / n_pos)
    step_fn = make_cross_step(model, optimizer, pos_weight=pos_weight)
    rng = np.random.default_rng(seed)
    losses: list[float] = []
    for _ in range(epochs):
        order = rng.permutation(len(examples))
        for s in range(0, len(examples) - batch_size + 1, batch_size):
            chunk = [examples[i] for i in order[s : s + batch_size]]
            encs = [tok.encode_pair(q, d, max_len) for q, d, _ in chunk]
            ids, types, mask = pad_batch(encs)
            labels = np.zeros(ids.shape[0], np.float32)
            labels[: len(chunk)] = [lbl for _, _, lbl in chunk]
            losses.append(float(step_fn(ids, types, mask, labels)))
    return model, losses
