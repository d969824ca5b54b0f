"""Contrastive fine-tuning of the bi-encoder on the serving query log.

Port of ``financial_rag_system_tpu/train/contrastive.py`` to torch
autograd, on one device: symmetric InfoNCE over (query, positive chunk)
pairs with in-batch negatives, optionally with one explicit hard
negative per pair whose logits are discounted by ``log(neg_weight)``,
then optax's clipped AdamW (:class:`train.optim.ClippedAdamW`).  The
functions take the port's ``BertModel`` and update it in place where the
JAX ones take and return a parameter pytree.  The forward runs graded
(``models/bert.py _graded``): the einsum attention and the unfused layer
at every length, the path the JAX trainer differentiates.

The JAX trainer's data-parallel step (a ``mesh`` with ``all_gather``
negatives) waits for the port of ``parallel/``.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from financial_rag_system_tpu_torch.models import bert
from financial_rag_system_tpu_torch.models.tokenizer import Tokenizer, pad_batch
from financial_rag_system_tpu_torch.train.optim import ClippedAdamW, graded

Batch = tuple  # (input_ids, token_type_ids, attention_mask), numpy arrays or tensors


# JAX's _embed: the CLS-pooled, L2-normalized embedding
_embed = bert.embed_cls


def on_device(batch: Batch, device: torch.device) -> tuple[torch.Tensor, ...]:
    """A batch's arrays as tensors on ``device``."""
    return tuple(torch.as_tensor(a, device=device) for a in batch)


def info_nce_loss(
    model: bert.BertModel,
    q_batch: Batch,
    d_batch: Batch,
    temperature: float,
    n_batch: Batch | None = None,
    neg_weight: float = 1.0,
) -> torch.Tensor:
    """Symmetric InfoNCE with in-batch negatives (JAX ``info_nce_loss``
    without a mesh): each query's logits against every positive of the
    batch, over ``temperature``; ``n_batch`` adds one explicit negative
    per pair to every query's pool, its logits plus ``log(neg_weight)``.
    Cross-entropy against the query's own positive, averaged."""
    qv = _embed(model, *q_batch)
    dv = _embed(model, *d_batch)
    logits = qv @ dv.t() / temperature
    if n_batch is not None:
        nv = _embed(model, *n_batch)
        logits = torch.cat([logits, qv @ nv.t() / temperature + math.log(neg_weight)], dim=1)
    labels = torch.arange(qv.shape[0], device=qv.device)
    return F.cross_entropy(logits, labels)


def make_train_step(
    model: bert.BertModel,
    optimizer: ClippedAdamW,
    *,
    temperature: float = 0.05,
    neg_weight: float = 1.0,
) -> Callable[..., torch.Tensor]:
    """``step(q_batch, d_batch, n_batch=None) -> loss``: one graded
    forward and backward of :func:`info_nce_loss` and one optimizer
    update of ``model`` in place.  The loss is a detached 0-d tensor."""
    dev = model.device

    def step(q_batch: Batch, d_batch: Batch, n_batch: Batch | None = None) -> torch.Tensor:
        with graded(model):
            loss = info_nce_loss(
                model, on_device(q_batch, dev), on_device(d_batch, dev), temperature,
                None if n_batch is None else on_device(n_batch, dev), neg_weight,
            )
            loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def tokenize_pairs(
    tokenizer: Tokenizer,
    pairs: list[tuple[str, ...]],
    *,
    max_len: int = 64,
) -> tuple[tuple[np.ndarray, ...], ...]:
    """(query, positive[, negative]) tuples -> padded batch arrays.

    Returns (q_batch, d_batch) for 2-tuples and (q_batch, d_batch,
    n_batch) for 3-tuples (hard-negative triples).
    """
    q_encs = [tokenizer.encode(p[0], max_len) for p in pairs]
    d_encs = [tokenizer.encode(p[1], max_len) for p in pairs]
    out = [pad_batch(q_encs), pad_batch(d_encs)]
    if pairs and len(pairs[0]) > 2:
        out.append(pad_batch([tokenizer.encode(p[2], max_len) for p in pairs]))
    return tuple(out)


def pairs_from_cache(
    cache, index, embedder, *, limit: int = 4096, min_rating: int = 0
):
    """Training pairs from the serving log: cached query -> its top chunk.

    The closed loop the reference README sketches: production queries
    (with cached answers) become supervision for the retriever.  A query
    whose net user rating (the sum of its +-1 ``user_feedback`` rows) is
    below ``min_rating`` is left out: the default 0 keeps unrated and
    net-positive queries, ``min_rating=1`` only approved ones.
    """
    pairs: list[tuple[str, str]] = []
    for query, _answer, net in cache.export_rated_pairs(limit):
        if net < min_rating:
            continue
        vec = embedder.encode([query])
        hits = index.search(vec, k=1)[0]
        if hits:
            pairs.append((query, hits[0]["text"]))
    return pairs


def _save(checkpoint_dir: str, step: int, model, optimizer) -> None:
    from financial_rag_system_tpu_torch.train.checkpoint import save_state

    save_state(checkpoint_dir, step, {"model": model.state_dict(), "opt": optimizer.state_dict()})


def _restore(checkpoint_dir: str, model, optimizer) -> int:
    """Load the latest checkpoint into ``model`` and ``optimizer``; its
    step, or 0 when there is none."""
    from financial_rag_system_tpu_torch.train.checkpoint import restore_state

    restored = restore_state(checkpoint_dir, map_location=model.device)
    if restored is None:
        return 0
    step, state = restored
    model.load_state_dict(state["model"])
    model.weights_changed()
    optimizer.load_state_dict(state["opt"])
    return step


def train(
    model: bert.BertModel,
    pairs: list[tuple[str, ...]],
    *,
    tokenizer: Tokenizer | None = None,
    epochs: int = 1,
    batch_size: int = 32,
    lr: float = 2e-5,
    temperature: float = 0.05,
    neg_weight: float = 1.0,
    seed: int = 0,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 100,
) -> tuple[bert.BertModel, list[float]]:
    """Epoch loop with optional checkpoint and resume (JAX ``train``).

    ``pairs`` items are (query, positive) or (query, positive, negative):
    3-tuples train with explicit hard negatives in the InfoNCE pool.
    Each epoch takes ``np.random.default_rng(seed)``'s next permutation
    and full batches of ``batch_size``, tokenized at 64 tokens.  Returns
    (``model``, trained in place, and the per-step losses).  With
    ``checkpoint_dir``, training starts from the latest saved step's model
    and optimizer state (the step count goes on from it; the epochs run
    in full), saves every ``checkpoint_every`` steps and once at the end.
    """
    tok = tokenizer or Tokenizer()
    # same rationale as train_cross_encoder: clip so the trajectory is
    # robust to shuffle order / supervision-size changes
    optimizer = ClippedAdamW(model, lr)
    step_count = _restore(checkpoint_dir, model, optimizer) if checkpoint_dir else 0
    step_fn = make_train_step(model, optimizer, temperature=temperature, neg_weight=neg_weight)
    rng = np.random.default_rng(seed)
    losses: list[float] = []
    for _ in range(epochs):
        order = rng.permutation(len(pairs))
        for s in range(0, len(pairs) - batch_size + 1, batch_size):
            chunk = [pairs[i] for i in order[s : s + batch_size]]
            losses.append(float(step_fn(*tokenize_pairs(tok, chunk))))
            step_count += 1
            if checkpoint_dir and step_count % checkpoint_every == 0:
                _save(checkpoint_dir, step_count, model, optimizer)
    if checkpoint_dir:
        _save(checkpoint_dir, step_count, model, optimizer)
    return model, losses
