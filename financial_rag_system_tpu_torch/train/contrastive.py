"""Contrastive fine-tuning of the bi-encoder on the serving query log.

Port of ``financial_rag_system_tpu/train/contrastive.py`` to torch
autograd: symmetric InfoNCE over (query, positive chunk) pairs with
in-batch negatives, optionally with one explicit hard negative per pair
whose logits are discounted by ``log(neg_weight)``, then optax's clipped
AdamW (:class:`train.optim.ClippedAdamW`).  The functions take the
port's ``BertModel`` and update it in place where the JAX ones take and
return a parameter pytree.  The forward runs graded
(``models/bert.py _graded``): the einsum attention and the unfused layer
at every length, the path the JAX trainer differentiates.

With a ``mesh`` the step is data-parallel over its ``data`` axis, as
JAX's ``shard_map`` step is: the global batch is cut into one
micro-batch of ``B / data`` rows per data shard; each shard embeds its
micro-batch, the document (and hard-negative) embeddings are gathered
over the axis (``parallel.collectives.all_gather_data``, whose backward
carries every shard's query terms to the documents' home shard), so
each query contrasts against the global pool with its label offset by
its shard's first row; then the loss and every gradient are averaged
over the axis (``pmean_``) before the one optimizer update, which every
replica applies alike.  This process's shards run one after another
through the one model (they must sit on the model's device: several
cards train as one process a card); the ``data`` axis spans the
processes of a process group (``parallel/mesh.py``).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from financial_rag_system_tpu_torch.models import bert
from financial_rag_system_tpu_torch.models.tokenizer import Tokenizer, pad_batch
from financial_rag_system_tpu_torch.parallel.collectives import all_gather_data, pmean_
from financial_rag_system_tpu_torch.parallel.mesh import AXIS_DATA, Mesh
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


def _shard_towers(model: bert.BertModel, mesh: Mesh, batches: list[Batch]
                  ) -> tuple[list[int], int, list[list[torch.Tensor]]]:
    """This process's data shards' global indices, the rows ``b`` a shard,
    and for each shard the embeddings of its rows ``[i b, (i + 1) b)`` of
    each global batch (queries, documents[, negatives]), in that order,
    as :func:`info_nce_loss` embeds them."""
    dev, n = model.device, mesh.shape[AXIS_DATA]
    rows = batches[0][0].shape[0]
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split over {AXIS_DATA}:{n}")
    b = rows // n
    shards = [mesh.data_index(r) for r in range(mesh.local_data)]
    towers = [[_embed(model, *on_device(tuple(a[i * b:(i + 1) * b] for a in batch), dev))
               for batch in batches] for i in shards]
    return shards, b, towers


def _shard_losses(mesh: Mesh, shards: list[int], b: int, towers: list[list[torch.Tensor]],
                  temperature: float, neg_weight: float) -> list[torch.Tensor]:
    """JAX ``info_nce_loss`` under ``shard_map`` over the ``data`` axis:
    each local shard's queries against the gathered documents (and
    negatives, ``+ log(neg_weight)``), labels offset by its first global
    row ``i b``; one mean cross-entropy a shard, with the ops in
    :func:`info_nce_loss`'s order."""
    qv = [t[0] for t in towers]
    all_d = all_gather_data(mesh, [t[1] for t in towers])
    logits = [q @ all_d.t() / temperature for q in qv]
    if len(towers[0]) > 2:
        all_n = all_gather_data(mesh, [t[2] for t in towers])
        logits = [torch.cat([lg, q @ all_n.t() / temperature + math.log(neg_weight)], dim=1)
                  for lg, q in zip(logits, qv)]
    return [F.cross_entropy(lg, i * b + torch.arange(b, device=lg.device))
            for lg, i in zip(logits, shards)]


def _check_mesh(model: bert.BertModel, mesh: Mesh) -> None:
    """Every local data shard's device must be the model's."""
    def canonical(d: torch.device) -> torch.device:
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d

    rows = [row[0] for row in mesh.grid]
    if any(canonical(d) != canonical(model.device) for d in rows):
        raise ValueError(
            f"the data shards sit on {[str(d) for d in rows]}, the model on {model.device}: "
            f"one process trains on one device (several cards train as one process a card)")


def make_train_step(
    model: bert.BertModel,
    optimizer: ClippedAdamW,
    *,
    temperature: float = 0.05,
    neg_weight: float = 1.0,
    mesh: Mesh | None = None,
) -> Callable[..., torch.Tensor]:
    """``step(q_batch, d_batch, n_batch=None) -> loss``: one graded
    forward and backward of :func:`info_nce_loss` and one optimizer
    update of ``model`` in place.  The loss is a detached 0-d tensor.

    With a ``mesh`` the batches are global (their rows split evenly over
    the ``data`` axis) and the step is data-parallel (module docstring):
    the loss returned is the mean over every data shard.  Without one the
    step runs over a one-shard mesh on the model's device, which gives
    :func:`info_nce_loss`'s loss and gradients bit for bit."""
    if mesh is None:
        # one data shard on the model's device: the gather is a copy and
        # the mean divides by one, so this is the plain one-device step
        mesh = Mesh([[model.device]])
    _check_mesh(model, mesh)
    params = list(model.parameters())

    def step(q_batch: Batch, d_batch: Batch, n_batch: Batch | None = None) -> torch.Tensor:
        batches = [q_batch, d_batch] + ([] if n_batch is None else [n_batch])
        with graded(model):
            shards, b, towers = _shard_towers(model, mesh, batches)
            # the loss is differentiated to the shards' embeddings first,
            # then each shard's encoder backward runs in turn: the
            # parameters' gradient is the shards' own gradients summed in
            # shard order, the sum the ranks' all_reduce forms
            loose = [[e.detach().requires_grad_() for e in t] for t in towers]
            losses = _shard_losses(mesh, shards, b, loose, temperature, neg_weight)
            total = sum(losses[1:], losses[0])
            total.backward()
            for tower, ends in zip(towers, loose):
                graded_ends = [(e, g.grad) for e, g in zip(tower, ends) if g.grad is not None]
                if graded_ends:
                    torch.autograd.backward(*zip(*graded_ends))
        loss = total.detach().clone()
        pmean_(mesh, [loss] + [p.grad for p in params if p.grad is not None])
        optimizer.step()
        return loss

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


def _save(checkpoint_dir: str, step: int, model, optimizer, mesh: Mesh | None = None) -> None:
    """Rank 0 writes the checkpoint; under a process group every rank
    then waits at a barrier, so none restores a half-written one."""
    from financial_rag_system_tpu_torch.train.checkpoint import save_state

    if mesh is None or mesh.rank == 0:
        save_state(checkpoint_dir, step,
                   {"model": model.state_dict(), "opt": optimizer.state_dict()})
    if mesh is not None and mesh.ranks_axis is not None:
        import torch.distributed as dist

        dist.barrier()


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
    mesh: Mesh | None = None,
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

    With a ``mesh`` the step is data-parallel (:func:`make_train_step`)
    and the batch is ``batch_size`` rounded down to a multiple of the
    ``data`` size (at least one row a shard), as JAX's is.  Under a
    process group every rank draws the same permutation and tokenizes the
    same global batches, every rank restores, and rank 0 alone writes.
    """
    tok = tokenizer or Tokenizer()
    # same rationale as train_cross_encoder: clip so the trajectory is
    # robust to shuffle order / supervision-size changes
    optimizer = ClippedAdamW(model, lr)
    step_count = _restore(checkpoint_dir, model, optimizer) if checkpoint_dir else 0
    step_fn = make_train_step(model, optimizer, temperature=temperature, neg_weight=neg_weight,
                              mesh=mesh)
    n_dev = mesh.shape[AXIS_DATA] if mesh is not None else 1
    bs = max(batch_size, n_dev) // n_dev * n_dev  # divisible micro-batching
    rng = np.random.default_rng(seed)
    losses: list[float] = []
    for _ in range(epochs):
        order = rng.permutation(len(pairs))
        for s in range(0, len(pairs) - bs + 1, bs):
            chunk = [pairs[i] for i in order[s : s + bs]]
            losses.append(float(step_fn(*tokenize_pairs(tok, chunk))))
            step_count += 1
            if checkpoint_dir and step_count % checkpoint_every == 0:
                _save(checkpoint_dir, step_count, model, optimizer, mesh)
    if checkpoint_dir:
        _save(checkpoint_dir, step_count, model, optimizer, mesh)
    return model, losses
