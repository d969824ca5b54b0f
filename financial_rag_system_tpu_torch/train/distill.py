"""Cross-encoder -> bi-encoder knowledge distillation (Margin-MSE).

Port of ``financial_rag_system_tpu/train/distill.py`` to torch autograd.
After the two first-party trainers run (``train/contrastive.py``,
``train/cross_encoder.py``), the trained cross-encoder becomes the
TEACHER and the bi-encoder learns to match its pairwise score *margins*
(Margin-MSE, Hofstaetter et al. 2020): for each (query, positive,
negative) triple the student's ``(cos(q,p) - cos(q,n)) / temperature``
regresses onto the teacher's ``logit(q,p) - logit(q,n)``.  Margins, not
absolute scores: on bait triples the geometry cannot push a
near-duplicate negative far away without wrecking the topical
clustering, but it can order the pair by a small margin.

The teacher is frozen and scored once up front (:func:`teacher_margins`)
under ``torch.inference_mode``, through the serving forward: the
pair-attention kernel on the card where a batch's pairs pad to 256 tokens
or more (``models/bert.py _pair_attn_enabled``), the einsum attention
below.  ``evaluate.py``'s unpadded triples make pairs of 123 tokens on
average and at most 182, so a batch of them pads to 128 or 256.  The
student's steps are graded (``models/bert.py _graded``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from financial_rag_system_tpu_torch.models import bert
from financial_rag_system_tpu_torch.models.tokenizer import Tokenizer, pad_batch
from financial_rag_system_tpu_torch.train.contrastive import _embed, on_device
from financial_rag_system_tpu_torch.train.optim import ClippedAdamW, graded


def teacher_margins(
    ce_model: bert.BertModel,
    triples: list[tuple[str, str, str]],
    *,
    tokenizer: Tokenizer | None = None,
    max_len: int = 128,
    batch_size: int = 64,
) -> np.ndarray:
    """Teacher logit margins ``score(q,pos) - score(q,neg)``, one pass:
    two ``cross_score`` calls a batch of ``batch_size`` triples."""
    tok = tokenizer or Tokenizer()
    dev = ce_model.device
    out = np.zeros(len(triples), np.float32)
    with torch.inference_mode():
        for s in range(0, len(triples), batch_size):
            chunk = triples[s : s + batch_size]
            pos_encs = [tok.encode_pair(q, p, max_len) for q, p, _ in chunk]
            neg_encs = [tok.encode_pair(q, n, max_len) for q, _, n in chunk]
            p_logits = bert.cross_score(ce_model, *on_device(pad_batch(pos_encs), dev))
            n_logits = bert.cross_score(ce_model, *on_device(pad_batch(neg_encs), dev))
            m = (p_logits - n_logits).float().cpu().numpy()
            out[s : s + len(chunk)] = m[: len(chunk)]
    return out


def margin_mse_loss(model: bert.BertModel, q_batch, p_batch, n_batch, margins: torch.Tensor,
                    temperature: float = 0.05) -> torch.Tensor:
    """Mean squared gap between the student's cosine margin over
    ``temperature`` and the teacher's logit margin (JAX
    ``make_distill_step``'s ``loss_fn``)."""
    qv = _embed(model, *q_batch)
    pv = _embed(model, *p_batch)
    nv = _embed(model, *n_batch)
    s_pos = torch.sum(qv * pv, dim=-1) / temperature
    s_neg = torch.sum(qv * nv, dim=-1) / temperature
    return torch.mean((s_pos - s_neg - margins) ** 2)


def make_distill_step(
    model: bert.BertModel,
    optimizer: ClippedAdamW,
    *,
    temperature: float = 0.05,
) -> Callable[..., torch.Tensor]:
    """``step(q_batch, p_batch, n_batch, margins) -> loss``: one graded
    forward and backward of :func:`margin_mse_loss` and one update of
    ``model`` in place.  ``temperature`` maps the cosine range onto the
    teacher's logit scale; the InfoNCE stage's 0.05 keeps the two
    objectives' gradient scales commensurate."""
    dev = model.device

    def step(q_batch, p_batch, n_batch, margins) -> torch.Tensor:
        with graded(model):
            loss = margin_mse_loss(
                model, on_device(q_batch, dev), on_device(p_batch, dev),
                on_device(n_batch, dev), torch.as_tensor(margins, device=dev), temperature,
            )
            loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def distill(
    model: bert.BertModel,
    ce_model: bert.BertModel,
    triples: list[tuple[str, str, str]],
    *,
    tokenizer: Tokenizer | None = None,
    steps: int = 100,
    batch_size: int = 32,
    lr: float = 1e-5,
    temperature: float = 0.05,
    max_len: int = 64,
    teacher_max_len: int = 128,
    seed: int = 0,
) -> tuple[bert.BertModel, list[float]]:
    """Distill the trained cross-encoder ``ce_model`` into the (already
    trained) bi-encoder ``model`` over (query, positive, negative) text
    triples: ``steps`` steps over ``np.random.default_rng(seed)``
    permutations, a short low-lr refinement after InfoNCE training.
    Returns (``model``, refined in place, and the per-step losses)."""
    tok = tokenizer or Tokenizer()
    margins = teacher_margins(ce_model, triples, tokenizer=tok, max_len=teacher_max_len)
    optimizer = ClippedAdamW(model, lr)
    step_fn = make_distill_step(model, optimizer, temperature=temperature)
    rng = np.random.default_rng(seed)
    losses: list[float] = []
    done = 0
    while done < steps:
        order = rng.permutation(len(triples))
        for s in range(0, len(triples) - batch_size + 1, batch_size):
            if done >= steps:
                break
            idx = order[s : s + batch_size]
            chunk = [triples[i] for i in idx]
            # trim batch-bucket pad rows so margins stay row-aligned
            q_b, p_b, n_b = (
                tuple(a[: len(chunk)]
                      for a in pad_batch([tok.encode(t[j], max_len) for t in chunk]))
                for j in range(3)
            )
            losses.append(float(step_fn(q_b, p_b, n_b, margins[idx])))
            done += 1
    return model, losses
