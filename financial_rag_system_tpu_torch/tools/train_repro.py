"""Whether the port's trainers repeat themselves on one NVIDIA GPU.

    python3 financial_rag_system_tpu_torch/tools/train_repro.py

Three readings, each printed as one line:

- the embedding backward: on the trainers' id batches (word and token-type
  ids) and on uniform random ids, how many different gradients 20
  backwards of the same lookup give, and their median time, through
  ``F.embedding``, ``index_put_`` with accumulate, and ``models/bert.py
  _embedding`` (the graded forward's lookup);
- the first graded cross-encoder forward at full width (MiniLM-L6, the
  first batch of 32 pairs ``train_cross_encoder`` draws at the length the
  stack sizes for 1000-character chunks), run on one model twice and on a
  second model from the same weights: the loss and every dense product,
  attention, layernorm and GELU output compared bit for bit, then the
  gradients leaf by leaf;
- each trainer (cross-encoder, bi-encoder InfoNCE, distillation) run twice
  for 12 steps from the same weights and seed, with the graded lookup as
  the port has it and with ``F.embedding`` in its place: the losses and
  the weights compared.
"""

from __future__ import annotations

import contextlib
import hashlib
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from financial_rag_system_tpu_torch.data import synthetic  # noqa: E402
from financial_rag_system_tpu_torch.models import bert  # noqa: E402
from financial_rag_system_tpu_torch.models.tokenizer import Tokenizer, pad_batch  # noqa: E402
from financial_rag_system_tpu_torch.train import contrastive, cross_encoder, distill, stack  # noqa: E402
from financial_rag_system_tpu_torch.train.optim import graded  # noqa: E402

STEPS = 12


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().float().cpu().numpy().tobytes()).hexdigest()


def embedding_backwards() -> None:
    """Ways and median CUDA-event ms of 20 backwards of each lookup, on the
    first cross-encoder batch's word and type ids, a bi-encoder batch's
    (32 filler passages at 64 tokens) and uniform random ids."""
    _, _, _, batch, _ = first_cross_batch()
    tok = Tokenizer()
    passages = [p for _, p, _ in synthetic.make_filler_triples(chunk_chars=1000)[:32]]
    bi_ids, bi_types, _ = contrastive.on_device(pad_batch([tok.encode(t, 64) for t in passages]),
                                                "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [("cross-encoder batch word ids", batch[0].long(), 30522),
             ("cross-encoder batch type ids", batch[1].long(), 2),
             ("bi-encoder batch word ids", bi_ids.long(), 30522),
             ("bi-encoder batch type ids", bi_types.long(), 2),
             ("uniform word ids (32, 512)",
              torch.randint(0, 30522, (32, 512), device="cuda", generator=gen), 30522)]
    lookups = {"F.embedding": F.embedding, "bert._embedding": bert._embedding,
               "index_put_": None}
    for label, ids, rows in cases:
        g = torch.randn(*ids.shape, 384, device="cuda", generator=gen)
        out = {}
        for name, lookup in lookups.items():
            seen, ms = set(), []
            for _ in range(20):
                table = torch.zeros(rows, 384, device="cuda", requires_grad=True)
                y = None if lookup is None else lookup(ids, table)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                if lookup is None:
                    grad = torch.zeros(rows, 384, device="cuda").index_put_(
                        (ids.reshape(-1),), g.reshape(-1, 384), accumulate=True)
                else:
                    y.backward(g)
                    grad = table.grad
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
                seen.add(digest(grad))
            out[name] = f"{len(seen)} ways, {float(np.median(ms)):.4f} ms"
        print(f"embedding backward, {label} {tuple(ids.shape)}, {rows} rows, 20 runs: {out}",
              flush=True)


def first_cross_batch():
    cfg = bert.MINILM_L6_CROSS
    examples = cross_encoder.make_cross_examples(seed=1, chunk_chars=1000)
    max_len = stack.reranker_len(examples, cfg, 1000)
    order = np.random.default_rng(1).permutation(len(examples))
    chunk = [examples[i] for i in order[:32]]
    tok = Tokenizer()
    ids, types, mask = pad_batch([tok.encode_pair(q, d, max_len) for q, d, _ in chunk])
    labels = np.zeros(ids.shape[0], np.float32)
    labels[:32] = [lbl for *_, lbl in chunk]
    n_pos = sum(1 for *_, lbl in examples if lbl > 0.5)
    batch = contrastive.on_device((ids, types, mask, torch.from_numpy(labels)), "cuda")
    return examples, order, max_len, batch, (len(examples) - n_pos) / n_pos


@contextlib.contextmanager
def recorded(names=("_proj", "_einsum_attention", "_ln", "_gelu")):
    """Record the outputs of ``models/bert.py``'s ops for the block."""
    out, saved = [], {n: getattr(bert, n) for n in names}

    def wrap(name, fn):
        def call(*a, **k):
            y = fn(*a, **k)
            out.append((name, y.detach().float().cpu().clone()))
            return y
        return call

    for n, fn in saved.items():
        setattr(bert, n, wrap(n, fn))
    try:
        yield out
    finally:
        for n, fn in saved.items():
            setattr(bert, n, fn)


def first_forward() -> None:
    _, _, max_len, batch, pos_weight = first_cross_batch()

    def run(model):
        with recorded() as ops, graded(model):
            loss = cross_encoder.bce_loss(model, *batch, pos_weight)
            loss.backward()
        grads = {k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()
                 if p.grad is not None}
        for p in model.parameters():
            p.grad = None
        return float(loss.detach()), ops, grads

    first = stack.init_model(bert.MINILM_L6_CROSS, 1, "cuda")
    a, b = run(first), run(first)
    c = run(stack.init_model(bert.MINILM_L6_CROSS, 1, "cuda"))
    for label, (la, oa, ga), (lb, ob, gb) in (("one model twice", a, b),
                                              ("two models", a, c)):
        ops_apart = [n for (n, x), (_, y) in zip(oa, ob) if not torch.equal(x, y)]
        leaves = {k: float((ga[k] - gb[k]).abs().max()) for k in ga
                  if not torch.equal(ga[k], gb[k])}
        print(f"first graded cross-encoder forward (32, {batch[0].shape[1]}), {label}: loss "
              f"{la!r} and {lb!r}; {len(oa)} op outputs, {len(ops_apart)} apart; gradient "
              f"leaves apart {leaves}", flush=True)


@contextlib.contextmanager
def plain_lookup():
    """``F.embedding`` in the graded forward's place, for the block."""
    saved = bert._embedding
    bert._embedding = F.embedding
    try:
        yield
    finally:
        bert._embedding = saved


def trainers_twice() -> None:
    examples, order, max_len, _, _ = first_cross_batch()
    pairs = [examples[i] for i in order[: 32 * STEPS]]
    triples = synthetic.make_filler_triples(chunk_chars=1000)[: 32 * STEPS]
    taught = (synthetic.make_train_triples() + synthetic.make_filler_triples())[: 32 * STEPS]

    def train(tower):
        if tower == "cross-encoder":
            model = stack.init_model(bert.MINILM_L6_CROSS, 1, "cuda")
            _, losses = cross_encoder.train_cross_encoder(model, pairs, lr=1e-4,
                                                          max_len=max_len, seed=1)
        elif tower == "bi-encoder":
            model = stack.init_model(bert.BGE_SMALL, 0, "cuda")
            _, losses = contrastive.train(model, triples, lr=1e-4, neg_weight=0.5)
        else:
            model = stack.init_model(bert.BGE_SMALL, 0, "cuda")
            teacher = stack.init_model(bert.MINILM_L6_CROSS, 1, "cuda")
            _, losses = distill.distill(model, teacher, taught, steps=STEPS, lr=1e-4,
                                        teacher_max_len=max_len)
        return losses, [p.detach().clone() for p in model.parameters()]

    for label, ctx in (("as the port has it", contextlib.nullcontext),
                       ("with F.embedding", plain_lookup)):
        for tower in ("cross-encoder", "bi-encoder", "distillation"):
            with ctx():
                (la, wa), (lb, wb) = train(tower), train(tower)
            dw = max(float((x - y).abs().max()) for x, y in zip(wa, wb))
            print(f"{tower} trained twice, {label}: {len(la)} steps, losses equal {la == lb} "
                  f"(last {la[-1]!r} and {lb[-1]!r}); weights {dw!r} apart", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("train_repro: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda, flush=True)
    embedding_backwards()
    first_forward()
    trainers_twice()
    return 0


if __name__ == "__main__":
    sys.exit(main())
