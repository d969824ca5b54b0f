"""Train the serving stack, export it, and serve it: the training half of
``evaluate.py`` for the port.

    python -m financial_rag_system_tpu_torch.train.stack --trained-arch bge \\
        --two-stage --filler-negatives --neg-weight 0.5 --distill 50 \\
        --chunk-chars 1000 --save-trained OUT [--device cuda]

trains a BERT bi-encoder with InfoNCE (:mod:`train.contrastive`) and,
with ``--two-stage``, a cross-encoder with BCE
(:mod:`train.cross_encoder`) from the port's seeded random init, on the
paraphrase supervision of :mod:`data.synthetic` (disjoint from the hard
eval queries); ``--distill N`` then refines the bi-encoder for N
Margin-MSE steps against the trained cross-encoder (:mod:`train.distill`),
and ``--save-trained OUT`` writes ``OUT/bge`` and ``OUT/reranker`` as HF
checkpoints, which ``build_default_engine`` serves through
``RAG_TPU_BGE_DIR`` and ``RAG_TPU_RERANKER_DIR``.  ``--trained-arch bge``
is the full serving architecture (12L/384 BGE-small and the 6-layer
MiniLM cross-encoder), ``compact`` the small towers.  It runs on the card
(``--device cuda``, the default, which raises without one) unless asked
for the CPU.

The functions follow ``evaluate.py:72-243`` and its ``--distill`` block
(``:515-545``): the distillation triples are built unpadded there, whatever
``--chunk-chars`` says, and so here.  The retrieval metrics of
``evaluate.py`` are not part of this module.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from financial_rag_system_tpu_torch.models import bert
from financial_rag_system_tpu_torch.models.embedder import BiEncoder
from financial_rag_system_tpu_torch.models.reranker import CrossEncoderReranker
from financial_rag_system_tpu_torch.models.tokenizer import Tokenizer
from financial_rag_system_tpu_torch.utils.device import resolve_device


def encoder_cfg(arch: str) -> bert.BertConfig:
    if arch == "bge":
        # the full serving architecture (BAAI/bge-small-en-v1.5's shape)
        return bert.BGE_SMALL
    return bert.BertConfig(
        vocab_size=30522, hidden=128, layers=4, heads=4, intermediate=256,
        max_positions=128, with_pooler=True,
    )


def reranker_cfg(arch: str) -> bert.BertConfig:
    if arch == "bge":
        # the full cross-encoder architecture (ms-marco MiniLM-L-6's shape)
        return bert.MINILM_L6_CROSS
    return bert.BertConfig(
        vocab_size=30522, hidden=128, layers=2, heads=4, intermediate=256,
        max_positions=256, with_pooler=True, num_labels=1,
    )


def init_model(cfg: bert.BertConfig, seed: int, device: str | torch.device) -> bert.BertModel:
    """A ``BertModel`` on ``device`` with the port's random init
    (``bert.init_params``) drawn from ``torch.Generator().manual_seed(seed)``."""
    model = bert.BertModel(cfg, device=device)
    return bert.load_jax_params(model, bert.init_params(torch.Generator().manual_seed(seed), cfg))


def trained_encoder(
    *, steps: int = 150, seed: int = 0, lr: float | None = None,
    arch: str = "compact", hard_negatives: bool = False,
    filler_negatives: bool = False, neg_weight: float = 1.0,
    chunk_chars: int | None = None, device: str | torch.device = "cuda",
) -> BiEncoder:
    """A contrastively trained BERT bi-encoder from random init: InfoNCE
    over (paraphrase, positive) pairs, or triples with a bait
    (``hard_negatives``) or filler-note (``filler_negatives``) negative
    each, for about ``steps`` steps of 32 (whole epochs)."""
    from financial_rag_system_tpu_torch.data.synthetic import (
        make_filler_triples,
        make_train_pairs,
        make_train_triples,
    )
    from financial_rag_system_tpu_torch.train.contrastive import train

    cfg = encoder_cfg(arch)
    if lr is None:
        lr = 1e-4 if arch == "bge" else 3e-4
    model = init_model(cfg, seed, resolve_device(device))
    if hard_negatives:
        pairs: list[tuple[str, ...]] = make_train_triples(chunk_chars=chunk_chars)
    elif filler_negatives:
        pairs = make_filler_triples(chunk_chars=chunk_chars)
    else:
        pairs = make_train_pairs(chunk_chars=chunk_chars)
    epochs = max(1, (steps * 32) // len(pairs))
    t0 = time.time()
    _, losses = train(model, pairs, epochs=epochs, batch_size=32, lr=lr, seed=seed,
                      neg_weight=neg_weight)
    print(
        f"trained {arch} encoder ({cfg.layers}L/{cfg.hidden}) "
        f"{len(losses)} steps on {len(pairs)} pairs in "
        f"{time.time()-t0:.0f}s: loss {losses[0]:.3f} -> {losses[-1]:.3f}"
    )
    return BiEncoder(model, cfg, Tokenizer(), pooling="cls", max_len=64)


def reranker_len(examples, cfg: bert.BertConfig, chunk_chars: int | None) -> int:
    """The pair length the reranker trains and serves at: 128, or with
    ``chunk_chars`` the p99 of the examples' pair wordpieces rounded up to
    32 (``index/flat.py auto_token_width``), at least 128 and at most the
    architecture's positions.  Positions past the trained length stay at
    their random init, so serving must truncate exactly where training
    did (the exported ``max_seq_length``)."""
    if not chunk_chars:
        return 128
    from financial_rag_system_tpu_torch.index.flat import auto_token_width

    tok = Tokenizer()
    lens = [len(tok.tokenize_ids(q)) + len(tok.tokenize_ids(c)) + 3 for q, c, _ in examples]
    return min(cfg.max_positions,
               max(128, auto_token_width(lens, cap=cfg.max_positions, multiple=32)))


def trained_reranker(
    *, steps: int = 150, seed: int = 1, lr: float = 1e-4,
    arch: str = "compact", chunk_chars: int | None = None,
    device: str | torch.device = "cuda",
) -> CrossEncoderReranker:
    """A cross-encoder trained on paraphrase positives and bait and
    filler negatives (:func:`train.cross_encoder.train_cross_encoder`)."""
    from financial_rag_system_tpu_torch.train.cross_encoder import (
        make_cross_examples,
        train_cross_encoder,
    )

    cfg = reranker_cfg(arch)
    model = init_model(cfg, seed, resolve_device(device))
    examples = make_cross_examples(seed=seed, chunk_chars=chunk_chars)
    epochs = max(1, (steps * 32) // len(examples))
    max_len = reranker_len(examples, cfg, chunk_chars)
    if chunk_chars:
        print(f"reranker max_len auto-sized to {max_len} "
              f"(p99 pair wordpieces at chunk_chars={chunk_chars})")
    t0 = time.time()
    _, losses = train_cross_encoder(model, examples, epochs=epochs, batch_size=32, lr=lr,
                                    max_len=max_len, seed=seed)
    print(
        f"trained {arch} reranker ({cfg.layers}L/{cfg.hidden}) "
        f"{len(losses)} steps on {len(examples)} pairs in "
        f"{time.time()-t0:.0f}s: loss {losses[0]:.3f} -> {losses[-1]:.3f}"
    )
    return CrossEncoderReranker(model, cfg, Tokenizer(), max_len=max_len)


def distill_triples(which: str = "both"):
    """The distillation triples, as ``evaluate.py`` builds them: bait
    (``make_train_triples()``), filler (``make_filler_triples()``) or both,
    unpadded."""
    from financial_rag_system_tpu_torch.data.synthetic import (
        make_filler_triples,
        make_train_triples,
    )

    triples = []
    if which in ("both", "bait"):
        triples += make_train_triples()
    if which in ("both", "filler"):
        triples += make_filler_triples()
    return triples


def distill_encoder(embedder: BiEncoder, reranker: CrossEncoderReranker, steps: int, *,
                    which: str = "both", temperature: float = 0.05) -> list[float]:
    """Refine ``embedder``'s model in place for ``steps`` Margin-MSE steps
    against ``reranker``'s margins; returns the losses."""
    from financial_rag_system_tpu_torch.train.distill import distill

    triples = distill_triples(which)
    t0 = time.time()
    _, losses = distill(
        embedder.model, reranker.model, triples, steps=steps,
        teacher_max_len=reranker.max_len, max_len=embedder.max_len, temperature=temperature,
    )
    print(
        f"distilled cross-encoder margins into the bi-encoder: "
        f"{len(losses)} steps on {len(triples)} triples in "
        f"{time.time()-t0:.0f}s, loss {losses[0]:.3f} -> {losses[-1]:.3f}"
    )
    return losses


def save_trained(embedder: BiEncoder, reranker: CrossEncoderReranker | None, out_dir: str) -> None:
    """Export the trained models as HF checkpoints, ``out_dir/bge`` and
    ``out_dir/reranker``, with their trained sequence lengths, for serving
    through ``RAG_TPU_BGE_DIR`` / ``RAG_TPU_RERANKER_DIR`` (no vocab.txt:
    ``Tokenizer.from_dir`` falls back to the hash vocab they trained with)."""
    from financial_rag_system_tpu_torch.models.hf_export import save_bert_checkpoint

    bge_dir = os.path.join(out_dir, "bge")
    rr_dir = os.path.join(out_dir, "reranker")
    save_bert_checkpoint(embedder.model, embedder.cfg, bge_dir, max_seq_length=embedder.max_len)
    if reranker is not None:
        save_bert_checkpoint(reranker.model, reranker.cfg, rr_dir, cross_encoder=True,
                             max_seq_length=reranker.max_len)
    print(f"exported trained checkpoints: RAG_TPU_BGE_DIR={bge_dir}"
          + (f" RAG_TPU_RERANKER_DIR={rr_dir}" if reranker else ""))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trained-arch", choices=("compact", "bge"), default="compact",
                    help="compact = the small towers; bge = the full serving "
                         "architectures (12L/384 BGE-small + 6L MiniLM cross-encoder)")
    ap.add_argument("--train-steps", type=int, default=150)
    ap.add_argument("--two-stage", action="store_true",
                    help="train the cross-encoder reranker too")
    ap.add_argument("--hard-negatives", action="store_true",
                    help="train the bi-encoder on (query, positive, bait) triples")
    ap.add_argument("--filler-negatives", action="store_true",
                    help="train the bi-encoder on (query, positive, filler-note) triples")
    ap.add_argument("--neg-weight", type=float, default=1.0,
                    help="denominator weight of the explicit negatives (1.0 = full strength)")
    ap.add_argument("--distill", type=int, default=0, metavar="STEPS",
                    help="after both trainers, refine the bi-encoder for STEPS Margin-MSE "
                         "steps against the cross-encoder's margins (needs --two-stage)")
    ap.add_argument("--distill-triples", choices=("both", "bait", "filler"), default="both")
    ap.add_argument("--distill-temp", type=float, default=0.05,
                    help="the student's cosine margin divides by this before regressing "
                         "onto the teacher's logit margin")
    ap.add_argument("--chunk-chars", type=int, default=0,
                    help="pad the supervision's chunks toward this many chars (the corpus "
                         "builders' 1000-char chunks; 0 = the ~150-char texts); sizes the "
                         "reranker's pair length")
    ap.add_argument("--save-trained", metavar="DIR", default="",
                    help="export the trained models as HF checkpoints for serving via "
                         "RAG_TPU_BGE_DIR / RAG_TPU_RERANKER_DIR")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; cpu only when asked)")
    return ap.parse_args(argv)


def main(argv=None) -> tuple[BiEncoder, CrossEncoderReranker | None]:
    """Train (and export) as the flags say; returns the trained
    (embedder, reranker or None)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    chunk_chars = args.chunk_chars or None
    emb = trained_encoder(
        steps=args.train_steps, arch=args.trained_arch,
        hard_negatives=args.hard_negatives, filler_negatives=args.filler_negatives,
        neg_weight=args.neg_weight, chunk_chars=chunk_chars, device=dev,
    )
    rr = None
    if args.two_stage:
        rr = trained_reranker(steps=args.train_steps, arch=args.trained_arch,
                              chunk_chars=chunk_chars, device=dev)
    if args.distill and rr is not None:
        distill_encoder(emb, rr, args.distill, which=args.distill_triples,
                        temperature=args.distill_temp)
    if args.save_trained:
        save_trained(emb, rr, args.save_trained)
    return emb, rr


if __name__ == "__main__":
    main()
