"""``python -m financial_rag_system_tpu_torch.train.stack`` on the CPU:
train both towers, distill, export, and serve the exports through
``build_default_engine(device="cpu")``.  The supervision is cut to a few
batches so each trainer's epoch is two steps.  The stack's distillation
is held to ``evaluate.py``'s ``--distill`` block: the same unpadded
triples, and the same steps as JAX's ``distill`` from the same weights."""

from __future__ import annotations

import asyncio
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from financial_rag_system_tpu_torch.data import synthetic
from financial_rag_system_tpu_torch.train import cross_encoder, stack
from financial_rag_system_tpu_torch.utils.config import reset_config

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def small_supervision(monkeypatch):
    """Each supervision maker's first rows only."""
    for module, name, n in ((synthetic, "make_filler_triples", 64),
                            (synthetic, "make_train_triples", 32),
                            (cross_encoder, "make_cross_examples", 64)):
        full = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _f=full, _n=n, **k: _f(*a, **k)[:_n])


def test_stack_entry_trains_exports_and_serves_on_the_cpu(tmp_path, monkeypatch,
                                                          small_supervision):
    from financial_rag_system_tpu_torch.train import distill

    out = tmp_path / "trained"
    taught = []
    monkeypatch.setattr(distill, "distill",
                        lambda m, ce, triples, _d=distill.distill, **k:
                        taught.append(triples) or _d(m, ce, triples, **k))
    emb, rr = stack.main([
        "--device", "cpu", "--trained-arch", "compact", "--train-steps", "2",
        "--two-stage", "--filler-negatives", "--neg-weight", "0.5", "--distill", "2",
        "--chunk-chars", "300", "--save-trained", str(out),
    ])
    # distilled on the unpadded triples, whatever --chunk-chars says
    assert taught == [stack.distill_triples("both")]
    assert emb.device.type == "cpu" and emb.cfg == stack.encoder_cfg("compact")
    assert rr.cfg == stack.reranker_cfg("compact") and rr.max_len >= 128
    # trained and back to the serving state
    assert not any(p.requires_grad for p in emb.model.parameters())
    for name in ("bge", "reranker"):
        assert (out / name / "pytorch_model.bin").exists()

    monkeypatch.setenv("RAG_TPU_BGE_DIR", str(out / "bge"))
    monkeypatch.setenv("RAG_TPU_RERANKER_DIR", str(out / "reranker"))
    monkeypatch.setenv("INDEX_DIR", str(tmp_path / "index"))
    monkeypatch.setenv("DATABASE_URL", ":memory:")
    monkeypatch.setenv("TESTING", "true")
    monkeypatch.setenv("RAG_TPU_CB_PATH", str(tmp_path / "cb.json"))
    monkeypatch.setenv("RAG_TPU_BATCH_WINDOW_S", "0.01")
    reset_config()
    try:
        from financial_rag_system_tpu_torch.serving.app import build_default_engine

        engine = build_default_engine(device="cpu")
        assert engine.embedder.max_len == 64 and engine.reranker.max_len == rr.max_len
        ids, texts, payloads = synthetic.make_hard_corpus(256, chunk_chars=300)
        # the served towers compute what the trained ones do
        np.testing.assert_allclose(engine.embedder.encode(texts[:8]), emb.encode(texts[:8]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(engine.reranker.score("revenue", texts[:4]),
                                   rr.score("revenue", texts[:4]), rtol=1e-5, atol=1e-5)
        asyncio.run(engine.ingest_chunks(ids, texts, payloads))
        assert engine.queue_status()["fused_kind"] == "full"
        questions = synthetic.make_hard_set(["AAPL", "MSFT"])[:3]

        async def scenario():
            await engine.startup()
            try:
                return await asyncio.gather(*[
                    engine.ask(q["query"], q["ticker"], 5) for q in questions])
            finally:
                await engine.shutdown()

        answers = asyncio.run(scenario())
    finally:
        reset_config()
    for q, a in zip(questions, answers):
        scores = [s["score"] for s in a["sources"]]
        assert not a["cached"] and len(scores) == 5 and np.isfinite(scores).all()
        assert scores == sorted(scores, reverse=True)


def test_stack_trains_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stack.main(["--trained-arch", "compact", "--train-steps", "1"])


def test_stack_module_entry_point_parses_evaluates_flags():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "financial_rag_system_tpu_torch.train.stack", "--help"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120, check=True,
    ).stdout
    for flag in ("--trained-arch", "--train-steps", "--two-stage", "--hard-negatives",
                 "--filler-negatives", "--neg-weight", "--distill", "--distill-triples",
                 "--distill-temp", "--chunk-chars", "--save-trained", "--device"):
        assert flag in out
    args = stack.parse_args([])
    assert args.device == "cuda" and args.train_steps == 150 and args.distill_temp == 0.05


@pytest.mark.parametrize("chunk_chars", [None, 1000])
def test_reranker_pair_length_is_sized_as_in_jax(chunk_chars):
    """``reranker_len`` gives the pair length ``evaluate.py
    trained_reranker`` computes (128, or the p99 of the pair wordpieces
    rounded up to 32 at 1000-character chunks)."""
    from financial_rag_system_tpu.index.flat import auto_token_width
    from financial_rag_system_tpu.models.tokenizer import Tokenizer as JTokenizer
    from financial_rag_system_tpu.train.cross_encoder import make_cross_examples as jexamples

    cfg = stack.reranker_cfg("bge")
    examples = cross_encoder.make_cross_examples(seed=1, chunk_chars=chunk_chars)
    assert examples == jexamples(seed=1, chunk_chars=chunk_chars)
    want = 128
    if chunk_chars:
        tok = JTokenizer()
        lens = [len(tok.tokenize_ids(q)) + len(tok.tokenize_ids(c)) + 3 for q, c, _ in examples]
        want = min(cfg.max_positions,
                   max(128, auto_token_width(lens, cap=cfg.max_positions, multiple=32)))
        assert want >= 256  # the pair-attention kernel's range when serving
    assert stack.reranker_len(examples, cfg, chunk_chars) == want


@pytest.mark.parametrize("which", ["both", "bait", "filler"])
def test_distill_triples_are_evaluates(which):
    """``distill_triples`` builds what ``evaluate.py``'s ``--distill`` block
    builds for ``--distill-triples`` (``:525-529``): the JAX makers'
    triples, unpadded."""
    from financial_rag_system_tpu.data import synthetic as jsynthetic

    want = []
    if which in ("both", "bait"):
        want += jsynthetic.make_train_triples()
    if which in ("both", "filler"):
        want += jsynthetic.make_filler_triples()
    assert stack.distill_triples(which) == want


def test_stack_distillation_matches_jax(monkeypatch, small_supervision):
    """``distill_encoder`` takes the steps ``evaluate.py``'s ``--distill``
    block takes through JAX's ``distill`` (teacher at the reranker's
    length, student at the embedder's, the same temperature), from the
    same weights, held to the five-step trajectory tolerances of
    ``tests/test_torch_train.py``."""
    from financial_rag_system_tpu.data import synthetic as jsynthetic
    from financial_rag_system_tpu.train import distill as jdist
    from financial_rag_system_tpu_torch.models import bert
    from financial_rag_system_tpu_torch.models.embedder import BiEncoder
    from financial_rag_system_tpu_torch.models.reranker import CrossEncoderReranker
    from financial_rag_system_tpu_torch.models.tokenizer import Tokenizer
    from tests.test_torch_train import CROSS, ENC, TRAJ_LOSS_RTOL, leaves, models

    params, jcfg, model = models(ENC)
    ce_params, ce_jcfg, _ = models(CROSS, seed=1)
    # a teacher with margins of about 0.1, not 1e-5 as at init
    ce_params["classifier"]["w"] = ce_params["classifier"]["w"] * 1e4
    _, _, ce_model = models(CROSS, params=ce_params)
    emb = BiEncoder(model, model.cfg, Tokenizer(), pooling="cls", max_len=32)
    rr = CrossEncoderReranker(ce_model, ce_model.cfg, Tokenizer(), max_len=64)
    losses = stack.distill_encoder(emb, rr, 3, which="both", temperature=0.05)
    triples = jsynthetic.make_train_triples()[:32] + jsynthetic.make_filler_triples()[:64]
    jp, jl = jdist.distill(params, jcfg, ce_params, ce_jcfg, triples, steps=3,
                           teacher_max_len=64, max_len=32, temperature=0.05)
    np.testing.assert_allclose(losses, jl, rtol=TRAJ_LOSS_RTOL)
    lr = 1e-5  # distill's default, which both entries take
    a, b = leaves(jp), leaves(bert.export_jax_params(model))
    for k in a:
        assert np.abs(a[k] - b[k]).max() <= 2 * 3 * lr, k
