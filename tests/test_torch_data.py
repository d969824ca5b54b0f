"""The port's copies of ``data/synthetic.py`` and ``data/chunker.py``
give outputs identical to the JAX package's."""

from __future__ import annotations

import pytest

from financial_rag_system_tpu.data import chunker as jchunker
from financial_rag_system_tpu.data import synthetic as jsyn
from financial_rag_system_tpu_torch.data import chunker as tchunker
from financial_rag_system_tpu_torch.data import synthetic as tsyn

GENERATORS = [
    ("make_corpus", dict(n_chunks=300)),
    ("make_corpus", dict(n_chunks=300, seed=3, chunk_chars=1000)),
    ("make_hard_corpus", dict(n_chunks=600)),
    ("make_hard_corpus", dict(n_chunks=600, seed=2, chunk_chars=1000)),
    ("make_hard_corpus", dict(n_chunks=400, tickers=["AAPL", "META"], chunk_chars=600)),
    ("make_hard_set", dict()),
    ("make_hard_set", dict(tickers=["JPM"])),
    ("make_train_pairs", dict()),
    ("make_train_pairs", dict(chunk_chars=1000)),
    ("make_train_triples", dict()),
    ("make_train_triples", dict(tickers=["MSFT"], chunk_chars=1000)),
    ("make_filler_triples", dict()),
    ("make_filler_triples", dict(chunk_chars=1000)),
]


@pytest.mark.parametrize("name,kwargs", GENERATORS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(GENERATORS)])
def test_generator_matches_jax(name, kwargs):
    assert getattr(tsyn, name)(**kwargs) == getattr(jsyn, name)(**kwargs)


@pytest.mark.parametrize("name", ["GOLDEN_SET", "HARD_INTENTS", "TRAIN_PARAPHRASES",
                                  "EASY_TRAIN_PARAPHRASES", "AAPL_TOPICS"])
def test_tables_match_jax(name):
    assert getattr(tsyn, name) == getattr(jsyn, name)


@pytest.mark.parametrize("chunk_chars", [None, 0, 200, 1000, 4000])
def test_expand_chunk_matches_jax(chunk_chars):
    for text in (jsyn.AAPL_TOPICS[k] for k in jsyn.AAPL_TOPICS):
        assert tsyn.expand_chunk(text, chunk_chars) == jsyn.expand_chunk(text, chunk_chars)


@pytest.mark.parametrize("chunk_size,overlap", [(1000, 200), (300, 50), (80, 0)])
def test_split_text_matches_jax(chunk_size, overlap):
    text = "\n\n".join(
        jsyn.expand_chunk(jsyn.AAPL_TOPICS[k], 1200) + "\n" + jsyn.AAPL_TOPICS[k]
        for k in jsyn.AAPL_TOPICS
    )
    got = tchunker.split_text(text, chunk_size=chunk_size, overlap=overlap)
    assert got == jchunker.split_text(text, chunk_size=chunk_size, overlap=overlap)
    assert got and all(len(c) <= chunk_size for c in got)
