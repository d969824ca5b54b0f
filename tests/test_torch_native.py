"""The port's native libraries, on the CPU: the C++ tokenizer and the HNSW
graph builder, built with g++ at first use from the port's own sources
into ``build/native/``, against the pure-Python tokenizer and the JAX
package's libraries.
"""

from __future__ import annotations

import threading
from pathlib import Path

import numpy as np
import pytest

from financial_rag_system_tpu.native import hnsw_loader as jhl
from financial_rag_system_tpu.native.loader import load_native_tokenizer as jax_native_tokenizer
from financial_rag_system_tpu_torch.models.tokenizer import (
    HashVocab,
    Tokenizer,
    WordPieceVocab,
    _basic_tokenize,
)
from financial_rag_system_tpu_torch.native import hnsw_loader as thl
from financial_rag_system_tpu_torch.native import loader as tloader

REPO = Path(__file__).resolve().parent.parent
TEXTS = [
    "Apple reported record revenue in Q4 2023.",
    "UPPER lower MiXeD  multiple   spaces",
    "punct!@#$%^&*()_+-=[]{}|;:'\",.<>?/~`",
    "tabs\tand\nnewlines\r\nhandled",
    "a" * 300 + " longword" + "x" * 120,
    "numbers 123,456.78 and 9.5% growth",
    "hyphen-ated co-op e.g. U.S.A.",
    "",
    "   ",
    "x",
    "revenue grew; margins held. " * 1000,  # more ids than the first buffer holds
]


def python_ids(tok: Tokenizer, text: str) -> list[int]:
    ids = []
    for word in _basic_tokenize(text):
        ids.extend(tok.vocab.token_ids(word))
    return ids


@pytest.fixture(scope="module")
def native_lib():
    lib = tloader._get_lib()
    if lib is None:
        pytest.skip("g++ is unavailable")
    return lib


def test_libraries_build_from_the_ports_sources_into_build_native(native_lib):
    assert thl._get_lib() is not None
    for lib in (native_lib, thl._get_lib()):
        path = Path(lib._name).resolve()
        assert path.parent == (REPO / "build" / "native").resolve() == tloader.BUILD_DIR
        assert "financial_rag_system_tpu/" not in str(path)  # never the JAX package's
    assert tloader._SRC == REPO / "financial_rag_system_tpu_torch/native/tokenizer.cpp"
    assert thl._SRC == REPO / "financial_rag_system_tpu_torch/native/hnsw.cpp"
    assert not list(tloader.SRC_DIR.glob("*.so"))  # nothing built beside the source
    for name in ("tokenizer.cpp", "hnsw.cpp"):  # the JAX package's sources, byte for byte
        assert (tloader.SRC_DIR / name).read_bytes() == (
            REPO / "financial_rag_system_tpu/native" / name).read_bytes()


def test_build_shared_library_builds_and_loads(tmp_path, native_lib):
    out = tmp_path / "sub" / "libfrs_tokenizer.so"
    assert tloader.build_shared_library(tloader._SRC, out)
    lib = tloader.load_library(tloader._SRC, out)
    assert lib is not None and hasattr(lib, "frs_tokenize")
    assert not tloader.build_shared_library(tmp_path / "missing.cpp", tmp_path / "x.so")
    assert [p.name for p in (tmp_path / "sub").iterdir()] == ["libfrs_tokenizer.so"]


def test_hash_vocab_ids_match_python_and_jax(native_lib):
    tok = Tokenizer(HashVocab())
    native = tok._get_native()
    assert isinstance(native, tloader.NativeTokenizer)
    jax_nat = jax_native_tokenizer(vocab_size=30522, piece_len=4)
    for text in TEXTS:
        ids = tok.tokenize_ids(text)
        assert ids == python_ids(tok, text) == native.tokenize_ids(text), text[:40]
        if jax_nat is not None and len(ids) < jax_nat.MAX_IDS:
            assert jax_nat.tokenize_ids(text) == ids
    assert len(tok.tokenize_ids(TEXTS[-1])) > tloader.NativeTokenizer.MAX_IDS
    # non-ASCII takes the Python path (accent stripping)
    assert tok.tokenize_ids("résumé café") == python_ids(tok, "resume cafe")


def wordpiece_dir(tmp_path) -> Path:
    """A checkpoint directory written by ``hf_export`` with a BERT-layout
    WordPiece vocab.txt ([UNK] at 100, [CLS] 101, [SEP] 102) beside it."""
    import torch

    from financial_rag_system_tpu_torch.models import bert
    from financial_rag_system_tpu_torch.models.hf_export import save_bert_checkpoint

    words = ["apple", "report", "##ed", "record", "revenue", "in", "q", "##4", "2023", ".",
             "re", "##ven", "##ue", "grow", "##th", "margin", "##s", "held", ";", "u", "s",
             "a", "-", "co", "##op", "!", "%", "9", "5", "the", "quarter", "##er"]
    vocab = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + [
        "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
    cfg = bert.BertConfig(vocab_size=len(vocab), hidden=32, layers=1, heads=2,
                          intermediate=64, with_pooler=True)
    model = bert.BertModel(cfg, device="cpu")
    bert.load_jax_params(model, bert.init_params(torch.Generator().manual_seed(0), cfg))
    out = tmp_path / "ckpt"
    save_bert_checkpoint(model, cfg, str(out))
    (out / "vocab.txt").write_text("\n".join(vocab) + "\n")
    return out


def test_wordpiece_vocab_ids_match_python_and_jax(tmp_path, native_lib):
    ckpt = wordpiece_dir(tmp_path)
    tok = Tokenizer.from_dir(str(ckpt))
    assert isinstance(tok.vocab, WordPieceVocab) and tok._get_native() is not None
    jax_nat = jax_native_tokenizer(vocab_path=str(ckpt / "vocab.txt"))
    texts = ["Apple reported record revenue in Q4 2023.", "revenue growth; margins held",
             "unknownword apple", "apple!revenue", "U.S.A. co-op 9.5% the quarter",
             "a" * 150, ""]
    for text in texts:
        ids = tok.tokenize_ids(text)
        assert ids == python_ids(tok, text), text
        if jax_nat is not None:
            assert jax_nat.tokenize_ids(text) == ids, text
    assert 100 in tok.tokenize_ids("unknownword")  # [UNK]


def test_vocabs_the_native_side_cannot_take_stay_on_python(tmp_path, native_lib):
    """A hash vocab below 1000 ids (the C side divides by the unsigned
    vocab_size - 1000, Python by the negative number), a vocab.txt with CR
    line ends or a repeated line: the pure-Python path, with its own ids."""
    for vocab in (HashVocab(600), HashVocab(999, piece_len=3)):
        tok = Tokenizer(vocab)
        assert tok._get_native() is None
        assert tok.tokenize_ids("Apple revenue") == python_ids(tok, "Apple revenue")
    base = ["[PAD]"] + [f"[u{i}]" for i in range(99)] + ["[UNK]", "apple", "##s"]
    cases = {"crlf": "\r\n".join(base) + "\r\n", "dup": "\n".join(base + ["apple"]) + "\n"}
    for name, text in cases.items():
        path = tmp_path / f"{name}.txt"
        path.write_bytes(text.encode())
        tok = Tokenizer(WordPieceVocab(str(path)))
        assert tok._get_native() is None, name
        assert tok.tokenize_ids("apples pear") == python_ids(tok, "apples pear")
    ok = tmp_path / "ok.txt"
    ok.write_text("\n".join(base))  # no final newline: still the same lines
    assert Tokenizer(WordPieceVocab(str(ok)))._get_native() is not None


def test_tokenizer_from_worker_threads(native_lib):
    tok = Tokenizer(HashVocab())
    texts = [f"quarter {i} revenue grew {i % 7} percent; margins " * (1 + i % 5)
             for i in range(64)]
    want = [python_ids(tok, t) for t in texts]
    got = [None] * len(texts)

    def work(lo):
        for i in range(lo, len(texts), 4):
            got[i] = tok.tokenize_ids(texts[i])

    threads = [threading.Thread(target=work, args=(lo,)) for lo in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert got == want


@pytest.mark.parametrize("n,m", [(700, 8), (1500, 16)])
def test_native_graph_matches_jax(n, m):
    """The port's library and the JAX package's, on the same vectors and
    seed with one thread: identical adjacency, entries and hierarchy, and
    again after the same online inserts (the dirty rows too)."""
    rng = np.random.default_rng(n)
    v = rng.standard_normal((n + 60, 32)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    kw = dict(m=m, ef_construction=60, seed=5, n_threads=1)
    t = thl.build_hnsw_graph_handle(v[:n], **kw)
    j = jhl.build_hnsw_graph_handle(v[:n], **kw)
    if t is None or j is None:
        pytest.skip("a native HNSW builder is unavailable (no g++)")
    def same():
        np.testing.assert_array_equal(t.adjacency(), j.adjacency())
        np.testing.assert_array_equal(t.entries(32), j.entries(32))
        for a, b in zip(t.hierarchy(), j.hierarchy()):
            np.testing.assert_array_equal(a, b)
        assert t.max_level() == j.max_level() and t.size == j.size

    try:
        same()
        assert t.add(v[n:], n_threads=1) == j.add(v[n:], n_threads=1)
        rows_t, adj_t = t.drain_dirty()
        rows_j, adj_j = j.drain_dirty()
        assert len(rows_t) > 60
        np.testing.assert_array_equal(rows_t, rows_j)
        np.testing.assert_array_equal(adj_t, adj_j)
        same()
    finally:
        t.close()
        j.close()
    adj, ent = thl.build_hnsw_graph(v, m=m, ef_construction=60, seed=5, n_threads=1)
    assert adj.shape == (len(v), 2 * m) and len(ent) > 0
