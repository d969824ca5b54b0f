"""First-party WordPiece tokenizer (BERT-uncased conventions).

The reference delegates tokenization to sentence-transformers' bundled
HF tokenizers (reference main.py:80-90).  Here it's implemented from
scratch: a basic tokenizer (lowercase, accent strip, punctuation split)
followed by greedy longest-match WordPiece, matching the behavior of
``BertTokenizer(do_lower_case=True)`` so that locally provided
``vocab.txt`` files from BGE-small / MiniLM checkpoints reproduce the
reference token streams.

When no vocab file is available (this environment has no model egress),
a deterministic :class:`HashVocab` maps each wordpiece to a stable id in
the BERT vocab range — tokenization stays deterministic and the whole
pipeline (bucketed padding, device forward, retrieval) runs for real.
"""

from __future__ import annotations

import os
import threading
import unicodedata
import zlib
from dataclasses import dataclass

PAD_ID = 0
UNK_ID = 100
CLS_ID = 101
SEP_ID = 102
DEFAULT_VOCAB_SIZE = 30522

_PUNCT_CATS = ("P",)


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith(_PUNCT_CATS)


def _basic_tokenize(text: str) -> list[str]:
    """Lowercase, strip accents, split on whitespace and punctuation."""
    text = unicodedata.normalize("NFD", text.lower())
    out: list[str] = []
    word: list[str] = []

    def flush():
        if word:
            out.append("".join(word))
            word.clear()

    for ch in text:
        cat = unicodedata.category(ch)
        if cat == "Mn":  # accents
            continue
        if ch.isspace():
            flush()
        elif _is_punct(ch):
            flush()
            out.append(ch)
        elif cat.startswith("C"):  # control chars
            continue
        else:
            word.append(ch)
    flush()
    return out


class HashVocab:
    """Deterministic stand-in vocab: stable hash of the piece string.

    Ids land in [1000, vocab_size) so they never collide with special
    tokens.  Greedy WordPiece needs membership tests, which a hash vocab
    can't answer, so words are split into fixed-size piece chunks
    instead — deterministic and length-bounded.
    """

    def __init__(self, vocab_size: int = DEFAULT_VOCAB_SIZE, piece_len: int = 4):
        self.vocab_size = vocab_size
        self.piece_len = piece_len

    def _hash(self, tag: str) -> int:
        # crc32: stable across processes (unlike built-in hash) and ~10x
        # cheaper than a cryptographic hash on this hot host path
        return 1000 + zlib.crc32(tag.encode()) % (self.vocab_size - 1000)

    def token_ids(self, word: str) -> list[int]:
        # whole-word id first (strong exact-match signal), then fixed-size
        # piece ids (stemming-ish overlap between inflected forms)
        ids = [self._hash("w:" + word)]
        if len(word) > self.piece_len:
            for i in range(0, len(word), self.piece_len):
                ids.append(self._hash("##" + word[i : i + self.piece_len]))
        return ids


class WordPieceVocab:
    """Real vocab loaded from an HF-format vocab.txt."""

    def __init__(self, path: str, max_chars_per_word: int = 100):
        self.path = path
        self.to_id: dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.to_id[line.rstrip("\n")] = i
        self.vocab_size = len(self.to_id)
        self.max_chars = max_chars_per_word

    def token_ids(self, word: str) -> list[int]:
        if len(word) > self.max_chars:
            return [UNK_ID]
        ids: list[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.to_id:
                    cur = self.to_id[sub]
                    break
                end -= 1
            if cur is None:
                return [UNK_ID]
            ids.append(cur)
            start = end
        return ids


def _native_takes(vocab) -> bool:
    """Whether ``native/tokenizer.cpp`` gives this vocab's ids: a hash
    vocab needs ids in [1000, vocab_size) and pieces of at least one
    character (the C side divides by vocab_size - 1000 and steps by the
    piece length); a vocab.txt must split into the same lines as Python's
    reader (no CR and no NUL byte), with no line twice (C keeps the first
    id, a dict the last) and the default word limit."""
    if isinstance(vocab, HashVocab):
        return vocab.vocab_size > 1000 and vocab.piece_len >= 1
    if not isinstance(vocab, WordPieceVocab) or vocab.max_chars != 100:
        return False
    try:
        with open(vocab.path, "rb") as f:
            data = f.read()
    except OSError:
        return False
    if b"\r" in data or b"\0" in data:
        return False
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    return len(set(lines)) == len(lines) == len(vocab.to_id)


def _load_native(vocab):
    """The C++ tokenizer for ``vocab`` (native/loader.py), or None."""
    from financial_rag_system_tpu_torch.native.loader import load_native_tokenizer

    if not _native_takes(vocab):
        return None
    if isinstance(vocab, HashVocab):
        return load_native_tokenizer(vocab_size=vocab.vocab_size, piece_len=vocab.piece_len)
    try:
        return load_native_tokenizer(vocab_path=vocab.path)
    except OSError:  # the vocab file went away since it was read
        return None


@dataclass
class Encoded:
    input_ids: list[int]
    token_type_ids: list[int]


class Tokenizer:
    """BERT-style tokenizer with single-text and pair encoding.

    Per-word results are memoized (natural-language vocabulary is small
    relative to token volume), which makes steady-state tokenization a
    dict lookup per word — this is the hottest host-side path in serving.
    """

    _WORD_CACHE_MAX = 262144

    def __init__(self, vocab: WordPieceVocab | HashVocab | None = None):
        self.vocab = vocab or HashVocab()
        self._word_cache: dict[str, list[int]] = {}
        self._native = None
        self._native_tried = False
        self._native_lock = threading.Lock()

    def _get_native(self):
        """Lazy-load the C++ tokenizer for this vocab (None if unavailable,
        or for a vocab the native side would not map as this class does)."""
        if not self._native_tried:
            with self._native_lock:
                if not self._native_tried:
                    self._native = _load_native(self.vocab)
                    self._native_tried = True
        return self._native

    @staticmethod
    def from_dir(model_dir: str | None) -> "Tokenizer":
        """Load vocab.txt from a checkpoint dir if present, else hash vocab."""
        if model_dir:
            p = os.path.join(model_dir, "vocab.txt")
            if os.path.exists(p):
                return Tokenizer(WordPieceVocab(p))
        return Tokenizer()

    def tokenize_ids(self, text: str) -> list[int]:
        # C++ fast path for ASCII (exact parity, see native/tokenizer.cpp);
        # the Python path handles accents/unicode
        native = self._get_native()
        if native is not None and text.isascii():
            return native.tokenize_ids(text)
        ids: list[int] = []
        cache = self._word_cache
        for word in _basic_tokenize(text):
            wi = cache.get(word)
            if wi is None:
                wi = self.vocab.token_ids(word)
                if len(cache) < self._WORD_CACHE_MAX:
                    cache[word] = wi
            ids.extend(wi)
        return ids

    def encode(self, text: str, max_len: int = 512) -> Encoded:
        """[CLS] text [SEP] — the bi-encoder input shape."""
        body = self.tokenize_ids(text)[: max_len - 2]
        ids = [CLS_ID, *body, SEP_ID]
        return Encoded(ids, [0] * len(ids))

    def encode_pair(self, a: str, b: str, max_len: int = 512) -> Encoded:
        """[CLS] a [SEP] b [SEP] — the cross-encoder input shape."""
        return self.encode_pair_from_ids(
            self.tokenize_ids(a), self.tokenize_ids(b), max_len
        )

    @staticmethod
    def encode_pair_from_ids(
        ta: list[int], tb: list[int], max_len: int = 512
    ) -> Encoded:
        """Pair encoding from pre-tokenized segments (hot rerank path).

        Truncates the longer segment first (longest-first strategy),
        matching sentence-transformers' CrossEncoder default.  Inputs are
        not mutated, so callers may cache and reuse the id lists.
        """
        budget = max_len - 3
        la, lb = len(ta), len(tb)
        while la + lb > budget:
            if la >= lb:
                la -= 1
            else:
                lb -= 1
        ta, tb = ta[:la], tb[:lb]
        ids = [CLS_ID, *ta, SEP_ID, *tb, SEP_ID]
        types = [0] * (la + 2) + [1] * (lb + 1)
        return Encoded(ids, types)


# --- batch padding with length bucketing (static shapes for jit) -----------

SEQ_BUCKETS = (32, 64, 128, 256, 512)
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def bucket_len(n: int, buckets: tuple[int, ...] = SEQ_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    # beyond the largest bucket: round up to a multiple of it (batch dim
    # only; sequence inputs are truncated to max_len before padding)
    last = buckets[-1]
    return ((n + last - 1) // last) * last


def pad_batch(
    encs: list[Encoded], seq_buckets: tuple[int, ...] = SEQ_BUCKETS
):
    """Pad a batch to bucketed (batch, seq) static shapes.

    Returns (input_ids, token_type_ids, attention_mask) as int32 numpy
    arrays of shape (Bpad, Lpad); rows beyond len(encs) are all-PAD.
    """
    import numpy as np

    max_l = max((len(e.input_ids) for e in encs), default=1)
    L = bucket_len(max_l, seq_buckets)
    B = bucket_len(len(encs), BATCH_BUCKETS)
    ids = np.zeros((B, L), np.int32)
    types = np.zeros((B, L), np.int32)
    mask = np.zeros((B, L), np.int32)
    for i, e in enumerate(encs):
        ii = e.input_ids[:L]
        ids[i, : len(ii)] = ii
        types[i, : len(ii)] = e.token_type_ids[: len(ii)]
        mask[i, : len(ii)] = 1
    return ids, types, mask
