"""Recursive character text splitter (first-party).

Replaces the reference's ``RecursiveCharacterTextSplitter(chunk_size=1000,
chunk_overlap=200, separators=["\\n\\n", "\\n", " ", ""])`` (reference
ingest.py:71-81): split on the coarsest separator present, recursively
re-split any piece that still exceeds chunk_size with the next separator,
then greedily merge pieces into chunks of at most ``chunk_size`` keeping
``overlap`` characters of trailing context between consecutive chunks.
Blank chunks are dropped, matching the reference's filter.
"""

from __future__ import annotations

DEFAULT_SEPARATORS = ("\n\n", "\n", " ", "")


def _split_on(text: str, sep: str) -> list[str]:
    if sep == "":
        return list(text)
    parts = text.split(sep)
    # keep the separator attached to the preceding piece so merges can
    # reconstruct the original spacing
    return [p + sep for p in parts[:-1]] + [parts[-1]]


def _recursive_split(
    text: str, chunk_size: int, separators: tuple[str, ...]
) -> list[str]:
    """Pieces each <= chunk_size, split as coarsely as possible."""
    if len(text) <= chunk_size:
        return [text]
    sep = separators[0] if separators else ""
    rest = separators[1:]
    out: list[str] = []
    for piece in _split_on(text, sep):
        if len(piece) <= chunk_size or not rest and sep == "":
            out.append(piece)
        elif len(piece) > chunk_size:
            out.extend(_recursive_split(piece, chunk_size, rest or ("",)))
        else:
            out.append(piece)
    return out


def split_text(
    text: str,
    chunk_size: int = 1000,
    overlap: int = 200,
    separators: tuple[str, ...] = DEFAULT_SEPARATORS,
) -> list[str]:
    """Chunk ``text`` with the reference's parameters (ingest.py:72-76)."""
    assert overlap < chunk_size
    pieces = _recursive_split(text, chunk_size, separators)

    chunks: list[str] = []
    cur = ""
    for piece in pieces:
        if len(cur) + len(piece) <= chunk_size:
            cur += piece
            continue
        if cur.strip():
            chunks.append(cur.strip())
        # seed the next chunk with the overlap tail of the previous one
        tail = cur[-overlap:] if overlap and cur else ""
        cur = tail + piece
        # a single piece can still exceed chunk_size only at the "" level;
        # hard-wrap it
        while len(cur) > chunk_size:
            chunks.append(cur[:chunk_size].strip())
            cur = cur[chunk_size - overlap :] if overlap else cur[chunk_size:]
    if cur.strip():
        chunks.append(cur.strip())
    return [c for c in chunks if c]
