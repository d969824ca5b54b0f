"""Build-on-demand ctypes loader for the native tokenizer library.

Port of ``financial_rag_system_tpu/native/loader.py``.  The binding
layer is a small C ABI and ctypes, with no compile-time Python
dependency.  The shared library builds with g++ from the port's own
``tokenizer.cpp`` the first time it is asked for, into ``build/native/``
at the repo root (as ``ops/_cuda.py`` builds the CUDA kernels into
``build/torch_kernels/``), never beside the source; a library older than
its source is rebuilt.  Concurrent builders race benignly through an
atomic rename.  Set ``RAG_TPU_NATIVE=0`` for the pure-Python paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_SRC = SRC_DIR / "tokenizer.cpp"
_LIB = BUILD_DIR / "libfrs_tokenizer.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_failed = False


def build_shared_library(src: str | Path, lib: str | Path) -> bool:
    """g++ -O3 src -> lib with an atomic rename; False on any failure.

    ``-mavx2 -mfma`` first: the HNSW distance loops are the build's hot
    path and 256-bit FMA is 4.3x over scalar there.  Plain -O3 is the
    fallback for non-x86 toolchains.
    """
    lib = Path(lib)
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    for extra in (["-mavx2", "-mfma"], []):
        try:
            subprocess.run(
                ["g++", "-O3", *extra, "-shared", "-fPIC", "-o", tmp, str(src)],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, lib)
            return True
        except (subprocess.SubprocessError, OSError):
            continue
    try:
        os.unlink(tmp)
    except OSError:
        pass
    return False


def native_enabled() -> bool:
    return os.environ.get("RAG_TPU_NATIVE", "1") not in ("0", "false")


def load_library(src: Path, lib: Path) -> ctypes.CDLL | None:
    """Build ``src`` into ``lib`` unless a library newer than the source
    is there, then load it; None when g++ or the load fails."""
    if not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime:
        if not build_shared_library(src, lib):
            return None
    try:
        return ctypes.CDLL(str(lib))
    except OSError:
        return None


def _get_lib() -> ctypes.CDLL | None:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    if not native_enabled():
        _build_failed = True
        return None
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        lib = load_library(_SRC, _LIB)
        if lib is None:
            _build_failed = True
            return None
        lib.frs_tokenizer_create_hash.restype = ctypes.c_void_p
        lib.frs_tokenizer_create_hash.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.frs_tokenizer_create_wordpiece.restype = ctypes.c_void_p
        lib.frs_tokenizer_create_wordpiece.argtypes = [ctypes.c_char_p]
        lib.frs_tokenize.restype = ctypes.c_int
        lib.frs_tokenize.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        lib.frs_tokenizer_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class NativeTokenizer:
    """ctypes wrapper; one handle per vocab configuration.

    A text's ids are never truncated: the C side writes at most the
    buffer's length and returns how many it wrote, so a full buffer is
    retried with one twice as long."""

    MAX_IDS = 8192

    def __init__(self, handle: int, lib: ctypes.CDLL):
        self._handle = handle
        self._lib = lib
        self._local = threading.local()  # one buffer a thread

    def _buffer(self, size: int) -> np.ndarray:
        buf = getattr(self._local, "buf", None)
        if buf is None or len(buf) < size:
            buf = self._local.buf = np.empty(size, np.int32)
        return buf

    def tokenize_ids(self, text: str) -> list[int]:
        raw = text.encode("ascii")
        size = self.MAX_IDS
        while True:
            buf = self._buffer(size)
            n = self._lib.frs_tokenize(
                self._handle, raw, len(raw),
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(buf),
            )
            if n < len(buf):
                return buf[:n].tolist()
            size = 2 * len(buf)

    def __del__(self):
        try:
            if self._lib is not None:
                self._lib.frs_tokenizer_destroy(self._handle)
        except Exception:
            pass


def load_native_tokenizer(
    *,
    vocab_size: int | None = None,
    piece_len: int = 4,
    vocab_path: str | None = None,
) -> NativeTokenizer | None:
    """Hash mode (vocab_size) or wordpiece mode (vocab_path); None if
    the native library is unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    if vocab_path is not None:
        with open(vocab_path, "rb") as f:
            handle = lib.frs_tokenizer_create_wordpiece(f.read())
    else:
        assert vocab_size is not None
        handle = lib.frs_tokenizer_create_hash(vocab_size, piece_len)
    if not handle:
        return None
    return NativeTokenizer(handle, lib)
