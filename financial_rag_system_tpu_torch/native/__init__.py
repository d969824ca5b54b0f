"""Native (C++) components and their ctypes loaders: the tokenizer and
the HNSW graph builder, the port's own copies of the JAX package's
sources, built with g++ at first use into ``build/native/``.  Set
``RAG_TPU_NATIVE=0`` to force the pure-Python paths."""

from financial_rag_system_tpu_torch.native.loader import load_native_tokenizer

__all__ = ["load_native_tokenizer"]
