"""financial_rag_system_tpu_torch — the PyTorch/CUDA port of the RAG engine.

The same two-stage SEC-filings RAG engine as ``financial_rag_system_tpu``,
written in PyTorch for one NVIDIA H100.  The module layout mirrors the
JAX package's, so each counterpart sits under the same path.  Every
kernel the JAX package wrote in Pallas becomes a hand-written CUDA C++
kernel under ``csrc/`` for ``sm_90a``, with a plain PyTorch version
beside it in the same module; dense products, layernorm, GELU and
gathers stay torch calls.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, and raise when no card is present.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
