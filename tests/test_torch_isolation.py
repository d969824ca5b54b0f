"""The port stands alone: no JAX, no JAX package, no silent CPU runs."""

from __future__ import annotations

import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import financial_rag_system_tpu_torch as port

REPO = Path(__file__).resolve().parent.parent


TRAIN_MODULES = ("optim", "checkpoint", "contrastive", "cross_encoder", "distill", "stack")
# top-level packages the port never imports: JAX, its optimizer and
# checkpointer, and the JAX package
BANNED = ("jax", "optax", "orbax", "financial_rag_system_tpu")


def port_modules() -> list[str]:
    return [
        m.name for m in pkgutil.walk_packages(port.__path__, prefix=port.__name__ + ".")
    ]


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = port_modules()
    assert len(mods) >= 25
    assert {f"financial_rag_system_tpu_torch.native.{m}" for m in ("loader", "hnsw_loader")} < set(mods)
    assert {f"financial_rag_system_tpu_torch.train.{m}" for m in TRAIN_MODULES} < set(mods)
    assert {f"financial_rag_system_tpu_torch.data.{m}" for m in ("synthetic", "chunker")} < set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {BANNED!r}]\n"
        "print(json.dumps(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_port_source_names_jax():
    for path in (REPO / "financial_rag_system_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                assert "jax" not in stripped, f"{path}: {stripped}"
                assert "optax" not in stripped and "orbax" not in stripped, f"{path}: {stripped}"
                assert "financial_rag_system_tpu." not in stripped.replace(
                    "financial_rag_system_tpu_torch", ""
                ), f"{path}: {stripped}"


def test_default_engine_refuses_the_cpu_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from financial_rag_system_tpu_torch.serving.app import build_default_engine

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_default_engine()


def test_default_engine_with_a_saved_ivf_index_refuses_the_cpu(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    import numpy as np

    from financial_rag_system_tpu_torch.index.flat import FlatIndex
    from financial_rag_system_tpu_torch.index.ivf import IVFIndex
    from financial_rag_system_tpu_torch.serving.app import build_default_engine
    from financial_rag_system_tpu_torch.utils.config import reset_config

    rng = np.random.default_rng(0)
    flat = FlatIndex(32, capacity=256, tile=128, device="cpu")
    flat.upsert([f"p{i}" for i in range(256)], rng.standard_normal((256, 32)),
                [f"t{i}" for i in range(256)], [{"ticker": "AAPL"}] * 256)
    IVFIndex(flat, tile=128).save(str(tmp_path))
    assert (tmp_path / IVFIndex.IVF_FILE).exists()
    monkeypatch.setenv("INDEX_DIR", str(tmp_path))
    reset_config()
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_default_engine()
    finally:
        reset_config()


def test_factories_and_index_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from financial_rag_system_tpu_torch.index.flat import FlatIndex
    from financial_rag_system_tpu_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="device='cpu'"):
        FlatIndex(64)
    assert resolve_device("cpu") == torch.device("cpu")


def test_factories_name_their_env_var(monkeypatch, tmp_path):
    """Without a checkpoint directory in RAG_TPU_BGE_DIR /
    RAG_TPU_RERANKER_DIR (unset, or naming no directory) the factories
    return the hermetic hash stack, the identity reranker in TESTING
    mode, as the JAX package's do."""
    from financial_rag_system_tpu_torch.models.embedder import HashEmbedder, get_embedder
    from financial_rag_system_tpu_torch.models.reranker import HashReranker, get_reranker

    monkeypatch.delenv("RAG_TPU_BGE_DIR", raising=False)
    monkeypatch.delenv("RAG_TPU_RERANKER_DIR", raising=False)
    assert isinstance(get_embedder(device="cpu"), HashEmbedder)
    assert get_reranker(device="cpu").identity is False
    monkeypatch.setenv("RAG_TPU_BGE_DIR", str(tmp_path / "missing"))
    monkeypatch.setenv("RAG_TPU_RERANKER_DIR", str(tmp_path / "missing"))
    assert isinstance(get_embedder(device="cpu"), HashEmbedder)
    rr = get_reranker(testing=True, device="cpu")
    assert isinstance(rr, HashReranker) and rr.identity is True
