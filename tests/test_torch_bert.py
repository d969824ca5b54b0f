"""The port's BERT encoder against the JAX package's, on the CPU.

Both compute with the same weights: the JAX ``bert.init_params`` pytree
goes into the port's ``BertModel`` through ``load_jax_params``, and the
HF checkpoint format round-trips between the two packages' exporters and
loaders.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from financial_rag_system_tpu.models import bert as jbert
from financial_rag_system_tpu.models import hf_export as jexport
from financial_rag_system_tpu.models import hf_loader as jloader
from financial_rag_system_tpu.ops import attention as jattention
from financial_rag_system_tpu_torch.models import bert as tbert
from financial_rag_system_tpu_torch.models import hf_export as texport
from financial_rag_system_tpu_torch.models import hf_loader as tloader

TINY = dict(vocab_size=1000, hidden=64, layers=2, heads=2, intermediate=128,
            max_positions=512)


def configs(**extra):
    return jbert.BertConfig(**TINY, **extra), tbert.BertConfig(**TINY, **extra)


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def make_models(seed=0, **extra):
    jcfg, tcfg = configs(**extra)
    params = jbert.init_params(jax.random.PRNGKey(seed), jcfg)
    model = tbert.load_jax_params(
        tbert.BertModel(tcfg, device="cpu"), tree_np(params)
    )
    return params, jcfg, model


def make_inputs(b=3, seq=40, seed=0, vocab=1000):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (b, seq)).astype(np.int32)
    lens = np.array([seq, seq // 2, 5][:b] + [seq] * max(0, b - 3))
    mask = (np.arange(seq)[None, :] < lens[:, None]).astype(np.int32)
    ids = ids * mask
    types = np.zeros_like(ids)
    types[:, seq // 3 :] = 1
    return ids, types, mask


def torch_inputs(*arrs):
    return tuple(torch.from_numpy(a) for a in arrs)


def cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, -1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


@pytest.fixture()
def jax_pair_attn(monkeypatch):
    """The JAX pair-attention kernel forced at every length (interpret
    mode on the CPU), with the JAX jit cache cleared around the patch."""
    jax.clear_caches()
    monkeypatch.setattr(jbert, "_pair_attn_enabled", lambda seq, hd: True)
    monkeypatch.setattr(
        jattention, "encoder_self_attention",
        functools.partial(jattention.encoder_self_attention, interpret=True),
    )
    yield
    jax.clear_caches()


@pytest.mark.parametrize("seq", [32, 40, 64, 130])
def test_encode_matches_jax_einsum_path(seq, monkeypatch):
    """Below the gate (S < 256) both packages take the einsum arithmetic;
    they differ only in the order of f32 sums."""
    monkeypatch.delenv("RAG_TPU_PAIR_ATTN", raising=False)
    params, jcfg, model = make_models()
    ids, types, mask = make_inputs(seq=seq)
    ref = np.asarray(jbert.encode(params, ids, types, mask, jcfg))
    got = model.encode(*torch_inputs(ids, types, mask)).numpy()
    assert got.shape == ref.shape == (3, seq, 64)
    np.testing.assert_allclose(got, ref, atol=5e-3, rtol=0)
    assert (cosine(got[:, 0], ref[:, 0]) >= 0.999).all()


def test_encode_matches_jax_kernel_semantics(monkeypatch, jax_pair_attn):
    """With the pair-attention kernel forced in both packages (the JAX one
    in interpret mode), both compute the same attention arithmetic."""
    monkeypatch.setenv("RAG_TPU_PAIR_ATTN", "1")
    params, jcfg, model = make_models(seed=1)
    ids, types, mask = make_inputs(seq=48, seed=1)
    ref = np.asarray(jbert.encode(params, ids, types, mask, jcfg))
    got = model.encode(*torch_inputs(ids, types, mask)).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-3, rtol=0)


def test_gate_default_takes_the_kernel_at_256(monkeypatch, jax_pair_attn):
    """At S 256 the port's default is the kernel arithmetic: the JAX
    package's with its kernel engaged, as its accelerator runs it."""
    monkeypatch.delenv("RAG_TPU_PAIR_ATTN", raising=False)
    params, jcfg, model = make_models(seed=4)
    ids, types, mask = make_inputs(seq=256, seed=4)
    ref = np.asarray(jbert.encode(params, ids, types, mask, jcfg))
    got = model.encode(*torch_inputs(ids, types, mask)).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-3, rtol=0)


def test_gate_off_takes_the_einsum_at_256(monkeypatch):
    """``RAG_TPU_PAIR_ATTN=0``: the einsum arithmetic at every length,
    against the JAX package's einsum path."""
    monkeypatch.setenv("RAG_TPU_PAIR_ATTN", "0")
    params, jcfg, model = make_models(seed=5)
    ids, types, mask = make_inputs(seq=256, seed=5)
    ref = np.asarray(jbert.encode(params, ids, types, mask, jcfg))
    got = model.encode(*torch_inputs(ids, types, mask)).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-3, rtol=0)


@pytest.mark.parametrize("mode,want", [
    (None, (False, False, True)), ("auto", (False, False, True)),
    ("1", (True, True, True)), ("0", (False, False, False)), ("off", (False, False, False)),
])
def test_pair_attn_gate_env_contract(monkeypatch, mode, want):
    """The JAX gate's rules without its platform test: lengths 32, 255
    and 256 at head_dim 32; never for a head wider than 128."""
    if mode is None:
        monkeypatch.delenv("RAG_TPU_PAIR_ATTN", raising=False)
    else:
        monkeypatch.setenv("RAG_TPU_PAIR_ATTN", mode)
    assert tuple(tbert._pair_attn_enabled(s, 32) for s in (32, 255, 256)) == want
    assert not tbert._pair_attn_enabled(512, 256)


def test_embed_cls_matches_jax():
    params, jcfg, model = make_models(with_pooler=True)
    ids, types, mask = make_inputs(seq=32)
    ref = np.asarray(jbert.embed_cls(params, ids, types, mask, jcfg))
    got = tbert.embed_cls(model, *torch_inputs(ids, types, mask)).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    assert (cosine(got, ref) >= 0.999).all()


def test_cross_score_matches_jax():
    params, jcfg, model = make_models(seed=2, with_pooler=True, num_labels=1)
    ids, types, mask = make_inputs(b=4, seq=56, seed=2)
    ref = np.asarray(jbert.cross_score(params, ids, types, mask, jcfg))
    got = tbert.cross_score(model, *torch_inputs(ids, types, mask)).numpy()
    assert got.shape == (4,)
    np.testing.assert_allclose(got, ref, atol=5e-3, rtol=0)


@pytest.mark.parametrize(
    "mode,on_cpu,on_card",
    [(None, False, True), ("auto", False, True), ("1", True, True), ("true", True, True),
     ("0", False, False), ("FALSE", False, False), ("other", False, True)],
)
def test_gelu_env_contract(monkeypatch, mode, on_cpu, on_card):
    """JAX's RAG_TPU_FAST_GELU rule: tanh on the accelerator (the card)
    and exact erf on the CPU unless the variable forces one; the CPU
    computes what its rule picks."""
    x = torch.linspace(-4, 4, 101)
    exact = torch.nn.functional.gelu(x)
    tanh = torch.nn.functional.gelu(x, approximate="tanh")
    if mode is None:
        monkeypatch.delenv("RAG_TPU_FAST_GELU", raising=False)
    else:
        monkeypatch.setenv("RAG_TPU_FAST_GELU", mode)
    assert tbert._fast_gelu(torch.device("cpu")) is on_cpu
    assert tbert._fast_gelu(torch.device("cuda")) is on_card
    assert torch.equal(tbert._gelu(x), tanh if on_cpu else exact)
    assert not torch.equal(tanh, exact)
    np.testing.assert_allclose(tanh.numpy(), exact.numpy(), atol=1e-3)


def test_matmul_keeps_f32_product():
    """bf16 operands, f32 result with no bf16 rounding (the JAX
    preferred_element_type=f32 contract)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((7, 64)).astype(np.float32))
    b = torch.zeros(7)
    got = tbert._matmul(x, w, b)
    ref = x.bfloat16().double() @ w.bfloat16().double().T
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4, rtol=0)
    assert not torch.equal(got, got.bfloat16().float())


@pytest.mark.parametrize("cross", [False, True])
def test_hf_checkpoint_round_trips(tmp_path, cross):
    extra = dict(with_pooler=True, num_labels=1 if cross else 0)
    params, jcfg, model = make_models(seed=3, **extra)
    ids, types, mask = make_inputs(seq=24, seed=3)
    want = model.encode(*torch_inputs(ids, types, mask))

    # JAX export -> port loader
    jexport.save_bert_checkpoint(
        params, jcfg, str(tmp_path / "j"), cross_encoder=cross, max_seq_length=64
    )
    loaded, cfg = tloader.load_bert_checkpoint(
        str(tmp_path / "j"), with_pooler=True, num_labels=extra["num_labels"],
        device="cpu",
    )
    assert cfg.layers == 2 and cfg.with_pooler and cfg.num_labels == extra["num_labels"]
    assert tloader.saved_max_seq_length(str(tmp_path / "j")) == 64
    assert torch.equal(loaded.encode(*torch_inputs(ids, types, mask)), want)
    if cross:
        assert torch.equal(
            tbert.cross_score(loaded, *torch_inputs(ids, types, mask)),
            tbert.cross_score(model, *torch_inputs(ids, types, mask)),
        )

    # port export -> JAX loader: the same pytree
    texport.save_bert_checkpoint(
        model, model.cfg, str(tmp_path / "t"), cross_encoder=cross
    )
    back, _ = jloader.load_bert_checkpoint(
        str(tmp_path / "t"), with_pooler=True, num_labels=extra["num_labels"]
    )
    flat_a = jax.tree_util.tree_leaves_with_path(tree_np(params))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(tree_np(back)))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    assert jloader.saved_max_seq_length(str(tmp_path / "t")) == 512


def test_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbert.BertModel(tbert.BertConfig(**TINY))
