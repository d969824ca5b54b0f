"""The port's fused encoder-block path against the JAX package, on the CPU.

- the three plain versions (``*_plain``, what the CUDA kernels compute)
  against the JAX Pallas kernels in interpret mode;
- the gate's env contract;
- the whole fused-block encoder against the JAX fused branch;
- the opt-in model paths around it: int8 weight-only PTQ,
  ``RAG_TPU_BF16_ACT`` and ``embed_mean``.

Inputs are made with numpy from fixed seeds and handed to both packages;
JAX weights are (in, out), the port's ``nn.Linear`` (out, in).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from financial_rag_system_tpu.models import bert as jbert
from financial_rag_system_tpu.models.embedder import BiEncoder as JBiEncoder
from financial_rag_system_tpu.models.tokenizer import Tokenizer as JTokenizer
from financial_rag_system_tpu.ops import attention as jattention
from financial_rag_system_tpu.ops import fused_bert as jfb
from financial_rag_system_tpu_torch.models import bert as tbert
from financial_rag_system_tpu_torch.models.embedder import BiEncoder
from financial_rag_system_tpu_torch.models.hf_export import save_bert_checkpoint
from financial_rag_system_tpu_torch.models.reranker import CrossEncoderReranker
from financial_rag_system_tpu_torch.models.tokenizer import Tokenizer
from financial_rag_system_tpu_torch.ops import fused_bert as tfb

# the JAX package's own bound for these kernels (tests/test_fused_bert.py)
TOL = dict(atol=2e-3, rtol=2e-3)
SMALL = dict(vocab_size=1000, hidden=128, layers=2, heads=4, intermediate=512,
             max_positions=512)
KERNEL_CASES = [(r, 128, 512) for r in (1, 64, 100, 512, 777)] + [(130, 384, 1536)]
FUSED_FNS = ("fused_qkv", "fused_resid_ln", "fused_ffn_ln")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def block_arrays(r, h, i, seed):
    """x and one layer's weights at the scales of a random-init encoder."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0, loc=0.0):
        return (loc + scale * rng.standard_normal(shape)).astype(np.float32)

    return dict(
        x=f(r, h), ctx=f(r, h),
        w_h=[f(h, h, scale=0.05) for _ in range(4)], b_h=[f(h, scale=0.01) for _ in range(4)],
        w_in=f(h, i, scale=0.05), b_in=f(i, scale=0.01),
        w_out=f(i, h, scale=0.05), b_out=f(h, scale=0.01),
        s=f(h, scale=0.1, loc=1.0), b=f(h, scale=0.1),
    )


@pytest.mark.parametrize("r,h,i", KERNEL_CASES)
def test_ffn_ln_plain_matches_pallas(r, h, i):
    a = block_arrays(r, h, i, seed=r)
    want = jfb.fused_ffn_ln(*(jnp.asarray(a[k]) for k in ("x", "w_in", "b_in", "w_out",
                                                           "b_out", "s", "b")),
                            1e-12, interpret=True, block=64)
    got = tfb.fused_ffn_ln_plain(t(a["x"]), t(a["w_in"].T), t(a["b_in"]), t(a["w_out"].T),
                                 t(a["b_out"]), t(a["s"]), t(a["b"]), 1e-12)
    assert got.shape == (r, h) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("r,h,i", KERNEL_CASES)
def test_qkv_plain_matches_pallas(r, h, i):
    a = block_arrays(r, h, i, seed=r + 1)
    ws, bs = a["w_h"][:3], a["b_h"][:3]
    want = jfb.fused_qkv(jnp.asarray(a["x"]), *(jnp.asarray(v) for wb in zip(ws, bs) for v in wb),
                         interpret=True, block=64)
    got = tfb.fused_qkv_plain(t(a["x"]), *(v for w, b in zip(ws, bs) for v in (t(w.T), t(b))))
    for g, w in zip(got, want):
        assert g.shape == (r, h) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("r,h,i", KERNEL_CASES)
def test_resid_ln_plain_matches_pallas(r, h, i):
    a = block_arrays(r, h, i, seed=r + 2)
    w, b = a["w_h"][3], a["b_h"][3]
    want = jfb.fused_resid_ln(*(jnp.asarray(v) for v in (a["x"], a["ctx"], w, b, a["s"], a["b"])),
                              1e-12, interpret=True, block=64)
    got = tfb.fused_resid_ln_plain(t(a["x"]), t(a["ctx"]), t(w.T), t(b), t(a["s"]), t(a["b"]),
                                   1e-12)
    assert got.shape == (r, h) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_tensors_run_the_plain_versions():
    """On a CPU tensor the wrappers are their plain versions, count no
    launch, and take a bf16 activation widened to f32 exactly."""
    a = block_arrays(70, 128, 512, seed=7)
    x, xb = t(a["x"]), t(a["x"]).bfloat16()
    w_in, w_out, ctx = t(a["w_in"].T), t(a["w_out"].T), t(a["ctx"])
    wh = [t(w.T) for w in a["w_h"]]
    bh = [t(b) for b in a["b_h"]]
    ln = (t(a["s"]), t(a["b"]))
    counts = (tfb.fused_qkv.launches, tfb.fused_resid_ln.launches, tfb.fused_ffn_ln.launches)
    for inp in (x, xb):
        ffn = (inp, w_in, t(a["b_in"]), w_out, t(a["b_out"]), *ln, 1e-12)
        assert torch.equal(tfb.fused_ffn_ln(*ffn), tfb.fused_ffn_ln_plain(inp.float(), *ffn[1:]))
        qkv = (inp, wh[0], bh[0], wh[1], bh[1], wh[2], bh[2])
        for g, w in zip(tfb.fused_qkv(*qkv), tfb.fused_qkv_plain(inp.float(), *qkv[1:])):
            assert torch.equal(g, w)
        res = (inp, ctx, wh[3], bh[3], *ln, 1e-12)
        assert torch.equal(tfb.fused_resid_ln(*res),
                           tfb.fused_resid_ln_plain(inp.float(), *res[1:]))
    # a bf16 context is the f32 one rounded: the kernels round it anyway
    assert torch.equal(tfb.fused_resid_ln(x, ctx.bfloat16(), wh[3], bh[3], *ln, 1e-12),
                       tfb.fused_resid_ln(x, ctx.bfloat16().float(), wh[3], bh[3], *ln, 1e-12))
    assert counts == (tfb.fused_qkv.launches, tfb.fused_resid_ln.launches,
                      tfb.fused_ffn_ln.launches)


# -- the gate ---------------------------------------------------------------


class _FakeModel:
    """What the gate reads of a model: its device, int8 state and widths."""

    def __init__(self, device="cuda", quantized=False, hidden=384, intermediate=1536):
        self.device = torch.device(device)
        self.quantized = quantized
        self.cfg = tbert.BertConfig(hidden=hidden, intermediate=intermediate)


@pytest.mark.parametrize(
    "block,gelu,model,on",
    [(None, "1", _FakeModel(), False), ("auto", "1", _FakeModel(), False),
     ("0", "1", _FakeModel(), False), ("false", "1", _FakeModel(), False),
     ("1", None, _FakeModel(), True), ("1", "auto", _FakeModel(), True),
     ("1", "0", _FakeModel(), False), ("1", "1", _FakeModel(quantized=True), False),
     ("1", "1", _FakeModel("cpu"), False), ("1", "1", _FakeModel(), True),
     ("true", "TRUE", _FakeModel(), True), ("1", "FALSE", _FakeModel(), False),
     ("1", None, _FakeModel("cpu"), False),
     ("1", "1", _FakeModel(hidden=512, intermediate=2048), True),
     ("1", "1", _FakeModel(hidden=768, intermediate=3072), False),
     ("1", "1", _FakeModel(hidden=1024, intermediate=4096), False),
     ("1", "1", _FakeModel(hidden=320, intermediate=1000), False)],
)
def test_fused_block_gate_env_contract(monkeypatch, block, gelu, model, on):
    """The JAX gate's rules on its accelerator: the opt-in engages alone,
    unless GELU is forced to erf; the port adds the kernels' widths (H at
    most 512, H and I multiples of 64)."""
    for name, v in (("RAG_TPU_FUSED_BLOCK", block), ("RAG_TPU_FAST_GELU", gelu)):
        if v is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, v)
    assert tbert._fused_block_enabled(model) is on


def test_gate_is_off_for_real_cpu_and_int8_models(monkeypatch):
    monkeypatch.setenv("RAG_TPU_FUSED_BLOCK", "1")
    monkeypatch.setenv("RAG_TPU_FAST_GELU", "1")
    _, _, model = make_models(0)
    assert not tbert._fused_block_enabled(model)  # on the CPU
    assert not model.quantized
    tbert.quantize_params(model)
    assert model.quantized


# -- the encoder ------------------------------------------------------------


def make_models(seed, **extra):
    jcfg = jbert.BertConfig(**{**SMALL, **extra})
    params = jbert.init_params(jax.random.PRNGKey(seed), jcfg)
    model = tbert.BertModel(tbert.BertConfig(**{**SMALL, **extra}), device="cpu")
    tbert.load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    return params, jcfg, model


def make_inputs(b=3, seq=40, seed=0):
    rng = np.random.default_rng(seed)
    lens = np.array([seq, seq // 2, 5][:b])
    mask = (np.arange(seq)[None, :] < lens[:, None]).astype(np.int32)
    ids = rng.integers(1, 1000, (b, seq)).astype(np.int32) * mask
    types = np.zeros_like(ids)
    types[:, seq // 3 :] = 1
    return ids, types, mask


@pytest.fixture()
def fresh_jit():
    """Gates and env vars are read at trace time: start and end with an
    empty jit cache so no trace crosses a patch."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def patch_fused_block(monkeypatch, pair_attn: bool) -> dict:
    """Both packages' fused branch on the CPU: the JAX gate forced on with
    its Pallas kernels in interpret mode, the port's gate forced on, tanh
    GELU selected.  ``pair_attn``: the pair-attention kernel forced in both
    packages (the JAX one in interpret mode), else both take the einsum
    arithmetic below S 256.  Returns the calls of each fused-block
    function, by package (JAX's as traced: once per scan)."""
    monkeypatch.setenv("RAG_TPU_FAST_GELU", "1")
    monkeypatch.setattr(jbert, "_fused_block_enabled", lambda layers: True)
    if pair_attn:
        monkeypatch.setattr(jbert, "_pair_attn_enabled", lambda seq, hd: True)
        monkeypatch.setenv("RAG_TPU_PAIR_ATTN", "1")
    else:
        monkeypatch.delenv("RAG_TPU_PAIR_ATTN", raising=False)
    calls = {"jax": {}, "port": {}}
    for name in FUSED_FNS:
        for side, mod, fn in (("jax", jfb, functools.partial(getattr(jfb, name), interpret=True)),
                              ("port", tbert, getattr(tbert, name))):
            calls[side][name] = 0

            def spy(*a, _fn=fn, _n=calls[side], _name=name):
                _n[_name] += 1
                return _fn(*a)

            monkeypatch.setattr(mod, name, spy)
    monkeypatch.setattr(jattention, "encoder_self_attention", functools.partial(
        jattention.encoder_self_attention, interpret=True))
    monkeypatch.setattr(tbert, "_fused_block_enabled", lambda model: True)
    return calls


@pytest.fixture()
def fused_block(monkeypatch, fresh_jit):
    """:func:`patch_fused_block` with pair attention forced."""
    return patch_fused_block(monkeypatch, pair_attn=True)


@pytest.fixture()
def fused_block_einsum(monkeypatch, fresh_jit):
    """:func:`patch_fused_block` with the attention gate at its default."""
    return patch_fused_block(monkeypatch, pair_attn=False)


def test_fused_block_encoder_matches_jax(fused_block):
    params, jcfg, model = make_models(1)
    ids, types, mask = make_inputs(seed=1)
    want = np.asarray(jbert.encode(params, ids, types, mask, jcfg))
    got = model.encode(t(ids), t(types), t(mask)).numpy()
    assert got.shape == (3, 40, 128)
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)
    # both took their fused branch: JAX in its one traced layer, the port
    # in each of its 2 layers
    assert fused_block == {"jax": dict.fromkeys(FUSED_FNS, 1),
                           "port": dict.fromkeys(FUSED_FNS, 2)}


@pytest.mark.parametrize("seq", [32, 40, 64])
def test_fused_block_below_the_gate_matches_jax(fused_block_einsum, seq):
    """Below S 256 both fused branches take the einsum attention and hand
    its f32 context to the o-proj + LN kernel (JAX ``bert.py:439-444``)."""
    params, jcfg, model = make_models(12)
    ids, types, mask = make_inputs(seed=12, seq=seq)
    want = np.asarray(jbert.encode(params, ids, types, mask, jcfg))
    got = model.encode(t(ids), t(types), t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)
    assert fused_block_einsum == {"jax": dict.fromkeys(FUSED_FNS, 1),
                                  "port": dict.fromkeys(FUSED_FNS, 2)}


def test_fused_block_after_a_reload_matches_jax(fused_block):
    """The layers' QKV packs follow the weights: a model reloaded with new
    parameters runs its fused branch with them, not with the packs cast
    from the old ones."""
    _, jcfg, model = make_models(10)
    ids, types, mask = make_inputs(seed=10)
    model.encode(t(ids), t(types), t(mask))  # packs the first weights
    params = jbert.init_params(jax.random.PRNGKey(11), jcfg)
    tbert.load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    want = np.asarray(jbert.encode(params, ids, types, mask, jcfg))
    got = model.encode(t(ids), t(types), t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)


def test_fused_block_is_the_unfused_tanh_function(monkeypatch):
    """The opt-in changes how a layer runs, not what it computes: the
    fused branch against the port's own unfused layer with tanh GELU."""
    monkeypatch.setenv("RAG_TPU_FAST_GELU", "1")
    _, _, model = make_models(2)
    args = tuple(t(a) for a in make_inputs(seed=2))
    unfused = model.encode(*args)
    monkeypatch.setattr(tbert, "_fused_block_enabled", lambda model: True)
    np.testing.assert_allclose(model.encode(*args).numpy(), unfused.numpy(), atol=1e-4, rtol=0)


def test_fused_block_cross_score_matches_jax(fused_block):
    params, jcfg, model = make_models(3, with_pooler=True, num_labels=1)
    ids, types, mask = make_inputs(seed=3)
    want = np.asarray(jbert.cross_score(params, ids, types, mask, jcfg))
    got = tbert.cross_score(model, t(ids), t(types), t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)


# -- int8 weight-only PTQ ---------------------------------------------------


def test_int8_weights_equal_jax_quantize_params(tmp_path):
    params, _, model = make_models(4, with_pooler=True, num_labels=1)
    jq = jax.tree_util.tree_map(np.asarray, jbert.quantize_params(params))
    tbert.quantize_params(model)
    loaded = tbert.load_jax_params(
        tbert.BertModel(tbert.BertConfig(**SMALL, with_pooler=True, num_labels=1), device="cpu"),
        jq,
    )
    for m in (model, loaded):
        for i, lp in enumerate(m.layers):
            for key, name in zip(tbert._QUANT_KEYS, tbert._QUANT_LINEARS):
                lin = getattr(lp, name)
                assert lin.weight.dtype == torch.int8
                np.testing.assert_array_equal(lin.weight.numpy(), jq["layers"][key][i].T)
                np.testing.assert_array_equal(lin.weight_scale.numpy(),
                                              jq["layers"][key + "__scale"][i, 0])
    with pytest.raises(ValueError, match="quantized already"):
        tbert.quantize_params(model)
    with pytest.raises(ValueError, match="float parameter tree"):
        tbert.load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    with pytest.raises(ValueError, match="float weights"):  # no scales in an HF checkpoint
        save_bert_checkpoint(model, model.cfg, str(tmp_path / "ckpt"), cross_encoder=True)


def test_int8_cross_score_matches_jax(fresh_jit):
    params, jcfg, model = make_models(5, with_pooler=True, num_labels=1)
    ids, types, mask = make_inputs(seed=5)
    want = np.asarray(jbert.cross_score(jbert.quantize_params(params), ids, types, mask, jcfg))
    got = tbert.cross_score(tbert.quantize_params(model), t(ids), t(types), t(mask)).numpy()
    assert got.shape == (3,)
    # exact-erf GELU and the einsum attention on both sides below S 256:
    # the bound of test_cross_score_matches_jax
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)


def test_reranker_quantizes_under_its_env(monkeypatch):
    _, _, model = make_models(6, with_pooler=True, num_labels=1)
    monkeypatch.delenv("RAG_TPU_INT8_RERANK", raising=False)
    assert not CrossEncoderReranker(model, model.cfg, tokenizer=None).model.quantized
    monkeypatch.setenv("RAG_TPU_INT8_RERANK", "1")
    assert CrossEncoderReranker(model, model.cfg, tokenizer=None).model.quantized


# -- bf16 activations and mean pooling --------------------------------------


@pytest.mark.parametrize("act", ["0", "1"])
def test_bf16_act_encode_and_embed_mean_match_jax(monkeypatch, fresh_jit, act):
    """Pair attention forced on both sides (interpret mode in JAX).  With
    f32 activations the two differ only in the order of f32 sums.  With
    bf16 activations XLA also rounds every op inside the exact-erf GELU
    to bf16 where torch rounds the GELU once, and each rounding that
    differs moves a value by a bf16 step (2^-8 relative) and carries into
    the next layer: up to 4.5 steps were seen, hence the bound of about 8
    steps there."""
    monkeypatch.setenv("RAG_TPU_BF16_ACT", act)
    monkeypatch.setattr(jbert, "_pair_attn_enabled", lambda seq, hd: True)
    monkeypatch.setenv("RAG_TPU_PAIR_ATTN", "1")
    monkeypatch.setattr(jattention, "encoder_self_attention", functools.partial(
        jattention.encoder_self_attention, interpret=True))
    params, jcfg, model = make_models(7)
    ids, types, mask = make_inputs(seed=7)
    tol = dict(atol=2e-2, rtol=3e-2) if act == "1" else dict(atol=5e-3, rtol=0)
    want = np.asarray(jbert.encode(params, ids, types, mask, jcfg))
    got = model.encode(t(ids), t(types), t(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **tol)
    want = np.asarray(jbert.embed_mean(params, ids, types, mask, jcfg))
    got = tbert.embed_mean(model, t(ids), t(types), t(mask)).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    # mean pooling averages the per-token differences down
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)


@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_bi_encoder_pooling_matches_jax(monkeypatch, fresh_jit, pooling):
    """``BiEncoder(pooling=...)`` end to end from text, against the JAX
    bi-encoder with the same hash vocabulary (pair attention forced on
    both sides, interpret mode in JAX)."""
    monkeypatch.setattr(jbert, "_pair_attn_enabled", lambda seq, hd: True)
    monkeypatch.setenv("RAG_TPU_PAIR_ATTN", "1")
    monkeypatch.setattr(jattention, "encoder_self_attention", functools.partial(
        jattention.encoder_self_attention, interpret=True))
    # the default hash vocabulary, so the model takes BERT's vocab size
    params, jcfg, model = make_models(9, vocab_size=30522)
    texts = ["what was revenue growth in the last quarter", "supply chain risk", "margins"]
    want = JBiEncoder(params, jcfg, JTokenizer(), pooling=pooling, max_len=64).encode(texts)
    got = BiEncoder(model, model.cfg, Tokenizer(), pooling=pooling, max_len=64).encode(texts)
    assert got.shape == (3, 128) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)


def test_bf16_act_stores_bf16_between_ops(monkeypatch):
    """The cast points of the JAX package: with RAG_TPU_BF16_ACT=1 the
    layer outputs are bf16-exact values; the result is f32."""
    _, _, model = make_models(8)
    args = tuple(t(a) for a in make_inputs(seed=8))
    monkeypatch.setenv("RAG_TPU_BF16_ACT", "1")
    h = model.encode(*args)
    assert h.dtype == torch.float32
    assert torch.equal(h, h.bfloat16().float())
    monkeypatch.setenv("RAG_TPU_BF16_ACT", "0")
    assert not torch.equal(model.encode(*args), h)
