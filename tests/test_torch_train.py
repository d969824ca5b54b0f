"""The port's trainers against the JAX package's, on the CPU.

The same weights (the JAX ``bert.init_params`` pytree, carried into the
port with ``load_jax_params`` and read back with ``export_jax_params``)
and the same token batches go through one step of each objective and
through five-step runs of each trainer, at the tiny configurations of
``tests/test_train.py`` and ``tests/test_trained_stack.py``.  JAX's
gradients are read from its own jitted steps, through an optimizer that
hands them back as its state.

Tolerances, from these runs:
- losses within ``LOSS_RTOL`` relative (measured at most 1.7e-6);
- gradients: the whole gradient's L2 difference within ``GRAD_TOL`` of
  its norm, and each leaf's within ``LEAF_RTOL`` of that leaf's own norm
  (a weight's gradient is rounded to bf16, as JAX rounds it, so the order
  of a sum may flip single elements by a bf16 step, 3.9e-3 relative).
  BCE is compared from init (measured at most 6.2e-7 at a 64 bucket and
  6.5e-4 at a 256 bucket, on the query and key weights of a nearly
  uniform attention); InfoNCE and Margin-MSE from weights ten InfoNCE
  steps of JAX's trainer away from init (``warm_params``; measured at
  most 2.9e-4 there, and 3.0e-3 with other shuffles).  At init these two
  objectives compare nearly equal embeddings, whose bf16 rounding
  InfoNCE's 1/temperature of 20 amplifies: JAX itself sits 40-50% from
  the unrounded model's gradient on the FFN leaves there, and the port
  up to 19% from JAX.  The attention key bias is the exception: softmax
  cancels the shift ``q . b_k`` it gives a query's row, so its exact
  gradient is zero and both sides hold rounding alone; it is held to
  ``GRAD_TOL`` of the whole gradient's norm (measured at most 4e-7);
- the optimizer within ``OPTIM_RTOL`` of optax on fixed gradients;
- five-step trajectories: per-step losses within ``TRAJ_LOSS_RTOL``
  (measured at most 1.5e-5), which a batch in another order or another
  update rule would break at once; weights within ``TRAJ_LR_UNITS``
  learning rates, the most two runs of Adam can part by in five steps
  (each moves a weight by at most about ``lr``, ``lr * sign(g)`` on the
  first, and a gradient near zero may take either sign: measured up to
  5.5 lr on the FFN leaves, under 2 lr elsewhere).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from financial_rag_system_tpu.models import bert as jbert
from financial_rag_system_tpu.models.tokenizer import Tokenizer as JTokenizer
from financial_rag_system_tpu.train import contrastive as jcon
from financial_rag_system_tpu.train import cross_encoder as jcross
from financial_rag_system_tpu.train import distill as jdist
from financial_rag_system_tpu_torch.models import bert as tbert
from financial_rag_system_tpu_torch.models.tokenizer import Tokenizer, pad_batch
from financial_rag_system_tpu_torch.train import checkpoint as tckpt
from financial_rag_system_tpu_torch.train import contrastive as tcon
from financial_rag_system_tpu_torch.train import cross_encoder as tcross
from financial_rag_system_tpu_torch.train import distill as tdist
from financial_rag_system_tpu_torch.train.optim import ClippedAdamW, graded

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-2
LEAF_RTOL = 1e-2
OPTIM_RTOL = 1e-5
TRAJ_LOSS_RTOL = 1e-4
TRAJ_STEPS = 5
TRAJ_LR_UNITS = 2 * TRAJ_STEPS

ENC = dict(vocab_size=30522, hidden=32, layers=2, heads=2, intermediate=64,
           max_positions=64)
CROSS = dict(ENC, with_pooler=True, num_labels=1)

PAIRS = [
    ("apple revenue quarter", "apple reported quarterly revenue of 90 billion"),
    ("microsoft cloud growth", "microsoft azure cloud grew 24 percent"),
    ("tesla vehicle deliveries", "tesla delivered 400 thousand vehicles"),
    ("nvidia data center", "nvidia data center revenue tripled"),
    ("google ad sales", "google advertising sales were strong"),
    ("amazon retail margin", "amazon retail operating margin improved"),
    ("meta user count", "meta daily active users increased"),
    ("jpm interest income", "jpmorgan net interest income rose"),
] * 2
TRIPLES = [(q, d, PAIRS[(i + 3) % len(PAIRS)][1]) for i, (q, d) in enumerate(PAIRS)]


def models(kw: dict, seed: int = 0, params=None):
    """(JAX params as numpy, JAX cfg, the port's model on the CPU): JAX's
    init from ``seed``, or ``params``."""
    jcfg = jbert.BertConfig(**kw)
    if params is None:
        params = jax.tree_util.tree_map(np.asarray,
                                        jbert.init_params(jax.random.PRNGKey(seed), jcfg))
    model = tbert.load_jax_params(tbert.BertModel(tbert.BertConfig(**kw), device="cpu"), params)
    return params, jcfg, model


@functools.lru_cache(maxsize=1)
def warm_params():
    """The ``ENC`` init after ten InfoNCE steps of JAX's trainer (batches
    of 4 triples, lr 3e-3), so that the embeddings no longer nearly
    coincide."""
    params, jcfg, _ = models(ENC)
    params, _ = jcon.train(params, jcfg, (TRIPLES * 3)[:40], batch_size=4, lr=3e-3,
                           neg_weight=0.5, seed=7)
    return jax.tree_util.tree_map(np.asarray, params)


def grads_of(model: tbert.BertModel) -> dict:
    """The model's ``.grad``s (zeros where None) as a JAX-layout pytree."""
    holder = tbert.BertModel(model.cfg, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            holder.get_parameter(name).copy_(torch.zeros_like(p) if p.grad is None else p.grad)
    return tbert.export_jax_params(holder)


def leaves(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def grab_grads():
    """An optax transformation that leaves the parameters as they are and
    returns the gradients as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


def assert_grads_close(jax_grads, port_grads) -> None:
    """The whole gradient within ``GRAD_TOL`` of its norm; each leaf within
    ``LEAF_RTOL`` of its own norm, but the key bias (exactly zero, see the
    module docstring), within ``GRAD_TOL`` of the whole norm."""
    a, b = leaves(jax_grads), leaves(port_grads)
    assert a.keys() == b.keys()
    total = np.sqrt(sum(np.sum(v.astype(np.float64) ** 2) for v in a.values()))
    diff = np.sqrt(sum(np.sum((a[k].astype(np.float64) - b[k]) ** 2) for k in a))
    assert diff <= GRAD_TOL * total, (diff, total)
    for k in a:
        err = np.linalg.norm(a[k].astype(np.float64) - b[k])
        bound = GRAD_TOL * total if k.endswith("['k_b']") else LEAF_RTOL * np.linalg.norm(a[k])
        assert err <= bound, (k, err, bound)


def jnp_batch(batch):
    return tuple(jnp.asarray(x) for x in batch)


def tokens(pairs, max_len=16):
    return tcon.tokenize_pairs(Tokenizer(), pairs, max_len=max_len)


# -- one step of each objective ------------------------------------------------


def infonce_case(with_negs: bool):
    params, jcfg, model = models(ENC, params=warm_params())
    batches = tokens(TRIPLES if with_negs else PAIRS)
    neg_weight = 0.5 if with_negs else 1.0
    step = jcon.make_train_step(None, jcfg, grab_grads(), neg_weight=neg_weight,
                                hard_negatives=with_negs)
    _, jgrads, jloss = step(params, grab_grads().init(params), *map(jnp_batch, batches))
    with graded(model):
        loss = tcon.info_nce_loss(model, *(tcon.on_device(b, "cpu") for b in batches[:2]), 0.05,
                                  tcon.on_device(batches[2], "cpu") if with_negs else None,
                                  neg_weight)
        loss.backward()
    return float(jloss), jgrads, float(loss.detach()), grads_of(model)


def cross_batch(examples, max_len):
    tok = Tokenizer()
    ids, types, mask = pad_batch([tok.encode_pair(q, d, max_len) for q, d, _ in examples])
    labels = np.zeros(ids.shape[0], np.float32)
    labels[: len(examples)] = [lbl for *_, lbl in examples]
    return ids, types, mask, labels


def bce_case(kw=CROSS, max_len=64, examples=None):
    params, jcfg, model = models(kw, seed=2)
    examples = examples or tcross.make_cross_examples(tickers=["AAPL"], seed=0)[:12]
    batch = cross_batch(examples, max_len)
    step = jcross.make_cross_step(jcfg, grab_grads(), pos_weight=3.0)
    _, jgrads, jloss = step(params, grab_grads().init(params), *map(jnp.asarray, batch))
    with graded(model):
        loss = tcross.bce_loss(model, *map(torch.from_numpy, batch), 3.0)
        loss.backward()
    return float(jloss), jgrads, float(loss.detach()), grads_of(model)


def margin_case():
    params, jcfg, model = models(ENC, params=warm_params())
    q, p, n = tokens(TRIPLES)
    margins = np.random.default_rng(0).standard_normal(q[0].shape[0]).astype(np.float32)
    step = jdist.make_distill_step(jcfg, grab_grads())
    _, jgrads, jloss = step(params, grab_grads().init(params), jnp_batch(q), jnp_batch(p),
                            jnp_batch(n), jnp.asarray(margins))
    with graded(model):
        loss = tdist.margin_mse_loss(model, *(tcon.on_device(b, "cpu") for b in (q, p, n)),
                                     torch.from_numpy(margins))
        loss.backward()
    return float(jloss), jgrads, float(loss.detach()), grads_of(model)


CASES = {
    "infonce_pairs": lambda: infonce_case(False),
    "infonce_triples_w05": lambda: infonce_case(True),
    "bce": bce_case,
    "margin_mse": margin_case,
}


@pytest.mark.parametrize("objective", list(CASES))
def test_one_step_loss_and_grads_match_jax(objective):
    jloss, jgrads, loss, grads = CASES[objective]()
    assert np.isfinite(loss)
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss), (loss, jloss)
    assert_grads_close(jgrads, grads)


def test_cross_encoder_grad_at_a_256_bucket_takes_the_einsum_path(monkeypatch):
    """Pairs past 128 tokens pad to a 256 bucket, where the serving forward
    takes the pair-attention kernel (``_pair_attn_enabled``); the graded
    forward takes the einsum path, as JAX's CPU trainer does, and never
    reaches the kernel wrapper."""
    from financial_rag_system_tpu_torch.data.synthetic import expand_chunk

    kw = dict(CROSS, max_positions=512)
    examples = [(q, expand_chunk(d, 900), lbl) for q, d, lbl in
                tcross.make_cross_examples(tickers=["MSFT"], seed=1)[:6]]
    assert cross_batch(examples, 256)[0].shape[1] == 256
    calls = []

    def kernel(*a, **k):
        calls.append(1)
        raise AssertionError("the graded forward reached the kernel wrapper")

    monkeypatch.setattr(tbert, "encoder_self_attention", kernel)
    jloss, jgrads, loss, grads = bce_case(kw, 256, examples)
    assert not calls
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss)
    assert_grads_close(jgrads, grads)
    # the same model outside a graded forward takes the kernel's path
    _, _, model = models(kw, seed=2)
    with pytest.raises(AssertionError, match="reached the kernel"):
        tbert.cross_score(model, *map(torch.from_numpy, cross_batch(examples, 256)[:3]))


def test_lookup_backward_is_the_embedding_backward():
    """``_Lookup`` (the graded forward's embedding on the card) gathers
    what ``F.embedding`` does, and its backward (a one-hot product for a
    small table, ``index_put_`` for a large one) gives the same sum.  Its
    fixed order holds on the card (the card tests); on the CPU
    ``index_put_`` adds in threads, so the CPU keeps ``F.embedding``."""
    rng = np.random.default_rng(0)
    for rows in (2, tbert.ONE_HOT_ROWS + 1, 300):
        ids = torch.from_numpy(rng.integers(0, rows, (32, 512)))
        table = torch.from_numpy(rng.standard_normal((rows, 24)).astype(np.float32))
        g = torch.from_numpy(rng.standard_normal((32, 512, 24)).astype(np.float32))
        grads = []
        for lookup in (tbert._Lookup.apply, torch.nn.functional.embedding):
            t = table.clone().requires_grad_(True)
            out = lookup(ids, t)
            assert torch.equal(out, table[ids])
            (out * g).sum().backward()
            grads.append(t.grad)
        # each within f32 rounding of the exact sum (up to about 8,000 terms)
        exact = torch.zeros(rows, 24, dtype=torch.float64).index_add_(
            0, ids.reshape(-1), g.reshape(-1, 24).double())
        for grad in grads:
            torch.testing.assert_close(grad.double(), exact, rtol=0,
                                       atol=1e-5 * float(exact.abs().max()))
    t = table.clone().requires_grad_(True)
    assert type(tbert._embedding(ids, t).grad_fn).__name__ == "EmbeddingBackward0"


def test_graded_forward_is_the_einsum_unfused_layer_at_every_length(monkeypatch):
    """The gates in a graded forward: no pair-attention kernel, no fused
    block, whatever the opt-ins say; outside one, the gates as before."""
    monkeypatch.setenv("RAG_TPU_PAIR_ATTN", "1")
    monkeypatch.setenv("RAG_TPU_FUSED_BLOCK", "1")
    assert not tbert._pair_attn_enabled(32, 16, graded=True)
    assert tbert._pair_attn_enabled(32, 16)
    _, _, model = models(ENC)
    assert not tbert._graded(model)
    with graded(model):
        assert tbert._graded(model)
        with torch.no_grad():
            assert not tbert._graded(model)
    assert not any(p.requires_grad for p in model.parameters())


# -- the optimizer against optax ---------------------------------------------------


@pytest.mark.parametrize("scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
def test_clipped_adamw_matches_optax(scale):
    rng = np.random.default_rng(1)
    shapes = {"a": (5, 7), "b": (7,), "c": (3, 4, 2), "unused": (6,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (scale * rng.standard_normal(s)).astype(np.float32) if k != "unused"
              else np.zeros(s, np.float32) for k, s in shapes.items()} for _ in range(5)]
    lr = 3e-3
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr))
    jp, state = {k: jnp.asarray(v) for k, v in params.items()}, None
    state = opt.init(jp)
    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    topt = ClippedAdamW(module, lr)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in module.named_parameters():
            p.grad = None if k == "unused" else torch.from_numpy(g[k].copy())
        norm = float(topt.step())
        want = float(optax.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
        assert abs(norm - want) <= 1e-6 * want
        assert all(p.grad is None for p in module.parameters())
    assert topt.count == 5
    for k, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=OPTIM_RTOL,
                                   atol=OPTIM_RTOL * lr)
    # the leaf with no gradient decayed, by (1 - lr * 1e-4) a step
    np.testing.assert_allclose(module.unused.detach().numpy(),
                               params["unused"] * (1 - lr * 1e-4) ** 5, rtol=1e-6)
    assert not np.allclose(module.unused.detach().numpy(), params["unused"], rtol=0, atol=0)


# -- five-step runs of each trainer -------------------------------------------------


def assert_trajectory(jparams, jlosses, model, losses, lr):
    assert len(losses) == len(jlosses) == TRAJ_STEPS
    np.testing.assert_allclose(losses, jlosses, rtol=TRAJ_LOSS_RTOL)
    a, b = leaves(jparams), leaves(tbert.export_jax_params(model))
    for k in a:
        err = np.abs(a[k] - b[k]).max()
        assert err <= TRAJ_LR_UNITS * lr, (k, err / lr)


def test_contrastive_train_five_steps_match_jax():
    params, jcfg, model = models(ENC)
    pairs = (TRIPLES * 2)[:20]
    jp, jl = jcon.train(params, jcfg, pairs, batch_size=4, lr=1e-3, neg_weight=0.5, seed=3)
    out, tl = tcon.train(model, pairs, batch_size=4, lr=1e-3, neg_weight=0.5, seed=3)
    assert out is model
    assert_trajectory(jp, jl, model, tl, 1e-3)


def test_cross_encoder_train_five_steps_match_jax():
    params, jcfg, model = models(CROSS, seed=2)
    examples = tcross.make_cross_examples(tickers=["AAPL"], seed=0)[:20]
    jp, jl = jcross.train_cross_encoder(params, jcfg, examples, batch_size=4, lr=1e-3,
                                        max_len=64, seed=1)
    _, tl = tcross.train_cross_encoder(model, examples, batch_size=4, lr=1e-3, max_len=64,
                                       seed=1)
    assert_trajectory(jp, jl, model, tl, 1e-3)


def test_distill_five_steps_match_jax():
    params, jcfg, model = models(ENC)
    ce_params, ce_jcfg, _ = models(CROSS, seed=1)
    # a teacher with margins of about 0.1, not 1e-5 as at init
    ce_params["classifier"]["w"] = ce_params["classifier"]["w"] * 1e4
    ce_model = tbert.load_jax_params(tbert.BertModel(tbert.BertConfig(**CROSS), device="cpu"),
                                     ce_params)
    jm = jdist.teacher_margins(ce_params, ce_jcfg, TRIPLES, tokenizer=JTokenizer(), max_len=32)
    tm = tdist.teacher_margins(ce_model, TRIPLES, max_len=32)
    np.testing.assert_allclose(tm, jm, rtol=1e-4, atol=1e-5)
    kw = dict(steps=5, batch_size=4, lr=1e-3, max_len=16, teacher_max_len=32, seed=2)
    jp, jl = jdist.distill(params, jcfg, ce_params, ce_jcfg, TRIPLES, **kw)
    _, tl = tdist.distill(model, ce_model, TRIPLES, **kw)
    assert_trajectory(jp, jl, model, tl, 1e-3)


# -- checkpoints ------------------------------------------------------------------------


def test_checkpoint_resume_is_bit_for_bit(tmp_path):
    """Three steps with a checkpoint at every step, then a second run
    that resumes from step 2's files and takes step 3 again: the same
    weights, moments and loss, bit for bit."""
    pairs = (PAIRS * 2)[:12]
    _, _, model = models(ENC)
    ck = str(tmp_path / "ck")
    _, losses = tcon.train(model, pairs, batch_size=4, lr=1e-3, checkpoint_dir=ck,
                           checkpoint_every=1)
    assert tckpt.latest_step(ck) == 3 and len(losses) == 3
    step3 = tckpt.restore_state(ck)[1]
    # resume from step 2: the epoch runs again from the restored state
    resumed_dir = str(tmp_path / "resumed")
    tckpt.save_state(resumed_dir, 2, tckpt.restore_state(ck, 2)[1])
    _, _, fresh = models(ENC)
    opt = ClippedAdamW(fresh, 1e-3)
    assert tcon._restore(resumed_dir, fresh, opt) == 2 and opt.count == 2
    step = tcon.make_train_step(fresh, opt)
    order = np.random.default_rng(0).permutation(len(pairs))
    loss = step(*tcon.tokenize_pairs(Tokenizer(), [pairs[i] for i in order[8:12]]))
    assert float(loss) == losses[2]
    for name, t in fresh.state_dict().items():
        assert torch.equal(t, step3["model"][name]), name
    for name in opt.names:
        assert torch.equal(opt.state_dict()["mu"][name], step3["opt"]["mu"][name])
        assert torch.equal(opt.state_dict()["nu"][name], step3["opt"]["nu"][name])
    # and train() itself resumes: the step count goes on from the latest
    _, _, again = models(ENC)
    tcon.train(again, pairs, batch_size=4, lr=1e-3, checkpoint_dir=ck, checkpoint_every=100)
    assert tckpt.latest_step(ck) == 6


def test_checkpoint_files_load_weights_only(tmp_path):
    _, _, model = models(ENC)
    opt = ClippedAdamW(model, 1e-3)
    path = tckpt.save_state(str(tmp_path), 7, {"model": model.state_dict(),
                                               "opt": opt.state_dict()})
    assert path.endswith("step_00000007")
    assert tckpt.restore_state(str(tmp_path / "missing")) is None
    step, state = tckpt.restore_state(str(tmp_path))
    assert step == 7 and state["opt"]["count"] == 0
    assert set(state["model"]) == set(model.state_dict())


# -- the serving log as supervision -------------------------------------------------------


def test_pairs_from_cache_closed_loop(tmp_path):
    """Cached production queries become (query, retrieved top chunk)
    supervision, gated by the feedback store (the port's index, embedder
    and cache; ``tests/test_train.py::test_pairs_from_cache_closed_loop``)."""
    from financial_rag_system_tpu_torch.index.flat import FlatIndex
    from financial_rag_system_tpu_torch.models.embedder import HashEmbedder
    from financial_rag_system_tpu_torch.serving.cache import CacheDB

    emb = HashEmbedder(device="cpu")
    index = FlatIndex(dim=emb.dim, capacity=128, tile=128, device="cpu")
    texts = [
        "revenue grew twelve percent on services strength",
        "litigation reserves increased after the consent decree",
    ]
    index.upsert(["a", "b"], emb.encode(texts), texts,
                 [{"ticker": "AAPL", "document_type": "10-K"}] * 2)
    db = CacheDB(str(tmp_path / "c.db"))
    db.save("h1", "AAPL", "how fast did revenue grow", "cached answer 1")
    db.save("h2", "AAPL", "what legal reserves exist", "cached answer 2")
    pairs = tcon.pairs_from_cache(db, index, emb)
    by_q = dict(pairs)
    assert len(pairs) == 2
    assert by_q["how fast did revenue grow"] == texts[0]
    assert by_q["what legal reserves exist"] == texts[1]
    db.add_feedback("h2", -1)
    assert [q for q, _ in tcon.pairs_from_cache(db, index, emb)] == ["how fast did revenue grow"]
    db.add_feedback("h2", 1)
    assert len(tcon.pairs_from_cache(db, index, emb)) == 2
    db.add_feedback("h1", 1)
    assert [q for q, _ in tcon.pairs_from_cache(db, index, emb, min_rating=1)] == [
        "how fast did revenue grow"
    ]
    # the pairs train the bi-encoder
    _, _, model = models(ENC)
    _, losses = tcon.train(model, pairs * 4, batch_size=4, lr=1e-3, epochs=2)
    assert len(losses) == 4 and all(np.isfinite(losses))
    db.close()


def _jax_attention(x):
    from financial_rag_system_tpu.ops.attention import encoder_self_attention

    q = x.reshape(1, 8, 2, 32)
    return encoder_self_attention(q, q, q, jnp.ones((1, 8), jnp.int32), 0.1, interpret=True)


def _jax_ffn(x):
    from financial_rag_system_tpu.ops.fused_bert import fused_ffn_ln

    w = jnp.full((64, 128), 0.01, jnp.float32)
    return fused_ffn_ln(x, w, jnp.zeros(128), w.T, jnp.zeros(64), jnp.ones(64), jnp.zeros(64),
                        1e-12, interpret=True)


@pytest.mark.parametrize("kernel", [_jax_attention, _jax_ffn], ids=["attention", "ffn_ln"])
def test_jax_kernels_have_no_backward(kernel):
    """Why a graded forward takes the einsum attention and the unfused
    layer: ``jax.grad`` through the JAX package's Pallas kernels (here in
    interpret mode) fails, so its trainers differentiate those paths."""
    x = jnp.linspace(-1.0, 1.0, 8 * 64, dtype=jnp.float32).reshape(8, 64)
    kernel(x).block_until_ready()
    with pytest.raises(ValueError, match="Linearization failed"):
        jax.grad(lambda v: kernel(v).sum())(x)
