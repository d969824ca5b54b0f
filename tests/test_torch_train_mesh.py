"""The port's data-parallel contrastive step against JAX's, on the CPU.

JAX's ``make_train_step(create_mesh("data:8,corpus:1"), ...)`` runs on
conftest's eight virtual devices; the port's on a ``data:8`` mesh of
``["cpu"] * 8`` (its shards one after another in one process), from the
same weights (``load_jax_params``) and the same token batches: the TINY
config, ``PAIRS`` and ``TRIPLES`` of ``tests/test_train.py``.  JAX's
gradients come back through ``grab_grads`` and the port's through an
optimizer that keeps them, as in ``tests/test_torch_train.py``.

Tolerances:
- against JAX, one step from weights ten JAX steps from init (at init
  the embeddings nearly coincide and the gradient is mostly bf16
  rounding, ``tests/test_torch_train.py``): the loss within
  ``LOSS_RTOL`` and each gradient leaf within that file's bounds
  (``assert_grads_close``); three steps' losses within rtol 2e-3;
- against the port's one-device step, JAX's
  ``test_mesh_step_matches_single_device`` bounds;
- the gather's backward: the mesh step's gradient against the
  one-device step's, each leaf that no bf16 product rounds (embeddings,
  layernorms, biases) within ``F32_LEAF_RTOL`` of its norm (measured at
  most 3.1e-6), and each dense weight within ``BF16_LEAF_RTOL``: a shard
  rounds its own weight gradient to bf16 before the shards' sum, as each
  JAX device does before ``pmean`` (measured 2.1e-3 to 6.4e-3).  A
  gather without its backward puts every leaf 0.5 to 1.6 of its norm
  away;
- two gloo ranks against one process: bit for bit (the two shards' sums
  are two-term sums either way).
"""

from __future__ import annotations

import functools
import multiprocessing
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_train_worker as worker
from test_torch_train import LOSS_RTOL, assert_grads_close, grab_grads, grads_of, leaves
from test_train import PAIRS, TINY, TRIPLES, _norm_ids, _norm_triple_ids

from financial_rag_system_tpu.models import bert as jbert
from financial_rag_system_tpu.parallel.mesh import create_mesh as jcreate_mesh
from financial_rag_system_tpu.train import contrastive as jcon
from financial_rag_system_tpu_torch.models import bert as tbert
from financial_rag_system_tpu_torch.parallel import collectives
from financial_rag_system_tpu_torch.parallel import mesh as tmesh
from financial_rag_system_tpu_torch.parallel.mesh import AXIS_CORPUS, AXIS_DATA, create_mesh
from financial_rag_system_tpu_torch.train import contrastive as tcon
from financial_rag_system_tpu_torch.train.checkpoint import latest_step
from financial_rag_system_tpu_torch.train.optim import ClippedAdamW

TINY_KW = dict(vocab_size=512, hidden=32, layers=2, heads=2, intermediate=64, max_positions=64)
MESH_LOSS_RTOL = 2e-3  # JAX's test_train.py:78
F32_LEAF_RTOL = 1e-5
BF16_LEAF_RTOL = 1e-2
DENSE = ("q_w", "k_w", "v_w", "o_w", "in_w", "out_w")
JOIN_S = 120

KINDS = {"pairs": (lambda: _norm_ids(PAIRS), 1.0),
         "triples": (lambda: _norm_triple_ids(TRIPLES), 0.5)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_mesh(n: int = 8):
    return create_mesh(f"data:{n},corpus:1", devices=["cpu"] * n)


def init_params():
    return jax.tree_util.tree_map(np.asarray, jbert.init_params(jax.random.PRNGKey(0), TINY))


@functools.lru_cache(maxsize=None)
def warm_params(kind: str):
    """TINY's init after ten single-device JAX steps (adamw 3e-3) on the
    kind's batch."""
    make, nw = KINDS[kind]
    batches = [tuple(jnp.asarray(a) for a in b) for b in make()]
    opt = optax.adamw(3e-3)
    params = init_params()
    state = opt.init(params)
    step = jcon.make_train_step(None, TINY, opt, hard_negatives=len(batches) > 2, neg_weight=nw)
    for _ in range(10):
        params, state, _ = step(params, state, *batches)
    return jax.tree_util.tree_map(np.asarray, params)


def port_model(params):
    return tbert.load_jax_params(tbert.BertModel(tbert.BertConfig(**TINY_KW), device="cpu"),
                                 params)


class KeepGrads:
    """An optimizer whose step keeps the gradients (JAX layout) and
    clears them, leaving the weights as they are."""

    def __init__(self, model):
        self.model, self.grads = model, None

    def step(self):
        self.grads = grads_of(self.model)
        for p in self.model.parameters():
            p.grad = None


def port_grads(params, batches, nw, mesh):
    model = port_model(params)
    keep = KeepGrads(model)
    loss = tcon.make_train_step(model, keep, neg_weight=nw, mesh=mesh)(*batches)
    return float(loss), keep.grads


@pytest.mark.parametrize("kind", list(KINDS))
def test_mesh_step_matches_jax_mesh_step(kind):
    """One ``data:8`` step from warm weights: the loss and every gradient
    leaf (after ``pmean``) against JAX's ``shard_map`` step."""
    make, nw = KINDS[kind]
    batches = make()
    params = warm_params(kind)
    step = jcon.make_train_step(jcreate_mesh("data:8,corpus:1"), TINY, grab_grads(),
                                hard_negatives=len(batches) > 2, neg_weight=nw)
    _, jgrads, jloss = step(params, grab_grads().init(params),
                            *[tuple(jnp.asarray(a) for a in b) for b in batches])
    loss, grads = port_grads(params, batches, nw, port_mesh())
    assert np.isfinite(loss)
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss)), (loss, float(jloss))
    assert_grads_close(jgrads, grads)


@pytest.mark.parametrize("kind", list(KINDS))
def test_mesh_three_steps_match_jax(kind):
    """Three ``data:8`` steps from init under each package's clipped
    AdamW: the per-step losses within rtol 2e-3."""
    make, nw = KINDS[kind]
    batches = make()
    params = init_params()
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3))
    step = jcon.make_train_step(jcreate_mesh("data:8,corpus:1"), TINY, opt,
                                hard_negatives=len(batches) > 2, neg_weight=nw)
    jb = [tuple(jnp.asarray(a) for a in b) for b in batches]
    p, state, jlosses = params, opt.init(params), []
    for _ in range(3):
        p, state, loss = step(p, state, *jb)
        jlosses.append(float(loss))
    model = port_model(params)
    tstep = tcon.make_train_step(model, ClippedAdamW(model, 1e-3), neg_weight=nw,
                                 mesh=port_mesh())
    losses = [float(tstep(*batches)) for _ in range(3)]
    np.testing.assert_allclose(losses, jlosses, rtol=MESH_LOSS_RTOL)


@pytest.mark.parametrize("kind", list(KINDS))
def test_mesh_step_matches_single_device(kind):
    """The port's ``data:8`` step against its one-device step, three
    steps from init: JAX's ``test_mesh_step_matches_single_device``
    bounds."""
    make, nw = KINDS[kind]
    batches = make()
    params = init_params()
    models, steps = [], []
    for mesh in (None, port_mesh()):
        model = port_model(params)
        models.append(model)
        steps.append(tcon.make_train_step(model, ClippedAdamW(model, 1e-3), neg_weight=nw,
                                          mesh=mesh))
    for _ in range(3):
        l1, l2 = (float(s(*batches)) for s in steps)
        np.testing.assert_allclose(l1, l2, rtol=2e-3, atol=2e-3)
    for (name, a), b in zip(models[0].state_dict().items(), models[1].state_dict().values()):
        a, b = a.numpy(), b.numpy()
        assert np.max(np.abs(a - b)) < 5e-2, name
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na > 0.5 and nb > 0.5:
            assert (a.ravel() @ b.ravel()) / (na * nb) > 0.995, name


def _leaf_errors(kind, detach: bool, monkeypatch) -> dict:
    make, nw = KINDS[kind]
    batches = make()
    params = warm_params(kind)
    _, one = port_grads(params, batches, nw, None)
    if detach:
        gather = collectives.all_gather_data
        monkeypatch.setattr(tcon, "all_gather_data", lambda m, parts: gather(m, parts).detach())
    _, mesh = port_grads(params, batches, nw, port_mesh())
    a, b = leaves(one), leaves(mesh)
    return {k: np.linalg.norm(a[k].astype(np.float64) - b[k]) / np.linalg.norm(a[k]) for k in a}


@pytest.mark.parametrize("kind", list(KINDS))
def test_mesh_gradient_carries_every_shard(kind, monkeypatch):
    """The gather's backward brings every shard's query terms to the
    documents: the mesh step's gradient is the one-device step's, each
    leaf that no bf16 product rounds within 1e-5 of its norm, each dense
    weight within bf16 rounding (module docstring)."""
    errors = _leaf_errors(kind, False, monkeypatch)
    for k, err in errors.items():
        bound = BF16_LEAF_RTOL if k.endswith(tuple(f"['{w}']" for w in DENSE)) else F32_LEAF_RTOL
        assert err <= bound, (k, err, bound)


def test_a_gather_without_its_backward_is_caught(monkeypatch):
    """The same comparison with the gather detached (documents without
    the other shards' terms): every leaf far past both bounds."""
    errors = _leaf_errors("triples", True, monkeypatch)
    assert min(errors.values()) > 10 * BF16_LEAF_RTOL, errors


@pytest.mark.parametrize("kind", list(KINDS))
def test_one_shard_mesh_over_one_rank_is_the_one_device_step(kind):
    """A ``data:1`` mesh whose axis spans a one-rank gloo group takes the
    one-device step's arithmetic through the real collectives: three
    steps' losses and weights bit for bit.  The group is torn down and
    set up anew for a second run in the same process, which
    ``initialize_distributed`` allows."""
    import torch.distributed as dist

    from financial_rag_system_tpu_torch.parallel.distributed import initialize_distributed

    make, nw = KINDS[kind]
    batches = make()
    params = warm_params(kind)

    def run(mesh):
        model = port_model(params)
        step = tcon.make_train_step(model, ClippedAdamW(model, 1e-3), neg_weight=nw, mesh=mesh)
        return torch.stack([step(*batches) for _ in range(3)]), model.state_dict()

    want = run(None)
    for _ in range(2):
        assert initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0, backend="gloo",
                                      timeout_s=60)
        try:
            mesh = create_mesh("data:1", devices=["cpu"], ranks_axis=AXIS_DATA)
            assert mesh.data_distributed and dist.get_world_size() == 1
            losses, weights = run(mesh)
        finally:
            dist.destroy_process_group()
        assert torch.equal(losses, want[0])
        for k, v in want[1].items():
            assert torch.equal(v, weights[k]), k


@pytest.mark.parametrize("kind", list(KINDS))
def test_step_without_a_mesh_is_the_plain_step(kind):
    """``make_train_step`` without a mesh (a one-shard mesh on the
    model's device) against :func:`info_nce_loss`'s graded backward and
    one optimizer update, written out: three steps' losses and weights
    bit for bit."""
    from financial_rag_system_tpu_torch.train.optim import graded

    make, nw = KINDS[kind]
    batches = make()
    params = warm_params(kind)
    plain, stepped = port_model(params), port_model(params)
    opt = ClippedAdamW(plain, 1e-3)
    step = tcon.make_train_step(stepped, ClippedAdamW(stepped, 1e-3), neg_weight=nw)
    dev = plain.device
    for _ in range(3):
        with graded(plain):
            want = tcon.info_nce_loss(
                plain, tcon.on_device(batches[0], dev), tcon.on_device(batches[1], dev), 0.05,
                tcon.on_device(batches[2], dev) if len(batches) > 2 else None, nw)
            want.backward()
        opt.step()
        assert torch.equal(step(*batches), want.detach())
    for k, v in plain.state_dict().items():
        assert torch.equal(v, stepped.state_dict()[k]), k


def test_mesh_refuses_data_shards_off_the_model_device():
    model = port_model(init_params())
    mesh = create_mesh("data:2", devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="one process trains on one device"):
        tcon.make_train_step(model, ClippedAdamW(model, 1e-3), mesh=mesh)
    step = tcon.make_train_step(model, ClippedAdamW(model, 1e-3), mesh=port_mesh(3))
    with pytest.raises(ValueError, match="does not split"):
        step(*_norm_ids(PAIRS))


@pytest.mark.parametrize("batch_size,rows", [(12, 8), (5, 8), (16, 16)])
def test_train_rounds_the_batch_to_the_data_axis(batch_size, rows, monkeypatch):
    """``train(mesh=...)`` takes ``max(batch_size, n) // n * n`` rows a
    step (JAX ``contrastive.py:235-236``): the steps JAX takes, each on
    a global batch of that many rows, with JAX's losses."""
    kw = dict(worker.ENC)
    jcfg = jbert.BertConfig(**kw)
    params = jax.tree_util.tree_map(np.asarray, jbert.init_params(jax.random.PRNGKey(0), jcfg))
    _, jlosses = jcon.train(params, jcfg, PAIRS, mesh=jcreate_mesh("data:8,corpus:1"),
                            batch_size=batch_size, lr=1e-3)
    seen = []
    make = tcon.make_train_step

    def recording(*a, **k):
        step = make(*a, **k)

        def recorded(q, d, n=None):
            seen.append(q[0].shape[0])
            return step(q, d, n)
        return recorded

    monkeypatch.setattr(tcon, "make_train_step", recording)
    model = tbert.load_jax_params(tbert.BertModel(tbert.BertConfig(**kw), device="cpu"), params)
    _, losses = tcon.train(model, PAIRS, mesh=port_mesh(8), batch_size=batch_size, lr=1e-3)
    assert seen == [rows] * (len(PAIRS) // rows)
    assert len(losses) == len(jlosses)
    np.testing.assert_allclose(losses, jlosses, rtol=MESH_LOSS_RTOL)


def test_mesh_axes_over_the_ranks(monkeypatch):
    """Under a process group (faked: rank 1 of 2) a spec with ``data``
    above 1 puts ``data`` over the processes and keeps ``corpus`` within
    one; without it ``corpus`` spans them, as sharded serving uses it;
    never both."""
    monkeypatch.setattr(tmesh, "_process_group", lambda: (1, 2))
    m = create_mesh("data:2", devices=["cpu"])
    assert m.shape == {AXIS_DATA: 2, AXIS_CORPUS: 1} and m.ranks_axis == AXIS_DATA
    assert m.data_distributed and not m.distributed
    assert m.data_index(0) == 1 and m.shard_index(0) == 0
    m = create_mesh("data:4,corpus:2", devices=["cpu"] * 4)
    assert m.shape == {AXIS_DATA: 4, AXIS_CORPUS: 2} and len(m.grid) == 2
    assert [m.data_index(r) for r in range(2)] == [2, 3] and len(m.devices) == 2
    m = create_mesh(devices=["cpu"] * 2)
    assert m.shape == {AXIS_DATA: 1, AXIS_CORPUS: 4} and m.distributed
    assert not m.data_distributed and m.shard_index(1) == 3
    with pytest.raises(ValueError, match="never both"):
        create_mesh("data:3,corpus:2", devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="must have one shard"):
        create_mesh("data:2", devices=["cpu"], ranks_axis=AXIS_CORPUS)
    with pytest.raises(ValueError, match="ranks_axis"):
        create_mesh(devices=["cpu"], ranks_axis="model")
    monkeypatch.setattr(tmesh, "_process_group", lambda: (0, 1))
    m = create_mesh("data:1", devices=["cpu"], ranks_axis=AXIS_DATA)
    assert m.data_distributed and m.shape == {AXIS_DATA: 1, AXIS_CORPUS: 1}
    monkeypatch.setattr(tmesh, "_process_group", lambda: None)
    assert create_mesh("data:2", devices=["cpu"] * 2, ranks_axis=AXIS_DATA).ranks_axis is None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_match_one_process(tmp_path):
    """``train(mesh=create_mesh("data:2"))`` in two gloo ranks of one
    shard each against one process of ``data:2``: the losses and weights
    bit for bit, through three steps with a checkpoint after each (rank 0
    writes) and a resume from the last (both ranks restore)."""
    pairs = [(q, d, PAIRS[(i + 5) % len(PAIRS)][1]) for i, (q, d) in enumerate(PAIRS)]
    want = worker.run(create_mesh("data:2", devices=["cpu"] * 2), pairs, str(tmp_path / "one"))
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=worker.run_rank,
                         args=(r, 2, port, pairs, str(tmp_path / f"rank{r}.npz"),
                               str(tmp_path / "two")))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.time() + JOIN_S
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.time()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, f"ranks did not finish within {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0, 0]
    assert int(want["step_a"]) == worker.STEPS_A
    assert len(want["losses_b"]) == len(pairs) // 4
    assert latest_step(str(tmp_path / "two")) == worker.STEPS_A + len(pairs) // 4
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert set(got.files) == set(want)
        for key, value in want.items():
            assert got[key].tobytes() == np.asarray(value).tobytes(), (r, key)
