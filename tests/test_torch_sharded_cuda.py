"""The port's mesh-sharded tier on the card: four shards on one card
(``[cuda:0] * 4``) against one device and against the same mesh on the
CPU (the kernels' plain versions), with the kernels' launches counted.

Needs an NVIDIA GPU; skips without one.  Imports neither JAX nor the JAX
package:

    python -m pytest --noconftest tests/test_torch_sharded_cuda.py -q
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import socket

import numpy as np
import pytest
import torch

from financial_rag_system_tpu_torch.index.flat import FlatIndex
from financial_rag_system_tpu_torch.index.ivf import ivf_probe
from financial_rag_system_tpu_torch.index.sharded import ShardedFlatIndex
from financial_rag_system_tpu_torch.index.sharded_hnsw import ShardedHNSWIndex
from financial_rag_system_tpu_torch.index.sharded_ivf import ShardedIVFIndex
from financial_rag_system_tpu_torch.models import bert
from financial_rag_system_tpu_torch.ops import fused_query as fq
from financial_rag_system_tpu_torch.ops.attention import encoder_self_attention
from financial_rag_system_tpu_torch.ops.topk import masked_topk
from financial_rag_system_tpu_torch.parallel.mesh import create_mesh

pytestmark = pytest.mark.cuda

D, N, CAP = 128, 6000, 8192
FILTERS = np.array([[-1, -1], [0, -1], [1, 1], [2, -1]] * 4, np.int32)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def clustered(rng, n, centers=32):
    c = rng.standard_normal((centers, D)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    v = c[rng.integers(0, centers, n)] + 0.2 * rng.standard_normal((n, D)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def build(index, v):
    n = len(v)
    index.upsert([f"p{i}" for i in range(n)], v, [f"t{i}" for i in range(n)],
                 [{"ticker": ("AAPL", "MSFT", "NVDA")[i % 3],
                   "document_type": ("10-K", "10-Q")[i % 2]} for i in range(n)])
    return index


def sharded(dev, v, dtype=torch.bfloat16, capacity=CAP):
    return build(ShardedFlatIndex(create_mesh(devices=[dev] * 4), D, capacity=capacity,
                                  tile=1024, dtype=dtype), v)


def search(index, q, k=15):
    s, i = index.search_device(torch.as_tensor(q, device=index.device),
                               torch.as_tensor(FILTERS[: len(q)], device=index.device), k)
    return s.cpu().numpy(), i.cpu().numpy()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
def test_sharded_flat_on_card(cuda, dtype):
    """Kernel 1 on each of four shards: the single-device rows, scores
    within 1e-6 (bit for bit in int8), the CPU mesh's rows, and a run
    whose last shard holds no valid rows."""
    rng = np.random.default_rng(0)
    v = clustered(rng, N)
    q = clustered(rng, 16)
    card = sharded("cuda:0", v, dtype)
    flat = build(FlatIndex(D, capacity=CAP, tile=1024, dtype=dtype, device="cuda"), v)
    masked_topk.launches = masked_topk.launches_int8 = 0
    s, i = search(card, q)
    assert masked_topk.launches + masked_topk.launches_int8 == 4
    s_1, i_1 = search(flat, q)
    np.testing.assert_array_equal(i, i_1)
    if dtype == torch.int8:
        assert s.tobytes() == s_1.tobytes()
    else:
        np.testing.assert_allclose(s, s_1, atol=1e-6, rtol=0)
    s_c, i_c = search(sharded("cpu", v, dtype), q)
    np.testing.assert_array_equal(i, i_c)
    np.testing.assert_allclose(s, s_c, atol=2e-3, rtol=0)
    # capacity 4 x 4096: shard 2 holds rows 8192-12287, beyond the corpus
    s, i = search(sharded("cuda:0", v, dtype, capacity=4 * 4096), q, 40)
    s_1, i_1 = search(flat, q, 40)
    np.testing.assert_array_equal(i, i_1)


def test_sharded_ivf_and_hnsw_on_card(cuda):
    """Kernel 3 on every shard's packing (an empty last shard packs
    padding only) and the per-shard walks: the CPU mesh's rows."""
    rng = np.random.default_rng(1)
    v = clustered(rng, N)
    q = clustered(rng, 16)
    card, cpu = sharded("cuda:0", v, capacity=4 * 2048), sharded("cpu", v, capacity=4 * 2048)
    ivf_c, ivf_h = ShardedIVFIndex(card, n_clusters=32), ShardedIVFIndex(cpu, n_clusters=32)
    assert ivf_c.c_max == ivf_h.c_max and ivf_c._tail_rows == ivf_h._tail_rows
    assert (ivf_c.packed_gids[3].cpu().numpy() == -1).all()
    ivf_probe.launches = 0
    s, i = search(ivf_c, q)
    assert ivf_probe.launches == 4
    s_h, i_h = search(ivf_h, q)
    np.testing.assert_array_equal(i, i_h)
    np.testing.assert_allclose(s, s_h, atol=2e-3, rtol=0)
    hn_c = ShardedHNSWIndex(card)  # the CPU walks the card's graphs
    hn_h = ShardedHNSWIndex(cpu, graphs=hn_c._host_graphs, pools=hn_c._host_pools)
    s, i = search(hn_c, q)
    s_h, i_h = search(hn_h, q)
    assert (i == i_h).mean() > 0.98
    np.testing.assert_allclose(s[i == i_h], s_h[i == i_h], atol=1e-5, rtol=0)


def test_sharded_fused_query_on_card(cuda):
    """The sharded fused program: kernel 1 on four shards, kernel 2 on four
    rerank chunks (pairs of 288 tokens) a layer; the card's rows and
    logits against one device's program."""
    rng = np.random.default_rng(2)
    v = clustered(rng, N)
    card = sharded("cuda:0", v)
    flat = build(FlatIndex(D, capacity=CAP, tile=1024, device="cuda"), v)
    cfg = bert.BertConfig(vocab_size=30522, hidden=D, layers=2, heads=4, intermediate=256,
                          with_pooler=True, max_positions=512)
    rcfg = dataclasses.replace(cfg, num_labels=1)
    e_model, r_model = (bert.load_jax_params(bert.BertModel(c, device="cuda"), bert.init_params(
        torch.Generator().manual_seed(s), c)) for s, c in ((0, cfg), (1, rcfg)))
    dtok = torch.from_numpy(rng.integers(1000, 30522, (CAP, 256)).astype(np.int32)).cuda()
    p = card.per_shard
    dtok_shards = tuple(dtok[g * p:(g + 1) * p].contiguous() for g in range(4))
    q_ids = torch.from_numpy(rng.integers(1000, 30522, (16, 32)).astype(np.int32)).cuda()
    batch = (q_ids, torch.zeros_like(q_ids), torch.ones_like(q_ids),
             torch.from_numpy(FILTERS).cuda())
    masked_topk.launches = encoder_self_attention.launches = 0
    emb, codes, _ = card._arrays
    rows, bi, ce = fq.make_sharded_fused_query(card.mesh, rcfg, k=15)(
        e_model, r_model, *batch, emb, codes, dtok_shards, N)
    assert masked_topk.launches == 4 and encoder_self_attention.launches == 4 * 2
    rows_1, bi_1, ce_1 = fq.fused_two_stage(e_model, r_model, *batch, *flat._arrays[:2], dtok,
                                            N, rerank_cfg=rcfg, k=15)
    np.testing.assert_array_equal(rows.cpu().numpy(), rows_1.cpu().numpy())
    np.testing.assert_allclose(bi.cpu().numpy(), bi_1.cpu().numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ce.cpu().numpy(), ce_1.cpu().numpy(), atol=1e-2, rtol=0)


def _one_rank(port: int, out):
    from financial_rag_system_tpu_torch.parallel.distributed import initialize_distributed

    import torch.distributed as dist

    initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        rng = np.random.default_rng(0)
        v = clustered(rng, N)
        card = sharded("cuda:0", v)
        assert card.mesh.distributed and dist.get_backend() == "nccl"
        s, i = search(card, clustered(rng, 16))
        out.put((s, i))
    finally:
        dist.destroy_process_group()


def test_one_rank_nccl_group_matches_no_group(cuda):
    """A one-rank NCCL group: the collectives run through NCCL and give
    the rows and scores of the run without a group."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    proc = ctx.Process(target=_one_rank, args=(port, out))
    proc.start()
    got = out.get(timeout=240)
    proc.join(timeout=60)
    assert proc.exitcode == 0
    rng = np.random.default_rng(0)
    v = clustered(rng, N)
    s, i = search(sharded("cuda:0", v), clustered(rng, 16))
    np.testing.assert_array_equal(got[1], i)
    assert got[0].tobytes() == s.tobytes()
