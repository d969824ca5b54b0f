"""One process's part of ``tests/test_torch_multiprocess.py``: the same
seeded corpus, models and queries on a CPU mesh, run in one process over
four shards or in two gloo ranks over two shards each.  Imports no JAX."""

from __future__ import annotations

import numpy as np
import torch

D, K, N, CAPACITY, TILE = 32, 7, 700, 512, 64
TINY = dict(vocab_size=2048, hidden=32, layers=1, heads=2, intermediate=64, with_pooler=True)


def _index(mesh):
    from financial_rag_system_tpu_torch.index.sharded import ShardedFlatIndex

    rng = np.random.default_rng(0)
    v = rng.standard_normal((N, D)).astype(np.float32)
    idx = ShardedFlatIndex(mesh, D, capacity=CAPACITY, tile=TILE)
    pays = [{"ticker": ("AAPL", "MSFT", "NVDA")[i % 3], "document_type": "10-K"}
            for i in range(N)]
    # two upserts: the second grows every shard (the blocks redistribute)
    idx.upsert([f"p{i}" for i in range(300)], v[:300], ["t"] * 300, pays[:300])
    idx.upsert([f"p{i}" for i in range(300, N)], v[300:], ["t"] * (N - 300), pays[300:])
    return idx, rng


def _models():
    from financial_rag_system_tpu_torch.models import bert

    out = []
    for seed, extra in ((0, dict(max_positions=64)), (1, dict(max_positions=128, num_labels=1))):
        cfg = bert.BertConfig(**TINY, **extra)
        model = bert.BertModel(cfg, device="cpu")
        bert.load_jax_params(model, bert.init_params(torch.Generator().manual_seed(seed), cfg))
        out.append((model, cfg))
    return out


def compute(mesh, save_dir=None) -> dict:
    """Search, the fused flat program and the skewed balanced rerank on
    ``mesh``; every rank returns the replicated results."""
    from financial_rag_system_tpu_torch.ops import fused_query as fq

    idx, rng = _index(mesh)
    q = rng.standard_normal((8, D)).astype(np.float32)
    qf = np.array([[-1, -1], [0, -1], [1, 0], [2, -1]] * 2, np.int32)
    s, i = idx.search_device(q, qf, 40)
    out = {"capacity": np.int64(idx.capacity), "search_s": s.numpy(), "search_i": i.numpy()}
    (e_model, _), (r_model, r_cfg) = _models()
    dtok = rng.integers(103, 2000, (idx.capacity, 24)).astype(np.int32)
    from financial_rag_system_tpu_torch.index.sharded import block

    p = idx.per_shard
    dtok_shards = tuple(block(dtok, mesh.shard_index(j) * p, p, fill=0, dtype=torch.int32,
                              device=d) for j, d in enumerate(mesh.devices))
    q_ids = torch.from_numpy(rng.integers(103, 2000, (4, 16)).astype(np.int32))
    ones = torch.ones_like(q_ids)
    emb, codes, _ = idx._arrays
    rows, bi, ce = fq.make_sharded_fused_query(mesh, r_cfg, k=K)(
        e_model, r_model, q_ids, torch.zeros_like(q_ids), ones, torch.from_numpy(qf[:4]),
        emb, codes, dtok_shards, idx.n_valid)
    out.update(fused_rows=rows.numpy(), fused_bi=bi.numpy(), fused_ce=ce.numpy())
    # every candidate on shard 0, an empty slot a query, 15 pairs over 4 shards
    g_rows = rng.integers(0, p, (3, 5)).astype(np.int32)
    g_rows[:, -1] = -1
    g_bi = rng.standard_normal((3, 5)).astype(np.float32)
    g_bi[:, -1] = -np.inf
    with torch.inference_mode():
        out["rerank"] = fq._sharded_balanced_rerank(
            mesh, r_model, q_ids[:3], torch.from_numpy(g_rows), torch.from_numpy(g_bi),
            dtok_shards, rows_per_shard=p, rerank_cfg=r_cfg).numpy()
    if save_dir is not None:
        idx.save(save_dir)
    return out


def run_rank(rank: int, world: int, port: int, out_path: str, save_dir: str) -> None:
    """A gloo rank: two CPU shards of a four-shard mesh."""
    from financial_rag_system_tpu_torch.parallel.distributed import initialize_distributed
    from financial_rag_system_tpu_torch.parallel.mesh import create_mesh

    import torch.distributed as dist

    initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo", timeout_s=120)
    try:
        out = compute(create_mesh(devices=["cpu"] * 2), save_dir)
        np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()
