"""One process's part of ``tests/test_torch_train_mesh.py``: the
data-parallel contrastive trainer over a ``data:2`` mesh, in one process
of two CPU data shards or in two gloo ranks of one shard each.  Imports
no JAX."""

from __future__ import annotations

import numpy as np
import torch

ENC = dict(vocab_size=30522, hidden=32, layers=1, heads=2, intermediate=64, max_positions=64)
STEPS_A = 3  # the first run's steps (a checkpoint after each)


def _model():
    from financial_rag_system_tpu_torch.models import bert

    cfg = bert.BertConfig(**ENC)
    model = bert.BertModel(cfg, device="cpu")
    return bert.load_jax_params(model, bert.init_params(torch.Generator().manual_seed(0), cfg))


def run(mesh, pairs, ckpt: str) -> dict:
    """Three steps with a checkpoint after each, then a fresh model that
    resumes from the checkpoint and trains one more epoch of the same
    pairs; the losses and both runs' weights."""
    from financial_rag_system_tpu_torch.train import contrastive
    from financial_rag_system_tpu_torch.train.checkpoint import latest_step

    kw = dict(mesh=mesh, batch_size=4, lr=1e-3, neg_weight=0.5, seed=5, checkpoint_dir=ckpt)
    first, losses_a = contrastive.train(_model(), pairs[: 4 * STEPS_A], checkpoint_every=1,
                                        **kw)
    out = {"losses_a": np.asarray(losses_a), "step_a": np.int64(latest_step(ckpt))}
    out.update({f"a/{k}": v.numpy() for k, v in first.state_dict().items()})
    resumed, losses_b = contrastive.train(_model(), pairs, checkpoint_every=1000, **kw)
    out["losses_b"] = np.asarray(losses_b)
    out.update({f"b/{k}": v.numpy() for k, v in resumed.state_dict().items()})
    return out


def run_rank(rank: int, world: int, port: int, pairs, out_path: str, ckpt: str) -> None:
    """A gloo rank holding one data shard of ``data:2``."""
    import torch.distributed as dist

    from financial_rag_system_tpu_torch.parallel.distributed import initialize_distributed
    from financial_rag_system_tpu_torch.parallel.mesh import create_mesh

    torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo", timeout_s=120)
    try:
        mesh = create_mesh("data:2", devices=["cpu"])
        assert mesh.data_distributed and mesh.data_index(0) == rank
        np.savez(out_path, **run(mesh, pairs, ckpt))
    finally:
        dist.destroy_process_group()
