"""The three collectives of the JAX package's sharded programs, over a
:class:`parallel.mesh.Mesh`.

JAX runs one program a device under ``shard_map`` and joins them with
``all_gather``, ``psum`` and ``axis_index`` over the ``corpus`` axis.
The port runs this process's shards one after another (their launches
queue on each shard's device) and joins them the same way:

- :func:`all_gather` (tiled, along ``dim``): this process's shards'
  tensors concatenated in shard order on the mesh's home device, then
  ``torch.distributed.all_gather`` across ranks in rank order;
- :func:`psum`: the local shards' sum, then ``all_reduce(SUM)``;
- ``Mesh.shard_index`` for ``axis_index``.

Without a process group the cross-rank step is skipped.  The group's
backend is NCCL for a mesh of cards and gloo for a CPU mesh
(:mod:`parallel.distributed`); both take the
list form of ``all_gather`` that every torch version keeps (the
``_into_tensor`` form is deprecated in recent ones).  bf16 and int8
travel as bytes, so the wire never depends on a backend's type list.
"""

from __future__ import annotations

import torch

from financial_rag_system_tpu_torch.parallel.mesh import Mesh


def _wire(t: torch.Tensor) -> torch.Tensor:
    """bf16 and int8 travel as their bytes (gloo takes neither bf16 nor
    int16); 4- and 8-byte types as they are."""
    return t.view(torch.uint8) if t.element_size() < 4 else t


def all_gather(mesh: Mesh, parts: list[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """Tiled all-gather: one tensor per local shard (equal shapes, any
    devices) -> their concatenation along ``dim`` over every shard of the
    ``corpus`` axis, on ``mesh.home``."""
    local = torch.cat([p.to(mesh.home) for p in parts], dim=dim).contiguous()
    if not mesh.distributed:
        return local
    import torch.distributed as dist

    wire = _wire(local)
    outs = [torch.empty_like(wire) for _ in range(mesh.world)]
    dist.all_gather(outs, wire)
    return torch.cat(outs, dim=dim).view(local.dtype)


def psum(mesh: Mesh, parts: list[torch.Tensor]) -> torch.Tensor:
    """Sum of one tensor per local shard over every shard, on
    ``mesh.home``.  Integer sums are exact; callers exchange float rows
    as f32 whose other terms are zeros, which is exact too."""
    total = parts[0].to(mesh.home)
    for p in parts[1:]:
        total = total + p.to(mesh.home)
    if mesh.distributed:
        import torch.distributed as dist

        total = total.contiguous()
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return total

