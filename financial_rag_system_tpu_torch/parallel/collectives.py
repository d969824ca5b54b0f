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

The data-parallel trainer (``train/contrastive.py``) joins its data
shards over the ``data`` axis:

- :func:`all_gather_data` (tiled, along rows): the local data shards'
  rows in shard order, then ``all_gather`` across ranks in rank order,
  as a ``torch.autograd.Function`` whose backward is JAX's transpose of
  ``all_gather``, a ``psum_scatter``: the cotangent ``all_reduce(SUM)``
  across ranks, then each local shard's block of rows, so every shard's
  rows receive every other shard's terms;
- :func:`pmean_`: in place, the sum over ranks divided by the ``data``
  size, for values the caller has already summed over its local shards.

Without a process group the cross-rank step is skipped.  The group's
backend is NCCL for a mesh of cards and gloo for a CPU mesh
(:mod:`parallel.distributed`); both take the
list form of ``all_gather`` that every torch version keeps (the
``_into_tensor`` form is deprecated in recent ones).  bf16 and int8
travel as bytes, so the wire never depends on a backend's type list.
"""

from __future__ import annotations

import torch

from financial_rag_system_tpu_torch.parallel.mesh import AXIS_DATA, Mesh


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



class _GatherData(torch.autograd.Function):
    """:func:`all_gather_data` with the backward that carries the other
    shards' terms home (see the module docstring)."""

    @staticmethod
    def forward(ctx, mesh: Mesh, *parts: torch.Tensor) -> torch.Tensor:
        ctx.mesh, ctx.rows = mesh, [p.shape[0] for p in parts]
        local = torch.cat(parts, dim=0)
        if not mesh.data_distributed:
            return local
        import torch.distributed as dist

        outs = [torch.empty_like(local) for _ in range(mesh.world)]
        dist.all_gather(outs, local.contiguous())
        return torch.cat(outs, dim=0)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        mesh = ctx.mesh
        if mesh.data_distributed:
            import torch.distributed as dist

            grad = grad.contiguous().clone()
            dist.all_reduce(grad, op=dist.ReduceOp.SUM)
            grad = grad.narrow(0, mesh.rank * sum(ctx.rows), sum(ctx.rows))
        return (None, *grad.split(ctx.rows, dim=0))


def all_gather_data(mesh: Mesh, parts: list[torch.Tensor]) -> torch.Tensor:
    """Tiled all-gather over the ``data`` axis with a gradient: one tensor
    of equal rows per local data shard (f32 or f64, on one device) ->
    every data shard's rows in global shard order.  Its backward gives
    each shard the sum over all shards of the cotangent on its rows
    (JAX's ``all_gather`` under ``shard_map``)."""
    return _GatherData.apply(mesh, *parts)


def pmean_(mesh: Mesh, tensors: list[torch.Tensor]) -> None:
    """``lax.pmean`` over the ``data`` axis, in place: each tensor holds
    the sum of its value over this process's data shards; it becomes the
    sum over every shard (one ``all_reduce(SUM)`` of all the tensors,
    flattened, across ranks) divided by the ``data`` size."""
    if mesh.data_distributed and tensors:
        import torch.distributed as dist

        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))
    n = mesh.shape[AXIS_DATA]
    for t in tensors:
        t.div_(n)
