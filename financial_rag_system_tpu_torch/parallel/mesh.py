"""Device mesh construction and axis conventions.

Port of ``financial_rag_system_tpu/parallel/mesh.py``.  The corpus is the
sharded dimension:

- ``corpus`` axis: corpus rows are sharded across devices; each shard
  computes a local top-k over its rows and the partials merge after an
  all-gather (:mod:`parallel.collectives`, :mod:`index.sharded`).
- ``data`` axis: query-batch data parallelism for the encoders and the
  contrastive trainer.  Serving uses the ``corpus`` axis only: every
  data row holds the same corpus shards, so the port serves from the
  first.

A mesh is a ``(data, corpus)`` grid of ``torch.device`` s.  With no spec
all devices go to ``corpus``; ``RAG_TPU_MESH="data:2,corpus:4"``
overrides.  With no device list it takes every visible CUDA device (under
a process group, this process's own card), and raises without one.  An
explicit list may name one device more than once:
``[torch.device("cpu")] * 8`` stands in for the JAX tests' eight
virtual CPU devices, and ``[torch.device("cuda:0")] * 4`` puts four
shards on one card, whose launches then run one after another.

Under ``torch.distributed`` (:mod:`parallel.distributed`) each process
holds its own devices' shards and one axis spans the processes in rank
order, never both:

- ``corpus`` (serving; the default when ``data`` has one shard): global
  corpus shard ``rank * local + i`` is this process's ``i``-th, the
  order of JAX's process-major device list;
- ``data`` (the data-parallel trainer, ``train/contrastive.py``; the
  default when the spec gives ``data`` more than one shard): each
  process holds ``data / world`` data shards, global data shard ``rank *
  local + r`` is its ``r``-th row, and the ``corpus`` axis stays within
  the process.  ``create_mesh("data:2")`` under two ranks gives one data
  shard a rank; ``ranks_axis="data"`` puts a one-shard ``data`` axis
  over a single rank.
"""

from __future__ import annotations

import torch

from financial_rag_system_tpu_torch.utils.device import resolve_device

AXIS_DATA = "data"
AXIS_CORPUS = "corpus"


def _parse_mesh_shape(spec: str) -> dict[str, int]:
    """Parse "data:2,corpus:4" into {"data": 2, "corpus": 4}."""
    out: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, size = part.partition(":")
        out[name.strip()] = int(size)
    return out


def _process_group() -> tuple[int, int] | None:
    """(rank, world size) of the default process group, None without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return None


class Mesh:
    """A ``(data, corpus)`` grid of this process's devices.

    ``shape`` is the global shape (the axis in ``ranks_axis`` counts
    every process's shards); ``grid`` holds this process's data rows of
    corpus shards, ``devices`` its first row's corpus shards in order,
    ``home`` the device that holds replicated values (queries, merged
    results).  ``distributed`` says whether a process group joins the
    corpus shards of other processes, ``data_distributed`` the data
    shards."""

    def __init__(self, grid: list[list[torch.device]], *, rank: int = 0, world: int = 1,
                 ranks_axis: str | None = None):
        self.grid = grid
        self.rank = rank
        self.world = world
        self.ranks_axis = ranks_axis
        self.local_data = len(grid)
        self.local_corpus = len(grid[0])
        span = {AXIS_DATA: 1, AXIS_CORPUS: 1}
        if ranks_axis is not None:
            span[ranks_axis] = world
        self.shape = {AXIS_DATA: self.local_data * span[AXIS_DATA],
                      AXIS_CORPUS: self.local_corpus * span[AXIS_CORPUS]}

    @property
    def distributed(self) -> bool:
        return self.ranks_axis == AXIS_CORPUS

    @property
    def data_distributed(self) -> bool:
        return self.ranks_axis == AXIS_DATA

    @property
    def devices(self) -> list[torch.device]:
        return self.grid[0]

    @property
    def home(self) -> torch.device:
        return self.grid[0][0]

    def shard_index(self, local: int) -> int:
        """Global shard index of this process's ``local``-th shard
        (``lax.axis_index`` over ``corpus``)."""
        return self.rank * self.local_corpus + local if self.distributed else local

    def data_index(self, local: int) -> int:
        """Global data shard index of this process's ``local``-th data row
        (``lax.axis_index`` over ``data``)."""
        return self.rank * self.local_data + local if self.data_distributed else local

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices={[str(d) for d in self.devices]}, "
                f"rank={self.rank}/{self.world}, ranks_axis={self.ranks_axis})")


def _default_devices(in_group: bool) -> list[torch.device]:
    """Every visible card; under a process group only this process's own
    card, the one :func:`parallel.distributed.initialize_distributed`
    bound (NCCL takes one rank a card, as JAX's ``local_devices`` gives
    each process its own).  A process that drives several cards names
    them in ``devices``."""
    resolve_device("cuda")  # raises without a card
    if in_group:
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]


def create_mesh(
    spec: str = "",
    *,
    devices: list[torch.device | str] | None = None,
    ranks_axis: str | None = None,
) -> Mesh:
    """Build the framework mesh.

    With no spec, all devices are assigned to the ``corpus`` axis and
    ``data`` is size 1 (serving default: shard the index, replicate the
    small encoder weights).  Under a process group the spec counts every
    process's devices and one axis spans the processes (see the module
    docstring): ``ranks_axis``, by default ``data`` when the spec gives it
    more than one shard, else ``corpus``."""
    group = _process_group()
    if devices is None:
        devices = _default_devices(group is not None)
    devs = [resolve_device(d) for d in devices]
    rank, world = group or (0, 1)
    n = len(devs) * world
    if spec:
        shape = _parse_mesh_shape(spec)
        data = shape.get(AXIS_DATA, 1)
        corpus = shape.get(AXIS_CORPUS, n // max(data, 1))
    else:
        data, corpus = 1, n
    if data * corpus != n:
        raise ValueError(
            f"mesh {AXIS_DATA}:{data} x {AXIS_CORPUS}:{corpus} != {n} devices"
        )
    if group is None:
        ranks_axis = None
    elif ranks_axis is None:
        ranks_axis = AXIS_DATA if data > 1 else AXIS_CORPUS
    elif ranks_axis not in (AXIS_DATA, AXIS_CORPUS):
        raise ValueError(f"ranks_axis {ranks_axis!r}: {AXIS_DATA!r} or {AXIS_CORPUS!r}")
    if ranks_axis == AXIS_DATA:
        if data % world:
            raise ValueError(f"{AXIS_DATA}:{data} does not split over {world} processes; "
                             f"one axis spans the processes, never both")
        rows, cols = data // world, corpus
    else:
        if world > 1 and data != 1:
            raise ValueError(f"the {AXIS_CORPUS} axis spans the processes, so {AXIS_DATA} "
                             f"must have one shard ({world} processes, {AXIS_DATA}:{data})")
        rows, cols = data, corpus // world
    grid = [devs[r * cols:(r + 1) * cols] for r in range(rows)]
    return Mesh(grid, rank=rank, world=world, ranks_axis=ranks_axis)


def local_mesh(n: int | None = None) -> Mesh:
    """Mesh over the first ``n`` visible CUDA devices, all on ``corpus``."""
    resolve_device("cuda")
    devs = [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]
    if n is not None:
        devs = devs[:n]
    return create_mesh(devices=devs)
