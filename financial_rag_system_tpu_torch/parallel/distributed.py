"""Multi-process initialization.

Port of ``financial_rag_system_tpu/parallel/distributed.py``: every host
runs this process, ``torch.distributed`` wires them, the mesh's
``corpus`` axis spans every process's devices, and exactly one process
(rank 0) owns the HTTP front — the serving shell checks
:func:`is_coordinator` before binding.

It reads the JAX package's environment variables
(``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``),
so one deployment config drives either package, or explicit arguments.
Without a coordinator address it is a no-op, so the same entry point
works everywhere.  The backend is NCCL when a card is visible, else
gloo (``backend=`` overrides).
"""

from __future__ import annotations

import datetime
import os

import torch


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    timeout_s: float = 600.0,
) -> bool:
    """Idempotent ``init_process_group``.  Returns True when a process
    group is (or already was) set up."""
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if coordinator_address is None:
        return False  # single-process run
    if dist.is_initialized():
        return True  # a group torn down with destroy_process_group is set up anew
    num_processes = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    process_id = (
        process_id
        if process_id is not None
        else int(os.environ.get("JAX_PROCESS_ID", "0"))
    )
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        # one card a process: the launcher's LOCAL_RANK where it sets one,
        # else the process id (processes of one host numbered together)
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


def is_coordinator() -> bool:
    """True on the process that should own the HTTP front (rank 0)."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1
