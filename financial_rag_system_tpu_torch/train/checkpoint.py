"""Checkpoint and resume of a trainer's model and optimizer state.

Port of ``financial_rag_system_tpu/train/checkpoint.py`` with a format of
the port's own: ``directory/step_%08d/state.pt``, one ``torch.save`` of
``{"step": step, **state}`` (the trainers save ``{"model":
model.state_dict(), "opt": optimizer.state_dict()}``), read back with
``torch.load(weights_only=True)``, so a checkpoint holds tensors, ints
and dicts and never runs code.  ``save_state``, ``latest_step`` and
``restore_state`` keep the JAX names and resume semantics (the latest
step by default).  The JAX package checkpoints through orbax; this
module does not read orbax directories, and the JAX package does not
read these.
"""

from __future__ import annotations

import os
from typing import Any

import torch

STATE_FILE = "state.pt"


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step:08d}")


def save_state(directory: str, step: int, state: dict[str, Any]) -> str:
    """Save ``state`` (tensors, numbers and dicts of them) under
    ``directory/step_{step:08d}``, replacing what was there; returns that
    path.  The file is written whole before it takes its name, so a run
    cut short leaves the previous step readable."""
    path = _step_dir(directory, step)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save({"step": step, **state}, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def latest_step(directory: str) -> int | None:
    d = os.path.abspath(directory)
    if not os.path.isdir(d):
        return None
    steps = [
        int(name.split("_")[1])
        for name in os.listdir(d)
        if name.startswith("step_") and name.split("_")[1].isdigit()
        and os.path.exists(os.path.join(d, name, STATE_FILE))
    ]
    return max(steps) if steps else None


def restore_state(
    directory: str, step: int | None = None, *, map_location: str | torch.device = "cpu",
) -> tuple[int, dict[str, Any]] | None:
    """(step, state) of ``step`` or the latest one; None if nothing is
    checkpointed.  Tensors load onto ``map_location``; the trainers copy
    them into their model and optimizer with ``load_state_dict``."""
    s = step if step is not None else latest_step(directory)
    if s is None:
        return None
    state = torch.load(os.path.join(_step_dir(directory, s), STATE_FILE),
                       map_location=map_location, weights_only=True)
    state.pop("step")
    return s, state
