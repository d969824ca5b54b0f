"""Device resolution for the port's entry points.

Every public constructor and factory takes an explicit ``device``.  The
default is the card: a caller that did not ask for the CPU never gets a
silent CPU run.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device to run on; raises when CUDA was asked for and is
    missing instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: financial_rag_system_tpu_torch runs on "
            "the GPU by default; pass device='cpu' to run on the CPU"
        )
    return dev
