"""optax's ``chain(clip_by_global_norm(1.0), adamw(lr))`` for the port.

Every JAX trainer (``train/contrastive.py``, ``cross_encoder.py``,
``distill.py``) updates its parameters with that chain.  The port has no
optax, so :class:`ClippedAdamW` computes the same update rule on the
model's parameters, in optax's order of operations:

1. the global norm of all gradients, ``sqrt(sum(sum(g**2)))``; when it
   is at least ``MAX_NORM``, every gradient becomes ``g / norm *
   MAX_NORM`` (optax's select: below it the gradients pass unchanged,
   with no ``norm + eps`` divide as ``torch.nn.utils.clip_grad_norm_``
   has);
2. Adam moments ``mu = (1 - B1) g + B1 mu`` and ``nu = (1 - B2) g**2 +
   B2 nu``, bias corrections ``1 - b**count`` in f32, and the direction
   ``mu_hat / (sqrt(nu_hat + eps_root) + EPS)`` with ``eps_root`` 0;
3. decoupled weight decay ``+ WEIGHT_DECAY * p`` on every parameter
   (optax's default mask is none), then ``p += -lr * update``.

The constants are optax's defaults, which every JAX trainer takes
(``optax.adamw(lr)``); the learning rate is the only setting.

A parameter whose ``.grad`` is ``None`` (the bi-encoder's pooler: the
contrastive loss reads CLS) counts as a zero gradient, as ``jax.grad``
returns zeros for it, so it still decays; ``torch.optim.AdamW`` would
skip it, and its default decay is 0.01 against optax's 1e-4.  The update
runs on ``torch._foreach_*`` ops, a few launches for all tensors.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

MAX_NORM = 1.0
B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4


@contextlib.contextmanager
def graded(model: nn.Module):
    """Every parameter of ``model`` requires grad inside the block (a
    trainer's forward and backward, which ``models/bert.py _graded`` sends
    down the differentiable path) and none after it, so the model serves
    as loaded once the block ends."""
    model.requires_grad_(True)
    try:
        yield model
    finally:
        model.requires_grad_(False)


def clip_by_global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """optax ``clip_by_global_norm(MAX_NORM)``, in place: when the global
    norm (the f32 L2 norm over all tensors) is at least ``MAX_NORM``, each
    gradient becomes ``g / norm * MAX_NORM``.  Returns the norm before
    clipping, a 0-d tensor."""
    norm = torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()
    if not bool(norm < MAX_NORM):
        torch._foreach_div_(grads, float(norm))
        torch._foreach_mul_(grads, MAX_NORM)
    return norm


class ClippedAdamW:
    """``optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr))``
    over every parameter of ``model`` (see the module docstring).  :meth:`step` consumes and
    clears the gradients and tells the model its weights changed
    (``BertModel.weights_changed`` drops the fused-block packs)."""

    def __init__(self, model: nn.Module, lr: float):
        if getattr(model, "quantized", False):
            raise ValueError("an int8-PTQ model cannot be trained")
        self.model, self.lr = model, lr
        self.names = [name for name, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def _bias_correction(self, decay: float) -> float:
        """``1 - decay**count`` in f32, as optax computes it."""
        return float(np.float32(1) - np.float32(decay) ** np.float32(self.count))

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' ``.grad`` (``None`` counts as
        zeros), which it then clears.  Returns the gradients' global norm
        before clipping (a 0-d tensor)."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        for p in self.params:
            p.grad = None
        norm = clip_by_global_norm(grads)
        new = torch._foreach_mul(grads, 1 - B1)
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, new)
        new = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(new, 1 - B2)
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_add_(self.nu, new)
        self.count += 1
        mu_hat = torch._foreach_div(self.mu, self._bias_correction(B1))
        root = torch._foreach_div(self.nu, self._bias_correction(B2))
        torch._foreach_sqrt_(root)
        torch._foreach_add_(root, EPS)
        update = torch._foreach_div(mu_hat, root)
        torch._foreach_add_(update, torch._foreach_mul(self.params, WEIGHT_DECAY))
        torch._foreach_mul_(update, -self.lr)
        torch._foreach_add_(self.params, update)
        changed = getattr(self.model, "weights_changed", None)
        if changed is not None:
            changed()
        return norm

    def state_dict(self) -> dict:
        """``count`` and the moments by parameter name (what
        ``torch.load(weights_only=True)`` reads back)."""
        return {"count": self.count,
                "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if sorted(state["mu"]) != sorted(self.names):
            raise ValueError("the optimizer state names other parameters")
        self.count = int(state["count"])
        for name, mu, nu in zip(self.names, self.mu, self.nu):
            mu.copy_(state["mu"][name])
            nu.copy_(state["nu"][name])
