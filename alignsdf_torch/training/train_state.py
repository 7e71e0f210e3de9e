"""Training state: the model, torch's Adam with the reference's settings, the
step LR schedule and the optional global-norm clip (the JAX package's
``training/train_state.py``; reference train.py:55-62,396,585-586)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import torch

from alignsdf_torch.config import Specs


@dataclass
class TrainState:
    """What one train step updates.  ``epoch`` starts at 1 and drives the LR
    schedule and the AdditionalLossStart gate."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    epoch: int = 1


def make_optimizer(specs: Specs, params: Iterable[torch.nn.Parameter]) -> torch.optim.Adam:
    """Adam with torch's defaults, as the reference builds it; the learning
    rate is written into the param groups at every step."""
    return torch.optim.Adam(params, lr=learning_rate_for_epoch(specs, 1),
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=0)


def learning_rate_for_epoch(specs: Specs, epoch: int) -> float:
    """Step schedule: initial * factor ** (epoch // interval)."""
    return specs.lr_schedules[0].learning_rate(epoch)


def clip_by_global_norm_(params: Iterable[torch.nn.Parameter], max_norm: float) -> torch.Tensor:
    """Scale every gradient by min(1, max_norm / ||g||) over all of them, as
    optax.clip_by_global_norm does (torch's clip_grad_norm_ adds 1e-6 to the
    norm).  Returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm
