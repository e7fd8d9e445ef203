"""Stochastic depth — ``drop_path`` of ``hvt/models/common.py``."""

from __future__ import annotations

import torch


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """Per-sample stochastic depth (timm DropPath semantics): zero the whole
    residual branch of a sample with probability ``rate`` and scale the kept
    ones by 1/(1 − rate). The (B, 1, ..., 1) keep mask is drawn from
    ``generator`` (on x's device), or from torch's default generator when it
    is None; JAX's PRNG gives other draws from the same seed."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    kept = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(kept, x / keep, torch.zeros_like(x))
