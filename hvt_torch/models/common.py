"""Stochastic depth — ``drop_path`` of ``hvt/models/common.py``."""

from __future__ import annotations

import torch


def drop_path_scale(batch: int, rate: float, generator: torch.Generator | None = None,
                    device=None) -> torch.Tensor:
    """The (B,) f32 per-sample branch scale of stochastic depth:
    bernoulli(1 − rate)/(1 − rate), drawn from ``generator`` (on ``device``),
    or from torch's default generator when it is None. hvt draws the same
    mask with ``jax.random.bernoulli``; JAX's PRNG gives other draws from the
    same seed."""
    keep = 1.0 - rate
    kept = torch.rand((batch,), generator=generator, device=device) < keep
    return kept.float() / keep


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """Per-sample stochastic depth (timm DropPath semantics): zero the whole
    residual branch of a sample with probability ``rate`` and scale the kept
    ones by 1/(1 − rate), the mask drawn by ``drop_path_scale``."""
    if not training or rate == 0.0:
        return x
    s = drop_path_scale(x.shape[0], rate, generator, x.device)
    kept = (s > 0).reshape((x.shape[0],) + (1,) * (x.ndim - 1))
    return torch.where(kept, x / (1.0 - rate), torch.zeros_like(x))
