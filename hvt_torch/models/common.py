"""Shared model pieces — port of ``hvt/models/common.py``: stochastic depth
and the two BatchNorm modules of the conv models.

Both BatchNorms take an NHWC activation, hold ``weight``/``bias``
parameters (flax's ``scale``/``bias``) and ``running_mean``/``running_var``
buffers (flax's ``batch_stats`` ``mean``/``var``), and keep flax
``nn.BatchNorm``'s semantics rather than torch's:

* training normalises with the biased batch moments in f32 and updates
  ra ← 0.9·ra + 0.1·batch with the *biased* variance (``torch.nn.BatchNorm2d``
  would use the unbiased one and call 0.1 its momentum), eps 1e-5, output in
  the input's dtype;
* eval computes (x − ra_mean)·rsqrt(ra_var + eps)·scale + bias.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from hvt_torch.ops import bn_stats


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


class _BatchNormBase(nn.Module):
    momentum = 0.9  # flax's: ra ← momentum·ra + (1 − momentum)·batch

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    @torch.no_grad()
    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def _eval(self, x: torch.Tensor) -> torch.Tensor:
        y = F.batch_norm(x.permute(0, 3, 1, 2), self.running_mean, self.running_var, self.weight,
                         self.bias, training=False, eps=self.eps)
        return y.permute(0, 2, 3, 1)


class BatchNorm(_BatchNormBase):
    """flax ``nn.BatchNorm`` on an NHWC tensor. Training runs torch's batch
    norm (``torch.native_batch_norm``: cuDNN-class kernels on the card, not a
    kernel of this repository) with no running statistics of its own, and
    updates the flax way from the biased batch moments it returns: its
    mean, and var = invstd⁻² − eps."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return self._eval(x)
        y, mean, invstd = torch.native_batch_norm(
            x.permute(0, 3, 1, 2), self.weight, self.bias, None, None, True, 0.0, self.eps)
        self._update(mean.detach(), invstd.detach().pow(-2) - self.eps)
        return y.permute(0, 2, 3, 1)


class PallasBatchNorm(_BatchNormBase):
    """hvt's ``PallasBatchNorm`` (``bn_pallas: true``): training goes through
    :func:`hvt_torch.ops.bn_stats.bn_train` on the free (rows, C) view of the
    NHWC input, so its two reductions run the BatchNorm kernels on the card;
    the running statistics update from the mean and var it returns. The view
    raises on an input that is not NHWC-contiguous: no silent copy."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return self._eval(x)
        c = x.shape[-1]
        y, mean, var = bn_stats.bn_train(x.view(-1, c), self.weight, self.bias, self.eps, x.dtype)
        self._update(mean, var)
        return y.view(x.shape)
