"""Shared model pieces — port of ``hvt/models/common.py``: flax's Dense,
Conv and LayerNorm arithmetic, its ``lecun_normal``, the transformer MLP,
squeeze-excite, stochastic depth, the BatchNorm modules of the conv models,
and recomputation.

Every BatchNorm takes an NHWC activation, holds ``weight``/``bias``
parameters (flax's ``scale``/``bias``) and ``running_mean``/``running_var``
buffers (flax's ``batch_stats`` ``mean``/``var``), and keeps flax
``nn.BatchNorm``'s semantics rather than torch's:

* training normalises with the biased batch moments in f32 and updates
  ra ← m·ra + (1 − m)·batch with the *biased* variance (``torch.nn.BatchNorm2d``
  would use the unbiased one and call 1 − m its momentum), output in the
  input's dtype; flax's momentum m and eps are constructor arguments, 0.9
  and 1e-5 by default (ResNet's and RegNet's; EfficientNet's are 0.99 and
  1e-3);
* eval computes (x − ra_mean)·rsqrt(ra_var + eps)·scale + bias.

Under a declared data group (:mod:`hvt_torch.parallel`) training normalises
with the global microbatch's moments, as hvt's modules do under GSPMD, and
the running statistics end equal on every rank: :class:`PallasBatchNorm` and
:class:`CustomBatchNorm` through ``bn_train``'s data-parallel route;
:class:`BatchNorm` through per-channel Σx and Σx² in f32 summed over the
ranks by a differentiable all-reduce, flax's fast variance E[x²] − E[x]²;
:class:`GroupedBatchNorm` two-pass as hvt's, each group's Σx and then its
Σ(x − mean)² summed over the ranks the same way (:func:`_group_sums`).
Stochastic depth draws its mask over the global microbatch's rows
(:func:`drop_path_scale`).

The four training routes, which ResNet's knobs pick as hvt's
``make_batch_norm`` does: :class:`BatchNorm` (torch's batch norm),
:class:`PallasBatchNorm` (``bn_pallas``: the BatchNorm kernels),
:class:`CustomBatchNorm` (``bn_custom``: the same custom backward with
torch's reductions) and :class:`GroupedBatchNorm` (``bn_groups`` > 1).

:func:`recompute` runs a block under ``torch.utils.checkpoint`` (hvt's
``nn.remat``): the block's BatchNorms update their running statistics in the
forward only, and the recomputation draws the forward's drop-path masks.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from hvt_torch import parallel
from hvt_torch.ops import bn_stats


def trunc02_(w: torch.Tensor, gen: torch.Generator) -> None:
    """hvt's ``trunc02`` initialiser, drawn from ``gen``."""
    nn.init.trunc_normal_(w, std=0.02, a=-0.04, b=0.04, generator=gen)


def lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax's ``lecun_normal``: variance_scaling(1, fan_in, "truncated_normal"),
    a normal truncated at two standard deviations with its std corrected to
    sqrt(1 / fan-in) after the cut, drawn from ``gen``."""
    std = (1.0 / w[0].numel()) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=gen)


def channels_last_(conv: nn.Conv2d) -> nn.Conv2d:
    """``conv``'s weight in channels-last memory (cuDNN's NHWC kernels)."""
    conv.weight.data = conv.weight.data.contiguous(memory_format=torch.channels_last)
    return conv


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """flax ``Conv(dtype=d)`` on an NHWC tensor: ``F.conv2d`` on its
    channels-last NCHW view with the kernel (and bias) cast to x's dtype,
    at the layer's stride, padding and groups; returns NHWC."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype), bias, conv.stride, conv.padding,
                 1, conv.groups)
    return y.permute(0, 2, 3, 1)


def se_gate(reduce: nn.Conv2d, expand: nn.Conv2d, h: torch.Tensor, act) -> torch.Tensor:
    """Squeeze-excite of an NHWC ``h`` (RegNet-Y's and EfficientNet's): the
    spatial mean through the two 1×1 convs (``act`` between them), a sigmoid
    gate on ``h``, all in h's dtype."""
    s = conv_nhwc(reduce, h.mean(dim=(1, 2), keepdim=True))
    s = conv_nhwc(expand, act(s))
    return h * torch.sigmoid(s)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm(dtype=d): statistics in f32, output in x's dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(x.dtype)


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax Dense(dtype=d): input, kernel and bias cast to x's dtype."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


class TransformerMlp(nn.Module):
    """hvt's ``TransformerMlp``: fc1 → exact (erf) GELU → fc2, each Dense in
    the input's dtype."""

    def __init__(self, dim: int, hidden: int, out: int | None = None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim if out is None else out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.fc2, F.gelu(linear(self.fc1, x)))


def drop_path_scale(batch: int, rate: float, generator: torch.Generator | None = None,
                    device=None) -> torch.Tensor:
    """The (B,) f32 per-sample branch scale of stochastic depth:
    bernoulli(1 − rate)/(1 − rate), drawn from ``generator`` (on ``device``),
    or from torch's default generator when it is None. hvt draws the same
    mask with ``jax.random.bernoulli``; JAX's PRNG gives other draws from the
    same seed. Under a declared data group the draw is over the global
    microbatch and the rank keeps its rows (``parallel.rand_rows``)."""
    keep = 1.0 - rate
    kept = parallel.rand_rows((batch,), generator, device) < keep
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
    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum  # flax's: ra ← momentum·ra + (1 − momentum)·batch
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.recomputing = False  # set by recompute(): the forward already updated

    @torch.no_grad()
    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        if self.recomputing:
            return
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def _eval(self, x: torch.Tensor) -> torch.Tensor:
        y = F.batch_norm(x.permute(0, 3, 1, 2), self.running_mean, self.running_var, self.weight,
                         self.bias, training=False, eps=self.eps)
        return y.permute(0, 2, 3, 1)


def _group_sums(rows: torch.Tensor, gid: torch.Tensor, groups: int) -> torch.Tensor:
    """(groups, ...) sums of each group's ``rows`` (indexed by ``gid``) over
    the declared data group, through a differentiable all-reduce (the
    rank's own sums without a group)."""
    local = rows.new_zeros((groups, *rows.shape[1:])).index_add(0, gid, rows)
    return parallel.all_reduce_sum(local)


class BatchNorm(_BatchNormBase):
    """flax ``nn.BatchNorm`` on an NHWC tensor. Training runs torch's batch
    norm (``torch.native_batch_norm``: cuDNN-class kernels on the card, not a
    kernel of this repository) with no running statistics of its own, and
    updates the flax way from the biased batch moments it returns: its
    mean, and var = invstd⁻² − eps."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return self._eval(x)
        if parallel.data_group() is not None:
            return self._global(x)
        y, mean, invstd = torch.native_batch_norm(
            x.permute(0, 3, 1, 2), self.weight, self.bias, None, None, True, 0.0, self.eps)
        self._update(mean.detach(), invstd.detach().pow(-2) - self.eps)
        return y.permute(0, 2, 3, 1)

    def _global(self, x: torch.Tensor) -> torch.Tensor:
        """Training on the global microbatch's moments: the rank's (2, C)
        Σx and Σx² in f32 through a differentiable all-reduce, mean = Σx/n,
        var = max(Σx²/n − mean², 0) (flax's fast variance), and flax's
        ``_normalize`` order (x − mean)·(rsqrt(var + eps)·scale) + bias,
        cast to x's dtype."""
        xf = x.float()
        rows = xf.reshape(-1, x.shape[-1])
        sums = parallel.all_reduce_sum(torch.stack((rows.sum(0), (rows * rows).sum(0))))
        n = rows.shape[0] * parallel.world()
        mean = sums[0] / n
        var = torch.clamp_min(sums[1] / n - mean * mean, 0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        self._update(mean.detach(), var.detach())
        return y.to(x.dtype)


class PallasBatchNorm(_BatchNormBase):
    """hvt's ``PallasBatchNorm`` (``bn_pallas: true``): training goes through
    :func:`hvt_torch.ops.bn_stats.bn_train` on the free (rows, C) view of the
    NHWC input, and on the card every pass of it runs a kernel of
    ``csrc/bn_stats.cu``: forward the sums with their finish (mean, var,
    rstd) and the normalize, backward the reduce with its finish and dx;
    the running statistics update from the mean and var it returns. The view
    raises on an input that is not NHWC-contiguous: no silent copy."""

    torch_reductions = False  # bn_train's reductions: the kernels on the card

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return self._eval(x)
        c = x.shape[-1]
        y, mean, var = bn_stats.bn_train(x.view(-1, c), self.weight, self.bias, self.eps, x.dtype,
                                         self.torch_reductions)
        self._update(mean, var)
        return y.view(x.shape)


class CustomBatchNorm(PallasBatchNorm):
    """hvt's ``bn_custom`` (``PallasBatchNorm(use_pallas=False)``): the same
    custom backward (``bn_train``, which saves x in its dtype and the
    per-channel moments and recomputes x̂), every pass of it the plain
    version (torch's reductions and eager elementwise formulas) on every
    device. The config picks it; no kernel of this repository runs."""

    torch_reductions = True


class GroupedBatchNorm(_BatchNormBase):
    """hvt's ``GroupedBatchNorm`` (``bn_groups`` > 1, ghost BatchNorm): the
    batch splits into ``groups`` equal slices, each normalised in f32 over
    its own moments (the statistics of the reference's per-GPU DDP
    BatchNorm), the output in the input's dtype; the running statistics
    update from the pooled moments (mean of the means; mean of the
    variances plus the variance of the means, the law of total variance).
    Under gradient accumulation the groups split each microbatch, as hvt's
    do. The groups are contiguous rows of the global microbatch, and a
    group may span ranks: the mean is each group's Σx over the data group,
    the variance each group's Σ(x − mean)² over it (two passes, as hvt's
    mean((x − mean_g)²)); without a group both sums are the process's own.
    torch's autograd differentiates it; no kernel of this repository
    runs."""

    def __init__(self, channels: int, groups: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__(channels, eps, momentum)
        self.groups = int(groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return self._eval(x)
        b, g, c = x.shape[0], self.groups, x.shape[-1]
        total, offset = parallel.global_rows(b)
        if total % g:
            raise ValueError(f"batch {total} not divisible by bn groups {g}")
        size = total // g
        gid = torch.div(torch.arange(offset, offset + b, device=x.device), size,
                        rounding_mode="floor")
        shape = (b,) + (1,) * (x.ndim - 2) + (c,)
        spatial = tuple(range(1, x.ndim - 1))
        n = size * (x.numel() // (b * c))
        xf = x.float()
        mean_g = _group_sums(xf.sum(spatial), gid, g) / n  # (G, C)
        d = xf - mean_g[gid].view(shape)
        var_g = _group_sums(d.square().sum(spatial), gid, g) / n
        y = (d * torch.rsqrt(var_g + self.eps)[gid].view(shape)) * self.weight + self.bias
        with torch.no_grad():
            mean = mean_g.mean(0)
            self._update(mean, var_g.mean(0) + (mean_g - mean).square().mean(0))
        return y.to(x.dtype)


REMAT_POLICIES = ("nothing", "dots")


def remat_policy(name: str) -> str:
    """hvt's ``REMAT_POLICIES`` names. Both recompute the whole block here:
    hvt's "dots" saves only ``dot_general`` outputs, and the blocks that use
    it (ResNet's) hold convolutions, which are not ``dot_general``, so it
    saves nothing either (hvt/models/resnet.py:52-57)."""
    if name not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {name!r}: one of {REMAT_POLICIES}")
    return name


def recompute(block: nn.Module, x: torch.Tensor, generator: torch.Generator | None = None):
    """``block(x, generator)`` under ``torch.utils.checkpoint`` (non-reentrant):
    the backward runs the block's forward again instead of keeping its
    activations, and with it each kernel's forward. The recomputation starts
    ``generator`` from its state at the forward, so it draws the same
    drop-path masks (checkpoint's own RNG handling covers only torch's
    default generators), and puts the generator back after; the block's
    BatchNorms skip their running-statistics update in it, so they update
    once a step, as under flax's ``nn.remat``."""
    norms = [m for m in block.modules() if isinstance(m, _BatchNormBase)]
    state = generator.get_state() if generator is not None else None

    @contextlib.contextmanager
    def recomputing():
        current = generator.get_state() if generator is not None else None
        if generator is not None:
            generator.set_state(state)
        for m in norms:
            m.recomputing = True
        try:
            yield
        finally:
            for m in norms:
                m.recomputing = False
            if generator is not None:
                generator.set_state(current)

    return torch.utils.checkpoint.checkpoint(
        block, x, generator, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), recomputing()))
