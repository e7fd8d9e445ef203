"""Training-mode BatchNorm over the row dim of a (rows, C) view — port of
``hvt/ops/bn_stats_pallas.py``.

* :func:`channel_sums` — per-channel (Σx, Σx²), f32;
* :func:`bn_bwd_reduce` — per-channel (Σg, Σg·x̂), x̂ = (x − mean)·rstd, f32;
* :func:`bn_train` — BatchNorm with flax's fast-variance semantics as a
  ``torch.autograd.Function``: the forward and backward of hvt's
  ``_bn_train_fwd``/``_bn_train_bwd`` (bn_stats_pallas.py:273-301), formula
  for formula, around the two reductions.

The reductions dispatch by device only: a CPU tensor takes the plain version
(``*_plain``), a CUDA tensor the kernel of :mod:`hvt_torch.ops.bn_stats_cuda`,
which raises on what it does not take. Accumulation is f32 (f64 for f64
inputs on the CPU). ``bn_train(..., torch_reductions=True)`` is hvt's
``use_pallas=False`` route (the model's ``bn_custom``): the same Function
with the two reductions in torch's ops on every device, chosen by the
caller, never taken on a kernel's failure.
"""

from __future__ import annotations

import torch

from hvt_torch.ops import bn_stats_cuda


def _acc(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def channel_sums_plain(x2d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σx, Σx²) over the rows, as hvt's ``_sums_jnp``."""
    xf = x2d.to(_acc(x2d))
    return xf.sum(0), (xf * xf).sum(0)


def bn_bwd_reduce_plain(g2d, x2d, mean, rstd) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σg, Σg·(x − mean)·rstd) over the rows, as hvt's ``_bwd_reduce_jnp``."""
    acc = _acc(x2d)
    gf = g2d.to(acc)
    xh = (x2d.to(acc) - mean) * rstd
    return gf.sum(0), (gf * xh).sum(0)


def _device(name: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


def channel_sums(x2d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (Σx, Σx²) of a (rows, C) tensor: the kernel on a CUDA
    tensor, the plain version on a CPU one."""
    if _device("channel_sums", x2d) == "cpu":
        return channel_sums_plain(x2d)
    return bn_stats_cuda.channel_sums(x2d)


def bn_bwd_reduce(g2d, x2d, mean, rstd) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (Σg, Σg·(x − mean)·rstd) over the rows of (rows, C)
    tensors: the kernel on CUDA tensors, the plain version on CPU ones."""
    if _device("bn_bwd_reduce", x2d) == "cpu":
        return bn_bwd_reduce_plain(g2d, x2d, mean, rstd)
    return bn_stats_cuda.bn_bwd_reduce(g2d, x2d, mean, rstd)


class _BnTrain(torch.autograd.Function):
    """hvt's ``bn_train`` custom VJP. Saves only x (in its dtype), mean, rstd
    and scale; the backward recomputes x̂. The f32 temporaries are updated in
    place, which keeps each one a single allocation."""

    @staticmethod
    def forward(ctx, x2d, scale, bias, eps, out_dtype, torch_reductions):
        n = x2d.shape[0]
        s, q = (channel_sums_plain if torch_reductions else channel_sums)(x2d)
        mean = s / n
        var = torch.clamp_min(q / n - mean * mean, 0.0)
        rstd = torch.rsqrt(var + eps)
        acc = mean.dtype
        y = (x2d - mean).mul_(rstd).mul_(scale.to(acc)).add_(bias.to(acc)).to(out_dtype)
        ctx.save_for_backward(x2d, mean, rstd, scale)
        ctx.torch_reductions = torch_reductions
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x2d, mean, rstd, scale = ctx.saved_tensors
        n = x2d.shape[0]
        acc = mean.dtype
        if dy is None:  # only the mean or var output is differentiated
            dy = torch.zeros(x2d.shape, dtype=x2d.dtype, device=x2d.device)
        reduce = bn_bwd_reduce_plain if ctx.torch_reductions else bn_bwd_reduce
        sg, sgx = reduce(dy, x2d, mean, rstd)
        xh = (x2d - mean).mul_(rstd)
        # dx = scale·rstd·(g − Σg/n − x̂·Σgx̂/n)
        dx = torch.sub(dy, sg / n).sub_(xh.mul_(sgx / n)).mul_(scale.to(acc) * rstd)
        # exact contributions of the mean and var outputs (None in training,
        # where they only feed the running statistics)
        if dmean is not None:
            dx.add_(dmean / n)
        if dvar is not None:
            dx.add_((x2d - mean).mul_(dvar * (2.0 / n)))
        return dx.to(x2d.dtype), sgx.to(scale.dtype), sg.to(scale.dtype), None, None, None


def bn_train(x2d: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
             out_dtype: torch.dtype, torch_reductions: bool = False
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training BatchNorm over the rows of ``x2d`` (rows, C): returns
    (y in ``out_dtype``, mean, var), mean and var the f32 biased batch moments
    for the running statistics, var = max(E[x²] − E[x]², 0) (flax's fast
    variance). Differentiable in x2d, scale and bias. ``torch_reductions``
    (hvt's ``use_pallas=False``) computes the two reductions with torch's
    ops on any device instead of :func:`channel_sums` and
    :func:`bn_bwd_reduce`."""
    return _BnTrain.apply(x2d, scale, bias, eps, out_dtype, torch_reductions)
