"""Training-mode BatchNorm over the row dim of a (rows, C) view — port of
``hvt/ops/bn_stats_pallas.py``.

* :func:`channel_sums` — per-channel (Σx, Σx²), f32;
* :func:`bn_bwd_reduce` — per-channel (Σg, Σg·x̂), x̂ = (x − mean)·rstd, f32;
* :func:`bn_train` — BatchNorm with flax's fast-variance semantics as a
  ``torch.autograd.Function``: the forward and backward of hvt's
  ``_bn_train_fwd``/``_bn_train_bwd`` (bn_stats_pallas.py:273-301), formula
  for formula, in four steps: :func:`bn_moments` (the sums and their
  finish, mean, var and rstd), :func:`bn_normalize` (y), :func:`bn_bwd_terms`
  (the backward's sums and their finish, dbias, dscale and dx's per-channel
  factors) and :func:`bn_dx`.

Each step dispatches by device only: a CPU tensor takes the plain version
(``*_plain``), a CUDA tensor one kernel of :mod:`hvt_torch.ops.bn_stats_cuda`,
which raises on what it does not take; so ``bn_train`` on the card is four
launches. Accumulation is f32 (f64 for f64 inputs on the CPU).
``bn_train(..., torch_reductions=True)`` is hvt's ``use_pallas=False``
route (the model's ``bn_custom``): the same Function with the plain versions
on every device, chosen by the caller, never taken on a kernel's failure.
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


def bn_moments_plain(x2d: torch.Tensor, eps: float):
    """(mean, var, rstd) as ``_bn_train_fwd`` forms them from the sums:
    var = max(Σx²/n − mean², 0) (flax's fast variance)."""
    n = x2d.shape[0]
    s, q = channel_sums_plain(x2d)
    mean = s / n
    var = torch.clamp_min(q / n - mean * mean, 0.0)
    return mean, var, torch.rsqrt(var + eps)


def bn_normalize_plain(x2d, mean, rstd, scale, bias, out_dtype) -> torch.Tensor:
    """y = ((x − mean)·rstd)·scale + bias in the moments' dtype, rounded once
    to ``out_dtype``; the f32 temporary is updated in place (one allocation)."""
    acc = mean.dtype
    return (x2d - mean).mul_(rstd).mul_(scale.to(acc)).add_(bias.to(acc)).to(out_dtype)


def bn_bwd_terms_plain(g2d, x2d, mean, rstd, scale) -> tuple[torch.Tensor, ...]:
    """(Σg, Σg·x̂, scale·rstd, Σg/n, Σg·x̂/n): the backward's sums and the
    per-channel factors of ``_bn_train_bwd``'s dx (the kernel's five rows)."""
    n = x2d.shape[0]
    sg, sgx = bn_bwd_reduce_plain(g2d, x2d, mean, rstd)
    return sg, sgx, scale.to(mean.dtype) * rstd, sg / n, sgx / n


def _dx_acc(g2d, x2d, mean, rstd, terms) -> torch.Tensor:
    # dx = scale·rstd·(g − Σg/n − x̂·Σgx̂/n), in hvt's order, updated in place
    k, m1, m2 = terms[2], terms[3], terms[4]
    xh = (x2d - mean).mul_(rstd)
    return torch.sub(g2d, m1).sub_(xh.mul_(m2)).mul_(k)


def bn_dx_plain(g2d, x2d, mean, rstd, terms) -> torch.Tensor:
    """dx = k·((g − m1) − ((x − mean)·rstd)·m2) in the moments' dtype,
    rounded once to x's dtype; k, m1, m2 are ``terms``' last three (of
    bn_bwd_terms' five: a tuple or the kernel's (5, C) rows)."""
    return _dx_acc(g2d, x2d, mean, rstd, terms).to(x2d.dtype)


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


def bn_moments(x2d: torch.Tensor, eps: float):
    """(mean, var, rstd) of each channel: one launch on a CUDA tensor."""
    if _device("bn_moments", x2d) == "cpu":
        return bn_moments_plain(x2d, eps)
    return bn_stats_cuda.bn_moments(x2d, eps)


def bn_normalize(x2d, mean, rstd, scale, bias, out_dtype) -> torch.Tensor:
    """BatchNorm's y: one launch on a CUDA tensor."""
    if _device("bn_normalize", x2d) == "cpu":
        return bn_normalize_plain(x2d, mean, rstd, scale, bias, out_dtype)
    return bn_stats_cuda.bn_normalize(x2d, mean, rstd, scale.float(), bias.float(), out_dtype)


def bn_bwd_terms(g2d, x2d, mean, rstd, scale):
    """(Σg, Σg·x̂, scale·rstd, Σg/n, Σg·x̂/n): a tuple on CPU tensors, the
    kernel's (5, C) rows on CUDA ones (one call)."""
    if _device("bn_bwd_terms", x2d) == "cpu":
        return bn_bwd_terms_plain(g2d, x2d, mean, rstd, scale)
    return bn_stats_cuda.bn_bwd_terms(g2d, x2d, mean, rstd, scale.float())


def bn_dx(g2d, x2d, mean, rstd, terms) -> torch.Tensor:
    """BatchNorm's dx from :func:`bn_bwd_terms`' ``terms``: one launch on
    CUDA tensors."""
    if _device("bn_dx", x2d) == "cpu":
        return bn_dx_plain(g2d, x2d, mean, rstd, terms)
    return bn_stats_cuda.bn_dx(g2d, x2d, mean, rstd, terms)


class _BnTrain(torch.autograd.Function):
    """hvt's ``bn_train`` custom VJP. Saves only x (in its dtype), mean, rstd
    and scale; the backward recomputes x̂. Where the mean or var output
    carries a cotangent (never in training, where they only feed the running
    statistics), the backward adds its exact contribution to an f32 dx in
    torch's ops after the same reduction."""

    @staticmethod
    def forward(ctx, x2d, scale, bias, eps, out_dtype, torch_reductions):
        moments, normalize = ((bn_moments_plain, bn_normalize_plain) if torch_reductions
                              else (bn_moments, bn_normalize))
        mean, var, rstd = moments(x2d, eps)
        y = normalize(x2d, mean, rstd, scale, bias, out_dtype)
        ctx.save_for_backward(x2d, mean, rstd, scale)
        ctx.torch_reductions = torch_reductions
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x2d, mean, rstd, scale = ctx.saved_tensors
        n = x2d.shape[0]
        terms, dx_fn = ((bn_bwd_terms_plain, bn_dx_plain) if ctx.torch_reductions
                        else (bn_bwd_terms, bn_dx))
        if dy is None:  # only the mean or var output is differentiated
            dy = torch.zeros(x2d.shape, dtype=x2d.dtype, device=x2d.device)
        t = terms(dy, x2d, mean, rstd, scale)  # Σg, Σg·x̂ and dx's three factors
        sg, sgx = t[0], t[1]
        if dmean is None and dvar is None:
            dx = dx_fn(dy, x2d, mean, rstd, t)
        else:  # exact contributions of the mean and var outputs
            dxf = _dx_acc(dy, x2d, mean, rstd, t)
            if dmean is not None:
                dxf.add_(dmean / n)
            if dvar is not None:
                dxf.add_((x2d - mean).mul_(dvar * (2.0 / n)))
            dx = dxf.to(x2d.dtype)
        return dx, sgx.to(scale.dtype), sg.to(scale.dtype), None, None, None


def bn_train(x2d: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
             out_dtype: torch.dtype, torch_reductions: bool = False
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training BatchNorm over the rows of ``x2d`` (rows, C): returns
    (y in ``out_dtype``, mean, var), mean and var the f32 biased batch moments
    for the running statistics, var = max(E[x²] − E[x]², 0) (flax's fast
    variance). Differentiable in x2d, scale and bias. On a CUDA tensor it
    makes four launches (:func:`bn_moments`, :func:`bn_normalize`;
    :func:`bn_bwd_terms`, :func:`bn_dx`). ``torch_reductions`` (hvt's
    ``use_pallas=False``) takes the plain versions of all four on any
    device."""
    return _BnTrain.apply(x2d, scale, bias, eps, out_dtype, torch_reductions)
