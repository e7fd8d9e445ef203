"""The fused halves' gradients against hvt's, on the CPU.

Seeded numpy inputs in f32 go through hvt's ``mlp_half`` and
``attention_half_nhwc`` (their Pallas forward and backward kernels in
interpret mode, under ``jax.grad``) and through the port's autograd
Functions on CPU tensors, whose backward runs the plain versions
``mlp_half_backward_plain`` and ``attention_half_nhwc_backward_plain``.
Weights are drawn in flax's (in, out) layout and transposed for the port.

* Tolerance: max|Δ| ≤ 5e-3·max|ref| per gradient. Both sides round every
  product's operands to bf16 and sum in another order, so an operand can
  land on the other side of a bf16 rounding boundary: the JAX suite's own
  bound between two of its entries with the same bf16 contract and another
  summation order (tests/test_fused_halves.py:206-216).
* The attention half runs at shift 0 and at shift 3 (hvt on the rolled map,
  the port on the un-rolled one), with drop-path scales 0, 1/keep and 1.
* The logit scale's gradient is exactly 0 above the log 100 clamp.
* ``torch.autograd.gradcheck`` holds both plain backwards to finite
  differences in f64 (no bf16 rounding on f64) at tiny widths.
* No kernel launch counter moves on CPU tensors.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvt.ops import fused_halves_pallas as jfh
from hvt_torch.ops import fused_halves_cuda as fh
from hvt_torch.ops import window_attention as wa
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 5e-3
KEEP = 0.8
SCALES = np.asarray([0.0, 1.0 / KEEP, 1.0, 1.0 / KEEP], np.float32)  # dropped, kept, eval, kept


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _block_params(rng, c, heads, n):
    """One block's parameters in flax layouts, LN scales around 1, head 0's
    logit scale above the log 100 clamp."""
    ls = np.log(10.0) + rng.normal(size=(heads, 1, 1)) * 0.3
    ls[0] = 5.0
    p = {
        "wqkv": rng.normal(size=(c, 3 * c)) / math.sqrt(c),
        "bqkv": np.concatenate([rng.normal(size=c) * 0.1, np.zeros(c), rng.normal(size=c) * 0.1]),
        "ls": ls,
        "bias": 16.0 / (1.0 + np.exp(-rng.normal(size=(heads, n, n)))),
        "wproj": rng.normal(size=(c, c)) / math.sqrt(c),
        "bproj": rng.normal(size=c) * 0.1,
        "w1": rng.normal(size=(c, 4 * c)) / math.sqrt(c),
        "b1": rng.normal(size=4 * c) * 0.1,
        "w2": rng.normal(size=(4 * c, c)) / math.sqrt(4 * c),
        "b2": rng.normal(size=c) * 0.1,
        "lns": 1.0 + rng.normal(size=c) * 0.1,
        "lnb": rng.normal(size=c) * 0.1,
    }
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


def _launches():
    return [k.launches for k in (fh.MLP_KERNEL, fh.ATTN_KERNEL, fh.MLP_BWD_KERNEL,
                                 fh.ATTN_BWD_KERNEL)]


MLP_NAMES = ("x", "w1", "b1", "w2", "b2", "lns", "lnb")
MLP_TRANSPOSED = ("w1", "w2")  # flax (in, out) vs nn.Linear (out, in)


# C = 64 and the card's widths 96 (not a multiple of 64) and 128; the C = 64
# cases keep the ids they had before the widths were added.
@pytest.mark.parametrize("c,resid", [
    pytest.param(64, False, id="False"), pytest.param(64, True, id="True"),
    *(pytest.param(c, resid, id=f"{c}-{resid}") for c in (96, 128) for resid in (False, True)),
])
def test_mlp_half_gradients_match_pallas(c, resid):
    rng = np.random.default_rng(21)
    b, tpi = 4, 16
    p = _block_params(rng, c, 2, 16)
    p["x"] = rng.normal(size=(b * tpi, c)).astype(np.float32)
    gout = rng.normal(size=(b * tpi, c)).astype(np.float32)
    dp = jnp.broadcast_to(jnp.asarray(SCALES)[:, None, None], (b, 8, 128)) if resid else None

    def loss(*args):
        out = jfh.mlp_half(*args, True, tpi if resid else 0, dp=dp)
        return jnp.sum(out * jnp.asarray(gout))

    ref = jax.jit(jax.grad(loss, argnums=tuple(range(7))))(*(jnp.asarray(p[k]) for k in MLP_NAMES))
    ref = [np.asarray(r) for r in ref]
    before = _launches()
    leaves = [_t(p[k].T if k in MLP_TRANSPOSED else p[k]).requires_grad_() for k in MLP_NAMES]
    extra = dict(tpi=tpi, dp=_t(SCALES)) if resid else {}
    (fh.mlp_half(*leaves, **extra) * _t(gout)).sum().backward()
    assert _launches() == before  # a CPU tensor never reaches a kernel
    for name, leaf, r in zip(MLP_NAMES, leaves, ref):
        got = leaf.grad.numpy()
        _close(got.T if name in MLP_TRANSPOSED else got, r, TOL,
               f"mlp_half C={c} resid={resid} d{name}")


ATTN_NAMES = ("x", "wqkv", "bqkv", "ls", "bias", "wproj", "bproj", "lns", "lnb")
ATTN_TRANSPOSED = ("wqkv", "wproj")


@pytest.mark.parametrize("shift", [0, 3])
def test_attention_half_nhwc_gradients_match_pallas(shift):
    """hvt's kernel takes the pre-rolled map; the port takes the un-rolled
    one and ``shift``. The reference loss rolls hvt's output back, and dx
    is rolled back likewise."""
    rng = np.random.default_rng(23 + shift)
    b, grid, window, heads = 4, 14, 7, 2
    c, n = heads * 32, window * window
    p = _block_params(rng, c, heads, n)
    p["x"] = rng.normal(size=(b, grid, grid, c)).astype(np.float32)
    gout = rng.normal(size=(b, grid, grid, c)).astype(np.float32)
    mask = wa.shift_attn_mask((grid, grid), window, shift) if shift else None
    dp = jnp.broadcast_to(jnp.asarray(SCALES)[:, None, None], (b, 8, 128))
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(x, wq, bq, ls, bias, wp, bp, lns, lnb):
        out = jfh.attention_half_nhwc(x, wq, bq, ls, bias, jmask, wp, bp, lns, lnb, window,
                                      heads, True, dp=dp)
        return jnp.sum(jnp.roll(out, (shift, shift), (1, 2)) * jnp.asarray(gout))

    args = [jnp.asarray(np.roll(p["x"], (-shift, -shift), (1, 2)))]
    args += [jnp.asarray(p[k]) for k in ATTN_NAMES[1:]]
    ref = [np.asarray(r) for r in jax.jit(jax.grad(loss, argnums=tuple(range(9))))(*args)]
    ref[0] = np.roll(ref[0], (shift, shift), (1, 2))
    assert ref[3][0, 0, 0] == 0.0  # hvt: no gradient above the clamp

    before = _launches()
    leaves = [_t(p[k].T if k in ATTN_TRANSPOSED else p[k]).requires_grad_() for k in ATTN_NAMES]
    x, wq, bq, ls, bias, wp, bp, lns, lnb = leaves
    out = fh.attention_half_nhwc(x, wq, bq, ls, bias,
                                 None if mask is None else torch.from_numpy(mask), wp, bp, lns,
                                 lnb, window, heads, dp=_t(SCALES), shift=shift)
    (out * _t(gout)).sum().backward()
    assert _launches() == before
    assert ls.grad[0, 0, 0].item() == 0.0  # exactly 0 above the log 100 clamp
    for name, leaf, r in zip(ATTN_NAMES, leaves, ref):
        got = leaf.grad.numpy()
        _close(got.T if name in ATTN_TRANSPOSED else got, r, TOL,
               f"attention_half_nhwc shift={shift} d{name}")


def test_mlp_half_plain_backward_passes_gradcheck_in_f64():
    """C = 8, hidden 32, 4 images of 8 tokens, scales 0, 1/keep, 1, 1/keep,
    with and without the fused residual."""
    rng = np.random.default_rng(31)
    c, tpi = 8, 8
    leaves = [torch.tensor(rng.normal(size=(4 * tpi, c)), requires_grad=True)]
    for shape, std, mean in [((4 * c, c), 0.3, 0.0), ((4 * c,), 0.1, 0.0), ((c, 4 * c), 0.2, 0.0),
                             ((c,), 0.1, 0.0), ((c,), 0.1, 1.0), ((c,), 0.1, 0.0)]:
        leaves.append(torch.tensor(mean + std * rng.normal(size=shape), requires_grad=True))
    dp = torch.tensor(SCALES, dtype=torch.float64)
    assert fh.mlp_half(*leaves, tpi=tpi, dp=dp).dtype == torch.float64
    assert torch.autograd.gradcheck(lambda *a: fh.mlp_half(*a, tpi=tpi, dp=dp), leaves)
    assert torch.autograd.gradcheck(lambda *a: fh.mlp_half(*a), leaves)


@pytest.mark.parametrize("shift", [0, 1])
def test_attention_half_plain_backward_passes_gradcheck_in_f64(shift):
    """Window 2 (N = 4) on a 4 x 4 map, 2 heads of dim 3, head 1's logit
    scale above the clamp, scales 0 and 1/keep."""
    rng = np.random.default_rng(37 + shift)
    b, grid, window, heads = 2, 4, 2, 2
    c, n = heads * 3, window * window

    def leaf(shape, std=1.0, mean=0.0):
        return torch.tensor(mean + std * rng.normal(size=shape), requires_grad=True)

    leaves = [leaf((b, grid, grid, c)), leaf((3 * c, c), 0.4), leaf((3 * c,), 0.1),
              torch.tensor([[[0.7]], [[5.0]]], dtype=torch.float64, requires_grad=True),
              leaf((heads, n, n)), leaf((c, c), 0.4), leaf((c,), 0.1), leaf((c,), 0.1, 1.0),
              leaf((c,), 0.1)]
    mask = torch.as_tensor(wa.shift_attn_mask((grid, grid), window, shift)) if shift else None
    dp = torch.tensor(SCALES[:2], dtype=torch.float64)

    def fn(x, wq, bq, ls, bias, wp, bp, lns, lnb):
        return fh.attention_half_nhwc(x, wq, bq, ls, bias, mask, wp, bp, lns, lnb, window, heads,
                                      dp=dp, shift=shift)

    assert torch.autograd.gradcheck(fn, leaves)
