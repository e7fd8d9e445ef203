"""Window attention on split q, k, v against hvt's, on the CPU.

hvt's ``window_attention_pallas.window_attention_kernel`` (the Pallas
``_forward``/``_backward`` kernels in interpret mode, under ``jax.grad``)
and the port's ``window_attention_split`` (its autograd Function on CPU
tensors, whose forward and backward run the plain versions
``split_heads_forward`` and ``split_heads_backward``, the versions the
kernels are held to on the card) take the same seeded numpy q, k, v
(nWB, H, N, D): 8 windows (2 images of 4), 2 heads of dim 32, N = 16 and 49,
with and without the shift mask, in f32 and in bf16.

* f32: max|Δ| ≤ 1e-4·max|ref| for the output and every gradient: the same
  f32 arithmetic in another summation order.
* bf16: the output and dq, dk, dv are rounded to bf16 at the store on both
  sides: 1e-2·max|ref| (one bf16 ulp is 3.9e-3 relative); dbias and
  dlogit_scale are f32 sums: 1e-4.
* P rounding: hvt rounds P to v's dtype before P·v. With q and k in f32 and
  v in bf16 the output is f32, so the rounding shows at f32 precision: the
  port is held to 1e-4·max|ref| there, and the same product with P kept in
  f32 misses that bound (the test checks both), so a port that skipped
  the rounding would fail.
* The logit scale's gradient is exactly 0 above the log 100 clamp.
* ``window_attention`` on CPU tensors, or with ``use_pallas=False``, is
  hvt's reference (``window_attention_reference``), as hvt dispatches off
  the TPU: held to hvt's reference at 1e-5 (f32) and its gradients too.
* ``torch.autograd.gradcheck`` holds the plain backward to finite
  differences in f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvt.ops import window_attention as jwa
from hvt.ops import window_attention_pallas as jwap
from hvt_torch.ops import window_attention as wa
from hvt_torch.ops import window_attention_cuda as wac
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HEADS, D, IMAGES = 2, 32, 2


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


def _inputs(seed, window, shift):
    """q, k, v (8, 2, N, 32), logit scale (head 0 above the clamp), bias and
    the shift mask of a 2 x 2-window map, all f32 numpy."""
    rng = np.random.default_rng(seed)
    n, nwb = window * window, IMAGES * 4
    qkv = [rng.normal(size=(nwb, HEADS, n, D)).astype(np.float32) for _ in range(3)]
    ls = (np.log(10.0) + rng.normal(size=(HEADS, 1, 1)) * 0.3).astype(np.float32)
    ls[0] = 5.0
    bias = (16.0 / (1.0 + np.exp(-rng.normal(size=(HEADS, n, n))))).astype(np.float32)
    mask = wa.shift_attn_mask((2 * window, 2 * window), window, shift) if shift else None
    gout = rng.normal(size=(nwb, HEADS, n, D)).astype(np.float32)
    return qkv, ls, bias, mask, gout


def _hvt(qkv, ls, bias, mask, gout, dtypes):
    jmask = None if mask is None else jnp.asarray(mask)

    def fwd(q, k, v, ls_, b_):
        return jwap.window_attention_kernel(q, k, v, ls_, b_, jmask, interpret=True)

    def loss(*args):
        return jnp.sum(fwd(*args).astype(jnp.float32) * jnp.asarray(gout))

    args = [jnp.asarray(a).astype(getattr(jnp, dt)) for a, dt in zip(qkv, dtypes)]
    args += [jnp.asarray(ls), jnp.asarray(bias)]
    out = fwd(*args)
    grads = jax.jit(jax.grad(loss, argnums=tuple(range(5))))(*args)
    return out, [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port(fn, qkv, ls, bias, mask, gout, dtypes):
    leaves = [torch.from_numpy(a).to(getattr(torch, dt)) for a, dt in zip(qkv, dtypes)]
    leaves += [torch.from_numpy(ls), torch.from_numpy(bias)]
    leaves = [t.requires_grad_() for t in leaves]
    out = fn(*leaves, None if mask is None else torch.from_numpy(mask))
    (out.float() * torch.from_numpy(gout)).sum().backward()
    return out.detach(), [t.grad for t in leaves]


def _launches():
    return wac.SPLIT_KERNEL.launches, wac.SPLIT_BWD_KERNEL.launches


@pytest.mark.parametrize("window,shift", [(4, 0), (7, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_attention_matches_pallas_forward_and_gradients(window, shift, dtype):
    qkv, ls, bias, mask, gout = _inputs(61 + window + shift, window, shift)
    ref_out, ref = _hvt(qkv, ls, bias, mask, gout, [dtype] * 3)
    before = _launches()
    out, got = _port(wac.window_attention_split, qkv, ls, bias, mask, gout, [dtype] * 3)
    assert _launches() == before  # a CPU tensor never reaches a kernel
    assert out.dtype == getattr(torch, dtype) and got[0].dtype == out.dtype
    assert got[3][0, 0, 0].item() == 0.0 and float(ref[3][0, 0, 0]) == 0.0
    tol = 1e-4 if dtype == "float32" else 1e-2
    what = f"window {window} shift {shift} {dtype}"
    _close(out.float(), np.asarray(ref_out.astype(jnp.float32)), tol, f"{what} out")
    for name, g, r, t in zip(("dq", "dk", "dv", "dlogit_scale", "dbias"), got, ref,
                             (tol, tol, tol, 1e-4, 1e-4)):
        _close(g.float(), r, t, f"{what} {name}")


def test_split_attention_rounds_p_to_v_dtype():
    """q and k in f32, v in bf16: hvt rounds P to bf16 before P·v and
    returns f32. The port's plain version agrees within 1e-4·max|ref|; the
    same product with P kept in f32 does not."""
    qkv, ls, bias, mask, gout = _inputs(71, 7, 3)
    dtypes = ["float32", "float32", "bfloat16"]
    ref_out, ref = _hvt(qkv, ls, bias, mask, gout, dtypes)
    ref_out = np.asarray(ref_out)
    out, got = _port(wac.window_attention_split, qkv, ls, bias, mask, gout, dtypes)
    assert out.dtype == torch.float32 and got[2].dtype == torch.bfloat16
    _close(out, ref_out, 1e-4, "out with P rounded")
    for name, g, r in zip(("dq", "dk", "dv", "dlogit_scale", "dbias"), got, ref):
        _close(g.float(), r, 1e-2 if name == "dv" else 1e-4, f"mixed dtypes {name}")
    q, k, v = (torch.from_numpy(a) for a in qkv)
    v = v.bfloat16().float()  # the same v, with P left in f32 before the product
    z = wac.merge_bias_mask(torch.from_numpy(bias), torch.from_numpy(mask))
    unrounded = wac.split_heads_forward(q, k, v, z, wac.attention_scale(torch.from_numpy(ls)))
    err = np.abs(unrounded.numpy() - ref_out).max()
    assert err > 1e-4 * np.abs(ref_out).max(), "the test cannot tell P's rounding apart"


@pytest.mark.parametrize("use_pallas", [True, False])
def test_window_attention_dispatches_to_the_reference_off_the_card(use_pallas):
    """``window_attention`` on CPU tensors runs hvt's reference with torch
    autograd, as hvt's dispatch does off the TPU: output and gradients
    against hvt's ``window_attention_reference`` under ``jax.grad``."""
    qkv, ls, bias, mask, gout = _inputs(83, 7, 3)
    jmask = jnp.asarray(mask)

    def loss(q, k, v, ls_, b_):
        out = jwa.window_attention_reference(q, k, v, ls_, b_, jmask)
        return jnp.sum(out * jnp.asarray(gout))

    args = [jnp.asarray(a) for a in qkv] + [jnp.asarray(ls), jnp.asarray(bias)]
    ref_out = np.asarray(jwa.window_attention_reference(*args, jmask))
    ref = jax.jit(jax.grad(loss, argnums=tuple(range(5))))(*args)
    before = _launches()
    out, got = _port(lambda *a: wa.window_attention(*a, use_pallas=use_pallas), qkv, ls, bias,
                     mask, gout, ["float32"] * 3)
    assert _launches() == before
    _close(out, ref_out, 1e-5, "reference out")
    for name, g, r in zip(("dq", "dk", "dv", "dlogit_scale", "dbias"), got, ref):
        _close(g, np.asarray(r), 1e-4, f"reference {name}")


@pytest.mark.parametrize("masked", [False, True])
def test_split_plain_backward_passes_gradcheck_in_f64(masked):
    """4 windows of 4 tokens (2 images of 2 windows), 2 heads of dim 3, head
    1's logit scale above the clamp."""
    rng = np.random.default_rng(89 + masked)

    def leaf(shape, std=1.0):
        return torch.tensor(std * rng.normal(size=shape), requires_grad=True)

    leaves = [leaf((4, 2, 4, 3)) for _ in range(3)]
    leaves += [torch.tensor([[[0.7]], [[5.0]]], dtype=torch.float64, requires_grad=True),
               leaf((2, 4, 4))]
    mask = torch.as_tensor(rng.normal(size=(2, 4, 4))) if masked else None
    fn = lambda *a: wac.window_attention_split(*a, mask)  # noqa: E731
    assert fn(*leaves).dtype == torch.float64
    assert torch.autograd.gradcheck(fn, leaves)
