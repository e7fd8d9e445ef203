"""The windowed attention half against hvt's, on the CPU.

hvt's ``attention_half`` (the Pallas ``_attn_forward``/``_attn_backward``
kernels in interpret mode, under ``jax.grad``) and the port's
``attention_half`` (its autograd Function on CPU tensors, whose forward and
backward run the plain versions ``attention_half_plain`` and
``attention_half_backward_plain``) take the same seeded numpy inputs: window
tokens partitioned from a rolled map of 2 images, C = 64, 2 heads, windows 4
and 7 (N = 16 and 49; hvt pads 49 to 56, the port does not), shift 0 and 2
(with the shift mask), in f32 and in bf16. Weights are drawn in flax's
(in, out) layout and transposed for the port.

* Tolerance: max|Δ| ≤ 5e-3·max|ref| per output and gradient in f32 (the
  bound tests/test_torch_port_fused_train.py holds the NHWC half to: both
  sides round every product's operands to bf16 and sum in another order).
  In bf16 the branch and dx are also rounded to bf16 at the store, one ulp
  of which is 3.9e-3 relative: 1e-2.
* The logit scale's gradient is exactly 0 above the log 100 clamp.
* No kernel launch counter moves on CPU tensors.
* ``torch.autograd.gradcheck`` holds the plain backward to finite
  differences in f64 (no bf16 rounding on f64).
* The port's copy of ``mlp_resid_images_per_block`` gives hvt's answers on
  a grid of shapes that includes SwinV2's 196- and 49-token stages.
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

TOL = {"float32": 5e-3, "bfloat16": 1e-2}
NAMES = ("x", "wqkv", "bqkv", "ls", "bias", "wproj", "bproj", "lns", "lnb")
TRANSPOSED = ("wqkv", "wproj")  # flax (in, out) vs nn.Linear (out, in)


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


def _inputs(rng, c, heads, window, shift, images=2):
    """Window tokens of ``images`` maps of 2 x 2 windows, partitioned from the
    map rolled by -shift as the model does, and one block's parameters in
    flax layouts (LN scales around 1; head 0's logit scale above the clamp)."""
    grid, n = 2 * window, window * window
    ls = np.log(10.0) + rng.normal(size=(heads, 1, 1)) * 0.3
    ls[0] = 5.0
    x = np.roll(rng.normal(size=(images, grid, grid, c)), (-shift, -shift), (1, 2))
    p = {
        "x": wa.window_partition(torch.from_numpy(x), window).numpy(),
        "wqkv": rng.normal(size=(c, 3 * c)) / math.sqrt(c),
        "bqkv": np.concatenate([rng.normal(size=c) * 0.1, np.zeros(c), rng.normal(size=c) * 0.1]),
        "ls": ls,
        "bias": 16.0 / (1.0 + np.exp(-rng.normal(size=(heads, n, n)))),
        "wproj": rng.normal(size=(c, c)) / math.sqrt(c),
        "bproj": rng.normal(size=c) * 0.1,
        "lns": 1.0 + rng.normal(size=c) * 0.1,
        "lnb": rng.normal(size=c) * 0.1,
    }
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    mask = wa.shift_attn_mask((grid, grid), window, shift) if shift else None
    return p, mask


def _launches():
    return [k.launches for k in (fh.ATTN_WIN_KERNEL, fh.ATTN_WIN_BWD_KERNEL, fh.ATTN_KERNEL,
                                 fh.ATTN_BWD_KERNEL)]


@pytest.mark.parametrize("window,shift,dtype", [
    (4, 0, "float32"), (7, 2, "float32"), (4, 2, "bfloat16"), (7, 0, "bfloat16"),
])
def test_attention_half_matches_pallas_forward_and_gradients(window, shift, dtype):
    rng = np.random.default_rng(41 + window + shift)
    heads, c = 2, 64
    p, mask = _inputs(rng, c, heads, window, shift)
    gout = rng.normal(size=p["x"].shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jmask = None if mask is None else jnp.asarray(mask)

    def fwd(x, wq, bq, ls, bias, wp, bp, lns, lnb):
        return jfh.attention_half(x, wq, bq, ls, bias, jmask, wp, bp, lns, lnb, heads, True)

    def loss(*args):
        return jnp.sum(fwd(*args).astype(jnp.float32) * jnp.asarray(gout))

    args = [jnp.asarray(p["x"]).astype(jdt)] + [jnp.asarray(p[k]) for k in NAMES[1:]]
    ref_out = np.asarray(fwd(*args).astype(jnp.float32))
    grad = jax.jit(jax.grad(loss, argnums=tuple(range(9))))
    ref = [np.asarray(r, np.float32) for r in grad(*args)]
    assert ref[3][0, 0, 0] == 0.0  # hvt: no gradient above the clamp

    before = _launches()
    leaves = [torch.from_numpy(np.ascontiguousarray(p[k].T if k in TRANSPOSED else p[k]))
              for k in NAMES]
    leaves[0] = leaves[0].to(tdt)
    leaves = [t.requires_grad_() for t in leaves]
    x, wq, bq, ls, bias, wp, bp, lns, lnb = leaves
    out = fh.attention_half(x, wq, bq, ls, bias, None if mask is None else torch.from_numpy(mask),
                            wp, bp, lns, lnb, heads)
    assert out.dtype == tdt and out.shape == x.shape
    (out.float() * torch.from_numpy(gout)).sum().backward()
    assert _launches() == before  # a CPU tensor never reaches a kernel
    assert x.grad.dtype == tdt and ls.grad[0, 0, 0].item() == 0.0  # exactly 0 above the clamp
    tol = TOL[dtype]
    _close(out.detach().float(), ref_out, tol, f"window {window} shift {shift} {dtype} branch")
    for name, leaf, r in zip(NAMES, leaves, ref):
        got = leaf.grad.float().numpy()
        _close(got.T if name in TRANSPOSED else got, r, tol,
               f"window {window} shift {shift} {dtype} d{name}")


@pytest.mark.parametrize("shift", [0, 1])
def test_attention_half_plain_backward_passes_gradcheck_in_f64(shift):
    """Windows of 4 tokens (window 2 on a 4 x 4 map, 2 images), 2 heads of
    dim 3, head 1's logit scale above the clamp; the shift mask at shift 1."""
    rng = np.random.default_rng(47 + shift)
    images, grid, window, heads = 2, 4, 2, 2
    c, n = heads * 3, window * window

    def leaf(shape, std=1.0, mean=0.0):
        return torch.tensor(mean + std * rng.normal(size=shape), requires_grad=True)

    nwb = images * (grid // window) ** 2
    leaves = [leaf((nwb, n, c)), leaf((3 * c, c), 0.4), leaf((3 * c,), 0.1),
              torch.tensor([[[0.7]], [[5.0]]], dtype=torch.float64, requires_grad=True),
              leaf((heads, n, n)), leaf((c, c), 0.4), leaf((c,), 0.1), leaf((c,), 0.1, 1.0),
              leaf((c,), 0.1)]
    mask = torch.as_tensor(wa.shift_attn_mask((grid, grid), window, shift)) if shift else None

    def fn(x, wq, bq, ls, bias, wp, bp, lns, lnb):
        return fh.attention_half(x, wq, bq, ls, bias, mask, wp, bp, lns, lnb, heads)

    assert fn(*leaves).dtype == torch.float64
    assert torch.autograd.gradcheck(fn, leaves)


def test_attention_half_matches_the_nhwc_half_on_the_same_windows():
    """The two plain versions share hvt's body: the windowed half on windows
    partitioned from the rolled map, reversed and un-rolled, is the NHWC
    half's branch to the bit."""
    rng = np.random.default_rng(53)
    p, mask = _inputs(rng, 64, 2, 7, 3)
    x = torch.from_numpy(rng.normal(size=(2, 14, 14, 64)).astype(np.float32)).bfloat16()
    args = [torch.from_numpy(np.ascontiguousarray(p[k].T if k in TRANSPOSED else p[k]))
            for k in NAMES[1:5]]
    tail = [torch.from_numpy(np.ascontiguousarray(p[k].T if k in TRANSPOSED else p[k]))
            for k in NAMES[5:]]
    m = torch.from_numpy(mask)
    nhwc = fh.attention_half_nhwc_plain(x, *args, m, *tail, 7, 2, shift=3)
    xw = wa.window_partition(torch.roll(x, (-3, -3), (1, 2)), 7)
    windows = fh.attention_half_plain(xw, *args, m, *tail, 2)
    torch.testing.assert_close(torch.roll(wa.window_reverse(windows, 7, 14, 14), (3, 3), (1, 2)),
                               nhwc, rtol=0, atol=0)


def test_mlp_resid_images_per_block_matches_hvt():
    cases = [(b * tpi, tpi, c, 4 * c) for b in (1, 2, 6, 64, 128) for tpi in (49, 196, 784, 3136, 64, 8)
             for c in (96, 128, 192, 384, 768, 1024)]
    cases += [(100, 0, 96, 384), (98, 49, 96, 384), (3136 * 3, 3136, 96, 256)]
    for t, tpi, c, hidden in cases:
        assert fh.mlp_resid_images_per_block(t, tpi, c, hidden) == \
            jfh.mlp_resid_images_per_block(t, tpi, c, hidden), (t, tpi, c, hidden)
    # SwinV2-T at 224 px, batch 128: stages 1-2 fuse the MLP residual, 3-4 do not
    assert [fh.mlp_resid_images_per_block(128 * g * g, g * g, c, 4 * c) > 0
            for g, c in ((56, 96), (28, 192), (14, 384), (7, 768))] == [True, True, False, False]
