"""The port's training ops against hvt's, on the CPU.

* ``window_attention_packed``'s gradients (dqkv, dlogit_scale, dbias): the
  port's ``torch.autograd.Function`` on CPU tensors runs the plain backward
  ``packed_heads_backward``; hvt's ``jax.grad`` goes through the Pallas
  backward ``_packed_backward`` in interpret mode. Both f32; tolerance
  max|Δ| ≤ 2e-4·max|ref| per gradient, the JAX suite's own bound for this
  kernel's gradients (tests/test_pallas_kernel.py).
* The logit scale's gradient is exactly 0 above the log 100 clamp.
* ``torch.autograd.gradcheck`` of the plain backward in f64 against finite
  differences (gradcheck's default tolerances: atol 1e-5, rtol 1e-3).
* ``drop_path``: mask shape, scaling, and the kept share within 3σ of
  1 − rate (JAX's PRNG gives other draws, so no draw is compared).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvt.ops import window_attention_pallas as jwap
from hvt_torch.models.common import drop_path
from hvt_torch.ops import window_attention as wa
from hvt_torch.ops import window_attention_cuda as wac
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (windows, heads, tokens, head dim, window ids): unshifted, stage-1-like
# shifted (one image of 64 windows), and 4 window ids over 4 images
SHAPES = [(8, 3, 49, 32, 1), (64, 3, 49, 32, 64), (16, 6, 49, 32, 4)]


def _inputs(nwb, heads, n, d, nwz, seed):
    rng = np.random.default_rng(seed)
    c = heads * d
    qkv = rng.normal(size=(nwb, n, 3 * c)).astype(np.float32)
    ls = (np.log(10.0) + 0.3 * rng.normal(size=(heads, 1, 1))).astype(np.float32)
    ls[0] = 5.0  # above the log(100) clamp: no gradient
    bias = (16.0 / (1.0 + np.exp(-rng.normal(size=(heads, n, n))))).astype(np.float32)
    mask = None
    if nwz > 1:
        window = int(round(n ** 0.5))
        grid = window * int(round(nwz ** 0.5))
        mask = wa.shift_attn_mask((grid, grid), window, window // 2)
        assert mask.shape[0] == nwz
    dout = rng.normal(size=(nwb, n, c)).astype(np.float32)
    return qkv, ls, bias, mask, dout


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


def _port_grads(qkv, ls, bias, mask, dout, heads):
    leaves = [torch.tensor(a, requires_grad=True) for a in (qkv, ls, bias)]
    out = wac.window_attention_packed(*leaves, None if mask is None else torch.from_numpy(mask),
                                      num_heads=heads)
    (out * torch.from_numpy(dout)).sum().backward()
    return [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("nwb,heads,n,d,nwz", SHAPES)
def test_packed_attention_gradients_match_pallas(nwb, heads, n, d, nwz):
    qkv, ls, bias, mask, dout = _inputs(nwb, heads, n, d, nwz, seed=nwb + heads)
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(q, s, b):
        out = jwap.window_attention_packed(q, s, b, jmask, num_heads=heads, interpret=True)
        return jnp.sum(out * jnp.asarray(dout))

    grad = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))
    ref = grad(jnp.asarray(qkv), jnp.asarray(ls), jnp.asarray(bias))
    ref = [np.asarray(r) for r in ref]  # to numpy before torch runs its backward
    before = wac.BWD_KERNEL.launches
    got = _port_grads(qkv, ls, bias, mask, dout, heads)
    assert wac.BWD_KERNEL.launches == before  # a CPU tensor never reaches the kernel
    for name, g, r in zip(("dqkv", "dlogit_scale", "dbias"), got, ref):
        _close(g, r, 2e-4, f"{name} at {(nwb, heads, n, d, nwz)}")


def test_logit_scale_gradient_is_zero_above_the_clamp():
    qkv, ls, bias, mask, dout = _inputs(8, 3, 49, 32, 1, seed=3)
    ls[1] = np.log(100.0) + 1e-3
    ls[2] = np.log(100.0) - 0.5
    _, dls, _ = _port_grads(qkv, ls, bias, mask, dout, 3)
    assert dls[0, 0, 0] == 0.0 and dls[1, 0, 0] == 0.0
    assert dls[2, 0, 0] != 0.0


def test_plain_backward_passes_gradcheck_in_f64():
    """Window 2 (N = 4), head dim 3, two window ids, one head above the clamp."""
    rng = np.random.default_rng(9)
    nwb, heads, n, d = 4, 2, 4, 3
    qkv = torch.tensor(rng.normal(size=(nwb, n, 3 * heads * d)), requires_grad=True)
    ls = torch.tensor([[[0.7]], [[5.0]]], dtype=torch.float64, requires_grad=True)
    bias = torch.tensor(rng.normal(size=(heads, n, n)), requires_grad=True)
    mask = torch.tensor(np.where(rng.random((2, n, n)) < 0.3, -3.0, 0.0))

    def fn(q, s, b):
        return wac.window_attention_packed(q, s, b, mask, num_heads=heads)

    assert fn(qkv, ls, bias).dtype == torch.float64
    assert torch.autograd.gradcheck(fn, (qkv, ls, bias))


def test_drop_path_masks_whole_samples_and_rescales():
    x = torch.ones(20_000, 3, 2, 4)
    rate = 0.3
    gen = torch.Generator().manual_seed(0)
    y = drop_path(x, rate, True, gen)
    per_sample = y.reshape(len(x), -1)
    assert (per_sample == per_sample[:, :1]).all()  # the mask is (B, 1, 1, 1)
    assert torch.unique(per_sample).tolist() == [0.0, pytest.approx(1.0 / (1.0 - rate))]
    kept = float((per_sample[:, 0] > 0).double().mean())
    sigma = np.sqrt(rate * (1.0 - rate) / len(x))
    assert abs(kept - (1.0 - rate)) < 3 * sigma
    assert float(y.mean()) == pytest.approx(1.0, abs=3 * sigma / (1.0 - rate))
    again = drop_path(x, rate, True, torch.Generator().manual_seed(0))
    assert torch.equal(y, again)  # seeded
    assert drop_path(x, rate, False, gen) is x and drop_path(x, 0.0, True, gen) is x
