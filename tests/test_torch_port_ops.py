"""The port's kernel modules against hvt's Pallas kernels, on the CPU.

Inputs come from seeded numpy generators and go through both sides:

* kernel 1, ``window_attention_packed``: hvt's Pallas kernel in interpret
  mode vs the port's wrapper on a CPU tensor (its plain version); both f32,
  so max|Δ| ≤ 1e-4·max|ref|;
* kernels 2 and 3, ``mlp_half`` and ``attention_half_nhwc``: hvt's Pallas
  kernels in interpret mode vs the port's plain versions. Both round matmul
  operands to bf16 (hvt's ``_dot``), so a product can land on the other side
  of a rounding boundary: max|Δ| ≤ 2e-2·max|ref|, the rule of
  tests/test_fused_halves.py;
* the helpers of ``hvt_torch.ops.window_attention`` against hvt's.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvt.ops import fused_halves_pallas as jfh
from hvt.ops import window_attention as jwa
from hvt.ops import window_attention_pallas as jwap
from hvt_torch.ops import fused_halves_cuda as fh
from hvt_torch.ops import window_attention as wa
from hvt_torch.ops import window_attention_cuda as wac
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _block_params(rng, c, heads, n):
    """Seeded parameters of one block in flax layouts: (in, out) kernels,
    LN scales around 1, logit scales around log 10."""
    return {
        "wqkv": rng.normal(size=(c, 3 * c)) / math.sqrt(c),
        "bqkv": np.concatenate([rng.normal(size=c) * 0.1, np.zeros(c), rng.normal(size=c) * 0.1]),
        "ls": np.log(10.0) + rng.normal(size=(heads, 1, 1)) * 0.3,
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


# ---------------------------------------------------------------------------
# hvt_torch.ops.window_attention helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window,pretrained", [(7, 0), (4, 0), (8, 6)])
def test_geometry_tables_match_hvt(window, pretrained):
    np.testing.assert_array_equal(wa.relative_coords_table(window, pretrained),
                                  jwa.relative_coords_table(window, pretrained))
    np.testing.assert_array_equal(wa.relative_position_index(window),
                                  jwa.relative_position_index(window))


@pytest.mark.parametrize("grid,window,shift", [(14, 7, 3), (8, 4, 2), (28, 7, 3)])
def test_shift_mask_and_partition_match_hvt(grid, window, shift):
    np.testing.assert_array_equal(wa.shift_attn_mask((grid, grid), window, shift),
                                  jwa.shift_attn_mask((grid, grid), window, shift))
    x = np.random.default_rng(grid).normal(size=(2, grid, grid, 5)).astype(np.float32)
    parts = wa.window_partition(_t(x), window)
    np.testing.assert_array_equal(parts.numpy(), np.asarray(jwa.window_partition(jnp.asarray(x), window)))
    np.testing.assert_array_equal(wa.window_reverse(parts, window, grid, grid).numpy(), x)


def test_cpb_bias_split_heads_and_oracle_match_hvt():
    rng = np.random.default_rng(0)
    window, heads, c = 7, 3, 96
    n = window * window
    w1, b1 = rng.normal(size=(2, 512)), rng.normal(size=512) * 0.1
    w2 = rng.normal(size=(512, heads)) / math.sqrt(512)
    coords = wa.relative_coords_table(window)
    index = wa.relative_position_index(window)
    ref = jwa.cpb_bias(jnp.asarray(w1, jnp.float32), jnp.asarray(b1, jnp.float32),
                       jnp.asarray(w2, jnp.float32), jnp.asarray(coords), jnp.asarray(index), heads)
    got = wa.cpb_bias(_t(w1.T), _t(b1), _t(w2.T), torch.from_numpy(coords),
                      torch.from_numpy(index), heads)
    _close(got, ref, 1e-5, "cpb_bias")

    qkv = rng.normal(size=(8, n, 3 * c)).astype(np.float32)
    jq, jk, jv = jwa.split_heads(jnp.asarray(qkv), heads)
    q, k, v = wa.split_heads(_t(qkv), heads)
    for a, b in ((q, jq), (k, jk), (v, jv)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ls = np.log(10.0) + rng.normal(size=(heads, 1, 1)) * 0.3
    mask = wa.shift_attn_mask((14, 14), window, 3)  # 4 windows, 2 images
    ref = jwa.window_attention_reference(jq, jk, jv, jnp.asarray(ls, jnp.float32), ref,
                                         jnp.asarray(mask))
    got = wa.window_attention_reference(q, k, v, _t(ls), got, torch.from_numpy(mask))
    _close(got, ref, 1e-4, "window_attention_reference")


def test_plain_math_helpers_match_hvt():
    x = np.random.default_rng(1).normal(size=(64, 96)).astype(np.float32) * 3
    np.testing.assert_allclose(fh.erf_as(_t(x)).numpy(), np.asarray(jfh._erf(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(fh.gelu_as(_t(x)).numpy(), np.asarray(jfh._gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    s, b = np.linspace(0.5, 1.5, 96, dtype=np.float32), np.linspace(-1, 1, 96, dtype=np.float32)
    ref, _, _ = jfh._ln_fwd(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    _close(fh.layer_norm(_t(x), _t(s), _t(b)), ref, 1e-5, "layer_norm")
    w = np.random.default_rng(2).normal(size=(96, 32)).astype(np.float32)
    _close(fh.bf16_linear(_t(x), _t(w.T), torch.zeros(32)),
           jfh._dot(jnp.asarray(x), jnp.asarray(w)), 1e-6, "bf16_linear")


# ---------------------------------------------------------------------------
# Kernel 1: window_attention_packed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window,grid,shift", [(7, 14, 0), (7, 14, 3), (4, 8, 2)])
def test_window_attention_packed_matches_pallas(window, grid, shift):
    """N = 49 (head dim 32) unshifted and shifted, and N = 16."""
    rng = np.random.default_rng(window * 10 + shift)
    b, heads, d = 2, 2, 32
    c, n = heads * d, window * window
    nwb = b * (grid // window) ** 2
    qkv = rng.normal(size=(nwb, n, 3 * c)).astype(np.float32)
    ls = (np.log(10.0) + rng.normal(size=(heads, 1, 1)) * 0.3).astype(np.float32)
    ls[0] = 5.0  # above the log(100) clamp
    bias = (16.0 / (1.0 + np.exp(-rng.normal(size=(heads, n, n))))).astype(np.float32)
    mask = wa.shift_attn_mask((grid, grid), window, shift) if shift else None
    ref = jwap.window_attention_packed(
        jnp.asarray(qkv), jnp.asarray(ls), jnp.asarray(bias),
        None if mask is None else jnp.asarray(mask), num_heads=heads, interpret=True)
    before = wac.KERNEL.launches
    got = wac.window_attention_packed(_t(qkv), _t(ls), _t(bias),
                                      None if mask is None else torch.from_numpy(mask),
                                      num_heads=heads)
    assert wac.KERNEL.launches == before  # a CPU tensor never reaches the kernel
    assert got.dtype == torch.float32
    _close(got, ref, 1e-4, f"packed attention N={n} shift={shift}")


# ---------------------------------------------------------------------------
# Kernels 2 and 3: the fused block halves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("resid", [False, True])
def test_mlp_half_matches_pallas(resid):
    rng = np.random.default_rng(5)
    b, tpi, c = 4, 16, 64
    p = _block_params(rng, c, 2, 16)
    x = rng.normal(size=(b * tpi, c)).astype(np.float32)
    s = np.asarray([0.0, 1.25, 1.25, 1.0], np.float32)  # dropped, kept at 1/keep, eval
    jargs = [jnp.asarray(p[k], jnp.float32) for k in ("w1", "b1", "w2", "b2", "lns", "lnb")]
    targs = [_t(p["w1"].T), _t(p["b1"]), _t(p["w2"].T), _t(p["b2"]), _t(p["lns"]), _t(p["lnb"])]
    before = fh.MLP_KERNEL.launches
    if resid:
        dp = jnp.broadcast_to(jnp.asarray(s)[:, None, None], (b, 8, 128))
        ref = jfh.mlp_half(jnp.asarray(x), *jargs, True, tpi, dp=dp)
        got = fh.mlp_half(_t(x), *targs, tpi=tpi, dp=_t(s))
    else:
        ref = jfh.mlp_half(jnp.asarray(x), *jargs, True)
        got = fh.mlp_half(_t(x), *targs)
    assert fh.MLP_KERNEL.launches == before
    _close(got, ref, 2e-2, f"mlp_half resid={resid}")


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("resid", [False, True])
def test_attention_half_nhwc_matches_pallas(shift, resid):
    """hvt's kernel reads the pre-rolled map and returns in rolled
    coordinates; the port takes the un-rolled map and ``shift`` and folds
    both rolls into its gather, so the references are rolled around hvt."""
    rng = np.random.default_rng(7 + shift)
    b, grid, window, heads = 4, 14, 7, 2
    c, n = heads * 32, window * window
    p = _block_params(rng, c, heads, n)
    x = rng.normal(size=(b, grid, grid, c)).astype(np.float32)
    s = np.asarray([0.0, 1.25, 1.25, 1.0], np.float32)
    mask = wa.shift_attn_mask((grid, grid), window, shift) if shift else None
    rolled = np.roll(x, (-shift, -shift), (1, 2))
    jargs = [jnp.asarray(p[k], jnp.float32) for k in ("wqkv", "bqkv", "ls", "bias")]
    jargs += [None if mask is None else jnp.asarray(mask)]
    jargs += [jnp.asarray(p[k], jnp.float32) for k in ("wproj", "bproj", "lns", "lnb")]
    dp = jnp.broadcast_to(jnp.asarray(s)[:, None, None], (b, 8, 128)) if resid else None
    ref = jfh.attention_half_nhwc(jnp.asarray(rolled), *jargs, window, heads, True, dp=dp)
    ref = np.roll(np.asarray(ref), (shift, shift), (1, 2))
    before = fh.ATTN_KERNEL.launches
    got = fh.attention_half_nhwc(
        _t(x), _t(p["wqkv"].T), _t(p["bqkv"]), _t(p["ls"]), _t(p["bias"]),
        None if mask is None else torch.from_numpy(mask), _t(p["wproj"].T), _t(p["bproj"]),
        _t(p["lns"]), _t(p["lnb"]), window, heads, dp=_t(s) if resid else None, shift=shift)
    assert fh.ATTN_KERNEL.launches == before
    _close(got, ref, 2e-2, f"attention_half_nhwc shift={shift} resid={resid}")


def test_attention_half_shift_equals_pre_rolled_input():
    """``shift`` is exactly roll(-shift) → kernel → roll(+shift)."""
    rng = np.random.default_rng(11)
    b, grid, window, heads, shift = 2, 14, 7, 3, 3
    c, n = heads * 32, window * window
    p = _block_params(rng, c, heads, n)
    x = _t(rng.normal(size=(b, grid, grid, c)))
    mask = torch.from_numpy(wa.shift_attn_mask((grid, grid), window, shift))
    args = (_t(p["wqkv"].T), _t(p["bqkv"]), _t(p["ls"]), _t(p["bias"]), mask,
            _t(p["wproj"].T), _t(p["bproj"]), _t(p["lns"]), _t(p["lnb"]), window, heads)
    dp = torch.ones(b)
    folded = fh.attention_half_nhwc(x, *args, dp=dp, shift=shift)
    rolled = fh.attention_half_nhwc(torch.roll(x, (-shift, -shift), (1, 2)), *args, dp=dp)
    torch.testing.assert_close(folded, torch.roll(rolled, (shift, shift), (1, 2)), rtol=0, atol=0)


def test_wrappers_refuse_devices_without_a_kernel():
    """A tensor that is neither on the CPU nor on a CUDA card raises; it is
    never routed to the plain version."""
    meta = torch.empty((8, 49, 3 * 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wac.window_attention_packed(meta, torch.zeros(2, 1, 1), torch.zeros(2, 49, 49), num_heads=2)
    with pytest.raises(ValueError, match="unsupported device"):
        fh.mlp_half(torch.empty((49, 96), device="meta"), *[None] * 6)
    with pytest.raises(ValueError, match="unsupported device"):
        fh.attention_half_nhwc(torch.empty((1, 7, 7, 96), device="meta"), *[None] * 9, 7, 3)
