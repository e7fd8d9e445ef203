"""The retired fused SwinV2 block halves against hvt's, on the CPU.

hvt's ``swin_block_pallas.fused_attention_branch`` and ``fused_mlp_branch``
(the Pallas kernels in interpret mode) and the port's
``swin_block_cuda.fused_attention_branch`` and ``fused_mlp_branch`` (their
plain versions on CPU tensors) take the same seeded numpy inputs: maps of 2
images of 14 x 14, window 7, at hvt's own test shape (C = 16, 2 heads) and
at the kernels' head dim (C = 64, 2 heads of 32), with z broadcast from one
(the bias alone) or one per window (bias + the shift mask at shift 3, on the
map rolled by -3 as the caller rolls it). Weights are drawn in flax's
(in, out) layout and transposed for the port; the LayerNorm scales are drawn
around 1, not at their zero init.

* Tolerances: hvt's own (tests/test_fused_block.py) in f32, attention
  atol = rtol = 1e-4, MLP atol 5e-3, rtol 1e-3: both sides compute in f32
  and differ in summation order. In bf16 (x and every weight) the branch is
  rounded to bf16 at the store, one ulp of which is 3.9e-3 relative: max|Δ|
  ≤ 1e-2·max|hvt|.
* A bf16 w2 with an f32 x rounds the GELU output to bf16 before fc2 on both
  sides: the port holds hvt to 1e-4·max|hvt| there, and the same math
  without that rounding misses it.
* The plain versions equal the port's own module math (``WindowAttention``
  then LayerNorm, ``Mlp`` then LayerNorm), as tests/test_fused_block.py holds
  hvt's kernels to hvt's modules, at the same tolerances (the MLP's exact
  GELU against the erf polynomial).
* No kernel launch counter moves on CPU tensors.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvt.ops import swin_block_pallas as sbp
from hvt_torch.models import swinv2 as ts
from hvt_torch.ops import fused_halves_cuda as fh
from hvt_torch.ops import swin_block_cuda as sb
from hvt_torch.ops import window_attention as wa
from hvt_torch.ops import window_attention_cuda as wac
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, GRID, WINDOW, HEADS = 2, 14, 7, 2
N = WINDOW * WINDOW
BF16_TOL = 1e-2


def _rel_close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _params(c, shift, seed):
    """One block's inputs, in flax layouts: the map rolled by -shift, the
    attention's weights, the clamped logit scale, z (the bias, or bias +
    the shift mask per window) and the MLP's weights."""
    rng = np.random.default_rng(seed)
    x = np.roll(rng.normal(size=(B, GRID, GRID, c)), (-shift, -shift), (1, 2))
    ls = np.log(10.0) + rng.normal(size=(HEADS, 1, 1)) * 0.3
    ls[0] = 5.0  # above the log 100 clamp
    bias = torch.as_tensor(16.0 / (1.0 + np.exp(-rng.normal(size=(HEADS, N, N)))), dtype=torch.float32)
    mask = torch.as_tensor(wa.shift_attn_mask((GRID, GRID), WINDOW, shift)) if shift else None
    p = {
        "x": x,
        "wqkv": rng.normal(size=(c, 3 * c)) / math.sqrt(c),
        "bqkv": np.concatenate([rng.normal(size=c) * 0.1, np.zeros(c), rng.normal(size=c) * 0.1]),
        "scale": np.exp(np.minimum(ls, np.log(100.0))),
        "z": wac.merge_bias_mask(bias, mask).numpy(),
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


def _port(p, dtypes):
    """The port's arguments: {name: torch tensor}, weights transposed to
    (out, in), in dtypes[name] (f32 by default)."""
    out = {}
    for k, v in p.items():
        t = torch.from_numpy(v.T.copy() if k in ("wqkv", "wproj", "w1", "w2") else v)
        out[k] = t.to(dtypes.get(k, torch.float32))
    return out


def _hvt(p, dtypes):
    """hvt's arguments in the same dtypes, from the port's tensors (so that
    both sides see the same rounded values)."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    return {k: jnp.asarray(v, jdt[dtypes.get(k, torch.float32)]) for k, v in p.items()}


def _launches():
    return sb.ATTN_KERNEL.launches, sb.MLP_KERNEL.launches


ATTN = ("x", "wqkv", "bqkv", "scale", "z", "wproj", "bproj", "lns", "lnb")
MLP = ("x", "w1", "b1", "w2", "b2", "lns", "lnb")
BF16 = dict.fromkeys(("x", "wqkv", "wproj", "w1", "w2"), torch.bfloat16)


@pytest.mark.parametrize("c,shift,dtypes", [
    (16, 0, {}),  # hvt's test shape, z broadcast from 1
    (16, 3, {}),
    (64, 0, {}),  # head dim 32, the kernels' shape
    (64, 3, {}),  # z per window: bias + the shift mask
    (64, 3, BF16),
], ids=["c16", "c16-shift", "c64", "c64-shift", "c64-shift-bf16"])
def test_attention_branch_matches_hvt(c, shift, dtypes):
    p = _params(c, shift, seed=c + shift)
    before = _launches()
    tp = _port(p, dtypes)
    got = sb.fused_attention_branch(*(tp[k] for k in ATTN), window=WINDOW, num_heads=HEADS)
    assert _launches() == before
    jp = _hvt({k: _np(v) for k, v in tp.items()}, dtypes)
    jp["wqkv"], jp["wproj"] = jp["wqkv"].T, jp["wproj"].T  # back to flax (in, out)
    want = np.asarray(sbp.fused_attention_branch(*(jp[k] for k in ATTN), window=WINDOW,
                                                 num_heads=HEADS, interpret=True), np.float32)
    assert got.dtype == tp["x"].dtype and got.shape == tp["x"].shape
    if dtypes:
        _rel_close(_np(got), want, BF16_TOL, f"attention branch C={c} shift={shift} bf16")
    else:
        np.testing.assert_allclose(_np(got), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("c,dtypes", [
    (16, {}),
    (64, {}),
    (64, BF16),
], ids=["c16", "c64", "c64-bf16"])
def test_mlp_branch_matches_hvt(c, dtypes):
    p = _params(c, 0, seed=10 + c)
    before = _launches()
    tp = _port(p, dtypes)
    got = sb.fused_mlp_branch(*(tp[k] for k in MLP))
    assert _launches() == before
    jp = _hvt({k: _np(v) for k, v in tp.items()}, dtypes)
    jp["w1"], jp["w2"] = jp["w1"].T, jp["w2"].T
    want = np.asarray(sbp.fused_mlp_branch(*(jp[k] for k in MLP), interpret=True), np.float32)
    assert got.dtype == tp["x"].dtype and got.shape == tp["x"].shape
    if dtypes:
        _rel_close(_np(got), want, BF16_TOL, f"MLP branch C={c} bf16")
    else:
        np.testing.assert_allclose(_np(got), want, atol=5e-3, rtol=1e-3)


def test_mlp_branch_rounds_gelu_to_w2_dtype():
    """f32 x and w1 with a bf16 w2: the GELU output is rounded to bf16
    before fc2 on both sides, which the port matches to 1e-4·max|hvt|; the
    same sums on the unrounded GELU output miss that by far."""
    dtypes = {"w2": torch.bfloat16}
    tp = _port(_params(64, 0, seed=7), dtypes)
    jp = _hvt({k: _np(v) for k, v in tp.items()}, dtypes)
    jp["w1"], jp["w2"] = jp["w1"].T, jp["w2"].T
    want = np.asarray(sbp.fused_mlp_branch(*(jp[k] for k in MLP), interpret=True))
    got = sb.fused_mlp_branch(*(tp[k] for k in MLP))
    assert got.dtype == torch.float32
    _rel_close(_np(got), want, 1e-4, "MLP branch, bf16 w2")
    unrounded = sb.fused_mlp_branch_plain(*(tp[k] if k != "w2" else tp[k].float() for k in MLP))
    err = np.abs(_np(unrounded) - want).max()
    assert err > 10 * 1e-4 * np.abs(want).max(), err


@pytest.mark.parametrize("c,shift", [(64, 0), (64, 3)])
def test_plain_versions_match_the_port_modules(c, shift):
    """The port's WindowAttention (hvt's reference attention) and Mlp, each
    followed by the res-post-norm, on the same parameters."""
    torch.manual_seed(c + shift)
    attn, mlp = ts.WindowAttention(c, HEADS), ts.TransformerMlp(c, 4 * c)
    for m in (attn, mlp):
        for prm in m.parameters():
            torch.nn.init.normal_(prm, std=0.3)
    lns, lnb = 1.0 + 0.1 * torch.randn(c), 0.1 * torch.randn(c)
    x = torch.randn(B, GRID, GRID, c)
    mask = torch.as_tensor(wa.shift_attn_mask((GRID, GRID), WINDOW, shift)) if shift else None
    with torch.no_grad():
        xw = wa.window_partition(x, WINDOW)
        want = fh.layer_norm(wa.window_reverse(attn(xw, WINDOW, mask, use_pallas=False),
                                               WINDOW, GRID, GRID), lns, lnb)
        got = sb.fused_attention_branch(
            x, attn.qkv.weight, attn.qkv_bias(), wac.attention_scale(attn.logit_scale),
            wac.merge_bias_mask(attn.rel_bias(WINDOW), mask), attn.proj.weight, attn.proj.bias,
            lns, lnb, window=WINDOW, num_heads=HEADS)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
        want = fh.layer_norm(mlp(x), lns, lnb)
        got = sb.fused_mlp_branch(x, mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight, mlp.fc2.bias,
                                  lns, lnb)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-3, rtol=1e-3)
