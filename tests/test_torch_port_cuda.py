"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test asks its fixture for a CUDA device and skips
where there is none (the CPU test run). On a machine with the card and the
CUDA toolkit:

    python -m pytest -q --noconftest -m gpu tests/test_torch_port_cuda.py

This file imports neither jax nor hvt, so it runs where only the port is
installed (``--noconftest`` skips tests/conftest.py, which sets up jax).
Inputs are bf16 at SwinV2-T widths (C = 96 and 768, head dim 32,
window 7); kernel and plain version share the arithmetic contract (bf16
operands, f32 accumulation, f32 softmax and LayerNorm), so they differ by
accumulation order and the odd bf16 rounding flip: max|Δ| ≤ 1e-2·max|plain|
for the attention core (1e-4 in f32), 2e-2 for the fused halves.
"""

import math

import numpy as np
import pytest
import torch

from hvt_torch.ops import fused_halves_cuda as fh
from hvt_torch.ops import window_attention as wa
from hvt_torch.ops import window_attention_cuda as wac

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


def _params(c, heads, n, device, seed):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return {
        "wqkv": t(rng.normal(size=(3 * c, c)) / math.sqrt(c)),
        "bqkv": t(np.concatenate([rng.normal(size=c) * 0.1, np.zeros(c), rng.normal(size=c) * 0.1])),
        "ls": t(np.log(10.0) + rng.normal(size=(heads, 1, 1)) * 0.3),
        "bias": t(16.0 / (1.0 + np.exp(-rng.normal(size=(heads, n, n))))),
        "wproj": t(rng.normal(size=(c, c)) / math.sqrt(c)),
        "bproj": t(rng.normal(size=c) * 0.1),
        "w1": t(rng.normal(size=(4 * c, c)) / math.sqrt(c)),
        "b1": t(rng.normal(size=4 * c) * 0.1),
        "w2": t(rng.normal(size=(c, 4 * c)) / math.sqrt(4 * c)),
        "b2": t(rng.normal(size=c) * 0.1),
        "lns": t(1.0 + rng.normal(size=c) * 0.1),
        "lnb": t(rng.normal(size=c) * 0.1),
        "x": t(rng.normal(size=(2, 14, 14, c))).bfloat16(),
    }


def _close(got, ref, tol, what):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all(), what
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


@pytest.mark.parametrize("c,shift,dtype,tol", [
    (96, 3, torch.bfloat16, 1e-2), (768, 0, torch.bfloat16, 1e-2),
    (96, 3, torch.float32, 1e-4),  # f32 in and out: summation order only
])
def test_window_attention_packed_kernel(cuda, c, shift, dtype, tol):
    heads, window = c // 32, 7
    p = _params(c, heads, 49, cuda, seed=c + shift)
    mask = torch.as_tensor(wa.shift_attn_mask((14, 14), window, shift), device=cuda) if shift else None
    xw = wa.window_partition(p["x"], window)
    qkv = fh.bf16_linear(xw, p["wqkv"], p["bqkv"]).to(dtype).contiguous()
    before = wac.KERNEL.launches
    got = wac.window_attention_packed(qkv, p["ls"], p["bias"], mask, num_heads=heads)
    torch.cuda.synchronize()
    assert wac.KERNEL.launches == before + 1 and got.dtype == dtype
    ref = wac.window_attention_packed_plain(qkv, p["ls"], p["bias"], mask, num_heads=heads)
    _close(got, ref, tol, f"packed attention C={c} {dtype}")


@pytest.mark.parametrize("c", [96, 768])
def test_mlp_half_kernel(cuda, c):
    p = _params(c, c // 32, 49, cuda, seed=c)
    x = p["x"].reshape(-1, c)
    args = (p["w1"], p["b1"], p["w2"], p["b2"], p["lns"], p["lnb"])
    dp = torch.tensor([0.0, 1.25], device=cuda)
    before = fh.MLP_KERNEL.launches
    got, got_resid = fh.mlp_half(x, *args), fh.mlp_half(x, *args, tpi=196, dp=dp)
    torch.cuda.synchronize()
    assert fh.MLP_KERNEL.launches == before + 2
    _close(got, fh.mlp_half_plain(x, *args), 2e-2, f"mlp_half C={c}")
    _close(got_resid, fh.mlp_half_plain(x, *args, tpi=196, dp=dp), 2e-2, f"mlp_half resid C={c}")


@pytest.mark.parametrize("c,shift", [(96, 3), (96, 0), (768, 0)])
def test_attention_half_nhwc_kernel(cuda, c, shift):
    heads, window = c // 32, 7
    p = _params(c, heads, 49, cuda, seed=2 * c + shift)
    mask = torch.as_tensor(wa.shift_attn_mask((14, 14), window, shift), device=cuda) if shift else None
    args = (p["wqkv"], p["bqkv"], p["ls"], p["bias"], mask, p["wproj"], p["bproj"], p["lns"],
            p["lnb"], window, heads)
    dp = torch.tensor([0.0, 1.25], device=cuda)
    before = fh.ATTN_KERNEL.launches
    got = fh.attention_half_nhwc(p["x"], *args, shift=shift)
    got_resid = fh.attention_half_nhwc(p["x"], *args, dp=dp, shift=shift)
    torch.cuda.synchronize()
    assert fh.ATTN_KERNEL.launches == before + 2
    _close(got, fh.attention_half_nhwc_plain(p["x"], *args, shift=shift), 2e-2,
           f"attention half C={c}")
    _close(got_resid, fh.attention_half_nhwc_plain(p["x"], *args, dp=dp, shift=shift), 2e-2,
           f"attention half resid C={c}")


def test_kernels_refuse_unsupported_shapes(cuda):
    """A CUDA tensor the kernel does not take raises; it never falls back."""
    with pytest.raises(ValueError, match="C in"):
        fh.mlp_half(torch.zeros((49, 64), device=cuda, dtype=torch.bfloat16),
                    torch.zeros((256, 64), device=cuda), *[None] * 5)
    with pytest.raises(ValueError, match="bf16"):
        fh.mlp_half(torch.zeros((49, 96), device=cuda), torch.zeros((384, 96), device=cuda),
                    *[None] * 5)
