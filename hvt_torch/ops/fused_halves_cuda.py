"""Kernels 2 and 3: the fused SwinV2 block halves, forward.

Port of ``mlp_half`` (hvt/ops/fused_halves_pallas.py:397) and
``attention_half_nhwc`` (same file, 1491), for eval. Each wrapper launches
``csrc/fused_halves.cu`` for a CUDA tensor and runs its plain version for a
CPU tensor; nothing else selects between them.

The arithmetic contract is the TPU kernels': matmul operands rounded to
bf16 with f32 accumulation (``_dot``), exact GELU by the A&S erf polynomial,
LayerNorm in f32 (eps 1e-5), the attention core of kernel 1 in f32, and the
optional fused residual ``x + s·branch`` with one scale per image.

Layouts follow hvt's public functions: x is (T, C) flat tokens for the MLP
and the NHWC map (B, H, W, C) for the attention half. Weights are in
nn.Linear's (out, in) layout (hvt_torch/models/convert.py maps the flax
ones), and ``dp`` is the per-image scale as a (B,) vector (hvt broadcasts it
to (B, 8, 128) for the TPU's tiling). ``attention_half_nhwc`` also takes
``shift``: shift = 0 reads x as hvt does (already rolled); shift > 0 reads
the un-rolled map, rolls by -shift on the way in and by +shift on the way
out, which the kernel folds into its gather index.
"""

from __future__ import annotations

import torch

from hvt_torch.ops import _build
from hvt_torch.ops import window_attention as wa
from hvt_torch.ops.window_attention_cuda import (
    attention_scale,
    merge_bias_mask,
    packed_heads_forward,
)

P, I = _build.P, _build.I
MLP_KERNEL = _build.Kernel(
    "fused_halves", "hvt_mlp_half_fwd", [P, P, P, P, P, P, P, P, I, P, I, I, P]
)
ATTN_KERNEL = _build.Kernel(
    "fused_halves",
    "hvt_attention_half_nhwc_fwd",
    [P, P, P, P, P, I, P, P, P, P, P, P, I, I, I, I, I, I, I, P],
)
#: channel widths the kernels are built for (SwinV2-T's stages)
WIDTHS = (96, 192, 384, 768)
HEAD_DIM = 32
_LN_EPS = 1e-5
_INV_SQRT2 = 0.7071067811865476


def unsupported(c: int, heads: int, window: int) -> str | None:
    """Why the kernels cannot run a fused block of width ``c`` with ``heads``
    heads and ``window``, or None."""
    if c not in WIDTHS:
        return f"width {c} is not one the kernels are built for {WIDTHS}"
    if c != heads * HEAD_DIM:
        return f"head dim {c // heads} is not {HEAD_DIM}"
    if window * window > 64:
        return f"window {window} has more than 64 tokens"
    return None


def erf_as(x: torch.Tensor) -> torch.Tensor:
    """erf by Abramowitz–Stegun 7.1.26 (|err| ≤ 1.5e-7), as hvt's ``_erf``."""
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def gelu_as(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + erf_as(x * _INV_SQRT2))


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """f32 LayerNorm over the last dim, two-pass, as hvt's ``_ln_fwd``."""
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + _LN_EPS)
    return xc * inv * scale.float() + bias.float()


def bf16_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (..., K) · w (N, K)ᵀ + b with operands rounded to bf16 and f32
    accumulation — the TPU kernels' ``_dot``."""
    xb = x.to(torch.bfloat16).float()
    wb = w.to(torch.bfloat16).float()
    return xb @ wb.t() + b.float()


# ---------------------------------------------------------------------------
# MLP half
# ---------------------------------------------------------------------------


def mlp_half_plain(x, w1, b1, w2, b2, lns, lnb, tpi: int = 0, dp=None):
    """Plain PyTorch version of kernel 2 (any device)."""
    hidden = gelu_as(bf16_linear(x, w1, b1))
    branch = layer_norm(bf16_linear(hidden, w2, b2), lns, lnb)
    if dp is None:
        return branch.to(x.dtype)
    return (x.float() + dp.float().repeat_interleave(tpi)[:, None] * branch).to(x.dtype)


def mlp_half(x, w1, b1, w2, b2, lns, lnb, tpi: int = 0, dp=None):
    """x (T, C) → LN(fc2(GELU(fc1 x))), or x + dp·branch when ``dp`` (B,)
    gives a scale per image of ``tpi`` consecutive rows. w1 (4C, C) and
    w2 (C, 4C) in nn.Linear layout."""
    if x.device.type == "cpu":
        return mlp_half_plain(x, w1, b1, w2, b2, lns, lnb, tpi, dp)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_half: unsupported device {x.device}")
    t, c = x.shape
    if x.dtype != torch.bfloat16 or c not in WIDTHS or tuple(w1.shape) != (4 * c, c):
        raise ValueError(
            f"mlp_half: x {tuple(x.shape)} {x.dtype}, w1 {tuple(w1.shape)}; the kernel "
            f"takes bf16 x with C in {WIDTHS} and hidden 4C"
        )
    if dp is not None and (tpi <= 0 or t != tpi * dp.numel()):
        raise ValueError(f"mlp_half: {t} rows are not {dp.numel()} images of {tpi} tokens")
    x = x.contiguous()
    f32 = lambda v: v.to(device=x.device, dtype=torch.float32).contiguous()  # noqa: E731
    bf = lambda v: v.to(device=x.device, dtype=torch.bfloat16).contiguous()  # noqa: E731
    args = [bf(w1), f32(b1), bf(w2), f32(b2), f32(lns), f32(lnb)]
    s = None if dp is None else f32(dp.reshape(-1))
    out = torch.empty_like(x)
    MLP_KERNEL(x.data_ptr(), *(a.data_ptr() for a in args),
               None if s is None else s.data_ptr(), max(tpi, 1), out.data_ptr(), t, c,
               torch.cuda.current_stream(x.device).cuda_stream)
    return out


# ---------------------------------------------------------------------------
# Attention half on the NHWC map
# ---------------------------------------------------------------------------


def attention_half_nhwc_plain(x, wqkv, bqkv, logit_scale, bias, mask, wproj, bproj, lns, lnb,
                              window: int, heads: int, dp=None, shift: int = 0):
    """Plain PyTorch version of kernel 3 (any device)."""
    b, h, w, c = x.shape
    xs = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
    qkv = bf16_linear(wa.window_partition(xs.float(), window), wqkv, bqkv)
    z = merge_bias_mask(bias, mask).to(x.device)
    attn = packed_heads_forward(qkv, z, attention_scale(logit_scale).to(x.device), heads)
    branch = layer_norm(bf16_linear(attn, wproj, bproj), lns, lnb)
    out = wa.window_reverse(branch, window, h, w)
    out = (out if dp is None else xs.float() + dp.float().reshape(b, 1, 1, 1) * out).to(x.dtype)
    return torch.roll(out, (shift, shift), (1, 2)) if shift else out


def attention_half_nhwc(x, wqkv, bqkv, logit_scale, bias, mask, wproj, bproj, lns, lnb,
                        window: int, heads: int, dp=None, shift: int = 0):
    """x (B, H, W, C) → LN(proj(window attention(qkv(x)))) at every token, or
    x + dp·branch with ``dp`` (B,). wqkv (3C, C), bqkv (3C,) = [q_b, 0, v_b],
    wproj (C, C); bias (heads, N, N), mask (nW, N, N) or None."""
    if x.device.type == "cpu":
        return attention_half_nhwc_plain(x, wqkv, bqkv, logit_scale, bias, mask, wproj, bproj,
                                         lns, lnb, window, heads, dp, shift)
    if x.device.type != "cuda":
        raise ValueError(f"attention_half_nhwc: unsupported device {x.device}")
    b, h, w, c = x.shape
    why = unsupported(c, heads, window)
    if h % window or w % window:
        why = "the window does not tile the map"
    if x.dtype != torch.bfloat16 or why:
        raise ValueError(
            f"attention_half_nhwc: x {tuple(x.shape)} {x.dtype}, {heads} heads, window "
            f"{window}: {why or 'bf16 wanted'}"
        )
    if not 0 <= shift < window:
        raise ValueError(f"attention_half_nhwc: shift {shift} outside [0, {window})")
    z = merge_bias_mask(bias, mask).to(x.device)
    if dp is not None and dp.numel() != b:
        raise ValueError(f"attention_half_nhwc: dp has {dp.numel()} scales for {b} images")
    x = x.contiguous()
    f32 = lambda v: v.to(device=x.device, dtype=torch.float32).contiguous()  # noqa: E731
    bf = lambda v: v.to(device=x.device, dtype=torch.bfloat16).contiguous()  # noqa: E731
    args = [bf(wqkv), f32(bqkv), f32(attention_scale(logit_scale)), z]
    rest = [bf(wproj), f32(bproj), f32(lns), f32(lnb)]
    s = None if dp is None else f32(dp.reshape(-1))
    out = torch.empty_like(x)
    ATTN_KERNEL(x.data_ptr(), *(a.data_ptr() for a in args), z.shape[0],
                *(a.data_ptr() for a in rest), None if s is None else s.data_ptr(),
                out.data_ptr(), b, h, w, c, heads, window, shift,
                torch.cuda.current_stream(x.device).cuda_stream)
    return out
