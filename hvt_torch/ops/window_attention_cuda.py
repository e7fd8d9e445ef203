"""Kernel 1: cosine window attention on the packed qkv projection.

Port of ``window_attention_packed`` (hvt/ops/window_attention_pallas.py:613),
forward only. ``window_attention_packed`` launches
``csrc/window_attention.cu`` for a CUDA tensor and runs
``window_attention_packed_plain`` for a CPU tensor; nothing else selects
between them. Both compute, per head,

    out = softmax(exp(min(ls, log 100)) · q̂k̂ᵀ + z) · v,   q̂ = q·rsqrt(Σq² + 1e-24)

in f32, with z = bias (H, N, N) [+ mask (nW, N, N)] and window id = row mod nW.
"""

from __future__ import annotations

import math

import torch

from hvt_torch.ops import _build

KERNEL = _build.Kernel(
    "window_attention",
    "hvt_window_attention_packed_fwd",
    [_build.P, _build.P, _build.P, _build.I, _build.P, _build.I, _build.I, _build.I,
     _build.I, _build.I, _build.P],
)
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
SMEM_BYTES = 227 * 1024  # the H100's dynamic shared memory per block


def unsupported(n: int, c: int, heads: int) -> str | None:
    """Why the kernel cannot take windows of ``n`` tokens at width ``c``
    with ``heads`` heads, or None: one block holds the head's q, k, v and
    the N x N logits in f32 shared memory."""
    if c % heads:
        return f"width {c} does not split into {heads} heads"
    d = c // heads
    smem = 4 * (3 * n * (d + 1) + n * (n + 1))
    if smem > SMEM_BYTES:
        return (f"windows of {n} tokens at head dim {d} need {smem} B of shared memory "
                f"(the card has {SMEM_BYTES})")
    return None


def attention_scale(logit_scale: torch.Tensor) -> torch.Tensor:
    """(heads, 1, 1) logit scale → (heads,) f32 exp(min(ls, log 100))."""
    return torch.exp(torch.clamp(logit_scale.float(), max=math.log(100.0))).reshape(-1)


def merge_bias_mask(bias: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """(H, N, N) bias [+ (nW, N, N) mask] → (nWZ, H, N, N) f32, nWZ ∈ {1, nW}."""
    if mask is None:
        return bias.float()[None].contiguous()
    return (bias.float()[None] + mask.float()[:, None]).contiguous()


def packed_heads_forward(qkv: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                         heads: int) -> torch.Tensor:
    """The f32 attention core on packed qkv (g, N, 3C) → (g, N, C): the plain
    version of what kernels 1 and 3 compute per (window, head). z is
    (nWZ, H, N, N) with window id = row mod nWZ."""
    g, n, c3 = qkv.shape
    c = c3 // 3
    q, k, v = qkv.float().reshape(g, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    qn = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-24)
    kn = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-24)
    logits = (qn @ kn.transpose(-1, -2)) * scale.reshape(1, heads, 1, 1)
    nwz = z.shape[0]
    logits = (logits.reshape(g // nwz, nwz, heads, n, n) + z[None]).reshape(g, heads, n, n)
    out = torch.softmax(logits, dim=-1) @ v  # (g, H, N, d)
    return out.transpose(1, 2).reshape(g, n, c)


def window_attention_packed_plain(qkv, logit_scale, bias, mask=None, *, num_heads):
    """Plain PyTorch version of kernel 1 (any device)."""
    z = merge_bias_mask(bias, mask)
    out = packed_heads_forward(qkv, z, attention_scale(logit_scale), num_heads)
    return out.to(qkv.dtype)


def window_attention_packed(qkv, logit_scale, bias, mask=None, *, num_heads):
    """qkv (nWB, N, 3C) → (nWB, N, C), same dtype. A CPU tensor takes the
    plain version; a CUDA tensor (bf16 or f32) takes the kernel."""
    if qkv.device.type == "cpu":
        return window_attention_packed_plain(qkv, logit_scale, bias, mask, num_heads=num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention_packed: unsupported device {qkv.device}")
    nwb, n, c3 = qkv.shape
    c = c3 // 3
    why = "3C columns wanted" if c3 % 3 else unsupported(n, c, num_heads)
    if qkv.dtype not in _DTYPES or why:
        raise ValueError(
            f"window_attention_packed: qkv {tuple(qkv.shape)} {qkv.dtype} with "
            f"{num_heads} heads: {why or 'bf16 or f32 wanted'}"
        )
    z = merge_bias_mask(bias, mask).to(qkv.device)
    if z.shape[1:] != (num_heads, n, n) or nwb % z.shape[0]:
        raise ValueError(f"window_attention_packed: z {tuple(z.shape)} vs qkv {tuple(qkv.shape)}")
    qkv = qkv.contiguous()
    scale = attention_scale(logit_scale).to(qkv.device).contiguous()
    out = torch.empty((nwb, n, c), dtype=qkv.dtype, device=qkv.device)
    KERNEL(qkv.data_ptr(), scale.data_ptr(), z.data_ptr(), z.shape[0], out.data_ptr(), nwb, n,
           c, num_heads, _DTYPES[qkv.dtype], torch.cuda.current_stream(qkv.device).cuda_stream)
    return out
