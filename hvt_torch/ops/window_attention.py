"""Windowed cosine attention helpers — port of ``hvt/ops/window_attention.py``.

Same layouts as hvt: NHWC feature maps, (nW·B, N, C) window tokens with
batch-major rows (window id = row mod nW), packed (nWB, N, 3C) qkv with
columns [q all heads | k | v], and (heads, N, N) biases. The geometry tables
are numpy constants, as in hvt; the rest is plain torch.

The kernels for the packed and the split layouts live in
:mod:`hvt_torch.ops.window_attention_cuda`; :func:`window_attention_reference`
here is the port of hvt's jnp oracle (its ``max(‖q‖, 1e-12)`` normalization,
where the kernels use ``rsqrt(Σq² + 1e-24)``). :func:`window_attention` and
:func:`window_attention_qkv` dispatch between them as hvt's ops of the same
names do: the kernel where hvt takes its Pallas kernel, the reference where
hvt runs plain XLA.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from hvt_torch.ops import window_attention_cuda as wac


def relative_coords_table(window_size: int, pretrained_window_size: int = 0) -> np.ndarray:
    """(2w-1, 2w-1, 2) log-spaced relative coordinates in [-1, 1]."""
    w = window_size
    coords = np.arange(-(w - 1), w, dtype=np.float32)
    table = np.stack(np.meshgrid(coords, coords, indexing="ij"), axis=-1)
    denom = (pretrained_window_size - 1) if pretrained_window_size > 0 else (w - 1)
    table = table / max(denom, 1)
    table = table * 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return table


def relative_position_index(window_size: int) -> np.ndarray:
    """(w², w²) flat index into the (2w-1)² bias table."""
    w = window_size
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int64)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, window², C)."""
    b, h, w, c = x.shape
    if h % window or w % window:
        raise ValueError(
            f"feature grid {h}x{w} is not divisible by window_size {window} "
            f"(image size must keep every stage's grid a multiple of the window)"
        )
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(windows: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """(B·nW, window², C) → (B, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // window) * (w // window))
    x = windows.reshape(b, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def shift_attn_mask(resolution: tuple[int, int], window: int, shift: int) -> np.ndarray:
    """(nW, w², w²) additive mask (0 / -100) for shifted windows."""
    h, w = resolution
    img = np.zeros((1, h, w, 1), dtype=np.float32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    img = img.reshape(1, h // window, window, w // window, window, 1)
    img = img.transpose(0, 1, 3, 2, 4, 5).reshape(-1, window * window)
    diff = img[:, None, :] - img[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def cpb_bias(
    cpb_w1: torch.Tensor,  # (512, 2), nn.Linear layout
    cpb_b1: torch.Tensor,  # (512,)
    cpb_w2: torch.Tensor,  # (heads, 512)
    coords: torch.Tensor,  # (2w-1, 2w-1, 2)
    rel_index: torch.Tensor,  # (w², w²) int64
    num_heads: int,
) -> torch.Tensor:
    """Continuous relative position bias → (heads, w², w²) f32: a 2-layer
    MLP (512 hidden, ReLU, bias-free output) over the coords table, gathered
    per token pair, scaled 16·sigmoid."""
    table = coords.reshape(-1, 2).float()
    hidden = F.relu(F.linear(table, cpb_w1.float(), cpb_b1.float()))
    bias_table = F.linear(hidden, cpb_w2.float())  # ((2w-1)², heads)
    n = rel_index.shape[0]
    bias = bias_table[rel_index.reshape(-1)].reshape(n, n, num_heads)
    return (16.0 * torch.sigmoid(bias)).permute(2, 0, 1).contiguous()


def split_heads(qkv: torch.Tensor, num_heads: int):
    """(nWB, N, 3C) packed → q, k, v each (nWB, heads, N, head_dim)."""
    nwb, n, c3 = qkv.shape
    c = c3 // 3
    qkv5 = qkv.reshape(nwb, n, 3, num_heads, c // num_heads)
    return tuple(qkv5[:, :, i].transpose(1, 2) for i in range(3))


def window_attention_reference(
    q: torch.Tensor,  # (nWB, heads, N, head_dim)
    k: torch.Tensor,
    v: torch.Tensor,
    logit_scale: torch.Tensor,  # (heads, 1, 1)
    bias: torch.Tensor,  # (heads, N, N)
    mask: torch.Tensor | None = None,  # (nW, N, N)
) -> torch.Tensor:
    """Plain cosine window attention (port of hvt's oracle) → (nWB, heads, N, d)."""
    dtype = q.dtype
    qn = q.float() / torch.clamp(torch.linalg.vector_norm(q.float(), dim=-1, keepdim=True), min=1e-12)
    kn = k.float() / torch.clamp(torch.linalg.vector_norm(k.float(), dim=-1, keepdim=True), min=1e-12)
    attn = qn @ kn.transpose(-1, -2)
    attn = attn * torch.exp(torch.clamp(logit_scale.float(), max=math.log(1.0 / 0.01)))
    attn = attn + bias[None].float()
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.reshape(-1, nw, *attn.shape[1:]) + mask[None, :, None].float()
        attn = attn.reshape(-1, *attn.shape[2:])
    attn = torch.softmax(attn, dim=-1)
    return attn.to(dtype) @ v


def window_attention(q, k, v, logit_scale, bias, mask=None, use_pallas: bool = True):
    """hvt's op on split q, k, v (nWB, heads, N, head_dim) → (nWB, heads, N,
    head_dim) in q's dtype: the split-q/k/v kernels
    (``window_attention_cuda.window_attention_split``, forward and backward)
    for a CUDA tensor with ``use_pallas``; :func:`window_attention_reference`
    under torch autograd for a CPU tensor or without ``use_pallas``, as hvt
    dispatches to its jnp reference off the TPU."""
    if use_pallas and q.device.type == "cuda":
        return wac.window_attention_split(q, k, v, logit_scale, bias, mask)
    return window_attention_reference(q, k, v, logit_scale, bias, mask)


def window_attention_qkv(qkv, logit_scale, bias, mask=None, *, num_heads: int,
                         use_pallas: bool = True):
    """hvt's op on the packed projection (nWB, N, 3C) → (nWB, N, C): with
    ``use_pallas`` the packed kernels (``window_attention_packed``, their
    plain versions on a CPU tensor); without, split_heads around
    :func:`window_attention_reference`, hvt's XLA route."""
    if use_pallas:
        return wac.window_attention_packed(qkv, logit_scale, bias, mask, num_heads=num_heads)
    nwb, n, c3 = qkv.shape
    q, k, v = split_heads(qkv, num_heads)
    out = window_attention_reference(q, k, v, logit_scale, bias, mask)
    return out.transpose(1, 2).reshape(nwb, n, c3 // 3)
