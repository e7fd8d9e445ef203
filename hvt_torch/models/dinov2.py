"""DINOv2 (ViT + LayerScale) in PyTorch — port of ``hvt/models/dinov2.py``.

ViT's encoder (:mod:`hvt_torch.models.vit`: patchify, class token, position
embedding, its ``Attention`` with both routes, final LN) with hvt's DINOv2
blocks: LayerScale (``ls1``, ``ls2``) on both residual branches, and for the
giant variant the SwiGLU FFN (``mlp.weights_in``/``weights_out``). The head
and ``features_only`` read the concatenation of the class token and the mean
patch token (2·D features, HF's Dinov2ForImageClassification rule): the
linear-probe and SimpleShot feature.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from hvt_torch.models.common import TransformerMlp, drop_path, layer_norm, linear
from hvt_torch.models.vit import Attention, _apply_head, _Encoder


class SwiGLUFFN(nn.Module):
    """HF Dinov2SwiGLUFFN: Dense(2h) → silu(x1)·x2 → Dense(d), with
    h = round8(int(d · mlp_ratio · 2/3))."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0):
        super().__init__()
        hidden = (int(int(dim * mlp_ratio) * 2 / 3) + 7) // 8 * 8
        self.weights_in = nn.Linear(dim, 2 * hidden)
        self.weights_out = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = linear(self.weights_in, x).chunk(2, dim=-1)
        return linear(self.weights_out, F.silu(x1) * x2)


class Dinov2Block(nn.Module):
    """Pre-norm block with LayerScale on both branches:
    x += dp(ls1·attn(LN x)); x += dp(ls2·ffn(LN x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 layerscale_init: float = 1.0, use_swiglu: bool = False, ln_eps: float = 1e-6,
                 use_flash: bool = False):
        super().__init__()
        self.drop_path_rate = drop_path
        self.ls1 = nn.Parameter(torch.full((dim,), float(layerscale_init)))
        self.ls2 = nn.Parameter(torch.full((dim,), float(layerscale_init)))
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = Attention(dim, num_heads, use_flash)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = (SwiGLUFFN(dim, mlp_ratio) if use_swiglu
                    else TransformerMlp(dim, int(dim * mlp_ratio)))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        rate, training = self.drop_path_rate, self.training
        h = self.attn(layer_norm(self.norm1, x))
        x = x + drop_path(h * self.ls1.to(h.dtype), rate, training, generator)
        h = self.mlp(layer_norm(self.norm2, x))
        return x + drop_path(h * self.ls2.to(h.dtype), rate, training, generator)


class Dinov2(_Encoder):
    """embed_dim 768 / depth 12 / heads 12 / patch 14 → dinov2_vitb14."""

    def __init__(
        self,
        num_classes: Union[int, tuple[int, ...]] = 1000,
        patch_size: int = 14,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        drop_path_rate: float = 0.0,
        layerscale_init: float = 1.0,
        use_swiglu: bool = False,
        ln_eps: float = 1e-6,
        dtype: torch.dtype = torch.bfloat16,
        remat: bool = False,
        use_flash: bool | None = None,
        img_size: int = 224,
        seed: int = 0,
    ):
        super().__init__(num_classes, patch_size, embed_dim, depth, ln_eps, dtype, remat,
                         img_size, 2 * embed_dim)
        rates = np.linspace(0, drop_path_rate, depth).tolist()
        for i in range(depth):
            self.add_module(f"block{i}", Dinov2Block(
                embed_dim, num_heads, mlp_ratio, rates[i], layerscale_init, use_swiglu, ln_eps,
                bool(use_flash)))
        self.reset_parameters(seed)

    def forward(self, x, features_only: bool = False, generator: torch.Generator | None = None):
        """x: (B, H, W, 3) → logits from [cls ‖ mean patch] (B, 2·D) f32, or
        those features with ``features_only``."""
        x = self.tokens(x, generator)
        feats = torch.cat([x[:, 0], x[:, 1:].mean(1)], -1).float()
        return feats if features_only else _apply_head(self.head, feats)


_KNOBS = ("bn_scale_init", "fuse", "blurpool")


def _build(num_classes, dtype, kwargs, **geometry):
    # The factory's uniform knobs, as hvt's variants take them: use_pallas is
    # the flash route; fuse, bn_scale_init and blurpool do nothing here.
    for knob in _KNOBS:
        kwargs.pop(knob, None)
    if "use_pallas" in kwargs:
        kwargs.setdefault("use_flash", kwargs.pop("use_pallas"))
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return Dinov2(num_classes=num_classes, dtype=dtype, **geometry, **kwargs)


def _variant(embed_dim, depth, num_heads, use_swiglu=False):
    def build(num_classes, *, dtype="bfloat16", **kwargs):
        return _build(num_classes, dtype, kwargs, embed_dim=embed_dim, depth=depth,
                      num_heads=num_heads, use_swiglu=use_swiglu)

    return build


# facebook/dinov2-{small,base,large,giant} geometry (timm
# vit_{small,base,large,giant}_patch14_dinov2); giant uses the SwiGLU FFN.
dinov2_vits14 = _variant(384, 12, 6)
dinov2_vitb14 = _variant(768, 12, 12)
dinov2_vitl14 = _variant(1024, 24, 16)
dinov2_vitg14 = _variant(1536, 40, 24, use_swiglu=True)


def dinov2_micro(num_classes, *, dtype="float32", **kwargs):
    """Tests only: 2 blocks at dim 32, patch 8 (``use_swiglu`` for the
    SwiGLU path)."""
    return _build(num_classes, dtype, kwargs, patch_size=8, embed_dim=32, depth=2, num_heads=2)
