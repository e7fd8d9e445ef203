"""Vision Transformer in PyTorch — port of ``hvt/models/vit.py``.

The standard (AugReg / original-paper) ViT with hvt's parameter tree and
arithmetic: a patchify that is one product (the parameter is the conv's
kernel, here in PyTorch's (D, C, p, p) layout), a prepended class token,
learned absolute position embeddings, pre-norm blocks (LN → attention → +,
LN → GELU MLP → +), a final LN, and the class token (``pool="token"``) or
the patch tokens' mean (``pool="avg"``) into a Dense or multitask head in
f32. Module names mirror the flax ones (``patch_embed``, ``cls_token``,
``pos_embed``, ``block{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}``,
``norm``, ``head``); :mod:`hvt_torch.models.convert` maps a flax tree onto
them.

Attention has two routes, by ``use_flash`` as in hvt:

* dense (the default): scores in the compute dtype, softmax in f32, P cast
  back to q's dtype, P·v (hvt/models/vit.py:117-122);
* ``use_flash``: :func:`hvt_torch.ops.flash_attention.flash_attention_qkv`
  on the packed qkv projection, the flash-attention kernels on the card
  (head dim 64) and their plain versions on the CPU. hvt takes this route on
  a TPU only (``flash_available``); the port takes it wherever it is asked.

``pos_embed`` is made at ``img_size`` (the factory passes the train crop), as
hvt makes it at its first input; another input size raises. ``remat`` runs
every block under :func:`~hvt_torch.models.common.recompute` in training.
Stochastic depth draws one mask per branch from the caller's generator, at
the per-block rates ``linspace(0, rate, depth)``.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from hvt_torch.models.common import (TransformerMlp, drop_path, layer_norm, linear, recompute,
                                     trunc02_)
from hvt_torch.models.heads import MultitaskHead
from hvt_torch.ops import flash_attention as fa


class Attention(nn.Module):
    """Global multi-head self-attention with fused qkv (with bias) and proj."""

    def __init__(self, dim: int, num_heads: int, use_flash: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.use_flash = bool(use_flash)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        h, hd = self.num_heads, self.head_dim
        qkv = linear(self.qkv, x)
        if self.use_flash:
            out = fa.flash_attention_qkv(qkv, h, hd ** -0.5)
        else:
            q, k, v = qkv.reshape(b, n, 3, h, hd).permute(2, 0, 3, 1, 4).unbind(0)
            attn = (q @ k.transpose(-1, -2)) * (hd ** -0.5)
            attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
            out = (attn @ v).transpose(1, 2).reshape(b, n, d)
        return linear(self.proj, out)

    def unsupported(self) -> str | None:
        """Why the kernels cannot run this attention, or None (the dense
        route runs no kernel of this repository)."""
        return fa.unsupported(self.head_dim) if self.use_flash else None


class Block(nn.Module):
    """Pre-norm transformer block (LN → attn → +, LN → mlp → +)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 ln_eps: float = 1e-6, use_flash: bool = False):
        super().__init__()
        self.drop_path_rate = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = Attention(dim, num_heads, use_flash)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = TransformerMlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        rate, training = self.drop_path_rate, self.training
        x = x + drop_path(self.attn(layer_norm(self.norm1, x)), rate, training, generator)
        return x + drop_path(self.mlp(layer_norm(self.norm2, x)), rate, training, generator)


class PatchEmbed(nn.Module):
    """hvt's patchify: reshape, then one product with the conv's kernel
    flattened in (kh, kw, C) order (``weight`` (D, C, p, p), ``bias`` (D,))."""

    def __init__(self, embed_dim: int, patch_size: int, in_chans: int = 3):
        super().__init__()
        self.patch_size = patch_size
        self.weight = nn.Parameter(torch.empty(embed_dim, in_chans, patch_size, patch_size))
        self.bias = nn.Parameter(torch.zeros(embed_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) → (B, (H/p)·(W/p), D) in x's dtype."""
        p = self.patch_size
        b, h, w, c = x.shape
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (h // p) * (w // p), p * p * c)
        w_flat = self.weight.permute(0, 2, 3, 1).reshape(self.weight.shape[0], -1).to(x.dtype)
        return x @ w_flat.t() + self.bias.to(x.dtype)


def _head(num_classes, dim: int) -> nn.Module:
    if isinstance(num_classes, tuple):
        return MultitaskHead(dim, num_classes)
    return nn.Linear(dim, num_classes)


def _apply_head(head: nn.Module, feats: torch.Tensor):
    if isinstance(head, MultitaskHead):
        return head(feats)
    return F.linear(feats, head.weight.float(), head.bias.float())


class _Encoder(nn.Module):
    """What ViT and DINOv2 share: the patch embedding, class token and
    position embedding, the blocks (``block{i}``), the final norm, the head,
    initialisation and the kernels' refusals."""

    def __init__(self, num_classes, patch_size: int, embed_dim: int, depth: int, ln_eps: float,
                 dtype: torch.dtype, remat: bool, img_size: int, head_features: int):
        super().__init__()
        self.num_classes = num_classes
        self.patch_size, self.embed_dim, self.depth = patch_size, embed_dim, depth
        self.dtype = dtype
        self.remat = remat
        self.num_features = head_features
        self.patch_embed = PatchEmbed(embed_dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        grid = img_size // patch_size
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, embed_dim))
        self.norm = nn.LayerNorm(embed_dim, eps=ln_eps)
        self.head = _head(num_classes, head_features)

    @property
    def no_weight_decay_substrings(self) -> tuple[str, ...]:
        """timm's ViT ``no_weight_decay()``: pos_embed and cls_token."""
        return ("pos_embed", "cls_token")

    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.depth)]

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """hvt's initialisation, drawn from a torch.Generator seeded with
        ``seed``: Dense kernels, the patch kernel, cls_token and pos_embed
        trunc_normal(0.02), biases zero, LayerNorms ones and zeros (and
        DINOv2's LayerScale at its init, set by its block)."""
        gen = torch.Generator().manual_seed(seed)
        for module in self.modules():
            if isinstance(module, (nn.Linear, PatchEmbed)):
                trunc02_(module.weight, gen)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
        trunc02_(self.cls_token, gen)
        trunc02_(self.pos_embed, gen)
        if isinstance(self.head, MultitaskHead):
            self.head.reset_parameters(gen)

    def cuda_unsupported(self, image_size: int, training: bool = False) -> list[str]:
        """Why the CUDA kernels cannot run this model at ``image_size`` px:
        on ``use_flash``, the flash-attention kernels' refusal (head dim), the
        same for forward and backward and any size; empty on the dense route,
        which runs no kernel of this repository."""
        del image_size, training
        why = self.block0.attn.unsupported() if self.depth else None
        return [f"attention ({self.depth} blocks, use_flash): {why}"] if why else []

    def tokens(self, x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        """x (B, H, W, 3) → the final-normed tokens (B, 1 + N, D) in the compute dtype."""
        b = x.shape[0]
        x = self.patch_embed(x.to(self.dtype))
        if x.shape[1] + 1 != self.pos_embed.shape[1]:
            raise ValueError(
                f"pos_embed holds {self.pos_embed.shape[1] - 1} patches and this input has "
                f"{x.shape[1]}; as hvt, the port does not interpolate it")
        cls = self.cls_token.to(x.dtype).expand(b, 1, self.embed_dim)
        x = torch.cat([cls, x], 1) + self.pos_embed.to(x.dtype)
        remat = self.remat and self.training
        for block in self.blocks():
            x = recompute(block, x, generator) if remat else block(x, generator)
        return layer_norm(self.norm, x)


class VisionTransformer(_Encoder):
    """Standard ViT. embed_dim 768 / depth 12 / heads 12 → ViT-B/16."""

    def __init__(
        self,
        num_classes: Union[int, tuple[int, ...]] = 1000,
        patch_size: int = 16,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        drop_path_rate: float = 0.0,
        pool: str = "token",
        ln_eps: float = 1e-6,
        dtype: torch.dtype = torch.bfloat16,
        remat: bool = False,
        use_flash: bool | None = None,
        img_size: int = 224,
        seed: int = 0,
    ):
        super().__init__(num_classes, patch_size, embed_dim, depth, ln_eps, dtype, remat,
                         img_size, embed_dim)
        self.pool = pool
        rates = np.linspace(0, drop_path_rate, depth).tolist()
        for i in range(depth):
            self.add_module(f"block{i}", Block(embed_dim, num_heads, mlp_ratio, rates[i], ln_eps,
                                               bool(use_flash)))
        self.reset_parameters(seed)

    def forward(self, x, features_only: bool = False, generator: torch.Generator | None = None):
        """x: (B, H, W, 3) normalized image → logits (B, classes) f32, or one
        tensor per tier for a multitask head; ``features_only`` → the pooled
        (B, D) f32 features. ``generator`` draws the stochastic-depth masks
        in train mode."""
        x = self.tokens(x, generator)
        feats = (x[:, 1:].mean(1) if self.pool == "avg" else x[:, 0]).float()
        return feats if features_only else _apply_head(self.head, feats)


def _variant(embed_dim, depth, num_heads, patch_size):
    def build(num_classes, *, blurpool: bool = False, dtype="bfloat16", **kwargs):
        # The factory's uniform knobs, as hvt's variants take them: use_pallas
        # is the flash route; fuse and bn_scale_init do nothing here.
        del blurpool
        kwargs.pop("bn_scale_init", None)
        kwargs.pop("fuse", None)
        if "use_pallas" in kwargs:
            kwargs.setdefault("use_flash", kwargs.pop("use_pallas"))
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        return VisionTransformer(num_classes=num_classes, patch_size=patch_size,
                                 embed_dim=embed_dim, depth=depth, num_heads=num_heads,
                                 dtype=dtype, **kwargs)

    return build


# timm geometry for the vit_{tiny,small,base,large}_patch16_224 names.
vit_tiny_patch16_224 = _variant(192, 12, 3, 16)
vit_small_patch16_224 = _variant(384, 12, 6, 16)
vit_base_patch16_224 = _variant(768, 12, 12, 16)
vit_base_patch32_224 = _variant(768, 12, 12, 32)
vit_large_patch16_224 = _variant(1024, 24, 16, 16)
vit_micro = _variant(32, 2, 2, 8)  # tests only
