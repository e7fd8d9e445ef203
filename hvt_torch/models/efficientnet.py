"""EfficientNet (V1) in PyTorch — port of ``hvt/models/efficientnet.py``.

Same architecture, parameter tree and init as hvt: a TF-SAME 3×3/2 stem, the
MBConv blocks of ``block_plan`` (1×1 expand → k×k depthwise → squeeze-excite
→ 1×1 project, BatchNorm and SiLU, per-sample stochastic depth on the
identity blocks), a 1×1 top conv to ``round_filters(1280)``, the pooled
features, dropout in training and a Dense or multitask head in f32; width
and depth scale per variant by ``round_filters`` and ``round_repeats``.
Module names mirror the flax ones (``stem_conv``, ``stem_bn``,
``block{i}.{expand_conv,expand_bn,dwconv,dw_bn,se_reduce,se_expand,
project_conv,project_bn}``, ``top_conv``, ``top_bn``, ``head``);
:func:`hvt_torch.models.convert.convnet_params_from_flax` maps a flax tree
(params and ``batch_stats``) onto them.

As hvt: a stride-2 conv pads TF-SAME, (k//2 − 1, k//2) on each axis (the
stem (0, 1)), then runs unpadded; a stride-1 depthwise conv pads k//2 on
every side. A block with expand ratio 1 has no expand conv; the
squeeze-excite width is int(in · se_ratio) of the block's *pre-expansion*
input. BatchNorm is flax's at momentum 0.99 and eps 1e-3
(:class:`~hvt_torch.models.common.BatchNorm`). Stochastic depth
(``drop_connect_rate``, 0.2 by default) draws one mask a block, and the
head's dropout (elementwise, train only) one mask a feature, from the
caller's generator. Parameters stay f32, activations run in ``dtype``, NHWC
end to end, each convolution ``F.conv2d`` on the channels-last view with a
channels-last weight.

hvt reaches no Pallas kernel here, and neither does the port:
:meth:`EfficientNet.cuda_unsupported` is empty. ``remat`` runs every block
under :func:`~hvt_torch.models.common.recompute` in training.
``drop_path_rate`` (which StochasticDepth would set) raises, as in hvt.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from hvt_torch.models.common import (BatchNorm, channels_last_, conv_nhwc, drop_path, recompute,
                                     se_gate)
from hvt_torch.models.heads import MultitaskHead

# The seven base stages (b0 geometry, the same for every variant; only
# width and depth scale) — kernel, in, out, stride, repeats, expand.
KERNELS = (3, 3, 5, 3, 5, 5, 3)
IN_CH = (32, 16, 24, 40, 80, 112, 192)
OUT_CH = (16, 24, 40, 80, 112, 192, 320)
STRIDES = (1, 2, 2, 2, 1, 2, 1)
REPEATS = (1, 2, 2, 3, 3, 4, 1)
EXPANDS = (1, 6, 6, 6, 6, 6, 6)


def round_filters(channels: float, width: float, divisor: int = 8) -> int:
    """EfficientNet's width scaling (the TF reference's rule)."""
    channels *= width
    new = max(divisor, int(channels + divisor / 2) // divisor * divisor)
    if new < 0.9 * channels:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def same_pad(x: torch.Tensor, k: int) -> torch.Tensor:
    """TF-SAME padding of an NHWC ``x`` for a stride-2 k×k conv: one less on
    the top and left, (k//2 − 1, k//2)."""
    c = k // 2
    return F.pad(x, (0, 0, c - 1, c, c - 1, c))


class MBConv(nn.Module):
    """expand 1×1 → depthwise k×k → squeeze-excite → project 1×1, with a
    per-sample drop-path residual on identity blocks."""

    def __init__(self, in_dim: int, out_dim: int, stride: int, expand_ratio: int, kernel: int,
                 skip: bool, drop_path: float = 0.0, se_ratio: float = 0.25,
                 bn_momentum: float = 0.99, bn_eps: float = 1e-3):
        super().__init__()
        self.stride, self.kernel, self.skip = stride, kernel, skip
        self.drop_path_rate = drop_path
        exp_dim = in_dim * expand_ratio
        dim_se = max(1, int(in_dim * se_ratio))

        def bn(c):
            return BatchNorm(c, bn_eps, bn_momentum)

        self.expand = expand_ratio != 1
        if self.expand:
            self.expand_conv = channels_last_(nn.Conv2d(in_dim, exp_dim, 1, bias=False))
            self.expand_bn = bn(exp_dim)
        pad = 0 if stride == 2 else kernel // 2
        self.dwconv = channels_last_(nn.Conv2d(exp_dim, exp_dim, kernel, stride, pad,
                                               groups=exp_dim, bias=False))
        self.dw_bn = bn(exp_dim)
        self.se_reduce = channels_last_(nn.Conv2d(exp_dim, dim_se, 1))
        self.se_expand = channels_last_(nn.Conv2d(dim_se, exp_dim, 1))
        self.project_conv = channels_last_(nn.Conv2d(exp_dim, out_dim, 1, bias=False))
        self.project_bn = bn(out_dim)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        h = F.silu(self.expand_bn(conv_nhwc(self.expand_conv, x))) if self.expand else x
        if self.stride == 2:
            h = same_pad(h, self.kernel)
        h = F.silu(self.dw_bn(conv_nhwc(self.dwconv, h)))
        h = se_gate(self.se_reduce, self.se_expand, h, F.silu)
        h = self.project_bn(conv_nhwc(self.project_conv, h))
        if self.skip:
            h = drop_path(h, self.drop_path_rate, self.training, generator) + x
        return h


class EfficientNet(nn.Module):
    """width / depth (1.0, 1.0) → EfficientNet-B0."""

    def __init__(self, num_classes: Union[int, tuple[int, ...]] = 1000,
                 width_coefficient: float = 1.0, depth_coefficient: float = 1.0,
                 drop_connect_rate: float = 0.2, dropout_rate: float = 0.2,
                 se_ratio: float = 0.25, bn_momentum: float = 0.99, bn_eps: float = 1e-3,
                 stem_channels: int = 32, top_channels: int = 1280,
                 kernels: Sequence[int] = KERNELS, in_ch: Sequence[int] = IN_CH,
                 out_ch: Sequence[int] = OUT_CH, strides: Sequence[int] = STRIDES,
                 repeats: Sequence[int] = REPEATS, expands: Sequence[int] = EXPANDS,
                 dtype: torch.dtype = torch.bfloat16, remat: bool = False, seed: int = 0):
        super().__init__()
        self.width_coefficient, self.depth_coefficient = width_coefficient, depth_coefficient
        self.drop_connect_rate, self.dropout_rate = drop_connect_rate, dropout_rate
        self.stages = tuple(zip(kernels, in_ch, out_ch, strides, repeats, expands))
        self.dtype, self.remat = dtype, bool(remat)
        self.num_features = round_filters(top_channels, width_coefficient)
        stem = round_filters(stem_channels, width_coefficient)
        self.stem_conv = channels_last_(nn.Conv2d(3, stem, 3, 2, bias=False))
        self.stem_bn = BatchNorm(stem, bn_eps, bn_momentum)
        plan = self.block_plan()
        for idx, spec in enumerate(plan):
            self.add_module(f"block{idx}", MBConv(se_ratio=se_ratio, bn_momentum=bn_momentum,
                                                  bn_eps=bn_eps, **spec))
        self.depth = len(plan)
        self.top_conv = channels_last_(nn.Conv2d(plan[-1]["out_dim"], self.num_features, 1,
                                                 bias=False))
        self.top_bn = BatchNorm(self.num_features, bn_eps, bn_momentum)
        if isinstance(num_classes, tuple):
            self.head = MultitaskHead(self.num_features, num_classes)
        else:
            self.head = nn.Linear(self.num_features, num_classes)
        self.reset_parameters(seed)

    def block_plan(self) -> list[dict]:
        """The flattened per-block geometry, as hvt's ``block_plan`` writes it:
        the blocks of every stage in order, the drop rate linear in the flat
        index (``drop_connect_rate · idx / blocks``)."""
        d = self.depth_coefficient
        num_blocks = sum(round_repeats(s[4], d) for s in self.stages)
        plan = []
        for kernel, cin, cout, stride, repeats, expand in self.stages:
            in_dim = round_filters(cin, self.width_coefficient)
            out_dim = round_filters(cout, self.width_coefficient)
            for j in range(round_repeats(repeats, d)):
                plan.append(dict(
                    in_dim=out_dim if j > 0 else in_dim, out_dim=out_dim,
                    stride=1 if j > 0 else int(stride), expand_ratio=int(expand),
                    kernel=int(kernel), skip=j > 0,
                    drop_path=self.drop_connect_rate * len(plan) / num_blocks))
        return plan

    @property
    def no_weight_decay_substrings(self) -> tuple[str, ...]:
        """None: hvt's rule (decay iff ndim > 1) already spares BatchNorm and biases."""
        return ()

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """hvt's init from a torch.Generator seeded with ``seed``: conv and
        Dense kernels N(0, 0.02²), biases zero, BatchNorm ones and zeros,
        running mean 0 and var 1; a multitask head as hvt's."""
        gen = torch.Generator().manual_seed(seed)
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                module.weight.normal_(0.0, 0.02, generator=gen)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, BatchNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
        if isinstance(self.head, MultitaskHead):
            self.head.reset_parameters(gen)

    def cuda_unsupported(self, image_size: int, training: bool = False) -> list[str]:
        """None: no kernel of this repository runs in EfficientNet."""
        del image_size, training
        return []

    def forward(self, x: torch.Tensor, features_only: bool = False,
                generator: torch.Generator | None = None):
        """x: (B, H, W, 3) normalized image → logits (B, classes) f32, or one
        tensor per tier for a multitask head; ``features_only`` → the pooled
        (B, F) f32 features, before dropout. ``generator`` draws the
        stochastic-depth and dropout masks in train mode."""
        x = F.pad(x.to(self.dtype), (0, 0, 0, 1, 0, 1))
        x = F.silu(self.stem_bn(conv_nhwc(self.stem_conv, x)))
        remat = self.remat and self.training
        for idx in range(self.depth):
            block = getattr(self, f"block{idx}")
            x = recompute(block, x, generator) if remat else block(x, generator)
        x = F.silu(self.top_bn(conv_nhwc(self.top_conv, x)))
        feats = x.mean(dim=(1, 2)).float()
        if features_only:
            return feats
        if self.training and self.dropout_rate > 0.0:
            keep = 1.0 - self.dropout_rate
            kept = torch.rand(feats.shape, generator=generator, device=feats.device) < keep
            feats = torch.where(kept, feats / keep, torch.zeros_like(feats))
        if isinstance(self.head, MultitaskHead):
            return self.head(feats)
        return F.linear(feats, self.head.weight.float(), self.head.bias.float())


def _variant(width, depth, dropout=None, default_dtype="bfloat16", **geometry):
    def build(num_classes, *, blurpool: bool = False, dtype=default_dtype,
              **kwargs) -> EfficientNet:
        # the factory's uniform knobs, which hvt's builders drop
        del blurpool
        for knob in ("bn_scale_init", "use_pallas", "fuse"):
            kwargs.pop(knob, None)
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        if dropout is not None:  # the variant's own, as hvt passes it
            kwargs = dict(dropout_rate=dropout, **kwargs)
        return EfficientNet(num_classes=num_classes, width_coefficient=width,
                            depth_coefficient=depth, dtype=dtype, **geometry, **kwargs)

    return build


# timm/HF geometry for the efficientnet_b{0..5} names (width, depth,
# classifier dropout; the native resolutions 224-456 are the data config's).
efficientnet_b0 = _variant(1.0, 1.0, 0.2)
efficientnet_b1 = _variant(1.0, 1.1, 0.2)
efficientnet_b2 = _variant(1.1, 1.2, 0.3)
efficientnet_b3 = _variant(1.2, 1.4, 0.3)
efficientnet_b4 = _variant(1.4, 1.8, 0.4)
efficientnet_b5 = _variant(1.6, 2.2, 0.4)
# tests only: two tiny stages, one stride-2 5×5 (the asymmetric SAME pad),
# SE and one identity block, f32 by default
efficientnet_micro = _variant(1.0, 1.0, default_dtype="float32", stem_channels=8,
                              top_channels=64, kernels=(3, 5), in_ch=(8, 16), out_ch=(16, 24),
                              strides=(1, 2), repeats=(1, 2), expands=(1, 6))
