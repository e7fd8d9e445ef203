"""RegNet-Y in PyTorch — port of ``hvt/models/regnet.py``.

Same architecture, parameter tree and init as hvt: a 3×3/2 conv stem with
BatchNorm and ReLU, four stages of Y blocks (1×1 → grouped 3×3 with the
stride → squeeze-excite → 1×1, BatchNorm and ReLU, a projection shortcut
where the shape changes, a post-add ReLU), then the pooled features into a
Dense or multitask head in f32. Module names mirror the flax ones
(``stem_conv``, ``stem_bn``, ``stage{s}_block{i}.{conv1,bn1,conv2,bn2,
se_reduce,se_expand,conv3,bn3,sc_conv,sc_bn}``, ``head``);
:func:`hvt_torch.models.convert.convnet_params_from_flax` maps a flax tree
(params and ``batch_stats``) onto them.

As hvt: the 3×3 convs pad 1 on every side (torch's padding, which hvt writes
as an explicit pad and a VALID conv where the stride is 2); groups =
max(1, out // group_width); the squeeze-excite width is round(in / 4) of
the block's *input*, its two 1×1 convs with biases; BatchNorm is flax's, at
momentum 0.9 and eps 1e-5 (:class:`~hvt_torch.models.common.BatchNorm`,
torch's batch norm with flax's running statistics). Parameters stay f32,
activations run in ``dtype``, NHWC end to end, each convolution
``F.conv2d`` on the channels-last view with a channels-last weight.

hvt reaches no Pallas kernel here (its BatchNorms are flax ``nn.BatchNorm``),
and neither does the port: :meth:`RegNetY.cuda_unsupported` is empty.
``remat`` runs every block under :func:`~hvt_torch.models.common.recompute`
in training. RegNet-Y has no stochastic depth: ``drop_path_rate`` (which
StochasticDepth would set) raises, as in hvt.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from hvt_torch.models.common import (BatchNorm, channels_last_, conv_nhwc, lecun_normal_, recompute,
                                     se_gate)
from hvt_torch.models.heads import MultitaskHead


class YBlock(nn.Module):
    """1×1 → grouped 3×3 (stride) → SE → 1×1, BatchNorm + ReLU, post-add ReLU."""

    def __init__(self, in_dim: int, out_dim: int, stride: int, group_width: int,
                 bn_momentum: float = 0.9, bn_eps: float = 1e-5):
        super().__init__()
        groups = max(1, out_dim // group_width)
        dim_se = max(1, int(round(in_dim / 4)))

        def bn(c):
            return BatchNorm(c, bn_eps, bn_momentum)

        self.conv1 = channels_last_(nn.Conv2d(in_dim, out_dim, 1, bias=False))
        self.bn1 = bn(out_dim)
        self.conv2 = channels_last_(nn.Conv2d(out_dim, out_dim, 3, stride, 1, groups=groups,
                                              bias=False))
        self.bn2 = bn(out_dim)
        self.se_reduce = channels_last_(nn.Conv2d(out_dim, dim_se, 1))
        self.se_expand = channels_last_(nn.Conv2d(dim_se, out_dim, 1))
        self.conv3 = channels_last_(nn.Conv2d(out_dim, out_dim, 1, bias=False))
        self.bn3 = bn(out_dim)
        self.projection = in_dim != out_dim or stride != 1
        if self.projection:
            self.sc_conv = channels_last_(nn.Conv2d(in_dim, out_dim, 1, stride, bias=False))
            self.sc_bn = bn(out_dim)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        del generator  # no stochastic depth in RegNet-Y
        h = F.relu(self.bn1(conv_nhwc(self.conv1, x)))
        h = F.relu(self.bn2(conv_nhwc(self.conv2, h)))
        h = se_gate(self.se_reduce, self.se_expand, h, F.relu)
        h = self.bn3(conv_nhwc(self.conv3, h))
        sc = self.sc_bn(conv_nhwc(self.sc_conv, x)) if self.projection else x
        return F.relu(h + sc)


class RegNetY(nn.Module):
    """depths (2, 6, 12, 2) / widths (128, 192, 512, 1088) / group 64 → Y-4.0GF."""

    def __init__(self, num_classes: Union[int, tuple[int, ...]] = 1000,
                 depths: Sequence[int] = (2, 6, 12, 2),
                 widths: Sequence[int] = (128, 192, 512, 1088), group_width: int = 64,
                 stem_channels: int = 32, downsample_in_first_stage: bool = True,
                 bn_momentum: float = 0.9, bn_eps: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16, remat: bool = False, seed: int = 0):
        super().__init__()
        self.depths, self.widths = tuple(depths), tuple(widths)
        self.dtype, self.remat = dtype, bool(remat)
        self.num_features = int(self.widths[-1])
        self.stem_conv = channels_last_(nn.Conv2d(3, stem_channels, 3, 2, 1, bias=False))
        self.stem_bn = BatchNorm(stem_channels, bn_eps, bn_momentum)
        self.layer_names: list[str] = []
        in_dim = stem_channels
        for stage, (depth, width) in enumerate(zip(self.depths, self.widths)):
            first_stride = 2 if stage > 0 or downsample_in_first_stage else 1
            for i in range(depth):
                self.layer_names.append(f"stage{stage}_block{i}")
                self.add_module(self.layer_names[-1], YBlock(
                    in_dim, width, first_stride if i == 0 else 1, group_width, bn_momentum,
                    bn_eps))
                in_dim = width
        if isinstance(num_classes, tuple):
            self.head = MultitaskHead(self.num_features, num_classes)
        else:
            self.head = nn.Linear(self.num_features, num_classes)
        self.reset_parameters(seed)

    @property
    def no_weight_decay_substrings(self) -> tuple[str, ...]:
        """None: hvt's rule (decay iff ndim > 1) already spares BatchNorm and biases."""
        return ()

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """hvt's init from a torch.Generator seeded with ``seed``: conv kernels
        variance_scaling(2, fan_out, "normal"), N(0, 2 / fan-out) with
        fan-out = out channels × kernel area, conv biases zero, the Dense
        head lecun_normal (truncated) with a zero bias, BatchNorm ones and
        zeros, running mean 0 and var 1; a multitask head as hvt's."""
        gen = torch.Generator().manual_seed(seed)
        for module in self.modules():
            if isinstance(module, nn.Conv2d):
                w = module.weight
                w.normal_(0.0, (2.0 / (w.shape[0] * w.shape[2] * w.shape[3])) ** 0.5, generator=gen)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, BatchNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
        if isinstance(self.head, MultitaskHead):
            self.head.reset_parameters(gen)
        else:
            lecun_normal_(self.head.weight, gen)
            self.head.bias.zero_()

    def cuda_unsupported(self, image_size: int, training: bool = False) -> list[str]:
        """None: no kernel of this repository runs in RegNet-Y."""
        del image_size, training
        return []

    def forward(self, x: torch.Tensor, features_only: bool = False,
                generator: torch.Generator | None = None):
        """x: (B, H, W, 3) normalized image → logits (B, classes) f32, or one
        tensor per tier for a multitask head; ``features_only`` → the pooled
        (B, F) f32 features."""
        x = F.relu(self.stem_bn(conv_nhwc(self.stem_conv, x.to(self.dtype))))
        remat = self.remat and self.training
        for name in self.layer_names:
            block = getattr(self, name)
            x = recompute(block, x, generator) if remat else block(x, generator)
        feats = x.mean(dim=(1, 2)).float()
        if features_only:
            return feats
        if isinstance(self.head, MultitaskHead):
            return self.head(feats)
        return F.linear(feats, self.head.weight.float(), self.head.bias.float())


def _variant(depths, widths, group_width, stem_channels=32, default_dtype="bfloat16"):
    def build(num_classes, *, blurpool: bool = False, dtype=default_dtype, **kwargs) -> RegNetY:
        # the factory's uniform knobs, which hvt's builders drop
        del blurpool
        for knob in ("bn_scale_init", "use_pallas", "fuse"):
            kwargs.pop(knob, None)
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        return RegNetY(num_classes=num_classes, depths=depths, widths=widths,
                       group_width=group_width, stem_channels=stem_channels, dtype=dtype,
                       **kwargs)

    return build


# pycls/torchvision/HF geometry for the regnety_* names (timm spelling;
# suffix = design-space compute budget).
regnety_004 = _variant((1, 3, 6, 6), (48, 104, 208, 440), 8)
regnety_008 = _variant((1, 3, 8, 2), (64, 128, 320, 768), 16)
regnety_016 = _variant((2, 6, 17, 2), (48, 120, 336, 888), 24)
regnety_040 = _variant((2, 6, 12, 2), (128, 192, 512, 1088), 64)
regnety_080 = _variant((2, 4, 10, 1), (168, 448, 896, 2016), 56)
regnety_160 = _variant((2, 4, 11, 1), (224, 448, 1232, 3024), 112)
regnety_320 = _variant((2, 5, 13, 1), (232, 696, 1392, 3712), 232)
# tests only: two tiny stages (one stride-2 grouped 3×3, SE, one identity
# block), an 8-channel stem, f32 by default
regnety_micro = _variant((1, 2), (16, 24), 8, stem_channels=8, default_dtype="float32")
