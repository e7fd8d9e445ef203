"""ResNet v1.5 in PyTorch — port of ``hvt/models/resnet.py``.

Same architecture, parameter tree and init as hvt: the 7×7/2 stem and a
3×3/2 max-pool (BlurMaxPool with ``blurpool``), bottleneck blocks (1×1 →
3×3 with the stride → 1×1×4, projection shortcut) with linear per-block
stochastic depth, or basic blocks for the ``resnet18/34`` family; global
average pool and a Dense or multitask head in f32. Module names mirror the
flax ones (``stem``, ``stage{s}_block{b}.conv{i}``, ``downsample``, each a
ConvBN of ``conv`` and ``bn``); :mod:`hvt_torch.models.convert` maps a flax
tree onto them.

Init, drawn from a torch.Generator seeded with ``seed``: kaiming-normal
(fan-in) conv and dense kernels, zero biases, and BatchNorm scale ~ U(0, 1)
(hvt's ``uniform01``, the reference's quirk) unless ``bn_scale_init:
ones``.

Layout: NHWC end to end. Parameters stay f32, activations run in ``dtype``.
Each convolution is ``F.conv2d`` on the channels-last NCHW view of the NHWC
tensor with a channels-last weight (cuDNN's NHWC kernels on the card), so it
returns NHWC memory and each BatchNorm input is a free (rows, C) view.
BatchNorm is picked as hvt's ``make_batch_norm`` picks it (:func:`batch_norm`):
``bn_groups`` > 1 → :class:`~hvt_torch.models.common.GroupedBatchNorm`;
else ``bn_pallas`` → :class:`~hvt_torch.models.common.PallasBatchNorm`,
whose training reductions run the BatchNorm kernels (``csrc/bn_stats.cu``)
on the card; else ``bn_custom`` →
:class:`~hvt_torch.models.common.CustomBatchNorm` (the same backward, torch's
reductions); else :class:`~hvt_torch.models.common.BatchNorm` (torch's batch
norm with flax's running statistics). Eval uses the running statistics and
no kernel.

``remat_stages`` (1-based) runs each block of the listed stages under
:func:`~hvt_torch.models.common.recompute` in training, as hvt's
``maybe_remat``; ``remat_policy`` is "nothing" or "dots", the same here.

``stem_s2d``: hvt computes the 7×7/2 stem as a 4×4/1 conv over
space-to-depth input, a TPU tiling trick with the same math; here it is the
plain 7×7/2 conv, over the same (7, 7, 3, width) kernel. Under int8
(:mod:`hvt_torch.ops.quant`) every ConvBN conv runs int8, the stem too, but
with ``stem_s2d``, whose kernel hvt multiplies as a raw parameter, outside
its int8 rewrite (``int8_full_precision``).
"""

from __future__ import annotations

import math
import warnings
from typing import Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from hvt_torch.models import common
from hvt_torch.models.common import PallasBatchNorm, drop_path
from hvt_torch.models.heads import MultitaskHead
from hvt_torch.ops import bn_stats_cuda

BN_SCALE_INITS = ("uniform01", "ones")


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def blur_2d(x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Depthwise 3×3 binomial blur of an NHWC tensor, zero padding 1,
    optionally strided (BlurPool's anti-aliased subsample)."""
    c = x.shape[-1]
    k1 = torch.tensor([1.0, 2.0, 1.0], device=x.device)
    k2 = torch.outer(k1, k1) / 16.0
    kernel = k2.to(x.dtype).expand(c, 1, 3, 3)
    y = F.conv2d(_nchw(x), kernel, stride=stride, padding=1, groups=c)
    return _nhwc(y).contiguous()  # a no-op where the conv returned NHWC memory


def max_pool_3x3(x: torch.Tensor, stride: int) -> torch.Tensor:
    return _nhwc(F.max_pool2d(_nchw(x), 3, stride, 1))


def batch_norm(channels: int, bn: dict) -> common._BatchNormBase:
    """hvt's ``make_batch_norm``: ``bn_groups`` > 1 wins, then ``bn_pallas``,
    then ``bn_custom``, else the default BatchNorm. ``bn`` holds the three
    knobs."""
    if bn["bn_groups"] > 1:
        return common.GroupedBatchNorm(channels, bn["bn_groups"])
    if bn["bn_pallas"]:
        return common.PallasBatchNorm(channels)
    if bn["bn_custom"]:
        return common.CustomBatchNorm(channels)
    return common.BatchNorm(channels)


_DEFAULT_BN = {"bn_groups": 1, "bn_pallas": False, "bn_custom": False}


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm + optional ReLU; with ``blurpool`` a strided
    conv blurs its input first (Composer's BlurConv2d). flax names the conv
    ``Conv_0`` (``flax_names``, the int8 layer keys)."""

    flax_names = {"conv": "Conv_0"}

    def __init__(self, in_ch: int, features: int, kernel_size: int, stride: int = 1,
                 act: bool = True, blurpool: bool = False, bn: dict = _DEFAULT_BN):
        super().__init__()
        self.act = act
        self.blur = blurpool and stride > 1
        self.conv = common.channels_last_(
            nn.Conv2d(in_ch, features, kernel_size, stride, kernel_size // 2, bias=False))
        self.bn = batch_norm(features, bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.blur:
            x = blur_2d(x)
        y = self.bn(common.conv_nhwc(self.conv, x))
        return F.relu(y) if self.act else y


class Bottleneck(nn.Module):
    """1×1 → 3×3 (stride) → 1×1×4 bottleneck with a projection shortcut where
    the shape changes, and stochastic depth on the residual branch."""

    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int = 1, blurpool: bool = False,
                 drop_path_rate: float = 0.0, bn: dict = _DEFAULT_BN):
        super().__init__()
        out = features * 4
        conv = lambda *a, **k: ConvBN(*a, blurpool=blurpool, bn=bn, **k)  # noqa: E731
        self.downsample = (conv(in_ch, out, 1, stride, act=False)
                           if in_ch != out or stride != 1 else None)
        self.conv1 = conv(in_ch, features, 1)
        self.conv2 = conv(features, features, 3, stride)
        self.conv3 = conv(features, out, 1, act=False)
        self.drop_path_rate = drop_path_rate

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        shortcut = x if self.downsample is None else self.downsample(x)
        y = self.conv3(self.conv2(self.conv1(x)))
        y = drop_path(y, self.drop_path_rate, self.training, generator)
        return F.relu(y + shortcut)


class BasicBlock(nn.Module):
    """3×3 (stride) → 3×3 with a projection shortcut where the shape changes."""

    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int = 1, blurpool: bool = False,
                 drop_path_rate: float = 0.0, bn: dict = _DEFAULT_BN):
        super().__init__()
        del drop_path_rate  # hvt's basic blocks have no stochastic depth
        conv = lambda *a, **k: ConvBN(*a, blurpool=blurpool, bn=bn, **k)  # noqa: E731
        self.downsample = (conv(in_ch, features, 1, stride, act=False)
                           if in_ch != features or stride != 1 else None)
        self.conv1 = conv(in_ch, features, 3, stride)
        self.conv2 = conv(features, features, 3, act=False)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        shortcut = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv2(self.conv1(x)) + shortcut)


class ResNet(nn.Module):
    """ResNet v1.5; ``stage_sizes`` (3, 4, 6, 3) is ResNet-50."""

    block = Bottleneck

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_classes: Union[int, tuple[int, ...]] = 1000, width: int = 64,
                 blurpool: bool = False, stochastic_depth_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, bn_scale_init: str = "uniform01",
                 bn_pallas: bool = False, seed: int = 0, bn_groups: int = 1,
                 bn_custom: bool = False, remat_stages: Sequence[int] = (),
                 remat_policy: str = "nothing", stem_s2d: bool = False):
        super().__init__()
        # hvt's space-to-depth stem multiplies its kernel as a raw parameter
        self.int8_full_precision = ("stem",) if stem_s2d else ()
        if bn_scale_init not in BN_SCALE_INITS:
            raise ValueError(f"bn_scale_init {bn_scale_init!r}: one of {BN_SCALE_INITS}")
        self.stage_sizes = tuple(stage_sizes)
        self.width, self.blurpool = width, blurpool
        self.dtype, self.bn_scale_init, self.bn_pallas = dtype, bn_scale_init, bn_pallas
        remat_stages = tuple(int(s) for s in remat_stages)
        if remat_stages:
            common.remat_policy(remat_policy)  # hvt looks the policy up only where it remats
        bn = {"bn_groups": int(bn_groups), "bn_pallas": bool(bn_pallas),
              "bn_custom": bool(bn_custom)}
        # Composer's BlurPool leaves the stem conv alone
        self.stem = ConvBN(3, width, 7, stride=2, bn=bn)
        self.layer_names: list[str] = []
        self.remat_names: set[str] = set()
        total, in_ch = sum(self.stage_sizes), width
        for stage, blocks in enumerate(self.stage_sizes):
            for block in range(blocks):
                name = f"stage{stage + 1}_block{block}"
                rate = stochastic_depth_rate * len(self.layer_names) / max(total - 1, 1)
                features = width * 2 ** stage
                self.add_module(name, self.block(in_ch, features, 2 if stage > 0 and block == 0 else 1,
                                                 blurpool, rate, bn))
                self.layer_names.append(name)
                if stage + 1 in remat_stages:
                    self.remat_names.add(name)
                in_ch = features * self.block.expansion
        self.num_features = in_ch
        if isinstance(num_classes, tuple):
            self.head = MultitaskHead(in_ch, num_classes)
        else:
            self.head = nn.Linear(in_ch, num_classes)
        self.reset_parameters(seed)

    @property
    def no_weight_decay_substrings(self) -> tuple[str, ...]:
        """None: hvt's rule (decay iff ndim > 1) already spares BatchNorm and biases."""
        return ()

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """hvt's init from a torch.Generator seeded with ``seed``: conv and
        dense kernels N(0, 2/fan_in), zero dense bias, BatchNorm scale U(0, 1)
        (or ones), zero BatchNorm bias, running mean 0 and var 1."""
        gen = torch.Generator().manual_seed(seed)
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                module.weight.normal_(0.0, math.sqrt(2.0 / module.weight[0].numel()), generator=gen)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, common._BatchNormBase):
                if self.bn_scale_init == "uniform01":
                    module.weight.uniform_(0.0, 1.0, generator=gen)
                else:
                    module.weight.fill_(1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)

    def cuda_unsupported(self, image_size: int, training: bool = False) -> list[str]:
        """Why the CUDA kernels cannot run this model: one line per BatchNorm
        whose width the BatchNorm kernels do not take, where the model
        trains with ``bn_pallas``. Eval and the default BatchNorm run no
        kernel of this repository."""
        del image_size  # convolutions and pooling take any size
        if not (training and self.bn_pallas):
            return []
        found = []
        for name, module in self.named_modules():
            if isinstance(module, PallasBatchNorm) and not module.torch_reductions:
                why = bn_stats_cuda.unsupported(module.weight.shape[0])
                if why:
                    found.append(f"{name}: {why}")
        return found

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        if self.blurpool:  # BlurMaxPool: stride-1 max-pool, then the blurred subsample
            return blur_2d(max_pool_3x3(x, 1), stride=2)
        return max_pool_3x3(x, 2)

    def forward(self, x: torch.Tensor, features_only: bool = False,
                generator: torch.Generator | None = None):
        """x: (B, H, W, 3) normalized image → logits (B, classes) f32, or one
        tensor per tier for a multitask head; ``features_only`` → the pooled
        (B, F) f32 features. ``generator`` draws the stochastic-depth masks
        in train mode; the blocks of ``remat_stages`` run under ``recompute``
        in train mode."""
        x = self._stem(x.to(self.dtype))
        for name in self.layer_names:
            block = getattr(self, name)
            if self.training and name in self.remat_names:
                x = common.recompute(block, x, generator)
            else:
                x = block(x, generator)
        x = x.mean(dim=(1, 2)).float()
        if features_only:
            return x
        if isinstance(self.head, MultitaskHead):
            return self.head(x)
        return F.linear(x, self.head.weight.float(), self.head.bias.float())


class BasicResNet(ResNet):
    """ResNet with basic (2-conv) blocks — the resnet18/34 family; always the
    plain stem, no stochastic depth."""

    block = BasicBlock


def _dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _bottleneck(stage_sizes, width=64, default_dtype="bfloat16", default_scale="uniform01"):
    def build(num_classes, *, blurpool: bool = False, stochastic_depth_rate: float = 0.0,
              stem_s2d: bool = False, dtype=default_dtype, bn_scale_init: str = default_scale,
              bn_groups: int = 1, bn_pallas: bool = False, bn_custom: bool = False,
              remat_stages: Sequence[int] = (), remat_policy: str = "nothing", seed: int = 0,
              **unused) -> ResNet:
        del unused
        return ResNet(stage_sizes, num_classes, width, blurpool, float(stochastic_depth_rate),
                      _dtype(dtype), bn_scale_init, bool(bn_pallas), seed, bn_groups,
                      bn_custom, remat_stages, remat_policy, bool(stem_s2d))

    return build


def _basic(name, stage_sizes, width=64, default_dtype="bfloat16", default_scale="uniform01"):
    def build(num_classes, *, blurpool: bool = False, dtype=default_dtype,
              bn_scale_init: str = default_scale, seed: int = 0, **unused) -> BasicResNet:
        if unused.get("stochastic_depth_rate"):
            warnings.warn(
                f"{name} (BasicResNet) ignores stochastic_depth_rate="
                f"{unused['stochastic_depth_rate']}; only the bottleneck family "
                "(resnet50) implements stochastic depth", stacklevel=2)
        return BasicResNet(stage_sizes, num_classes, width, blurpool, 0.0, _dtype(dtype),
                           bn_scale_init, bool(unused.get("bn_pallas", False)), seed,
                           int(unused.get("bn_groups", 1)), bool(unused.get("bn_custom", False)),
                           tuple(unused.get("remat_stages", ())),
                           str(unused.get("remat_policy", "nothing")))

    return build


resnet50 = _bottleneck((3, 4, 6, 3))
resnet101 = _bottleneck((3, 4, 23, 3))
resnet152 = _bottleneck((3, 8, 36, 3))
resnet34 = _basic("resnet34", (3, 4, 6, 3))
resnet18 = _basic("resnet18", (2, 2, 2, 2))
# tiny 2-stage models for tests and CPU runs; the bottleneck one carries the
# whole resnet50 block family (stochastic depth, blurpool, the stem knob)
resnet_micro_bottleneck = _bottleneck((1, 1), width=8, default_dtype="float32",
                                      default_scale="ones")
resnet_micro = _basic("resnet_micro", (1, 1), width=8, default_dtype="float32",
                      default_scale="ones")
