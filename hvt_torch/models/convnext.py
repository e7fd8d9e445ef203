"""ConvNeXt in PyTorch — port of ``hvt/models/convnext.py``.

Same architecture, parameter tree and init as hvt: a 4×4/4 conv stem and
LayerNorm, four stages of blocks (7×7 depthwise conv → LayerNorm → the
pointwise 4× GELU MLP → layer scale ``gamma`` → stochastic-depth residual)
with a LayerNorm and 2×2/2 conv between stages, then the pooled features'
LayerNorm and a Dense or multitask head in f32. Module names mirror the
flax ones (``stem_conv``, ``stem_norm``, ``downsample{s}_norm``/``_conv``,
``stage{s}_block{i}.{dwconv,norm,mlp.fc1,mlp.fc2,gamma}``, ``norm``,
``head``); :func:`hvt_torch.models.convert.convnet_params_from_flax` maps a
flax tree onto them.

Arithmetic as hvt's: every LayerNorm is eps 1e-6 with its statistics in
f32 and its output in the compute dtype, except the final ``norm`` on the
pooled f32 features (pooled, then normed); ``gamma`` multiplies in the
compute dtype. Parameters stay f32, activations run in ``dtype``, NHWC end to
end, each convolution ``F.conv2d`` on the channels-last view with a
channels-last weight (:func:`~hvt_torch.models.common.conv_nhwc`).

hvt reaches no Pallas kernel here, and neither does the port: convolutions,
LayerNorms and products are torch's (cuDNN and cuBLAS on the card), so
:meth:`ConvNeXt.cuda_unsupported` is empty. ``remat`` runs every block under
:func:`~hvt_torch.models.common.recompute` in training. Stochastic depth
draws one mask a block from the caller's generator, at the per-block rates
``linspace(0, drop_path_rate, total)``.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from hvt_torch.models.common import (TransformerMlp, channels_last_, conv_nhwc, drop_path,
                                     layer_norm, recompute, trunc02_)
from hvt_torch.models.heads import MultitaskHead


class ConvNeXtBlock(nn.Module):
    """dwconv 7×7 → LN → fc1 (4×) → GELU → fc2 → γ· → drop-path residual."""

    def __init__(self, dim: int, drop_path: float = 0.0, layer_scale_init: float = 1e-6,
                 ln_eps: float = 1e-6):
        super().__init__()
        self.drop_path_rate = drop_path
        self.layer_scale_init = layer_scale_init
        self.dwconv = channels_last_(nn.Conv2d(dim, dim, 7, padding=3, groups=dim))
        self.norm = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = TransformerMlp(dim, 4 * dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        y = self.mlp(layer_norm(self.norm, conv_nhwc(self.dwconv, x)))
        y = y * self.gamma.to(y.dtype)
        return x + drop_path(y, self.drop_path_rate, self.training, generator)


class ConvNeXt(nn.Module):
    """depths (3, 3, 9, 3) / dims (96, 192, 384, 768) → ConvNeXt-T."""

    def __init__(self, num_classes: Union[int, tuple[int, ...]] = 1000,
                 depths: Sequence[int] = (3, 3, 9, 3), dims: Sequence[int] = (96, 192, 384, 768),
                 drop_path_rate: float = 0.0, layer_scale_init: float = 1e-6,
                 ln_eps: float = 1e-6, dtype: torch.dtype = torch.bfloat16, remat: bool = False,
                 seed: int = 0):
        super().__init__()
        self.depths, self.dims = tuple(depths), tuple(dims)
        self.dtype, self.remat = dtype, bool(remat)
        self.num_features = int(self.dims[-1])
        self.stem_conv = channels_last_(nn.Conv2d(3, self.dims[0], 4, stride=4))
        self.stem_norm = nn.LayerNorm(self.dims[0], eps=ln_eps)
        rates = np.linspace(0, drop_path_rate, sum(self.depths)).tolist()
        self.stages: list[tuple[str | None, list[str]]] = []
        for stage, (depth, dim) in enumerate(zip(self.depths, self.dims)):
            down = None
            if stage > 0:
                down = f"downsample{stage}"
                self.add_module(f"{down}_norm", nn.LayerNorm(self.dims[stage - 1], eps=ln_eps))
                self.add_module(f"{down}_conv", channels_last_(
                    nn.Conv2d(self.dims[stage - 1], dim, 2, stride=2)))
            names = []
            for i in range(depth):
                names.append(f"stage{stage}_block{i}")
                self.add_module(names[-1], ConvNeXtBlock(dim, rates.pop(0), layer_scale_init,
                                                         ln_eps))
            self.stages.append((down, names))
        self.norm = nn.LayerNorm(self.num_features, eps=ln_eps)
        if isinstance(num_classes, tuple):
            self.head = MultitaskHead(self.num_features, num_classes)
        else:
            self.head = nn.Linear(self.num_features, num_classes)
        self.reset_parameters(seed)

    @property
    def no_weight_decay_substrings(self) -> tuple[str, ...]:
        """None: hvt's rule (decay iff ndim > 1) already spares the 1-D gamma,
        the LayerNorms and the biases."""
        return ()

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """hvt's init from a torch.Generator seeded with ``seed``: conv and
        Dense kernels trunc_normal(0.02), biases zero, LayerNorms ones and
        zeros, ``gamma`` at ``layer_scale_init``; a multitask head as hvt's."""
        gen = torch.Generator().manual_seed(seed)
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                trunc02_(module.weight, gen)
                module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, ConvNeXtBlock):
                module.gamma.fill_(module.layer_scale_init)
        if isinstance(self.head, MultitaskHead):
            self.head.reset_parameters(gen)

    def cuda_unsupported(self, image_size: int, training: bool = False) -> list[str]:
        """None: no kernel of this repository runs in ConvNeXt."""
        del image_size, training
        return []

    def forward(self, x: torch.Tensor, features_only: bool = False,
                generator: torch.Generator | None = None):
        """x: (B, H, W, 3) normalized image → logits (B, classes) f32, or one
        tensor per tier for a multitask head; ``features_only`` → the pooled,
        normed (B, F) f32 features. ``generator`` draws the stochastic-depth
        masks in train mode."""
        x = layer_norm(self.stem_norm, conv_nhwc(self.stem_conv, x.to(self.dtype)))
        remat = self.remat and self.training
        for down, names in self.stages:
            if down is not None:
                x = conv_nhwc(getattr(self, f"{down}_conv"),
                              layer_norm(getattr(self, f"{down}_norm"), x))
            for name in names:
                block = getattr(self, name)
                x = recompute(block, x, generator) if remat else block(x, generator)
        feats = F.layer_norm(x.mean(dim=(1, 2)).float(), self.norm.normalized_shape,
                             self.norm.weight, self.norm.bias, self.norm.eps)
        if features_only:
            return feats
        if isinstance(self.head, MultitaskHead):
            return self.head(feats)
        return F.linear(feats, self.head.weight.float(), self.head.bias.float())


def _variant(depths, dims, default_dtype="bfloat16"):
    def build(num_classes, *, blurpool: bool = False, dtype=default_dtype, **kwargs) -> ConvNeXt:
        # the factory's uniform knobs, which hvt's builders drop
        del blurpool
        for knob in ("bn_scale_init", "use_pallas", "fuse"):
            kwargs.pop(knob, None)
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        return ConvNeXt(num_classes=num_classes, depths=depths, dims=dims, dtype=dtype, **kwargs)

    return build


# timm/HF geometry for the convnext_{tiny,small,base,large} names.
convnext_tiny = _variant((3, 3, 9, 3), (96, 192, 384, 768))
convnext_small = _variant((3, 3, 27, 3), (96, 192, 384, 768))
convnext_base = _variant((3, 3, 27, 3), (128, 256, 512, 1024))
convnext_large = _variant((3, 3, 27, 3), (192, 384, 768, 1536))
convnext_micro = _variant((1, 1, 2, 1), (16, 32, 64, 128))  # tests only
