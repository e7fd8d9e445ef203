"""Model factory: config → nn.Module — port of ``hvt/models/factory.py``.

The port carries every family of hvt's registry: SwinV2, ResNet, ViT,
DINOv2, ConvNeXt, EfficientNet and RegNet-Y. As in hvt, BlurPool in the
algorithms list sets ``blurpool``, and StochasticDepth sets a ResNet's
``stochastic_depth_rate`` or another family's ``drop_path_rate`` (which
RegNet-Y and EfficientNet do not take: they raise, as hvt's do). SwinV2's
``ape`` embedding and ViT's and DINOv2's ``pos_embed`` are made at the train
crop (``img_size``), the size hvt's init sample has; no other family takes
it.

Beyond the registry, hvt's open name ``module.path:symbol`` resolves by
import to a builder with the registry's signature, ``builder(num_classes, *,
blurpool, dtype, seed, **model.args) -> nn.Module``; the Trainer also reads
the model's ``cuda_unsupported(image_size, training)`` and
``no_weight_decay_substrings``.
"""

from __future__ import annotations

import importlib
from typing import Union

from hvt_torch.models import convnext, dinov2, efficientnet, regnet, resnet, swinv2, vit

VALID_VARIANTS = (
    "full-tuning",
    "linear-probe",
    "simpleshot",
    "simpleshot-l2n",
    "simpleshot-cl2n",
)

_SWIN = (
    "swinv2_micro",
    "swinv2_micro_deep",
    "swinv2_tiny",
    "swinv2_tiny_window8_256",
    "swinv2_tiny_window16_256",
    "swinv2_small",
    "swinv2_base",
    "swinv2_large",
    "swinv2_large_window12_192",
)
_RESNET = (
    "resnet50",
    "resnet101",
    "resnet152",
    "resnet34",
    "resnet18",
    "resnet_micro",
    "resnet_micro_bottleneck",
)
_VIT = (
    "vit_tiny_patch16_224",
    "vit_small_patch16_224",
    "vit_base_patch16_224",
    "vit_base_patch32_224",
    "vit_large_patch16_224",
    "vit_micro",
)
_DINOV2 = ("dinov2_vits14", "dinov2_vitb14", "dinov2_vitl14", "dinov2_vitg14", "dinov2_micro")
_CONVNEXT = ("convnext_tiny", "convnext_small", "convnext_base", "convnext_large",
             "convnext_micro")
_EFFICIENTNET = tuple(f"efficientnet_b{i}" for i in range(6)) + ("efficientnet_micro",)
_REGNET = ("regnety_004", "regnety_008", "regnety_016", "regnety_040", "regnety_080",
           "regnety_160", "regnety_320", "regnety_micro")
_FAMILIES = {**{n: swinv2 for n in _SWIN}, **{n: resnet for n in _RESNET},
             **{n: vit for n in _VIT}, **{n: dinov2 for n in _DINOV2},
             **{n: convnext for n in _CONVNEXT}, **{n: efficientnet for n in _EFFICIENTNET},
             **{n: regnet for n in _REGNET}}
_SIZED = (swinv2, vit, dinov2)  # the families whose embeddings are made at the train crop


def _open_builder(name: str):
    """hvt's open-name escape hatch: ``module.path:symbol`` → the builder."""
    module_name, _, symbol = name.partition(":")
    try:
        module = importlib.import_module(module_name)
    except ImportError as e:
        raise ValueError(f"model {name!r}: cannot import module {module_name!r}") from e
    builder = getattr(module, symbol, None)
    if not callable(builder):
        raise ValueError(
            f"model {name!r}: {module_name}.{symbol} is not a callable "
            "model builder (expected builder(num_classes, **kwargs))")
    return builder


def build_model(config, num_classes: Union[int, tuple[int, ...]]):
    """The model of ``config.model`` on the CPU with seeded init
    (``config.seed``); the caller moves it to its device. Multitask requires
    hierarchy.variant = multitask."""
    if isinstance(num_classes, tuple) and config.hierarchy.variant != "multitask":
        raise ValueError("tuple num_classes requires hierarchy.variant == 'multitask'")
    if config.model.variant not in VALID_VARIANTS:
        raise ValueError(
            f"unknown model.variant {config.model.variant!r} (valid: {VALID_VARIANTS})"
        )
    name = config.model.name
    family = _FAMILIES.get(name)
    if family is not None:
        builder = getattr(family, name)
    elif ":" in name:
        builder = _open_builder(name)
    else:
        raise ValueError(
            f"unknown model {name!r}; hvt_torch has {list(_FAMILIES)}, or the open-name "
            "form 'module.path:symbol' resolves a builder by import")
    kwargs = dict(config.model.args)
    kwargs.setdefault("dtype", config.precision.compute_dtype)
    kwargs.setdefault("seed", config.seed)
    if family in _SIZED:
        kwargs.setdefault("img_size", int(config.train_dataset.crop_size))
    for algo in config.algorithms:
        if algo.cls == "StochasticDepth":
            key = "stochastic_depth_rate" if name.startswith("resnet") else "drop_path_rate"
            kwargs.setdefault(key, float(algo.args.get("drop_rate", 0.1)))
    blurpool = any(a.cls == "BlurPool" for a in config.algorithms)
    return builder(num_classes, blurpool=blurpool, **kwargs)
