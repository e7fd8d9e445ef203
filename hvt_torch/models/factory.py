"""Model factory: config → nn.Module — port of ``hvt/models/factory.py``.

The port carries the SwinV2, ResNet, ViT and DINOv2 families. Every other
name of hvt's registry raises, naming the ROADMAP item that ports it. As in
hvt, BlurPool in the algorithms list sets ``blurpool``, and StochasticDepth
sets a ResNet's ``stochastic_depth_rate`` or another family's
``drop_path_rate``. SwinV2's ``ape`` embedding and ViT's and DINOv2's
``pos_embed`` are made at the train crop (``img_size``), the size hvt's
init sample has.
"""

from __future__ import annotations

from typing import Union

from hvt_torch.models import dinov2, resnet, swinv2, vit

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
_FAMILIES = {**{n: swinv2 for n in _SWIN}, **{n: resnet for n in _RESNET},
             **{n: vit for n in _VIT}, **{n: dinov2 for n in _DINOV2}}
_ITEM_9B = "ROADMAP.md queue 1, item 9b (ConvNeXt, EfficientNet, RegNet)"
_NOT_PORTED = {"convnext_": _ITEM_9B, "efficientnet_": _ITEM_9B, "regnety_": _ITEM_9B}


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
    if name not in _FAMILIES:
        for prefix, item in _NOT_PORTED.items():
            if name.startswith(prefix):
                raise NotImplementedError(f"model {name!r} is not ported yet: {item}")
        raise ValueError(f"unknown model {name!r}; hvt_torch has {list(_FAMILIES)}")
    family = _FAMILIES[name]
    kwargs = dict(config.model.args)
    kwargs.setdefault("dtype", config.precision.compute_dtype)
    kwargs.setdefault("seed", config.seed)
    if family is not resnet:  # the size position embeddings are made at
        kwargs.setdefault("img_size", int(config.train_dataset.crop_size))
    for algo in config.algorithms:
        if algo.cls == "StochasticDepth":
            key = "stochastic_depth_rate" if family is resnet else "drop_path_rate"
            kwargs.setdefault(key, float(algo.args.get("drop_rate", 0.1)))
    blurpool = any(a.cls == "BlurPool" for a in config.algorithms)
    return getattr(family, name)(num_classes, blurpool=blurpool, **kwargs)

