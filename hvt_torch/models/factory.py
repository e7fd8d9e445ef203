"""Model factory: config → nn.Module — port of ``hvt/models/factory.py``.

The port carries the SwinV2 and ResNet families. Every other name of hvt's
registry raises, naming the ROADMAP item that ports it. As in hvt, BlurPool
in the algorithms list sets ``blurpool``, and StochasticDepth sets a
ResNet's ``stochastic_depth_rate`` or a SwinV2's ``drop_path_rate``.
"""

from __future__ import annotations

from typing import Union

from hvt_torch.models import resnet, swinv2

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
_NOT_PORTED = {
    "vit_": "ROADMAP.md queue 1, item 9 (other model families)",
    "convnext_": "ROADMAP.md queue 1, item 9 (other model families)",
    "efficientnet_": "ROADMAP.md queue 1, item 9 (other model families)",
    "regnety_": "ROADMAP.md queue 1, item 9 (other model families)",
    "dinov2_": "ROADMAP.md queue 1, item 9 (other model families)",
}


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
    if name not in _SWIN + _RESNET:
        for prefix, item in _NOT_PORTED.items():
            if name.startswith(prefix):
                raise NotImplementedError(f"model {name!r} is not ported yet: {item}")
        raise ValueError(f"unknown model {name!r}; hvt_torch has {list(_SWIN + _RESNET)}")
    family = resnet if name in _RESNET else swinv2
    kwargs = dict(config.model.args)
    kwargs.setdefault("dtype", config.precision.compute_dtype)
    kwargs.setdefault("seed", config.seed)
    if family is swinv2:  # the size ``ape``'s embedding is made at, as hvt's init sample
        kwargs.setdefault("img_size", int(config.train_dataset.crop_size))
    for algo in config.algorithms:
        if algo.cls == "StochasticDepth":
            key = "stochastic_depth_rate" if family is resnet else "drop_path_rate"
            kwargs.setdefault(key, float(algo.args.get("drop_rate", 0.1)))
    blurpool = any(a.cls == "BlurPool" for a in config.algorithms)
    return getattr(family, name)(num_classes, blurpool=blurpool, **kwargs)

