"""Model factory: config → nn.Module — port of ``hvt/models/factory.py``.

This slice carries the SwinV2 family. Every other name of hvt's registry
raises, naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from typing import Union

from hvt_torch.models import swinv2

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
_NOT_PORTED = {
    "resnet": "ROADMAP.md queue 1, item 7 (ResNet-50)",
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
    if name not in _SWIN:
        for prefix, item in _NOT_PORTED.items():
            if name.startswith(prefix):
                raise NotImplementedError(f"model {name!r} is not ported yet: {item}")
        raise ValueError(f"unknown model {name!r}; hvt_torch has {list(_SWIN)}")
    kwargs = dict(config.model.args)
    kwargs.setdefault("dtype", config.precision.compute_dtype)
    kwargs.setdefault("seed", config.seed)
    for algo in config.algorithms:
        if algo.cls == "StochasticDepth":
            kwargs.setdefault("drop_path_rate", float(algo.args.get("drop_rate", 0.1)))
    blurpool = any(a.cls == "BlurPool" for a in config.algorithms)
    return getattr(swinv2, name)(num_classes, blurpool=blurpool, **kwargs)

