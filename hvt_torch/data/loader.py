"""Eval-side dataset builder — port of the ``is_train=False`` half of
``hvt/data/loader.py``.

The serving path reads the split's classes and ``num_classes`` from here.
Batched iteration and the tree-distance matrix of hvt's eval
``DatasetInfo`` are not ported: no ported path reads them yet.
"""

from __future__ import annotations

import dataclasses

from hvt_torch.data import folder as folder_lib
from hvt_torch.data import synthetic as synthetic_lib
from hvt_torch.data import transforms as T


@dataclasses.dataclass(frozen=True)
class EvalLoader:
    """The eval split's dataset, its transform and the batch size."""

    dataset: object
    transform: T.EvalTransform
    batch_size: int


def build_dataset(config, is_train: bool = False):
    """Scan/construct the eval split's dataset → (dataset, DatasetInfo)."""
    if is_train:
        raise NotImplementedError("the training loader is a later slice of the port (ROADMAP.md queue 1)")
    data_cfg = config.eval_dataset
    hierarchical = config.hierarchy.variant == "multitask"
    if data_cfg.source == "synthetic":
        dataset = synthetic_lib.build_synthetic(
            num_samples=data_cfg.synthetic_num_samples,
            num_leaf_classes=data_cfg.synthetic_num_classes,
            crop_size=data_cfg.crop_size,
            hierarchical=hierarchical,
            seed=config.seed,
        )
    else:
        path = config.machine.datasets[data_cfg.path]
        dataset = folder_lib.scan_image_folder(path, "val", hierarchical=hierarchical)
    return dataset, folder_lib.DatasetInfo(dataset.num_classes)


def build_loader(config, is_train: bool = False):
    """Config → (EvalLoader, DatasetInfo) for the eval split."""
    dataset, info = build_dataset(config, is_train)
    data_cfg = config.eval_dataset
    transform = T.EvalTransform(crop_size=data_cfg.crop_size, resize_size=data_cfg.resize_size)
    return EvalLoader(dataset, transform, data_cfg.global_batch_size), info
