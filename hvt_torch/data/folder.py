"""ImageFolder scanning with flat or hierarchical (7-tier) labels — port of
``hvt/data/folder.py``."""

from __future__ import annotations

import dataclasses
import os
import pathlib
from typing import Optional, Sequence

import numpy as np

from hvt_torch import hierarchy

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp", ".ppm", ".tif", ".tiff")


@dataclasses.dataclass(frozen=True)
class DatasetInfo:
    """num_classes: an int (flat) or per-tier counts (multitask); tree_dists:
    the class×class tree-distance matrix, built for eval-only runs
    (``is_train: false``)."""

    num_classes: int | tuple[int, ...]
    tree_dists: Optional[np.ndarray] = None

    @property
    def fine_grained_num_classes(self) -> int:
        if isinstance(self.num_classes, tuple):
            return self.num_classes[-1]
        return self.num_classes


@dataclasses.dataclass(frozen=True)
class FolderDataset:
    root: str
    paths: tuple[str, ...]
    labels: np.ndarray  # (N,) or (N, N_TIERS) int32
    classes: tuple[str, ...]
    num_classes: int | tuple[int, ...]

    def __len__(self) -> int:
        return len(self.paths)


def _scan_classes(split_dir: pathlib.Path) -> list[str]:
    classes = sorted(e.name for e in os.scandir(split_dir) if e.is_dir())
    if not classes:
        raise FileNotFoundError(f"no class directories under {split_dir}")
    return classes


def _scan_files(split_dir: pathlib.Path, classes: Sequence[str]) -> list[tuple[str, int]]:
    samples = []
    for idx, cls in enumerate(classes):
        for name in sorted(os.listdir(split_dir / cls)):
            if name.lower().endswith(IMG_EXTENSIONS):
                samples.append((str(split_dir / cls / name), idx))
    if not samples:
        raise FileNotFoundError(f"no images under {split_dir}")
    return samples


def scan_image_folder(root: str | os.PathLike, split: str, hierarchical: bool = False) -> FolderDataset:
    """Scan ``<root>/<split>/<class>/*``; hierarchical labels are per-tier index vectors."""
    split_dir = pathlib.Path(root) / split
    classes = _scan_classes(split_dir)
    samples = _scan_files(split_dir, classes)
    flat = np.asarray([i for _, i in samples], dtype=np.int32)
    if hierarchical:
        table, num_classes = hierarchy.assign_tier_indices(classes)
        labels = table[flat]
    else:
        labels, num_classes = flat, len(classes)
    return FolderDataset(root=str(root), paths=tuple(p for p, _ in samples), labels=labels,
                         classes=tuple(classes), num_classes=num_classes)
