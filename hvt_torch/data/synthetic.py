"""Synthetic dataset: deterministic random images + taxonomy-shaped labels —
port of ``hvt/data/synthetic.py`` (same names, labels and pixels per seed)."""

from __future__ import annotations

import dataclasses

import numpy as np

from hvt_torch import hierarchy


def synthetic_class_names(num_classes: int) -> list[str]:
    """Taxonomy-shaped names forming a consistent tree: tier t of class i is
    ``i % 2**(t+1)``, the species tier is i itself."""
    names = []
    for i in range(num_classes):
        tiers = [f"t{t}v{i % (2 ** (t + 1))}" for t in range(hierarchy.N_TIERS - 1)]
        names.append("_".join([f"{i:05d}", *tiers, f"s{i}"]))
    return names


#: distinct random images in the lazily-built pool; sample i is pool[i % POOL_SIZE]
POOL_SIZE = 64


@dataclasses.dataclass(frozen=True)
class SyntheticDataset:
    num_samples: int
    crop_size: int
    labels: np.ndarray  # (N,) or (N, N_TIERS) int32
    classes: tuple[str, ...]
    num_classes: int | tuple[int, ...]
    seed: int = 0

    def __len__(self) -> int:
        return self.num_samples

    def _pool(self) -> np.ndarray:
        cached = getattr(self, "_pool_cache", None)
        if cached is None:
            rng = np.random.default_rng((self.seed, 0xF00D))
            n = min(POOL_SIZE, self.num_samples)
            cached = rng.integers(0, 256, size=(n, self.crop_size, self.crop_size, 3), dtype=np.uint8)
            object.__setattr__(self, "_pool_cache", cached)
        return cached

    def load(self, index: int) -> np.ndarray:
        pool = self._pool()
        return pool[int(index) % len(pool)]


def build_synthetic(num_samples: int, num_leaf_classes: int, crop_size: int,
                    hierarchical: bool = False, seed: int = 0) -> SyntheticDataset:
    classes = synthetic_class_names(num_leaf_classes)
    rng = np.random.default_rng((seed, 0x1AB))
    flat = rng.integers(0, num_leaf_classes, size=(num_samples,)).astype(np.int32)
    if hierarchical:
        table, num_classes = hierarchy.assign_tier_indices(classes)
        labels = table[flat]
    else:
        labels, num_classes = flat, num_leaf_classes
    return SyntheticDataset(num_samples=num_samples, crop_size=crop_size, labels=labels,
                            classes=tuple(classes), num_classes=num_classes, seed=seed)
