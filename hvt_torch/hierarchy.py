"""Taxonomy labels and parent lookups — the parts of ``hvt/hierarchy.py`` that
the port's data and decode paths use (its own copy; pure Python/numpy).

* 7-tier labels parsed from iNat21-style directory names
  ``00001_animalia_chordata_aves_..._accipiter_badius``, lower tiers
  disambiguated by their path from the kingdom,
* per-tier class indices in first-seen order over the sorted class list,
* child → parent index vectors for the constrained top-down decode.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

#: kingdom, phylum, class, order, family, genus, species
N_TIERS = 7


@dataclasses.dataclass(frozen=True)
class HierarchicalLabel:
    raw: str
    number: int
    tiers: tuple[str, ...]  # length N_TIERS, kingdom..species

    @classmethod
    def parse(cls, name: str) -> "HierarchicalLabel":
        """Parse ``<index>_<kingdom>_..._<species>``; each tier value is the
        "-"-joined path from the kingdom down, so equal strings are equal nodes."""
        index, *parts = name.split("_")
        number = int(index)
        tiers: list[str] = []
        prefix = ""
        for part in parts:
            prefix = part if not prefix else f"{prefix}-{part}"
            tiers.append(prefix)
        if len(tiers) != N_TIERS:
            raise ValueError(f"label {name!r} has {len(tiers)} tiers, expected {N_TIERS}")
        return cls(raw=name, number=number, tiers=tuple(tiers))


def assign_tier_indices(class_names: Sequence[str]) -> tuple[np.ndarray, tuple[int, ...]]:
    """(num_classes, N_TIERS) int32 table of each class's index per tier, and
    the per-tier class counts (kingdom..species)."""
    tier_lookup: list[dict[str, int]] = [{} for _ in range(N_TIERS)]
    table = np.zeros((len(class_names), N_TIERS), dtype=np.int32)
    for row, name in enumerate(class_names):
        for tier, value in enumerate(HierarchicalLabel.parse(name).tiers):
            lut = tier_lookup[tier]
            if value not in lut:
                lut[value] = len(lut)
            table[row, tier] = lut[value]
    return table, tuple(len(lut) for lut in tier_lookup)


def parent_lookup_from_classes(classes: Sequence[str]) -> list[np.ndarray]:
    """(N_TIERS-1) vectors: vectors[t][c] is the tier-t index of the parent of
    tier-(t+1) class c."""
    table, num_classes = assign_tier_indices(list(classes))
    vectors = []
    for tier in range(1, N_TIERS):
        vec = np.zeros((num_classes[tier],), dtype=np.int64)
        vec[table[:, tier]] = table[:, tier - 1]
        vectors.append(vec)
    return vectors
