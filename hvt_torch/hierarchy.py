"""Taxonomy labels, tree distances and parent lookups — the port's own copy
of ``hvt/hierarchy.py`` (pure Python/numpy).

* 7-tier labels parsed from iNat21-style directory names
  ``00001_animalia_chordata_aves_..._accipiter_badius``, lower tiers
  disambiguated by their path from the kingdom,
* the N×N uint8 tree-distance matrix over the union of train and val
  classes, cached on disk as ``tree_dist_cache.npy`` (evaluation's
  ``tree-dist`` metric),
* per-tier class indices in first-seen order over the sorted class list,
* child → parent index vectors for the constrained top-down decode and
  the hierarchical SimpleShot centroid,
* ``LeafCountLookup``, the leaf counts under every node.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import pathlib
from typing import Iterable, Sequence

import numpy as np

#: kingdom, phylum, class, order, family, genus, species
N_TIERS = 7
TIER_NAMES = ("kingdom", "phylum", "cls", "order", "family", "genus", "species")

TREE_DIST_CACHE = "tree_dist_cache.npy"


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


def union_labels(directory: str | os.PathLike) -> list[HierarchicalLabel]:
    """Sorted parsed labels over the union of train/ and val/ class dirs."""
    directory = pathlib.Path(directory)
    names = {p.name for p in (directory / "train").iterdir() if p.is_dir()}
    names |= {p.name for p in (directory / "val").iterdir() if p.is_dir()}
    return [HierarchicalLabel.parse(name) for name in sorted(names)]


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


def build_parent_label_lookup(directory: str | os.PathLike) -> list[np.ndarray]:
    """:func:`parent_lookup_from_classes` over the union of the folder's
    train/ and val/ class directories (SimpleShot's hierarchical centroid)."""
    return parent_lookup_from_classes([lab.raw for lab in union_labels(directory)])


def tree_dist_matrix(labels: Sequence[HierarchicalLabel]) -> np.ndarray:
    """N×N uint8 matrix of pairwise tree distances: 0 for the same species,
    N_TIERS - 1 - t where the deepest shared tier is t, N_TIERS for
    different kingdoms. Each tier's values become integer codes, and deeper
    tiers overwrite shallower ones with smaller distances."""
    n = len(labels)
    dist = np.full((n, n), N_TIERS, dtype=np.uint8)
    for depth in range(N_TIERS):
        _, codes = np.unique([lab.tiers[depth] for lab in labels], return_inverse=True)
        dist[codes[:, None] == codes[None, :]] = N_TIERS - 1 - depth
    if not (np.diagonal(dist) == 0).all():
        raise AssertionError("diagonal of tree-dist matrix must be 0")
    return dist


def build_tree_dist_matrix(directory: str | os.PathLike) -> np.ndarray:
    """Tree-dist matrix over train∪val classes, cached at
    ``<directory>/tree_dist_cache.npy``."""
    cache = pathlib.Path(directory) / TREE_DIST_CACHE
    if cache.is_file():
        return np.load(cache)
    matrix = tree_dist_matrix(union_labels(directory))
    np.save(cache, matrix)
    return matrix


class LeafCountLookup:
    """Species (leaf) counts under every taxonomic node."""

    def __init__(self, labels: Iterable[HierarchicalLabel]):
        self._lookup: dict[tuple[str, str], int] = collections.defaultdict(int)
        self.total = 0
        for label in labels:
            for tier_name, value in zip(TIER_NAMES, label.tiers):
                self._lookup[(value, tier_name)] += 1
            self.total += 1

    def closest(self, n: int | float) -> tuple[str, str, int]:
        """Node (label, tier, count) whose leaf count is closest to n (or to
        n·total when n is a fraction)."""
        if isinstance(n, float):
            if not 0 <= n <= 1:
                raise ValueError("fractional n must be in [0, 1]")
            n = int(self.total * n)
        if not self._lookup:
            raise RuntimeError("no values in lookup!")
        (label, tier), count = min(self._lookup.items(), key=lambda kv: abs(kv[1] - n))
        return label, tier, count
