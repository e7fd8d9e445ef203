"""Nearest-centroid classifiers for SimpleShot, in torch on the features'
device, in f64.

* :class:`NearestCentroid`: the flat classifier hvt takes from sklearn
  (``sklearn.neighbors.NearestCentroid`` with its defaults): ``classes_``
  the sorted labels present, a centroid per class the mean of its rows,
  ``predict`` the class of the nearest centroid in euclidean distance, the
  first class on a tie.
* :class:`HierarchicalNearestCentroid`: port of
  ``hvt/downstream/centroid.py``. Per-tier centroids; ``predict`` goes
  top-down: the unconstrained nearest centroid at the kingdom tier, then at
  each deeper tier the nearest centroid whose parent is the previous
  tier's prediction (a masked argmin). Where the predicted parent has no
  child present (possible on k-shot splits) the unconstrained nearest is
  taken. Rows go through in chunks of 4096.

The class means add up with ``index_add_``; distances are ``|x|² + |c|² -
2 x·c`` through ``torch.matmul``, monotone in the euclidean distance.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_CHUNK = 4096


def _as_f64(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           device=device).to(torch.float64)


def _class_means(x: torch.Tensor, codes: torch.Tensor, n: int) -> torch.Tensor:
    """(n, D) means of ``x``'s rows grouped by ``codes`` in [0, n)."""
    sums = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device).index_add_(0, codes, x)
    counts = torch.bincount(codes, minlength=n).to(x.dtype)
    return sums / counts[:, None]


def _sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances (B, n_centroids)."""
    return (x * x).sum(1, keepdim=True) + (c * c).sum(1) - 2.0 * torch.matmul(x, c.T)


class NearestCentroid:
    """fit(X, y) with y (N,) labels; predict(X) → labels (numpy)."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else torch.device("cpu")

    def fit(self, X, y) -> "NearestCentroid":
        y = np.asarray(y)
        self.classes_, codes = np.unique(y, return_inverse=True)
        if self.classes_.size < 2:
            raise ValueError(f"The number of classes has to be greater than one; got {self.classes_.size}")
        x = _as_f64(X, self.device)
        if bool((x == x[:1]).all()):
            raise ValueError("All features have zero variance. Division by zero.")
        self.centroids_ = _class_means(x, torch.as_tensor(codes, device=self.device),
                                       self.classes_.size)
        return self

    def predict(self, X) -> np.ndarray:
        if not hasattr(self, "centroids_"):
            raise RuntimeError("not fitted")
        x = _as_f64(X, self.device)
        enc = torch.cat([_sq_dists(x[s:s + _CHUNK], self.centroids_).argmin(1)
                         for s in range(0, x.shape[0], _CHUNK)])
        return self.classes_[enc.cpu().numpy()]


class HierarchicalNearestCentroid:
    """fit(X, y) with y (N, n_tiers) global tier indices; predict(X) →
    (N, n_tiers) global tier indices (numpy)."""

    def __init__(self, lookup_vecs: Sequence[np.ndarray], device=None):
        # lookup_vecs[t-1][child index] = parent index
        # (hierarchy.build_parent_label_lookup)
        self.lookup_vecs = [np.asarray(v) for v in lookup_vecs]
        self.device = torch.device(device) if device is not None else torch.device("cpu")

    def fit(self, X, y) -> "HierarchicalNearestCentroid":
        y = np.asarray(y)
        n_tiers = y.shape[1]
        # classes_[t]: the sorted tier-t indices present
        self.classes_ = [np.unique(y[:, t]) for t in range(n_tiers)]
        if any(c.size < 2 for c in self.classes_):
            raise ValueError(
                "All levels need > 1 class; got %s" % [c.size for c in self.classes_])
        x = _as_f64(X, self.device)
        self.centroids_ = []
        for t, present in enumerate(self.classes_):
            codes = torch.as_tensor(np.searchsorted(present, y[:, t]), device=self.device)
            self.centroids_.append(_class_means(x, codes, present.size))
        # parents of each tier's present classes, as global indices of the tier above
        self._parents = [torch.as_tensor(self.lookup_vecs[t - 1][self.classes_[t]],
                                         device=self.device) for t in range(1, n_tiers)]
        self._classes = [torch.as_tensor(c, device=self.device) for c in self.classes_]
        return self

    def predict(self, X) -> np.ndarray:
        if not hasattr(self, "centroids_"):
            raise RuntimeError("not fitted")
        x = _as_f64(X, self.device)
        inf = torch.tensor(float("inf"), dtype=torch.float64, device=self.device)
        preds = []
        for start in range(0, x.shape[0], _CHUNK):
            chunk = x[start:start + _CHUNK]
            tiers, prev = [], None
            for t, cents in enumerate(self.centroids_):
                dists = _sq_dists(chunk, cents)
                if t > 0:
                    allowed = self._parents[t - 1][None, :] == prev[:, None]
                    dists = torch.where(allowed | ~allowed.any(1, keepdim=True), dists, inf)
                prev = self._classes[t][dists.argmin(1)]
                tiers.append(prev)
            preds.append(torch.stack(tiers, 1))
        return torch.cat(preds).cpu().numpy().astype(np.int64)
