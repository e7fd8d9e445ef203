"""Masked classification metrics — port of ``hvt/metrics.py``.

Metric names and semantics are hvt's: ``cross-entropy``, ``acc@1``,
``acc@5`` and ``tree-dist``, on the finest tier of multitask outputs.
Per-batch partial sums stay tensors on the batch's device, so summing them
over steps needs no host sync; the accumulator fetches them as floats.
Cross-entropy here is the metric CE on hard labels, not the smoothed
training loss. ``accuracy_topk`` and ``mean_tree_distance`` are the numpy
helpers of the downstream evaluations.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def fine_grained(outputs, labels):
    """Reduce multitask outputs/labels to the finest tier."""
    if isinstance(outputs, (list, tuple)):
        outputs = outputs[-1]
    if labels.ndim > 1:
        labels = labels[:, -1]
    return outputs, labels


def batch_stats(outputs, labels: torch.Tensor, mask: torch.Tensor,
                tree_dists: Optional[torch.Tensor] = None) -> dict[str, torch.Tensor]:
    """Partial sums for one batch, f32 scalars: ``correct@1``, ``correct@5``,
    ``ce_sum`` and ``count``; with ``tree_dists`` (classes × classes, on the
    logits' device) also ``tree_dist_sum``, the argmax prediction's tree
    distance to the label."""
    logits, labels = fine_grained(outputs, labels)
    logits = logits.float()
    labels = labels.long()
    # Rank counting instead of top-k, as hvt: the target is in the top k iff
    # fewer than k classes score strictly higher (ties resolve optimistically).
    k = min(5, logits.shape[-1])
    target = logits.gather(-1, labels[:, None])
    rank = (logits > target).float().sum(-1)
    nll = -F.log_softmax(logits, dim=-1).gather(-1, labels[:, None])[:, 0]
    mask = mask.float()
    out = {
        "correct@1": ((rank < 1).float() * mask).sum(),
        "correct@5": ((rank < k).float() * mask).sum(),
        "ce_sum": (nll * mask).sum(),
        "count": mask.sum(),
    }
    if tree_dists is not None:
        dists = tree_dists[logits.argmax(-1), labels].float()
        out["tree_dist_sum"] = (dists * mask).sum()
    return out


class MetricAccumulator:
    """Host-side accumulation of per-batch partial sums → final metric dict."""

    def __init__(self):
        self._sums: dict[str, float] = {}

    def update(self, stats: dict) -> None:
        for key, val in stats.items():
            self._sums[key] = self._sums.get(key, 0.0) + float(val)

    def compute(self) -> dict[str, float]:
        count = max(self._sums.get("count", 0.0), 1.0)
        out = {
            "acc@1": self._sums.get("correct@1", 0.0) / count,
            "acc@5": self._sums.get("correct@5", 0.0) / count,
            "cross-entropy": self._sums.get("ce_sum", 0.0) / count,
        }
        if "tree_dist_sum" in self._sums:
            out["tree-dist"] = self._sums["tree_dist_sum"] / count
        if "loss_sum" in self._sums and "batches" in self._sums:
            out["loss"] = self._sums["loss_sum"] / max(self._sums["batches"], 1.0)
        return out

    def reset(self) -> None:
        self._sums.clear()


def accuracy_topk(outputs, labels: np.ndarray, topk: int = 1, hierarchy_level: int = -1) -> float:
    """Numpy helper for downstream evaluations (linear probe, SimpleShot):
    the share of rows whose label is among the ``topk`` highest outputs of
    tier ``hierarchy_level``."""
    if isinstance(outputs, (list, tuple)):
        outputs = outputs[hierarchy_level]
    if labels.ndim > 1:
        labels = labels[:, hierarchy_level]
    k = min(topk, outputs.shape[-1])
    pred = np.argsort(-outputs, axis=-1)[:, :k]
    return float(np.mean(np.any(pred == labels[:, None], axis=-1)))


def mean_tree_distance(preds: np.ndarray, labels: np.ndarray, tree_dists: np.ndarray) -> float:
    """Mean tree distance between predicted and true classes."""
    return float(np.mean(tree_dists[preds, labels]))
