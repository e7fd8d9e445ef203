"""Masked classification metrics — port of ``hvt/metrics.py`` (the training
side: ``fine_grained``, ``batch_stats`` and ``MetricAccumulator``; the
tree-distance sums of evaluation are ROADMAP.md queue 1, item 3).

Per-batch partial sums stay tensors on the batch's device, so summing them
over steps needs no host sync; the accumulator fetches them as floats.
Cross-entropy here is the metric CE on hard labels, not the smoothed
training loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def fine_grained(outputs, labels):
    """Reduce multitask outputs/labels to the finest tier."""
    if isinstance(outputs, (list, tuple)):
        outputs = outputs[-1]
    if labels.ndim > 1:
        labels = labels[:, -1]
    return outputs, labels


def batch_stats(outputs, labels: torch.Tensor, mask: torch.Tensor) -> dict[str, torch.Tensor]:
    """Partial sums for one batch, f32 scalars: ``correct@1``, ``correct@5``,
    ``ce_sum`` and ``count``."""
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
    return {
        "correct@1": ((rank < 1).float() * mask).sum(),
        "correct@5": ((rank < k).float() * mask).sum(),
        "ce_sum": (nll * mask).sum(),
        "count": mask.sum(),
    }


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
        if "loss_sum" in self._sums and "batches" in self._sums:
            out["loss"] = self._sums["loss_sum"] / max(self._sums["batches"], 1.0)
        return out

    def reset(self) -> None:
        self._sums.clear()
