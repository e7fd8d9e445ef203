"""Training objectives — port of ``hvt/objectives.py``: flat soft CE,
multitask CE, hierarchical CE (HXE) and per-class BCE.

Every objective has the signature ``loss(outputs, targets, mask) -> scalar``:
``outputs`` are logits (B, C), or a list of per-tier logits for multitask;
``targets`` are soft label distributions of the same shapes; ``mask`` is a
(B,) validity weight (1.0 for every row of a drop-last training batch). All
arithmetic is f32.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from hvt_torch import hierarchy


def _masked_mean(values: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return values.mean()
    return (values * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def soft_cross_entropy(logits, targets, mask=None):
    """CE against a probability-distribution target, masked mean over batch."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return _masked_mean(-(targets * logp).sum(-1), mask)


def multitask_cross_entropy(outputs, targets, coeffs: Sequence[float], mask=None):
    """coeffs · [CE per tier]."""
    if not len(outputs) == len(targets) == len(coeffs):
        raise ValueError(f"{len(outputs)} != {len(targets)} != {len(coeffs)}")
    losses = torch.stack([soft_cross_entropy(o, t, mask) for o, t in zip(outputs, targets)])
    return (torch.as_tensor(coeffs, dtype=losses.dtype, device=losses.device) * losses).sum()


def hxe_tier_weights(variant: str, alpha: float, n_tiers: int = hierarchy.N_TIERS) -> np.ndarray:
    """Per-tier weights w_t, kingdom→species: "uniform" ones, or
    "exponential" exp(−alpha · height above the species tier)."""
    if variant == "uniform":
        return np.ones((n_tiers,), dtype=np.float32)
    if variant == "exponential":
        heights = np.arange(n_tiers - 1, -1, -1, dtype=np.float32)
        return np.exp(-alpha * heights).astype(np.float32)
    raise ValueError(f"unknown hxe_tree_weights: {variant!r}")


@dataclasses.dataclass(frozen=True)
class HXELoss:
    """Tree-factorized cross-entropy over flat species logits
    (Bertinetto et al., arXiv:1912.09393): the species softmax is summed up
    to each ancestor tier and the loss is −Σ_t w_t · log p(anc_t | anc_{t−1}),
    in expectation under the soft targets."""

    tier_table: np.ndarray  # (n_species, N_TIERS) int32
    weights: np.ndarray  # (N_TIERS,) float32
    num_classes: tuple[int, ...]  # per-tier class counts

    @classmethod
    def from_config(cls, hierarchy_cfg, class_names: Sequence[str]) -> "HXELoss":
        table, num_classes = hierarchy.assign_tier_indices(list(class_names))
        weights = hxe_tier_weights(hierarchy_cfg.hxe_tree_weights, hierarchy_cfg.hxe_alpha)
        return cls(tier_table=table, weights=weights, num_classes=num_classes)

    def __call__(self, logits, targets, mask=None):
        """logits (B, n_species); targets soft (B, n_species)."""
        logp = F.log_softmax(logits.float(), dim=-1)
        b, species = logp.shape
        prev = torch.zeros(b, device=logp.device)  # E_q[log p(anc_{t-1})]
        per_example = torch.zeros(b, device=logp.device)
        for t in range(self.tier_table.shape[1]):
            n_t = self.num_classes[t]
            if n_t == species:
                tier_logp, q_t = logp, targets
            else:
                seg = torch.as_tensor(self.tier_table[:, t], dtype=torch.long, device=logp.device)
                # log p(ancestor) = segment logsumexp over its species; the
                # segment max only steadies the exp, so it carries no gradient
                seg_max = torch.full((b, n_t), -torch.inf, device=logp.device).scatter_reduce(
                    1, seg.expand(b, species), logp.detach(), "amax")
                total = torch.zeros(b, n_t, device=logp.device).index_add(
                    1, seg, torch.exp(logp - seg_max[:, seg]))
                tier_logp = torch.log(total) + seg_max
                q_t = torch.zeros(b, n_t, device=logp.device).index_add(1, seg, targets.float())
            exp_logp = (q_t * tier_logp).sum(-1)
            per_example = per_example - float(self.weights[t]) * (exp_logp - prev)
            prev = exp_logp
        return _masked_mean(per_example, mask)


def binary_cross_entropy(logits, targets, mask=None):
    """Per-class sigmoid BCE summed over classes, masked mean over batch."""
    logits = logits.float()
    per_class = torch.clamp(logits, min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return _masked_mean(per_class.sum(-1), mask)


def build_objective(config, dataset_info, class_names: Sequence[str] | None = None):
    """Select the loss per config.hierarchy.variant and model.loss_name."""
    del dataset_info  # kept for the signature of hvt's build_objective
    variant = config.hierarchy.variant
    if variant == "" and config.model.loss_name == "binary_cross_entropy":
        return binary_cross_entropy
    if config.model.loss_name not in ("", "binary_cross_entropy", "cross_entropy", "soft_cross_entropy"):
        raise ValueError(f"unknown model.loss_name {config.model.loss_name!r}")
    if variant == "multitask":
        coeffs = tuple(config.hierarchy.multitask_coeffs)

        def loss(outputs, targets, mask=None):
            return multitask_cross_entropy(outputs, targets, coeffs, mask)

        return loss
    if variant == "hxe":
        if class_names is None:
            raise ValueError("hxe objective needs the dataset's class names")
        return HXELoss.from_config(config.hierarchy, class_names)
    if variant == "":
        return soft_cross_entropy
    raise ValueError(f"unknown hierarchy.variant: {variant!r}")
