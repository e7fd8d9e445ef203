"""Classification heads shared across backbones — port of ``hvt/models/heads.py``."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class MultitaskHead(nn.Module):
    """One linear classifier per taxonomy tier (``tier{i}``) over the shared
    pooled features; returns a list of f32 logits, kingdom … species."""

    def __init__(self, in_features: int, num_classes: Sequence[int]):
        super().__init__()
        for n in num_classes:
            if n <= 0:
                raise ValueError("every tier needs at least one class")
        self.num_classes = tuple(num_classes)
        for i, n in enumerate(self.num_classes):
            self.add_module(f"tier{i}", nn.Linear(in_features, n))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """hvt's init: variance_scaling(2.0, fan_in, normal) kernels, zero bias."""
        for i in range(len(self.num_classes)):
            layer = getattr(self, f"tier{i}")
            layer.weight.normal_(0.0, (2.0 / layer.in_features) ** 0.5, generator=gen)
            layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = x.float()
        return [
            F.linear(x, getattr(self, f"tier{i}").weight.float(), getattr(self, f"tier{i}").bias.float())
            for i in range(len(self.num_classes))
        ]
