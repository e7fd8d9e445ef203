"""The train step — port of ``build_train_step`` in ``hvt/train/step.py``.

One step: uint8 NHWC images → ``DevicePrep.normalize`` → (smoothed)
one-hot targets → the model's train-mode forward (stochastic depth drawn
from the caller's generator; BatchNorm running statistics updated in place)
→ objective → backward (the model's backward kernels on the card) → clip +
optimizer update → EMA of the parameters and running statistics → metric
partial sums. hvt's step is one jitted XLA program; here it runs eagerly and
never waits for the device, so the host prepares the next batch while the
card works.

The port runs ``grad_accum == 1`` without SAM, MixUp, CutMix, progressive
resizing or device RandAugment/ColOut: :func:`build_train_step` raises on
grad accumulation, the Trainer on the rest (ROADMAP.md queue 1, items 4-6).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from hvt_torch import metrics as metrics_lib
from hvt_torch.data import device as device_prep
from hvt_torch.train import ema as ema_lib
from hvt_torch.train import optim as optim_lib


@dataclasses.dataclass(frozen=True)
class StepSettings:
    num_classes: Any  # int | tuple[int, ...]
    smoothing: float = 0.0
    grad_accum: int = 1


def build_train_step(model: torch.nn.Module, objective: Callable,
                     optimizer: optim_lib.Optimizer, prep: device_prep.DevicePrep,
                     settings: StepSettings, ema: Optional[ema_lib.Ema] = None) -> Callable:
    """Returns ``step(images, labels, mask, generator)`` → stats: device
    scalars ``loss_sum``, ``grad_norm`` (of the raw gradients), ``batches``,
    ``correct@1``, ``correct@5``, ``ce_sum`` and ``count``. The model, its
    parameters and the batch share one device; the parameters update in
    place, and then ``ema`` with the optimizer's count of updates before
    this one (hvt's ``state.step``)."""
    if settings.grad_accum != 1:
        raise NotImplementedError(
            f"grad_accum {settings.grad_accum}: gradient accumulation is ROADMAP.md "
            "queue 1, item 5 (train step); set grad_accum: 1")

    def step(images: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> dict[str, torch.Tensor]:
        model.train()
        x = prep.normalize(images)
        targets = device_prep.prepare_targets(labels, settings.num_classes, settings.smoothing)
        out = model(x, generator=generator)
        loss = objective(out, targets, mask)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        step_before = optimizer.count
        grad_norm = optimizer.step()
        if ema is not None:
            ema.update(step_before)
        with torch.no_grad():
            detached = [o.detach() for o in out] if isinstance(out, list) else out.detach()
            stats = metrics_lib.batch_stats(detached, labels, mask)
        stats["loss_sum"] = loss.detach().float()
        stats["batches"] = torch.ones((), device=loss.device)
        stats["grad_norm"] = grad_norm
        return stats

    return step
