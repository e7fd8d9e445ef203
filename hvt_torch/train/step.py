"""The train, eval and feature steps — port of ``build_train_step``,
``build_eval_step`` and ``build_feature_step`` in ``hvt/train/step.py``.

One step, in hvt's order: uint8 NHWC images → device RandAugment →
device ColOut → ``DevicePrep.normalize`` → ``progressive_resize(scale)`` →
(smoothed) one-hot targets → MixUp → CutMix → the model's train-mode
forward (stochastic depth drawn from the caller's generator; BatchNorm
running statistics updated in place) → objective → backward (the model's
backward kernels on the card) → clip + optimizer update → EMA of the
parameters and running statistics → metric partial sums. Every
augmentation's draws come from the caller's generator, before the forward's
(:func:`draw_augmentations`), unless the caller passes them. hvt's step is
one jitted XLA program; here it runs eagerly and never waits for the
device, so the host prepares the next batch while the card works.

The eval and feature steps run the model's eval-mode forward (its forward
kernels on the card, no backward) under ``torch.inference_mode`` on the
parameters and running statistics they are given, through
``torch.func.functional_call``, as hvt's take ``params, batch_stats``:
evaluating the EMA copy neither copies the model nor touches its weights.

The port runs ``grad_accum == 1`` without SAM: :func:`build_train_step`
raises on grad accumulation, the Trainer on SAM (ROADMAP.md queue 1, item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from hvt_torch import metrics as metrics_lib
from hvt_torch.data import device as device_prep
from hvt_torch.data import randaugment as ra_lib
from hvt_torch.train import ema as ema_lib
from hvt_torch.train import optim as optim_lib


@dataclasses.dataclass(frozen=True)
class StepSettings:
    num_classes: Any  # int | tuple[int, ...]
    smoothing: float = 0.0
    mixup_alpha: Optional[float] = None
    cutmix_alpha: Optional[float] = None
    grad_accum: int = 1
    # device RandAugment (depth, severity, stratified), on the uint8 batch
    # before ColOut and normalization, the host order
    randaugment: Optional[tuple[int, int, bool]] = None
    # device ColOut (p_row, p_col), on the uint8 batch before normalization
    colout: Optional[tuple[float, float]] = None


def draw_augmentations(generator: Optional[torch.Generator], settings: StepSettings,
                       images_shape: tuple[int, ...], scale: float, device) -> dict:
    """The step's augmentation draws, in hvt's order (RandAugment, ColOut,
    MixUp, CutMix), on ``device`` from ``generator``: the inputs of
    :func:`augment` besides the batch."""
    b, h, w, _ = images_shape
    draws = {}
    if settings.randaugment:
        depth, _, stratified = settings.randaugment
        draws["randaugment"] = ra_lib.draw_rand_augment(generator, b, depth, stratified, device)
    if settings.colout:
        draws["colout"] = device_prep.draw_colout(generator, b, h, w, *settings.colout, device)
    if settings.mixup_alpha:
        draws["mixup"] = device_prep.draw_beta(generator, settings.mixup_alpha, device)
    if settings.cutmix_alpha:
        if scale < 1.0:
            h, w = device_prep.resized_size(h, scale), device_prep.resized_size(w, scale)
        draws["cutmix"] = device_prep.draw_cutmix(generator, settings.cutmix_alpha, h, w, device)
    return draws


def augment(images: torch.Tensor, labels: torch.Tensor, prep: device_prep.DevicePrep,
            settings: StepSettings, scale: float, draws: dict):
    """uint8 images and int labels → (model input, targets) with the given
    draws: RandAugment → ColOut → normalize → progressive resize → targets
    → MixUp → CutMix."""
    if settings.randaugment:
        _, severity, stratified = settings.randaugment
        images = ra_lib.rand_augment(images, draws["randaugment"], severity, stratified)
    if settings.colout:
        images = device_prep.colout(images, draws["colout"])
    x = device_prep.progressive_resize(prep.normalize(images), scale)
    targets = device_prep.prepare_targets(labels, settings.num_classes, settings.smoothing)
    if settings.mixup_alpha:
        x, targets = device_prep.mixup(x, targets, draws["mixup"])
    if settings.cutmix_alpha:
        x, targets = device_prep.cutmix(x, targets, *draws["cutmix"])
    return x, targets


def build_train_step(model: torch.nn.Module, objective: Callable,
                     optimizer: optim_lib.Optimizer, prep: device_prep.DevicePrep,
                     settings: StepSettings, ema: Optional[ema_lib.Ema] = None) -> Callable:
    """Returns ``step(images, labels, mask, generator, scale=1.0, draws=None)``
    → stats: device scalars ``loss_sum``, ``grad_norm`` (of the raw
    gradients), ``batches``, ``correct@1``, ``correct@5``, ``ce_sum`` and
    ``count``. ``scale`` is the progressive-resize scale; ``draws`` (of
    :func:`draw_augmentations`) are taken from ``generator`` when not
    given. The model, its parameters and the batch share one device; the
    parameters update in place, and then ``ema`` with the optimizer's count
    of updates before this one (hvt's ``state.step``)."""
    if settings.grad_accum != 1:
        raise NotImplementedError(
            f"grad_accum {settings.grad_accum}: gradient accumulation is ROADMAP.md "
            "queue 1, item 5 (train step); set grad_accum: 1")

    def step(images: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
             generator: Optional[torch.Generator] = None, scale: float = 1.0,
             draws: Optional[dict] = None) -> dict[str, torch.Tensor]:
        model.train()
        if draws is None:
            draws = draw_augmentations(generator, settings, tuple(images.shape), scale,
                                       images.device)
        x, targets = augment(images, labels, prep, settings, scale, draws)
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


def _eval_forward(model: torch.nn.Module, params: dict, batch_stats: dict, x: torch.Tensor,
                  features_only: bool = False):
    """The model's eval-mode forward on ``params`` and ``batch_stats`` in
    place of its own, its train/eval mode put back after."""
    training = model.training
    model.eval()
    try:
        return torch.func.functional_call(model, {**params, **batch_stats}, (x,),
                                          {"features_only": features_only})
    finally:
        model.train(training)


def build_eval_step(model: torch.nn.Module, prep: device_prep.DevicePrep,
                    tree_dists=None) -> Callable:
    """Returns ``eval(params, batch_stats, images, labels, mask)`` → the
    device scalars of ``metrics.batch_stats``: ``correct@1``, ``correct@5``,
    ``ce_sum``, ``count`` and, given ``tree_dists`` (classes × classes),
    ``tree_dist_sum``. The matrix is copied to the model's device once,
    here."""
    device = next(model.parameters()).device
    td = None if tree_dists is None else torch.from_numpy(np.asarray(tree_dists)).to(device)

    @torch.inference_mode()
    def step(params: dict, batch_stats: dict, images: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor) -> dict[str, torch.Tensor]:
        out = _eval_forward(model, params, batch_stats, prep.normalize(images))
        return metrics_lib.batch_stats(out, labels, mask, tree_dists=td)

    return step


def build_feature_step(model: torch.nn.Module, prep: device_prep.DevicePrep) -> Callable:
    """Returns ``features(params, batch_stats, images)`` → the frozen pooled
    features (B, F) in f32, for the linear probe and SimpleShot."""

    @torch.inference_mode()
    def step(params: dict, batch_stats: dict, images: torch.Tensor) -> torch.Tensor:
        return _eval_forward(model, params, batch_stats, prep.normalize(images),
                             features_only=True).float()

    return step
