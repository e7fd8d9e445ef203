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

Gradient accumulation and SAM are hvt's (``hvt/train/step.py:130-213``),
in :func:`build_gradients`. The batch splits into ``grad_accum`` equal
microbatches, run one after another: each draws its own augmentations and
drop-path masks from the generator (hvt folds its key per microbatch), the
BatchNorm running statistics chain through them, their gradients sum in
``p.grad`` and are divided by ``grad_accum``, the loss is the mean of theirs
and the metric sums add up. SAM (every ``sam_interval`` updates, counting
the optimizer's updates before this one) runs the microbatches again at
``p + (rho / max(|g|, 1e-12))·g`` and steps on those gradients; the first
pass's loss, metric sums and running statistics are kept. hvt gives both
passes one key, so the port replays the generator from the state it had at
the start of the step; the parameters are put back from a copy (``p + e −
e`` is not ``p``), the running statistics from a snapshot taken after the
first pass, and the generator to its state after the first pass.

A model with MoE layers (:mod:`hvt_torch.ops.moe`) adds their aux loss to
each microbatch's loss before its backward, in each SAM pass too, so that it
counts in the reported loss, as hvt's ``objective + aux``
(hvt/train/step.py:55-73, :118).

Under a declared data group (:mod:`hvt_torch.parallel`; hvt's GSPMD step
over its mesh's data axis, ``hvt/train/step.py:93-213``) each rank's batch
is its share of every microbatch of hvt's global batch (the loader's row
plan). The augmentation draws are made over the global microbatch from the
generator, which stays equal on every rank, and each rank keeps its rows;
each rank's loss is its Σ(loss·mask) over the global Σmask (its objective's
value times its count over the global count), so that the ranks' gradients
*sum* to those of hvt's global masked mean; the aux loss, hvt's mean over the
global microbatch's images whatever the mask, counts at the rank's share of
those images. After the last microbatch the
gradients are summed over the ranks in flat buckets, one all-reduce at a
time (``parallel.all_reduce_tensors_``), before the division by
``grad_accum``; SAM's norm and the clipping then read the summed gradients,
and SAM's second pass is summed again. The loss and the metric sums are
summed over the ranks in one all-reduce, so every rank returns the global
stats. Under a grid with a model axis every sum above is over the data
group: model peers run the same rows and hold the same replicated
gradients, and SAM's norm and the clipping count a TP shard's squares over
the model group (``optim.global_norm``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from hvt_torch import metrics as metrics_lib
from hvt_torch import parallel
from hvt_torch.data import device as device_prep
from hvt_torch.data import randaugment as ra_lib
from hvt_torch.ops import moe as moe_lib
from hvt_torch.train import ema as ema_lib
from hvt_torch.train import optim as optim_lib


@dataclasses.dataclass(frozen=True)
class StepSettings:
    num_classes: Any  # int | tuple[int, ...]
    smoothing: float = 0.0
    mixup_alpha: Optional[float] = None
    cutmix_alpha: Optional[float] = None
    grad_accum: int = 1
    # SAM: every sam_interval updates, the gradients again at p + rho·g/|g|
    sam_rho: Optional[float] = None
    sam_interval: int = 1
    # device RandAugment (depth, severity, stratified), on the uint8 batch
    # before ColOut and normalization, the host order
    randaugment: Optional[tuple[int, int, bool]] = None
    # device ColOut (p_row, p_col), on the uint8 batch before normalization
    colout: Optional[tuple[float, float]] = None


def draw_augmentations(generator: Optional[torch.Generator], settings: StepSettings,
                       images_shape: tuple[int, ...], scale: float, device) -> dict:
    """The step's augmentation draws, in hvt's order (RandAugment, ColOut,
    MixUp, CutMix), on ``device`` from ``generator``: the inputs of
    :func:`augment` besides the batch. Under a data group the per-image
    draws are made over the global microbatch and this rank keeps its rows."""
    b, h, w, _ = images_shape
    total, offset = parallel.global_rows(b)
    draws = {}
    if settings.randaugment:
        depth, _, stratified = settings.randaugment
        rounds = ra_lib.draw_rand_augment(generator, total, depth, stratified, device)
        draws["randaugment"] = (rounds if total == b
                                else ra_lib.local_rounds(rounds, offset, b, stratified))
    if settings.colout:
        keep = device_prep.draw_colout(generator, total, h, w, *settings.colout, device)
        draws["colout"] = None if keep is None else tuple(t[offset:offset + b] for t in keep)
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


def build_gradients(model: torch.nn.Module, objective: Callable, prep: device_prep.DevicePrep,
                    settings: StepSettings) -> Callable:
    """Returns ``gradients(images, labels, mask, generator=None, scale=1.0,
    draws=None, sam=False)`` → (loss, metric sums): the step's gradients,
    left in ``p.grad``, through ``settings.grad_accum`` microbatches, and
    with ``sam`` at the perturbed point. ``draws`` are the microbatches'
    augmentation draws, one :func:`draw_augmentations` dict each (a list, or
    one dict at ``grad_accum`` 1), taken from ``generator`` when not given.
    The running statistics update as the first pass goes; the parameters,
    the second pass's statistics and the generator are put back even when a
    pass raises (the Trainer's memory probe runs out of memory on purpose)."""
    accum = int(settings.grad_accum)
    if accum < 1:
        raise ValueError(f"grad_accum {accum}: at least 1")

    def one_pass(chunks, generator, scale, draws):
        grouped = parallel.data_group() is not None
        loss_sum, sums = None, None
        for i, (images, labels, mask) in enumerate(chunks):
            d = draws[i] if draws is not None else draw_augmentations(
                generator, settings, tuple(images.shape), scale, images.device)
            x, targets = augment(images, labels, prep, settings, scale, d)
            out = model(x, generator=generator)
            aux = moe_lib.moe_aux_loss(model)  # 0.0 without MoE layers: nothing added
            loss = objective(out, targets, mask)
            if grouped:  # the rank's share of the global masked mean
                count = mask.sum()
                loss = loss * (count.clamp_min(1.0)
                               / parallel.all_reduce_(count.clone()).clamp_min(1.0))
            if isinstance(aux, torch.Tensor):  # a mean over the global microbatch's images
                loss = loss + aux * (images.shape[0] / parallel.global_rows(images.shape[0])[0])
            loss.backward()
            with torch.no_grad():
                detached = [o.detach() for o in out] if isinstance(out, list) else out.detach()
                stats = metrics_lib.batch_stats(detached, labels, mask)
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            sums = stats if sums is None else {k: sums[k] + v for k, v in stats.items()}
        if grouped:
            with torch.no_grad():
                parallel.all_reduce_tensors_([p.grad for p in model.parameters()
                                              if p.grad is not None])
                names = list(sums)
                flat = parallel.all_reduce_(torch.stack([loss_sum.float()]
                                                        + [sums[k].float() for k in names]))
                loss_sum = flat[0].to(loss_sum.dtype)
                sums = {k: flat[j + 1].to(sums[k].dtype) for j, k in enumerate(names)}
        if accum > 1:
            with torch.no_grad():
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.div_(accum)
        return loss_sum / accum if accum > 1 else loss_sum, sums

    def gradients(images: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                  generator: Optional[torch.Generator] = None, scale: float = 1.0,
                  draws=None, sam: bool = False):
        b = images.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by grad_accum {accum}")
        chunks = list(zip(*(a.split(b // accum) for a in (images, labels, mask))))
        if isinstance(draws, dict):
            draws = [draws]
        if draws is not None and len(draws) != accum:
            raise ValueError(f"{len(draws)} sets of draws for {accum} microbatches")
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        if sam and generator is None:
            raise ValueError("SAM replays the step's draws for its second pass: pass a generator")
        start = generator.get_state() if sam else None
        loss, stats = one_pass(chunks, generator, scale, draws)
        if not sam:
            return loss, stats
        after = generator.get_state()
        buffers = [(b, b.detach().clone()) for b in model.buffers()]
        saved = [p.detach().clone() for p in params]
        try:
            with torch.no_grad():
                grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
                norm = optim_lib.global_norm(grads, optim_lib.tp_sharded(params))
                factor = settings.sam_rho / norm.clamp_min(1e-12)
                for p, g in zip(params, grads):
                    p.add_(factor * g.to(p.dtype))
            del grads
            for p in params:
                p.grad = None
            generator.set_state(start)
            one_pass(chunks, generator, scale, draws)
        finally:
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)
                for b, s in buffers:
                    b.copy_(s)
            generator.set_state(after)
        return loss, stats

    return gradients


def build_train_step(model: torch.nn.Module, objective: Callable,
                     optimizer: optim_lib.Optimizer, prep: device_prep.DevicePrep,
                     settings: StepSettings, ema: Optional[ema_lib.Ema] = None) -> Callable:
    """Returns ``step(images, labels, mask, generator, scale=1.0, draws=None)``
    → stats: device scalars ``loss_sum``, ``grad_norm`` (of the raw
    gradients the optimizer steps on: SAM's second ones), ``batches``,
    ``correct@1``, ``correct@5``, ``ce_sum`` and ``count``. ``scale`` is
    the progressive-resize scale; ``draws`` (see :func:`build_gradients`)
    are taken from ``generator`` when not given. The model, its parameters
    and the batch share one device; the parameters update in place once,
    and then ``ema`` with the optimizer's count of updates before this one
    (hvt's ``state.step``), which also decides whether SAM runs."""
    gradients = build_gradients(model, objective, prep, settings)

    def step(images: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
             generator: Optional[torch.Generator] = None, scale: float = 1.0,
             draws=None) -> dict[str, torch.Tensor]:
        model.train()
        step_before = optimizer.count
        sam = bool(settings.sam_rho) and step_before % settings.sam_interval == 0
        loss, stats = gradients(images, labels, mask, generator, scale, draws, sam)
        grad_norm = optimizer.step()
        if ema is not None:
            ema.update(step_before)
        stats["loss_sum"] = loss.float()
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
